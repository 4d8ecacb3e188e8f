"""train_net, the experiment driver (port of vlbert_tpu/engine/train.py):
config -> loaders -> model -> warm starts -> resume -> optimizer -> ``fit``
with per-epoch validation and checkpoints.

    python -m vlbert_tpu_torch.engine.train --task vqa \\
        --cfg cfgs/vqa/base_v5e_bf16.yaml [--do-test]
    python -m vlbert_tpu_torch.engine.train --task vcr \\
        --cfg cfgs/vcr/base_q2a_4x16G_fp32.yaml
    python -m vlbert_tpu_torch.engine.train --task refcoco \\
        --cfg cfgs/refcoco/base_gt_boxes_4x16G.yaml
    python -m vlbert_tpu_torch.engine.train --task pretrain \\
        --cfg cfgs/pretrain/base_e2e_16x16G_fp16.yaml

VCR, RefCOCO+ and pretraining train from pixels: the ResNet's unfrozen
stages and the conv5 RoI head take gradients through ROIAlign (kernels K1
and K1b). A list-valued DATASET (multitask pretraining: captions and a
text corpus) zips one loader per entry and has no validation, as in the
JAX package; every checkpoint is then also mirrored to ``-best.model``.

Weights start random (init from RNG_SEED), then take the language (BERT)
and image (ResNet) warm starts and NETWORK.PARTIAL_PRETRAIN, all on
reference names, unless a checkpoint will be resumed. TRAIN.RESUME and
TRAIN.AUTO_RESUME restore weights, optimizer moments and count, the best
validation metric and the plateau detector. Every CHECKPOINT_FREQUENT
epoch and every best-val epoch is saved as ``{prefix}-{epoch:04d}.model``
(by a background writer under TPU.ASYNC_CHECKPOINT), the best mirrored to
``{prefix}-best.model``. ``--do-test`` then scores the best checkpoint
(``engine/test.py``). One card, one process: under a process group of
more than one rank it refuses to train, because nothing all-reduces the
gradients yet (ROADMAP.md queue 1, multi-GPU).
"""

from __future__ import annotations

import logging
import os
import sys

import torch

from vlbert_tpu_torch.data.build import (dist_rank_world, make_dataloader,
                                         make_multitask_dataloader)
from vlbert_tpu_torch.data.tokenization import BertTokenizer
from vlbert_tpu_torch.engine.val import make_validation_fn
from vlbert_tpu_torch.models.layers import init_weights
from vlbert_tpu_torch.models.task_modules import build_module
from vlbert_tpu_torch.training import checkpoint as ckpt_lib
from vlbert_tpu_torch.training import convert as cvt
from vlbert_tpu_torch.training.loop import fit
from vlbert_tpu_torch.training.optim import Optimizer, apply_trainable_mask
from vlbert_tpu_torch.utils.misc import summary_parameters

logger = logging.getLogger(__name__)

DEFAULT_PREFIX = "vlbert_torch"


def setup_logger(output_path, rank=0):
    os.makedirs(output_path, exist_ok=True)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(message)s",
        handlers=[logging.StreamHandler(),
                  logging.FileHandler(os.path.join(
                      output_path, f"train_rank{rank}.log"))],
        force=True)


def check_unported(config):
    """Raise on what the config asks for that the port does not do, before
    anything is built. Every task the port trains, trains on the CPU and
    on the card, from precomputed features and from pixels; what is
    refused is float16 compute, which the JAX package trains in under
    TRAIN.FP16 with TPU.FP16_PARITY_MODE and under TPU.COMPUTE_DTYPE
    float16."""
    if config.TRAIN.FP16 and config.TPU.get("FP16_PARITY_MODE", False):
        raise NotImplementedError(
            "TRAIN.FP16 with TPU.FP16_PARITY_MODE asks for float16 compute "
            "with a static loss scale; the port's kernels take float32 and "
            "bfloat16 only (unset TPU.FP16_PARITY_MODE: TRAIN.FP16 then "
            "trains in bfloat16)")
    if config.TPU.COMPUTE_DTYPE == "float16" and not config.TRAIN.FP16:
        raise NotImplementedError(
            "TPU.COMPUTE_DTYPE float16 asks for float16 training; the "
            "port's kernels take float32 and bfloat16 only (set "
            "COMPUTE_DTYPE to bfloat16 or float32)")


def nsp_to_binary_classifier_surgery(sd, config):
    """ref vcr/function/train.py:215-222: the last final_mlp layer
    (``final_mlp.4``, [1, H]) starts as the relationship head's row 1 -
    row 0 (NSP 'is-match' minus 'not-match'). Reference names; acts only
    under NETWORK.LOAD_REL_HEAD (the VCR configs)."""
    wkey = "vlbert.relationship_head.caption_image_relationship.weight"
    bkey = "vlbert.relationship_head.caption_image_relationship.bias"
    if wkey in sd and config.NETWORK.get("LOAD_REL_HEAD", False):
        w, b = torch.as_tensor(sd[wkey]), torch.as_tensor(sd[bkey])
        sd["final_mlp.4.weight"] = w[1:2] - w[0:1]
        sd["final_mlp.4.bias"] = b[1:2] - b[0:1]
    return sd


def segmb_init_surgery(sd, config):
    """Segment-B init (ref vcr/function/train.py:223-229): pretraining
    used token type 0 for text, VCR uses 0 and 1, so the B row starts as
    a copy of the A row of the loaded checkpoint."""
    key = "vlbert.token_type_embeddings.weight"
    if config.NETWORK.get("PARTIAL_PRETRAIN_SEGMB_INIT", False) and key in sd:
        tt = torch.as_tensor(sd[key]).clone()
        tt[1] = tt[0]
        sd[key] = tt
    return sd


def warm_start_paths(config):
    """Language + image warm-start checkpoint paths.

    ref: each task module ctor resolves BERT weights from
    NETWORK.BERT_PRETRAINED ('{prefix}-{epoch:04d}.model') or falls back to
    the BERT_MODEL_NAME archive dir's pytorch_model.bin
    (vcr/modules/resnet_vlbert_for_vcr.py:20-33), gated on
    VLBERT.from_scratch; FastRCNN resolves the ResNet checkpoint from
    NETWORK.IMAGE_PRETRAINED (common/fast_rcnn.py:39-40).
    """
    net = config.NETWORK
    lang = None
    # from_scratch exists only in the pretrain tree (ref pretrain config:88)
    if not net.VLBERT.get("from_scratch", False):
        if net.BERT_PRETRAINED:
            lang = "{}-{:04d}.model".format(net.BERT_PRETRAINED,
                                            int(net.BERT_PRETRAINED_EPOCH))
        elif os.path.isdir(net.BERT_MODEL_NAME):
            cand = os.path.join(net.BERT_MODEL_NAME, "pytorch_model.bin")
            if os.path.isfile(cand):
                lang = cand
    img = None
    if net.IMAGE_PRETRAINED:
        img = "{}-{:04d}.model".format(net.IMAGE_PRETRAINED,
                                       int(net.IMAGE_PRETRAINED_EPOCH))
        if not os.path.isfile(img) and os.path.isfile(net.IMAGE_PRETRAINED):
            img = net.IMAGE_PRETRAINED     # direct path (.model/.npz)
    return lang, img


def _warm_state_dict(path, model, converter):
    """A warm-start file on reference names: a torch file through
    ``converter``, an .npz through the inverse of the JAX converter."""
    sd, raw = cvt.load_state_dict_file(path, model)
    return converter(sd)[0] if raw else sd


def apply_warm_starts(model, config):
    """Load the image (ResNet), then the language (BERT) warm start into
    ``model`` in place; a later PARTIAL_PRETRAIN overrides overlapping
    keys, matching the reference's ctor-then-train_net order."""
    lang_path, img_path = warm_start_paths(config)
    if img_path:
        sd = _warm_state_dict(img_path, model,
                              cvt.convert_raw_resnet_checkpoint)
        loaded, _, _ = ckpt_lib.partial_load(model, sd)
        logger.info("image warm start %s: %d tensors", img_path, len(loaded))
    if lang_path:
        sd = _warm_state_dict(lang_path, model, cvt.convert_bert_checkpoint)
        loaded, _, _ = ckpt_lib.partial_load(model, sd)
        logger.info("language warm start %s: %d tensors", lang_path,
                    len(loaded))
    return model


def apply_partial_pretrain(model, config):
    """PARTIAL_PRETRAIN warm start (ref vcr/function/train.py:199-232).

    PREFIX_CHANGES are written on the reference's raw torch names (e.g.
    'module.vlbert.mlm_head.predictions.transform->module.final_mlp.0') and
    the reference applies them BEFORE loading, so they are applied to the
    file's raw names here, before ``reference_name`` strips ``module.``.
    An .npz is already on the model's names and takes none. Then the
    surgeries and, under CLASSIFIER_PRETRAINED with the 'mlm' classifier,
    the MLM transform copied to the classifier, in the JAX package's order.
    Returns (loaded, missing, mismatched) of ``partial_load``, or None."""
    path = config.NETWORK.PARTIAL_PRETRAIN
    if not path:
        return None
    prefix_changes = [tuple(pc.split("->")) for pc in
                      config.NETWORK.PARTIAL_PRETRAIN_PREFIX_CHANGES]
    sd, raw = cvt.load_state_dict_file(path, model)
    if raw:
        sd = cvt.convert_torch_state_dict(
            cvt.apply_reference_prefix_changes(sd, prefix_changes))
    sd = nsp_to_binary_classifier_surgery(sd, config)
    sd = segmb_init_surgery(sd, config)
    if config.NETWORK.get("CLASSIFIER_PRETRAINED", False) \
            and config.NETWORK.CLASSIFIER_TYPE == "mlm":
        sd = cvt.mlm_transform_to_classifier(sd)
    report = ckpt_lib.partial_load(model, sd)
    logger.info("partial pretrain %s: loaded %d tensors", path,
                len(report[0]))
    return report


def train_output_path(config, args, task):
    return os.path.join(config.OUTPUT_PATH or getattr(args, "model_dir", "")
                        or "./output", f"{task}_train")


def model_prefix_of(config, output_path):
    return os.path.join(output_path, config.MODEL_PREFIX or DEFAULT_PREFIX)


def train_net(args, config, task):
    """Train ``task`` from ``config``; returns (model, history). The
    history adds ``begin_epoch`` and ``resumed_count`` (the optimizer count
    after the resume) to ``fit``'s."""
    rank, world = dist_rank_world()
    if world > 1:
        raise NotImplementedError(
            f"training under a process group of {world} ranks: nothing "
            f"all-reduces the gradients or metrics yet, so each rank would "
            f"train its own replica; see ROADMAP.md queue 1 (multi-GPU)")
    output_path = train_output_path(config, args, task)
    setup_logger(output_path, rank)
    logger.info("config: %s", dict(config))
    model_prefix = model_prefix_of(config, output_path)
    device = torch.device(getattr(args, "device", "cuda"))
    check_unported(config)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda requested but torch.cuda is not "
                           "available")

    dtype_name = config.TPU.COMPUTE_DTYPE
    if config.TRAIN.FP16:
        logger.info("TRAIN.FP16 -> bf16 compute (no loss scale needed)")
        dtype_name = "bfloat16"
    dtype = torch.bfloat16 if dtype_name == "bfloat16" else torch.float32
    seed = max(int(config.RNG_SEED), 0)
    model = build_module(config, task, dtype=dtype, device=device)
    init_weights(model, torch.Generator(device=device).manual_seed(seed))
    apply_trainable_mask(model, config)
    if rank == 0:
        summary_parameters(model)

    # warm starts are skipped when a checkpoint will be resumed: the resume
    # overwrites every tensor (the reference pays for the loads anyway)
    if ckpt_lib.has_resumable_checkpoint(model_prefix, config):
        logger.info("resumable checkpoint found: skipping BERT/ResNet/"
                    "PARTIAL_PRETRAIN warm starts")
    else:
        apply_warm_starts(model, config)
        apply_partial_pretrain(model, config)

    tokenizer = BertTokenizer.from_pretrained(config.NETWORK.BERT_MODEL_NAME)
    if isinstance(config.DATASET, (list, tuple)):
        train_loader = make_multitask_dataloader(config, task, "train",
                                                 tokenizer)
        val_loader = None
    else:
        train_loader = make_dataloader(config, task, "train", tokenizer)
        val_loader = make_dataloader(config, task, "val", tokenizer)
    try:
        optimizer = Optimizer(config, model, len(train_loader), world)
        begin_epoch, extra = ckpt_lib.smart_resume(model_prefix, model,
                                                   optimizer, config)
        resumed_count = optimizer.count
        logger.info("base LR %g over %d steps/epoch; epochs %d..%d, "
                    "optimizer count %d", optimizer.base_lr,
                    len(train_loader), begin_epoch, config.TRAIN.END_EPOCH,
                    resumed_count)
        # the serialize + write in a background thread (seconds a save at
        # base width); TPU.ASYNC_CHECKPOINT=false is the reference's
        # synchronous save
        async_ckpt = bool(config.TPU.get("ASYNC_CHECKPOINT", True))

        def checkpoint_fn(m, opt, epoch, extra_dict, is_best):
            # without validation every save is the best there is, as in
            # the JAX package
            ckpt_lib.save_checkpoint(
                model_prefix, epoch, m, opt, extra=extra_dict,
                async_write=async_ckpt,
                mirror_best_to=model_prefix
                if is_best or val_loader is None else None)

        history = fit(model, config, task, train_loader, optimizer,
                      device=device,
                      seed_generator=torch.Generator().manual_seed(seed),
                      val_loader=val_loader,
                      validation_fn=None if val_loader is None else
                      make_validation_fn(model, config, task, device),
                      begin_epoch=begin_epoch, checkpoint_fn=checkpoint_fn,
                      best_val=extra.get("best_val"),
                      plateau_state=extra.get("plateau"))
    except BaseException:
        # a failure mid-epoch must not abandon the writer: the checkpoint
        # it is writing is what AUTO_RESUME needs after this very failure;
        # join it, but never mask the original exception
        try:
            ckpt_lib.wait_for_pending_save()
        except Exception:
            logger.exception("async checkpoint write failed during unwind")
        raise
    finally:
        for loader in (train_loader, val_loader):
            if loader is not None:
                loader.shutdown()
    ckpt_lib.wait_for_pending_save()     # surface in-flight write failures
    history["begin_epoch"] = begin_epoch
    history["resumed_count"] = resumed_count
    if getattr(args, "do_test", False):
        from vlbert_tpu_torch.engine.test import do_test

        history["test"] = do_test(args, config, task)
    return model, history


def main(argv=None):
    from vlbert_tpu_torch.engine.cli import parse_args
    from vlbert_tpu_torch.utils.config import load_config

    args = parse_args(argv=argv)
    config = load_config(args.task, args.cfg)
    train_net(args, config, args.task)
    return 0


if __name__ == "__main__":
    sys.exit(main())
