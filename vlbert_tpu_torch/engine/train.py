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
(``engine/test.py``).

On several cards, one process a card (TPU.PARTITION_MODE dp,
``parallel/dist.py``):

    torchrun --nproc_per_node N -m vlbert_tpu_torch.engine.train --dist \
        --task vqa --cfg cfgs/vqa/base_4x16G_fp32.yaml

TRAIN.BATCH_IMAGES is each card's batch and the base LR scales by the
world size, as in the JAX package and the reference. Every rank
initialises the same weights; rank 0 alone resumes and its weights,
optimizer moments and count, begin epoch, best validation metric and
plateau state are broadcast; each step is the global batch's; rank 0
alone writes checkpoints and runs ``--do-test`` (the others wait at a
barrier); each rank logs to ``train_rank{rank}.log``.

With TPU.PARTITION_MODE fsdp under ``--dist`` (``parallel/fsdp.py``) the
model is sharded with FSDP2 after its warm starts, and the optimizer and
the train step are built on the sharded parameters: each rank holds 1/N
of the parameters and moments, and each step is still the global
batch's. Every rank enters a checkpoint save, which gathers the state
into the file a ``dp`` run writes (rank 0 alone writes it), and a resume,
in which rank 0 reads the file and each rank keeps its shard.
``--do-test`` still runs on rank 0 alone, on a model it builds from the
written file. Under SLURM, ``srun`` with one task a card replaces
torchrun (``scripts/run_slurm_torch.sh``; ``parallel/dist.py``).

With TPU.PARTITION_MODE tp under ``--dist`` (``parallel/tp.py``) the
ranks form a [data, model] mesh of TPU.MESH_SHAPE [d, m] (MESH_AXES
[data, model]) and each encoder layer is split over the model axis after
the warm starts, before the optimizer; the loader shards by data index
and a replica's batch is BATCH_IMAGES x m; checkpoints are gathered as
under fsdp, validation runs on every rank. TPU.PARTITION_MODE fsdp on
such a mesh (m > 1) splits the layers as tp does, then shards each
rank's part and the replicated tensors with FSDP2 over its data group.
Config overrides may follow the yaml on the command line:

    torchrun --nproc_per_node 4 -m vlbert_tpu_torch.engine.train --dist \
        --task vqa --cfg cfgs/vqa/base_v5e_bf16.yaml \
        TPU.PARTITION_MODE tp TPU.MESH_SHAPE '[2,2]' \
        TPU.MESH_AXES '[data,model]'
"""

from __future__ import annotations

import logging
import math
import os
import sys

import torch

from vlbert_tpu_torch.data.build import (dist_rank_world, make_dataloader,
                                         make_multitask_dataloader)
from vlbert_tpu_torch.data.tokenization import BertTokenizer
from vlbert_tpu_torch.engine.val import make_validation_fn
from vlbert_tpu_torch.models.layers import init_weights
from vlbert_tpu_torch.models.task_modules import _DTYPES, build_module
from vlbert_tpu_torch.parallel import dist as dist_lib
from vlbert_tpu_torch.parallel import fsdp as fsdp_lib
from vlbert_tpu_torch.parallel import tp as tp_lib
from vlbert_tpu_torch.training import checkpoint as ckpt_lib
from vlbert_tpu_torch.training import convert as cvt
from vlbert_tpu_torch.training.loop import fit, loss_scale
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


def compute_policy(config):
    """(compute dtype, static loss scale) of a training run, resolved as
    the JAX package's train_net and train step resolve them:
    TRAIN.FP16 with TPU.FP16_PARITY_MODE trains in float16 with the scale
    TRAIN.FP16_LOSS_SCALE (the reference's Apex O2 with a fixed scale);
    TRAIN.FP16 alone in bfloat16 with no scale, whatever COMPUTE_DTYPE
    says; otherwise TPU.COMPUTE_DTYPE (bfloat16, float16; anything else
    float32) with no scale. Raises ValueError on a scale that is not a
    number (``loss_scale``), before anything is built."""
    scale = loss_scale(config)
    name = config.TPU.COMPUTE_DTYPE
    if config.TRAIN.FP16:
        name = "float16" if config.TPU.get("FP16_PARITY_MODE", False) \
            else "bfloat16"
    return _DTYPES.get(name, torch.float32), scale


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
    dist_lib.check_partition(config, world)
    output_path = train_output_path(config, args, task)
    setup_logger(output_path, rank)
    logger.info("config: %s", dict(config))
    model_prefix = model_prefix_of(config, output_path)
    device = torch.device(getattr(args, "device", None) or "cuda")
    dtype, scale = compute_policy(config)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda requested but torch.cuda is not "
                           "available")
    if dtype == torch.float16:
        # cuBLAS may otherwise reduce a split-K fp16 GEMM in fp16; XLA's
        # fp16 dots accumulate in fp32
        torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction \
            = False
        logger.info("float16 compute, static loss scale %g; fp16 GEMMs "
                    "reduce in fp32 (allow_fp16_reduced_precision_reduction"
                    " off)", scale)
    elif config.TRAIN.FP16:
        logger.info("TRAIN.FP16 -> bf16 compute (no loss scale); set "
                    "TPU.FP16_PARITY_MODE for float16 with the static loss "
                    "scale")
    seed = max(int(config.RNG_SEED), 0)
    # TPU.REMAT: each encoder layer activation-checkpointed, as the JAX
    # package's train_net builds its model
    model = build_module(config, task, dtype=dtype, device=device,
                         remat=bool(config.TPU.get("REMAT", False)))
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
    # after the mask and the warm starts, before the optimizer and the
    # train step, which hold the sharded Parameters
    mode = dist_lib.partition_mode(config)
    if dist_lib.is_distributed() and mode == "fsdp":
        # over the data axis; on a [d, m] mesh, after tp's split
        model_axis = dist_lib.mesh_dims(config, world)[1] > 1
        fsdp_lib.shard_module(model, device, tp_lib.make_mesh(
            config, device) if model_axis else None)
    elif dist_lib.is_distributed() and mode == "tp":
        tp_lib.shard_module(model, tp_lib.make_mesh(config, device))

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
        begin_epoch, extra = resume(model_prefix, model, optimizer, config)
        resumed_count = optimizer.count
        moments = optimizer.mu + (optimizer.nu or [])
        copies = len(optimizer.params + moments) // len(optimizer.params)
        state_elements = (fsdp_lib.local_numel(optimizer.params + moments),
                          copies * sum(math.prod(s) for s in
                                       optimizer.full_shapes()))
        logger.info("rank %d holds %d of the %d elements of the trained "
                    "parameters and their moments", rank, *state_elements)
        logger.info("base LR %g over %d steps/epoch; epochs %d..%d, "
                    "optimizer count %d", optimizer.base_lr,
                    len(train_loader), begin_epoch, config.TRAIN.END_EPOCH,
                    resumed_count)
        # the serialize + write in a background thread (seconds a save at
        # base width); TPU.ASYNC_CHECKPOINT=false is the reference's
        # synchronous save
        async_ckpt = bool(config.TPU.get("ASYNC_CHECKPOINT", True))

        def checkpoint_fn(m, opt, epoch, extra_dict, is_best):
            # one writer; replicated state (dp) lets the other ranks skip,
            # sharded state (fsdp, tp) is gathered with every rank in it
            if rank != 0 and not ckpt_lib.snapshot_needs_all_ranks(m):
                return
            # without validation every save is the best there is, as in
            # the JAX package
            ckpt_lib.save_checkpoint(
                model_prefix, epoch, m, opt, extra=extra_dict,
                async_write=async_ckpt,
                mirror_best_to=model_prefix
                if is_best or val_loader is None else None,
                write=rank == 0)

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
    dist_lib.barrier()                   # rank 0's files are written
    if fsdp_lib.is_sharded(model):
        model.reshard()                  # the root's, gathered by validation
    history["begin_epoch"] = begin_epoch
    history["resumed_count"] = resumed_count
    history["state_elements"] = state_elements
    if getattr(args, "do_test", False):
        from vlbert_tpu_torch.engine.test import do_test

        # rank 0 alone, over an unsharded loader; None on the others
        history["test"] = do_test(args, config, task)
        dist_lib.barrier()
    return model, history


def resume(model_prefix, model, optimizer, config):
    """``smart_resume``; under a process group on rank 0 alone, then rank
    0's parameters, buffers, optimizer moments, count and plateau scale,
    begin epoch and ``extra`` (best_val, plateau) on every rank (JAX:
    ``broadcast_one_to_all`` after the resume). A sharded model: rank 0
    finds the file and every rank enters the load, which scatters rank
    0's tensors. A rank without the checkpoint file resumes all the same;
    a failure on rank 0 raises on every rank. Returns (begin_epoch,
    extra)."""
    if not dist_lib.is_distributed():
        return ckpt_lib.smart_resume(model_prefix, model, optimizer, config)
    if ckpt_lib.snapshot_needs_all_ranks(model):
        path, begin_epoch = dist_lib.from_rank0(
            lambda: ckpt_lib.resume_target(model_prefix, config))
        if path is None:
            return begin_epoch, {}
        extra = ckpt_lib.load_checkpoint(path, model, optimizer)
        logger.info("resumed from rank 0's %s (begin_epoch=%d)", path,
                    begin_epoch)
        return begin_epoch, extra

    def read():                     # rank 0 alone, then broadcast
        begin_epoch, extra = ckpt_lib.smart_resume(model_prefix, model,
                                                   optimizer, config)
        return begin_epoch, extra, optimizer.count, optimizer.plateau_scale

    begin_epoch, extra, optimizer.count, optimizer.plateau_scale = \
        dist_lib.from_rank0(read)
    dist_lib.broadcast_tensors_(
        [p.data for p in model.parameters()] + list(model.buffers())
        + optimizer.mu + (optimizer.nu or []))
    return begin_epoch, extra


def main(argv=None):
    from vlbert_tpu_torch.engine.cli import apply_overrides, parse_args
    from vlbert_tpu_torch.utils.config import load_config

    args = parse_args(argv=argv)
    config = apply_overrides(load_config(args.task, args.cfg), args.opts)
    if not args.dist:
        args.device = args.device or "cuda"
        train_net(args, config, args.task)
        return 0
    with dist_lib.process_group(args.dist_backend, args.device) as device:
        args.device = str(device)
        train_net(args, config, args.task)
    return 0


if __name__ == "__main__":
    sys.exit(main())
