"""train_net, the experiment driver (port of vlbert_tpu/engine/train.py):
config -> loaders -> model -> optimizer -> ``fit`` with per-epoch
validation.

    python -m vlbert_tpu_torch.engine.train --task vqa \\
        --cfg cfgs/vqa/base_v5e_bf16.yaml

Weights start random (init from RNG_SEED). Checkpoint save and resume,
PARTIAL_PRETRAIN and the BERT/ResNet warm starts are not ported yet
(ROADMAP.md queue 1): a config that asks for them raises. No checkpoint is
saved. One card per process; rank and world size come from
``torch.distributed`` when it is initialised.
"""

from __future__ import annotations

import glob
import logging
import os
import sys

import torch

from vlbert_tpu.data.tokenization import BertTokenizer
from vlbert_tpu_torch.data.build import dist_rank_world, make_dataloader
from vlbert_tpu_torch.engine.val import make_validation_fn
from vlbert_tpu_torch.models.layers import init_weights
from vlbert_tpu_torch.models.task_modules import build_module
from vlbert_tpu_torch.training.loop import fit
from vlbert_tpu_torch.training.optim import Optimizer, apply_trainable_mask
from vlbert_tpu_torch.utils.misc import summary_parameters

logger = logging.getLogger(__name__)

_NEXT = "is not ported yet; see ROADMAP.md queue 1 (checkpoints and warm " \
        "starts)"


def setup_logger(output_path, rank=0):
    os.makedirs(output_path, exist_ok=True)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(message)s",
        handlers=[logging.StreamHandler(),
                  logging.FileHandler(os.path.join(
                      output_path, f"train_rank{rank}.log"))],
        force=True)


def check_unported(config, model_prefix):
    """Raise on what the config asks for that the port does not do yet."""
    net, t = config.NETWORK, config.TRAIN
    if net.PARTIAL_PRETRAIN:
        raise NotImplementedError(f"NETWORK.PARTIAL_PRETRAIN "
                                  f"({net.PARTIAL_PRETRAIN}) {_NEXT}")
    if net.BERT_PRETRAINED or net.IMAGE_PRETRAINED or os.path.isfile(
            os.path.join(net.BERT_MODEL_NAME, "pytorch_model.bin")):
        raise NotImplementedError(f"the BERT / ResNet warm start {_NEXT}")
    if t.RESUME:
        raise NotImplementedError(f"TRAIN.RESUME {_NEXT}")
    if t.AUTO_RESUME and glob.glob(f"{model_prefix}-*.model"):
        raise NotImplementedError(f"TRAIN.AUTO_RESUME with a checkpoint "
                                  f"present ({model_prefix}-*.model) {_NEXT}")


def train_net(args, config, task):
    """Train ``task`` from ``config``; returns (model, history)."""
    rank, world = dist_rank_world()
    output_path = os.path.join(
        config.OUTPUT_PATH or args.model_dir or "./output", f"{task}_train")
    setup_logger(output_path, rank)
    logger.info("config: %s", dict(config))
    model_prefix = os.path.join(output_path,
                                config.MODEL_PREFIX or "vlbert_torch")
    check_unported(config, model_prefix)
    device = torch.device(getattr(args, "device", "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda requested but torch.cuda is not "
                           "available")

    dtype_name = config.TPU.COMPUTE_DTYPE
    if config.TRAIN.FP16:
        logger.info("TRAIN.FP16 -> bf16 compute (no loss scale needed)")
        dtype_name = "bfloat16"
    dtype = {"bfloat16": torch.bfloat16}.get(dtype_name, torch.float32)
    seed = max(int(config.RNG_SEED), 0)
    model = build_module(config, task, dtype=dtype, device=device)
    init_weights(model, torch.Generator(device=device).manual_seed(seed))
    apply_trainable_mask(model, config)
    if rank == 0:
        summary_parameters(model)

    tokenizer = BertTokenizer.from_pretrained(config.NETWORK.BERT_MODEL_NAME)
    train_loader = make_dataloader(config, task, "train", tokenizer)
    val_loader = make_dataloader(config, task, "val", tokenizer)
    optimizer = Optimizer(config, model, len(train_loader), world)
    logger.info("base LR %g over %d steps/epoch; no checkpoint is saved "
                "(checkpoints are ROADMAP.md queue 1)", optimizer.base_lr,
                len(train_loader))
    try:
        history = fit(model, config, task, train_loader, optimizer,
                      device=device,
                      seed_generator=torch.Generator().manual_seed(seed),
                      val_loader=val_loader,
                      validation_fn=make_validation_fn(model, config, task,
                                                       device))
    finally:
        train_loader.shutdown()
        val_loader.shutdown()
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
