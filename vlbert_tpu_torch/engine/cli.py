"""Command line of the port's entry points (port of
vlbert_tpu/engine/cli.py)."""

from __future__ import annotations

import argparse

import yaml


def _add_test_args(parser):
    parser.add_argument("--ckpt", type=str, default="",
                        help="checkpoint to test; after training defaults to "
                             "<prefix>-best.model")
    parser.add_argument("--split", type=str, default="test",
                        choices=("val", "test"))
    parser.add_argument("--result-path", type=str, default="./results")
    parser.add_argument("--result-name", type=str, default="result")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device, by default cuda (under --dist "
                             "cuda:LOCAL_RANK); cuda needs a card (no "
                             "fallback)")


def parse_args(task=None, description="VL-BERT (PyTorch + CUDA)",
               argv=None):
    """Training: --cfg, --model-dir, --device, --do-test, --dist,
    --dist-backend and the test flags; --task when ``task`` is None."""
    parser = argparse.ArgumentParser(description=description)
    if task is None:
        parser.add_argument("--task", type=str, required=True,
                            choices=("vqa", "vcr", "refcoco", "pretrain"),
                            help="the task to train")
    parser.add_argument("--cfg", type=str, required=True,
                        help="path to experiment yaml")
    parser.add_argument("--model-dir", type=str, default="",
                        help="root path for the run's output")
    parser.add_argument("--do-test", action="store_true",
                        help="score the best checkpoint after training")
    parser.add_argument("--dist", action="store_true",
                        help="train over torch.distributed, one rank a "
                             "card, from torchrun's or srun's environment "
                             "(TPU.PARTITION_MODE dp, fsdp or tp)")
    parser.add_argument("--dist-backend", type=str, default=None,
                        choices=("nccl", "gloo"),
                        help="the process group's backend: by default nccl "
                             "on a card, gloo on the CPU")
    _add_test_args(parser)
    parser.add_argument("opts", nargs="*", default=[], metavar="KEY VALUE",
                        help="config overrides after the yaml, a dotted "
                             "key and a YAML value each: TPU.PARTITION_MODE"
                             " tp TPU.MESH_SHAPE [1,2] TPU.MESH_AXES "
                             "[data,model]")
    args = parser.parse_args(argv)
    if task is not None:
        args.task = task
    if len(args.opts) % 2:
        parser.error(f"config overrides come in KEY VALUE pairs, got "
                     f"{args.opts}")
    return args


def apply_overrides(config, opts):
    """Set each dotted key of ``opts`` (KEY VALUE ...) to its value read as
    YAML (``[1,2]`` is a list, ``tp`` a string), in place; a key that the
    config does not have raises ValueError, as a yaml's does."""
    for key, text in zip(opts[::2], opts[1::2]):
        node, parts = config, key.split(".")
        for i, part in enumerate(parts):
            if not hasattr(node, "keys") or part not in node:
                raise ValueError(f"config override {key}: "
                                 f"{'.'.join(parts[:i + 1])} is not in the "
                                 f"config")
            if i < len(parts) - 1:
                node = node[part]
        node[parts[-1]] = yaml.safe_load(text)
    return config


def parse_test_args(argv=None):
    """``python -m vlbert_tpu_torch.engine.test``: --task, --cfg, --ckpt
    (required) and the test flags."""
    parser = argparse.ArgumentParser(
        description="VL-BERT test driver (PyTorch + CUDA)")
    parser.add_argument("--task", type=str, required=True,
                        choices=("vqa", "refcoco", "vcr"))
    parser.add_argument("--cfg", type=str, required=True,
                        help="path to experiment yaml")
    _add_test_args(parser)
    args = parser.parse_args(argv)
    if not args.ckpt:
        parser.error("--ckpt is required")
    args.device = args.device or "cuda"
    return args
