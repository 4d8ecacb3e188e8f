"""Command line of the port's entry points (port of
vlbert_tpu/engine/cli.py)."""

from __future__ import annotations

import argparse


def _add_test_args(parser):
    parser.add_argument("--ckpt", type=str, default="",
                        help="checkpoint to test; after training defaults to "
                             "<prefix>-best.model")
    parser.add_argument("--split", type=str, default="test",
                        choices=("val", "test"))
    parser.add_argument("--result-path", type=str, default="./results")
    parser.add_argument("--result-name", type=str, default="result")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; cuda needs a card (no fallback)")


def parse_args(task=None, description="VL-BERT (PyTorch + CUDA)",
               argv=None):
    """Training: --cfg, --model-dir, --device, --do-test and the test
    flags; --task when ``task`` is None."""
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
    _add_test_args(parser)
    args = parser.parse_args(argv)
    if task is not None:
        args.task = task
    return args


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
    return args
