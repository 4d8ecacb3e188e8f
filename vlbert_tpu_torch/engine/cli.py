"""Command line of the port's entry points (port of
vlbert_tpu/engine/cli.py)."""

from __future__ import annotations

import argparse


def parse_args(task=None, description="VL-BERT (PyTorch + CUDA)",
               argv=None):
    """--cfg, --model-dir, --device; --task when ``task`` is None."""
    parser = argparse.ArgumentParser(description=description)
    if task is None:
        parser.add_argument("--task", type=str, required=True,
                            help="vqa (the only task ported for training)")
    parser.add_argument("--cfg", type=str, required=True,
                        help="path to experiment yaml")
    parser.add_argument("--model-dir", type=str, default="",
                        help="root path for the run's output")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; cuda needs a card (no fallback)")
    args = parser.parse_args(argv)
    if task is not None:
        args.task = task
    return args
