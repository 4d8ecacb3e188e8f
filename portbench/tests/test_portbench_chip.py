"""A cell as the benchmark runs it, on the card: ``python -m pytest
portbench/tests -m chip``. Skipped without a CUDA card."""

import json
import subprocess
import sys

import pytest

from portbench import harness


@pytest.mark.chip
@pytest.mark.parametrize("name", ["vcr_large.q2a_pixels_b16",
                                  "vcr_base.q2a_pixels_b16"])
def test_a_short_run_on_the_card_is_correct(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", name, "--seed",
         "2718281829", "--seconds", "5", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["check"]
    assert result["device"]["platform"] == "gpu"


def test_no_card_no_result():
    """Without a card (this machine, or a card too few) the run exits
    non-zero and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "vcr_base.q2a_pixels_b16", "--seed", "1", "--seconds", "1"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
