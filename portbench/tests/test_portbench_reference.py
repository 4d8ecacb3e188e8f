"""The reference against the port's CPU path on tiny steps, and the
comparison failing the faults and the control it must fail: the run as
the benchmark makes it, at the tests' size, with the timed path broken
underneath."""

import pytest

from tiny import TINY_LIMIT, run, tiny_cell

CELLS = ("vcr_base.q2a_pixels_b16",)


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_ports_cpu_path(name):
    result = run(tiny_cell(name))
    for number, v in result["check"].items():
        assert v["value"] < TINY_LIMIT, (number, v)
    assert result["correct"] is True


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "answer"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_step_is_not_correct(name, fault):
    result = run(tiny_cell(name), fault=fault)
    assert result["correct"] is False, result["check"]


@pytest.mark.parametrize("name", CELLS)
def test_the_float8_control_is_not_correct(name):
    result = run(tiny_cell(name), control=True)
    assert result["correct"] is False, result["check"]
