"""The result line: its keys, the checked numbers last, and their
printing beside their limits."""

import json

from portbench import harness

from tiny import run, tiny_cell

REQUIRED = ("correct", "attempted", "failed", "metrics", "device")


def test_result_line_schema(capsys):
    result = run(tiny_cell("vcr_base.q2a_pixels_b16"), seconds=0.5)
    assert all(k in result for k in REQUIRED)
    assert list(result)[-1] == "check"
    assert isinstance(result["correct"], bool)
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"train_samples_per_s", "setup_s"}
    assert result["metrics"]["setup_s"]["unit"] == "s"
    for k in ("platform", "kind", "count", "memory_peak_bytes"):
        assert k in result["device"]
    harness.print_result(result)
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == json.loads(
        json.dumps(result))
    tail = err.strip().splitlines()[-len(result["check"]):]
    for line, (name, v) in zip(tail, result["check"].items()):
        assert line == f"check {name} {v['value']!r} limit {v['limit']!r}"


def test_traced_run_reports_per_layer_metrics_only():
    cell = tiny_cell("vcr_base.q2a_pixels_b16")
    cell["traffic_spec"].update(profile_from=1, profile_steps=1)
    result = run(cell, seconds=15.0, trace=True)
    names = {m["name"] for m in cell["per_layer"]}
    assert set(result["metrics"]) <= names
    assert {"loader_wait_ms", "step_ms_p50", "mfu"} <= set(result["metrics"])
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(result)[-1] == "check"
