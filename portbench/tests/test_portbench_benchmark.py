"""BENCHMARK.json against the benchmark's contract: it parses, every name
resolves to its file, names and units use the allowed characters, and a
cell added as new files and a new workloads entry runs with no edit to
an existing file."""

import json
import re
import shutil

import pytest

from portbench import harness

from tiny import run, tiny_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return harness.benchmark()


def test_top_level_keys_and_command(bench):
    assert set(bench) == KEYS
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) < 64 * 1024


def test_names_and_units(bench):
    names = [c["name"] for c in bench["configs"]] + \
        [w["name"] for w in bench["workloads"]] + \
        [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["config"] for w in bench["workloads"]] \
            + [w["traffic"] for w in bench["workloads"]] \
            + [k for c in bench["configs"] for k in c["reduced"]]:
        assert NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for text in [c["why"] for c in bench["configs"] + bench["workloads"]] \
            + [m["layer"] for m in bench["per_layer"]] \
            + [c["source"] for c in bench["configs"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_entries_hold_their_keys_only(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e


@pytest.mark.parametrize("index", [0, 1])
def test_every_name_resolves_to_its_files(bench, index):
    w = bench["workloads"][index]
    cell = harness.cell(w["name"], bench)
    spec = cell["config_spec"]
    entry = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    assert entry["file"] == f"portbench/configs/{w['config']}.json"
    assert sorted(entry["reduced"]) == sorted(spec["reduced"])
    for rel in (cell["traffic_spec"]["driver"],
                cell["traffic_spec"]["generator"]):
        assert (harness.BENCH_DIR / rel).is_file(), rel
    for m in cell["per_layer"]:
        assert (harness.BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()
    assert set(cell["limits"]) == {"loss_gap", "grad_gap.backbone",
                                   "grad_gap.vl", "change_gap.backbone",
                                   "change_gap.vl"}
    ends = {m["name"] for m in cell["end_to_end"]}
    assert {"setup_s", "train_samples_per_s"} <= ends
    assert cell["per_layer"]


def test_a_cell_added_as_new_files_runs(bench, tmp_path):
    """A new configuration, traffic mix and limits, each a new file (copies
    of the VCR base cell's, its limits as calibrated), and a new entry in
    BENCHMARK.json: the harness finds them, the driver runs the cell and
    its check holds the run to those limits, with no file of the
    benchmark changed."""
    bench_dir = tmp_path / "portbench"
    shutil.copytree(harness.BENCH_DIR, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(bench_dir): p.read_bytes()
              for p in bench_dir.rglob("*") if p.is_file()}
    spec = json.loads((bench_dir / "configs/vcr_base.json").read_text())
    spec["name"] = "vcr_small"
    (bench_dir / "configs/vcr_small.json").write_text(json.dumps(spec))
    mix = json.loads((bench_dir / "traffic/q2a_pixels_b16.json").read_text())
    mix["data"]["boxes"] = [2, 4]
    (bench_dir / "traffic/q2a_few_boxes.json").write_text(json.dumps(mix))
    limits = (bench_dir / "limits/vcr_base.q2a_pixels_b16.json").read_text()
    (bench_dir / "limits/vcr_small.q2a_few_boxes.json").write_text(limits)
    name = "vcr_small.q2a_few_boxes"
    new = dict(bench)
    new["workloads"] = bench["workloads"] + [
        {"name": name, "config": "vcr_small", "traffic": "q2a_few_boxes",
         "chips": 1, "why": "a test cell"}]
    for m in new["end_to_end"] + new["per_layer"]:
        if "workloads" in m:
            m["workloads"] = m["workloads"] + [name]
    cell = tiny_cell(name, bench=new, bench_dir=bench_dir, limits=None)
    assert cell["limits"] == json.loads(limits)
    result = run(cell, seconds=0.5)
    assert result["correct"] is True
    assert {k: v["limit"] for k, v in result["check"].items()} == \
        json.loads(limits)
    assert result["metrics"]["train_samples_per_s"]["value"] > 0
    assert run(cell, fault="unchanged")["correct"] is False
    for rel, data in before.items():
        assert (bench_dir / rel).read_bytes() == data, rel
