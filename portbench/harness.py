"""What every cell's run shares: finding a cell's files by the names in
``BENCHMARK.json``, loading a driver, generator or metric reader from its
file, the checks on the device and on the modules the process loaded,
the result line, and stopping the processes the run started."""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BENCH_DIR = Path(__file__).resolve().parent
# compared with the top-level name of every loaded module, whole: the
# port's own name begins with the JAX package's
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "vlbert_tpu")


def benchmark(root=ROOT):
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path):
    with open(path) as f:
        return json.load(f)


def cell(name, bench=None, bench_dir=BENCH_DIR):
    """The workload ``name`` with its configuration, traffic mix, limits
    and the per-layer metrics it reports, each found by name."""
    bench = bench or benchmark()
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = dict(found[0])
    w["config_spec"] = _json(bench_dir / "configs" / f"{w['config']}.json")
    w["traffic_spec"] = _json(bench_dir / "traffic" / f"{w['traffic']}.json")
    w["limits"] = _json(bench_dir / "limits" / f"{name}.json")
    w["end_to_end"] = [m for m in bench["end_to_end"]
                       if name in m.get("workloads", [name])]
    w["per_layer"] = [m for m in bench["per_layer"]
                      if name in m.get("workloads", [name])]
    w["bench_dir"] = str(bench_dir)
    return w


def load(relpath, bench_dir=BENCH_DIR):
    """The module of a file under the benchmark's folder."""
    path = Path(bench_dir) / relpath
    name = "portbench_" + relpath.replace("/", "_").removesuffix(".py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules(names=None):
    """The FORBIDDEN top-level names among ``names`` (the loaded
    modules)."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def device_kind():
    import torch

    return torch.cuda.get_device_name(0)


def power_limit():
    """The card's power limit as nvidia-smi gives it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return out.splitlines()[0] if out else None


def print_result(result):
    """The checked numbers beside their limits on standard error, last,
    then the result as the last line of standard output."""
    for name, v in result["check"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def descendants(pid):
    """Pids of every live process below ``pid``, from /proc."""
    children = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        fields = stat[stat.rindex(")") + 2:].split()
        if fields[0] != "Z":
            children.setdefault(int(fields[1]), []).append(int(entry))
    found, todo = [], [pid]
    while todo:
        for c in children.get(todo.pop(), ()):
            found.append(c)
            todo.append(c)
    return found


def stop_children():
    """Stop multiprocessing's forkserver and resource tracker (the
    loader's worker pool starts both), then kill and reap any other
    process below this one. Returns the pids that had to be killed."""
    import multiprocessing.forkserver as forkserver
    import multiprocessing.resource_tracker as resource_tracker

    with contextlib.suppress(Exception):
        forkserver._forkserver._stop()
    with contextlib.suppress(Exception):
        resource_tracker._resource_tracker._stop()
    left = descendants(os.getpid())
    for pid in left:
        with contextlib.suppress(ProcessLookupError):
            os.kill(pid, signal.SIGKILL)
    for pid in left:
        with contextlib.suppress(ChildProcessError):
            os.waitpid(pid, 0)
    return left
