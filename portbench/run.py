"""The port's benchmark: one run of one cell of BENCHMARK.json.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout. The cell's configuration
(``configs/<config>.json``), traffic mix (``traffic/<traffic>.json``, which
names its data generator and its driver), limits (``limits/<cell>.json``)
and per-layer metric readers (``metrics/<metric>.py``) are found by the
names in BENCHMARK.json. Exits non-zero, with no result, without a CUDA
card or with fewer than the cell asks for, or when the process has
loaded jax, jaxlib, flax, optax or the JAX package (whole top-level
names) once the window has closed. The last line of standard output is
the result as one JSON object; the checked numbers, each beside its
limit, are the last lines of standard error and the result's last key.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root, for this process and for the loader's workers
sys.path.insert(0, ROOT)
os.environ["PYTHONPATH"] = os.pathsep.join(
    [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
              if p])


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    import torch

    from portbench import harness

    cell = harness.cell(args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s), this machine has {have}", file=sys.stderr)
        return 2
    driver = harness.load(cell["traffic_spec"]["driver"])
    result = driver.run(cell, args.seed, args.seconds, bool(args.trace),
                        t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 3
    killed = harness.stop_children()
    if killed:
        print(f"portbench: stopped leftover processes {killed}",
              file=sys.stderr)
    print(f"portbench: {harness.power_limit()}, peak "
          f"{result['device']['memory_peak_bytes']} bytes", file=sys.stderr)
    harness.print_result(result)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        from portbench import harness as _harness

        _harness.stop_children()
    sys.exit(rc)
