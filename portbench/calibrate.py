"""The readings a cell's limits are set from, on the card: the program's
checked numbers over many seeds, the float8 control's, and the faults'
(the timed path broken underneath), at the cell's own size, without a
window. The benchmark's own runs never run this.

    python3 portbench/calibrate.py --workload <cell> --seeds 1 2 ... \
        [--control 3] [--faults half_batch answer] [--fault-seeds 3]

Prints one JSON line a reading: {"seed", "mode", "numbers", "worst",
"program_loss", "leaves" (every leaf's norms on both sides), "seconds"}.
``limits/<cell>.readings.jsonl`` keeps, without the leaves, the readings
that the cell's ``limits/<cell>.json`` was set from.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ["PYTHONPATH"] = os.pathsep.join(
    [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
              if p])


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control", type=int, default=0,
                   help="the control on the first n seeds")
    p.add_argument("--faults", nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, default=3)
    args = p.parse_args(argv)
    from portbench import harness

    cell = harness.cell(args.workload)
    driver = harness.load(cell["traffic_spec"]["driver"])
    runs = [(s, "program", None) for s in args.seeds]
    runs += [(s, "control", None) for s in args.seeds[:args.control]]
    runs += [(s, f, f) for f in args.faults
             for s in args.seeds[:args.fault_seeds]]
    for seed, mode, fault in runs:
        t = time.perf_counter()
        r = driver.run(cell, seed, 0.0, False, t_start=t, fault=fault,
                       control=mode == "control", window=False,
                       keep_leaves=True)
        print(json.dumps({"seed": seed, "mode": mode,
                          "numbers": {k: v["value"]
                                      for k, v in r["check"].items()},
                          "worst": r["detail"]["worst"],
                          "program_loss": r["detail"]["program_loss"],
                          "leaves": r["detail"]["leaves"],
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        from portbench import harness as _harness

        _harness.stop_children()
    sys.exit(rc)
