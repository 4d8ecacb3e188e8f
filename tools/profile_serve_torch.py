#!/usr/bin/env python
"""Where a RefCOCO+ query's time goes on the card (vlbert_tpu_torch).

Builds the serving model of chip_smoke.py (base config, full width, random
weights from a seed, bf16), warms it up, then traces 8 distinct queries with
torch.profiler and prints: host preprocess ms per query, wall ms per
query without and under the profiler, summed device time per query, the
device's idle share of the unprofiled wall time, the top ops by device
time, and the two kernels' mean device time per launch.

    python tools/profile_serve_torch.py [--device cuda] [--rows 25]

Needs a CUDA card. The profiler adds host overhead per op, so its wall time
is above the unprofiled latency that chip_smoke.py reports.
"""

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=25)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from vlbert_tpu_torch.data.transforms import build_transforms
    from vlbert_tpu_torch.engine.serve import RefCOCOServer
    from vlbert_tpu_torch.models.layers import init_weights
    from vlbert_tpu_torch.models.task_modules import build_module
    from vlbert_tpu_torch.utils.config import load_config

    dev = torch.device(args.device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        sys.exit("profile_serve_torch: needs a CUDA device")
    cfg = load_config("refcoco", chip_smoke.CFG)
    cfg.NETWORK.VLBERT.visual_scale_text_init = 1.0
    cfg.NETWORK.VLBERT.visual_scale_object_init = 1.0
    model = build_module(cfg, "refcoco", dtype=torch.bfloat16, device=dev)
    init_weights(model, torch.Generator(device=dev).manual_seed(0))
    srv = RefCOCOServer(model, chip_smoke.HashTokenizer(),
                        build_transforms(cfg, "test"))
    queries = chip_smoke.make_queries()
    t0 = time.perf_counter()
    batches = [srv.preprocess(*q) for q in queries]
    pre_ms = (time.perf_counter() - t0) * 1e3 / len(queries)
    for b in batches[:3]:
        srv.infer(b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches:
        srv.infer(b)
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            srv.infer(b)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy_ms = sum(e.device_time for e in events) / 1e3
    n = len(batches)
    print(f"{torch.cuda.get_device_name(dev)}; host preprocess "
          f"{pre_ms:.2f} ms/query; wall {plain_wall_ms / n:.2f} ms/query "
          f"({wall_ms / n:.2f} under the profiler); device busy "
          f"{busy_ms / n:.2f} ms/query; idle share "
          f"{1 - busy_ms / plain_wall_ms:.3f} of the unprofiled wall; "
          f"{len(events) / n:.0f} device ops/query")
    print(prof.key_averages().table(sort_by="device_time_total",
                                    row_limit=args.rows,
                                    max_name_column_width=60))
    # K1, and K2 in bf16 (the tensor-core kernel it shares with K3)
    for name in ("roi_align_fwd_kernel", "attn_fwd_mma<false,"):
        ts = [e.device_time for e in events if name in e.name]
        print(f"{name}: {len(ts)} launches, mean device "
              f"{sum(ts) / max(len(ts), 1):.2f} us")


if __name__ == "__main__":
    main()
