#!/usr/bin/env python
"""K1 (ROIAlign forward) and K1b (its dF backward) on the card: device
time by kernel name on the main paths' routes, and what bounds K1.

    python tools/bench_k1_torch.py [--tree DIR] [--probes] [--json FILE]

At the serve shape of chip_smoke.py (bf16 body4 [1,38,63,1024], 16 box
slots of which 14 are live, 14x14 bins, sampling ratio 1), warm (the map
stays in L2 between calls, as the serve path finds it right after the
backbone wrote it), 50 calls a window:

  main      the route models/fast_rcnn.py runs: roi_align(...,
            out_dtype=bf16) where the package's roi_align takes out_dtype,
            else roi_align(...).to(bf16), as the serve path ran it before;
  fp32_out  roi_align(...) with its default fp32 output.

Each is given by kernel name (torch.profiler), with the CUDA-event time per
call and the kernels a call runs. Then K1b (bf16 g and dF, sampling ratio
1) at chip_smoke.py's K1B_TIMED calls:

  k1b/vcr           VCR's training shape, g [4,108,14,14,1024] with 108,
                    60, 21 and 8 live slots, dF [4,38,75,1024];
  k1b/vcr_all_live  the same with all 432 slots live;
  k1b/refcoco       RefCOCO+'s, dF [4,38,63,1024], at most 16 live a map;

and k1b_sha256: a digest of K1b's dF on every case, dtype pair and
sampling ratio of chip_smoke.py's k1b_parity, so that two trees' outputs
are compared bit for bit; k1_sha256 the same of K1's output over
k1_parity's cases (fp32 and bf16 maps and outputs). With --probes,
also what bounds K1b:

  k1b/padded        VCR's call with every slot padded: the launch, the
                    per-block set-up and the zero stores;
  k1b/c128          VCR's boxes with C = 128: an eighth of the g bytes,
                    the same weights and the same chains of sums.

--tree DIR times the vlbert_tpu_torch package of another checkout (an
earlier commit unpacked with ``git archive``) with this checkout's harness,
so that two versions are compared in one process each on one card: run
parent, this, this, parent.

--probes adds, for the package timed, what bounds K1 (bf16 out):

  cold      the L2 flushed (a 128 MB fill) before each call; K1 alone;
  tiny      the same slots with boxes of one map pixel: every bin of a
            roi reads the same four taps, so the taps' gathers from L2 fall
            to almost nothing while the bytes K1 must move stay;
  padded    every slot padded: K1 only stores the zeros of its output, in
            bf16 and in fp32 (the stores and the launch alone);
  one_slot  one padded slot: a 14x14 output, the launch alone;

with the rates they imply: bytes that must move (map read once, output
written once) and the tap gathers (4 taps x C channels a live output
pixel) over K1's time.

Needs a CUDA card. Prints one JSON line; --json also writes it to FILE.
"""

import argparse
import hashlib
import importlib.util
import inspect
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _harness():
    """This checkout's chip_smoke.py, whichever package is timed."""
    spec = importlib.util.spec_from_file_location(
        "k1_harness", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def k1b(h, troi, dev, probes):
    """K1b's times at the K1B_TIMED calls (and the probes) and the digests
    of its dF."""
    import torch

    calls = {case: h.k1b_inputs(dev, case) for case in h.K1B_TIMED}
    if probes:
        feat, boxes, mask, g = calls["vcr"]
        calls["padded"] = (feat, boxes, torch.zeros_like(mask), g)
        calls["c128"] = (feat[..., :128].contiguous(), boxes, mask,
                         g[..., :128].contiguous())
    out = {}
    for case, (feat, boxes, mask, g) in calls.items():
        args = (g, boxes, mask, feat.shape, feat.dtype, 14, 14, 1.0 / 16, 1)
        t = h.time_calls(lambda: troi._roi_align_bwd_cuda(*args),
                         h.K1B_KERNEL)
        out[f"k1b/{case}"] = {"ms": t["ms"], "call_ms": t["call_ms"],
                              "live": int(mask.sum())}
    digests = {}
    gen = torch.Generator(device=dev).manual_seed(h.SEED + 13)
    for name, feat, boxes, mask, ratios in h.k1_cases(dev):
        B, _, _, C = feat.shape
        g32 = torch.randn(B, boxes.shape[1], 14, 14, C, generator=gen,
                          device=dev)
        g32[~mask] = 1e6
        for dtype in (torch.float32, torch.bfloat16):
            for g_dtype in (torch.float32, torch.bfloat16):
                for sr in ratios:
                    df = troi._roi_align_bwd_cuda(
                        g32.to(g_dtype), boxes, mask, feat.shape, dtype, 14,
                        14, 1.0 / 16, sr)
                    key = (f"{name}/{str(g_dtype)[6:]}->{str(dtype)[6:]}"
                           f"/sr{sr}")
                    digests[key] = hashlib.sha256(
                        df.view(torch.uint8).cpu().numpy().tobytes()
                    ).hexdigest()[:16]
    out["k1b_sha256"] = digests
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=REPO,
                    help="checkout whose vlbert_tpu_torch is timed")
    ap.add_argument("--probes", action="store_true")
    ap.add_argument("--json", default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("bench_k1_torch: needs a CUDA card")
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    h = _harness()
    from vlbert_tpu_torch.ops import roi_align as troi
    from vlbert_tpu_torch.ops.roi_align import roi_align

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    feat, boxes, mask = h.k1_serve_inputs(dev)
    f = feat.to(torch.bfloat16)
    bf16 = torch.bfloat16
    takes_out_dtype = "out_dtype" in inspect.signature(roi_align).parameters

    def k1(fn):
        return h.time_calls(fn, h.K1_KERNEL)

    def main_route(bx=boxes, m=mask, out_dtype=bf16):
        if takes_out_dtype:
            return roi_align(f, bx, m, sampling_ratio=1, out_dtype=out_dtype)
        return roi_align(f, bx, m, sampling_ratio=1).to(out_dtype)

    res = {"tree": os.path.relpath(tree, REPO), "card": smi,
           "package": os.path.dirname(
               sys.modules["vlbert_tpu_torch"].__file__),
           "takes_out_dtype": takes_out_dtype,
           "main": k1(main_route),
           "fp32_out": k1(lambda: roi_align(f, boxes, mask,
                                                     sampling_ratio=1))}
    if args.probes:
        B, H, W, C = f.shape
        O, live = boxes.shape[1], int(mask.sum())
        out_bytes = B * O * 14 * 14 * C * 2
        must_move = B * H * W * C * 2 + B * O * 17 + out_bytes
        gathers = live * 14 * 14 * 4 * C * 2
        flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
        # one map pixel per slot, spread over the map; roi 1x1 after scaling
        g = torch.Generator(device=dev).manual_seed(h.SEED)
        xy = torch.rand(1, O, 2, generator=g, device=dev) \
            * torch.tensor([W - 2, H - 2], device=dev)
        tiny = torch.cat([xy, xy + 1.0], -1) * 16.0
        none = torch.zeros_like(mask)
        probes = {
            "cold": k1(lambda: (flush.fill_(1), main_route())),
            "tiny": k1(lambda: main_route(tiny)),
            "padded": k1(lambda: main_route(m=none)),
            "padded_fp32": k1(lambda: main_route(
                m=none, out_dtype=torch.float32)),
            "one_slot": k1(lambda: main_route(
                boxes[:, :1].contiguous(), none[:, :1].contiguous())),
        }
        for k in ("padded", "padded_fp32"):
            probes[k]["out_GB_per_s"] = (
                out_bytes * (2 if k == "padded_fp32" else 1)
                / probes[k]["ms"] / 1e6)
        for k in ("cold", "tiny"):
            probes[k]["must_move_GB_per_s"] = must_move / probes[k]["ms"] / 1e6
        for name, t in (("warm", res["main"]), ("cold", probes["cold"])):
            probes[f"{name}_rates"] = {
                "must_move_GB_per_s": must_move / t["ms"] / 1e6,
                "tap_gathers_GB_per_s": gathers / t["ms"] / 1e6}
        probes["bytes"] = {"must_move": must_move, "tap_gathers": gathers,
                           "live_slots": live}
        res["probes"] = probes
    digests = {}
    for name, feat, boxes, mask, ratios in h.k1_cases(dev):
        for dtype in (torch.float32, bf16):
            for out_dtype in (torch.float32, bf16):
                for sr in ratios:
                    out = roi_align(feat.to(dtype), boxes, mask,
                                    sampling_ratio=sr, out_dtype=out_dtype)
                    key = (f"{name}/{str(dtype)[6:]}->{str(out_dtype)[6:]}"
                           f"/sr{sr}")
                    digests[key] = hashlib.sha256(
                        out.view(torch.uint8).cpu().numpy().tobytes()
                    ).hexdigest()[:16]
    res["k1_sha256"] = digests
    if hasattr(troi, "_roi_align_bwd_cuda"):
        res.update(k1b(h, troi, dev, args.probes))
    line = json.dumps(res)
    print(line)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as fh:
            fh.write(line + "\n")


if __name__ == "__main__":
    main()
