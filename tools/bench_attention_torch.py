#!/usr/bin/env python
"""Attention kernels K2, K3 and K4 on the card, bf16 and fp32: device time
per call.

    python tools/bench_attention_torch.py [--tree DIR] [--json FILE]

At the VQA training shape of chip_smoke.py (B=16, H=12, L=128, D=64; q,
k, v views of one fused projection with q, k on its 2**-6 grid, 7 padded
keys and an all-masked batch row; Philox masks at rate 0.1), warm, 50
calls a window, in bf16 and in fp32:

  K2         fused_attention (the forward without dropout);
  K3         fused_attention_dropout (its forward);
  K4         the backward of one fused_attention_dropout (separate leaves);
  K2_B1_L41  K2 at the serve shape, one query of L = 41;
  K3_L173    K3 at VCR's training shape, B=16 L=173;
  K4_L173    K4 at VCR's training shape, B=16 L=173.

Each entry is chip_smoke.py's ``time_calls``: the summed device time of
the kernels a call runs (torch.profiler), the CUDA-event time per call,
and the device ms by kernel name. ``sha256`` holds a digest of each
kernel's result on its own seeded inputs (K2's and K3's output, K4's dq,
dk, dv and dbias, and K5's output at [16,128,768] in Philox and
explicit-bits mode), in bf16 and fp32, so that two trees' outputs are
compared bit for bit.

``ptxas`` holds, for each kernel of the K2-K4 sources, the registers and
the bytes of spill stores and loads that ``ptxas -v`` reports when the
package's own ``nvcc`` flags compile it.

--tree DIR times the vlbert_tpu_torch package of another checkout (an
earlier commit unpacked with ``git archive``) with this checkout's harness,
so that two versions are compared in one process each on one card: run
parent, this, this, parent.

Needs a CUDA card. Prints one JSON line; --json also writes it to FILE.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _harness():
    """This checkout's chip_smoke.py, whichever package is timed."""
    spec = importlib.util.spec_from_file_location(
        "attention_harness", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def digests(h, dev):
    """{kernel/dtype/L: sha256 of its result}, each on inputs made from
    chip_smoke.py's seed."""
    import hashlib

    import torch
    from vlbert_tpu_torch.ops.attention import (fused_attention,
                                                fused_attention_dropout)
    from vlbert_tpu_torch.ops.dropout import hw_dropout

    def sha(*ts):
        m = hashlib.sha256()
        for t in ts:
            m.update(t.detach().contiguous().view(torch.uint8).cpu()
                     .numpy().tobytes())
        return m.hexdigest()[:16]

    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype)[6:]
        for L in (41, 128, 173):
            g = torch.Generator(device=dev).manual_seed(h.SEED + L)
            qkv, (q, k, v), bias = h._train_qkv(g, dev, dtype, L=L)
            gy = torch.randn(q.shape, generator=g, device=dev).to(dtype)
            with torch.no_grad():
                out[f"K2/{dn}/L{L}"] = sha(fused_attention(q, k, v, bias))
            a = fused_attention_dropout(q, k, v, bias, h.DROP_RATE,
                                        seed=h.SEED)
            out[f"K3/{dn}/L{L}"] = sha(a)
            out[f"K4/{dn}/L{L}"] = sha(*torch.autograd.grad(a, (qkv, bias),
                                                            gy))
        g = torch.Generator(device=dev).manual_seed(h.SEED + 5)
        x = torch.randn(16, 128, 768, generator=g, device=dev).to(dtype)
        bits = torch.randint(0, 65536, x.shape, generator=g, device=dev,
                             dtype=torch.int32)
        out[f"K5/{dn}"] = sha(hw_dropout(x, h.DROP_RATE, seed=h.SEED),
                              hw_dropout(x, h.DROP_RATE, bits=bits))
    return out


def _kernel_name(mangled):
    """A kernel's name from its mangled one: its first identifier outside
    the anonymous namespace, with its template arguments (bools, bf16 and
    fp16), e.g. ``attn_fwd_mma<true,bf16,false>``."""
    import re

    name, rest = mangled, ""
    pos = 3 if mangled.startswith("_ZN") else 2
    while m := re.match(r"\d+", mangled[pos:]):
        start = pos + len(m.group())
        ident = mangled[start:start + int(m.group())]
        pos = start + len(ident)
        if not ident.startswith("_GLOBAL__N"):
            name, rest = ident, mangled[pos:]
            break
    if not rest.startswith("I") or "Ev" not in rest:
        return name
    words = {"Lb1E": "true", "Lb0E": "false", "13__nv_bfloat16": "bf16",
             "6__half": "fp16"}
    args = re.findall("|".join(words), rest[1:rest.index("Ev")])
    return f"{name}<{','.join(words[a] for a in args)}>"


def ptxas():
    """{kernel: "R registers, S spill stores, L spill loads"} of the
    imported package's attention sources, from ``nvcc -Xptxas -v``."""
    import re
    import tempfile

    from vlbert_tpu_torch.kernels import build

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for src in ("attention_dropout_mma.cu", "attention_f32_mma.cu"):
            p = subprocess.run(
                [build.find_nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                 "-o", os.path.join(tmp, "k.o"), str(build.CSRC_DIR / src)],
                capture_output=True, text=True, check=True)
            name, spill = None, ""
            for line in (p.stdout + p.stderr).splitlines():
                m = re.search(r"entry function '(\w+)'", line)
                if m:
                    name = _kernel_name(m.group(1))
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", line)
                if m:
                    spill = (f"{m.group(1)} spill stores, {m.group(2)} "
                             f"spill loads")
                m = re.search(r"Used (\d+) registers", line)
                if m and name:
                    out[name] = f"{m.group(1)} registers, {spill}"
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=REPO,
                    help="checkout whose vlbert_tpu_torch is timed")
    ap.add_argument("--json", default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("bench_attention_torch: needs a CUDA card")
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    h = _harness()
    from vlbert_tpu_torch.ops.attention import (fused_attention,
                                                fused_attention_dropout)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    g = torch.Generator(device=dev).manual_seed(h.SEED)

    def timed(fn):
        t = h.time_calls(fn)
        return {"ms": t["route_ms"], "call_ms": t["call_ms"],
                "by_kernel": t["by_kernel"]}

    def k4(dtype, L):
        _, (q, k, v), bias = h._train_qkv(g, dev, dtype, L=L)
        leaves = [t.detach().contiguous().requires_grad_() for t in (q, k, v)]
        gy = torch.randn(q.shape, generator=g, device=dev).to(dtype)
        out = fused_attention_dropout(*leaves, bias.detach(), h.DROP_RATE,
                                      seed=h.SEED)
        return timed(lambda: torch.autograd.grad(out, leaves, gy,
                                                 retain_graph=True))

    res = {"tree": os.path.relpath(tree, REPO), "card": smi,
           "package": os.path.dirname(
               sys.modules["vlbert_tpu_torch"].__file__)}
    def k3(q, k, v, bias):
        return timed(lambda: fused_attention_dropout(
            q, k, v, bias, h.DROP_RATE, seed=h.SEED))

    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype)[6:]
        with torch.no_grad():
            _, (q, k, v), bias = h._train_qkv(g, dev, dtype)
            bias = bias.detach()
            res[f"K2/{dn}"] = timed(lambda: fused_attention(q, k, v, bias))
            res[f"K3/{dn}"] = k3(q, k, v, bias)
            _, qkv173, b173 = h._train_qkv(g, dev, dtype, L=173)
            res[f"K3_L173/{dn}"] = k3(*qkv173, b173.detach())
            qkv = torch.randn(1, 41, 3 * 768, generator=g, device=dev) \
                .to(dtype)
            q1, k1, v1 = (t.view(1, 41, 12, 64)
                          for t in qkv.split(768, dim=-1))
            b1 = torch.zeros(1, 1, 1, 41, device=dev)
            res[f"K2_B1_L41/{dn}"] = timed(
                lambda: fused_attention(q1, k1, v1, b1))
        res[f"K4/{dn}"] = k4(dtype, 128)
        res[f"K4_L173/{dn}"] = k4(dtype, 173)
    res["sha256"] = digests(h, dev)
    res["ptxas"] = ptxas()
    line = json.dumps(res)
    print(line)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as fh:
            fh.write(line + "\n")


if __name__ == "__main__":
    main()
