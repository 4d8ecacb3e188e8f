"""Build the package's CUDA sources into one shared library and load it.

``nvcc`` compiles every ``csrc/*.cu`` of this package for ``sm_90a``, one
process per source, all started together, and links the objects into a
shared library with a plain C interface, loaded with ``ctypes``. The build
runs at first use and lands in ``_build/`` beside the package (listed in
``.gitignore``); the library's file name carries a hash of the sources and
the command line, so it is rebuilt only when a source changes.

Every C entry point returns ``cudaGetLastError()`` after its launch; the
wrappers raise when it is not 0. There is no fallback: a missing ``nvcc`` or
a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
DEFAULT_BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_U = ctypes.c_uint
_Q = ctypes.c_ulonglong
_STRIDES = (_L,) * 9         # q, k, v strides over (b, l, h)

_ATTN_FWD = (_P, _P, _P, _P, _P, _I, _I, _I, _I, *_STRIDES, _F, _P)

# attention with prob dropout takes the same arguments in fp32 (CUDA cores)
# and bf16 (tensor cores): q, k, v, bias, out, B, L, H, D, strides, scale,
# bits (or NULL), thresh, drop_scale, seed, stream
_ATTN_DROP_FWD = (_P, _P, _P, _P, _P, _I, _I, _I, _I, *_STRIDES, _F, _P, _U,
                  _F, _Q, _P)
# q, k, v, bias, g, dq, dk, dv, dbias_h, stats, B, L, H, D, strides, scale,
# bits (or NULL), thresh, drop_scale, seed, stream
_ATTN_DROP_BWD = (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                  *_STRIDES, _F, _P, _U, _F, _Q, _P)

# C signatures of the entry points (pointers and the stream as void*)
SIGNATURES = {
    # feat, feat_is_bf16, boxes, box_mask, out, out_is_bf16, B, H, W, C,
    # O, P, Q, spatial_scale, sampling_ratio, max_grid, stream
    "roi_align_fwd": (_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                      _F, _I, _I, _P),
    # g, g_is_bf16, boxes, box_mask, dfeat, dfeat_is_bf16, B, H, W, C, O,
    # P, Q, spatial_scale, sampling_ratio, max_grid, stream
    "roi_align_bwd": (_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                      _F, _I, _I, _P),
    # attention without dropout in fp32 (CUDA cores) and bf16 (tensor
    # cores): q, k, v, bias, out, B, L, H, D, q strides (b, l, h), k
    # strides, v strides, scale, stream
    "attention_fwd_f32": _ATTN_FWD,
    "attention_fwd_bf16": _ATTN_FWD,
    # x, out, n, is_bf16, bits (or NULL), thresh, scale, seed, stream
    "dropout_fwd": (_P, _P, _L, _I, _P, _U, _F, _Q, _P),
    "attention_dropout_fwd_f32": _ATTN_DROP_FWD,
    "attention_dropout_bwd_f32": _ATTN_DROP_BWD,
    "attention_dropout_fwd_bf16": _ATTN_DROP_FWD,
    "attention_dropout_bwd_bf16": _ATTN_DROP_BWD,
}


def sources():
    """The CUDA sources of this package, in a fixed order."""
    return sorted(CSRC_DIR.glob("*.cu"))


def find_nvcc():
    cands = [shutil.which("nvcc")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(os.path.join(os.environ[env], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME, $CUDA_PATH and "
        "/usr/local/cuda/bin): the CUDA kernels of vlbert_tpu_torch are "
        "compiled from csrc/ at first use and need the CUDA toolkit")


def compile_command(nvcc, src, obj):
    """One source -> one object file."""
    return [str(nvcc), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]


def link_command(nvcc, objs, out):
    return [str(nvcc), "-shared", "-o", str(out), *map(str, objs)]


def _digest(srcs):
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    for s in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def build(build_dir=None):
    """Compile the sources unless a library of the same hash exists.

    Returns the library's path."""
    build_dir = Path(build_dir or DEFAULT_BUILD_DIR)
    srcs = sources()
    lib = build_dir / f"libvlbert_kernels_{_digest(srcs)}.so"
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    build_dir.mkdir(parents=True, exist_ok=True)
    # compile every source at once, then link to a temporary name and
    # rename: a cut build leaves no half-written library behind under the
    # final name
    tmp_dir = Path(tempfile.mkdtemp(dir=build_dir))
    try:
        objs = [tmp_dir / f"{s.stem}.o" for s in srcs]
        procs = [subprocess.Popen(compile_command(nvcc, s, o),
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(srcs, objs)]
        logs = [p.communicate()[0] for p in procs]
        failed = [(s.name, p.returncode, log)
                  for s, p, log in zip(srcs, procs, logs) if p.returncode]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{name} ({rc}):\n{log}" for name, rc, log in failed))
        tmp = tmp_dir / lib.name
        proc = subprocess.run(link_command(nvcc, objs, tmp),
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}):\n{proc.stdout}\n"
                f"{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        shutil.rmtree(tmp_dir, ignore_errors=True)
    return lib


@functools.lru_cache(maxsize=None)
def load(build_dir=None):
    """Build (if needed) and load the kernel library; cached per process."""
    lib = ctypes.CDLL(str(build(build_dir)))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check(err, name):
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
