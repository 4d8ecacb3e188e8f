"""Build the package's CUDA sources into one shared library and load it.

``nvcc`` compiles every ``csrc/*.cu`` of this package for ``sm_90a`` into a
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
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# C signatures of the entry points (pointers and the stream as void*)
SIGNATURES = {
    # feat, feat_is_bf16, boxes, box_mask, out, B, H, W, C, O, P, Q,
    # spatial_scale, sampling_ratio, max_grid, stream
    "roi_align_fwd": (_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                      _F, _I, _I, _P),
    # q, k, v, bias, out, is_bf16, B, L, H, D,
    # q strides (b, l, h), k strides, v strides, scale, stream
    "attention_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                      _L, _L, _L, _L, _L, _L, _L, _L, _L, _F, _P),
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


def nvcc_command(nvcc, srcs, out):
    return [str(nvcc), *NVCC_FLAGS, "-o", str(out), *map(str, srcs)]


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
    # compile to a temporary name, then rename: a cut build leaves no
    # half-written library behind under the final name
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    try:
        proc = subprocess.run(nvcc_command(nvcc, srcs, tmp),
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n"
                f"{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
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
