"""Build-on-demand loader for the port's C++ host libraries (port of
vlbert_tpu/data/native_build.py).

``vlbert_tpu_torch/csrc/host/{name}.cc`` (the port's copies of the JAX
package's native/ sources: ``wordpiece`` for ``native_tokenizer.py``,
``maskapi`` for ``coco_mask.py``) is compiled with ``g++ -O3 -fPIC
-shared`` into ``vlbert_tpu_torch/_build/lib{name}-{digest}.so`` at first
use, the digest that of the source, so an edited source builds anew. The
build is serialized by an flock: forked loader workers that load the
library at once must not run parallel compilers writing the file one of
them is about to dlopen. The JAX package's own build output (native/*.so)
is never loaded.

``load_native_lib`` returns None when the library cannot be built (no
``g++``, a read-only tree), and the callers take their Python paths,
which give the same tokens and masks. ``BUILT`` records what this
process compiled, for a caller that must know the library was built on
the machine it runs on.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import time
from pathlib import Path

logger = logging.getLogger(__name__)

PACKAGE_DIR = Path(__file__).resolve().parent.parent
HOST_SRC_DIR = PACKAGE_DIR / "csrc" / "host"
BUILD_DIR = PACKAGE_DIR / "_build"

# {name: seconds} of the libraries this process compiled
BUILT: dict = {}
_LOADED: dict = {}


def source(name):
    return HOST_SRC_DIR / f"{name}.cc"


def library_path(name, build_dir=None):
    """Where ``name``'s library of the current source lives."""
    digest = hashlib.sha256(source(name).read_bytes()).hexdigest()[:16]
    return Path(build_dir or BUILD_DIR) / f"lib{name}-{digest}.so"


def compile_command(cxx, src, out):
    return [cxx, "-O3", "-fPIC", "-std=c++17", "-Wall", "-shared", "-o",
            str(out), str(src)]


def _build(name, path):
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        logger.warning("no g++: lib%s not built (Python path used)", name)
        return False
    path.parent.mkdir(parents=True, exist_ok=True)
    import fcntl

    with open(path.parent / ".host_build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():                 # another process built it
            return True
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(compile_command(cxx, source(name), tmp),
                              check=False, capture_output=True, text=True)
        if proc.returncode != 0:
            logger.warning("lib%s build failed (Python path used):\n%s",
                           name, proc.stderr[-2000:])
            return False
        os.replace(tmp, path)
        BUILT[name] = time.perf_counter() - t0
    return True


def load_native_lib(name):
    """The CDLL of ``csrc/host/{name}.cc``, built with g++ if absent;
    None when it cannot be built."""
    if name in _LOADED:
        return _LOADED[name]
    lib = None
    try:
        path = library_path(name)
        if path.exists() or _build(name, path):
            lib = ctypes.CDLL(str(path))
    except OSError as e:                  # read-only tree, a bad .so
        logger.warning("lib%s unavailable (%s): Python path used", name, e)
    _LOADED[name] = lib
    return lib
