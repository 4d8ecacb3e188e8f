"""Process-wide zip handle cache with the ``archive.zip@/inner/path``
convention (ref: common/utils/zipreader.py:8-86).

Port copy of ``vlbert_tpu/data/zipreader.py``, unchanged but for its
imports: the port imports nothing of the JAX package.
``tests/test_torch_host_copies.py`` holds it to the original.
"""

from __future__ import annotations

import io
import os
import threading
import zipfile


class ZipReader:
    # keyed by (pid, path): a handle opened before fork shares its OS file
    # offset with every fork-pool worker — interleaved seek/read between
    # processes returns bytes from the wrong member. Keying by pid makes
    # each worker open its own handle lazily after fork.
    _handles = {}
    _lock = threading.Lock()

    @classmethod
    def get_zipfile(cls, path):
        key = (os.getpid(), path)
        with cls._lock:      # threaded loaders race the check-then-open
            zf = cls._handles.get(key)
            if zf is None:
                zf = cls._handles[key] = zipfile.ZipFile(path, "r")
        return zf

    @staticmethod
    def split_zip_style_path(path):
        assert "@" in path, f"character '@' is not found in {path}"
        pos = path.index("@")
        zip_path = path[:pos]
        inner = path[pos + 1:].lstrip("/")
        return zip_path, inner

    @classmethod
    def read(cls, path):
        zip_path, inner = cls.split_zip_style_path(path)
        return cls.get_zipfile(zip_path).read(inner)

    @classmethod
    def imread(cls, path):
        """Returns uint8 RGB [H, W, 3].

        uint8 is kept through decode/resize/flip; Normalize produces the
        float32 BGR255-minus-mean values in one pass (numerically identical
        to the reference's ToTensor(/255) -> Normalize(*255) round trip,
        common/.../transforms.py:82-97, at a quarter of the memory traffic).
        """
        from PIL import Image
        import numpy as np

        data = cls.read(path)
        img = Image.open(io.BytesIO(data)).convert("RGB")
        return np.asarray(img, np.uint8)


def read_image(path):
    """Read an image (uint8 RGB) from a plain path or zip@/inner path."""
    import numpy as np

    if "@" in path:
        return ZipReader.imread(path)
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"), np.uint8)
