"""Shared dataset IO helpers (one copy; previously drifted across the four
dataset modules — see the '.zip@' vs '@' routing divergence fixed in r2).

Port copy of ``vlbert_tpu/data/io_utils.py``, unchanged but for its imports:
the port imports nothing of the JAX package.
``tests/test_torch_host_copies.py`` holds it to the original.
"""

from __future__ import annotations

import base64
import json


def load_jsonl(path):
    """One JSON object per non-blank line."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def b64_decode(s):
    """Base64 (with newlines) -> bytes, as the reference's frcnn jsons use."""
    return base64.decodebytes(s.encode())


def load_json_maybe_zip(path):
    """Plain json file, or a member inside a zip via 'archive.zip@/inner'."""
    if ".zip@" in path:
        from vlbert_tpu_torch.data.zipreader import ZipReader

        return json.loads(ZipReader.read(path).decode())
    with open(path) as f:
        return json.load(f)


def resolve_data_file(data_path, rel, zip_mode=False):
    """Annotation-relative file -> full path. Under zip_mode the file's
    direct parent directory is read as a '{dir}.zip@/{dir}' archive
    (the reference's path-template convention, e.g. vqa.py:141-152,
    refcoco.py:146,268); absolute and already-zip-style paths pass through.
    """
    import os

    if os.path.isabs(rel) or ".zip@" in rel:
        return rel if os.path.isabs(rel) else os.path.join(data_path, rel)
    if zip_mode:
        head, tail = os.path.split(rel)
        parent, last = os.path.split(head)
        if last:
            rel = os.path.join(parent, f"{last}.zip@/{last}", tail)
    return os.path.join(data_path, rel)
