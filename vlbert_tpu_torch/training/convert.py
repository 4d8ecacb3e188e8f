"""JAX params -> port state_dict: the inverse of vlbert_tpu.training.convert.

Port modules keep the reference's torch parameter names, so
``vlbert_tpu.training.convert.convert_state_dict(port.state_dict())`` gives
the JAX tree. ``state_dict_from_jax`` goes the other way: for each port
parameter name, ``map_reference_name(normalize_torch_name(name))`` gives the
JAX path and the layout transform, which is inverted here. A fused
``...attention.self.qkv`` leaf (TPU.FUSED_QKV) is split back into query,
key and value.

One head needs a task-aware rename: the reference names its VQA ``mlm``
classifier ``final_mlp.0`` (transform) and ``final_mlp.2`` (linear), which
the JAX converter maps to RefCOCO's leaves (``final_mlp_transform.dense``,
``final_mlp_fc``), while the JAX VQA module names them
``final_mlp.transform_dense`` and ``final_mlp.dense_0``. For a port module
whose ``final_mlp`` is an ``mlm`` Classifier the paths are renamed here.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from vlbert_tpu.training.convert import map_reference_name, normalize_torch_name

# JAX-converter path prefix -> the JAX VQA mlm classifier's path prefix
_MLM_HEAD = (("final_mlp_transform.dense.", "final_mlp.transform_dense."),
             ("final_mlp_fc.", "final_mlp.dense_0."))

_QKV = re.compile(r"^(.*attention\.self\.)(query|key|value)\.(kernel|bias)$")


def _inverse(arr, transform):
    arr = np.asarray(arr)
    if transform == "linear":         # flax [in, out] -> torch [out, in]
        return arr.T
    if transform == "conv":           # (kh, kw, in, out) -> (out, in, kh, kw)
        return np.transpose(arr, (3, 2, 0, 1))
    if transform == "squeeze0":
        return arr[None]
    return arr


def _lookup(flat, path, used):
    """The JAX leaf at ``path``, or its third of a fused qkv leaf."""
    if path in flat:
        used.add(path)
        return flat[path]
    m = _QKV.match(path)
    if m:
        prefix, which, kind = m.groups()
        fused = f"{prefix}qkv.{kind}"
        if fused in flat:
            used.add(fused)
            part = ("query", "key", "value").index(which)
            return np.split(np.asarray(flat[fused]), 3,
                            axis=1 if kind == "kernel" else 0)[part]
    return None


def state_dict_from_jax(flat, module):
    """JAX params as a flat {dot.path: np.ndarray} -> the port module's
    state_dict ({name: torch.Tensor} on the CPU, fp32 as stored).

    Raises on a port parameter with no source, on a shape mismatch and on
    any JAX leaf left unused.
    """
    from vlbert_tpu_torch.models.task_modules import Classifier

    head = getattr(module, "final_mlp", None)
    renames = _MLM_HEAD if isinstance(head, Classifier) \
        and head.kind == "mlm" else ()
    out, used, missing = {}, set(), []
    for name, ref in module.state_dict().items():
        mapped = map_reference_name(normalize_torch_name(name))
        arr = None
        if mapped is not None:
            path, transform = mapped
            for old, new in renames:
                if path.startswith(old):
                    path = new + path[len(old):]
            arr = _lookup(flat, path, used)
        if arr is None:
            missing.append(name)
            continue
        arr = _inverse(arr, transform)
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{name}: JAX leaf {path} has shape "
                             f"{arr.shape} after transform, port expects "
                             f"{tuple(ref.shape)}")
        out[name] = torch.tensor(arr, dtype=ref.dtype)
    if missing:
        raise KeyError(f"port parameters with no JAX source: {missing}")
    unused = sorted(set(flat) - used)
    if unused:
        raise KeyError(f"JAX leaves not used by the port: {unused}")
    return out
