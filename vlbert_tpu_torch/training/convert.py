"""JAX params -> port state_dict: the inverse of vlbert_tpu.training.convert.

Port modules keep the reference's torch parameter names, so
``vlbert_tpu.training.convert.convert_state_dict(port.state_dict())`` gives
the JAX tree. ``state_dict_from_jax`` goes the other way: for each port
parameter name, ``map_reference_name(normalize_torch_name(name))`` gives the
JAX path and the layout transform, which is inverted here. Those two name
rules (and ``_map_resnet_name``) are copies of the JAX converter's, kept
here because the port imports nothing of the JAX package;
``tests/test_torch_host_copies.py`` holds them to the originals. A fused
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

# --------------------------------------------------------------- name rules

def normalize_torch_name(name):
    """Strip DDP/TimeDistributed wrappers, fix TF-era LN names, and the
    reference's 'relationsip' typo."""
    name = re.sub(r"^module\.", "", name)
    name = name.replace("vlbert._module.", "vlbert.")
    name = name.replace(".gamma", ".weight_ln").replace(".beta", ".bias_ln")
    name = name.replace("relationsip_head", "relationship_head")
    return name


def map_reference_name(name):
    """Map a normalized reference param name to (flax_path, transform).

    Returns None for buffers/params with no counterpart.
    transform in {'linear', 'conv', 'none'}.
    """
    n = name

    # ---- LayerNorm weight/bias (incl. TF-era renames) ----
    n = n.replace(".weight_ln", ".weight").replace(".bias_ln", ".bias")

    # ---- BERT encoder layers ----
    m = re.search(r"encoder\.layer\.(\d+)\.(.*)", n)
    if m:
        i, rest = m.group(1), m.group(2)
        prefix = n[: m.start()] + f"encoder.layer_{i}."
        table = {
            "attention.self.query.weight": ("attention.self.query.kernel", "linear"),
            "attention.self.query.bias": ("attention.self.query.bias", "none"),
            "attention.self.key.weight": ("attention.self.key.kernel", "linear"),
            "attention.self.key.bias": ("attention.self.key.bias", "none"),
            "attention.self.value.weight": ("attention.self.value.kernel", "linear"),
            "attention.self.value.bias": ("attention.self.value.bias", "none"),
            "attention.output.dense.weight": ("attention.output_dense.kernel", "linear"),
            "attention.output.dense.bias": ("attention.output_dense.bias", "none"),
            "attention.output.LayerNorm.weight": ("attention.output_LayerNorm.scale", "none"),
            "attention.output.LayerNorm.bias": ("attention.output_LayerNorm.bias", "none"),
            "intermediate.dense.weight": ("intermediate_dense.kernel", "linear"),
            "intermediate.dense.bias": ("intermediate_dense.bias", "none"),
            "output.dense.weight": ("output_dense.kernel", "linear"),
            "output.dense.bias": ("output_dense.bias", "none"),
            "output.LayerNorm.weight": ("output_LayerNorm.scale", "none"),
            "output.LayerNorm.bias": ("output_LayerNorm.bias", "none"),
        }
        if rest.replace("weight_ln", "weight").replace("bias_ln", "bias") in table:
            tgt, tf = table[rest.replace("weight_ln", "weight").replace("bias_ln", "bias")]
            return prefix + tgt, tf
        return None

    # ---- embeddings / pooler / visual fusion in VisualLinguisticBert ----
    simple = [
        (r"word_embeddings\.weight$", "word_embeddings.embedding", "none"),
        (r"special_word_embeddings\.weight$", "special_word_embeddings.embedding", "none"),
        (r"end_embedding\.weight$", "end_embedding.embedding", "none"),
        (r"position_embeddings\.weight$", "position_embeddings.embedding", "none"),
        (r"token_type_embeddings\.weight$", "token_type_embeddings.embedding", "none"),
        (r"embedding_LayerNorm\.weight$", "embedding_LayerNorm.scale", "none"),
        (r"embedding_LayerNorm\.bias$", "embedding_LayerNorm.bias", "none"),
        (r"visual_ln_text\.weight$", "visual_ln_text.scale", "none"),
        (r"visual_ln_text\.bias$", "visual_ln_text.bias", "none"),
        (r"visual_ln_object\.weight$", "visual_ln_object.scale", "none"),
        (r"visual_ln_object\.bias$", "visual_ln_object.bias", "none"),
        (r"visual_scale_text$", "visual_scale_text", "none"),
        (r"visual_scale_object$", "visual_scale_object", "none"),
        (r"visual_1x1_text\.weight$", "visual_1x1_text.kernel", "linear"),
        (r"visual_1x1_text\.bias$", "visual_1x1_text.bias", "none"),
        (r"visual_1x1_object\.weight$", "visual_1x1_object.kernel", "linear"),
        (r"visual_1x1_object\.bias$", "visual_1x1_object.bias", "none"),
        (r"pooler\.dense\.weight$", "pooler.dense.kernel", "linear"),
        (r"pooler\.dense\.bias$", "pooler.dense.bias", "none"),
        (r"object_linguistic_embeddings\.weight$",
         "object_linguistic_embeddings.embedding", "none"),
        (r"object_mask_visual_embedding\.weight$", "object_mask_visual_embedding", "squeeze0"),
        (r"object_mask_word_embedding\.weight$", "object_mask_word_embedding", "squeeze0"),
        (r"aux_text_visual_embedding\.weight$", "aux_text_visual_embedding", "squeeze0"),
    ]
    for pat, tgt, tf in simple:
        m = re.search(pat, n)
        if m:
            return n[: m.start()] + tgt, tf

    # ---- pretraining heads ----
    heads = [
        (r"mlm_head\.predictions\.transform\.dense\.weight$",
         "mlm_head.transform.dense.kernel", "linear"),
        (r"mlm_head\.predictions\.transform\.dense\.bias$",
         "mlm_head.transform.dense.bias", "none"),
        (r"mlm_head\.predictions\.transform\.LayerNorm\.weight$",
         "mlm_head.transform.LayerNorm.scale", "none"),
        (r"mlm_head\.predictions\.transform\.LayerNorm\.bias$",
         "mlm_head.transform.LayerNorm.bias", "none"),
        (r"mlm_head\.predictions\.bias$", "mlm_head.bias", "none"),
        (r"mvrc_head\.transform\.dense\.weight$",
         "mvrc_head.transform_dense.kernel", "linear"),
        (r"mvrc_head\.transform\.dense\.bias$",
         "mvrc_head.transform_dense.bias", "none"),
        (r"mvrc_head\.region_cls_pred\.weight$",
         "mvrc_head.region_cls_pred.kernel", "linear"),
        (r"mvrc_head\.region_cls_pred\.bias$",
         "mvrc_head.region_cls_pred.bias", "none"),
        (r"relationship_head\.caption_image_relationship\.weight$",
         "relationship_head.caption_image_relationship.kernel", "linear"),
        (r"relationship_head\.caption_image_relationship\.bias$",
         "relationship_head.caption_image_relationship.bias", "none"),
    ]
    for pat, tgt, tf in heads:
        m = re.search(pat, n)
        if m:
            return n[: m.start()] + tgt, tf

    # ---- task classifier heads (Sequential index -> named layers) ----
    cls = [
        (r"final_mlp\.1\.weight$", "final_mlp.dense_0.kernel", "linear"),
        (r"final_mlp\.1\.bias$", "final_mlp.dense_0.bias", "none"),
        (r"final_mlp\.4\.weight$", "final_mlp.dense_1.kernel", "linear"),
        (r"final_mlp\.4\.bias$", "final_mlp.dense_1.bias", "none"),
        # refcoco / mlm-classifier style: [0]=transform, [2]=linear
        (r"final_mlp\.0\.dense\.weight$", "final_mlp_transform.dense.kernel", "linear"),
        (r"final_mlp\.0\.dense\.bias$", "final_mlp_transform.dense.bias", "none"),
        (r"final_mlp\.0\.LayerNorm\.weight$", "final_mlp.transform_LayerNorm.scale", "none"),
        (r"final_mlp\.0\.LayerNorm\.bias$", "final_mlp.transform_LayerNorm.bias", "none"),
        (r"final_mlp\.2\.weight$", "final_mlp_fc.kernel", "linear"),
        (r"final_mlp\.2\.bias$", "final_mlp_fc.bias", "none"),
        (r"cnn_loss_reg\.0\.dense\.weight$", "cnn_loss_reg_transform.dense.kernel", "linear"),
        (r"cnn_loss_reg\.0\.dense\.bias$", "cnn_loss_reg_transform.dense.bias", "none"),
        (r"cnn_loss_reg\.2\.weight$", "cnn_loss_reg_fc.kernel", "linear"),
        (r"cnn_loss_reg\.2\.bias$", "cnn_loss_reg_fc.bias", "none"),
    ]
    for pat, tgt, tf in cls:
        m = re.search(pat, n)
        if m:
            return n[: m.start()] + tgt, tf

    # ---- FastRCNN non-resnet parts (must precede the resnet rules:
    # 'obj_downsample.1.' would otherwise match 'downsample.1.') ----
    if re.search(r"obj_downsample\.1\.weight$", n):
        return n.replace("obj_downsample.1.weight", "obj_downsample.kernel"), "linear"
    if re.search(r"obj_downsample\.1\.bias$", n):
        return n.replace("obj_downsample.1.bias", "obj_downsample.bias"), "none"
    if re.search(r"object_embed\.weight$", n):
        return n.replace("object_embed.weight", "object_embed.embedding"), "none"
    if re.search(r"regularizing_predictor\.weight$", n):
        return n.replace("regularizing_predictor.weight",
                         "regularizing_predictor.kernel"), "linear"
    if re.search(r"regularizing_predictor\.bias$", n):
        return n, "none"

    # ---- ResNet backbone / ROI head ----
    if "backbone." in n or "roi_head_feature_extractor" in n:
        return _map_resnet_name(n)

    return None


def _map_resnet_name(n):
    """torch resnet names -> our ResNetC4Backbone/ResNetRoIHead tree."""
    # roi head: roi_head_feature_extractor.K.* == roi_head.layer4.block_K.*
    n2 = re.sub(r"roi_head_feature_extractor\.(\d+)\.",
                r"roi_head.layer4.block_\1.", n)
    # backbone blocks: backbone.layerL.K. -> backbone.layerL.block_K.
    n2 = re.sub(r"backbone\.layer(\d)\.(\d+)\.", r"backbone.layer\1.block_\2.", n2)

    # downsample: downsample.0 = conv, downsample.1 = bn
    n2 = n2.replace("downsample.0.", "downsample_conv.")
    n2 = n2.replace("downsample.1.", "downsample_bn.")

    if re.search(r"conv\d?\.weight$", n2) or n2.endswith("downsample_conv.weight"):
        return n2.replace(".weight", ".kernel"), "conv"
    # BatchNorm -> FrozenBatchNorm
    for src, tgt in ((".weight", ".scale"), (".bias", ".bias"),
                     (".running_mean", ".mean"), (".running_var", ".var")):
        if re.search(r"(bn\d|downsample_bn)" + re.escape(src) + "$", n2):
            return re.sub(re.escape(src) + "$", tgt, n2), "none"
    if n2.endswith("num_batches_tracked"):
        return None
    return None


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
