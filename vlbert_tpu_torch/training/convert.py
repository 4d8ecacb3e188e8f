"""Checkpoint names and formats for the port (port of
vlbert_tpu/training/convert.py, on torch names instead of flax paths).

Port modules keep the reference's torch parameter names, so a reference
``.model``, a checkpoint the port writes and the JAX package's torch path
all meet on **reference names**: ``reference_name`` strips the DDP and
TimeDistributed wrappers (``module.``, ``vlbert._module.``) and undoes the
TF-era LayerNorm names, and what is left is a key of the port module's
``state_dict``. The JAX converter's name rules (``normalize_torch_name``,
``map_reference_name``, ``_map_resnet_name``) are copied here, because the
port imports nothing of the JAX package; ``tests/test_torch_host_copies.py``
holds them and the loaders below to the originals.

Loaders and renamers, each a copy of the JAX function of the same name:
``checkpoint_format``, ``load_torch_blob``, ``apply_reference_prefix_
changes``, ``convert_bert_checkpoint`` (``bert.*`` / ``roberta.*`` /
``cls.*`` to ``vlbert.*`` with the token-type row copy),
``convert_raw_resnet_checkpoint`` and ``mlm_transform_to_classifier``.
Formats read (``load_state_dict_file``): torch (reference ``.model``, raw
``pytorch_model.bin``, the port's own checkpoints), and the flax-named
``.npz`` of ``tools/convert_checkpoint.py``, mapped back through the
inverse rules of ``state_dict_from_jax``. The JAX package's native msgpack
checkpoints need flax, which the port does not have: that format raises.
There is no ``stack_layer_params`` or ``fuse_qkv_params``: the port has
no scan layers and keeps separate query / key / value parameters under
TPU.FUSED_QKV.

``state_dict_from_jax`` turns JAX params into a port ``state_dict``: for
each port parameter name, ``map_reference_name(normalize_torch_name(name))``
gives the JAX path and the layout transform, which is inverted here. A fused
``...attention.self.qkv`` leaf (TPU.FUSED_QKV) is split back into query,
key and value. The JAX pretraining model nests its encoder one level
deeper (``vlbert.bert.*``, the heads at ``vlbert.<head>``), as the
reference does not: such leaves are read on the reference's names
(``align_vlbert_nesting``'s inverse). The tied MLM decoder the reference
layout carries (``vlbert.mlm_head.predictions.decoder.weight``) is the
word-embedding table, and is read from it.

One head needs a task-aware rename: the reference names its VQA ``mlm``
classifier ``final_mlp.0`` (transform) and ``final_mlp.2`` (linear), which
the JAX converter maps to RefCOCO's leaves (``final_mlp_transform.dense``,
``final_mlp_fc``), while the JAX VQA and VCR modules name them
``final_mlp.transform_dense`` and ``final_mlp.dense_0``. For a port module
whose ``final_mlp`` is an ``mlm`` Classifier the paths are renamed here.
The second head of the single-model VCR Q2AR, ``final_mlp_rationale``,
has no reference name (the reference has no such model): it is mapped as
``final_mlp`` is and moved to the JAX module's ``final_mlp_rationale``.
"""

from __future__ import annotations

import logging
import re
import zipfile

import numpy as np
import torch

logger = logging.getLogger(__name__)

# --------------------------------------------------------------- name rules

def normalize_torch_name(name):
    """Strip DDP/TimeDistributed wrappers, fix TF-era LN names, and the
    reference's 'relationsip' typo."""
    name = re.sub(r"^module\.", "", name)
    name = name.replace("vlbert._module.", "vlbert.")
    name = name.replace(".gamma", ".weight_ln").replace(".beta", ".bias_ln")
    name = name.replace("relationsip_head", "relationship_head")
    return name


def reference_name(name):
    """A checkpoint's torch name -> the port's ``state_dict`` key: the
    wrappers stripped and the TF-era LayerNorm names undone."""
    name = normalize_torch_name(name)
    return name.replace(".weight_ln", ".weight").replace(".bias_ln", ".bias")


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

RATIONALE_HEAD = "final_mlp_rationale."


def _head_alias(name):
    """(name with the rationale head read as ``final_mlp``, whether it
    was the rationale head); ``name`` normalized."""
    if name.startswith(RATIONALE_HEAD):
        return "final_mlp." + name[len(RATIONALE_HEAD):], True
    return name, False


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


def _unnest_vlbert(flat):
    """The JAX pretraining tree's ``vlbert.bert.*`` leaves on the task
    trees' ``vlbert.*`` paths."""
    prefix = "vlbert.bert."
    return {("vlbert." + k[len(prefix):] if k.startswith(prefix) else k): v
            for k, v in flat.items()}


def state_dict_from_jax(flat, module, strict=True):
    """JAX params as a flat {dot.path: np.ndarray} -> the port module's
    state_dict ({name: torch.Tensor} on the CPU, fp32 as stored).

    Strict (the default): raises on a port parameter with no source, on a
    shape mismatch and on any JAX leaf left unused. ``strict=False`` returns
    what it could map and logs the rest (the ``.npz`` loader). A module on
    the meta device gets meta tensors: the names and shapes are held and
    nothing is allocated (``flat`` may then hold zero-stride arrays of
    ``jax.eval_shape``'s shapes).
    """
    from vlbert_tpu_torch.models.task_modules import Classifier
    from vlbert_tpu_torch.models.vlbert import TIED_DECODER

    flat = _unnest_vlbert(flat)
    head = getattr(module, "final_mlp", None)
    renames = _MLM_HEAD if isinstance(head, Classifier) \
        and head.kind == "mlm" else ()
    out, used, missing, mismatched = {}, set(), [], []
    for name, ref in module.state_dict().items():
        alias, rationale = _head_alias(normalize_torch_name(
            name.replace(TIED_DECODER, "word_embeddings.weight")))
        mapped = map_reference_name(alias)
        arr = None
        if mapped is not None:
            path, transform = mapped
            for old, new in renames:
                if path.startswith(old):
                    path = new + path[len(old):]
            if rationale:
                path = "final_mlp_rationale" + path[len("final_mlp"):]
            arr = _lookup(flat, path, used)
        if arr is None:
            missing.append(name)
            continue
        arr = _inverse(arr, transform)
        if tuple(arr.shape) != tuple(ref.shape):
            mismatched.append(f"{name}: JAX leaf {path} has shape "
                              f"{arr.shape} after transform, port expects "
                              f"{tuple(ref.shape)}")
            continue
        out[name] = torch.empty(arr.shape, dtype=ref.dtype, device="meta") \
            if ref.is_meta else torch.tensor(arr, dtype=ref.dtype)
    unused = sorted(set(flat) - used)
    if not strict:
        if missing or mismatched or unused:
            logger.info("npz: %d port tensors with no source, %d shape "
                        "mismatches, %d leaves unused (e.g. %s)",
                        len(missing), len(mismatched), len(unused),
                        unused[:5])
        return out
    if mismatched:
        raise ValueError(mismatched[0])
    if missing:
        raise KeyError(f"port parameters with no JAX source: {missing}")
    if unused:
        raise KeyError(f"JAX leaves not used by the port: {unused}")
    return out


# ------------------------------------------------- torch-name loaders

def convert_bert_checkpoint(sd, target_prefix="vlbert."):
    """Language-pretrained BERT (bert.* / roberta.* / cls.* keys) ->
    reference names of the VL-BERT tree (ref visual_linguistic_bert.py:
    243-309), with the token-type row copy for checkpoints of one or two
    types. Returns (state_dict, skipped): keys with no counterpart are
    skipped, as the JAX converter skips them."""
    remapped = {}
    for k, v in sd.items():
        if k.startswith("bert."):
            k = k[len("bert."):]
        elif k.startswith("roberta."):
            k = k[len("roberta."):]
        elif k.startswith("cls.predictions."):
            k = "mlm_head.predictions." + k[len("cls.predictions."):]
        elif k.startswith("cls.seq_relationship."):
            k = "relationship_head.caption_image_relationship." \
                + k[len("cls.seq_relationship."):]
        else:
            continue
        k = k.replace("embeddings.word_embeddings", "word_embeddings")
        k = k.replace("embeddings.position_embeddings", "position_embeddings")
        k = k.replace("embeddings.token_type_embeddings",
                      "token_type_embeddings")
        k = k.replace("embeddings.LayerNorm", "embedding_LayerNorm")
        remapped[target_prefix + k] = v
    out, skipped = reference_state_dict(remapped)

    # token-type rows (ref :276-286): one row -> rows 0, 0, 0; two rows ->
    # rows 0, 1, 1
    key = f"{target_prefix}token_type_embeddings.weight"
    tt = out.get(key)
    if tt is not None and tt.shape[0] < 3:
        rows = [0, 0, 0] if tt.shape[0] == 1 else [0, 1, 1]
        out[key] = tt[rows]
    return out, skipped


def convert_raw_resnet_checkpoint(sd, target_prefix="image_feature_extractor."):
    """Raw torchvision-style ResNet state dict (conv1./bn1./layerL.K.*) ->
    the backbone and conv5 RoI head warm start: ``layer4.*`` goes to
    ``roi_head_feature_extractor.*`` (ref common/fast_rcnn.py:115-121), the
    rest to ``backbone.*`` (the C4 backbone holds the stem and layer1-3);
    ``fc.*`` and ``num_batches_tracked`` are dropped. Returns
    (state_dict, skipped)."""
    remapped = {}
    for k, v in sd.items():
        if k.startswith("fc.") or k.endswith("num_batches_tracked"):
            continue
        if k.startswith("layer4."):
            remapped[target_prefix + "roi_head_feature_extractor."
                     + k[len("layer4."):]] = v
        else:
            remapped[target_prefix + "backbone." + k] = v
    return reference_state_dict(remapped)


def reference_state_dict(sd):
    """Checkpoint names -> reference names (``reference_name``); a key the
    JAX converter has no rule for is skipped, as it skips it (the Q2AR
    rationale head is read by ``final_mlp``'s rules). Returns
    (state_dict, skipped)."""
    out, skipped = {}, []
    for name, tensor in sd.items():
        if map_reference_name(_head_alias(normalize_torch_name(name))[0]) \
                is None:
            skipped.append(name)
            continue
        out[reference_name(name)] = tensor
    return out, skipped


def load_torch_blob(path):
    """torch.load + state_dict extraction (the one place a foreign torch
    file is read). Tensors, dicts, lists and numbers load with
    ``weights_only=True``; a reference ``.model`` also pickles its
    optimizer's and validation monitor's state, which may hold numpy
    scalars that ``weights_only`` refuses, so such a file is read again
    with ``weights_only=False``, as the reference itself reads it."""
    import pickle

    try:
        blob = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        logger.warning("%s holds objects weights_only refuses; reading it "
                       "as the reference does (weights_only=False)", path)
        blob = torch.load(path, map_location="cpu", weights_only=False)
    return blob.get("state_dict", blob) if isinstance(blob, dict) else blob


def convert_torch_state_dict(sd):
    """Detect raw-BERT vs reference VL-BERT names; reference names out."""
    if any(k.startswith("bert.") or k.startswith("roberta.")
           for k in sd.keys()):
        out, _ = convert_bert_checkpoint(sd)
    else:
        out, _ = reference_state_dict(sd)
    return out


def apply_reference_prefix_changes(sd, prefix_changes):
    """PARTIAL_PRETRAIN_PREFIX_CHANGES on RAW torch checkpoint names,
    exactly as the reference applies them BEFORE loading
    (ref vcr/function/train.py:202-214): first matching rule wins, keys
    matching no rule pass through unchanged."""
    if not prefix_changes:
        return sd
    out = {}
    for k, v in sd.items():
        for old, new in prefix_changes:
            if k.startswith(old):
                out[new + k[len(old):]] = v
                break
        else:
            out[k] = v
    return out


def checkpoint_format(path):
    """Classify a checkpoint file: 'torch' | 'native' (flax msgpack) |
    'npz' (tools/convert_checkpoint.py output).

    Suffixes are ambiguous — '.model' is both the reference torch format
    and the JAX package's native save, and torch>=1.6 zips share the PK
    header with numpy's .npz — so classify by content: PK zips with
    'data.pkl' are torch, PK zips of .npy members are npz, legacy pickles
    (0x80 + protocol byte) are torch, everything else is native msgpack.
    """
    try:
        with open(path, "rb") as f:
            head = f.read(4)
    except OSError:
        return "native"
    if head[:2] == b"PK":
        try:
            with zipfile.ZipFile(path) as z:
                names = z.namelist()
            if any(n.endswith("data.pkl") for n in names):
                return "torch"
            if names and all(n.endswith(".npy") for n in names):
                return "npz"
        except zipfile.BadZipFile:
            pass
        return "torch"
    if len(head) >= 2 and head[0] == 0x80 and head[1] <= 0x05:
        return "torch"      # legacy (pre-1.6) torch pickle
    return "native"


def load_npz_checkpoint(path):
    """tools/convert_checkpoint.py output: flat {flax.dot.path: array}."""
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def load_state_dict_file(path, module):
    """A checkpoint file -> (state_dict, raw): ``raw`` is True for a torch
    file, whose names are still the file's own (prefix changes apply to
    them), False for an ``.npz``, already mapped onto ``module``'s names.
    The JAX package's native msgpack format raises ValueError."""
    fmt = checkpoint_format(path)
    if fmt == "torch":
        return load_torch_blob(path), True
    if fmt == "npz":
        return state_dict_from_jax(load_npz_checkpoint(path), module,
                                   strict=False), False
    raise ValueError(
        f"{path}: checkpoint format {fmt!r} (the JAX package's flax msgpack "
        f"save) cannot be read without flax; convert it with "
        f"tools/convert_checkpoint.py to .npz, or save a torch checkpoint")


_MLM_TRANSFORM = {
    "mlm_head.predictions.transform.dense.weight": "final_mlp.0.dense.weight",
    "mlm_head.predictions.transform.dense.bias": "final_mlp.0.dense.bias",
    "mlm_head.predictions.transform.LayerNorm.weight":
        "final_mlp.0.LayerNorm.weight",
    "mlm_head.predictions.transform.LayerNorm.bias":
        "final_mlp.0.LayerNorm.bias",
}


def mlm_transform_to_classifier(sd):
    """VQA 'mlm' classifier warm start (ref vqa module init_weight :97-111):
    the BERT MLM prediction transform becomes the classifier's transform
    (``final_mlp.0``). Input: reference names, the head under ``vlbert.``
    or bare."""
    out = dict(sd)
    for src, dst in _MLM_TRANSFORM.items():
        for k in (src, "vlbert." + src):
            if k in sd:
                out[dst] = sd[k]
                break
    return out
