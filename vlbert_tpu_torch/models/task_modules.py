"""Task modules (port of vlbert_tpu/models/task_modules.py).

Ported so far: the RefCOCO+ grounding model, eval branch
(``ResNetVLBERTForRefCOCO``). Text arrives pre-assembled by the host
([CLS] expr [SEP]); boxes stay in the static [B, O] layout with a mask.
``build_module`` raises NotImplementedError, naming the ROADMAP.md queue,
for every other task module of the JAX package.
"""

from __future__ import annotations

import warnings

import torch
from torch import nn

from vlbert_tpu_torch.models.bert import ACT2FN
from vlbert_tpu_torch.models.fast_rcnn import FastRCNN
from vlbert_tpu_torch.models.layers import Embedding, Linear
from vlbert_tpu_torch.models.vlbert import VisualLinguisticBert, VLBertConfig


def generic_obj_vl_embeddings(embed_table, obj_reps):
    """cat(visual feature, GENERIC object linguistic embedding), the object
    VL assembly shared by VQA / RefCOCO / pretraining."""
    B, O = obj_reps.shape[:2]
    obj_ling = embed_table(torch.zeros((B, O), dtype=torch.long,
                                       device=obj_reps.device))
    return torch.cat([obj_reps, obj_ling.to(obj_reps.dtype)], dim=-1)


class MVRCHeadTransform(nn.Module):
    """dense + activation transform."""

    def __init__(self, hidden_size, hidden_act, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dense = Linear(hidden_size, hidden_size, dtype=dtype,
                            device=device)
        self.act = ACT2FN[hidden_act]

    def forward(self, x):
        return self.act(self.dense(x))


def _fast_rcnn_from_cfg(cfg, vl_cfg, device=None):
    n = cfg.NETWORK
    tpu = cfg.TPU if "TPU" in cfg else {}
    return FastRCNN(
        image_feat_precomputed=n.IMAGE_FEAT_PRECOMPUTED,
        num_layers=n.IMAGE_NUM_LAYERS,
        stride_in_1x1=n.IMAGE_STRIDE_IN_1x1,
        c5_dilated=n.IMAGE_C5_DILATED,
        final_dim=n.IMAGE_FINAL_DIM,
        image_semantic=n.IMAGE_SEMANTIC,
        # 1 = reference parity (its ROIAlign ctor default); 0 = adaptive
        roi_sampling_ratio=tpu.get("ROI_SAMPLING_RATIO", 1),
        pixel_means=tuple(n.PIXEL_MEANS or (102.9801, 115.9465, 122.7717)),
        pixel_stds=tuple(n.PIXEL_STDS or (1.0, 1.0, 1.0)),
        dtype=vl_cfg.dtype, device=device)


class ResNetVLBERTForRefCOCO(nn.Module):
    """RefCOCO+ grounding model, inference: per-box logits and the argmax
    box in original image coordinates."""

    def __init__(self, config, vl_config, *, device=None):
        super().__init__()
        vl = self.vl_config = vl_config
        kw = dict(dtype=vl.dtype, device=device)
        self.image_feature_extractor = _fast_rcnn_from_cfg(config, vl, device)
        self.object_linguistic_embeddings = Embedding(1, vl.hidden_size,
                                                      **kw)
        self.vlbert = VisualLinguisticBert(vl, device=device)
        self.final_mlp = nn.Sequential(
            MVRCHeadTransform(vl.hidden_size, vl.hidden_act, **kw),
            nn.Dropout(config.NETWORK.CLASSIFIER_DROPOUT),
            Linear(vl.hidden_size, 1, **kw))

    def forward(self, image, boxes, box_mask, im_info, text_input_ids,
                text_mask, label=None, train=False):
        if train:
            raise NotImplementedError(
                "RefCOCO+ training is not ported yet; see ROADMAP.md "
                "queue 1 (training)")
        B, O = box_mask.shape
        obj_reps = self.image_feature_extractor(image, boxes, box_mask,
                                                im_info)["obj_reps"]
        # text visual embedding = the whole-image box, broadcast
        text_visual = obj_reps[:, :1].expand(B, text_input_ids.shape[1], -1)
        obj_vl = generic_obj_vl_embeddings(self.object_linguistic_embeddings,
                                           obj_reps)
        _, h_regions, _ = self.vlbert(
            text_input_ids, torch.zeros_like(text_input_ids), text_visual,
            text_mask, obj_vl, box_mask,
            output_text_and_object_separately=True)

        logits = self.final_mlp(h_regions).to(torch.float32)[..., 0]
        # invalid slots pushed to -10000
        logits = torch.where(box_mask.bool(), logits,
                             torch.full_like(logits, -10000.0))

        # argmax box, rescaled to original image coords
        best = logits.argmax(dim=1)
        pred = torch.gather(boxes[..., :4].to(torch.float32), 1,
                            best[:, None, None].expand(B, 1, 4))[:, 0]
        ratio = im_info[:, [2, 3, 2, 3]].to(torch.float32)
        return {"label_logits": logits, "pred_boxes": pred / ratio}


_QUEUE = {
    "ResNetVLBERT:vqa": "queue 1, after the serving slice (VQA server)",
    "ResNetVLBERT:vcr": "queue 1 (VCR forward)",
    "ResNetVLBERTForPretraining:pretrain": "queue 1 (other tasks)",
    "ResNetVLBERTForPretrainingMultitask:pretrain": "queue 1 (other tasks)",
}

MODULES = {"ResNetVLBERT:refcoco": ResNetVLBERTForRefCOCO}

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# TPU knobs that pick between two formulations of one function; on CUDA the
# port always launches its kernels
_IGNORED_KNOBS = ("FUSED_ATTENTION", "ROI_ALIGN_IMPL")


def build_module(config, task, dtype=None, device=None, fused_qkv=None):
    """Build a task module from a vlbert_tpu config.

    dtype: compute dtype; None reads TPU.COMPUTE_DTYPE. fused_qkv: None
    reads TPU.FUSED_QKV. TPU.FUSED_ATTENTION and TPU.ROI_ALIGN_IMPL are
    accepted and ignored with a warning; the other TPU-only knobs are
    ignored.
    """
    key = f"{config.MODULE}:{task}"
    if key in _QUEUE:
        raise NotImplementedError(
            f"module {key!r} is not ported yet; see ROADMAP.md {_QUEUE[key]}")
    if key not in MODULES:
        raise ValueError(f"unknown module {config.MODULE!r} for task "
                         f"{task!r}")
    if config.NETWORK.get("FOR_MASK_VL_MODELING_PRETRAIN", False):
        raise NotImplementedError(
            "NETWORK.FOR_MASK_VL_MODELING_PRETRAIN is not implemented, "
            "matching the reference's own assert")
    tpu = config.TPU if "TPU" in config else {}
    present = [k for k in _IGNORED_KNOBS if k in tpu]
    if present:
        warnings.warn(f"TPU.{', TPU.'.join(present)} ignored: on CUDA the "
                      f"port always launches its ROIAlign and attention "
                      f"kernels", stacklevel=2)
    if dtype is None:
        dtype = _DTYPES[tpu.get("COMPUTE_DTYPE", "bfloat16")]
    if fused_qkv is None:
        fused_qkv = bool(tpu.get("FUSED_QKV", False))
    vl_cfg = VLBertConfig.from_attrdict(config.NETWORK.VLBERT, dtype=dtype,
                                        fused_qkv=fused_qkv)
    return MODULES[key](config, vl_cfg, device=device)
