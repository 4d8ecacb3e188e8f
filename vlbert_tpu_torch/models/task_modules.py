"""Task modules (port of vlbert_tpu/models/task_modules.py).

Ported so far: the RefCOCO+ grounding model, eval branch
(``ResNetVLBERTForRefCOCO``), and the VQA model, train and eval
(``ResNetVLBERTForVQA`` with its ``1fc`` / ``2fc`` / ``mlm`` classifiers).
Text arrives pre-assembled by the host; boxes stay in the static [B, O]
layout with a mask. A module in training mode returns (outputs, loss) and
in eval mode its outputs. ``build_module`` raises NotImplementedError,
naming the ROADMAP.md queue, for every other task module of the JAX
package.
"""

from __future__ import annotations

import warnings

import torch
from torch import nn

from vlbert_tpu_torch.models.bert import ACT2FN, BertLayerNorm
from vlbert_tpu_torch.models.fast_rcnn import FastRCNN
from vlbert_tpu_torch.models.layers import Embedding, Linear
from vlbert_tpu_torch.models.vlbert import VisualLinguisticBert, VLBertConfig
from vlbert_tpu_torch.ops.dropout import Dropout
from vlbert_tpu_torch.utils import losses


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


class BertPredictionHeadTransform(nn.Module):
    """dense + activation + LayerNorm (the MLM head's transform)."""

    def __init__(self, hidden_size, hidden_act, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dense = Linear(hidden_size, hidden_size, dtype=dtype,
                            device=device)
        self.act = ACT2FN[hidden_act]
        self.LayerNorm = BertLayerNorm(hidden_size, device=device)

    def forward(self, x):
        return self.LayerNorm(self.act(self.dense(x)))


class Classifier(nn.Sequential):
    """final_mlp variants, laid out as the reference's nn.Sequential so the
    parameter names match its checkpoints:

      '2fc': dropout, linear, relu, dropout, linear
      '1fc': dropout, linear
      'mlm': BertPredictionHeadTransform, dropout, linear

    The logits are fp32."""

    def __init__(self, kind, out_dim, hidden_size, classifier_hidden,
                 dropout, hidden_act="gelu", *, dtype=torch.float32,
                 device=None):
        kw = dict(dtype=dtype, device=device)
        if kind == "2fc":
            layers = [Dropout(dropout),
                      Linear(hidden_size, classifier_hidden, **kw),
                      nn.ReLU(), Dropout(dropout),
                      Linear(classifier_hidden, out_dim, **kw)]
        elif kind == "1fc":
            layers = [Dropout(dropout), Linear(hidden_size, out_dim, **kw)]
        elif kind == "mlm":
            layers = [BertPredictionHeadTransform(hidden_size, hidden_act,
                                                  **kw),
                      Dropout(dropout), Linear(hidden_size, out_dim, **kw)]
        else:
            raise ValueError(f"unsupported classifier type {kind!r}")
        super().__init__(*layers)
        self.kind = kind

    def forward(self, x):
        return super().forward(x).to(torch.float32)


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
        visual_feat_dim=cfg.DATASET.get("PRECOMPUTED_FEAT_DIM", 2048),
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
            Dropout(config.NETWORK.CLASSIFIER_DROPOUT),
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


class ResNetVLBERTForVQA(nn.Module):
    """VQA model. Text arrives pre-assembled: [CLS] Q [SEP] [MASK] [SEP]
    with ``ans_pos`` the index of the [MASK] slot; the answer logits are
    read there. Training loss: BCE on the soft targets times the number of
    answers."""

    def __init__(self, config, vl_config, *, device=None):
        super().__init__()
        vl = self.vl_config = vl_config
        net = config.NETWORK
        kw = dict(dtype=vl.dtype, device=device)
        self.no_grounding = bool(net.get("NO_GROUNDING", False))
        self.image_feature_extractor = _fast_rcnn_from_cfg(config, vl, device)
        self.object_linguistic_embeddings = Embedding(1, vl.hidden_size,
                                                      **kw)
        self.vlbert = VisualLinguisticBert(vl, device=device)
        self.final_mlp = Classifier(
            net.CLASSIFIER_TYPE, config.DATASET.ANSWER_VOCAB_SIZE,
            vl.hidden_size, net.CLASSIFIER_HIDDEN_SIZE,
            net.CLASSIFIER_DROPOUT, vl.hidden_act, **kw)

    def forward(self, image, boxes, box_mask, im_info, text_input_ids,
                text_token_type_ids, text_mask, ans_pos, label=None):
        obj_reps = self.image_feature_extractor(image, boxes, box_mask,
                                                im_info)["obj_reps"]
        B, T = text_input_ids.shape
        # text visual embedding = the whole-image box feature, broadcast
        reps = torch.zeros_like(obj_reps) if self.no_grounding else obj_reps
        text_visual = reps[:, :1].expand(B, T, -1)
        obj_vl = generic_obj_vl_embeddings(self.object_linguistic_embeddings,
                                           obj_reps)
        hidden, _ = self.vlbert(text_input_ids, text_token_type_ids,
                                text_visual, text_mask, obj_vl, box_mask)
        idx = ans_pos.long()[:, None, None].expand(B, 1, hidden.shape[-1])
        logits = self.final_mlp(torch.gather(hidden, 1, idx)[:, 0])
        outputs = {"label_logits": logits}
        if not self.training:
            return outputs
        if label is None:
            raise ValueError("ResNetVLBERTForVQA in training mode needs label")
        ans_loss = losses.bce_with_logits(logits, label) * label.shape[1]
        outputs.update(label=label, ans_loss=ans_loss)
        return outputs, ans_loss


_QUEUE = {
    "ResNetVLBERT:vcr": "queue 1 (VCR forward)",
    "ResNetVLBERTForPretraining:pretrain": "queue 1 (other tasks)",
    "ResNetVLBERTForPretrainingMultitask:pretrain": "queue 1 (other tasks)",
}

MODULES = {"ResNetVLBERT:refcoco": ResNetVLBERTForRefCOCO,
           "ResNetVLBERT:vqa": ResNetVLBERTForVQA}

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# TPU knobs that pick between two formulations of one function; on CUDA the
# port always launches its kernels (Philox dropout for DROPOUT_IMPL)
_IGNORED_KNOBS = ("FUSED_ATTENTION", "ROI_ALIGN_IMPL", "DROPOUT_IMPL")


def build_module(config, task, dtype=None, device=None, fused_qkv=None):
    """Build a task module from a vlbert_tpu config.

    dtype: compute dtype; None reads TPU.COMPUTE_DTYPE. fused_qkv: None
    reads TPU.FUSED_QKV. TPU.FUSED_ATTENTION, TPU.ROI_ALIGN_IMPL and
    TPU.DROPOUT_IMPL are accepted and ignored with a warning; the other
    TPU-only knobs are ignored.
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
                      f"port always launches its ROIAlign, attention and "
                      f"Philox dropout kernels", stacklevel=2)
    if dtype is None:
        dtype = _DTYPES[tpu.get("COMPUTE_DTYPE", "bfloat16")]
    if fused_qkv is None:
        fused_qkv = bool(tpu.get("FUSED_QKV", False))
    vl_cfg = VLBertConfig.from_attrdict(config.NETWORK.VLBERT, dtype=dtype,
                                        fused_qkv=fused_qkv)
    return MODULES[key](config, vl_cfg, device=device)
