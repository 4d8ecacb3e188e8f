"""Task modules (port of vlbert_tpu/models/task_modules.py).

Ported: the RefCOCO+ grounding model, train and eval
(``ResNetVLBERTForRefCOCO``); the VQA model, train and eval
(``ResNetVLBERTForVQA`` with its ``1fc`` / ``2fc`` / ``mlm`` classifiers);
the VCR models, train and eval (``ResNetVLBERTForVCR`` for Q2A and QA2R,
``ResNetVLBERTForVCRQ2AR`` for the single-model Q2AR with its second
head), each from precomputed features or from pixels; and the multitask
pretraining model (``ResNetVLBERTForPretrainingMultitask``: MLM on
captions and a text corpus, MVRC, the optional relationship task), which
``ResNetVLBERTForPretraining`` builds without the corpus rows, and its
``attention_vis`` (the attention-map dump's forward, registered as
``ResNetVLBERTForAttentionVis`` too). Text
arrives pre-assembled by the host; boxes stay in the static [B, O] layout
with a mask. A module in training mode returns (outputs, loss) and in
eval mode its outputs.
"""

from __future__ import annotations

import warnings

import torch
import torch.nn.functional as F
from torch import nn

from vlbert_tpu_torch.models.bert import BertPredictionHeadTransform
from vlbert_tpu_torch.models.fast_rcnn import FastRCNN
from vlbert_tpu_torch.models.layers import Embedding, Linear
from vlbert_tpu_torch.models.vlbert import (MVRCHeadTransform,
                                            VisualLinguisticBert,
                                            VisualLinguisticBertForPretraining,
                                            VLBertConfig)
from vlbert_tpu_torch.ops.dropout import Dropout
from vlbert_tpu_torch.utils import losses
from vlbert_tpu_torch.utils.misc import master_dataset


def collect_obj_reps(span_tags, object_reps):
    """Per-token grounded object features gathered by the text tags
    ([..., T] -> [..., T, H] from [B, O, H]): negative tags (and tags past
    the last slot) land on the clipped slot, so -1 and -2 take object 0,
    the whole-image box."""
    B, O, H = object_reps.shape
    tags = span_tags.long().clamp(0, O - 1)
    flat = tags.reshape(B, -1)
    out = torch.gather(object_reps, 1, flat[..., None].expand(-1, -1, H))
    return out.reshape(*tags.shape, H)


def generic_obj_vl_embeddings(embed_table, obj_reps, mask_fn=None):
    """cat(visual feature, GENERIC object linguistic embedding), the object
    VL assembly shared by VQA / RefCOCO / pretraining; ``mask_fn`` lets
    pretraining replace the masked regions' linguistic embedding first."""
    B, O = obj_reps.shape[:2]
    obj_ling = embed_table(torch.zeros((B, O), dtype=torch.long,
                                       device=obj_reps.device))
    if mask_fn is not None:
        obj_ling = mask_fn(obj_ling)
    return torch.cat([obj_reps, obj_ling.to(obj_reps.dtype)], dim=-1)


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


def _fast_rcnn_from_cfg(cfg, vl_cfg, device=None, with_classes=False,
                        enable_cnn_reg_loss=False):
    """``with_classes``: the module passes per-box classes, so
    IMAGE_SEMANTIC applies (the JAX package skips the class embedding
    where no classes are given)."""
    n = cfg.NETWORK
    tpu = cfg.TPU if "TPU" in cfg else {}
    return FastRCNN(
        image_feat_precomputed=n.IMAGE_FEAT_PRECOMPUTED,
        num_layers=n.IMAGE_NUM_LAYERS,
        stride_in_1x1=n.IMAGE_STRIDE_IN_1x1,
        c5_dilated=n.IMAGE_C5_DILATED,
        final_dim=n.IMAGE_FINAL_DIM,
        enable_cnn_reg_loss=enable_cnn_reg_loss,
        image_semantic=with_classes and n.IMAGE_SEMANTIC,
        # 1 = reference parity (its ROIAlign ctor default); 0 = adaptive
        roi_sampling_ratio=tpu.get("ROI_SAMPLING_RATIO", 1),
        pixel_means=tuple(n.PIXEL_MEANS or (102.9801, 115.9465, 122.7717)),
        pixel_stds=tuple(n.PIXEL_STDS or (1.0, 1.0, 1.0)),
        visual_feat_dim=master_dataset(cfg).get("PRECOMPUTED_FEAT_DIM",
                                                2048),
        frozen_stages=tuple(n.IMAGE_FROZEN_BACKBONE_STAGES),
        dtype=vl_cfg.dtype, device=device)


class ResNetVLBERTForRefCOCO(nn.Module):
    """RefCOCO+ grounding model: per-box logits; in eval mode also the
    argmax box in original image coordinates. Training loss: BCE over the
    live box slots against the IoU > 0.5 labels."""

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
                text_mask, label=None):
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
        if self.training:
            if label is None:
                raise ValueError("ResNetVLBERTForRefCOCO in training mode "
                                 "needs label")
            cls_loss = losses.bce_with_logits_masked(logits, label, box_mask)
            return {"label_logits": logits, "cls_loss": cls_loss,
                    "label": torch.where(box_mask.bool(), label.to(
                        torch.float32), torch.full_like(logits, -1.0))}, \
                cls_loss

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


class ResNetVLBERTForVCR(nn.Module):
    """VCR Q2A / QA2R model: one score per choice.

    Text arrives pre-assembled per choice, [B, C, T] input ids / type ids /
    tags / mask (the collate's [CLS] Q [SEP] A [SEP]). The object features
    are computed once per image and repeated per choice; the B x C
    sequences go through VL-BERT as one batch and the pooled output of
    each gives its choice's logit (fp32)."""

    def __init__(self, config, vl_config, *, device=None):
        super().__init__()
        vl = self.vl_config = vl_config
        net = self.net = config.NETWORK
        kw = dict(dtype=vl.dtype, device=device)
        self.enable_cnn_reg_loss = net.ENABLE_CNN_REG_LOSS
        self.cnn_loss_top = net.CNN_LOSS_TOP
        if not net.BLIND:
            self.image_feature_extractor = _fast_rcnn_from_cfg(
                config, vl, device, with_classes=True,
                enable_cnn_reg_loss=(self.enable_cnn_reg_loss
                                     and not self.cnn_loss_top))
            self.object_word_embed_mode = net.VLBERT.object_word_embed_mode
            if self.object_word_embed_mode in (1, 2):
                n_emb = 81 if self.object_word_embed_mode == 1 else 1
                self.object_linguistic_embeddings = Embedding(
                    n_emb, vl.hidden_size, **kw)
            elif self.object_word_embed_mode != 3:
                raise NotImplementedError(
                    f"object_word_embed_mode "
                    f"{self.object_word_embed_mode!r} (supported: 1, 2, 3)")
            if self.enable_cnn_reg_loss and self.cnn_loss_top:
                # the reference's layout: transform, dropout, 81-way linear
                self.cnn_loss_reg = nn.Sequential(
                    MVRCHeadTransform(vl.hidden_size, vl.hidden_act, **kw),
                    Dropout(net.CNN_REG_DROPOUT),
                    Linear(vl.hidden_size, 81, **kw))
        self.vlbert = VisualLinguisticBert(vl, device=device)
        self.final_mlp = self._classifier(config, **kw)

    def _classifier(self, config, **kw):
        net, vl = config.NETWORK, self.vl_config
        return Classifier(net.CLASSIFIER_TYPE, 1, vl.hidden_size,
                          net.CLASSIFIER_HIDDEN_SIZE, net.CLASSIFIER_DROPOUT,
                          vl.hidden_act, **kw)

    def extract_obj_reps(self, image, boxes, objects, segms, box_mask,
                         im_info):
        """The visual features, shared by the answer and rationale passes
        of Q2AR (they do not depend on the text)."""
        B, O = box_mask.shape
        if self.net.BLIND:
            return {"obj_reps": torch.zeros(
                (B, O, self.net.IMAGE_FINAL_DIM), dtype=self.vl_config.dtype,
                device=box_mask.device)}
        return self.image_feature_extractor(image, boxes, box_mask, im_info,
                                            classes=objects, segms=segms)

    def choice_logits(self, obj_reps, objects, box_mask, text_input_ids,
                      text_token_type_ids, text_tags, text_mask, classifier):
        """Per-choice logits [B, C] of one (query, choices) text block, the
        object hidden states [B*C, O, H] and the per-choice box mask."""
        net, vl = self.net, self.vl_config
        B, C, T = text_input_ids.shape
        O = box_mask.shape[1]
        reps = obj_reps["obj_reps"]
        if net.NO_GROUNDING:
            text_tags = torch.zeros_like(text_tags)
        text_visual = collect_obj_reps(text_tags, reps)

        if net.BLIND:
            obj_ling = torch.zeros((B, O, vl.hidden_size), dtype=vl.dtype,
                                   device=reps.device)
        elif self.object_word_embed_mode in (1, 2):
            n_emb = self.object_linguistic_embeddings.num_embeddings
            obj_ling = self.object_linguistic_embeddings(
                objects.long().clamp(0, n_emb - 1))
        else:
            # mode 3: each choice's mean word embedding over its text
            # tokens, [CLS] and [SEP] left out; the count is cast to the
            # embedding dtype before the divide, as in the JAX package
            ids = text_input_ids.long()
            ctx = text_mask.bool() & (ids != 101) & (ids != 102)
            we = self.vlbert.word_embeddings(ids)
            we = we * ctx[..., None].to(we.dtype)
            mean_we = we.sum(dim=2) / ctx.sum(dim=2)[..., None] \
                .clamp(min=1).to(we.dtype)
            obj_ling = mean_we[:, :, None, :].expand(B, C, O, vl.hidden_size)

        # object VL embeddings, one copy per choice
        if obj_ling.dim() == 3:
            obj_vl = torch.cat([reps, obj_ling.to(reps.dtype)], dim=-1)
            obj_vl = obj_vl[:, None].expand(B, C, O, obj_vl.shape[-1])
        else:
            obj_vl = torch.cat([reps[:, None].expand(B, C, O, reps.shape[-1]),
                                obj_ling.to(reps.dtype)], dim=-1)
        eff_box_mask = torch.zeros_like(box_mask) \
            if net.NO_OBJ_ATTENTION or net.BLIND else box_mask
        box_mask_c = eff_box_mask[:, None].expand(B, C, O)

        def fold(x):       # [B, C, ...] -> [B*C, ...]
            return x.reshape(B * C, *x.shape[2:])

        _, h_obj, pooled = self.vlbert(
            fold(text_input_ids), fold(text_token_type_ids),
            fold(text_visual), fold(text_mask), fold(obj_vl),
            fold(box_mask_c), output_text_and_object_separately=True)
        return classifier(pooled).reshape(B, C), h_obj, box_mask_c

    def forward(self, image, boxes, objects, segms, box_mask, text_input_ids,
                text_token_type_ids, text_tags, text_mask, im_info,
                answer_label=None):
        C = text_input_ids.shape[1]
        obj_reps = self.extract_obj_reps(image, boxes, objects, segms,
                                         box_mask, im_info)
        logits, h_obj, box_mask_c = self.choice_logits(
            obj_reps, objects, box_mask, text_input_ids, text_token_type_ids,
            text_tags, text_mask, self.final_mlp)
        outputs = {"label_logits": logits}
        if not self.training:
            return outputs
        if answer_label is None:
            raise ValueError("ResNetVLBERTForVCR in training mode needs "
                             "answer_label")
        ans_loss, pos_frac = self._choice_loss(logits, answer_label, C)
        if pos_frac is not None:
            outputs["positive_fraction"] = pos_frac
        outputs.update(label=answer_label, ans_loss=ans_loss)
        loss = ans_loss * self.net.ANS_LOSS_WEIGHT
        cnn_reg, loss = self._cnn_reg_loss(loss, obj_reps, h_obj, box_mask_c,
                                           objects)
        if cnn_reg is not None:
            outputs["cnn_regularization_loss"] = cnn_reg
        return outputs, loss

    def _choice_loss(self, logits, answer_label, C):
        """Sigmoid BCE per choice with a positive weight
        (CLASSIFIER_SIGMOID), or softmax CE over the choices. Returns
        (loss, the positive fraction or None)."""
        net = self.net
        if net.CLASSIFIER_SIGMOID:
            label_binary = (torch.arange(C, device=logits.device)[None, :]
                            == answer_label.long()[:, None])
            pw = net.CLASSIFIER_SIGMOID_LOSS_POSITIVE_WEIGHT
            weight = torch.where(label_binary, torch.full_like(logits, pw),
                                 torch.ones_like(logits))
            rescale = (pw + 1.0) / (2.0 * pw)
            loss = rescale * losses.bce_with_logits(
                logits, label_binary.to(torch.float32), weight)
            return loss, label_binary.to(torch.float32).mean()
        return losses.cross_entropy(logits, answer_label), None

    def _cnn_reg_loss(self, loss, obj_reps, h_obj, box_mask_c, objects):
        """Adds the CNN regularization loss to ``loss``: FastRCNN's, or
        under CNN_LOSS_TOP the 81-way head on the object hidden states,
        NLL averaged over the live (choice, box) slots."""
        net = self.net
        if not (self.enable_cnn_reg_loss and not net.BLIND):
            return None, loss
        if not self.cnn_loss_top:
            if "cnn_regularization_loss" not in obj_reps:
                raise ValueError(
                    "ENABLE_CNN_REG_LOSS with CNN_LOSS_TOP=false needs the "
                    "end-to-end visual path (IMAGE_FEAT_PRECOMPUTED=true "
                    "computes no FastRCNN reg loss; set CNN_LOSS_TOP=true "
                    "or disable the reg loss)")
            cnn_reg = obj_reps["cnn_regularization_loss"]
        else:
            B, C, O = box_mask_c.shape
            cnn_reg = losses.masked_cross_entropy(
                self.cnn_loss_reg(h_obj.reshape(B, C, O, -1)),
                objects[:, None].expand(B, C, O), box_mask_c)
        return cnn_reg, loss + cnn_reg * net.CNN_LOSS_WEIGHT


class ResNetVLBERTForVCRQ2AR(ResNetVLBERTForVCR):
    """Single-model Q2AR: one visual pass scores the answer choices and the
    rationale choices (the rationale query holds the gt answer at
    train/val time); the rationales have their own head,
    ``final_mlp_rationale``."""

    def __init__(self, config, vl_config, *, device=None):
        super().__init__(config, vl_config, device=device)
        self.final_mlp_rationale = self._classifier(
            config, dtype=vl_config.dtype, device=device)

    def forward(self, image, boxes, objects, segms, box_mask, text_input_ids,
                text_token_type_ids, text_tags, text_mask,
                rationale_input_ids, rationale_token_type_ids,
                rationale_tags, rationale_mask, im_info, answer_label=None,
                rationale_label=None):
        C = text_input_ids.shape[1]
        obj_reps = self.extract_obj_reps(image, boxes, objects, segms,
                                         box_mask, im_info)
        a_logits, h_obj, box_mask_c = self.choice_logits(
            obj_reps, objects, box_mask, text_input_ids, text_token_type_ids,
            text_tags, text_mask, self.final_mlp)
        r_logits, _, _ = self.choice_logits(
            obj_reps, objects, box_mask, rationale_input_ids,
            rationale_token_type_ids, rationale_tags, rationale_mask,
            self.final_mlp_rationale)
        outputs = {"label_logits": a_logits, "rationale_logits": r_logits}
        if not self.training:
            return outputs
        if answer_label is None or rationale_label is None:
            raise ValueError("ResNetVLBERTForVCRQ2AR in training mode needs "
                             "answer_label and rationale_label")
        ans_loss, pos_frac = self._choice_loss(a_logits, answer_label, C)
        rationale_loss, _ = self._choice_loss(r_logits, rationale_label, C)
        if pos_frac is not None:
            outputs["positive_fraction"] = pos_frac
        outputs.update(label=answer_label, rationale_label=rationale_label,
                       ans_loss=ans_loss, rationale_loss=rationale_loss)
        loss = (ans_loss + rationale_loss) * self.net.ANS_LOSS_WEIGHT
        # the shared visual path's reg loss, once (the answer pass's object
        # hidden states stand in under CNN_LOSS_TOP)
        cnn_reg, loss = self._cnn_reg_loss(loss, obj_reps, h_obj, box_mask_c,
                                           objects)
        if cnn_reg is not None:
            outputs["cnn_regularization_loss"] = cnn_reg
        return outputs, loss


class ResNetVLBERTForPretrainingMultitask(nn.Module):
    """Multitask pretraining: caption rows (image, boxes, text) and, with
    ``with_aux``, text-only corpus rows, concatenated along the batch into
    one VL-BERT pass. A corpus row's text visual embedding is the learned
    ``aux_text_visual_embedding`` and its box slots are all masked. Losses:
    MLM on both kinds of rows (``mlm_loss_wvc``, ``mlm_loss_aux``), MVRC
    soft CE on the caption rows' masked regions, and the optional
    caption-image relationship CE; the total is their sum.

    MVRC masking: a masked region's precomputed feature becomes
    ``object_mask_visual_embedding`` (from pixels too, when
    MASK_RAW_PIXELS is off; with it on, the host zeroed the region's
    pixels), and its linguistic embedding ``object_mask_word_embedding``.
    """

    def __init__(self, config, vl_config, *, with_aux=True,
                 mask_visual_feat_dim=2048, device=None):
        super().__init__()
        vl = self.vl_config = vl_config
        net = self.net = config.NETWORK
        self.with_aux = with_aux
        if with_aux and net.IMAGE_FINAL_DIM != vl.hidden_size:
            # the aux embedding stands in for IMAGE_FINAL_DIM-wide visual
            # features, the reference's own assumption
            raise ValueError(
                f"multitask pretraining requires IMAGE_FINAL_DIM "
                f"({net.IMAGE_FINAL_DIM}) == VLBERT.hidden_size "
                f"({vl.hidden_size}) for the aux text-visual embedding")
        kw = dict(dtype=vl.dtype, device=device)
        self.image_feature_extractor = _fast_rcnn_from_cfg(config, vl, device)
        self.object_linguistic_embeddings = Embedding(1, vl.hidden_size,
                                                      **kw)
        if net.IMAGE_FEAT_PRECOMPUTED or not net.MASK_RAW_PIXELS:
            # zeros, as in the reference; a plain nn.Embedding, so that
            # init_weights leaves it so
            self.object_mask_visual_embedding = nn.Embedding(
                1, mask_visual_feat_dim, device=device)
            nn.init.zeros_(self.object_mask_visual_embedding.weight)
        if net.WITH_MVRC_LOSS:
            self.object_mask_word_embedding = Embedding(1, vl.hidden_size,
                                                        **kw)
        self.aux_text_visual_embedding = Embedding(1, vl.hidden_size, **kw)
        self.vlbert = VisualLinguisticBertForPretraining(
            vl, with_rel_head=net.WITH_REL_LOSS,
            with_mlm_head=net.WITH_MLM_LOSS,
            with_mvrc_head=net.WITH_MVRC_LOSS, device=device)

    def forward(self, image, boxes, im_info, text, relationship_label,
                mlm_labels, mvrc_ops, mvrc_labels, aux_text=None,
                aux_mlm_labels=None):
        net = self.net
        B, O = boxes.shape[:2]
        box_mask = boxes[:, :, 0] > -1.5
        masked = (mvrc_ops == 1)[..., None]
        if net.IMAGE_FEAT_PRECOMPUTED:
            feats = torch.where(
                masked, self.object_mask_visual_embedding.weight[0]
                .to(boxes.dtype), boxes[:, :, 4:])
            boxes = torch.cat([boxes[:, :, :4], feats], dim=-1)
        mask_visual_embed = None
        if not (net.IMAGE_FEAT_PRECOMPUTED or net.MASK_RAW_PIXELS):
            mask_visual_embed = self.object_mask_visual_embedding.weight[0]
        obj_reps = self.image_feature_extractor(
            image, boxes, box_mask, im_info, mvrc_ops=mvrc_ops,
            mask_visual_embed=mask_visual_embed)["obj_reps"]

        # the text's visual embedding: the whole-image box, slot 0
        T = text.shape[1]
        text_visual = obj_reps[:, :1].expand(B, T, obj_reps.shape[-1])

        def mask_ling(obj_ling):
            if not net.WITH_MVRC_LOSS:
                return obj_ling
            return torch.where(masked, self.object_mask_word_embedding.weight[
                0].to(obj_ling.dtype), obj_ling)

        obj_vl = generic_obj_vl_embeddings(self.object_linguistic_embeddings,
                                           obj_reps, mask_ling)
        B2 = 0
        if self.with_aux and aux_text is not None:
            # the corpus rows follow the caption rows: text padded to one
            # length, the aux embedding as their visual embedding, no boxes
            B2 = aux_text.shape[0]
            T = max(T, aux_text.shape[1])
            tv_aux = self.aux_text_visual_embedding.weight[0].to(
                text_visual.dtype).expand(B2, T, text_visual.shape[-1])
            text = torch.cat([_pad_t(text, T), _pad_t(aux_text, T)])
            text_visual = torch.cat([_pad_t(text_visual, T), tv_aux])
            obj_vl = torch.cat([obj_vl, obj_vl.new_zeros(
                (B2, *obj_vl.shape[1:]))])
            box_mask = torch.cat([box_mask, box_mask.new_zeros((B2, O))])
        rel_logits, mlm_logits, mvrc_logits = self.vlbert(
            text, torch.zeros_like(text), text_visual, text > 0, obj_vl,
            box_mask)

        zero = torch.zeros((), dtype=torch.float32, device=text.device)
        rel_loss = mlm_loss_wvc = mlm_loss_aux = mvrc_loss = zero
        outputs = {}
        if net.WITH_REL_LOSS:
            rel_logits = rel_logits[:B]
            rel_loss = losses.cross_entropy(rel_logits, relationship_label)
            outputs.update(relationship_logits=rel_logits,
                           relationship_label=relationship_label)
        if net.WITH_MLM_LOSS:
            mlm_ce = (losses.cross_entropy_ignore_index_batch_first
                      if net.MLM_LOSS_NORM_IN_BATCH_FIRST
                      else losses.cross_entropy_ignore_index)
            labels = _pad_t(mlm_labels, T, -1)
            mlm_loss_wvc = mlm_ce(mlm_logits[:B], labels, -1)
            outputs.update(mlm_logits_wvc=mlm_logits[:B],
                           mlm_label_wvc=labels)
            if B2:
                labels = _pad_t(aux_mlm_labels, T, -1)
                mlm_loss_aux = mlm_ce(mlm_logits[B:], labels, -1)
                outputs.update(mlm_logits_aux=mlm_logits[B:],
                               mlm_label_aux=labels)
        if net.WITH_MVRC_LOSS:
            mvrc_logits = mvrc_logits[:B]
            if net.MVRC_LOSS_NORM_IN_BATCH_FIRST:
                mvrc_loss = losses.soft_cross_entropy_batch_first(
                    mvrc_logits, mvrc_labels)
            else:
                mvrc_loss = losses.soft_cross_entropy(
                    mvrc_logits.reshape(-1, mvrc_logits.shape[-1]),
                    mvrc_labels.reshape(-1, mvrc_labels.shape[-1]))
            outputs.update(mvrc_logits=mvrc_logits, mvrc_label=mvrc_labels)
        outputs.update(relationship_loss=rel_loss, mlm_loss=mlm_loss_wvc,
                       mlm_loss_wvc=mlm_loss_wvc, mlm_loss_aux=mlm_loss_aux,
                       mvrc_loss=mvrc_loss)
        if not self.training:
            return outputs
        return outputs, rel_loss + mlm_loss_wvc + mlm_loss_aux + mvrc_loss

    def attention_vis(self, image, boxes, im_info, text):
        """Every layer's attention probabilities, [B, layers, heads, L, L]
        fp32 with L = T + O + 1, from a deterministic forward (dropout off
        whatever the module's mode): zero text tags, so each token's
        visual embedding is the whole-image box's; the generic object
        linguistic embedding; ``text > 0`` as the text mask. The encoder
        takes its plain attention route here, since the kernels never
        write the probs."""
        box_mask = boxes[:, :, 0] > -1.5
        was_training = self.training
        self.eval()
        try:
            obj_reps = self.image_feature_extractor(
                image, boxes, box_mask, im_info)["obj_reps"]
            text_visual = collect_obj_reps(torch.zeros_like(text), obj_reps)
            obj_vl = generic_obj_vl_embeddings(
                self.object_linguistic_embeddings, obj_reps)
            _, _, probs = VisualLinguisticBert.forward(
                self.vlbert, text, torch.zeros_like(text), text_visual,
                text > 0, obj_vl, box_mask, output_attention_probs=True)
        finally:
            self.train(was_training)
        return torch.stack(probs, dim=1).to(torch.float32)


def _pad_t(x, t, value=0):
    """``x`` [N, T', ...] padded with ``value`` to T = t along dim 1."""
    pad = [0, 0] * (x.dim() - 2) + [0, t - x.shape[1]]
    return F.pad(x, pad, value=value)


MODULES = {"ResNetVLBERT:refcoco": ResNetVLBERTForRefCOCO,
           "ResNetVLBERT:vqa": ResNetVLBERTForVQA,
           "ResNetVLBERT:vcr": ResNetVLBERTForVCR,
           # without the corpus rows when the name lacks "Multitask"
           "ResNetVLBERTForPretraining:pretrain":
               ResNetVLBERTForPretrainingMultitask,
           "ResNetVLBERTForPretrainingMultitask:pretrain":
               ResNetVLBERTForPretrainingMultitask,
           # cfgs/pretrain/vis_attention_maps_coco.yaml's module, which the
           # JAX package's registry lacks: the pretraining model without
           # the corpus rows, whose attention_vis the dump runs
           "ResNetVLBERTForAttentionVis:pretrain":
               ResNetVLBERTForPretrainingMultitask}

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}

# TPU knobs the port accepts and ignores, each with the reason
_IGNORED_KNOBS = {
    # pick between two formulations of one function: on CUDA the port
    # always launches its kernels (Philox dropout for DROPOUT_IMPL)
    "FUSED_ATTENTION": "the attention kernels always run",
    "ROI_ALIGN_IMPL": "the ROIAlign kernels always run",
    "DROPOUT_IMPL": "the Philox dropout kernels always run",
    "RNG_IMPL": "dropout draws Philox from the step's seed",
    # what it buys the JAX package K3/K4 always do: the backward keeps only
    # q, k, v and the bias, and rebuilds probs and mask from the seed
    "ATTN_REMAT": "K3/K4 keep only q, k, v and the bias for the backward",
    # XLA compile-time, layout and buffer levers
    "SCAN_LAYERS": "an XLA layout lever, not ported (a JAX checkpoint's "
                   "stacked layers are read)",
    "ROI_CHUNK": "chunks XLA's ROIAlign intermediate, which K1 has not",
    "DONATE_STATE": "XLA buffer donation",
    "COMPILE_CACHE_DIR": "an XLA compile cache",
    "MASKED_OPT_STATE": "moments are kept for the trained parameters "
                        "only (a JAX checkpoint's masked moments are read)",
    # device meshes: a model is built whole, on one card; engine.train
    # (--dist) reads them (parallel/dist.py::check_partition), splits the
    # model under PARTITION_MODE tp (parallel/tp.py) and shards it under
    # fsdp (parallel/fsdp.py), after tp's split on a [d, m] mesh
    "MESH_SHAPE": "the model is built whole on one card; engine.train "
                  "--dist lays its ranks out as MESH_SHAPE [d] or, under "
                  "PARTITION_MODE tp or fsdp, [d, m]",
    "MESH_AXES": "the model is built whole on one card; PARTITION_MODE tp, "
                 "and fsdp on a model axis, under engine.train --dist take "
                 "[data, model]",
    "PARTITION_MODE": "the model is built whole on one card; engine.train "
                      "--dist trains dp, fsdp (sharded state; on [d, m] "
                      "over tp's split) or tp (heads and FFN split over "
                      "the model axis)",
}


def build_module(config, task, dtype=None, device=None, fused_qkv=None,
                 remat=None):
    """Build a task module from a vlbert_tpu config.

    dtype: compute dtype; None reads TPU.COMPUTE_DTYPE. fused_qkv: None
    reads TPU.FUSED_QKV. remat: per-layer activation checkpointing of the
    encoder in training; None reads TPU.REMAT. The knobs of
    ``_IGNORED_KNOBS`` are accepted and ignored with a warning that gives
    the reason: TPU.FUSED_ATTENTION, TPU.ROI_ALIGN_IMPL, TPU.DROPOUT_IMPL
    and TPU.RNG_IMPL choose a formulation where the port always launches
    its kernel; TPU.ATTN_REMAT keeps only q, k, v and the bias for the
    attention backward, which K3/K4 always do; TPU.SCAN_LAYERS and the
    other XLA levers have no counterpart; the mesh knobs lay out the ranks
    of ``engine.train --dist`` (``parallel/dist.py`` checks them against
    the process group, ``parallel/tp.py`` splits the built model under
    PARTITION_MODE tp). The other TPU knobs are read where they
    apply (the loaders, the transforms, train_net, the checkpoints).
    """
    key = f"{config.MODULE}:{task}"
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
        warnings.warn(f"TPU.{', TPU.'.join(present)} ignored on CUDA: "
                      + "; ".join(f"{k}: {_IGNORED_KNOBS[k]}"
                                  for k in present), stacklevel=2)
    if dtype is None:
        dtype = _DTYPES[tpu.get("COMPUTE_DTYPE", "bfloat16")]
    if fused_qkv is None:
        fused_qkv = bool(tpu.get("FUSED_QKV", False))
    if remat is None:
        remat = bool(tpu.get("REMAT", False))
    vl_cfg = VLBertConfig.from_attrdict(config.NETWORK.VLBERT, dtype=dtype,
                                        fused_qkv=fused_qkv, remat=remat)
    cls = MODULES[key]
    if cls is ResNetVLBERTForVCR and master_dataset(config).get("TASK") \
            == "Q2AR":
        cls = ResNetVLBERTForVCRQ2AR
    if cls is ResNetVLBERTForPretrainingMultitask:
        return cls(config, vl_cfg, with_aux=config.MODULE.endswith(
            "Multitask"), mask_visual_feat_dim=master_dataset(config).get(
                "PRECOMPUTED_FEAT_DIM", 2048), device=device)
    return cls(config, vl_cfg, device=device)
