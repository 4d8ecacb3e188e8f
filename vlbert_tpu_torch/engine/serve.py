"""Single-query serving paths + latency probe (port of
vlbert_tpu/engine/serve.py: VQAServer and RefCOCOServer).

``VQAServer`` answers a question over precomputed box features in one
static (max_text, max_boxes) bucket: [CLS] question [SEP] [MASK] [SEP]
assembled on the host, VL-BERT, the answer logits at the [MASK] slot.
``RefCOCOServer`` runs the whole model from raw pixels on the device: the
eval transform (``vlbert_tpu_torch.data.transforms.build_transforms(cfg,
"test")``) on the host, then ResNet C4 + ROIAlign + conv5 RoI head, [CLS]
expr [SEP] text through VL-BERT, per-candidate grounding logits and the
argmax box.

``quantize="int8"`` on either server keeps the matmul and conv weights on
the card as per-output-channel int8 with fp32 scales (``ops/quant.py``;
the model is quantized in place, each weight of at least
``quantize_min_size`` elements) and dequantizes each at its op; the
launches a query are those of the fp32-weight server.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from vlbert_tpu_torch.data.collate import (assemble_expression_text,
                                           assemble_qa_text, pad_to)
from vlbert_tpu_torch.ops.quant import MIN_SIZE, quantize_module


class _Server:
    """Shared plumbing: the model in eval mode on its device (its weights
    int8 under ``quantize="int8"``), host numpy batches in, host numpy
    outputs back, and the latency probe. Subclasses define ``preprocess``
    and ``_forward(*tensors)``."""

    def __init__(self, model, quantize=None, quantize_min_size=MIN_SIZE):
        if quantize not in (None, "int8"):
            raise ValueError(f"unknown quantize mode: {quantize!r}")
        self.model = model.eval()
        self.device = next(model.parameters()).device
        if quantize == "int8":
            quantize_module(model, quantize_min_size)

    def infer(self, batch):
        """Run one preprocessed batch; returns host numpy outputs. A None
        entry (no image) stays None."""
        tensors = [None if a is None else
                   torch.from_numpy(np.asarray(a)).to(self.device)
                   for a in batch]
        with torch.inference_mode():
            out = self._forward(*tensors)
            return {k: v.cpu().numpy() for k, v in out.items()}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def measure_latency(self, queries, warmup=3):
        """p50/p90/p99 ms over distinct preprocessed queries; each timed
        call runs the model and fetches its outputs to the host, between
        two device synchronizations."""
        batches = [self.preprocess(*q) for q in queries]
        for b in batches[:warmup]:
            self.infer(b)
        lat = []
        for b in batches:
            self._sync()
            t0 = time.perf_counter()
            self.infer(b)
            self._sync()
            lat.append((time.perf_counter() - t0) * 1e3)
        lat = np.asarray(lat)
        return {"p50_ms": float(np.percentile(lat, 50)),
                "p90_ms": float(np.percentile(lat, 90)),
                "p99_ms": float(np.percentile(lat, 99)),
                "n": len(lat)}


class VQAServer(_Server):
    """VQA over precomputed features, one static (max_text, max_boxes)
    bucket: at the defaults L = 64 + 108 + 1 = 173.

    ``model`` is a ``ResNetVLBERTForVQA`` holding its weights; it is put in
    eval mode. ``answer_vocab`` lists the answers in logit order."""

    def __init__(self, model, tokenizer, answer_vocab, max_text=64,
                 max_boxes=108, feat_dim=2048, quantize=None,
                 quantize_min_size=MIN_SIZE):
        super().__init__(model, quantize, quantize_min_size)
        self.tokenizer = tokenizer
        self.answer_vocab = answer_vocab
        self.max_text = max_text
        self.max_boxes = max_boxes
        self.feat_dim = feat_dim

    def preprocess(self, question, boxes, features, im_w, im_h):
        """Host-side: tokenize, assemble and pad one query. Returns host
        numpy arrays (None, boxes+features, box_mask, im_info, ids, types,
        text_mask, ans_pos), each with a batch dim of 1; ans_pos is the
        [MASK] slot, one before the last [SEP], as the dataset has it."""
        q_ids = self.tokenizer.convert_tokens_to_ids(
            self.tokenizer.tokenize(question))
        ids, types, _tags, tmask, ans_pos = assemble_qa_text(
            q_ids, [0] * len(q_ids), [self.tokenizer.mask_id], [0],
            self.max_text, self.tokenizer.cls_id, self.tokenizer.sep_id)
        n = min(len(boxes), self.max_boxes)
        box_buf = np.full((self.max_boxes, 4 + self.feat_dim), -2.0,
                          np.float32)
        box_buf[:n, :4] = boxes[:n]
        box_buf[:n, 4:] = features[:n]
        box_mask = np.zeros(self.max_boxes, bool)
        box_mask[:n] = True
        im_info = np.asarray([im_w, im_h, 1.0, 1.0], np.float32)
        return (None, box_buf[None], box_mask[None], im_info[None],
                ids[None], types[None], tmask[None],
                np.asarray([ans_pos - 1], np.int32))

    def _forward(self, image, boxes, box_mask, im_info, ids, types, tmask,
                 ans_pos):
        out = self.model(image, boxes, box_mask, im_info, ids.long(),
                         types.long(), tmask, ans_pos.long())
        return {"label_logits": out["label_logits"]}

    def query(self, question, boxes, features, im_w, im_h):
        """The answer string."""
        logits = self.infer(self.preprocess(question, boxes, features, im_w,
                                            im_h))["label_logits"]
        return self.answer_vocab[int(np.argmax(logits[0]))]


class RefCOCOServer(_Server):
    """Single-image referring-expression grounding over static
    (max_text, max_boxes) buckets.

    ``model`` is a ``ResNetVLBERTForRefCOCO`` holding its weights; it is
    put in eval mode. Inputs are moved to the model's device.
    """

    def __init__(self, model, tokenizer, transform, max_text=24,
                 max_boxes=16, add_image_as_a_box=True, quantize=None,
                 quantize_min_size=MIN_SIZE):
        super().__init__(model, quantize, quantize_min_size)
        self.tokenizer = tokenizer
        self.transform = transform
        self.max_text = max_text
        self.max_boxes = max_boxes
        self.add_image_as_a_box = add_image_as_a_box

    def preprocess(self, image, boxes, expression):
        """image: uint8/float RGB [H0, W0, 3]; boxes: [N, 4] candidate boxes
        in ORIGINAL image coords; expression: the referring phrase. Returns
        host numpy arrays (image, boxes, box_mask, im_info, ids, text_mask),
        each with a batch dim of 1."""
        image = np.asarray(image)
        h0, w0 = image.shape[:2]
        boxes = np.asarray(boxes, np.float32).copy()
        if self.add_image_as_a_box:
            boxes = np.concatenate(
                [np.asarray([[0, 0, w0 - 1, h0 - 1]], np.float32), boxes], 0)
        s = {"image": image, "boxes": boxes, "masks": None,
             "im_info": np.asarray([w0, h0, 1.0, 1.0], np.float32),
             "flipped": False}
        if self.transform is not None:
            s = self.transform(s)
        image, boxes, im_info = s["image"], s["boxes"], s["im_info"]
        w, h = float(im_info[0]), float(im_info[1])
        boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, w - 1)
        boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, h - 1)

        expr_ids = self.tokenizer.convert_tokens_to_ids(
            self.tokenizer.tokenize(expression))
        ids, tmask = assemble_expression_text(
            expr_ids, self.max_text, self.tokenizer.cls_id,
            self.tokenizer.sep_id)
        n = min(len(boxes), self.max_boxes)
        box_buf = pad_to(boxes, (self.max_boxes, 4), -2.0, np.float32)
        box_mask = np.zeros(self.max_boxes, bool)
        box_mask[:n] = True
        return (np.ascontiguousarray(image)[None], box_buf[None],
                box_mask[None], np.asarray(im_info, np.float32)[None],
                ids[None], tmask[None])

    def _forward(self, image, boxes, box_mask, im_info, ids, tmask):
        """{"label_logits": [1, O], "pred_boxes": [1, 4]}."""
        return self.model(image, boxes, box_mask, im_info, ids.long(), tmask)

    def query(self, image, boxes, expression):
        """Returns a consistent triple over the CALLER's candidate list:
        {"box": [4] the best candidate box in ORIGINAL coords,
         "best_index": its index into the caller's list,
         "candidate_scores": [N] sigmoid scores,
         "image_box_score": score of the prepended whole-image box (or
         None)}. Serving picks from the caller's candidates only, so "box"
        always corresponds to "best_index"."""
        out = self.infer(self.preprocess(image, boxes, expression))
        logits = out["label_logits"][0]
        off = 1 if self.add_image_as_a_box else 0
        n = min(len(boxes), self.max_boxes - off)
        cand = logits[off:off + n]
        best = int(np.argmax(cand))
        return {"box": np.asarray(boxes[best], np.float32),
                "best_index": best,
                "candidate_scores": 1.0 / (1.0 + np.exp(-cand)),
                "image_box_score": float(1.0 / (1.0 + np.exp(-logits[0])))
                if self.add_image_as_a_box else None}
