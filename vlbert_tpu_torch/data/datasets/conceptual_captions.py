"""Conceptual Captions pretraining dataset + the pretrain batch collator.

ref: pretrain/data/datasets/conceptual_captions.py. Reads the reference's
data layout verbatim: a jsonl db with per-item {'image': ..., 'frcnn': ...,
'caption': [...]}; per-item frcnn json files with base64 boxes / class
scores / (optional) 2048-d features, sorted by max class confidence
(:103-112); whole-image box prepended (:130-135, with mean-pooled feature in
precomputed mode :133-135 and the adjusted running mean when regions get
masked :184-190); zero-image fallback (:122-128); box clamping (:147-151);
Task1 relationship label by 50% random caption swap (:153-163); Task2 MLM
wwm (:165-174); Task3 MVRC (:176-199); masked-RoI pixel zeroing (:201-206);
joint truncation (:215-232).

__getitem__ returns variable-length numpy pieces; the collator pads to the
static buckets of cfg.TPU.

Port copy of ``vlbert_tpu/data/datasets/conceptual_captions.py``,
unchanged but for its imports: the port imports nothing of the JAX package.
``tests/test_torch_host_copies.py`` holds it to the original.
"""

from __future__ import annotations

import os

import numpy as np

from vlbert_tpu_torch.data.collate import PicklableCollate, pad_to, stack_batch
from vlbert_tpu_torch.data.io_utils import (b64_decode, load_json_maybe_zip,
                                            load_jsonl)
from vlbert_tpu_torch.data.masking import (random_mask_region, random_word_wwm,
                                           truncate_seq_and_boxes)
from vlbert_tpu_torch.data.zipreader import read_image


class ConceptualCaptionsDataset:
    def __init__(self, ann_file, image_set, root_path, data_path, *,
                 tokenizer, transform=None, seq_len=64,
                 with_precomputed_visual_feat=False, mask_raw_pixels=True,
                 with_rel_task=True, with_mlm_task=True, with_mvrc_task=True,
                 zip_mode=False, add_image_as_a_box=False, seed=0,
                 fallback_fill_rgb=(123, 116, 103), **kwargs):
        annot = {"train": "train_frcnn.json", "val": "val_frcnn.json"}
        self.data_path = data_path
        self.ann_file = os.path.join(data_path, annot.get(image_set, image_set))
        self.seq_len = seq_len
        self.with_precomputed_visual_feat = with_precomputed_visual_feat
        self.mask_raw_pixels = mask_raw_pixels
        self.with_rel_task = with_rel_task
        self.with_mlm_task = with_mlm_task
        self.with_mvrc_task = with_mvrc_task
        self.zip_mode = zip_mode
        self.add_image_as_a_box = add_image_as_a_box
        self.transform = transform
        self.tokenizer = tokenizer
        # rounded PIXEL_MEANS in RGB order: the zero-image fallback is
        # filled with these so that BGR-mean normalization (host or
        # on-device) yields ~0.0, matching the reference, which creates
        # the zeros buffer AFTER normalization (ref
        # conceptual_captions.py:122-128,141-145: new_zeros post-transform)
        self.fallback_fill_rgb = tuple(int(v) for v in fallback_fill_rgb)
        self.rng = np.random.default_rng(seed)

        self.database = self.load_annotations()

    def load_annotations(self):
        database = load_jsonl(self.ann_file)
        if not self.zip_mode:
            for i, idb in enumerate(database):
                database[i]["frcnn"] = (
                    idb["frcnn"].replace(".zip@", "").replace(".0", "")
                    .replace(".1", "").replace(".2", "").replace(".3", ""))
                database[i]["image"] = idb["image"].replace(".zip@", "")
        return database

    data_names = ["image", "boxes", "im_info", "text",
                  "relationship_label", "mlm_labels", "mvrc_ops", "mvrc_labels"]

    def __len__(self):
        return len(self.database)

    def _load_json(self, path):
        return load_json_maybe_zip(path)

    def _load_regions(self, idb):
        """Per-item region source (seam for subclasses, e.g. the live
        COCOCaptionsDataset). Returns (boxes [K, 4], cls_scores [K, C],
        extra) where extra carries image_w/image_h/features for the
        precomputed & image-fallback paths (None entries if unavailable)."""
        frcnn = self._load_json(os.path.join(self.data_path, idb["frcnn"]))
        boxes = np.frombuffer(b64_decode(frcnn["boxes"]), np.float32) \
            .reshape((frcnn["num_boxes"], -1)).copy()
        cls_scores = np.frombuffer(b64_decode(frcnn["classes"]), np.float32) \
            .reshape((frcnn["num_boxes"], -1)).copy()
        order = np.argsort(cls_scores.max(axis=1))[::-1]      # ref :108-111
        boxes = boxes[order]
        cls_scores = cls_scores[order]
        feats = None
        if self.with_precomputed_visual_feat:
            feats = np.frombuffer(b64_decode(frcnn["features"]), np.float32) \
                .reshape((frcnn["num_boxes"], -1))[order].copy()
        return boxes, cls_scores, {"image_w": frcnn["image_w"],
                                   "image_h": frcnn["image_h"],
                                   "features": feats}

    def __getitem__(self, index):
        idb = self.database[index]
        boxes, cls_scores, extra = self._load_regions(idb)

        feats = None
        if self.with_precomputed_visual_feat:
            image = None
            w0, h0 = extra["image_w"], extra["image_h"]
            feats = extra["features"]
        else:
            try:
                image = read_image(os.path.join(self.data_path, idb["image"]))
                h0, w0 = image.shape[:2]
            except Exception:
                if extra["image_w"] is None:                   # live COCO:
                    raise                                      # ref coco :176
                # zero-image fallback (ref :122-128,141-145). Built BEFORE
                # the transform so it is resized/normalized/FixPadded like
                # every other sample — a post-transform zeros buffer keeps
                # the ORIGINAL size/dtype and crashes np.stack at collate.
                # Filled with the rounded pixel means (RGB) so the
                # normalized valid region is ~0.0, as in the reference
                # (whose zeros buffer is created post-normalization).
                w0, h0 = extra["image_w"], extra["image_h"]
                image = np.full((int(h0), int(w0), 3),
                                self.fallback_fill_rgb, np.uint8)

        if self.add_image_as_a_box:                            # ref :130-135
            boxes = np.concatenate(
                [np.asarray([[0.0, 0.0, w0 - 1.0, h0 - 1.0]], np.float32),
                 boxes], 0)
            cls_scores_full = np.concatenate(
                [np.zeros_like(cls_scores[:1]), cls_scores], 0)
            if self.with_precomputed_visual_feat:
                feats = np.concatenate([feats.mean(0, keepdims=True), feats], 0)
        else:
            cls_scores_full = cls_scores

        im_info = np.asarray([w0, h0, 1.0, 1.0], np.float32)
        if self.transform is not None:
            s = {"image": image, "boxes": boxes, "masks": None,
                 "im_info": im_info, "flipped": False}
            s = self.transform(s)
            image, boxes, im_info = s["image"], s["boxes"], s["im_info"]

        w, h = float(im_info[0]), float(im_info[1])            # ref :147-151
        boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, w - 1)
        boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, h - 1)

        # Task 1 (ref :153-163)
        if self.rng.random() < 0.5 or (not self.with_rel_task):
            relationship_label = 1
            caption = idb["caption"]
        else:
            relationship_label = 0
            rand_index = index
            while rand_index == index:
                rand_index = int(self.rng.integers(len(self.database)))
            caption = self.database[rand_index]["caption"]
        if isinstance(caption, (list, tuple)):
            caption = " ".join(caption)

        # Task 2 (ref :165-174)
        if self.with_mlm_task:
            basic = self.tokenizer.basic_tokenizer.tokenize(caption)
            toks, mlm_labels = random_word_wwm(basic, self.tokenizer, self.rng)
        else:
            toks = self.tokenizer.tokenize(caption)
            mlm_labels = [-1] * len(toks)
        text = self.tokenizer.convert_tokens_to_ids(["[CLS]"] + toks + ["[SEP]"])
        mlm_labels = [-1] + mlm_labels + [-1]

        # Task 3 (ref :176-199)
        if self.with_mvrc_task:
            mvrc_ops, mvrc_labels = random_mask_region(cls_scores, self.rng)
            if self.add_image_as_a_box:
                mvrc_ops = [0] + mvrc_ops
                mvrc_labels = [np.zeros_like(cls_scores_full[0])] + mvrc_labels
                if self.with_precomputed_visual_feat:          # ref :184-190
                    nreal = boxes.shape[0] - 1
                    feats[0] *= nreal
                    nmask = 0
                    for op, f in zip(mvrc_ops, feats):
                        if op == 1:
                            nmask += 1
                            feats[0] -= f
                    feats[0] /= (nreal - nmask + 1e-5)
        else:
            mvrc_ops = [0] * boxes.shape[0]
            mvrc_labels = [np.zeros_like(cls_scores_full[0])] * boxes.shape[0]

        # zero out pixels of masked RoIs (ref :201-206)
        if (not self.with_precomputed_visual_feat) and self.mask_raw_pixels:
            for op, box in zip(mvrc_ops, boxes):
                if op == 1:
                    x1, y1, x2, y2 = box[:4]
                    image[int(y1):int(y2) + 1, int(x1):int(x2) + 1] = 0

        mvrc_labels = [np.asarray(l, np.float32) for l in mvrc_labels]
        if self.with_precomputed_visual_feat:
            boxes = np.concatenate([boxes[:, :4], feats], axis=1)

        text, mlm_labels, boxes, mvrc_ops, mvrc_labels = truncate_seq_and_boxes(
            list(text), list(mlm_labels), boxes, list(mvrc_ops), mvrc_labels,
            self.seq_len)

        return {
            "image": image,
            "boxes": np.asarray(boxes, np.float32),
            "im_info": np.asarray(im_info, np.float32),
            "text": np.asarray(text, np.int32),
            "relationship_label": np.int32(relationship_label),
            "mlm_labels": np.asarray(mlm_labels, np.int32),
            "mvrc_ops": np.asarray(mvrc_ops, np.int32),
            "mvrc_labels": np.stack(mvrc_labels) if mvrc_labels
            else np.zeros((0, 1), np.float32),
        }


class GeneralCorpusDataset:
    """Text-only MLM stream (ref: pretrain/data/datasets/general_corpus.py:
    36-67): line corpus, consecutive lines packed to >= min_seq_len, wwm."""

    data_names = ["text", "mlm_labels"]

    def __init__(self, ann_file, *, tokenizer, seq_len=64, min_seq_len=64,
                 seed=0, **kwargs):
        self.tokenizer = tokenizer
        self.seq_len = seq_len
        self.min_seq_len = min_seq_len
        self.rng = np.random.default_rng(seed)
        with open(ann_file, encoding="utf-8") as f:
            self.lines = [l.strip() for l in f if l.strip()]

    def __len__(self):
        return len(self.lines)

    def __getitem__(self, index):
        # pack consecutive lines until min_seq_len (ref :44-56)
        toks = []
        i = index
        while len(toks) < self.min_seq_len and i < len(self.lines):
            toks.extend(self.tokenizer.basic_tokenizer.tokenize(self.lines[i]))
            i += 1
        toks, labels = random_word_wwm(toks, self.tokenizer, self.rng)
        toks = toks[: self.seq_len - 2]
        labels = labels[: self.seq_len - 2]
        ids = self.tokenizer.convert_tokens_to_ids(["[CLS]"] + toks + ["[SEP]"])
        labels = [-1] + labels + [-1]
        return {"text": np.asarray(ids, np.int32),
                "mlm_labels": np.asarray(labels, np.int32)}


def _make_pretrain_collate_impl(max_text, max_boxes, num_classes,
                                image_size=None, precomputed_dim=0):
    """Pad to static buckets; box pad value -2 (validity boxes[...,0] > -1.5,
    ref pretrain module :126)."""

    def collate(samples):
        out = []
        box_dim = 4 + precomputed_dim
        for s in samples:
            o = {
                "image": None if s["image"] is None else s["image"],
                "boxes": pad_to(s["boxes"], (max_boxes, box_dim), -2.0,
                                np.float32),
                "im_info": s["im_info"],
                "text": pad_to(s["text"], (max_text,), 0, np.int32),
                "relationship_label": s["relationship_label"],
                "mlm_labels": pad_to(s["mlm_labels"], (max_text,), -1,
                                     np.int32),
                "mvrc_ops": pad_to(s["mvrc_ops"], (max_boxes,), 0, np.int32),
                "mvrc_labels": pad_to(s["mvrc_labels"],
                                      (max_boxes, num_classes), 0.0,
                                      np.float32),
            }
            out.append(o)
        b = stack_batch(out)
        return (b["image"], b["boxes"], b["im_info"], b["text"],
                b["relationship_label"], b["mlm_labels"], b["mvrc_ops"],
                b["mvrc_labels"])

    return collate


def make_pretrain_collate(*args, **kwargs):
    """Picklable collate (forkserver workers): see collate.PicklableCollate."""
    return PicklableCollate(_make_pretrain_collate_impl, *args, **kwargs)


def _make_corpus_collate_impl(max_text):
    def collate(samples):
        texts = np.stack([pad_to(s["text"], (max_text,), 0, np.int32)
                          for s in samples])
        labels = np.stack([pad_to(s["mlm_labels"], (max_text,), -1, np.int32)
                           for s in samples])
        return (texts, labels)

    return collate


def make_corpus_collate(*args, **kwargs):
    """Picklable collate (forkserver workers): see collate.PicklableCollate."""
    return PicklableCollate(_make_corpus_collate_impl, *args, **kwargs)
