"""RefCOCO+ dataset + collator.

ref: refcoco/data/datasets/refcoco.py + the REFER toolkit
(refcoco/data/datasets/refer/refer.py). Preserved semantics:
  * one db row per referring sentence (:264-288);
  * candidate boxes = gt COCO anns of the image ('gt') or detections
    ('proposal'/vg) (:133-176);
  * per-region binary label = IoU(candidate, gt_ref_box) > 0.5 (:200-203);
  * the gt box is PREPENDED before the transform so it flips/scales with the
    image, then stripped (:183-189) — labels are computed post-transform;
  * [CLS] expr [SEP] assembly (module :100-108) in the collator.

Annotation input: refs pickle (refs(unc).p) + instances.json as in the
REFER toolkit, or a prepared jsonl with
{image_fn, width, height, boxes [[x1,y1,x2,y2],...], gt_box, sentence}.

Port copy of ``vlbert_tpu/data/datasets/refcoco.py``, unchanged but for its
imports: the port imports nothing of the JAX package.
``tests/test_torch_host_copies.py`` holds it to the original.
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np

from vlbert_tpu_torch.data.collate import (PicklableCollate,
                                           assemble_expression_text, pad_to,
                                           stack_batch)
from vlbert_tpu_torch.data.io_utils import (b64_decode, load_json_maybe_zip,
                                            resolve_data_file)
from vlbert_tpu_torch.data.zipreader import read_image


def bbox_iou(boxes, query):
    """IoU of [N,4] vs [4] with +1 extents (ref common/utils/bbox.py:68-88)."""
    x11, y11, x12, y12 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    x21, y21, x22, y22 = query
    xa = np.maximum(x11, x21)
    ya = np.maximum(y11, y21)
    xb = np.minimum(x12, x22)
    yb = np.minimum(y12, y22)
    inter = np.clip(xb - xa + 1, 0, None) * np.clip(yb - ya + 1, 0, None)
    a1 = (x12 - x11 + 1) * (y12 - y11 + 1)
    a2 = (x22 - x21 + 1) * (y22 - y21 + 1)
    return inter / (a1 + a2 - inter)


def load_refer_db(refs_file, instances_file, splits):
    """Minimal REFER toolkit: one row per sentence (ref refer.py + :264-288)."""
    with open(refs_file, "rb") as f:
        refs = pickle.load(f)
    with open(instances_file) as f:
        inst = json.load(f)
    anns = {a["id"]: a for a in inst["annotations"]}
    imgs = {i["id"]: i for i in inst["images"]}
    img_anns = {}
    for a in inst["annotations"]:
        img_anns.setdefault(a["image_id"], []).append(a)

    def xywh_to_xyxy(b):
        # ref refcoco.py:286 and :138-140: x2 = x + w (no -1), even though
        # the IoU then uses +1 extents — mirrored exactly for parity
        return [b[0], b[1], b[0] + b[2], b[1] + b[3]]

    db = []
    for ref in refs:
        if ref["split"] not in splits:
            continue
        img = imgs[ref["image_id"]]
        gt = xywh_to_xyxy(anns[ref["ann_id"]]["bbox"])
        boxes = [xywh_to_xyxy(a["bbox"]) for a in img_anns[ref["image_id"]]]
        for sent in ref["sentences"]:
            db.append({
                "image_id": ref["image_id"],
                # COCO file_names are bare; the reference reads refcoco
                # images from the train2014 dir (zip: train2014.zip@/...,
                # ref :264-270)
                "image_fn": img["file_name"] if "/" in img["file_name"]
                else os.path.join("train2014", img["file_name"]),
                "width": img["width"],
                "height": img["height"],
                "boxes": boxes,
                "gt_box": gt,
                "sentence": " ".join(sent["tokens"]),
            })
    return db


# MAttNet detection + VG precomputed-box locations (ref refcoco.py:66-68)
PROPOSAL_DETS = "refcoco+/proposal/res101_coco_minus_refer_notime_dets.json"
VG_PROPOSAL = ("vgbua_res101_precomputed",
               "trainval2014_resnet101_faster_rcnn_genome")


class RefCOCODataset:
    def __init__(self, ann_file, image_set, root_path, data_path, *,
                 tokenizer, transform=None, test_mode=False,
                 boxes="gt", proposal_source="official",
                 add_image_as_a_box=True, zip_mode=False, seed=0, **kwargs):
        assert boxes in ("gt", "proposal", "proposal+gt", "gt+proposal"), \
            f"unsupported box source {boxes!r} (ref refcoco.py:133-176)"
        self.data_path = data_path
        self.test_mode = test_mode
        self.zip_mode = zip_mode
        self.boxes = boxes
        self.proposal_source = proposal_source
        self.add_image_as_a_box = add_image_as_a_box
        self.transform = transform
        self.tokenizer = tokenizer

        path = ann_file if os.path.isabs(ann_file) \
            else os.path.join(data_path, ann_file)
        if path.endswith(".jsonl"):
            with open(path) as f:
                self.database = [json.loads(l) for l in f if l.strip()]
        elif path.endswith(".p") or path.endswith(".pkl"):
            inst = os.path.join(os.path.dirname(path), "instances.json")
            self.database = load_refer_db(path, inst, set(image_set.split("+")))
        else:
            with open(path) as f:
                self.database = json.load(f)

        # MAttNet detections, loaded once per process (ref :85-96); boxes
        # stored xywh -> converted at lookup
        self.proposals = None
        if "proposal" in boxes and proposal_source == "official":
            with open(os.path.join(data_path, PROPOSAL_DETS)) as f:
                proposal_list = json.load(f)
            self.proposals = {}
            for p in proposal_list:
                self.proposals.setdefault(p["image_id"], []).append(p["box"])

    @property
    def group_ids(self):
        """Aspect groups for TRAIN.ASPECT_GROUPING (ref refcoco.py:305-318:
        horizontal w >= h -> 0, vertical -> 1). RefCOCO is the one task the
        reference ships with grouping ON (cfgs/refcoco/*.yaml)."""
        return np.asarray([0 if idb["width"] >= idb["height"] else 1
                           for idb in self.database], np.int32)

    def __len__(self):
        return len(self.database)

    def _candidate_boxes(self, idb):
        """Candidate regions by source (ref :133-176): gt COCO anns,
        MAttNet detections ('official'), or VG precomputed b64 boxes ('vg');
        'proposal+gt' concatenates detections then gt anns."""
        parts = []
        if "proposal" in self.boxes:
            if self.proposal_source == "official":
                dets = np.asarray(self.proposals.get(idb["image_id"], []),
                                  np.float32).reshape(-1, 4)
                dets[:, 2:] += dets[:, :2]                     # xywh -> xyxy
                parts.append(dets)
            elif self.proposal_source == "vg":
                # under zip_mode the VG subdir is '{sub}.zip@/{sub}'
                # (ref refcoco.py:146)
                box_fn = resolve_data_file(
                    self.data_path,
                    os.path.join(VG_PROPOSAL[0], VG_PROPOSAL[1],
                                 f"{idb['image_id']}.json"),
                    self.zip_mode)
                data = self._load_json(box_fn)
                dets = np.frombuffer(
                    b64_decode(data["boxes"]),
                    np.float32).reshape((data["num_boxes"], -1))[:, :4]
                parts.append(np.array(dets))
            else:
                raise ValueError(
                    f"unknown proposal source {self.proposal_source!r}")
        if "gt" in self.boxes:
            parts.append(np.asarray(idb["boxes"], np.float32).reshape(-1, 4))
        return np.concatenate(parts, 0) if len(parts) > 1 else parts[0]

    def _load_json(self, path):
        return load_json_maybe_zip(path)

    def __getitem__(self, index):
        idb = self.database[index]
        image = read_image(resolve_data_file(
            self.data_path, idb["image_fn"], self.zip_mode))
        h0, w0 = image.shape[:2]

        boxes = self._candidate_boxes(idb)
        if self.add_image_as_a_box:
            boxes = np.concatenate(
                [np.asarray([[0, 0, w0 - 1, h0 - 1]], np.float32), boxes], 0)
        # prepend gt box so it transforms consistently (ref :183-189)
        if not self.test_mode:
            boxes = np.concatenate(
                [np.asarray([idb["gt_box"]], np.float32), boxes], 0)

        im_info = np.asarray([w0, h0, 1.0, 1.0], np.float32)
        flipped = False
        if self.transform is not None:
            s = {"image": image, "boxes": boxes, "masks": None,
                 "im_info": im_info, "flipped": False}
            s = self.transform(s)
            image, boxes, im_info = s["image"], s["boxes"], s["im_info"]
            flipped = s.get("flipped", False)

        w, h = float(im_info[0]), float(im_info[1])
        boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, w - 1)
        boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, h - 1)

        label = None
        if not self.test_mode:
            gt = boxes[0]
            boxes = boxes[1:]                                  # strip gt
            label = (bbox_iou(boxes, gt) > 0.5).astype(np.float32)  # ref :200-203

        expr_tokens = self.tokenizer.tokenize(idb["sentence"])
        if flipped:
            # mirror the spatial language with the mirrored boxes
            # (ref refcoco.py:208-226 flip_tokens)
            expr_tokens = ["right" if t == "left" else
                           "left" if t == "right" else t
                           for t in expr_tokens]
        expr_ids = self.tokenizer.convert_tokens_to_ids(expr_tokens)

        out = {"image": image, "boxes": boxes, "im_info": im_info,
               "expr_ids": np.asarray(expr_ids, np.int32)}
        if label is not None:
            out["label"] = label
        return out


def _make_refcoco_collate_impl(tokenizer, max_text, max_boxes, test_mode=False):
    cls_id, sep_id = tokenizer.cls_id, tokenizer.sep_id

    def collate(samples):
        rows = []
        for s in samples:
            ids, tmask = assemble_expression_text(
                list(s["expr_ids"]), max_text, cls_id, sep_id)
            n = len(s["boxes"])
            rows.append({
                "image": s["image"],
                "boxes": pad_to(s["boxes"], (max_boxes, 4), -2.0, np.float32),
                "box_mask": pad_to(np.ones(n, bool), (max_boxes,), False),
                "im_info": s["im_info"],
                "text_input_ids": ids,
                "text_mask": tmask,
                "label": pad_to(s["label"], (max_boxes,), -1.0, np.float32)
                if "label" in s else np.full(max_boxes, -1.0, np.float32),
            })
        b = stack_batch(rows)
        out = (b["image"], b["boxes"], b["box_mask"], b["im_info"],
               b["text_input_ids"], b["text_mask"])
        if not test_mode:
            out = out + (b["label"],)
        return out

    return collate


def make_refcoco_collate(*args, **kwargs):
    """Picklable collate (forkserver workers): see collate.PicklableCollate."""
    return PicklableCollate(_make_refcoco_collate_impl, *args, **kwargs)
