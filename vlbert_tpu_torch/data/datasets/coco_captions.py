"""COCO-captions pretraining: the live dataset.

ref: pretrain/data/datasets/coco_captions.py — drives the same three
pretrain tasks from COCO2017 captions+instances json (gt boxes, one-hot
class scores over the contiguous category remap) instead of
Conceptual-Captions frcnn files.

``COCOCaptionsDataset`` is the live equivalent (used by
cfgs/pretrain/vis_attention_maps_coco.yaml): it indexes the two COCO json
files directly (pure-json — the reference's pycocotools usage is only an
index over the same structures, ref :89-104) and reuses the entire
ConceptualCaptions task pipeline via the ``_load_regions`` seam.
The JAX module's offline ``build_coco_captions_db`` is not copied: no
path of the port writes CC-format rows.

Port copy of ``vlbert_tpu/data/datasets/coco_captions.py`` (its
dataset), unchanged but for its imports: the port imports nothing of the
JAX package.
``tests/test_torch_host_copies.py`` holds it to the original.
"""

from __future__ import annotations

import json
import os

import numpy as np

from vlbert_tpu_torch.data.datasets.conceptual_captions import (
    ConceptualCaptionsDataset)


class COCOCaptionsDataset(ConceptualCaptionsDataset):
    """Live COCO2017 captions+instances pretraining dataset.

    Semantics preserved from the reference (coco_captions.py):
      * one item per image, sorted by image id, filtered to images that
        have instance annotations (ref :92-98); caption = the image's first
        caption annotation (ref :131-135);
      * boxes: gt instances, xywh -> xyxy with the TO_REMOVE=1 convention
        (ref :137-142);
      * cls_scores: one-hot [K, 81] over the contiguous category remap
        json_id -> i+1 (ref :100-104, :143-147);
      * zip_mode image root "{set}2017.zip@/{set}2017" (ref :53-57);
      * precomputed features / zero-image fallback unsupported, as in the
        reference (assert False branches, ref :149-151, :176-180).
    """

    def __init__(self, ann_file, image_set, root_path, data_path, *,
                 num_classes=81, **kwargs):
        assert not kwargs.get("with_precomputed_visual_feat"), \
            "live COCO captions has no precomputed features (ref :149)"
        # index the COCO jsons before the base ctor (it loads the db)
        annot = {"train": "annotations/captions_train2017.json",
                 "val": "annotations/captions_val2017.json"}
        annot_inst = {"train": "annotations/instances_train2017.json",
                      "val": "annotations/instances_val2017.json"}
        caps_file = os.path.join(data_path, annot.get(image_set, ann_file))
        inst_file = os.path.join(
            data_path, annot_inst.get(image_set,
                                      ann_file.replace("captions",
                                                       "instances")))
        if kwargs.get("zip_mode"):
            img_root = f"{image_set}2017.zip@/{image_set}2017"  # ref :53-55
        else:
            img_root = f"{image_set}2017"
        self._rows = self._index(caps_file, inst_file, img_root, num_classes)
        super().__init__(ann_file="", image_set=image_set,
                         root_path=root_path, data_path=data_path, **kwargs)

    @staticmethod
    def _index(caps_file, inst_file, img_root, num_classes):
        with open(caps_file) as f:
            caps = json.load(f)
        with open(inst_file) as f:
            inst = json.load(f)
        # contiguous remap over sorted category ids (pycocotools getCatIds
        # returns ids sorted; ref :100-104)
        cat_remap = {cid: i + 1 for i, cid in enumerate(
            sorted(c["id"] for c in inst["categories"]))}
        img_meta = {i["id"]: i for i in inst["images"]}
        inst_by_img = {}
        for a in inst["annotations"]:
            inst_by_img.setdefault(a["image_id"], []).append(a)
        caps_by_img = {}
        for a in caps["annotations"]:
            caps_by_img.setdefault(a["image_id"], []).append(a)

        rows = []
        for img_id in sorted(img_meta):                        # ref :92-98
            anns = inst_by_img.get(img_id)
            cap_anns = caps_by_img.get(img_id)
            if not anns or not cap_anns:
                continue
            xywh = np.asarray([a["bbox"] for a in anns], np.float32) \
                .reshape(-1, 4)
            boxes = np.concatenate([                           # ref :139-142
                xywh[:, :2],
                xywh[:, :2] + np.clip(xywh[:, 2:] - 1.0, 0.0, None)], axis=1)
            cls_scores = np.zeros((len(anns), num_classes), np.float32)
            for i, a in enumerate(anns):
                cls_scores[i, cat_remap[a["category_id"]]] = 1.0
            rows.append({
                "image": os.path.join(
                    img_root, img_meta[img_id]["file_name"]),
                "caption": cap_anns[0]["caption"],             # ref :131-135
                "boxes": boxes,
                "cls_scores": cls_scores,
            })
        return rows

    def load_annotations(self):
        return self._rows

    def _load_regions(self, idb):
        return (idb["boxes"].copy(), idb["cls_scores"].copy(),
                {"image_w": None, "image_h": None, "features": None})

