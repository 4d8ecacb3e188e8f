"""VQA 2.0 dataset + collator.

ref: vqa/data/datasets/vqa.py. Preserved semantics: per-image precomputed
bottom-up boxes/features json (base64, :159-180 incl. 'image_box_feature'
fallback to mean), whole-image box prepend, box clamping, left/right token
swap on horizontal flip (:261-274), VQA consensus soft targets
min(1, matches/3) averaged leave-one-out (:286-306), answer vocab with
<unk> handling, [CLS] Q [SEP] [MASK] [SEP] text assembly moved to the
collator (ref module :141-167,196-209).

Annotation input: either the official questions/annotations json pair
(build_vqa_db) or a prepared jsonl where each row already has
{image_fn, box_fn, width, height, question, answers}.

Port copy of ``vlbert_tpu/data/datasets/vqa.py``, unchanged but for its
imports: the port imports nothing of the JAX package.
``tests/test_torch_host_copies.py`` holds it to the original.
"""

from __future__ import annotations

import base64
import json
import os

import numpy as np

from vlbert_tpu_torch.data.collate import (PicklableCollate, assemble_qa_text,
                                           pad_to, stack_batch)
from vlbert_tpu_torch.data.io_utils import (b64_decode, load_json_maybe_zip,
                                            resolve_data_file)
from vlbert_tpu_torch.data.zipreader import read_image




def build_vqa_db(questions_file, annotations_file=None, image_fn_template="",
                 box_fn_template=""):
    """Join official VQA questions (+annotations) into db rows."""
    with open(questions_file) as f:
        questions = json.load(f)["questions"]
    anns = {}
    if annotations_file is not None:
        with open(annotations_file) as f:
            for a in json.load(f)["annotations"]:
                anns[a["question_id"]] = a
    db = []
    for q in questions:
        row = {
            "image_id": q["image_id"],
            "question_id": q["question_id"],
            "question": q["question"],
            "image_fn": image_fn_template.format(q["image_id"]),
            "box_fn": box_fn_template.format(q["image_id"]),
        }
        if q["question_id"] in anns:
            row["answers"] = [a["answer"]
                              for a in anns[q["question_id"]]["answers"]]
        db.append(row)
    return db


def build_vqa_imdb_db(imdb_file, image_set, data_path, boxes="36",
                      test_mode=False):
    """Pythia imdb ``.npy`` input path (ref vqa/data/datasets/vqa.py:357-376):
    imdb[0] is an info header; each following item carries image_id /
    question_id / question_tokens / answers. Image and box paths follow the
    reference's directory conventions (:80-120); width/height come from the
    COCO instances json when present (falling back to the image file at
    __getitem__ time if the row lacks them).
    """
    imdb = np.load(imdb_file, allow_pickle=True)
    coco_split = {"minival2014": "val2014",
                  "valminusminival2014": "val2014",
                  "test-dev2015": "test2015"}.get(image_set, image_set)
    box_dir = os.path.join(
        "vgbua_res101_precomputed",
        ("test2015" if "test" in coco_split else "trainval")
        + ("_resnet101_faster_rcnn_genome_36" if boxes == "36"
           else "_resnet101_faster_rcnn_genome"))
    dims = {}
    inst = os.path.join(data_path, "annotations",
                        f"instances_{coco_split}.json")
    if not os.path.exists(inst):
        inst = os.path.join(data_path, "annotations",
                            f"image_info_{coco_split}.json")
    if os.path.exists(inst):
        with open(inst) as f:
            for im in json.load(f)["images"]:
                dims[im["id"]] = (im["width"], im["height"])

    db = []
    for item in imdb[1:]:
        image_id = item["image_id"]
        row = {
            "image_id": image_id,
            "question_id": item["question_id"],
            "question_tokens": list(item["question_tokens"]),
            "image_fn": os.path.join(
                coco_split, f"COCO_{coco_split}_{image_id:012d}.jpg"),
            "box_fn": os.path.join(box_dir, f"{image_id}.json"),
        }
        if image_id in dims:
            row["width"], row["height"] = dims[image_id]
        if not test_mode and item.get("answers") is not None:
            row["answers"] = list(item["answers"])
        db.append(row)
    return db


class VQADataset:
    def __init__(self, ann_file, image_set, root_path, data_path, *,
                 tokenizer, answer_vocab_file, transform=None,
                 test_mode=False, zip_mode=False,
                 with_precomputed_visual_feat=True,
                 add_image_as_a_box=True, boxes="36", use_imdb=True,
                 seed=0, **kwargs):
        self.data_path = data_path
        self.test_mode = test_mode
        self.zip_mode = zip_mode
        self.with_precomputed_visual_feat = with_precomputed_visual_feat
        self.add_image_as_a_box = add_image_as_a_box
        self.transform = transform
        self.tokenizer = tokenizer

        with open(answer_vocab_file) as f:
            self.answer_vocab = [l.strip() for l in f if l.strip()]
        if "<unk>" not in self.answer_vocab:
            # the reference indexes '<unk>' unguarded (ref vqa.py:284);
            # silently aliasing it to a real answer would zero that class's
            # soft targets — fail loudly instead
            raise ValueError(
                f"answer vocab {answer_vocab_file} has no '<unk>' entry")
        self._unk = self.answer_vocab.index("<unk>")

        path = ann_file if os.path.isabs(ann_file) \
            else os.path.join(data_path, ann_file)
        if path.endswith(".npy"):
            # pythia imdb path (DATASET.USE_IMDB, ref :357-376)
            assert use_imdb, "imdb .npy annotations require USE_IMDB"
            self.database = build_vqa_imdb_db(
                path, image_set, data_path, boxes=boxes, test_mode=test_mode)
        elif path.endswith(".jsonl"):
            with open(path) as f:
                self.database = [json.loads(l) for l in f if l.strip()]
        else:
            with open(path) as f:
                self.database = json.load(f)

    def __len__(self):
        return len(self.database)

    @property
    def group_ids(self):
        """Aspect groups for TRAIN.ASPECT_GROUPING (ref vqa.py:413-426:
        horizontal w >= h -> 0, vertical -> 1); imdb rows without dims
        default to horizontal."""
        return np.asarray(
            [0 if idb.get("width", 1) >= idb.get("height", 0) else 1
             for idb in self.database], np.int32)

    def _load_json(self, path):
        return load_json_maybe_zip(path)

    def answer_to_ind(self, answer):
        try:
            return self.answer_vocab.index(answer)
        except ValueError:
            return self._unk

    def get_soft_target(self, answers):
        """VQA consensus leave-one-out (ref :286-306)."""
        soft = np.zeros(len(self.answer_vocab), np.float32)
        inds = [self.answer_to_ind(a) for a in answers]
        gt = list(enumerate(inds))
        for answer in set(inds):
            accs = []
            for g in gt:
                others = [it for it in gt if it != g]
                matching = [it for it in others if it[1] == answer]
                accs.append(min(1.0, len(matching) / 3.0))
            if answer != self._unk:
                soft[answer] = sum(accs) / len(accs)
        return soft

    @staticmethod
    def flip_tokens(tokens):
        return ["right" if t == "left" else "left" if t == "right" else t
                for t in tokens]

    def _data_file(self, rel):
        return resolve_data_file(self.data_path, rel, self.zip_mode)

    def __getitem__(self, index):
        idb = self.database[index]
        boxes_data = self._load_json(self._data_file(idb["box_fn"]))
        boxes = np.frombuffer(b64_decode(boxes_data["boxes"]), np.float32) \
            .reshape((boxes_data["num_boxes"], -1)).copy()

        feats = None
        if self.with_precomputed_visual_feat:
            image = None
            if "width" in idb:
                w0, h0 = idb["width"], idb["height"]
            else:    # imdb rows without a COCO instances json: read dims
                h0, w0 = read_image(
                    self._data_file(idb["image_fn"])).shape[:2]
            feats = np.frombuffer(b64_decode(boxes_data["features"]),
                                  np.float32) \
                .reshape((boxes_data["num_boxes"], -1)).copy()
        else:
            image = read_image(self._data_file(idb["image_fn"]))
            h0, w0 = image.shape[:2]

        if self.add_image_as_a_box:
            boxes = np.concatenate(
                [np.asarray([[0, 0, w0 - 1, h0 - 1]], np.float32), boxes], 0)
            if self.with_precomputed_visual_feat:
                if "image_box_feature" in boxes_data:
                    ibf = np.frombuffer(
                        b64_decode(boxes_data["image_box_feature"]),
                        np.float32).reshape((1, -1))
                else:
                    ibf = feats.mean(0, keepdims=True)
                feats = np.concatenate([ibf, feats], 0)

        im_info = np.asarray([w0, h0, 1.0, 1.0], np.float32)
        flipped = False
        if self.transform is not None:
            s = {"image": image, "boxes": boxes, "masks": None,
                 "im_info": im_info, "flipped": False}
            s = self.transform(s)
            image, boxes, im_info = s["image"], s["boxes"], s["im_info"]
            flipped = s["flipped"]

        w, h = float(im_info[0]), float(im_info[1])
        boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, w - 1)
        boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, h - 1)

        q_tokens = idb.get("question_tokens") \
            or self.tokenizer.basic_tokenizer.tokenize(idb["question"])
        if flipped:
            q_tokens = self.flip_tokens(q_tokens)              # ref :261-274
        q_retok = self.tokenizer.tokenize(" ".join(q_tokens))
        q_ids = self.tokenizer.convert_tokens_to_ids(q_retok)

        if self.with_precomputed_visual_feat:
            boxes = np.concatenate([boxes[:, :4], feats], 1)

        out = {"image": image, "boxes": boxes.astype(np.float32),
               "im_info": im_info, "q_ids": np.asarray(q_ids, np.int32)}
        if not self.test_mode:
            answers = idb["answers"]
            if flipped:
                answers = [" ".join(self.flip_tokens(a.split()))
                           for a in answers]
            out["label"] = self.get_soft_target(answers)
        return out


def _make_vqa_collate_impl(tokenizer, max_text, max_boxes, precomputed_dim=2048,
                     test_mode=False):
    """[CLS] Q [SEP] [MASK] [SEP]; ans_pos = index of [MASK]
    (ref module :196-209 + prepare_text_from_qa :141-167)."""
    cls_id, sep_id, mask_id = (tokenizer.cls_id, tokenizer.sep_id,
                               tokenizer.mask_id)

    def collate(samples):
        rows = []
        box_dim = 4 + precomputed_dim
        for s in samples:
            ids, types, _tags, tmask, ans_pos = assemble_qa_text(
                list(s["q_ids"]), [0] * len(s["q_ids"]),
                [mask_id], [0], max_text, cls_id, sep_id)
            n_box = len(s["boxes"])
            rows.append({
                "image": s["image"],
                "boxes": pad_to(s["boxes"], (max_boxes, box_dim), -2.0,
                                np.float32),
                "box_mask": pad_to(np.ones(n_box, bool), (max_boxes,), False),
                "im_info": s["im_info"],
                "text_input_ids": ids,
                "text_token_type_ids": types,
                "text_mask": tmask,
                # the [MASK] sits right before the final [SEP]
                "ans_pos": np.int32(ans_pos - 1),
                "label": s.get("label", np.zeros(1, np.float32)),
            })
        b = stack_batch(rows)
        out = (b["image"], b["boxes"], b["box_mask"], b["im_info"],
               b["text_input_ids"], b["text_token_type_ids"], b["text_mask"],
               b["ans_pos"])
        if not test_mode:
            out = out + (b["label"],)
        return out

    return collate


def make_vqa_collate(*args, **kwargs):
    """Picklable collate (forkserver workers): see collate.PicklableCollate."""
    return PicklableCollate(_make_vqa_collate_impl, *args, **kwargs)
