"""VCR dataset + collator.

ref: vcr/data/datasets/vcr.py. Semantics preserved:
  * jsonl annotations + per-image metadata json (boxes [x1,y1,x2,y2,score],
    polygon segms, object names, width/height);
  * object references ``[obj_idx, ...]`` in mixed-token questions/answers
    become object names, with persons mapped to rotating gender-neutral
    names (:21-22, :297-304); each wordpiece carries a TAG = box index
    (+1 when the whole image is box 0, :203-251);
  * only_use_relevant_dets filter (:253-279);
  * task wiring Q2A / QA2R (incl. qa2r_noq) (:388-426);
  * joint q/a truncation to seq_len (:321-343);
  * instance masks rasterized from polygons to mask_size (:355-358);
  * whole-image box prepend with class 0 + all-ones mask (:359-363);
  * box clamping (:382-386).

The reference's on-device prepare_text_from_qa ([CLS] Q [SEP] A [SEP] per
choice, vcr/modules/resnet_vlbert_for_vcr.py:135-164) happens in the
COLLATOR here, producing static [B, C, T] tensors.

Note: the reference also emits align matrices (:366-374) that its own task
module accepts but never reads — they fed a legacy BERT-feature path — so
they are intentionally not produced.

Port copy of ``vlbert_tpu/data/datasets/vcr.py``, unchanged but for its
imports: the port imports nothing of the JAX package.
``tests/test_torch_host_copies.py`` holds it to the original.
"""

from __future__ import annotations

import json
import os

import numpy as np

from vlbert_tpu_torch.data.collate import (PicklableCollate, assemble_qa_text,
                                           pad_to, stack_batch)
from vlbert_tpu_torch.data.io_utils import load_json_maybe_zip, load_jsonl
from vlbert_tpu_torch.data.zipreader import read_image
from vlbert_tpu_torch.utils.mask import generate_instance_mask

GENDER_NEUTRAL_NAMES = ["Casey", "Riley", "Jessie", "Jackie", "Avery",
                        "Jaime", "Peyton", "Kerry", "Jody", "Kendall",
                        "Frankie", "Pat", "Quinn"]

# Fixed COCO-81 category list (ref vcr/data/datasets/vcr.py:69-77) used for
# boxes[:, 5] class ids; VCR's object_word_embed_mode=1 feeds these into a
# learned class embedding, so the ids must be stable across visit orders and
# match converted reference checkpoints.
VCR_CATEGORIES = [
    "__background__", "person", "bicycle", "car", "motorcycle", "airplane",
    "bus", "train", "truck", "boat", "trafficlight", "firehydrant",
    "stopsign", "parkingmeter", "bench", "bird", "cat", "dog", "horse",
    "sheep", "cow", "elephant", "bear", "zebra", "giraffe", "backpack",
    "umbrella", "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard",
    "sportsball", "kite", "baseballbat", "baseballglove", "skateboard",
    "surfboard", "tennisracket", "bottle", "wineglass", "cup", "fork",
    "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "hotdog", "pizza", "donut", "cake", "chair",
    "couch", "pottedplant", "bed", "diningtable", "toilet", "tv", "laptop",
    "mouse", "remote", "keyboard", "cellphone", "microwave", "oven",
    "toaster", "sink", "refrigerator", "book", "clock", "vase", "scissors",
    "teddybear", "hairdrier", "toothbrush",
]


class VCRDataset:
    def __init__(self, ann_file, image_set, root_path, data_path, *,
                 tokenizer, transform=None, task="Q2A", test_mode=False,
                 zip_mode=False, only_use_relevant_dets=False,
                 add_image_as_a_box=True, mask_size=(14, 14),
                 basic_align=False, qa2r_noq=False, seq_len=64,
                 categories=None, cache_db=True, ignore_db_cache=True,
                 **kwargs):
        assert task in ("Q2A", "QA2R", "Q2AR")
        self.ann_file = ann_file if os.path.isabs(ann_file) \
            else os.path.join(data_path, ann_file)
        self.data_path = data_path
        self.root_path = root_path
        self.image_set = image_set
        self.task = task
        self.test_mode = test_mode
        self.zip_mode = zip_mode
        self.cache_db = cache_db
        self.ignore_db_cache = ignore_db_cache
        self.only_use_relevant_dets = only_use_relevant_dets
        self.add_image_as_a_box = add_image_as_a_box
        self.mask_size = tuple(mask_size) if not isinstance(mask_size, int) \
            else (mask_size, mask_size)
        self.basic_align = basic_align
        self.qa2r_noq = qa2r_noq
        self.seq_len = seq_len
        self.tokenizer = tokenizer
        self.transform = transform
        self.epoch = 0      # set by DataLoader.set_epoch; varies name rolls
        self.database = self.load_annotations(self.ann_file)
        # fixed 81-category COCO list (ref :69-78); the lookup is strict so
        # an unknown object name fails loudly rather than drifting ids
        cats = categories if categories is not None else VCR_CATEGORIES
        self._cat_to_idx = {c: i for i, c in enumerate(cats)}

    def load_annotations(self, ann_file):
        """jsonl parse with an optional pickle cache (ref :120-181:
        vcr_nometa_{task}_{image_set}_{split} under root_path/cache)."""
        import pickle

        base = os.path.basename(ann_file)
        if base.endswith(".jsonl"):
            base = base[: -len(".jsonl")]
        name = f"vcr_nometa_{self.task}_{self.image_set}_{base}"
        if self.only_use_relevant_dets:
            name += "_only_relevant_dets"
        if self.zip_mode:
            name += "_zipped"
        cache_root = os.path.join(self.root_path or ".", "cache")
        cache_path = os.path.join(cache_root, f"{name}.pkl")

        if os.path.exists(cache_path) and not self.ignore_db_cache:
            try:
                with open(cache_path, "rb") as f:
                    return pickle.load(f)
            except Exception:
                # concurrent writer or a crash-truncated file: fall through
                # to the jsonl source instead of poisoning the run
                pass

        database = load_jsonl(ann_file)
        if self.cache_db:
            try:
                os.makedirs(cache_root, exist_ok=True)
                # atomic publish: other ranks polling os.path.exists must
                # never observe a partially-written pickle
                tmp_path = cache_path + f".tmp.{os.getpid()}"
                with open(tmp_path, "wb") as f:
                    pickle.dump(database, f)
                os.replace(tmp_path, cache_path)
            except OSError:
                pass  # read-only data dir: run uncached
        return database

    def __len__(self):
        return len(self.database)

    def _cat_idx(self, name):
        return self._cat_to_idx[name]

    def _load_json(self, path):
        return load_json_maybe_zip(path)

    def retokenize_with_tags(self, tokens, objects_replace_name, non_obj_tag):
        """ref :203-251 — returns list of (token_id, tag)."""
        parsed, tags = [], []
        for mixed in tokens:
            if isinstance(mixed, list):
                names = [objects_replace_name[o] for o in mixed]
                re_toks = self.tokenizer.tokenize(names[0])
                parsed.extend(re_toks)
                tags.extend([mixed[0] + non_obj_tag + 1] * len(re_toks))
                for name, o in zip(names[1:], mixed[1:]):
                    parsed.append("and")
                    tags.append(non_obj_tag)
                    re_toks = self.tokenizer.tokenize(name)
                    parsed.extend(re_toks)
                    tags.extend([o + non_obj_tag + 1] * len(re_toks))
            else:
                re_toks = self.tokenizer.tokenize(mixed)
                parsed.extend(re_toks)
                tags.extend([non_obj_tag] * len(re_toks))
        ids = self.tokenizer.convert_tokens_to_ids(parsed)
        return list(zip(ids, tags))

    @staticmethod
    def keep_only_relevant_dets(question, answer_choices, rationale_choices):
        """ref :253-279 — remap object indices to the used subset."""
        dets = []

        def remap(tok_seq):
            for i, tok in enumerate(tok_seq):
                if isinstance(tok, list):
                    for j, o in enumerate(tok):
                        if o not in dets:
                            dets.append(o)
                        tok_seq[i][j] = dets.index(o)

        remap(question)
        if answer_choices is not None:
            for a in answer_choices:
                remap(a)
        if rationale_choices is not None:
            for r in rationale_choices:
                remap(r)
        return dets, question, answer_choices, rationale_choices

    def _data_file(self, rel_fn):
        """Resolve an annotation-relative file: plain dir, or inside the
        '{image_set}.zip@/{image_set}' archive under ZIP_MODE (the reference
        rewrites paths the same way, ref vcr.py:150-152)."""
        if os.path.isabs(rel_fn) or ".zip@" in rel_fn:
            return rel_fn
        if self.zip_mode:
            return os.path.join(
                self.data_path, f"{self.image_set}.zip@/{self.image_set}",
                rel_fn)
        return os.path.join(self.data_path, rel_fn)

    def __getitem__(self, index):
        # shallow row copy + targeted 2-level copies of the mixed-token
        # sequences (the ONLY fields mutated in place downstream:
        # keep_only_relevant_dets.remap rewrites object indices inside the
        # nested [obj_idx, ...] lists). A full deepcopy of the row was
        # ~2.5% of per-sample host cost for copies that are never needed.
        row = self.database[index]
        idb = dict(row)
        if self.only_use_relevant_dets:
            def _copy_mixed(seq):
                return [list(t) if isinstance(t, list) else t for t in seq]

            idb["question"] = _copy_mixed(row["question"])
            idb["answer_choices"] = [_copy_mixed(a)
                                     for a in row["answer_choices"]]
            if row.get("rationale_choices") is not None:
                idb["rationale_choices"] = [_copy_mixed(r)
                                            for r in row["rationale_choices"]]
        metadata = self._load_json(self._data_file(idb["metadata_fn"]))
        idb["boxes"] = metadata["boxes"]
        idb["segms"] = metadata["segms"]

        if self.only_use_relevant_dets:
            dets, idb["question"], idb["answer_choices"], idb["rationale_choices"] = \
                self.keep_only_relevant_dets(
                    idb["question"], idb["answer_choices"],
                    idb.get("rationale_choices")
                    if self.task != "Q2A" else None)
            idb["objects"] = [idb["objects"][i] for i in dets]
            idb["boxes"] = [idb["boxes"][i] for i in dets]
            idb["segms"] = [idb["segms"][i] for i in dets]

        # Gender-neutral name rotation (ref :297-304). The reference rotates
        # a GLOBAL counter across __getitem__ calls — nondeterministic under
        # parallel loading (per-worker dataset copies, shuffled visit order,
        # and a data race in a thread pool). Names are interchangeable
        # placeholders, so we rotate deterministically per (epoch, sample):
        # reproducible for any worker/thread layout, and a given sample
        # still sees different names each epoch (index-only seeding would
        # make names a stable per-sample cue the model could memorize,
        # which the reference's visit-order rotation avoids).
        objects_replace_name = []
        person_name_id = (index + self.epoch * 31) % len(GENDER_NEUTRAL_NAMES)
        for o in idb["objects"]:
            if o == "person":
                objects_replace_name.append(
                    GENDER_NEUTRAL_NAMES[person_name_id])
                person_name_id = (person_name_id + 1) \
                    % len(GENDER_NEUTRAL_NAMES)
            else:
                objects_replace_name.append(o)

        non_obj_tag = 0 if self.add_image_as_a_box else -1
        question = self.retokenize_with_tags(
            idb["question"], objects_replace_name, non_obj_tag)
        answers = [self.retokenize_with_tags(a, objects_replace_name, non_obj_tag)
                   for a in idb["answer_choices"]]
        rationales = None
        if self.task != "Q2A":
            rationales = [self.retokenize_with_tags(
                r, objects_replace_name, non_obj_tag)
                for r in idb["rationale_choices"]]

        # truncation (ref :321-343). Note the reference truncates QA2R only
        # in train/val mode (test-mode conditioned queries are clipped by the
        # static max_text buffer downstream, mirroring the 512-position cap).
        if self.task in ("Q2A", "Q2AR"):
            # Q2A-style: every answer truncated against the question. For
            # Q2AR this must run over ALL answers (not just the gt one as
            # the rationale pass below would), otherwise the gt choice is
            # systematically shorter than the distractors — a learnable
            # length cue on the answer head.
            for a in answers:
                while len(question) + len(a) > self.seq_len:
                    if len(a) > len(question):
                        a.pop()
                    else:
                        question.pop()
        if self.task != "Q2A" and not self.test_mode:
            a_lab = answers[idb["answer_label"]]
            for r in rationales:
                while len(question) + len(a_lab) + len(r) > self.seq_len:
                    if len(r) > (len(question) + len(a_lab)):
                        r.pop()
                    elif len(question) > 1:
                        question.pop()
                    else:
                        a_lab.pop()

        image = read_image(self._data_file(idb["img_fn"]))
        h0, w0 = image.shape[:2]
        objects = idb["objects"]

        boxes = np.zeros((len(objects), 6), np.float32)
        masks = np.zeros((len(objects), *self.mask_size), np.float32)
        if objects:
            boxes[:, :5] = np.asarray(idb["boxes"], np.float32)
            boxes[:, 5] = [self._cat_idx(o) for o in objects]
            for i in range(len(objects)):
                masks[i] = generate_instance_mask(
                    idb["segms"][i], idb["boxes"][i], self.mask_size)
        if self.add_image_as_a_box:                            # ref :359-363
            image_box = np.asarray([[0, 0, w0 - 1, h0 - 1, 1.0, 0]], np.float32)
            boxes = np.concatenate([image_box, boxes], 0)
            masks = np.concatenate(
                [np.ones((1, *self.mask_size), np.float32), masks], 0)

        im_info = np.asarray([w0, h0, 1.0, 1.0], np.float32)
        if self.transform is not None:
            s = {"image": image, "boxes": boxes, "masks": masks,
                 "im_info": im_info, "flipped": False}
            s = self.transform(s)
            image, boxes, masks, im_info = (s["image"], s["boxes"],
                                            s["masks"], s["im_info"])

        w, h = float(im_info[0]), float(im_info[1])
        boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, w - 1)
        boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, h - 1)

        # choice assembly (ref :388-426): Q2A query=question,
        # QA2R query=question(+unless noq)+chosen answer, choices=rationales,
        # Q2AR emits both (ref data_names :448-483)
        if self.task == "Q2A":
            query = question
            choices = answers
            label = idb.get("answer_label") if not self.test_mode else None
        elif self.task == "QA2R":
            if self.test_mode:
                # test-time answer conditioning (ref :416-424): one query per
                # candidate answer; the test driver runs 4 conditioned passes
                # and emits 4x4 = 16 probabilities per question
                query = [([] if self.qa2r_noq else question) + a
                         for a in answers]
            else:
                a_lab = answers[idb["answer_label"]]
                query = ([] if self.qa2r_noq else question) + a_lab
            choices = rationales
            label = idb.get("rationale_label") if not self.test_mode else None
        else:  # Q2AR
            query = question
            choices = answers
            label = idb.get("answer_label") if not self.test_mode else None

        out = {
            "image": image,
            "boxes": boxes[:, :4],
            "objects": boxes[:, 5].astype(np.int32),
            "box_scores": boxes[:, 4],
            "masks": masks,
            "query": query,          # list of (id, tag)
            "choices": choices,      # C lists of (id, tag)
            "im_info": im_info,
        }
        if label is not None:
            out["label"] = np.int32(label)
        if self.task == "Q2AR":
            a_lab = answers[idb["answer_label"]] if not self.test_mode else []
            out["rationale_query"] = question + a_lab
            out["rationale_choices"] = rationales
            if not self.test_mode:
                out["rationale_label"] = np.int32(idb["rationale_label"])
        return out


def _make_vcr_collate_impl(tokenizer, max_text, max_boxes, mask_size=(14, 14),
                     answer_first=False, one_sent=False, test_mode=False,
                     task="Q2A"):
    """Collate to the ResNetVLBERTForVCR batch tuple with static shapes.

    Layouts by task/mode (text tensors are int32/bool, static [.., T]):
      * Q2A, or QA2R train/val:  text [B, C, T]
      * QA2R test (answer-conditioned, ref vcr.py:416-424 + test.py:101-115):
        text [B, A, C, T] — axis 1 indexes the conditioning answer; the test
        driver slices per a_id
      * Q2AR train/val: answer text [B, C, T] + rationale text [B, C, T]
        (rationale query = question + gt answer, ref data_names :448-470)
    """
    cls_id, sep_id = tokenizer.cls_id, tokenizer.sep_id
    mh, mw = mask_size
    conditioned = test_mode and task == "QA2R"

    def assemble_choice_text(query, choices):
        """One [C, T] text block from (query, choices) token/tag lists."""
        q_ids = [t[0] for t in query]
        q_tags = [t[1] for t in query]
        ids_c, types_c, tags_c, mask_c = [], [], [], []
        for ch in choices:
            a_ids = [t[0] for t in ch]
            a_tags = [t[1] for t in ch]
            ids, types, tags, tmask, _ = assemble_qa_text(
                q_ids, q_tags, a_ids, a_tags, max_text, cls_id, sep_id,
                answer_first=answer_first, one_sent=one_sent)
            ids_c.append(ids)
            types_c.append(types)
            tags_c.append(tags)
            mask_c.append(tmask)
        return (np.stack(ids_c), np.stack(types_c), np.stack(tags_c),
                np.stack(mask_c))

    def collate(samples):
        rows = []
        for s in samples:
            if conditioned:
                # s["query"] is a list of A conditioned queries
                per_a = [assemble_choice_text(q, s["choices"])
                         for q in s["query"]]
                ids, types, tags, tmask = (np.stack([p[k] for p in per_a])
                                           for k in range(4))
            else:
                ids, types, tags, tmask = assemble_choice_text(
                    s["query"], s["choices"])
            O = max_boxes
            row = {
                "image": s["image"],
                "boxes": pad_to(s["boxes"], (O, 4), -2.0, np.float32),
                "objects": pad_to(s["objects"], (O,), 0, np.int32),
                "segms": pad_to(s["masks"], (O, mh, mw), 0.0, np.float32),
                "box_mask": pad_to(np.ones(len(s["boxes"]), bool), (O,), False),
                "text_input_ids": ids,
                "text_token_type_ids": types,
                "text_tags": tags,
                "text_mask": tmask,
                "im_info": s["im_info"],
                "label": s.get("label", np.int32(0)),
            }
            if task == "Q2AR" and not test_mode:
                r_ids, r_types, r_tags, r_mask = assemble_choice_text(
                    s["rationale_query"], s["rationale_choices"])
                row.update(rationale_input_ids=r_ids,
                           rationale_token_type_ids=r_types,
                           rationale_tags=r_tags, rationale_mask=r_mask,
                           rationale_label=s.get("rationale_label",
                                                 np.int32(0)))
            rows.append(row)
        b = stack_batch(rows)
        out = (b["image"], b["boxes"], b["objects"], b["segms"],
               b["box_mask"], b["text_input_ids"], b["text_token_type_ids"],
               b["text_tags"], b["text_mask"])
        if task == "Q2AR" and not test_mode:
            out = out + (b["rationale_input_ids"],
                         b["rationale_token_type_ids"],
                         b["rationale_tags"], b["rationale_mask"],
                         b["im_info"], b["label"], b["rationale_label"])
        else:
            out = out + (b["im_info"],)
            if not test_mode:
                out = out + (b["label"],)
        return out

    return collate


def make_vcr_collate(*args, **kwargs):
    """Picklable collate (forkserver workers): see collate.PicklableCollate."""
    return PicklableCollate(_make_vcr_collate_impl, *args, **kwargs)
