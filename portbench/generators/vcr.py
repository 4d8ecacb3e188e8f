"""VCR in its own on-disk form, made from the seed: movie-still JPEGs, one
metadata json per image ([x1, y1, x2, y2, score] boxes, polygon segms,
object names, width, height) and ``train.jsonl`` of questions whose
[obj, ...] references tag the image's objects, each with four answer
and four rationale choices.

Parameters (the traffic file's ``data``): ``images``, ``questions``,
``width`` [lo, hi] and ``aspect`` [lo, hi] (landscape, width / height),
``boxes`` [lo, hi] detections an image, ``question_words``,
``answer_words``, ``rationale_words`` and ``tags`` [lo, hi] of each
sentence, ``vocab_size``, ``jpeg_quality``, and ``texture``: the
pictures' content, crops of a bank of ``bank`` random fields of
``size`` x ``size`` pixels whose amplitude spectrum falls as
1 / f ** ``alpha`` (the power law of natural images), scaled by a
``contrast`` [lo, hi] drawn per picture, so that a picture costs the
bytes and the decode of a photograph.
"""

from __future__ import annotations

import io
import json
import os

import numpy as np

from portbench.generators import common

# names the dataset's category table holds (its class ids must resolve)
OBJECTS = ("person", "dog", "car", "chair", "cup", "bottle", "horse",
           "umbrella", "tie", "bench", "book", "clock", "laptop", "tv",
           "bicycle", "bus", "cat", "bed", "couch", "sink")
# the dataset's gender-neutral person names
NAMES = ("Casey", "Riley", "Jessie", "Jackie", "Avery", "Jaime", "Peyton",
         "Kerry", "Jody", "Kendall", "Frankie", "Pat", "Quinn")
PERSON_SHARE = 0.4


def texture_bank(r, t):
    """``t["bank"]`` fields of ``t["size"]`` squared pixels and 3 channels,
    each channel of unit deviation, with a 1 / f ** ``t["alpha"]``
    amplitude spectrum; the channels share most of their phase, so colour
    follows brightness as in a photograph."""
    size = int(t["size"])
    fy = np.fft.fftfreq(size)[:, None]
    fx = np.fft.rfftfreq(size)[None, :]
    f = np.sqrt(fx * fx + fy * fy)
    f[0, 0] = 1.0
    amp = f ** -float(t["alpha"])
    amp[0, 0] = 0.0
    bank = []
    for _ in range(int(t["bank"])):
        phase = r.uniform(0, 2 * np.pi, (3,) + amp.shape)
        phase[1:] = phase[0] + 0.35 * (phase[1:] - phase[0])
        x = np.fft.irfft2(amp * np.exp(1j * phase), s=(size, size))
        x /= x.std(axis=(1, 2), keepdims=True)
        bank.append(np.ascontiguousarray(
            x.astype(np.float32).transpose(1, 2, 0)))
    return bank


def picture(r, bank, w, h, t):
    """A w x h crop of one field of the bank around a drawn mean colour,
    at a drawn contrast, as uint8 RGB."""
    field = bank[int(r.integers(len(bank)))]
    size = field.shape[0]
    if w > size or h > size:
        raise ValueError(f"a {w} x {h} picture needs a texture size of "
                         f"{max(w, h)} or more, not {size}")
    y0 = int(r.integers(0, size - h + 1))
    x0 = int(r.integers(0, size - w + 1))
    mean = r.uniform(70, 170, 3).astype(np.float32)
    contrast = np.float32(r.uniform(*t["contrast"]))
    px = field[y0:y0 + h, x0:x0 + w] * contrast
    px += mean
    return np.clip(px, 0, 255, out=px).astype(np.uint8)


def jpeg(px, quality):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(px).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def _detections(r, w, h, n):
    x1 = r.uniform(0, w * 0.8, n)
    y1 = r.uniform(0, h * 0.8, n)
    x2 = np.minimum(x1 + r.uniform(16, w * 0.5, n), w - 1)
    y2 = np.minimum(y1 + r.uniform(16, h * 0.5, n), h - 1)
    boxes, segms = [], []
    for b in zip(x1, y1, x2, y2):
        boxes.append([float(v) for v in b] + [float(r.uniform(0.5, 1.0))])
        polys = []
        for _ in range(int(r.integers(1, 3))):
            k = int(r.integers(3, 9))
            polys.append(np.stack([r.uniform(b[0], b[2], k),
                                   r.uniform(b[1], b[3], k)], 1)
                         .round(1).tolist())
        segms.append(polys)
    names = [("person" if r.random() < PERSON_SHARE
              else str(r.choice(OBJECTS[1:]))) for _ in range(n)]
    return boxes, segms, names


def _mixed(r, d, n_obj, span):
    """A sentence of plain words with ``d["tags"]`` object references."""
    toks = common.sentence_words(r, d["vocab_size"] - 200, *span)
    for _ in range(int(r.integers(d["tags"][0], d["tags"][1] + 1))):
        refs = sorted({int(o) for o in r.integers(0, n_obj,
                                                  int(r.integers(1, 3)))})
        toks.insert(int(r.integers(0, len(toks) + 1)), refs)
    return toks + ["?"]


def write(root, d, seed):
    """Writes the split under ``root``; returns the configuration's data
    keys and the split's facts."""
    data = os.path.join(root, "vcr")
    os.makedirs(os.path.join(data, "img"), exist_ok=True)
    common.write_vocab(os.path.join(root, "bert", "vocab.txt"),
                       d["vocab_size"], OBJECTS + NAMES)
    r = common.rng(seed, 0)
    bank = texture_bank(r, d["texture"])
    objects = []
    for i in range(d["images"]):
        w = int(r.integers(d["width"][0], d["width"][1] + 1))
        h = int(round(w / r.uniform(*d["aspect"])))
        n = int(r.integers(d["boxes"][0], d["boxes"][1] + 1))
        boxes, segms, names = _detections(r, w, h, n)
        objects.append(names)
        with open(os.path.join(data, "img", f"{i}.jpg"), "wb") as f:
            f.write(jpeg(picture(r, bank, w, h, d["texture"]),
                         d["jpeg_quality"]))
        with open(os.path.join(data, f"{i}.json"), "w") as f:
            json.dump({"boxes": boxes, "segms": segms, "names": names,
                       "width": w, "height": h}, f)
    rows = []
    for k in range(d["questions"]):
        i = int(r.integers(0, d["images"]))
        n_obj = len(objects[i])
        rows.append(json.dumps({
            "annot_id": f"train-{k}", "img_fn": f"img/{i}.jpg",
            "metadata_fn": f"{i}.json", "objects": objects[i],
            "question": _mixed(r, d, n_obj, d["question_words"]),
            "answer_choices": [_mixed(r, d, n_obj, d["answer_words"])
                               for _ in range(4)],
            "rationale_choices": [_mixed(r, d, n_obj, d["rationale_words"])
                                  for _ in range(4)],
            "answer_label": int(r.integers(0, 4)),
            "rationale_label": int(r.integers(0, 4))}))
    with open(os.path.join(data, "train.jsonl"), "w") as f:
        f.write("\n".join(rows) + "\n")
    keys = {"DATASET.DATASET_PATH": data, "DATASET.ROOT_PATH": root,
            "DATASET.TRAIN_ANNOTATION_FILE": "train.jsonl",
            "NETWORK.BERT_MODEL_NAME": os.path.join(root, "bert")}
    return keys, {"samples": d["questions"]}
