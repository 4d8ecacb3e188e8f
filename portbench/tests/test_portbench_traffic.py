"""Each traffic mix's generator is deterministic in the seed and writes
the stated shapes in its dataset's on-disk form."""

import hashlib
import json
import os

import numpy as np
import pytest

from portbench import harness

SMALL = {"q2a_pixels_b16": {"images": 6, "questions": 40}}
# bits a pixel at quality 90 of three photographs coded again at that
# quality (640 x 427 and 512 x 600): 1.42, 2.24 and 2.92
PHOTO_BITS_PER_PIXEL = (1.42, 2.92)


def _digest(root):
    h = hashlib.sha256()
    for dirpath, _, files in sorted(os.walk(root)):
        for f in sorted(files):
            p = os.path.join(dirpath, f)
            h.update(os.path.relpath(p, root).encode())
            with open(p, "rb") as fh:
                h.update(fh.read())
    return h.hexdigest()


def _write(mix, root, seed):
    spec = json.loads((harness.BENCH_DIR / "traffic" / f"{mix}.json")
                      .read_text())
    spec["data"].update(SMALL[mix])
    gen = harness.load(spec["generator"])
    keys, facts = gen.write(str(root), spec["data"], seed)
    return spec["data"], keys, facts


@pytest.mark.parametrize("mix", sorted(SMALL))
def test_deterministic_in_the_seed(mix, tmp_path):
    seed = 2 ** 31 + 12345
    _write(mix, tmp_path / "a", seed)
    _write(mix, tmp_path / "b", seed)
    _write(mix, tmp_path / "c", seed + 1)
    assert _digest(tmp_path / "a") == _digest(tmp_path / "b")
    assert _digest(tmp_path / "a") != _digest(tmp_path / "c")


def test_vcr_shapes(tmp_path):
    from PIL import Image

    d, keys, facts = _write("q2a_pixels_b16", tmp_path, 7)
    data = keys["DATASET.DATASET_PATH"]
    rows = [json.loads(x) for x in open(os.path.join(data, "train.jsonl"))]
    assert len(rows) == facts["samples"] == d["questions"]
    for i in range(d["images"]):
        meta = json.load(open(os.path.join(data, f"{i}.json")))
        w, h = Image.open(os.path.join(data, "img", f"{i}.jpg")).size
        assert (w, h) == (meta["width"], meta["height"])
        assert d["width"][0] <= w <= d["width"][1]
        assert d["aspect"][0] - 0.01 <= w / h <= d["aspect"][1] + 0.01
        assert d["boxes"][0] <= len(meta["boxes"]) <= d["boxes"][1]
        assert len(meta["segms"]) == len(meta["names"]) == len(meta["boxes"])
    for r in rows:
        n_obj = len(r["objects"])
        q_words = [t for t in r["question"] if isinstance(t, str)][:-1]
        assert d["question_words"][0] <= len(q_words) <= \
            d["question_words"][1]
        assert len(r["answer_choices"]) == len(r["rationale_choices"]) == 4
        refs = [o for t in r["question"] if isinstance(t, list) for o in t]
        assert all(0 <= o < n_obj for o in refs)
    vocab = open(os.path.join(keys["NETWORK.BERT_MODEL_NAME"],
                              "vocab.txt")).read().split("\n")
    assert len([v for v in vocab if v]) == d["vocab_size"]


def test_vcr_pictures_cost_the_bytes_of_photographs(tmp_path):
    """The pictures are no flat fields: at the mix's JPEG quality their
    bits a pixel lie in the photographs' range, on the whole and each
    within a margin of it."""
    d, keys, _ = _write("q2a_pixels_b16", tmp_path, 2 ** 31 + 99)
    data = keys["DATASET.DATASET_PATH"]
    bits = []
    for i in range(d["images"]):
        meta = json.load(open(os.path.join(data, f"{i}.json")))
        size = os.path.getsize(os.path.join(data, "img", f"{i}.jpg"))
        bits.append(size * 8 / (meta["width"] * meta["height"]))
    lo, hi = PHOTO_BITS_PER_PIXEL
    assert lo <= float(np.mean(bits)) <= hi, bits
    assert lo * 0.8 <= min(bits) and max(bits) <= hi * 1.2, bits
