"""The port's last host modules against the JAX package's, on the CPU:
the native tokenizer (``data/native_tokenizer.py`` over the port's own
g++ build of ``csrc/host/wordpiece.cc``), the COCO RLE codec
(``data/coco_mask.py`` over ``csrc/host/maskapi.cc``, and its numpy path)
and ``ops/roi_pool.py``. Each is a copy held to its original, exact."""

import ctypes
import os
import pickle
import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import vlbert_tpu.data.coco_mask as j_mask
import vlbert_tpu.data.tokenization as j_tok
import vlbert_tpu_torch.data.coco_mask as t_mask
import vlbert_tpu_torch.data.tokenization as t_tok
from tests.test_torch_host_copies import TEXTS, WORDPIECE_VOCAB
from vlbert_tpu_torch.data import native_build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the words hypothesis texts are made of: whole vocab entries, pieces and
# words that are not in it, with ASCII punctuation and whitespace between
WORDS = ["what", "is", "the", "cat", "doing", "red", "blue", "dog",
         "unaffable", "unaff", "able", "hello", "world", "a", "s", "xyz",
         "UnAffable", "DOG", "[MASK]", "[UNK]", "qq" * 60]
SEPS = [" ", "  ", "\t", "\n", ",", "!", "?", "'", "'s", ".", "-", "\x07",
        "\r\n", "[", "]"]


@pytest.fixture(scope="module")
def vocab_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("wp")
    (d / "vocab.txt").write_text("\n".join(WORDPIECE_VOCAB) + "\n")
    return str(d)


@pytest.fixture(scope="module")
def tokenizers(vocab_dir):
    return _tokenizers(vocab_dir)


def _tokenizers(vocab_dir, lower=True):
    tt = t_tok.BertTokenizer.from_pretrained(vocab_dir, do_lower_case=lower)
    jt = j_tok.BertTokenizer.from_pretrained(vocab_dir, do_lower_case=lower)
    py = t_tok.BertTokenizer.from_pretrained(vocab_dir, do_lower_case=lower,
                                             native=False)
    return tt, jt, py


def test_the_libraries_are_built_from_the_port_sources(vocab_dir):
    """g++ builds both host libraries into the port's _build/ under the
    digest of their source; the JAX package's native/*.so is not what is
    loaded."""
    for name in ("wordpiece", "maskapi"):
        lib = native_build.load_native_lib(name)
        assert isinstance(lib, ctypes.CDLL), name
        path = native_build.library_path(name)
        assert path.exists() and lib._name == str(path)
        assert path.parent == native_build.BUILD_DIR
        assert re.fullmatch(rf"lib{name}-[0-9a-f]{{16}}\.so", path.name)
        assert not lib._name.startswith(os.path.join(REPO, "native"))
    tt, _, _ = _tokenizers(vocab_dir)
    assert tt._native is not None
    assert t_mask._load_lib()
    cmd = native_build.compile_command("g++", "x.cc", "y.so")
    for flag in ("-O3", "-fPIC", "-shared"):
        assert flag in cmd


@pytest.mark.parametrize("name", ["wordpiece", "maskapi"])
def test_the_host_sources_are_copies_of_the_originals(name):
    """The port's source is the JAX package's with a header of its own."""
    with open(os.path.join(REPO, "native", f"{name}.cc")) as f:
        original = f.read()
    copy = native_build.source(name).read_text()
    header, body = copy.split("//\n", 1)
    assert body == original
    assert all(line.startswith("//") for line in header.splitlines())


@pytest.mark.parametrize("lower", [True, False])
def test_native_ids_equal_jax_and_the_python_path_on_the_fixtures(
        vocab_dir, lower):
    tt, jt, py = _tokenizers(vocab_dir, lower)
    assert jt._native is not None and tt._native is not None
    for text in TEXTS + ["What is the cat doing?" * 30, "\x00 nul"]:
        toks = tt.tokenize(text)
        assert toks == jt.tokenize(text) == py.tokenize(text), text
        ids = tt._native.tokenize_ids(text)
        if ids is not None:           # ASCII: the C path gave them
            assert ids == jt._native.tokenize_ids(text), text
            assert ids == tt.convert_tokens_to_ids(toks), text
        else:
            assert not text.isascii() or "\x00" in text


@settings(max_examples=200, deadline=None, database=None)
@given(parts=st.lists(st.tuples(st.sampled_from(WORDS),
                                st.sampled_from(SEPS)), max_size=12),
       noise=st.text(alphabet=st.characters(min_codepoint=1,
                                            max_codepoint=127),
                     max_size=20))
def test_native_ids_equal_jax_and_the_python_path_on_ascii_text(
        tokenizers, parts, noise):
    text = "".join(w + s for w, s in parts) + noise
    tt, jt, py = tokenizers
    ids = tt._native.tokenize_ids(text)
    assert ids is not None and ids == jt._native.tokenize_ids(text)
    assert [tt.ids_to_tokens[i] for i in ids] == py.tokenize(text) \
        == jt.tokenize(text)


def test_the_native_tokenizer_survives_pickling(vocab_dir):
    """A loader's workers receive the tokenizer by pickle: the C handle is
    rebuilt and the ids are the same; a non-default never_split keeps
    the Python path, as in the JAX package."""
    tt, _, _ = _tokenizers(vocab_dir)
    back = pickle.loads(pickle.dumps(tt))
    assert back._native is not None and back._native._h != tt._native._h
    for text in TEXTS:
        assert back.tokenize(text) == tt.tokenize(text)
        assert back._native.tokenize_ids(text) \
            == tt._native.tokenize_ids(text)
    odd = t_tok.BertTokenizer(os.path.join(vocab_dir, "vocab.txt"),
                              never_split=("[UNK]",))
    jodd = j_tok.BertTokenizer(os.path.join(vocab_dir, "vocab.txt"),
                               never_split=("[UNK]",))
    assert odd._native is None and jodd._native is None
    assert odd.tokenize("red[MASK]blue") == jodd.tokenize("red[MASK]blue")


# ------------------------------------------------------------ COCO masks

def _masks(rng, n=12):
    out = [np.zeros((5, 7), np.uint8), np.ones((6, 4), np.uint8)]
    for _ in range(n):
        h, w = rng.integers(1, 24, 2)
        out.append((rng.uniform(size=(h, w)) > rng.uniform(0.2, 0.8))
                   .astype(np.uint8))
    return out


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_coco_mask_equals_jax(path, monkeypatch):
    if path == "numpy":
        monkeypatch.setattr(t_mask, "_LIB", False)
        monkeypatch.setattr(j_mask, "_LIB", False)
    else:
        assert t_mask._load_lib() and j_mask._load_lib()
    rng = np.random.default_rng(0)
    masks = _masks(rng)
    for m in masks:
        h, w = m.shape
        c = t_mask.encode(m)
        np.testing.assert_array_equal(c, j_mask.encode(m))
        assert c.dtype == np.uint32
        np.testing.assert_array_equal(t_mask.decode(c, h, w),
                                      j_mask.decode(c, h, w))
        np.testing.assert_array_equal(t_mask.decode(c, h, w), m)
        np.testing.assert_array_equal(t_mask.to_bbox(c, h, w),
                                      j_mask.to_bbox(c, h, w))
        assert t_mask.area(c) == j_mask.area(c) == int(m.sum())
    for a, b in zip(masks[2:], masks[3:]):
        b = np.resize(b, a.shape)
        ca, cb = t_mask.encode(a), t_mask.encode(b)
        assert t_mask.iou(ca, cb) == j_mask.iou(ca, cb)
    polys = [[(2, 2), (8, 2), (8, 8), (2, 8)],
             [(0.5, 0.5), (10.5, 3.2), (4.1, 9.9)],
             [(1, 1), (6, 6)], [(3.5, 3.5), (3.5, 3.5), (3.5, 3.5)]]
    for xy in polys + [rng.uniform(0, 12, (7, 2)).tolist()]:
        np.testing.assert_array_equal(t_mask.from_poly(xy, 12, 14),
                                      j_mask.from_poly(xy, 12, 14))
    with pytest.raises(ValueError, match="invalid RLE"):
        t_mask.decode([3, 4], 2, 2)


def test_compressed_counts_decode_as_jax():
    """COCO's compressed counts strings (annotation files), made by the
    LEB128-style encoder pycocotools uses."""
    def compress(counts):
        out = []
        for i, x in enumerate(int(c) for c in counts):
            if i > 2:
                x -= int(counts[i - 2])
            more = True
            while more:
                c = x & 0x1F
                x >>= 5
                more = not ((c & 0x10 == 0 and x == 0)
                            or (c & 0x10 and x == -1))
                if more:
                    c |= 0x20
                out.append(chr(c + 48))
        return "".join(out)

    for m in _masks(np.random.default_rng(2)):
        h, w = m.shape
        s = compress(t_mask.encode(m))
        np.testing.assert_array_equal(t_mask.decode_compressed(s, h, w),
                                      j_mask.decode_compressed(s, h, w))
        np.testing.assert_array_equal(t_mask.decode_compressed(s, h, w), m)


# --------------------------------------------------------------- ROIPool

@pytest.mark.parametrize("scale", [1.0 / 16, 0.5, 1.0])
def test_roi_pool_equals_jax(scale):
    """Random boxes, boxes whose scaled corners land on .5 (C round() is
    half away from zero), boxes past the map and degenerate ones; a
    masked box is zeros."""
    import jax.numpy as jnp

    from vlbert_tpu.ops.roi_pool import roi_pool as j_roi_pool
    from vlbert_tpu_torch.ops.roi_pool import roi_pool

    rng = np.random.default_rng(3)
    B, H, W, C, O = 2, 9, 11, 3, 7
    feats = rng.normal(size=(B, H, W, C)).astype(np.float32)
    xy = rng.uniform(0, W / scale, (B, O, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0, 6 / scale, (B, O, 2))],
                           -1).astype(np.float32)
    half = (np.asarray([0.5, 1.5, 2.5, 4.5]) / scale).astype(np.float32)
    boxes[0, 0] = half                                 # corners on .5
    boxes[0, 1] = (np.asarray([3.5, 0.5, 3.5, 0.5]) / scale)  # one cell
    boxes[1, 0] = (np.asarray([W + 2, H + 2, W + 5, H + 5]) / scale)
    boxes[1, 1] = (np.asarray([5.0, 6.0, 2.0, 1.0]) / scale)  # x2 < x1
    mask = np.ones((B, O), bool)
    mask[1, 6] = False
    for ph, pw in ((7, 7), (2, 3)):
        want = np.asarray(j_roi_pool(jnp.asarray(feats), jnp.asarray(boxes),
                                     jnp.asarray(mask), pooled_h=ph,
                                     pooled_w=pw, spatial_scale=scale))
        got = roi_pool(torch.from_numpy(feats), torch.from_numpy(boxes),
                       torch.from_numpy(mask), ph, pw, scale)
        assert got.shape == (B, O, ph, pw, C) and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
        assert not got[1, 6].any()
