"""Static-shape batch collation + host-side text assembly.

ref: pretrain/data/collate_batch.py:5-72 and vcr/data/collate_batch.py:14-147
(dynamic pad-to-batch-max), common/utils/clip_pad.py. TPU-native: pad to
FIXED bucket sizes from cfg.TPU (MAX_TEXT_LEN / MAX_BOXES / IMAGE_SIZE) so
every batch compiles once. Pad values preserved: image 0, boxes -2 (validity
sentinel boxes[...,0] > -1.5), text 0, mlm labels -1.

Text assembly (the reference does it on-device per forward —
vcr/modules/resnet_vlbert_for_vcr.py:135-224,
vqa/modules/resnet_vlbert_for_vqa.py:141-167,
refcoco/modules/resnet_vlbert_for_refcoco.py:100-108) is pure data movement,
so it lives here on the host.

Port copy of ``vlbert_tpu/data/collate.py``, unchanged but for its imports
and one repair: ``stack_batch`` pads a batch whose images differ in shape
(FixPadding gives landscape and portrait images transposed canvases) to
their common largest canvas, as the reference pads every batch to its
largest image; the original cannot stack such a batch, which VCR training
(shuffled, with no aspect grouping) produces. The port imports nothing of
the JAX package. ``tests/test_torch_host_copies.py`` holds it to the
original on every batch the original can stack.
"""

from __future__ import annotations

import numpy as np


class PicklableCollate:
    """Picklable wrapper over a closure-returning collate factory.

    The ``make_*_collate`` factories close over their arguments, which
    blocks pickling — and pickling is what lets the worker pool use the
    ``forkserver`` start method (workers exec'd fresh instead of forking a
    JAX-threaded parent; see data/loader.py). Pickles as
    (factory, args, kwargs) and rebuilds the closure on load.
    """

    def __init__(self, factory, *args, **kwargs):
        self._spec = (factory, args, kwargs)
        self._fn = factory(*args, **kwargs)

    def __call__(self, samples):
        return self._fn(samples)

    def __getstate__(self):
        return self._spec

    def __setstate__(self, spec):
        self._spec = spec
        factory, args, kwargs = spec
        self._fn = factory(*args, **kwargs)


def pad_to(arr, shape, pad_value=0, dtype=None):
    """Pad/clip ``arr`` into a fixed-shape buffer."""
    arr = np.asarray(arr)
    out = np.full(shape, pad_value, dtype or arr.dtype)
    sl = tuple(slice(0, min(a, s)) for a, s in zip(arr.shape, shape))
    out[sl] = arr[sl]
    return out


def assemble_qa_text(q_ids, q_tags, a_ids, a_tags, max_len, cls_id, sep_id,
                     answer_first=False, one_sent=False):
    """[CLS] Q [SEP] A [SEP] (or AQ / one-sent variants) for ONE example.

    ref: prepare_text_from_qa / _onesent / _from_aq
    (vcr/modules/resnet_vlbert_for_vcr.py:135-224). Returns fixed-length
    (input_ids, type_ids, tags, mask, ans_pos) where ans_pos = index of the
    last [SEP] (used by VQA's [MASK]-position head, vqa module :167).
    """
    q_ids, a_ids = list(q_ids), list(a_ids)
    q_tags, a_tags = list(q_tags), list(a_tags)
    # Truncate CONTENT, never structure: an overlong question must not clip
    # the [SEP]/answer tail (VQA's [MASK] slot lives there — ans_pos would
    # otherwise point at a question token and the answer head would gather
    # garbage). Longest side shrinks first, like the reference's joint
    # policy (ref vcr/data/datasets/vcr.py:321-343).
    n_special = 2 if one_sent else 3
    while len(q_ids) + len(a_ids) + n_special > max_len:
        if not q_ids and not a_ids:
            break
        if len(q_ids) >= len(a_ids) and q_ids:
            q_ids.pop(); q_tags.pop()
        else:
            a_ids.pop(); a_tags.pop()
    ids = np.zeros(max_len, np.int32)
    types = np.zeros(max_len, np.int32)
    tags = np.zeros(max_len, np.int32)
    mask = np.zeros(max_len, bool)

    if answer_first:
        seq = ([cls_id] + a_ids + [sep_id] + q_ids + [sep_id])
        tgs = [0] + a_tags + [0] + q_tags + [0]
        tps = [0] * (len(a_ids) + 2) + [1] * (len(q_ids) + 1)
    elif one_sent:
        seq = [cls_id] + q_ids + a_ids + [sep_id]
        tgs = [0] + q_tags + a_tags + [0]
        tps = [0] * len(seq)
    else:
        seq = [cls_id] + q_ids + [sep_id] + a_ids + [sep_id]
        tgs = [0] + q_tags + [0] + a_tags + [0]
        tps = [0] * (len(q_ids) + 2) + [1] * (len(a_ids) + 1)

    n = min(len(seq), max_len)
    ids[:n] = seq[:n]
    types[:n] = tps[:n]
    tags[:n] = tgs[:n]
    mask[:n] = True
    ans_pos = n - 1
    return ids, types, tags, mask, ans_pos


def assemble_expression_text(expr_ids, max_len, cls_id, sep_id):
    """[CLS] expr [SEP] (ref refcoco module :100-108)."""
    ids = np.zeros(max_len, np.int32)
    mask = np.zeros(max_len, bool)
    seq = [cls_id] + list(expr_ids) + [sep_id]
    n = min(len(seq), max_len)
    ids[:n] = seq[:n]
    mask[:n] = True
    return ids, mask


def _stack(arrays):
    """np.stack; arrays of one rank but different shapes (the canvases of
    landscape and portrait images) are first zero-padded at their ends to
    the largest extent of each axis (the padding FixPadding uses; im_info
    keeps each image's valid region)."""
    shape = np.max([a.shape for a in arrays], axis=0)
    if all(a.shape == tuple(shape) for a in arrays):
        return np.stack(arrays)
    out = np.zeros((len(arrays), *shape), arrays[0].dtype)
    for i, a in enumerate(arrays):
        out[(i, *map(slice, a.shape))] = a
    return out


def stack_batch(samples):
    """Stack a list of per-example dicts of fixed-shape arrays; images of
    different canvases are padded to the largest (``_stack``)."""
    keys = samples[0].keys()
    return {k: (_stack([s[k] for s in samples])
                if samples[0][k] is not None else None) for k in keys}
