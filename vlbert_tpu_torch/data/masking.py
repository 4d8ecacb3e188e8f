"""MLM whole-word masking + MVRC region masking (host-side, numpy RNG).

ref: pretrain/data/datasets/conceptual_captions.py:274-349.

Port copy of ``vlbert_tpu/data/masking.py``, unchanged but for its
imports: the port imports nothing of the JAX package.
``tests/test_torch_host_copies.py`` holds it to the original.
"""

from __future__ import annotations

import numpy as np


def random_word_wwm(tokens, tokenizer, rng):
    """Whole-word masking over basic tokens (ref :274-317).

    tokens: list of basic (whole-word) tokens.
    Returns (sub_tokens, labels) at the sub-token level: for each selected
    word (p=0.15), all sub-tokens are 80% [MASK] / 10% random vocab token /
    10% kept, labels = original sub-token ids; unselected -> label -1.
    """
    # cached on the tokenizer: rebuilding a ~30k-entry list per sample is
    # pure hot-path waste (random replacement draws need it ~1.5% of words)
    vocab_keys = getattr(tokenizer, "_vocab_keys_cache", None)
    if vocab_keys is None or len(vocab_keys) != len(tokenizer.vocab):
        vocab_keys = tuple(tokenizer.vocab.keys())
        try:
            tokenizer._vocab_keys_cache = vocab_keys
        except AttributeError:
            pass
    out_tokens, out_labels = [], []
    for token in tokens:
        sub_tokens = tokenizer.wordpiece_tokenizer.tokenize(token)
        prob = rng.random()
        if prob < 0.15:
            prob /= 0.15
            if prob < 0.8:
                out_tokens.extend(["[MASK]"] * len(sub_tokens))
            elif prob < 0.9:
                out_tokens.extend(
                    vocab_keys[int(rng.integers(len(vocab_keys)))]
                    for _ in sub_tokens)
            else:
                out_tokens.extend(sub_tokens)
            for st in sub_tokens:
                out_labels.append(tokenizer.vocab.get(st, tokenizer.vocab["[UNK]"]))
        else:
            out_tokens.extend(sub_tokens)
            out_labels.extend([-1] * len(sub_tokens))
    return out_tokens, out_labels


def random_mask_region(region_cls_scores, rng):
    """MVRC masking (ref :319-349): with p=0.15 select a region; selected
    regions are 90% masked (op=1) / 10% kept (op=0), label = its class-score
    row either way; unselected -> zero label row (ignored by soft CE)."""
    ops, labels = [], []
    for cls_scores in region_cls_scores:
        prob = rng.random()
        if prob < 0.15:
            prob /= 0.15
            ops.append(1 if prob < 0.9 else 0)
            labels.append(np.asarray(cls_scores, np.float32))
        else:
            ops.append(0)
            labels.append(np.zeros_like(cls_scores, np.float32))
    return ops, labels


def truncate_seq_and_boxes(text, mlm_labels, boxes, mvrc_ops, mvrc_labels,
                           seq_len):
    """Joint text+box truncation (ref :215-232): shrink the longer side until
    text+boxes fits; keep >=2 text tokens and >=1 box; the LAST text token
    ([SEP]-like) is preserved."""
    text_keep, box_keep = len(text), len(boxes)
    if text_keep + box_keep <= seq_len:
        return text, mlm_labels, boxes, mvrc_ops, mvrc_labels
    while (text_keep + box_keep) > seq_len and text_keep > 0 and box_keep > 0:
        if box_keep > text_keep:
            box_keep -= 1
        else:
            text_keep -= 1
    text_keep = max(text_keep, 2)
    box_keep = max(box_keep, 1)
    return (text[: text_keep - 1] + [text[-1]],
            mlm_labels[: text_keep - 1] + [mlm_labels[-1]],
            boxes[:box_keep], mvrc_ops[:box_keep], mvrc_labels[:box_keep])
