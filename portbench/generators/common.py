"""What the data generators share: the BERT vocabulary file and the
seeded random source."""

from __future__ import annotations

import os

import numpy as np

# bert-base-uncased's special ids: [PAD] 0, [unused*] 1-99, [UNK] 100,
# [CLS] 101, [SEP] 102, [MASK] 103
SPECIAL = (["[PAD]"] + [f"[unused{i}]" for i in range(99)]
           + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"])


def rng(seed, stream):
    """The generator of one stream of the run's data, from ``seed``."""
    return np.random.default_rng([int(seed), stream])


def words(n):
    """The plain words of the synthetic vocabulary, which the BERT
    tokenizer keeps whole."""
    return [f"w{i}" for i in range(n)]


def write_vocab(path, size, named=()):
    """A ``vocab.txt`` of ``size`` entries: the special tokens, the words
    of ``named`` (object and person names), then ``words``."""
    vocab = SPECIAL + ["and", "?", "."] + [w.lower() for w in named]
    vocab += words(size - len(vocab))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(vocab) + "\n")
    return len(vocab)


def sentence_words(r, vocab_words, lo, hi):
    """lo..hi words drawn from the vocabulary's plain words, skewed to the
    frequent ones (a Zipf-like draw)."""
    n = int(r.integers(lo, hi + 1))
    idx = np.minimum((r.pareto(1.1, n) * 50).astype(np.int64),
                     vocab_words - 1)
    return [f"w{i}" for i in idx]
