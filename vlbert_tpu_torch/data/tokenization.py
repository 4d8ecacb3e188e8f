"""BERT WordPiece tokenizer — pure-Python, host-side.

Matches the reference's vendored tokenizer
(ref: external/pytorch_pretrained_bert/tokenization.py — BasicTokenizer :157,
WordpieceTokenizer :274, BertTokenizer :74, vocab loader :50): text cleaning,
CJK-character spacing, lowercase + accent stripping, punctuation splitting,
greedy longest-match WordPiece with '##' continuation and 100-char word cap.
Parity is tested against transformers' BertTokenizer in
tests/test_tokenization.py.

Port copy of ``vlbert_tpu/data/tokenization.py``, with its C fast path
for ASCII text (``native=True``): ``data/native_tokenizer.py`` over the
port's own build of csrc/host/wordpiece.cc (``data/native_build.py``).
Non-ASCII text and a non-default ``never_split`` take the Python path, as
does every text when the library cannot be built; both give the same
tokens. ``tests/test_torch_host_copies.py`` and
``tests/test_torch_host_natives.py`` hold it to the original.
"""

from __future__ import annotations

import collections
import unicodedata


def load_vocab(vocab_file):
    """id = line number (ref tokenization.py:50-61)."""
    vocab = collections.OrderedDict()
    with open(vocab_file, encoding="utf-8") as f:
        for idx, line in enumerate(f):
            token = line.strip()   # ref :59 strips ALL whitespace (CRLF too)
            vocab[token] = idx
    return vocab


def _is_whitespace(ch):
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch):
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch):
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_chinese_char(cp):
    return ((0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF)
            or (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F)
            or (0x2B740 <= cp <= 0x2B81F) or (0x2B820 <= cp <= 0x2CEAF)
            or (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F))


class BasicTokenizer:
    """ref tokenization.py:157-271."""

    def __init__(self, do_lower_case=True,
                 never_split=("[UNK]", "[SEP]", "[PAD]", "[CLS]", "[MASK]")):
        self.do_lower_case = do_lower_case
        self.never_split = set(never_split)

    def tokenize(self, text):
        text = self._clean_text(text)
        text = self._tokenize_chinese_chars(text)
        tokens = text.strip().split() if text.strip() else []
        out = []
        for tok in tokens:
            if tok in self.never_split:
                out.append(tok)
                continue
            if self.do_lower_case:
                tok = tok.lower()
                tok = self._strip_accents(tok)
            out.extend(self._split_punc(tok))
        return " ".join(out).strip().split() if out else []

    def _clean_text(self, text):
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    def _tokenize_chinese_chars(self, text):
        out = []
        for ch in text:
            if _is_chinese_char(ord(ch)):
                out.append(f" {ch} ")
            else:
                out.append(ch)
        return "".join(out)

    @staticmethod
    def _strip_accents(text):
        text = unicodedata.normalize("NFD", text)
        return "".join(ch for ch in text
                       if unicodedata.category(ch) != "Mn")

    @staticmethod
    def _split_punc(text):
        out = []
        word = []
        for ch in text:
            if _is_punctuation(ch):
                if word:
                    out.append("".join(word))
                    word = []
                out.append(ch)
            else:
                word.append(ch)
        if word:
            out.append("".join(word))
        return out


class WordpieceTokenizer:
    """Greedy longest-match-first (ref tokenization.py:274-330)."""

    def __init__(self, vocab, unk_token="[UNK]", max_input_chars_per_word=100):
        self.vocab = vocab
        self.unk_token = unk_token
        self.max_input_chars_per_word = max_input_chars_per_word
        self._cache = {}  # word -> subtokens memo (word vocab is small)

    def tokenize(self, text):
        out = []
        for token in text.strip().split():
            hit = self._cache.get(token)
            if hit is not None:
                out.extend(hit)
                continue
            sub = self._tokenize_word(token)
            if len(self._cache) < 200000:
                self._cache[token] = sub
            out.extend(sub)
        return out

    def _tokenize_word(self, token):
        out = []
        for token in (token,):
            chars = list(token)
            if len(chars) > self.max_input_chars_per_word:
                out.append(self.unk_token)
                continue
            is_bad = False
            start = 0
            sub_tokens = []
            while start < len(chars):
                end = len(chars)
                cur = None
                while start < end:
                    substr = "".join(chars[start:end])
                    if start > 0:
                        substr = "##" + substr
                    if substr in self.vocab:
                        cur = substr
                        break
                    end -= 1
                if cur is None:
                    is_bad = True
                    break
                sub_tokens.append(cur)
                start = end
            out.extend([self.unk_token] if is_bad else sub_tokens)
        return out


class BertTokenizer:
    """ref tokenization.py:74-154."""

    def __init__(self, vocab_file, do_lower_case=True, do_basic_tokenize=True,
                 never_split=("[UNK]", "[SEP]", "[PAD]", "[CLS]", "[MASK]"),
                 native=True):
        self.vocab = load_vocab(vocab_file)
        self.ids_to_tokens = {v: k for k, v in self.vocab.items()}
        self.do_basic_tokenize = do_basic_tokenize
        if do_basic_tokenize:
            self.basic_tokenizer = BasicTokenizer(do_lower_case, never_split)
        self.wordpiece_tokenizer = WordpieceTokenizer(self.vocab)
        # ASCII fast path: basic+wordpiece fused in C (csrc/host/
        # wordpiece.cc), token-for-token identical for pure-ASCII text;
        # non-ASCII texts (and non-default never_split) take the Python
        # path below
        self._native = None
        if (native and do_basic_tokenize
                and tuple(never_split) == ("[UNK]", "[SEP]", "[PAD]",
                                           "[CLS]", "[MASK]")):
            try:
                from vlbert_tpu_torch.data.native_tokenizer import (
                    NativeBertTokenizer)

                self._native = NativeBertTokenizer(self.vocab, do_lower_case)
            except Exception:   # no toolchain / read-only tree: Python path
                self._native = None
        # text-level memo: datasets re-tokenize the same words/short phrases
        # constantly (VCR per-word alignment); a dict hit beats BOTH paths
        # (the ctypes call included). Bounded; long texts aren't cached.
        self._text_cache = {}

    def tokenize(self, text):
        if self.do_basic_tokenize:
            hit = self._text_cache.get(text)
            if hit is not None:
                return list(hit)
            if self._native is not None:
                ids = self._native.tokenize_ids(text)
                if ids is not None:
                    i2t = self.ids_to_tokens
                    toks = [i2t[i] for i in ids]
                else:
                    toks = self._py_tokenize(text)
            else:
                toks = self._py_tokenize(text)
            if len(text) < 256 and len(self._text_cache) < 200000:
                self._text_cache[text] = tuple(toks)
            return toks
        return self.wordpiece_tokenizer.tokenize(text)

    def _py_tokenize(self, text):
        toks = []
        for t in self.basic_tokenizer.tokenize(text):
            toks.extend(self.wordpiece_tokenizer.tokenize(t))
        return toks

    def convert_tokens_to_ids(self, tokens):
        return [self.vocab.get(t, self.vocab.get("[UNK]", 0)) for t in tokens]

    def convert_ids_to_tokens(self, ids):
        return [self.ids_to_tokens[i] for i in ids]

    @property
    def cls_id(self):
        return self.vocab["[CLS]"]

    @property
    def sep_id(self):
        return self.vocab["[SEP]"]

    @property
    def mask_id(self):
        return self.vocab["[MASK]"]

    @classmethod
    def from_pretrained(cls, name_or_path, **kw):
        """Load from a vocab.txt path or a directory containing one.

        (The reference's HTTP model-name resolution is replaced by local
        paths; pass the path to a vocab file or its directory.)
        """
        import os

        if os.path.isdir(name_or_path):
            name_or_path = os.path.join(name_or_path, "vocab.txt")
        return cls(name_or_path, **kw)
