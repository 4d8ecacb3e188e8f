"""ctypes bindings for the native ASCII-fast-path BERT tokenizer (port
copy of vlbert_tpu/data/native_tokenizer.py, unchanged but for the
library it loads: the port's own build of csrc/host/wordpiece.cc,
``native_build.load_native_lib("wordpiece")``).

csrc/host/wordpiece.cc fuses the basic tokenizer (clean / lowercase /
punctuation split — per-character unicodedata work in Python, the
dominant cost of text-heavy ``__getitem__``) with greedy WordPiece into
one C call per text. Pure-ASCII texts only; the caller
(data/tokenization.py BertTokenizer) routes everything else to the
reference-parity Python path, so unicode semantics live in exactly one
place. Token-for-token parity is asserted in the data-pipeline fuzz test
and by the existing HF parity suite (which runs through this path when
the library is built).
"""

from __future__ import annotations

import ctypes
import threading

from vlbert_tpu_torch.data.native_build import load_native_lib

_NOT_ASCII = -1000000000


def _bind(lib):
    lib.wp_new.restype = ctypes.c_void_p
    lib.wp_new.argtypes = [ctypes.c_char_p, ctypes.c_int,
                           ctypes.c_char_p, ctypes.c_int]
    lib.wp_tokenize.restype = ctypes.c_int
    lib.wp_tokenize.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.POINTER(ctypes.c_int32),
                                ctypes.c_int]
    lib.wp_free.argtypes = [ctypes.c_void_p]
    return lib


class NativeBertTokenizer:
    """One handle per (vocab, do_lower_case); thread-, fork- and
    pickle-safe.

    Buffers are thread-local (ctypes releases the GIL around the C call,
    so loader worker threads must not share an output buffer). Pickling
    drops the C handle and rebuilds it on unpickle — loader worker pools
    (forkserver) ship collates holding the tokenizer by pickle.
    """

    def __init__(self, vocab, do_lower_case, unk_token="[UNK]",
                 max_chars=100):
        if unk_token not in vocab:
            # the Python path emits the literal unk STRING for unmatched
            # words even when it's not in the vocab; ids can't express that
            raise RuntimeError(f"{unk_token!r} not in vocab; native path "
                               "cannot mirror the Python fallback")
        # explicit token->id pairs: a vocab file with duplicate lines gives
        # last-wins ids WITH GAPS in Python's load_vocab; a bare line blob
        # cannot reproduce that. Tokens containing tab/newline can't be
        # round-tripped (and can never match whitespace-split input) — skip.
        self._blob = "\n".join(
            f"{tok}\t{tid}" for tok, tid in vocab.items()
            if "\t" not in tok and "\n" not in tok)
        self._lower = bool(do_lower_case)
        self._unk = unk_token
        self._max_chars = max_chars
        self._init_handle()

    def _init_handle(self):
        lib = load_native_lib("wordpiece")
        if lib is None:
            raise RuntimeError("libwordpiece unavailable")
        self._lib = _bind(lib)
        self._h = self._lib.wp_new(self._blob.encode("utf-8"),
                                   int(self._lower),
                                   self._unk.encode("utf-8"),
                                   self._max_chars)
        if not self._h:
            raise RuntimeError("wp_new rejected the vocab (unk missing)")
        self._tls = threading.local()

    def __getstate__(self):
        return {"blob": self._blob, "lower": self._lower,
                "unk": self._unk, "max_chars": self._max_chars}

    def __setstate__(self, st):
        self._blob = st["blob"]
        self._lower = st["lower"]
        self._unk = st["unk"]
        self._max_chars = st["max_chars"]
        self._init_handle()

    def tokenize_ids(self, text):
        """Token ids for a pure-ASCII text, or None when the text must take
        the Python path (non-ASCII or embedded NUL)."""
        if "\x00" in text:
            return None
        try:
            b = text.encode("ascii")
        except UnicodeEncodeError:
            return None
        buf = getattr(self._tls, "buf", None)
        if buf is None:
            buf = self._tls.buf = (ctypes.c_int32 * 512)()
        n = self._lib.wp_tokenize(self._h, b, buf, len(buf))
        if n == _NOT_ASCII:
            return None
        if n < 0:
            buf = self._tls.buf = (ctypes.c_int32 * (-n))()
            n = self._lib.wp_tokenize(self._h, b, buf, len(buf))
        return buf[:n]

    def __del__(self):
        try:
            self._lib.wp_free(self._h)
        except Exception:
            pass
