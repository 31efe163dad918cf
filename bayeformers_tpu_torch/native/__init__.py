"""The native tokenizers (counterpart of ``bayeformers_tpu/native``): BERT's
WordPiece (``wordpiece.cc``), GPT-2's byte-level BPE (``bpe.cc``) and
SentencePiece Unigram (``unigram.cc``), in C++ behind a plain C interface
loaded with ``ctypes``.

Each source is compiled at its first use with

    g++ -O3 -std=c++17 -shared -fPIC -pthread <name>.cc -o _build/lib<name>_<hash>.so

into ``bayeformers_tpu_torch/_build/`` (which git ignores), the library's
name carrying a hash of the source and the flags, as ``ops/_build.py`` names
the kernels' library: a changed source rebuilds, an unchanged one loads what
is there. There is no pure-Python fallback: a missing ``g++``, a failed
build or a vocabulary the library cannot read raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent
BUILD_DIR = _SRC.parent / "_build"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_P = ctypes.c_void_p
_S = ctypes.c_char_p
_I = ctypes.c_int
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64
_PI32 = ctypes.POINTER(ctypes.c_int32)
_PI64 = ctypes.POINTER(ctypes.c_int64)
_BATCH = [_P, ctypes.POINTER(ctypes.c_char_p), _I64, _PI32, _I64, _PI64, _I32]
# each library's C entry points: (restype, argtypes)
SIGNATURES = {
    "wordpiece": {
        "wp_load": (_P, [_S, _I]),
        "wp_free": (None, [_P]),
        "wp_vocab_size": (_I32, [_P]),
        "wp_special_id": (_I32, [_P, _S]),
        "wp_encode": (_I64, [_P, _S, _PI32, _I64]),
        "wp_encode_offsets": (_I64, [_P, _S, _PI32, _PI32, _PI32, _I64]),
        "wp_encode_batch": (None, _BATCH),
    },
    "bpe": {
        "bpe_load": (_P, [_S, _S]),
        "bpe_free": (None, [_P]),
        "bpe_vocab_size": (_I32, [_P]),
        "bpe_token_id": (_I32, [_P, _S, _I64]),
        "bpe_encode": (_I64, [_P, _S, _PI32, _I64]),
        "bpe_decode": (_I64, [_P, _PI32, _I64, _S, _I64]),
        "bpe_encode_batch": (None, _BATCH),
    },
    "unigram": {
        "ug_load": (_P, [_S, _I, _I, _I]),
        "ug_free": (None, [_P]),
        "ug_vocab_size": (_I32, [_P]),
        "ug_piece_id": (_I32, [_P, _S, _I64]),
        "ug_encode": (_I64, [_P, _S, _PI32, _I64]),
        "ug_decode": (_I64, [_P, _PI32, _I64, _S, _I64]),
        "ug_encode_batch": (None, _BATCH),
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def build(name: str) -> Path:
    """Compile ``<name>.cc`` into ``_build/lib<name>_<hash>.so`` unless that
    file exists; returns its path. Raises with g++'s output on failure."""
    src = _SRC / f"{name}.cc"
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode() + src.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}_{h}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *GXX_FLAGS, str(src), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build {src.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``name`` (built on first use), with its entry
    points' types set."""
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(build(name)))
            for fn, (res, args) in SIGNATURES[name].items():
                getattr(lib, fn).restype = res
                getattr(lib, fn).argtypes = args
            _libs[name] = lib
        return _libs[name]


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_PI32)


def _grow(call, cap: int) -> np.ndarray:
    """Ids from ``call(out, cap) -> n``, rerun at the exact size when the
    first buffer was too small."""
    while True:
        out = np.empty(cap, dtype=np.int32)
        n = call(out, cap)
        if n <= cap:
            return out[:n]
        cap = int(n)


def _decode(call, ids, per_id: int) -> str:
    arr = np.ascontiguousarray(ids, dtype=np.int32)
    cap = max(64, per_id * max(1, len(arr)) + 8)
    while True:
        buf = ctypes.create_string_buffer(cap)
        n = call(arr, buf, cap)
        if n <= cap:
            return buf.raw[:n].decode("utf-8", errors="replace")
        cap = int(n)


class _Native:
    """A handle of one of the libraries: batch encoding and freeing."""

    _prefix = ""

    def __init__(self, name: str, handle, what: str):
        self._lib = library(name)
        if not handle:
            raise ValueError(f"{type(self).__name__}: the native library could not "
                             f"load {what}")
        self._handle = handle

    def _fn(self, name: str):
        return getattr(self._lib, self._prefix + name)

    def encode_batch(self, texts: list[str], capacity: int = 512, n_threads: int = 0
                     ) -> tuple[np.ndarray, np.ndarray]:
        """(ids [len(texts), capacity] int32, lengths [len(texts)] int64),
        encoded on ``n_threads`` C++ threads (0: all cores)."""
        encoded = [t.encode("utf-8") for t in texts]  # alive through the call
        arr = (ctypes.c_char_p * len(texts))(*encoded)
        ids = np.zeros((len(texts), capacity), np.int32)
        lengths = np.zeros(len(texts), np.int64)
        self._fn("encode_batch")(self._handle, arr, len(texts), _ptr(ids), capacity,
                                 lengths.ctypes.data_as(_PI64), n_threads)
        return ids, lengths

    def __del__(self):
        if getattr(self, "_handle", None):
            self._fn("free")(self._handle)
            self._handle = None


class WordPieceTokenizer(_Native):
    """BERT's tokenizer over a ``vocab.txt`` (one token a line, line order
    the id; a repeated token keeps its last line): basic tokenization
    (lower case and accents folded when ``lowercase``, punctuation split,
    CJK characters isolated), then greedy longest-match WordPiece.
    ``tokenize(text)`` gives the raw ids without special tokens, the
    callable the GLUE and SQuAD featurizers take."""

    _prefix = "wp_"

    def __init__(self, vocab_path: str, lowercase: bool = True):
        self.vocab_path = vocab_path
        self.lowercase = lowercase
        lib = library("wordpiece")
        super().__init__("wordpiece", lib.wp_load(vocab_path.encode(), int(lowercase)),
                         vocab_path)

    def special_id(self, name: str) -> int:
        """The id of ``"cls"``, ``"sep"``, ``"pad"`` or ``"unk"``."""
        return int(self._lib.wp_special_id(self._handle, name.encode()))

    @property
    def vocab_size(self) -> int:
        return int(self._lib.wp_vocab_size(self._handle))

    def tokenize(self, text: str) -> list[int]:
        data = text.encode("utf-8")
        return _grow(lambda out, cap: self._lib.wp_encode(self._handle, data, _ptr(out),
                                                          cap),
                     max(64, 2 * len(text) + 8)).tolist()

    def tokenize_with_offsets(self, text: str) -> tuple[list[int], list[tuple[int, int]]]:
        """``(ids, [(char_start, char_end)])``: each token's codepoint span
        in ``text``, subword-exact (what SQuAD's span mapping needs)."""
        data = text.encode("utf-8")
        cap = max(64, 2 * len(text) + 8)
        while True:
            ids, starts, ends = (np.empty(cap, dtype=np.int32) for _ in range(3))
            n = self._lib.wp_encode_offsets(self._handle, data, _ptr(ids), _ptr(starts),
                                            _ptr(ends), cap)
            if n <= cap:
                return (ids[:n].tolist(),
                        list(zip(starts[:n].tolist(), ends[:n].tolist())))
            cap = int(n)


class BPETokenizer(_Native):
    """GPT-2's byte-level BPE over the stock ``vocab.json`` and
    ``merges.txt``: ``encode(text)`` gives the ids (no special tokens),
    ``decode(ids)`` the lossless byte-level inverse. The pre-tokenizer is
    exact in its categories for ASCII and Unicode whitespace; other
    non-ASCII codepoints count as letters (``bpe.cc``)."""

    _prefix = "bpe_"

    def __init__(self, vocab_path: str, merges_path: str):
        self.vocab_path, self.merges_path = vocab_path, merges_path
        lib = library("bpe")
        super().__init__("bpe", lib.bpe_load(vocab_path.encode(), merges_path.encode()),
                         f"{vocab_path} and {merges_path}")

    @property
    def vocab_size(self) -> int:
        return int(self._lib.bpe_vocab_size(self._handle))

    def token_id(self, token: str) -> int:
        """The id of a literal token in raw text (``"<|endoftext|>"``), -1
        if absent."""
        raw = token.encode("utf-8")
        return int(self._lib.bpe_token_id(self._handle, raw, len(raw)))

    def encode(self, text: str) -> list[int]:
        data = text.encode("utf-8")
        return _grow(lambda out, cap: self._lib.bpe_encode(self._handle, data, _ptr(out),
                                                           cap),
                     max(64, len(data) + 8)).tolist()

    def decode(self, ids) -> str:
        return _decode(lambda arr, buf, cap: self._lib.bpe_decode(
            self._handle, _ptr(arr), len(arr), buf, cap), ids, 8)


METASPACE = "▁"


class UnigramTokenizer(_Native):
    """SentencePiece Unigram (the T5, LLaMA, Mistral and Gemma vocabularies)
    over a ``vocab.tsv`` (``piece<TAB>score`` a line, line order the id):
    metaspace normalization, Viterbi segmentation, fused unknowns, optional
    ``<0xXX>`` byte fallback and a lossless ``decode``; ``encode``,
    ``decode`` and ``encode_batch`` as :class:`BPETokenizer`'s.

    ``add_dummy_prefix``: 0 none, 1 always prepend the metaspace (LLaMA's
    Prepend normalizer), 2 unless the text starts with a space or a
    metaspace (T5's Metaspace pre-tokenizer). Ties between segmentations
    of equal score go by a fixed order (start ascending, piece length
    descending, strict improvement)."""

    _prefix = "ug_"

    def __init__(self, vocab_path: str, unk_id: int = 0, add_dummy_prefix=True,
                 byte_fallback: bool = False):
        self.vocab_path = vocab_path
        self.unk_id = unk_id
        self.add_dummy_prefix = int(add_dummy_prefix)
        self.byte_fallback = byte_fallback
        lib = library("unigram")
        super().__init__("unigram", lib.ug_load(vocab_path.encode(), unk_id,
                                                self.add_dummy_prefix, int(byte_fallback)),
                         vocab_path)

    @classmethod
    def from_tokenizer_json(cls, json_path: str, vocab_tsv_path: str | None = None
                            ) -> "UnigramTokenizer":
        """Build from a Hugging Face ``tokenizer.json`` with a Unigram
        model: its pieces are written as a ``vocab.tsv`` (next to the json
        unless ``vocab_tsv_path`` is given), ``unk_id`` and
        ``byte_fallback`` come from the model block, the dummy prefix from
        the normalizer (Prepend: 1) or the Metaspace pre-tokenizer (2). A
        split-mode Metaspace with a piece holding an interior metaspace
        raises ``NotImplementedError``: the whole-string Viterbi would part
        from the word-split lattice there."""
        with open(json_path, encoding="utf-8") as fh:
            spec = json.load(fh)
        model = spec.get("model", {})
        if model.get("type") != "Unigram":
            raise ValueError(f"{json_path}: model.type={model.get('type')!r}, not Unigram")
        vocab = model.get("vocab", [])
        unk_id = model.get("unk_id")

        def scan(block, wanted):
            if not block:
                return []
            seq = (block.get("normalizers", block.get("pretokenizers", [block]))
                   if block.get("type") == "Sequence" else [block])
            return [b for b in seq if b.get("type") == wanted]

        add_dummy_prefix = 1 if scan(spec.get("normalizer") or {}, "Prepend") else 0
        split_mode = False
        for ms in scan(spec.get("pre_tokenizer") or {}, "Metaspace"):
            scheme = ms.get("prepend_scheme",
                            "always" if ms.get("add_prefix_space", True) else "never")
            if scheme != "never" and add_dummy_prefix == 0:
                add_dummy_prefix = 2
            split_mode = split_mode or ms.get("split", True)
        if split_mode:
            for piece, _ in vocab:
                if METASPACE in piece[1:]:
                    raise NotImplementedError(
                        f"{json_path}: split-mode Metaspace with an interior-metaspace "
                        f"piece {piece!r}: whole-string Viterbi would part from the "
                        "word-split lattice")
        if vocab_tsv_path is None:
            vocab_tsv_path = os.path.splitext(json_path)[0] + ".vocab.tsv"
        with open(vocab_tsv_path, "w", encoding="utf-8") as fh:
            for piece, score in vocab:
                if any(c in piece for c in "\t\n\r"):
                    raise ValueError(f"piece {piece!r} contains tsv delimiter bytes")
                fh.write(f"{piece}\t{score}\n")
        return cls(vocab_tsv_path, unk_id=-1 if unk_id is None else int(unk_id),
                   add_dummy_prefix=add_dummy_prefix,
                   byte_fallback=bool(model.get("byte_fallback", False)))

    @property
    def vocab_size(self) -> int:
        return int(self._lib.ug_vocab_size(self._handle))

    def piece_id(self, piece: str) -> int:
        """The id of a literal piece (``"</s>"``), -1 if absent."""
        raw = piece.encode("utf-8")
        return int(self._lib.ug_piece_id(self._handle, raw, len(raw)))

    token_id = piece_id  # BPETokenizer's name: the two serve interchangeably

    def encode(self, text: str) -> list[int]:
        data = text.encode("utf-8")
        return _grow(lambda out, cap: self._lib.ug_encode(self._handle, data, _ptr(out),
                                                          cap),
                     max(64, 2 * len(data) + 8)).tolist()

    def decode(self, ids) -> str:
        return _decode(lambda arr, buf, cap: self._lib.ug_decode(
            self._handle, _ptr(arr), len(arr), buf, cap), ids, 16)


__all__ = ["BPETokenizer", "UnigramTokenizer", "WordPieceTokenizer", "build", "library"]
