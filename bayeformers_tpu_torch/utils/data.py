"""Dataset loading with offline synthetic fallbacks (counterpart of
``bayeformers_tpu/utils/data.py``).

MNIST from its idx files (plain or gzipped) under a directory, else a
deterministic synthetic stand-in of the same shapes (the JAX package's
draws, bit for bit); shuffled minibatches; and a real-text corpus packed
into causal-LM windows by the native BPE or Unigram tokenizer
(``bayeformers_tpu_torch/native``).
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np


# ---------------------------------------------------------------------------
# MNIST (idx format parser — replaces torchvision.datasets.MNIST)
# ---------------------------------------------------------------------------

def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as fh:
        zero, dtype_code, ndim = struct.unpack(">HBB", fh.read(4))
        if zero != 0:
            raise ValueError(f"{path}: not an idx file")
        shape = struct.unpack(">" + "I" * ndim, fh.read(4 * ndim))
        dtype = {0x08: np.uint8, 0x09: np.int8, 0x0B: np.int16,
                 0x0C: np.int32, 0x0D: np.float32, 0x0E: np.float64}[dtype_code]
        return np.frombuffer(fh.read(), dtype=dtype).reshape(shape)


def _find_idx(root: str, stem: str) -> str | None:
    for name in (stem, stem + ".gz", stem.replace("-idx", ".idx"),
                 stem.replace("-idx", ".idx") + ".gz"):
        path = os.path.join(root, name)
        if os.path.exists(path):
            return path
    return None


def load_mnist(
    root: str = "dataset/mnist", synthetic_ok: bool = True, seed: int = 0
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, bool]:
    """Returns (x_train, y_train, x_test, y_test, is_synthetic).

    Images are float32 in [0,1], flattened to 784; labels int32. Looks for
    the standard idx files (optionally gzipped) under ``root``; if absent and
    ``synthetic_ok``, generates class-structured synthetic digits (each class
    = a fixed random 784-prototype + noise) so train/eval dynamics are
    meaningful without the real data.
    """
    stems = {
        "x_train": "train-images-idx3-ubyte",
        "y_train": "train-labels-idx1-ubyte",
        "x_test": "t10k-images-idx3-ubyte",
        "y_test": "t10k-labels-idx1-ubyte",
    }
    paths = {k: _find_idx(root, stem) for k, stem in stems.items()}
    if all(paths.values()):
        x_train = _read_idx(paths["x_train"]).reshape(-1, 784).astype(np.float32) / 255.0
        y_train = _read_idx(paths["y_train"]).astype(np.int32)
        x_test = _read_idx(paths["x_test"]).reshape(-1, 784).astype(np.float32) / 255.0
        y_test = _read_idx(paths["y_test"]).astype(np.int32)
        return x_train, y_train, x_test, y_test, False
    if not synthetic_ok:
        raise FileNotFoundError(f"MNIST idx files not found under {root}")
    rng = np.random.default_rng(seed)
    prototypes = rng.uniform(0, 1, (10, 784)).astype(np.float32)
    def make(n):
        y = rng.integers(0, 10, n).astype(np.int32)
        base = prototypes[y]
        # 15% of examples live BETWEEN two class prototypes, with the label
        # stochastic given the input: x blends prototypes (a, b) with weight
        # alpha ~ U(0.5, 1) and the label is a w.p. alpha, b otherwise. The
        # Bayes-optimal posterior there is (alpha, 1-alpha) — no model can
        # be confidently right, memorization cannot beat the Bayes rate
        # (labels are genuinely random given everything), and near
        # alpha ~ 0.5 a converged model must emit small margins, so MC
        # weight draws genuinely flip predictions (nonzero acc_std — the
        # reference's uncertainty proxy, `examples/bert_glue.py:185-186`).
        # A fully separable stand-in degenerates all uncertainty metrics to
        # zero.
        mixed = rng.random(n) < 0.15
        b = (y + rng.integers(1, 10, n)) % 10
        alpha = rng.uniform(0.5, 1.0, n).astype(np.float32)
        blend = alpha[:, None] * prototypes[y] + (1 - alpha[:, None]) * prototypes[b]
        base = np.where(mixed[:, None], blend, base)
        flip = mixed & (rng.random(n) >= alpha)
        y = np.where(flip, b, y).astype(np.int32)
        x = base * 0.6 + rng.uniform(0, 1, (n, 784)).astype(np.float32) * 0.4
        return x.astype(np.float32), y
    x_train, y_train = make(12_800)
    x_test, y_test = make(2_560)
    return x_train, y_train, x_test, y_test, True


def batches(
    x: np.ndarray, y: np.ndarray, batch_size: int, *, seed: int | None = None,
    drop_remainder: bool = True,
):
    """Simple shuffled minibatch iterator (drop-remainder keeps every batch
    the same shape)."""
    n = len(x)
    idx = np.arange(n)
    if seed is not None:
        np.random.default_rng(seed).shuffle(idx)
    end = n - (n % batch_size) if drop_remainder else n
    for start in range(0, end, batch_size):
        sel = idx[start : start + batch_size]
        yield x[sel], y[sel]


def num_batches(n: int, batch_size: int, drop_remainder: bool = True) -> int:
    return n // batch_size if drop_remainder else -(-n // batch_size)


# ---------------------------------------------------------------------------
# Causal-LM text corpus (GPT-2 BPE via the native tokenizer tier)
# ---------------------------------------------------------------------------

def load_lm_corpus(
    corpus: str, seq: int, *, vocab_json: str | None = None,
    merges_txt: str | None = None, tokenizer_json: str | None = None,
    test_frac: float = 0.1, seed: int = 0,
):
    """Tokenize a real text corpus into packed causal-LM windows.

    ``corpus`` is a ``.txt`` file or a directory of them (read in sorted
    order). Documents are joined with the vocabulary's document separator
    (GPT-2's ``<|endoftext|>`` / SentencePiece's ``</s>``) when present and
    the id stream is chunked into non-overlapping ``seq``-length windows —
    the same packing the reference's HF pipelines produce, built here on
    the native tokenizers instead of Python ones.

    Tokenizer resolution: explicit ``tokenizer_json`` (HF Unigram —
    the LLaMA/Mistral/Gemma/T5 vocabulary family, `native/unigram.cc`);
    explicit ``vocab_json``/``merges_txt`` (GPT-2 BPE, `native/bpe.cc`);
    else ``vocab.json``+``merges.txt`` next to the corpus, then
    ``tokenizer.json`` next to the corpus, then ``dataset/gpt2/``. Returns
    ``(train_ids, test_ids, vocab_size, eot_id)`` with int32 ``(N, seq)``
    id arrays shuffled/split deterministically by ``seed``.
    """
    from bayeformers_tpu_torch.native import BPETokenizer, UnigramTokenizer

    if os.path.isdir(corpus):
        paths = sorted(
            os.path.join(corpus, f) for f in os.listdir(corpus)
            if f.endswith(".txt")
        )
        base = corpus
    else:
        paths = [corpus]
        base = os.path.dirname(corpus) or "."
    if not paths:
        raise FileNotFoundError(f"no .txt files under {corpus}")

    def _near(name):
        cand = os.path.join(base, name)
        return cand if os.path.exists(cand) else None

    def _find(explicit, name):
        if explicit:
            return explicit
        for root in (base, os.path.join("dataset", "gpt2")):
            cand = os.path.join(root, name)
            if os.path.exists(cand):
                return cand
        raise FileNotFoundError(
            f"{name} not found next to {corpus} or under dataset/gpt2/ "
            "(pass vocab_json/merges_txt/tokenizer_json)"
        )

    if tokenizer_json:
        tok = UnigramTokenizer.from_tokenizer_json(tokenizer_json)
    elif vocab_json or merges_txt or (
        _near("vocab.json") and _near("merges.txt")
    ):
        tok = BPETokenizer(_find(vocab_json, "vocab.json"),
                           _find(merges_txt, "merges.txt"))
    elif _near("tokenizer.json"):
        tok = UnigramTokenizer.from_tokenizer_json(_near("tokenizer.json"))
    else:
        tok = BPETokenizer(_find(None, "vocab.json"),
                           _find(None, "merges.txt"))
    if isinstance(tok, UnigramTokenizer):
        eot = tok.piece_id("</s>")
    else:
        eot = tok.token_id("<|endoftext|>")
    stream: list[int] = []
    for path in paths:
        with open(path, encoding="utf-8") as fh:
            stream.extend(tok.encode(fh.read()))
        if eot >= 0:
            stream.append(eot)
    n_win = len(stream) // seq
    if n_win < 2:
        raise ValueError(
            f"corpus too small: {len(stream)} tokens < 2 windows of {seq}"
        )
    ids = np.asarray(stream[: n_win * seq], np.int32).reshape(n_win, seq)
    order = np.random.default_rng(seed).permutation(n_win)
    n_test = max(1, int(n_win * test_frac))
    return (ids[order[n_test:]], ids[order[:n_test]], tok.vocab_size,
            int(eot))
