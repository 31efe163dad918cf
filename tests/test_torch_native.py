"""The port's native tokenizers (``bayeformers_tpu_torch/native``) against the
JAX package's (``bayeformers_tpu/native``): its native libraries and its
pure-Python versions, on vocabulary files the tests write. Ids and offsets
must be equal, element for element."""
import json
import random

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401

from bayeformers_tpu import native as jnative
from bayeformers_tpu_torch import native

WP_VOCAB = [
    "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "the", "quick", "brown",
    "fox", "jump", "##ed", "##s", "over", "lazy", "dog", ",", ".", "!", "un",
    "##want", "run", "##ning", "he", "##llo", "world", "ca", "##fe", "中", "文",
    "(", ")", "-", "?", "##ll", "o", "w", "##o", "##r", "##l", "##d",
]

WP_TEXTS = [
    "The quick brown fox jumped over the lazy dog.",
    "unwanted running!",
    "totally-unknown zebra qqq zzz",          # [UNK] runs
    "Héllo, wörld café",                       # accents
    "中文 and 中国文字",                         # CJK isolated, unknown CJK
    "(the) fox-dog? !!",                       # punctuation
    "  extra   whitespace\tand\nnewlines  ",
    "HELLO World",
    "",
]


def _rng_texts(seed: int, n: int) -> list[str]:
    """Texts drawn from the vocabulary's words and a few strangers, made
    from a numpy seed."""
    rng = np.random.default_rng(seed)
    words = [w for w in WP_VOCAB if not w.startswith("[") and not w.startswith("##")]
    words += ["zebra", "Café", "jumps", "running", "wörld", "中文", "...", "x-y"]
    return [" ".join(rng.choice(words, size=rng.integers(1, 12)).tolist()) for _ in range(n)]


@pytest.fixture(scope="module")
def wp_vocab(tmp_path_factory):
    path = tmp_path_factory.mktemp("wp") / "vocab.txt"
    path.write_text("\n".join(WP_VOCAB), encoding="utf-8")
    return str(path)


@pytest.mark.parametrize("lowercase", [True, False])
@pytest.mark.parametrize("backend", ["native", "python"])
def test_wordpiece_ids_and_offsets(wp_vocab, lowercase, backend):
    port = native.WordPieceTokenizer(wp_vocab, lowercase=lowercase)
    ref = jnative.WordPieceTokenizer(wp_vocab, lowercase=lowercase,
                                     force_python=backend == "python")
    for text in WP_TEXTS + _rng_texts(0, 40):
        assert port.tokenize(text) == ref.tokenize(text), text
        assert port.tokenize_with_offsets(text) == ref.tokenize_with_offsets(text), text


def test_wordpiece_specials_and_size(wp_vocab):
    port = native.WordPieceTokenizer(wp_vocab)
    ref = jnative.WordPieceTokenizer(wp_vocab, force_python=True)
    assert port.vocab_size == len(WP_VOCAB)
    for name in ("cls", "sep", "pad", "unk"):
        assert port.special_id(name) == ref.special_id(name)


def test_wordpiece_batch(wp_vocab):
    port = native.WordPieceTokenizer(wp_vocab)
    ref = jnative.WordPieceTokenizer(wp_vocab)
    texts = WP_TEXTS * 5 + _rng_texts(1, 20)
    for a, b in zip(port.encode_batch(texts, capacity=16, n_threads=3),
                    ref.encode_batch(texts, capacity=16, n_threads=3)):
        np.testing.assert_array_equal(a, b)


def test_wordpiece_duplicate_entries_last_wins(tmp_path):
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(["[PAD]", "[UNK]", "tok", "other", "tok"]))
    port = native.WordPieceTokenizer(str(path))
    assert port.tokenize("tok") == [4]
    assert port.tokenize("tok other") == jnative.WordPieceTokenizer(
        str(path), force_python=True).tokenize("tok other")


def test_wordpiece_missing_vocab_raises(tmp_path):
    with pytest.raises(ValueError, match="could not load"):
        native.WordPieceTokenizer(str(tmp_path / "absent.txt"))


# ---------------------------------------------------------------------------
# GPT-2 byte-level BPE
# ---------------------------------------------------------------------------

MERGES = [
    "h e", "l l", "he ll", "hell o", "Ġ w", "Ġw o", "r l", "Ġwo rl",
    "Ġworl d", "Ġ t", "Ġt he", "1 2", "12 3", "t h", "th e", "' s",
    "Ġ h", "Ġh e", "Ġhe ll", "Ġhell o", "! !",
]

BPE_TEXTS = [
    "hello world", "the hello worlds", "  hello   world ",
    "hello's world 'til 're 've 'll", "hello123 worlds!!",
    "tabs\tand\nnewlines  end", "punct?!... runs---", "héllo wörld 中文",
    "trailing spaces   ", "",
]


@pytest.fixture(scope="module")
def bpe_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("bpe")
    alphabet = jnative.gpt2_byte_alphabet()
    vocab = {alphabet[b]: b for b in range(256)}
    for i, merge in enumerate(MERGES):
        a, b = merge.split(" ")
        vocab[a + b] = 256 + i
    vocab["<|endoftext|>"] = 256 + len(MERGES)
    (d / "vocab.json").write_text(json.dumps(vocab, ensure_ascii=False), encoding="utf-8")
    (d / "merges.txt").write_text("#version: 0.2\n" + "\n".join(MERGES) + "\n",
                                  encoding="utf-8")
    return str(d / "vocab.json"), str(d / "merges.txt")


@pytest.mark.parametrize("backend", ["native", "python"])
def test_bpe_encode_decode(bpe_files, backend):
    port = native.BPETokenizer(*bpe_files)
    ref = jnative.BPETokenizer(*bpe_files, force_python=backend == "python")
    for text in BPE_TEXTS + _rng_texts(2, 30):
        ids = port.encode(text)
        assert ids == ref.encode(text), repr(text)
        assert port.decode(ids) == ref.decode(ids) == text, repr(text)


def test_bpe_tokens_and_batch(bpe_files):
    port = native.BPETokenizer(*bpe_files)
    ref = jnative.BPETokenizer(*bpe_files)
    assert port.vocab_size == ref.vocab_size == 256 + len(MERGES) + 1
    assert port.token_id("<|endoftext|>") == 256 + len(MERGES)
    assert port.token_id("absent-token") == -1
    texts = BPE_TEXTS * 4
    for a, b in zip(port.encode_batch(texts, capacity=24, n_threads=2),
                    ref.encode_batch(texts, capacity=24, n_threads=2)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# SentencePiece Unigram
# ---------------------------------------------------------------------------

UG_TEXTS = [
    "hello world", "the quick brown fox", " leading space", "double  space inside",
    "héllo wörld", "punct! marks? here.", "∑ unknown ∑∑ runs ∑", "", "▁literal metaspace",
]


def _ug_vocab(seed: int, byte_fallback: bool):
    rng = random.Random(seed)
    singles = sorted(set("".join(UG_TEXTS).replace(" ", "").replace("∑", "")))
    multis = ["▁hello", "▁world", "hello", "llo", "▁the", "▁qu", "ick", "▁fox", "▁br",
              "own", "▁space", "space", "▁lead", "ing", "▁in", "side", "▁mark", "s?",
              "▁here", "▁runs", "un", "known"]
    vocab = [("<unk>", 0.0), ("▁", rng.uniform(-10.0, -1.0))]
    vocab += [(p, rng.uniform(-10.0, -1.0)) for p in singles + multis]
    if byte_fallback:
        vocab += [(f"<0x{b:02X}>", rng.uniform(-14.0, -11.0)) for b in range(256)]
    return vocab


def _tokenizer_json(path, flavor: str, byte_fallback: bool, seed: int) -> str:
    """A Hugging Face ``tokenizer.json`` with a Unigram model, written by
    hand: LLaMA's Prepend normalizer, or T5's split Metaspace."""
    spec = {"model": {"type": "Unigram", "unk_id": 0, "byte_fallback": byte_fallback,
                      "vocab": [list(v) for v in _ug_vocab(seed, byte_fallback)]}}
    if flavor == "prepend":
        spec["normalizer"] = {"type": "Sequence", "normalizers": [
            {"type": "Prepend", "prepend": "▁"},
            {"type": "Replace", "pattern": {"String": " "}, "content": "▁"}]}
    else:
        spec["pre_tokenizer"] = {"type": "Metaspace", "replacement": "▁",
                                 "prepend_scheme": "first", "split": True}
    out = path / f"ug_{flavor}_{int(byte_fallback)}.json"
    out.write_text(json.dumps(spec, ensure_ascii=False), encoding="utf-8")
    return str(out)


@pytest.mark.parametrize("flavor", ["prepend", "metaspace"])
@pytest.mark.parametrize("byte_fallback", [False, True])
def test_unigram_encode_decode(tmp_path, flavor, byte_fallback):
    path = _tokenizer_json(tmp_path, flavor, byte_fallback, seed=7)
    port = native.UnigramTokenizer.from_tokenizer_json(path, str(tmp_path / "port.tsv"))
    refs = [jnative.UnigramTokenizer.from_tokenizer_json(
        path, str(tmp_path / f"ref{int(p)}.tsv"), force_python=p) for p in (False, True)]
    assert (tmp_path / "port.tsv").read_bytes() == (tmp_path / "ref0.tsv").read_bytes()
    for text in UG_TEXTS:
        ids = port.encode(text)
        for ref in refs:
            assert ids == ref.encode(text), (ref.backend, text)
            assert port.decode(ids) == ref.decode(ids), (ref.backend, text)
    assert port.vocab_size == refs[1].vocab_size
    assert port.piece_id("▁hello") == refs[1].piece_id("▁hello") >= 0
    assert port.piece_id("absent-piece") == port.token_id("absent-piece") == -1


def test_unigram_batch(tmp_path):
    path = _tokenizer_json(tmp_path, "prepend", True, seed=5)
    port = native.UnigramTokenizer.from_tokenizer_json(path, str(tmp_path / "a.tsv"))
    ref = jnative.UnigramTokenizer.from_tokenizer_json(path, str(tmp_path / "b.tsv"))
    texts = [t for t in UG_TEXTS if t] * 3
    for a, b in zip(port.encode_batch(texts, capacity=64, n_threads=2),
                    ref.encode_batch(texts, capacity=64, n_threads=2)):
        np.testing.assert_array_equal(a, b)


def test_unigram_split_mode_interior_metaspace_refused(tmp_path):
    spec = {"model": {"type": "Unigram", "unk_id": 0,
                      "vocab": [["<unk>", 0.0], ["a▁b", -1.0]]},
            "pre_tokenizer": {"type": "Metaspace", "replacement": "▁", "split": True}}
    path = tmp_path / "t.json"
    path.write_text(json.dumps(spec, ensure_ascii=False), encoding="utf-8")
    with pytest.raises(NotImplementedError, match="interior"):
        native.UnigramTokenizer.from_tokenizer_json(str(path))


def test_build_is_keyed_by_source():
    paths = {name: native.build(name) for name in ("wordpiece", "bpe", "unigram")}
    for name, p in paths.items():
        assert p.parent == native.BUILD_DIR and p.name.startswith(f"lib{name}_")
        assert native.build(name) == p  # built once, then loaded


# ---------------------------------------------------------------------------
# a real-text corpus for the causal LMs (utils/data.py::load_lm_corpus)
# ---------------------------------------------------------------------------

def _corpus(root, bpe_files, n_docs=3, seed=0):
    """Documents of seeded text in ``root``, the BPE files beside them."""
    import shutil

    rng = np.random.default_rng(seed)
    words = ["hello", "world", "the", "worlds", "hello's", "123", "!!", "héllo"]
    for i in range(n_docs):
        (root / f"doc{i}.txt").write_text(
            " ".join(rng.choice(words, size=120).tolist()), encoding="utf-8")
    for f in bpe_files:
        shutil.copy(f, root)
    return str(root)


def test_load_lm_corpus_bit_equal(tmp_path, bpe_files):
    from bayeformers_tpu.utils import data as jdata
    from bayeformers_tpu_torch.utils import data

    root = _corpus(tmp_path, bpe_files)
    for seq in (8, 16):
        got = data.load_lm_corpus(root, seq, seed=1)
        want = jdata.load_lm_corpus(root, seq, seed=1)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2:] == want[2:] == (256 + len(MERGES) + 1, 256 + len(MERGES))
    one = data.load_lm_corpus(f"{root}/doc0.txt", 8, vocab_json=bpe_files[0],
                              merges_txt=bpe_files[1])
    assert one[0].dtype == np.int32 and one[0].shape[1] == 8
    with pytest.raises(ValueError, match="too small"):
        data.load_lm_corpus(f"{root}/doc0.txt", 4096)


def test_gpt2_lm_trains_on_a_corpus(tmp_path, bpe_files):
    from bayeformers_tpu_torch.workloads import gpt2_lm

    (tmp_path / "c").mkdir()
    root = _corpus(tmp_path / "c", bpe_files)
    res = gpt2_lm.train(corpus=root, size="tiny", seq=16, samples=2, batch_size=4,
                        limit_batches=2, estimator="fused", device="cpu",
                        logs=str(tmp_path / "logs"))
    assert "bayes_rate" not in res and all(np.isfinite(v) for v in res.values())
