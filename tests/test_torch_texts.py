"""``Predictor.predict_texts`` and ``Predictor.warmup`` against the JAX
package's ``Predictor``, at shared weights (tiny models carried over by
``from_jax_params``) and the JAX predictor's own draws (injected into the
port through ``_jax_hook`` for each bucket it runs): classification on
single sentences and pairs, QA across several ``doc_stride`` windows a
question (spans, the draws' answers and their agreement), and causal-lm
through the native BPE tokenizer."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax.traverse_util import flatten_dict
from test_torch_bert import _jax_hook
from test_torch_families import S, convert_pair
from test_torch_glue_files import SENTENCE_WORDS, write_vocab
from torch_threads import one_torch_thread  # noqa: F401

import bayeformers_tpu as bf
import bayeformers_tpu_torch as bt
from bayeformers_tpu import native as jnative
from bayeformers_tpu.models import gpt2 as jgpt2
from bayeformers_tpu.serving import Predictor as JPredictor
from bayeformers_tpu_torch import native

jax.config.update("jax_platforms", "cpu")


def hook_by_bucket(monkeypatch, port, bmodel, seed):
    """Give the port's forward the JAX predictor's draws of the bucket it
    runs: ``fold_in(key(seed), nb * 100003 + lb)``, read off the padded ids."""
    orig = port.mc_apply_fused

    def run(key_int, n, input_ids, *a, **k):
        nb, lb = input_ids.shape
        key = jax.random.fold_in(jax.random.key(seed), nb * 100003 + lb)
        return orig(key_int, n, input_ids, *a, **k, eps_hook=_jax_hook(bmodel, key))

    monkeypatch.setattr(port, "mc_apply_fused", run)


def assert_same(got, want, keys):
    for k in keys:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    return write_vocab(tmp_path_factory.mktemp("vocab") / "vocab.txt")


def _sentences(seed, n, lo=3, hi=12):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(SENTENCE_WORDS, size=rng.integers(lo, hi)).tolist())
            for _ in range(n)]


def test_classification_texts_match_jax(monkeypatch, vocab):
    _, bmodel, bp, port = convert_pair("bert-base-uncased", layers={"num_hidden_layers": 1})
    kw = dict(n_samples=S, batch_sizes=(2, 4), seq_lens=(16, 32), antithetic=True)
    jpred, pred = JPredictor(bmodel, bp, **kw), bt.Predictor(port, **kw)
    hook_by_bucket(monkeypatch, port, bmodel, 5)
    a, b = _sentences(0, 3), _sentences(1, 3, 6, 20)
    texts = [a[0], (a[1], b[1]), (a[2], b[2])]
    got = pred.predict_texts(texts, tokenizer=native.WordPieceTokenizer(vocab), seed=5)
    want = jpred.predict_texts(texts, tokenizer=jnative.WordPieceTokenizer(vocab), seed=5)
    assert set(got) == set(want)
    assert_same(got, want, ("probs", "epistemic_std", "entropy", "mutual_info"))
    np.testing.assert_array_equal(got["pred"], np.asarray(want["pred"]))
    assert pred.warmup(seed=1) == 4  # every (batch, sequence) bucket once


def test_texts_equal_the_call_on_their_features(vocab):
    """What ``chip_smoke.py`` checks on the card: after ``warmup``,
    ``predict_texts`` on raw pairs gives exactly ``__call__`` on the same
    features at the same seed."""
    _, _, _, port = convert_pair("bert-base-uncased", layers={"num_hidden_layers": 1})
    pred = bt.Predictor(port, n_samples=S, batch_sizes=(8,), seq_lens=(32,))
    assert pred.warmup() == 1
    tok = native.WordPieceTokenizer(vocab)
    pairs = list(zip(_sentences(2, 8), _sentences(3, 8)))
    got = pred.predict_texts(pairs, tokenizer=tok, seed=9)
    feats = bt.serving.glue_lib.featurize_pairs(pairs, [0] * 8, tok.tokenize, max_seq=32,
                                                cls_id=tok.special_id("cls"),
                                                sep_id=tok.special_id("sep"))
    feats.pop("labels")
    want = pred.predict_featurized(feats, seed=9)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(ValueError, match="tokenizer"):
        pred.predict_texts(pairs, tokenizer=None)


def test_qa_texts_match_jax_across_windows(monkeypatch, vocab):
    _, bmodel, bp, port = convert_pair("bert-base-uncased", task="qa",
                                       layers={"num_hidden_layers": 1})
    kw = dict(n_samples=S, batch_sizes=(2, 4), seq_lens=(32,), task="qa", antithetic=True,
              n_best=3, max_answer_len=5, doc_stride=8)
    jpred, pred = JPredictor(bmodel, bp, **kw), bt.Predictor(port, **kw)
    assert bt.Predictor(port, task="qa").doc_stride == 128
    hook_by_bucket(monkeypatch, port, bmodel, 2)
    contexts = _sentences(4, 2, 30, 40)
    texts = [("Who wrote the book?", contexts[0] + " Ada Lovelace wrote it."),
             ("Where?", contexts[1] + " in Paris today.")]
    got = pred.predict_texts(texts, tokenizer=native.WordPieceTokenizer(vocab), seed=2)
    want = jpred.predict_texts(texts, tokenizer=jnative.WordPieceTokenizer(vocab), seed=2)
    assert set(got) == set(want)
    assert len(got["feature_qid"]) > 2 * len(texts)  # several windows a question
    np.testing.assert_array_equal(got["feature_qid"], want["feature_qid"])
    assert_same(got, want, ("start_probs", "end_probs", "start_logp_draws",
                            "end_logp_draws", "span_agreement"))
    assert got["draw_answers"] == want["draw_answers"]
    for gs, ws in zip(got["spans"], want["spans"]):
        assert [(d["start"], d["end"], d["text"]) for d in gs] == [
            (d["start"], d["end"], d["text"]) for d in ws]
        np.testing.assert_allclose([d["score"] for d in gs], [d["score"] for d in ws],
                                   rtol=1e-5, atol=1e-5)


MERGES = ["h e", "l l", "he ll", "hell o", "Ġ w", "Ġw o", "r l", "Ġwo rl", "Ġworl d",
          "Ġ t", "Ġt he", "t h", "th e"]


def test_causal_lm_texts_match_jax(monkeypatch, tmp_path):
    alphabet = jnative.gpt2_byte_alphabet()
    vocab = {alphabet[b]: b for b in range(256)}
    for i, merge in enumerate(MERGES):
        vocab[merge.replace(" ", "")] = 256 + i
    (tmp_path / "vocab.json").write_text(json.dumps(vocab, ensure_ascii=False),
                                         encoding="utf-8")
    (tmp_path / "merges.txt").write_text("#version: 0.2\n" + "\n".join(MERGES) + "\n",
                                         encoding="utf-8")
    files = (str(tmp_path / "vocab.json"), str(tmp_path / "merges.txt"))
    bundle = jgpt2.build_gpt2(size="tiny", seed=0)
    params = jax.tree.map(lambda a: jnp.where(a == 0, jnp.full_like(a, 0.01), a),
                          bundle.params)
    bmodel, bp = bf.to_bayesian(bundle.apply_fn, params, delta=0.05, freeze=True)
    port = bt.from_jax_params(flatten_dict(bp.params, sep="/"),
                              {p: np.asarray(r) for p, r in bp.rho.items()}, device="cpu")
    kw = dict(n_samples=S, batch_sizes=(4,), seq_lens=(16,), task="causal-lm", top_k=5,
              antithetic=True)
    jpred = JPredictor(bmodel, bp, input_keys=("input_ids", "attention_mask"), **kw)
    pred = bt.Predictor(port, **kw)
    hook_by_bucket(monkeypatch, port, bmodel, 3)
    texts = ["hello world", "the hello worlds and the rest of a long line of text", "th"]
    got = pred.predict_texts(texts, tokenizer=native.BPETokenizer(*files), seed=3)
    want = jpred.predict_texts(texts, tokenizer=jnative.BPETokenizer(*files), seed=3)
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["topk_ids"], np.asarray(want["topk_ids"]))
    assert got["topk_tokens"] == want["topk_tokens"]
    assert_same(got, want, ("topk_probs", "topk_epistemic_std", "entropy"))
    # BALD is the difference of two entropies near log(1024) = 6.9: each
    # side rounds them at 2^-23 of that, a few 1e-7 apart
    np.testing.assert_allclose(got["mutual_info"], np.asarray(want["mutual_info"]),
                               rtol=0, atol=4e-6)
    assert pred.warmup() == 1
