"""The SQuAD QA slice of the port against the JAX package, on the CPU in f32.

The span heads of BERT, DistilBERT and RoBERTa (tiny, frozen MOPED, carried
over with ``from_jax_params``) give the JAX package's start and end logits
at its own injected draws; ``training.qa_span_loss`` is the JAX function;
``Predictor(task="qa")`` gives the JAX ``Predictor``'s probabilities,
per-draw log-probabilities and n-best spans on the same request at the
JAX predictor's draws; and ``utils/squad.py`` answers as the JAX module
does on the same inputs (normalisation, EM/F1, the JSON loader,
windowing, featurisation with a toy tokenizer, span decoding, the draws'
metrics), except where the reference's span scores overflow to -inf.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayeformers_tpu_torch as bt
from bayeformers_tpu import training as jtraining
from bayeformers_tpu.serving import Predictor as JPredictor
from bayeformers_tpu.utils import squad as jsquad
from bayeformers_tpu_torch import training
from bayeformers_tpu_torch.models import families
from bayeformers_tpu_torch.utils import squad
from test_torch_bert import _jax_hook
from test_torch_families import S, convert_pair
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

B, L = 3, 20
NEG = np.finfo(np.float32).min


def qa_batch(bundle, seed=0):
    rng = np.random.default_rng(seed)
    pad = getattr(bundle.config, "pad_token_id", 0)
    ids = rng.integers(2, 1024, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[1, 13:] = 0
    ids[1, 13:] = pad
    tok = np.zeros((B, L), np.int32)
    if bundle.uses_token_type_ids:
        tok[:, 6:] = 1
    from bayeformers_tpu.models import bert as jbert

    return jbert.prune_inputs(bundle, {"input_ids": ids, "attention_mask": mask,
                                       "token_type_ids": tok})


@pytest.mark.parametrize("name", ["bert-base-uncased", "distilbert-base-uncased",
                                  "roberta-base"])
def test_span_heads_match_jax(name):
    """(start, end) of the span head, the frequentist forward and the fused
    forward with antithetic pairs at the JAX package's draws: 1e-4."""
    family = families.family_of(name)
    layers = {"n_layers": 1} if family == "distilbert" else {"num_hidden_layers": 1}
    bundle, bmodel, bp, port = convert_pair(name, task="qa", layers=layers)
    assert port.model.task == "qa" and not hasattr(port.model, "classifier")
    batch = qa_batch(bundle)
    jin = {k: jnp.asarray(v) for k, v in batch.items()}
    tin = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    want = bundle.apply_fn(bp.params, **jin)
    got = port.model(**tin)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
    key = jax.random.key(4)
    jout, jaux = bmodel.mc_apply_fused(bp, key, S, antithetic=True, **jin)
    out, aux = port.mc_apply_fused(0, S, **tin, antithetic=True,
                                   eps_hook=_jax_hook(bmodel, key))
    assert isinstance(out, tuple) and out[0].shape == (S, B, L)
    for a, b in zip(out, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
    for k in aux:
        np.testing.assert_allclose(aux[k].numpy(), np.asarray(jaux[k]), rtol=2e-5)


def test_qa_span_loss_matches_jax():
    rng = np.random.default_rng(0)
    start = rng.normal(size=(S, B, L)).astype(np.float32) * 2
    end = rng.normal(size=(S, B, L)).astype(np.float32) * 2
    pos = {"start_positions": rng.integers(0, L, (B,)).astype(np.int32),
           "end_positions": rng.integers(0, L, (B,)).astype(np.int32)}
    jnll, jm = jtraining.qa_span_loss((jnp.asarray(start), jnp.asarray(end)),
                                      {k: jnp.asarray(v) for k, v in pos.items()})
    nll, m = training.qa_span_loss((torch.from_numpy(start), torch.from_numpy(end)),
                                   {k: torch.from_numpy(v).long() for k, v in pos.items()})
    np.testing.assert_allclose(nll.item(), float(jnll), rtol=1e-6)
    for k in ("acc", "acc_std"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-6, atol=1e-7)


def test_predictor_qa_matches_jax(monkeypatch):
    """The port's ``Predictor(task="qa")`` against the JAX package's on one
    ragged request (bucket (4, 32)), the port given the JAX predictor's
    draws: start and end summaries and per-draw log-probs within 1e-5, the
    same n-best spans; padded positions get no probability."""
    bundle, bmodel, bp, port = convert_pair("bert-base-uncased", task="qa",
                                            layers={"num_hidden_layers": 1})
    kw = dict(n_samples=S, batch_sizes=(2, 4), seq_lens=(16, 32), task="qa",
              antithetic=True, n_best=3, max_answer_len=6)
    jpred = JPredictor(bmodel, bp, **kw)
    pred = bt.Predictor(port, **kw)
    batch = qa_batch(bundle)
    seed, nb, lb = 3, 4, 32
    key = jax.random.fold_in(jax.random.key(seed), nb * 100003 + lb)
    orig = port.mc_apply_fused
    monkeypatch.setattr(port, "mc_apply_fused", lambda *a, **k: orig(
        *a, **k, eps_hook=_jax_hook(bmodel, key)))
    want = jpred(batch, seed=seed)
    got = pred(batch, seed=seed)
    assert set(got) == set(want)
    for k in want:
        if k == "spans":
            continue
        assert got[k].shape == np.asarray(want[k]).shape, k
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    assert got["start_logp_draws"].shape == (B, S, L)
    assert got["start_probs"][1, 13:].max() == 0.0  # padded positions
    for gs, ws in zip(got["spans"], want["spans"]):
        assert [(d["start"], d["end"]) for d in gs] == [(d["start"], d["end"]) for d in ws]
        np.testing.assert_allclose([d["score"] for d in gs], [d["score"] for d in ws],
                                   rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="needs a tokenizer"):
        pred.predict_texts([("q", "c")], tokenizer=None)
    with pytest.raises(ValueError, match="span head"):
        bt.Predictor(port, task="classification")


def _toy_tokenize(text):
    """Ids from characters: one id per word piece of up to 3 letters."""
    ids = []
    for word in text.lower().split():
        for i in range(0, len(word), 3):
            ids.append(5 + sum(ord(c) for c in word[i:i + 3]) % 900)
    return ids


EXAMPLES = [
    {"qid": "q1", "question": "Who wrote the book?",
     "context": "The book was written by Ada Lovelace in London, long ago.",
     "answers": [{"text": "Ada Lovelace", "answer_start": 24}]},
    {"qid": "q2", "question": "Where?",
     "context": " ".join(f"word{i}" for i in range(40)) + " in Paris today.",
     "answers": [{"text": "Paris", "answer_start": 244}]},
]


def test_squad_utils_match_jax(tmp_path):
    for a, b in (("The  Cat!", "cat"), ("an apple", "Apple."), ("x y z", "y z w")):
        assert squad.normalize_answer(a) == jsquad.normalize_answer(a)
        assert squad.exact_match_score(a, b) == jsquad.exact_match_score(a, b)
        assert squad.f1_score(a, b) == jsquad.f1_score(a, b)
    preds = {"q1": "Ada Lovelace", "q2": "in Paris"}
    refs = {"q1": ["Ada Lovelace"], "q2": ["Paris", "paris today"]}
    assert squad.squad_evaluate(preds, refs) == jsquad.squad_evaluate(preds, refs)
    draws = [preds, {"q1": "Lovelace", "q2": "Paris"}, preds]
    assert squad.draw_metrics(draws, refs) == jsquad.draw_metrics(draws, refs)
    path = tmp_path / "dev.json"
    path.write_text(json.dumps({"data": [{"paragraphs": [
        {"context": ex["context"], "qas": [{"id": ex["qid"], "question": ex["question"],
                                            "answers": ex["answers"]}]}
        for ex in EXAMPLES]}]}))
    assert squad.load_squad_json(str(path)) == jsquad.load_squad_json(str(path))
    for n, m, d in ((10, 20, 5), (50, 20, 8), (50, 20, 30), (41, 13, 13)):
        assert squad.windowize(n, m, d) == jsquad.windowize(n, m, d)
    text = EXAMPLES[0]["context"]
    assert squad.tokenize_with_offsets(text, _toy_tokenize) == \
        jsquad.tokenize_with_offsets(text, _toy_tokenize)
    for training_ in (True, False):
        kw = dict(max_seq=32, doc_stride=8, is_training=training_)
        feats = squad.featurize(EXAMPLES, _toy_tokenize, **kw)
        assert feats == jsquad.featurize(EXAMPLES, _toy_tokenize, **kw)
    assert len(feats) > len(EXAMPLES)  # the long context took several windows
    rng = np.random.default_rng(0)
    for f in feats:
        s_log = rng.normal(size=32).astype(np.float32)
        e_log = rng.normal(size=32).astype(np.float32)
        off = f["context_offset"]
        assert squad.best_span(s_log, e_log, off, 6) == jsquad.best_span(s_log, e_log, off, 6)
        assert squad.n_best_spans(s_log, e_log, off, 6, 4) == \
            jsquad.n_best_spans(s_log, e_log, off, 6, 4)
        (s, e), _ = squad.best_span(s_log, e_log, off, 6)
        ctx = EXAMPLES[int(f["qid"][1:]) - 1]["context"]
        assert squad.decode_span(f, ctx, s, e) == jsquad.decode_span(f, ctx, s, e)


def test_span_scores_do_not_overflow():
    """Where two masked ``finfo(f32).min`` logits meet, the reference's f32
    sum is -inf: the port's span scorer keeps the spans and scores the
    reference gives wherever its score is finite, and a finite score, the
    best f64 sum, where the reference's is not."""
    rng = np.random.default_rng(1)
    finite = overflowed = 0
    for trial in range(60):
        s_log = (rng.normal(size=24) * 3).astype(np.float32)
        e_log = (rng.normal(size=24) * 3).astype(np.float32)
        if trial % 3:
            s_log[16:] = NEG
            e_log[16:] = NEG
        if trial % 3 == 2:  # every position masked: every f32 sum overflows
            s_log[:] = NEG
            e_log[:] = NEG
        with np.errstate(over="ignore"):
            ref = jsquad.best_span(s_log, e_log, 3, 5)
            ref_n = jsquad.n_best_spans(s_log, e_log, 3, 5, 4)
        got = squad.best_span(s_log, e_log, 3, 5)
        got_n = squad.n_best_spans(s_log, e_log, 3, 5, 4)
        assert np.isfinite(got[1]) and all(np.isfinite(x[2]) for x in got_n)
        if np.isfinite(ref[1]):
            finite += 1
            assert got == ref
        else:
            overflowed += 1
            best = max(float(np.float64(s_log[a]) + np.float64(e_log[b]))
                       for a in range(3, 24) for b in range(a, min(a + 5, 24)))
            assert got[1] == best
        kept = [x for x in ref_n if np.isfinite(x[2])]
        assert got_n[:len(kept)] == kept
    assert finite and overflowed
