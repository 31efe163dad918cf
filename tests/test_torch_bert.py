"""The port's serving slice as a whole against the JAX package.

A tiny Flax BERT converted by ``bayeformers_tpu.to_bayesian(delta=0.05,
freeze=True)`` is carried over with ``from_jax_params``; the JAX package's
own per-leaf draws (``naive_eps`` at its ``layer_seeds``, ``_unit_bias_eps``
for the biases) are injected into the port through the eps hook, and both
run ``mc_apply_fused`` (antithetic and independent draws) on the CPU in
f32. The ``Predictor`` on both estimators.
"""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import bayeformers_tpu as bf
import bayeformers_tpu_torch as bt
from bayeformers_tpu.models import bert as jbert
from bayeformers_tpu.nn import fused as jfused
from bayeformers_tpu.ops import common as jcommon
from bayeformers_tpu.ops import sampled_linear as jsl
from bayeformers_tpu_torch import elbo, training
from bayeformers_tpu_torch.nn.fused import derive_seed
from bayeformers_tpu_torch.nn.surgery import leaf
from bayeformers_tpu_torch.serving import summarize
from bayeformers_tpu_torch.ops import _build
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

S = 4


def _batch(B=3, L=16, seed=0, vocab=1024):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[1, 10:] = 0
    tok = np.zeros((B, L), np.int32)
    tok[:, L // 2:] = 1
    return ids, mask, tok


@pytest.fixture(scope="module")
def pair():
    bundle = jbert.build_bert(size="tiny", seed=0)
    bmodel, bp = bf.to_bayesian(bundle.apply_fn, bundle.params, delta=0.05,
                                freeze=True)
    port = bt.from_jax_params(
        flatten_dict(bp.params, sep="/"),
        {p: np.asarray(r) for p, r in bp.rho.items()},
        prior_mu={p: np.asarray(m) for p, m in bp.prior_mu.items()},
        device="cpu",
    )
    return bundle, bmodel, bp, port


def _jax_hook(bmodel, key, drawn=None):
    """The JAX package's own draw for each leaf (nn/fused.py)."""
    index = {p: i for i, p in enumerate(bmodel.spec.paths)}

    def hook(path, n_draws, shape):
        lkey = jax.random.fold_in(key, index[path])
        if path.endswith("/kernel"):
            seeds = jcommon.seed_from_key(jax.random.split(lkey, n_draws))
            eps = jsl.naive_eps(seeds, shape)
        else:
            eps = jfused._unit_bias_eps(lkey, n_draws, shape[0], None)
        if drawn is not None:
            drawn.append((path, n_draws))
        return torch.from_numpy(np.array(eps))

    return hook


def _fused_against_jax(pair, antithetic, key):
    _, bmodel, bp, port = pair
    ids, mask, tok = _batch()
    out, aux = bmodel.mc_apply_fused(
        bp, key, S, input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask),
        token_type_ids=jnp.asarray(tok), save_weights=False, antithetic=antithetic)
    drawn = []
    t = lambda a: torch.from_numpy(a).long()
    logits, taux = port.mc_apply_fused(0, S, t(ids), t(mask), t(tok),
                                       antithetic=antithetic,
                                       eps_hook=_jax_hook(bmodel, key, drawn))
    assert sorted(p for p, _ in drawn) == sorted(bmodel.spec.paths)
    assert {n for _, n in drawn} == {S // 2 if antithetic else S}
    assert logits.shape == out.shape == (S, 3, 2)
    np.testing.assert_allclose(logits.numpy(), np.asarray(out), atol=1e-4)
    # log_q / log_p are f32 sums over ~3e5 terms of magnitude ~1-7: XLA's CPU
    # reduction is off a float64 sum by up to ~1e-5 relative (see
    # test_torch_fused_linear.py), so absolute agreement is ~1e1 here
    for k in ("log_variational_posterior", "log_prior"):
        np.testing.assert_allclose(taux[k].numpy(), np.asarray(aux[k]), rtol=2e-5)
    return taux


def test_mc_apply_fused_matches_jax_at_injected_draws(pair):
    taux = _fused_against_jax(pair, True, jax.random.key(3))
    # antithetic pairs share log_q and (frozen MOPED) log_p
    lq = taux["log_variational_posterior"]
    assert torch.allclose(lq[0::2], lq[1::2], rtol=1e-6)


def test_independent_mc_apply_fused_matches_jax(pair):
    """``mc_apply_fused(antithetic=False)``, the reference's default: one
    draw per sample, logits 1e-4 and aux 2e-5 relative."""
    taux = _fused_against_jax(pair, False, jax.random.key(4))
    lq = taux["log_variational_posterior"]
    assert len(set(lq.tolist())) == S  # every sample has its own draw


def test_frequentist_forward_matches_flax(pair):
    bundle, _, bp, port = pair
    ids, mask, tok = _batch(seed=1)
    want = bundle.apply_fn(bp.params, jnp.asarray(ids), jnp.asarray(mask),
                           jnp.asarray(tok))
    t = lambda a: torch.from_numpy(a).long()
    got = port.model(t(ids), t(mask), t(tok))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_to_bayesian_matches_jax_conversion(pair):
    _, bmodel, bp, port = pair
    fresh = bt.to_bayesian(port.model, delta=0.05, freeze=True)
    assert fresh.spec.paths == bmodel.spec.paths
    assert fresh.spec.frozen and fresh.spec.moped
    for p in fresh.spec.paths:
        np.testing.assert_allclose(fresh.rho[p].numpy(), np.asarray(bp.rho[p]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(leaf(port.model, p).numpy(),
                                      np.asarray(flatten_dict(bp.params, sep="/")[p]))
        assert not leaf(port.model, p).requires_grad  # frozen mu


def test_other_recipes_raise():
    """Every conversion of the reference now runs: random init (the
    default, which needs a generator, as the JAX package's needs ``rng``)
    and MOPED with a trainable mu. What raises is a random init without a
    generator and an odd S for pairs; every estimator runs."""
    model = bt.build_bert(size="tiny", device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match="generator"):
        bt.to_bayesian(model)
    with pytest.raises(ValueError, match="generator"):
        bt.to_bayesian(model, delta=None)
    ids = torch.ones((2, 8), dtype=torch.long)
    for kw in ({"generator": torch.Generator().manual_seed(0)},
               {"delta": 0.05, "freeze": False}):
        other = bt.to_bayesian(
            bt.build_bert(size="tiny", device="cpu", dtype=torch.float32), **kw)
        assert not other.spec.frozen
        out, aux = other.mc_apply_fused(0, 2, ids)
        assert out.shape == (2, 2, 2) and torch.isfinite(aux["log_prior"]).all()
    bmodel = bt.to_bayesian(model, delta=0.05, freeze=True)
    ids = torch.ones((2, 8), dtype=torch.long)
    # W residuals serve the backward (save_weights=True); save_weights=False
    # under autograd regenerates W in the backward instead, to the same
    # gradients in f32
    out, _ = bmodel.mc_apply_fused(0, 2, ids, save_weights=True)
    assert out.shape == (2, 2, 2)
    named = bmodel.trainable_parameters()
    grads = []
    for sw in (True, False):
        for _, t, _ in named:
            t.grad = None
        out, aux = bmodel.mc_apply_fused(0, 2, ids, save_weights=sw)
        (out.float().sum() + aux["log_variational_posterior"].sum()).backward()
        grads.append({n: t.grad.clone() for n, t, _ in named})
    assert set(grads[0]) == set(grads[1])
    for n in grads[0]:
        torch.testing.assert_close(grads[1][n], grads[0][n], rtol=1e-6, atol=1e-7,
                                   msg=n)
    # the other estimators run too: each serves the S samples, finite
    for est in ("naive", "flipout", "local"):
        with torch.no_grad():
            out, aux = training.pick_mc(bmodel, True, est)(0, 2, ids)
        assert out.shape == (2, 2, 2) and torch.isfinite(aux["log_prior"]).all(), est
    with pytest.raises(ValueError):
        bmodel.mc_apply_fused(0, 3, ids, antithetic=True)


def test_unported_recipes_name_their_slice(pair):
    """What still raises names the slice that brings it, or what the caller
    must pass, not a slice that has landed: the conversions of ROADMAP
    queue 1 items 2 and 3 now run."""
    _, _, bp, port = pair
    with pytest.raises(ValueError, match="generator") as e:
        bt.to_bayesian(port.model, delta=None)
    assert "items 2 and 3" not in str(e.value)
    assert training.pick_mc(port, True, "naive") == port.mc_apply
    flat = flatten_dict(bp.params, sep="/")
    prior_mu = {p: np.asarray(m) for p, m in bp.prior_mu.items()}
    path = "classifier/kernel"
    prior_mu[path] = prior_mu[path] + 1.0
    rho = {p: np.asarray(r) for p, r in bp.rho.items()}
    # a frozen conversion centres its prior on mu: a prior_mu away from mu
    # names the conversion that carries it
    with pytest.raises(ValueError, match="frozen=False") as e:
        bt.from_jax_params(flat, rho, prior_mu=prior_mu, device="cpu")
    assert "items 2 and 3" not in str(e.value)
    moved = bt.from_jax_params(flat, rho, prior_mu=prior_mu, frozen=False,
                               device="cpu")
    assert moved.spec.moped and not moved.spec.frozen
    np.testing.assert_array_equal(moved.prior_mu[path].numpy(), prior_mu[path])


@pytest.fixture(scope="module")
def predictor():
    model = bt.build_bert(size="tiny", seed=1, device="cpu", dtype=torch.float32)
    return bt.Predictor(bt.to_bayesian(model, delta=0.05, freeze=True), n_samples=4,
                        batch_sizes=(2, 4),
                        seq_lens=(8, 16), antithetic=True)


def _request(n, L, seed=0, pad_from=None):
    rng = np.random.default_rng(seed)
    mask = np.ones((n, L), np.int64)
    if pad_from is not None:
        mask[:, pad_from:] = 0
    return {"input_ids": rng.integers(1, 1024, (n, L)) * mask,
            "attention_mask": mask,
            "token_type_ids": np.zeros((n, L), np.int64)}


def test_predictor_summaries(predictor):
    out = predictor(_request(3, 11), seed=1)  # bucket (4, 16)
    assert out["probs"].shape == (3, 2) and out["pred"].shape == (3,)
    assert out["epistemic_std"].shape == (3, 2) and out["entropy"].shape == (3,)
    np.testing.assert_allclose(out["probs"].sum(-1), 1.0, rtol=1e-6)
    assert (out["epistemic_std"] >= 0).all()
    assert (out["mutual_info"] >= -1e-6).all()
    assert (out["mutual_info"] <= out["entropy"] + 1e-6).all()


def test_predictor_deterministic_per_seed(predictor):
    r = _request(2, 8, seed=2)
    a, b, c = predictor(r, seed=7), predictor(r, seed=7), predictor(r, seed=8)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert not np.array_equal(a["probs"], c["probs"])


def test_predictor_padding_is_masked(predictor):
    # the same rows padded by the caller or by the bucket: same answer
    short = _request(3, 11, seed=3)
    padded = {k: np.concatenate([v, np.zeros((3, 5), v.dtype)], axis=1)
              for k, v in short.items()}
    a, b = predictor(short, seed=4), predictor(padded, seed=4)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=1e-7)
    # extra (padded) rows in the batch bucket do not change the others
    three = predictor(short, seed=4)
    two = predictor({k: v[:2] for k, v in short.items()}, seed=4)  # bucket 2
    assert three["probs"].shape == (3, 2) and two["probs"].shape == (2, 2)
    four = predictor({k: np.concatenate([v, v[:1]]) for k, v in short.items()}, seed=4)
    np.testing.assert_allclose(four["probs"][:3], three["probs"], rtol=1e-6, atol=1e-7)
    # a featurizer's trailing pad columns are trimmed: bucket 8, not 16
    feat = _request(2, 16, seed=5, pad_from=6)
    np.testing.assert_array_equal(
        predictor.predict_featurized(feat, seed=9)["probs"],
        predictor({k: v[:, :6] for k, v in feat.items()}, seed=9)["probs"])


def test_predictor_rejects(predictor):
    with pytest.raises(ValueError):
        predictor(_request(5, 8))   # > largest batch bucket
    with pytest.raises(ValueError):
        predictor(_request(2, 17))  # > largest sequence bucket
    with pytest.raises(ValueError):
        bt.Predictor(predictor.bmodel, n_samples=3, antithetic=True)
    # a decoder's next-token serving is a task now (tests/test_torch_gpt2.py),
    # and qa too (tests/test_torch_squad.py); an unknown task raises, and qa
    # over a classification head names the span head it needs
    assert bt.Predictor(predictor.bmodel, task="causal-lm").task == "causal-lm"
    with pytest.raises(ValueError, match="unknown task"):
        bt.Predictor(predictor.bmodel, task="translation")
    with pytest.raises(ValueError, match="span head"):
        bt.Predictor(predictor.bmodel, task="qa")


def test_independent_predictor_summaries(predictor):
    """The default ``Predictor`` (independent draws), at an odd S: the
    summaries of the fused forward's S logits at the request's key,
    deterministic per seed."""
    pred = bt.Predictor(predictor.bmodel, n_samples=3, batch_sizes=(2, 4),
                        seq_lens=(8, 16))
    assert not pred.antithetic
    r = _request(2, 6, seed=6)  # bucket (2, 8)
    out = pred(r, seed=1)
    assert out["probs"].shape == (2, 2) and out["pred"].shape == (2,)
    np.testing.assert_allclose(out["probs"].sum(-1), 1.0, rtol=1e-6)
    assert (out["epistemic_std"] > 0).all()  # three different draws
    assert (out["mutual_info"] >= -1e-6).all()
    assert (out["mutual_info"] <= out["entropy"] + 1e-6).all()
    with torch.inference_mode():
        padded = {k: torch.from_numpy(np.pad(v, ((0, 0), (0, 2)))) for k, v in r.items()}
        logits, _ = predictor.bmodel.mc_apply_fused(
            derive_seed(1, 2 * 100003 + 8), 3, padded["input_ids"],
            padded["attention_mask"], padded["token_type_ids"], save_weights=False)
        want = summarize(logits)
    for k in out:
        np.testing.assert_allclose(out[k], want[k].numpy(), rtol=1e-6, atol=1e-7)
    again, other = pred(r, seed=1), pred(r, seed=2)
    for k in out:
        np.testing.assert_array_equal(out[k], again[k])
    assert not np.array_equal(out["probs"], other["probs"])


def test_mc_logits_mean():
    x = torch.arange(24.0).reshape(4, 3, 2)
    torch.testing.assert_close(elbo.mc_logits_mean(x), x.mean(0))


def test_no_fallback_without_a_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bt.build_bert(size="tiny", device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bt.from_jax_params({}, {})
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.library()


def test_port_imports_and_serves_without_jax():
    """The port needs none of jax, flax, optax, transformers or the JAX
    package: with their imports blocked it imports, runs the tiny ViT,
    CLIP, T5 and Whisper with every rule, decodes with ``mc_generate``, and
    serves a request."""
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "flax", "optax", "transformers",
                     "bayeformers_tpu"):
            sys.modules[name] = None
        import numpy as np, torch
        import bayeformers_tpu_torch as bt
        import bayeformers_tpu_torch.convert, bayeformers_tpu_torch.elbo
        import bayeformers_tpu_torch.ops._build
        import bayeformers_tpu_torch.nn.conv, bayeformers_tpu_torch.nn.naive
        import bayeformers_tpu_torch.nn.flipout, bayeformers_tpu_torch.nn.lrt
        from bayeformers_tpu_torch.models import clip, vit
        rules = (*bt.DEFAULT_RULES, bt.CONV_RULE, bt.EMBEDDING_RULE)
        px = torch.zeros(2, 32, 32, 3)
        vm = bt.to_bayesian(vit.build_vit(size="tiny", device="cpu"), delta=0.05, rules=rules)
        assert vm.mc_apply_fused(0, 2, px)[0].shape == (2, 2, 2)
        cm = bt.to_bayesian(clip.build_clip(device="cpu"), delta=0.05, rules=rules)
        ids = torch.ones(2, 8, dtype=torch.long)
        assert cm.mc_apply_fused(0, 2, ids, px, untile_axes=(1,))[0].shape == (2, 2, 2)
        from bayeformers_tpu_torch import generation, pretrained
        from bayeformers_tpu_torch.models import t5, whisper
        tm = bt.to_bayesian(t5.build_t5("tiny", device="cpu"), delta=0.05, rules=rules)
        out = tm.mc_apply_fused(0, 2, input_ids=ids, labels=ids[:, :4])[0]
        assert out.shape == (2, 2, 4, 512)
        wm = bt.to_bayesian(whisper.build_whisper(device="cpu"), delta=0.05, rules=rules)
        out = wm.mc_apply_fused(0, 2, input_features=torch.zeros(2, 16, 48),
                                decoder_input_ids=ids[:, :4])[0]
        assert out.shape == (2, 2, 4, 128)
        seqs = generation.mc_generate(tm.model, tm, 2, np.ones((2, 3)), max_new_tokens=2)
        assert seqs["sequences"].shape == (2, 2, 5)
        model = bt.build_bert(size="tiny", device="cpu", dtype=torch.bfloat16)
        bmodel = bt.to_bayesian(model, delta=0.05, freeze=True)
        for anti, s in ((False, 3), (True, 2)):
            pred = bt.Predictor(bmodel, n_samples=s, batch_sizes=(2,),
                                seq_lens=(8,), antithetic=anti)
            out = pred({"input_ids": np.arange(1, 13).reshape(2, 6)}, seed=0)
            assert np.isfinite(out["probs"]).all() and out["probs"].shape == (2, 2)
        bad = [m for m in sys.modules if m.split(".")[0] in (
            "jax", "flax", "optax", "transformers", "bayeformers_tpu")
            and sys.modules[m] is not None]
        assert not bad, bad
        print("served", out["probs"].shape)
    """)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "served (2, 2)" in proc.stdout
