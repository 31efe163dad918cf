"""The port's serving slice as a whole against the JAX package.

A tiny Flax BERT converted by ``bayeformers_tpu.to_bayesian(delta=0.05,
freeze=True)`` is carried over with ``from_jax_params``; the JAX package's
own per-leaf draws (``naive_eps`` at its ``layer_seeds``, ``_unit_bias_eps``
for the biases) are injected into the port through the eps hook, and both
run ``mc_apply_fused(antithetic=True)`` on the CPU in f32.
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
from bayeformers_tpu_torch import elbo
from bayeformers_tpu_torch.nn.surgery import leaf
from bayeformers_tpu_torch.ops import _build

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


def test_mc_apply_fused_matches_jax_at_injected_draws(pair):
    _, bmodel, bp, port = pair
    key = jax.random.key(3)
    ids, mask, tok = _batch()
    out, aux = bmodel.mc_apply_fused(
        bp, key, S, input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask),
        token_type_ids=jnp.asarray(tok), save_weights=False, antithetic=True)
    index = {p: i for i, p in enumerate(bmodel.spec.paths)}
    drawn = []

    def hook(path, n_draws, shape):
        """The JAX package's own draw for this leaf (nn/fused.py)."""
        lkey = jax.random.fold_in(key, index[path])
        if path.endswith("/kernel"):
            seeds = jcommon.seed_from_key(jax.random.split(lkey, n_draws))
            eps = jsl.naive_eps(seeds, shape)
        else:
            eps = jfused._unit_bias_eps(lkey, n_draws, shape[0], None)
        drawn.append(path)
        return torch.from_numpy(np.array(eps))

    t = lambda a: torch.from_numpy(a).long()
    logits, taux = port.mc_apply_fused(0, S, t(ids), t(mask), t(tok), eps_hook=hook)
    assert sorted(drawn) == sorted(bmodel.spec.paths)
    assert logits.shape == out.shape == (S, 3, 2)
    np.testing.assert_allclose(logits.numpy(), np.asarray(out), atol=1e-4)
    # log_q / log_p are f32 sums over ~3e5 terms of magnitude ~1-7: XLA's CPU
    # reduction is off a float64 sum by up to ~1e-5 relative (see
    # test_torch_fused_linear.py), so absolute agreement is ~1e1 here
    for k in ("log_variational_posterior", "log_prior"):
        np.testing.assert_allclose(taux[k].numpy(), np.asarray(aux[k]), rtol=2e-5)
    # antithetic pairs share log_q and (frozen MOPED) log_p
    lq = taux["log_variational_posterior"]
    assert torch.allclose(lq[0::2], lq[1::2], rtol=1e-6)


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
    model = bt.build_bert(size="tiny", device="cpu", dtype=torch.float32)
    with pytest.raises(NotImplementedError):
        bt.to_bayesian(model, delta=None)
    with pytest.raises(NotImplementedError):
        bt.to_bayesian(model, delta=0.05, freeze=False)
    bmodel = bt.to_bayesian(model)
    ids = torch.ones((2, 8), dtype=torch.long)
    # W residuals now serve the backward; a backward that would regenerate
    # W instead (save_weights=False under autograd) comes later and raises
    out, _ = bmodel.mc_apply_fused(0, 2, ids, save_weights=True)
    assert out.shape == (2, 2, 2)
    bmodel.trainable_parameters()
    with pytest.raises(NotImplementedError, match="regenerates W"):
        bmodel.mc_apply_fused(0, 2, ids, save_weights=False)
    with pytest.raises(NotImplementedError):
        bmodel.mc_apply_fused(0, 2, ids, antithetic=False)
    with pytest.raises(ValueError):
        bmodel.mc_apply_fused(0, 3, ids)


@pytest.fixture(scope="module")
def predictor():
    model = bt.build_bert(size="tiny", seed=1, device="cpu", dtype=torch.float32)
    return bt.Predictor(bt.to_bayesian(model), n_samples=4, batch_sizes=(2, 4),
                        seq_lens=(8, 16))


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
        bt.Predictor(predictor.bmodel, n_samples=3)
    with pytest.raises(NotImplementedError):
        bt.Predictor(predictor.bmodel, antithetic=False)
    with pytest.raises(NotImplementedError):
        bt.Predictor(predictor.bmodel, task="qa")


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
    package: with their imports blocked it imports and serves a request."""
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "flax", "optax", "transformers",
                     "bayeformers_tpu"):
            sys.modules[name] = None
        import numpy as np, torch
        import bayeformers_tpu_torch as bt
        import bayeformers_tpu_torch.convert, bayeformers_tpu_torch.elbo
        import bayeformers_tpu_torch.ops._build
        model = bt.build_bert(size="tiny", device="cpu", dtype=torch.bfloat16)
        pred = bt.Predictor(bt.to_bayesian(model), n_samples=2,
                            batch_sizes=(2,), seq_lens=(8,))
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
