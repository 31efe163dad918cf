"""The port's GPT-2 slice against the JAX package, on the CPU.

Causal attention: ``mha_plain`` against ``_mha_xla(causal=True)`` and the
JAX package's head-grouped Pallas forward ``_fwd_kernel_stacked`` (#3),
``mha_bwd_plain`` against its Pallas backward ``_bwd_kernel`` (#5), both
run in Pallas' interpret mode, and against ``jax.vjp`` of ``_mha_xla``
away from the all-masked rows, where XLA's autodiff and ``_bwd_kernel``
differ. Inputs: right-padded keys, a fully masked row and a row whose first
key is masked (its query 0 sees no live key).

The model: a tiny Flax GPT-2 (``models/gpt2.py``, seed 0: two layers,
n_embd 128, two heads, vocab 1024) converted by the JAX package's
``to_bayesian`` three ways and carried over with ``from_jax_params``; the
frequentist logits in f32 and bf16, the converted paths, and
``mc_apply_fused`` under both estimators at the JAX package's own draws
(logits 1e-4, log-probs 2e-5 relative). ``Predictor(task="causal-lm")``
with the properties of ``tests/test_serving.py``, and its summaries
against the JAX ``Predictor``'s on the same logits.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from jax.experimental import pallas as pl

import bayeformers_tpu as bf
import bayeformers_tpu_torch as bt
from bayeformers_tpu.models import gpt2 as jgpt2
from bayeformers_tpu.ops import attention as jat
from bayeformers_tpu.serving import Predictor as JPredictor
from bayeformers_tpu_torch.models.gpt2 import build_gpt2
from bayeformers_tpu_torch.ops import attention as at
from bayeformers_tpu_torch.serving import Predictor, summarize_causal_lm
from test_torch_bert import _jax_hook
from test_torch_bf16 import _within_two_bf16_steps
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

S, B, L = 4, 3, 16
CONVERSIONS = {"frozen-moped": {"delta": 0.05, "freeze": True},
               "moped-trainable": {"delta": 0.05},
               "random-init": {"rng": jax.random.key(5)}}


# ---------------------------------------------------------------------------
# causal attention
# ---------------------------------------------------------------------------

def _attn_inputs(N=4, L=16, H=128, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((N, L, H)).astype(np.float32) for _ in range(4))
    mask = np.ones((N, L), np.int32)
    mask[0, L - 5:] = 0   # right-padded keys
    mask[2] = 0           # a fully masked row (a padded bucket row)
    mask[3, 0] = 0        # the first key masked: query 0 sees no live key
    return q, k, v, g, mask


def _pallas(kernel, n_out, *arrays):
    """A Pallas kernel of the JAX package in interpret mode, one example a
    grid step, with the bias as (N, 1, L) (``_mha_pallas_fwd``'s layout)."""
    N, L_, H = arrays[0].shape
    spec = pl.BlockSpec((1, L_, H), lambda i: (i, 0, 0))
    bspec = pl.BlockSpec((1, 1, L_), lambda i: (i, 0, 0))
    specs = [spec if a.ndim == 3 and a.shape[1] != 1 else bspec for a in arrays]
    shape = jax.ShapeDtypeStruct((N, L_, H), arrays[0].dtype)
    return pl.pallas_call(kernel, grid=(N,), in_specs=specs,
                          out_specs=spec if n_out == 1 else (spec,) * n_out,
                          out_shape=shape if n_out == 1 else (shape,) * n_out,
                          interpret=True)(*arrays)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_causal_mha_plain_matches_jax(dtype, tol):
    """``mha_plain(causal=True)`` against ``_mha_xla(causal=True)`` and #3
    in interpret mode; the all-masked rows (row 2, and row 3's query 0)
    are finite and uniform over all L keys, future keys included."""
    q, k, v, _, mask = _attn_inputs()
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    bias = np.asarray(jat.mask_to_bias(jnp.asarray(mask)))
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    want = jat._mha_xla(jq, jk, jv, jnp.asarray(bias), 2, causal=True)
    stacked = _pallas(functools.partial(jat._fwd_kernel_stacked, 2, True, 2), 1,
                      jq, jk, jv, jnp.asarray(bias)[:, None, :])
    t = lambda a: torch.from_numpy(a).to(dtype)
    got = at.mha_plain(t(q), t(k), t(v), torch.from_numpy(bias), 2, causal=True)
    assert got.dtype == dtype and got.shape == q.shape
    for ref in (want, stacked):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                                   atol=tol, rtol=tol)
    mean_v = t(v).float().numpy().mean(1)
    out = got.float().numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out[2], np.broadcast_to(mean_v[2], out[2].shape),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(out[3, 0], mean_v[3], atol=tol, rtol=tol)
    # a live row sees its causal prefix only: future keys' values do not move it
    v2 = v.copy()
    v2[1, 9:] += 5.0
    moved = at.mha_plain(t(q), t(k), t(v2), torch.from_numpy(bias), 2, causal=True)
    assert torch.equal(moved[1, :9], got[1, :9])
    assert not torch.equal(moved[1, 9:], got[1, 9:])


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_causal_mha_bwd_plain_matches_bwd_kernel(dtype, tol):
    """``mha_bwd_plain(causal=True)`` against the reference's ``_bwd_kernel``
    (#5) in interpret mode on every row, and against ``jax.vjp`` of
    ``_mha_xla(causal=True)`` where no row is all-masked; on the all-masked
    rows ``_bwd_kernel`` (and so the port) lets the uniform row's dS reach
    the future keys, where XLA's autodiff gives them zero."""
    q, k, v, g, mask = _attn_inputs(seed=3)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    bias = np.asarray(jat.mask_to_bias(jnp.asarray(mask)))
    jq, jk, jv, jg = (jnp.asarray(a, jdt) for a in (q, k, v, g))
    want = _pallas(functools.partial(jat._bwd_kernel, 2, True), 3,
                   jq, jk, jv, jnp.asarray(bias)[:, None, :], jg)
    _, vjp = jax.vjp(lambda a, b, c: jat._mha_xla(a, b, c, jnp.asarray(bias), 2,
                                                   causal=True), jq, jk, jv)
    xla = vjp(jg)
    t = lambda a: torch.from_numpy(a).to(dtype)
    got = at.mha_bwd_plain(t(q), t(k), t(v), torch.from_numpy(bias), t(g), 2, causal=True)
    live = [0, 1]  # rows with no all-masked query
    for name, a, b, c in zip(("dq", "dk", "dv"), got, want, xla):
        assert a.dtype == dtype and a.shape == q.shape
        a = a.float().numpy()
        assert np.isfinite(a).all(), name
        for ref, rows in ((b, slice(None)), (c, live)):
            ref = np.asarray(ref, np.float32)[rows]
            np.testing.assert_allclose(a[rows], ref, rtol=tol,
                                       atol=tol * np.abs(ref).max(), err_msg=name)
    # the known difference: the fully masked row 2's dQ under XLA's autodiff
    # takes key 0 only, under _bwd_kernel every key
    dq_xla = np.asarray(xla[0], np.float32)[2]
    assert np.abs(got[0].float().numpy()[2] - dq_xla).max() > 10 * tol


def test_causal_flows_through_the_function():
    """``mha(causal=True)`` under autograd runs the plain causal backward
    on CPU tensors and counts no launch; the counters key by causal."""
    q, k, v, g, mask = _attn_inputs(seed=5)
    bias = at.mask_to_bias(torch.from_numpy(mask))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    before = (at.LAUNCHES.count, at.BWD_LAUNCHES.count)
    out = at.mha(qt, kt, vt, bias, 2, causal=True)
    assert torch.equal(out.detach(), at.mha_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                                  bias, 2, causal=True))
    out.backward(torch.from_numpy(g))
    want = at.mha_bwd_plain(*(torch.from_numpy(a) for a in (q, k, v)), bias,
                            torch.from_numpy(g), 2, causal=True)
    for got, ref in zip((qt.grad, kt.grad, vt.grad), want):
        assert torch.equal(got, ref)
    assert (at.LAUNCHES.count, at.BWD_LAUNCHES.count) == before
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        at.mha_cuda(bf(q), bf(k), bf(v), bias, 2, causal=True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        at.mha_bwd_cuda(bf(q), bf(k), bf(v), bias, bf(g), 2, causal=True)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _batch(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 1024, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[1, 10:] = 0  # right padding
    mask[2, 0] = 0    # the first key masked
    return ids, mask


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


def _convert(bundle, conversion):
    held = {}

    def convert(params):
        held["bmodel"], bp = bf.to_bayesian(bundle.apply_fn, params,
                                            **CONVERSIONS[conversion])
        return bp

    bp = jax.jit(convert)(bundle.params)
    bmodel = held["bmodel"]
    spec = bmodel.spec
    port = bt.from_jax_params(
        flatten_dict(bp.params, sep="/"), {p: np.asarray(r) for p, r in bp.rho.items()},
        prior_mu={p: np.asarray(m) for p, m in bp.prior_mu.items()},
        prior=(spec.prior.pi, spec.prior.sigma1, spec.prior.sigma2),
        moped=spec.moped, frozen=spec.frozen, device="cpu")
    return bmodel, bp, port


@pytest.fixture(scope="module")
def bundle():
    return jgpt2.build_gpt2(size="tiny", seed=0)


@pytest.fixture(scope="module", params=list(CONVERSIONS))
def conversion(request, bundle):
    return (request.param,) + _convert(bundle, request.param)


def test_frequentist_logits_match_flax(bundle):
    """The port's GPT-2 on the Flax weights gives Flax's logits (f32 1e-4);
    its module tree has the Flax paths."""
    port = bt.from_jax_params(flatten_dict(bundle.params, sep="/"), {}, moped=False,
                              frozen=False, device="cpu")
    ids, mask = _batch(1)
    want = bundle.apply_fn(bundle.params, jnp.asarray(ids), jnp.asarray(mask))
    got = port.model(_t(ids), _t(mask))
    assert got.shape == (B, L, 1024)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4)
    names = {n.replace(".", "/") for n, _ in port.model.named_parameters()}
    assert names == set(flatten_dict(bundle.params, sep="/"))
    fresh = build_gpt2("tiny", seed=0, device="cpu")
    assert {n for n, _ in fresh.named_parameters()} == {
        n for n, _ in port.model.named_parameters()}


def test_bf16_frequentist_logits_match_flax(bundle):
    """bf16 activations against HF's Flax GPT-2 in bf16 at the same weights,
    at ``tests/test_torch_bf16.py``'s tolerance (two bf16 steps of the
    largest |logit|): HF runs attention in bf16, the port's mha in f32, and
    gelu_new rounds once in the port."""
    hf16 = type(bundle.hf_model)(bundle.config, dtype=jnp.bfloat16, _do_init=False)
    port = bt.from_jax_params(flatten_dict(bundle.params, sep="/"), {}, moped=False,
                              frozen=False, dtype=torch.bfloat16, device="cpu")
    ids, mask = _batch(2)
    pos = jnp.broadcast_to(jnp.arange(L), (B, L))
    want = hf16.module.apply({"params": bundle.params}, jnp.asarray(ids), jnp.asarray(mask),
                             pos, deterministic=True, return_dict=False)[0]
    _within_two_bf16_steps(port.model(_t(ids), _t(mask)).detach(), want)


def test_conversion_converts_the_conv1d_leaves(conversion, bundle):
    """``n_layer * 8`` converted leaves (c_attn, attn c_proj, c_fc, mlp
    c_proj, kernel and bias each), in the JAX package's order; wte, wpe, the
    LayerNorms and the tied head stay frequentist. The port's own
    ``to_bayesian`` finds the same leaves."""
    name, bmodel, bp, port = conversion
    n_layer = bundle.config.n_layer
    assert len(port.spec.paths) == n_layer * 8 == len(bmodel.spec.paths)
    assert port.spec.paths == bmodel.spec.paths
    assert not any(s in p for p in port.spec.paths for s in ("wte", "wpe", "ln_"))
    fresh = bt.to_bayesian(build_gpt2("tiny", seed=0, device="cpu"), delta=0.05,
                           freeze=True)
    assert fresh.spec.paths == port.spec.paths
    assert fresh.rho["transformer/h/0/attn/c_attn/kernel"].shape == (384, 128)


@pytest.mark.parametrize("antithetic", [True, False])
def test_fused_mc_apply_matches_jax(conversion, antithetic):
    """``mc_apply_fused`` on GPT-2 at the JAX package's draws, the Conv1D
    leaves' eps on the transposed (in, out) view: logits 1e-4, log-probs
    2e-5 relative, under each conversion."""
    name, bmodel, bp, port = conversion
    key = jax.random.key(7)
    ids, mask = _batch()
    out, aux = bmodel.mc_apply_fused(
        bp, key, S, input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask),
        save_weights=False, antithetic=antithetic)
    drawn = []
    logits, taux = port.mc_apply_fused(0, S, _t(ids), _t(mask), antithetic=antithetic,
                                       eps_hook=_jax_hook(bmodel, key, drawn))
    assert sorted(p for p, _ in drawn) == sorted(bmodel.spec.paths)
    assert logits.shape == out.shape == (S, B, L, 1024)
    np.testing.assert_allclose(logits.numpy(), np.asarray(out), atol=1e-4)
    for k in ("log_variational_posterior", "log_prior"):
        np.testing.assert_allclose(taux[k].numpy(), np.asarray(aux[k]), rtol=2e-5,
                                   err_msg=f"{name} {k}")


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def served(bundle):
    """The JAX package's GPT-2 with its zero leaves set to 0.01 (as
    ``tests/test_serving.py`` does: MOPED would give a zero bias sigma =
    softplus(0)), frozen MOPED, and the port's copy."""
    params = jax.tree.map(lambda a: jnp.where(a == 0, jnp.full_like(a, 0.01), a),
                          bundle.params)
    bmodel, bp = bf.to_bayesian(bundle.apply_fn, params, delta=0.05, freeze=True)
    port = bt.from_jax_params(flatten_dict(bp.params, sep="/"),
                              {p: np.asarray(r) for p, r in bp.rho.items()}, device="cpu")
    return bmodel, bp, port


def test_predictor_causal_lm(served):
    """``tests/test_serving.py::test_predictor_causal_lm``'s properties on
    the port: shapes, sorted top-k, BALD within [0, entropy], determinism
    per seed, and a row's prediction unchanged by cutting its padded tail
    (same bucket, same draws)."""
    _, _, port = served
    pred = Predictor(port, n_samples=4, batch_sizes=(2,), seq_lens=(32,),
                     task="causal-lm", top_k=8)
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 1024, (2, 20)).astype(np.int32)
    mask = np.ones((2, 20), np.int32)
    mask[1, 14:] = 0
    out = pred({"input_ids": ids, "attention_mask": mask}, seed=3)
    for k in ("topk_ids", "topk_probs", "topk_epistemic_std"):
        assert out[k].shape == (2, 8), k
    assert out["entropy"].shape == out["mutual_info"].shape == (2,)
    np.testing.assert_array_equal(out["pred"], out["topk_ids"][:, 0])
    assert (np.diff(out["topk_probs"], axis=-1) <= 1e-7).all()
    assert (out["topk_probs"].sum(-1) <= 1 + 1e-5).all()
    assert (out["mutual_info"] >= -1e-5).all()
    assert (out["mutual_info"] <= out["entropy"] + 1e-5).all()
    out2 = pred({"input_ids": ids, "attention_mask": mask}, seed=3)
    for k in out:
        np.testing.assert_array_equal(out[k], out2[k])
    other = pred({"input_ids": ids, "attention_mask": mask}, seed=4)
    assert not np.array_equal(other["topk_probs"], out["topk_probs"])
    out3 = pred({"input_ids": ids[:, :14].copy(), "attention_mask": mask[:, :14].copy()},
                seed=3)
    np.testing.assert_array_equal(out["topk_ids"][1], out3["topk_ids"][1])
    np.testing.assert_allclose(out["topk_probs"][1], out3["topk_probs"][1], rtol=1e-5,
                               atol=1e-6)
    # one request row in a bucket of two: the all-pad bucket row is dropped
    one = pred({"input_ids": ids[:1], "attention_mask": mask[:1]}, seed=3)
    assert one["topk_ids"].shape == (1, 8)
    with pytest.raises(ValueError, match="span head"):  # a decoder has none
        Predictor(port, task="qa")
    with pytest.raises(ValueError, match="unknown task"):
        Predictor(port, task="translation")


def test_causal_lm_summaries_match_jax(served):
    """The port's causal-lm summaries against the JAX ``Predictor``'s on the
    same (S, B, L, V) logits (its ``mc_apply_fused`` returns them)."""
    bmodel, bp, _ = served
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((S, 2, 16, 1024)) * 3).astype(np.float32)
    mask = np.ones((2, 16), np.int32)
    mask[1, 9:] = 0

    class Fixed:
        def mc_apply_fused(self, bparams, key, n, **kw):
            return jnp.asarray(logits), {}

    jpred = JPredictor(Fixed(), None, n_samples=S, batch_sizes=(2,), seq_lens=(16,),
                       task="causal-lm", top_k=8, input_keys=("input_ids", "attention_mask"))
    want = jpred({"input_ids": np.ones((2, 16), np.int32), "attention_mask": mask})
    got = summarize_causal_lm(torch.from_numpy(logits), torch.from_numpy(mask), 8)
    np.testing.assert_array_equal(got["topk_ids"].numpy(), want["topk_ids"])
    np.testing.assert_array_equal(got["pred"].numpy(), want["pred"])
    for k in ("topk_probs", "topk_epistemic_std", "entropy", "mutual_info"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
