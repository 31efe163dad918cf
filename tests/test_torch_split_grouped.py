"""The grouped split ops of the port against the JAX package, on the CPU.

``logprob.sampled_logprobs_grouped`` (Pallas #11's op over a group of
leaves, one launch on the card) and its closed-form VJP (one
``bft_logprob_vjp`` launch on the card) against the JAX package's
``sampled_logprobs`` and ``jax.vjp``, leaf by leaf, at the JAX draws
injected into the port; flipout's and LRT's mixture KL, deferred to one
grouped call, against the per-leaf path (``analytic_leaf_kl`` a leaf) on a
small random-init BERT; the rerouted VJP of ``sampled_dense`` (W rebuilt,
``reduce_abuv`` and ``finalize``) against the reference's
``_sampled_dense_bwd``; the kernels' leaf table.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayeformers_tpu.ops import logprob as jlp
from bayeformers_tpu.ops import sampled_linear as jsl
import bayeformers_tpu_torch as bt
from bayeformers_tpu_torch.nn import flipout, lrt
from bayeformers_tpu_torch.nn.surgery import leaf
from bayeformers_tpu_torch.ops import logprob as lp
from bayeformers_tpu_torch.ops import sampled_linear as sl
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

MIXTURE = (0.5, 1.0, float(np.exp(-6.0)))
SHAPES = ((64, 48), (300, 130), (256, 40))


def _eps(seeds, shape):
    """The JAX package's CPU draw of the split ops for ``seeds``."""
    return torch.from_numpy(np.array(jsl.naive_eps(jnp.asarray(seeds), shape)))


def _close(got, want, frac, what):
    """``got`` within ``frac`` of ``want``'s largest entry."""
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=frac * max(np.abs(want).max(), 1e-30), err_msg=what)


@pytest.mark.parametrize("prior", ["mixture", "gaussian"])
def test_grouped_logprobs_and_vjp_match_jax(prior):
    """Three leaves of different shapes, one ragged (300, 130), at S = 4:
    each row of the grouped ``(log_q, log_p)`` against the JAX op of its
    leaf at the same draw (rtol 2e-5), and the grouped VJP's dmu, drho of
    every leaf against ``jax.vjp`` of that leaf at its row of the
    cotangents (1e-4 of each one's largest entry); prior_mu gets no
    gradient."""
    S = 4
    rng = np.random.default_rng(7)
    mus, rhos, pmus, seeds, eps = [], [], [], [], []
    for K, N in SHAPES:
        mu = rng.uniform(-0.2, 0.2, (K, N)).astype(np.float32)
        mus.append(mu)
        rhos.append(rng.uniform(-5.0, -3.0, (K, N)).astype(np.float32))
        pmus.append((mu + 0.05 * rng.normal(size=mu.shape)).astype(np.float32))
        seeds.append(rng.integers(0, 2**31 - 1, (S,)).astype(np.int32))
        eps.append(_eps(seeds[-1], (K, N)))
    g_q, g_p = (rng.normal(size=(len(SHAPES), S)).astype(np.float32) for _ in range(2))
    tmu = [torch.from_numpy(m).requires_grad_() for m in mus]
    trho = [torch.from_numpy(r).requires_grad_() for r in rhos]
    tpm = [torch.from_numpy(p).requires_grad_() for p in pmus]
    kw = {"mixture": MIXTURE} if prior == "mixture" else {"prior_mus": tpm}
    q, p = lp.sampled_logprobs_grouped(tmu, trho, [torch.from_numpy(s) for s in seeds],
                                       eps=eps, **kw)
    assert q.shape == p.shape == (len(SHAPES), S)
    (q * torch.from_numpy(g_q) + p * torch.from_numpy(g_p)).sum().backward()
    for i, (mu, rho, pmu, sd) in enumerate(zip(mus, rhos, pmus, seeds)):
        if prior == "mixture":
            fn = lambda m, r: jlp.sampled_logprobs(m, r, jnp.asarray(sd), mixture=MIXTURE)
        else:
            fn = lambda m, r: jlp.sampled_logprobs(m, r, jnp.asarray(sd),
                                                   prior_mu=jnp.asarray(pmu))
        (jq, jp), vjp = jax.vjp(fn, jnp.asarray(mu), jnp.asarray(rho))
        jdmu, jdrho = vjp((jnp.asarray(g_q[i]), jnp.asarray(g_p[i])))
        np.testing.assert_allclose(q[i].detach().numpy(), np.asarray(jq), rtol=2e-5)
        np.testing.assert_allclose(p[i].detach().numpy(), np.asarray(jp), rtol=2e-5)
        _close(tmu[i].grad.numpy(), jdmu, 1e-4, f"leaf {i} dmu")
        _close(trho[i].grad.numpy(), jdrho, 1e-4, f"leaf {i} drho")
    assert all(t.grad is None for t in tpm)


def test_grouped_takes_exactly_one_prior():
    mu = torch.zeros(8, 4)
    rho = torch.full((8, 4), -3.0)
    seeds = torch.tensor([1, 2], dtype=torch.int32)
    for kw in ({}, {"mixture": MIXTURE, "prior_mus": [mu]}):
        with pytest.raises(ValueError, match="exactly one of `mixture` or `prior_mus`"):
            lp.sampled_logprobs_grouped([mu], [rho], [seeds], **kw)


def test_leaf_table_packs_the_kernel_struct():
    """``leaf_table`` packs ``csrc/logprob.cu::Leaf``: the four addresses
    (0 without a prior_mu), the element offset, then (K, N) and
    (first_block, n_blocks) as little-endian int32 pairs."""
    mus = [torch.zeros(K, N) for K, N in SHAPES]
    rhos = [torch.zeros(K, N) for K, N in SHAPES]
    seeds = [torch.zeros(4, dtype=torch.int32) for _ in SHAPES]
    spans = lp.grouped_layout(SHAPES)
    table = lp.leaf_table(spans, mus, rhos, seeds)
    assert table.dtype == np.int64 and table.shape == (len(SHAPES), 7)
    assert table.tobytes().__len__() == 56 * len(SHAPES)
    as32 = table.view(np.int32).reshape(len(SHAPES), 14)
    for row, r32, sp, mu, rho, sd in zip(table, as32, spans, mus, rhos, seeds):
        assert tuple(row[:5]) == (mu.data_ptr(), rho.data_ptr(), 0, sd.data_ptr(), sp.offset)
        assert tuple(r32[10:]) == (sp.K, sp.N, sp.first_block, sp.n_blocks)


def _bert_hook(rng_seed):
    """Seeded normals for every draw flipout and LRT ask for, +-1 for the
    signs, each (path, what) drawn once; ``order`` records the KL draws'
    (path, what) in the order the tier asks for them."""
    rng = np.random.default_rng(rng_seed)
    cache, order = {}, []

    def hook(path, what, shape):
        if (path, what) not in cache:
            if what in ("r", "s", "bias_s"):
                a = rng.choice([-1.0, 1.0], size=shape)
            else:
                a = rng.normal(size=shape)
            cache[path, what] = torch.from_numpy(a.astype(np.float32))
            if what in ("kl", "bias_kl"):
                order.append((path, what))
        return cache[path, what]

    return hook, order


@pytest.mark.parametrize("tier", ["flipout", "local"])
def test_deferred_grouped_kl_equals_per_leaf_path(tier):
    """A small random-init BERT (scale-mixture prior) under flipout and
    LRT: the KL of the aux, now one grouped ``sampled_logprobs_grouped``
    call over the kernel leaves, equals the per-leaf path (each leaf's
    ``analytic_leaf_kl``, in the order the tier met the leaves) at the same
    injected draws, and so do its gradients in mu and rho."""
    model = bt.build_bert(size="tiny", seed=0, dtype=torch.float32, device="cpu")
    bmodel = bt.to_bayesian(model, generator=torch.Generator().manual_seed(3))
    assert not bmodel.spec.moped
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(1, 100, (2, 10))).long()
    mask = torch.ones(2, 10, dtype=torch.long)
    apply = flipout.flipout_mc_apply if tier == "flipout" else lrt.lrt_mc_apply
    tensors = {n: t for n, t, _ in bmodel.trainable_parameters()}
    hook, order = _bert_hook(1)
    _, aux = apply(bmodel, 0, 2, ids, mask, eps_hook=hook)
    kl = aux["kl"]
    grads = torch.autograd.grad(kl, list(tensors.values()), allow_unused=True)
    terms = []
    for path, what in order:
        mu, rho = leaf(bmodel.model, path), bmodel.rho[path]
        terms.append(flipout.analytic_leaf_kl(bmodel, path, mu, rho, plain=True,
                                              eps=hook(path, what, None)))
    assert {p for p, _ in order} == set(bmodel.spec.paths)
    want = torch.stack(terms).sum()
    assert torch.equal(kl, want), (kl.item(), want.item())
    want_grads = torch.autograd.grad(want, list(tensors.values()), allow_unused=True)
    for name, g, w in zip(tensors, grads, want_grads):
        assert (g is None) == (w is None), name
        if w is not None:
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6 * w.abs().max().item(),
                                       msg=name)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_sampled_dense_vjp_reduce_route_matches_jax(dtype):
    """``sampled_dense_vjp``'s plain route (W rebuilt in f32 and x's dtype,
    dx = g W^T, dmu and drho from ``reduce_abuv_plain`` with g_p = 0 and
    ``finalize`` with g_q = 0) against the reference's
    ``_sampled_dense_bwd`` at the same draw, flipout's mu = 0 and mu != 0:
    dmu and drho within 1e-4 of each one's largest entry, dx 1e-4 (bf16
    2e-2: a bf16 output)."""
    S, M, K, N = 3, 6, 300, 130
    rng = np.random.default_rng(5)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32,
                                                                      torch.float32)
    x = rng.normal(size=(S, M, K)).astype(np.float32)
    g = rng.normal(size=(S, M, N)).astype(np.float32)
    rho = rng.uniform(-4.0, -2.0, (K, N)).astype(np.float32)
    seeds = rng.integers(0, 2**31 - 1, (S,)).astype(np.int32)
    for mu in (np.zeros((K, N), np.float32), (rng.normal(size=(K, N)) * 0.05).astype(np.float32)):
        jdx, jdmu, jdrho, _ = jsl._sampled_dense_bwd(
            (jnp.asarray(x, jdt), jnp.asarray(mu), jnp.asarray(rho), jnp.asarray(seeds)),
            jnp.asarray(g, jdt))
        dx, dmu, drho = sl.sampled_dense_vjp(
            torch.from_numpy(x).to(tdt), torch.from_numpy(mu), torch.from_numpy(rho),
            torch.from_numpy(seeds), torch.from_numpy(g).to(tdt), eps=_eps(seeds, (K, N)))
        assert dx.dtype == tdt and dmu.dtype == drho.dtype == torch.float32
        _close(dx.float().numpy(), np.asarray(jdx, np.float32),
               2e-2 if dtype == "bf16" else 1e-4, "dx")
        _close(dmu.numpy(), jdmu, 1e-4, "dmu")
        _close(drho.numpy(), jdrho, 1e-4, "drho")
