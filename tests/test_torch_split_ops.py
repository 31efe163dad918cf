"""The split ops of the port against the JAX package, on the CPU.

``sampled_linear.sampled_dense`` (Pallas #12's op) and its VJP against
``bayeformers_tpu.ops.sampled_linear``'s ``naive_sampled_dense`` and
``sampled_dense`` custom VJP; ``logprob.sampled_logprobs`` (Pallas #11's
op) and both of its VJPs against the JAX op, the same draws fed to both
(the JAX package's CPU stream ``naive_eps``, injected into the port);
the port's two ``regenerate_weights`` (#13 and #10 on the card) bit-equal;
``gaussian_kl`` and ``sample_gaussian``; flipout's mixture KL through
``sampled_logprobs`` against the JAX package's ``analytic_leaf_kl`` in
value and gradient; the wrappers' refusal of CPU tensors and the layout of
the logprob kernel's partial sums. On a small net (two ``Dense`` layers)
under the three conversions: ``elbo.analytic_kl`` and ``elbo.predictive``
(through the fused and the naive tier) against the JAX functions.
"""
import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from test_torch_estimators import S, _hook, _Net, _normals, _np

import bayeformers_tpu as bf
from bayeformers_tpu import elbo as jelbo
from bayeformers_tpu.core import distributions as jdist
from bayeformers_tpu.nn import flipout as jflip
from bayeformers_tpu.nn import fused as jfused
from bayeformers_tpu.ops import common as jcommon
from bayeformers_tpu.ops import logprob as jlp
from bayeformers_tpu.ops import sampled_linear as jsl
from bayeformers_tpu_torch import elbo
from bayeformers_tpu_torch.core import distributions as dist
from bayeformers_tpu_torch.core.prior import ScaleMixturePrior
from bayeformers_tpu_torch.nn import flipout
from bayeformers_tpu_torch.ops import common
from bayeformers_tpu_torch.ops import fused_linear as fl
from bayeformers_tpu_torch.ops import logprob as lp
from bayeformers_tpu_torch.ops import sampled_linear as sl
from bayeformers_tpu_torch.nn.surgery import leaf, to_bayesian
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

MIXTURE = (0.5, 1.0, float(np.exp(-6.0)))


def _inputs(S, M, K, N, seed=0, mixture=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(S, M, K)).astype(np.float32)
    if mixture:
        mu = rng.uniform(-0.2, 0.2, (K, N)).astype(np.float32)
        rho = rng.uniform(-5.0, -4.0, (K, N)).astype(np.float32)
    else:
        mu = (rng.normal(size=(K, N)) * 0.05).astype(np.float32)
        rho = rng.uniform(-4.0, -2.0, (K, N)).astype(np.float32)
    seeds = rng.integers(0, 2**31 - 1, (S,)).astype(np.int32)
    g = rng.normal(size=(S, M, N)).astype(np.float32)
    return x, mu, rho, seeds, g


def _eps(seeds, shape):
    """The JAX package's CPU draw of the split ops for ``seeds``."""
    return torch.from_numpy(np.array(jsl.naive_eps(jnp.asarray(seeds), shape)))


def _close(got, want, frac, what):
    """``got`` within ``frac`` of ``want``'s largest entry."""
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=frac * max(np.abs(want).max(), 1e-30), err_msg=what)


@pytest.mark.parametrize("S,M,K,N,dtype", [(3, 5, 64, 48, "f32"), (2, 7, 300, 130, "f32"),
                                           (3, 6, 96, 40, "bf16")])
def test_sampled_dense_and_vjp_match_jax(S, M, K, N, dtype):
    """y against ``naive_sampled_dense`` (f32 1e-5 of max |y|; bf16 one bf16
    step), and dx, dmu, drho against the reference's VJP
    (``_sampled_dense_bwd``) at the same draw: 1e-4 of each one's largest
    entry (bf16 dx 2e-2: a bf16 output)."""
    x, mu, rho, seeds, g = _inputs(S, M, K, N)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32,
                                                                      torch.float32)
    jx = jnp.asarray(x, jdt)
    jseeds = jnp.asarray(seeds)
    jy, vjp = jax.vjp(lambda a, b, c: jsl.sampled_dense(a, b, c, jseeds), jx,
                      jnp.asarray(mu), jnp.asarray(rho))
    jdx, jdmu, jdrho = vjp(jnp.asarray(g, jdt))
    np.testing.assert_allclose(np.asarray(jy, np.float32),
                               np.asarray(jsl.naive_sampled_dense(jx, jnp.asarray(mu),
                                                                  jnp.asarray(rho), jseeds),
                                          np.float32))
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    tmu = torch.from_numpy(mu).requires_grad_()
    trho = torch.from_numpy(rho).requires_grad_()
    y = sl.sampled_dense(tx, tmu, trho, torch.from_numpy(seeds), eps=_eps(seeds, (K, N)))
    assert y.dtype == tdt and tuple(y.shape) == (S, M, N)
    y.backward(torch.from_numpy(g).to(tdt))
    step = 2.0 ** -8 if dtype == "bf16" else 1e-5
    _close(y.float().detach().numpy(), np.asarray(jy, np.float32), step, "y")
    _close(tx.grad.float().numpy(), np.asarray(jdx, np.float32),
           2e-2 if dtype == "bf16" else 1e-4, "dx")
    _close(tmu.grad.numpy(), jdmu, 1e-4, "dmu")
    _close(trho.grad.numpy(), jdrho, 1e-4, "drho")


@pytest.mark.parametrize("prior", ["mixture", "gaussian"])
@pytest.mark.parametrize("K,N", [(64, 48), (300, 130)])
def test_sampled_logprobs_and_vjps_match_jax(prior, K, N):
    """``(log_q, log_p)`` against the JAX op at the same draw (rtol 2e-5,
    XLA's CPU sums), and dmu, drho of both closed-form VJPs (the mixture's
    and the Gaussian's) within 1e-4 of each one's largest entry;
    ``prior_mu`` gets no gradient (the reference's is masked out of
    training)."""
    S = 4
    x, mu, rho, seeds, _ = _inputs(S, 1, K, N, seed=K + N, mixture=prior == "mixture")
    rng = np.random.default_rng(1)
    pmu = (mu + 0.05 * rng.normal(size=mu.shape)).astype(np.float32)
    g_q, g_p = (rng.normal(size=(S,)).astype(np.float32) for _ in range(2))
    jseeds = jnp.asarray(seeds)
    if prior == "mixture":
        fn = lambda m, r: jlp.sampled_logprobs(m, r, jseeds, mixture=MIXTURE)
        kw = {"mixture": MIXTURE}
    else:
        fn = lambda m, r: jlp.sampled_logprobs(m, r, jseeds, prior_mu=jnp.asarray(pmu))
        kw = {"prior_mu": torch.from_numpy(pmu).requires_grad_()}
    (jq, jp), vjp = jax.vjp(fn, jnp.asarray(mu), jnp.asarray(rho))
    jdmu, jdrho = vjp((jnp.asarray(g_q), jnp.asarray(g_p)))
    tmu = torch.from_numpy(mu).requires_grad_()
    trho = torch.from_numpy(rho).requires_grad_()
    q, p = lp.sampled_logprobs(tmu, trho, torch.from_numpy(seeds), eps=_eps(seeds, (K, N)),
                               **kw)
    np.testing.assert_allclose(q.detach().numpy(), np.asarray(jq), rtol=2e-5)
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=2e-5)
    (q * torch.from_numpy(g_q) + p * torch.from_numpy(g_p)).sum().backward()
    _close(tmu.grad.numpy(), jdmu, 1e-4, "dmu")
    _close(trho.grad.numpy(), jdrho, 1e-4, "drho")
    if prior == "gaussian":
        assert kw["prior_mu"].grad is None


def test_sampled_logprobs_takes_exactly_one_prior():
    mu = torch.zeros(8, 4)
    rho = torch.full((8, 4), -3.0)
    seeds = torch.tensor([1, 2], dtype=torch.int32)
    for kw in ({}, {"mixture": MIXTURE, "prior_mu": mu}):
        with pytest.raises(ValueError, match="exactly one of `mixture` or `prior_mu`"):
            lp.sampled_logprobs(mu, rho, seeds, **kw)
    with pytest.raises(ValueError, match="exactly one"):
        jlp.sampled_logprobs(jnp.zeros((8, 4)), jnp.zeros((8, 4)), jnp.asarray([1]))


@pytest.mark.parametrize("K,N", [(768, 130), (300, 256)])
def test_regenerate_weights_are_one_stream(K, N):
    """The port's split ``regenerate_weights`` (#13 on the card) and the
    fused op's (#10) return the same W for the same seeds, bit for bit, and
    so does the fused forward's W; ``sampled_dense`` is ``x @ W`` of that W
    (one stream for one backend, unlike the TPU's two)."""
    rng = np.random.default_rng(K)
    mu = torch.from_numpy((rng.normal(size=(K, N)) * 0.05).astype(np.float32))
    rho = torch.from_numpy(rng.uniform(-4, -2, (K, N)).astype(np.float32))
    seeds = torch.tensor([3, 99, 2**31 - 2], dtype=torch.int32)
    w = sl.regenerate_weights(mu, rho, seeds)
    assert w.dtype == torch.float32 and tuple(w.shape) == (3, K, N)
    assert torch.equal(w, fl.regenerate_weights(mu, rho, seeds))
    assert torch.equal(w, mu[None] + dist.sigma_from_rho(rho)[None]
                       * common.unit_eps(seeds, (K, N)))
    x = torch.from_numpy(rng.normal(size=(3, 4, K)).astype(np.float32))
    assert torch.equal(fl.bayes_linear_with_w(x, mu, rho, seeds)[3], w)
    assert torch.equal(sl.sampled_dense(x, mu, rho, seeds), torch.bmm(x, w))


def test_wrappers_take_plain_on_cpu_and_kernels_refuse_it():
    """A CPU tensor takes the plain version and launches nothing; the
    kernel wrappers refuse it, their counters unchanged."""
    x = torch.randn(2, 3, 16)
    mu, rho = torch.zeros(16, 8), torch.full((16, 8), -3.0)
    seeds = torch.tensor([1, 2], dtype=torch.int32)
    counters = (sl.LAUNCHES, sl.REGEN_LAUNCHES, lp.LAUNCHES, lp.VJP_LAUNCHES)
    before = [c.count for c in counters]
    sl.sampled_dense(x, mu, rho, seeds)
    sl.regenerate_weights(mu, rho, seeds)
    lp.sampled_logprobs(mu, rho, seeds, mixture=MIXTURE)
    mixture = ("mixture",) + MIXTURE
    g = torch.zeros(1, 2)
    for fn, args in ((sl.sampled_dense_cuda, (x, mu, rho, seeds)),
                     (sl.regen_cuda, (mu, rho, seeds, sl.REGEN_LAUNCHES)),
                     (lp.logprobs_grouped_cuda, ([mu], [rho], [seeds], mixture)),
                     (lp.logprob_vjp_grouped_cuda, ([mu], [rho], [seeds], mixture, g, g))):
        with pytest.raises(ValueError, match="CUDA tensor"):
            fn(*args)
    assert [c.count for c in counters] == before


@pytest.mark.parametrize("K,N", [(768, 3072), (300, 130), (256, 2)])
def test_logprob_partials_layout(K, N):
    """The grouped logprob kernel's blocks: each leaf of a group (here (K,
    N) between two others) owns the span of ``logprob_blocks`` blocks after
    the leaf before it, and ``logprob_block_of`` partitions its (K, N)
    elements into those blocks (past a ragged K a block may hold none), at
    most 8192 (2048 Philox calls of four) each, each element in the block of
    its call; the VJP's element offsets
    follow the leaves in order."""
    shapes = [(64, 48), (K, N), (256, 2)]
    spans = lp.grouped_layout(shapes)
    assert [(sp.K, sp.N) for sp in spans] == shapes
    assert spans[0].first_block == 0 and spans[0].offset == 0
    for a, b in zip(spans, spans[1:]):
        assert b.first_block == a.first_block + a.n_blocks
        assert b.offset == a.offset + a.K * a.N
    sp = spans[1]
    assert sp.n_blocks == lp.logprob_blocks(K, N)
    block = lp.logprob_block_of(K, N)
    counts = torch.bincount(block.reshape(-1), minlength=sp.n_blocks)
    assert counts.shape[0] == sp.n_blocks
    assert int(counts.sum()) == K * N and int(counts.max()) <= 8192
    # rows r and r + 128 of a unit and columns c, c + 1 (c even) share a call
    if K >= 256:
        assert torch.equal(block[:128], block[128:256])
    assert torch.equal(block[:, 0::2][:, : N // 2], block[:, 1::2][:, : N // 2])


def test_gaussian_kl_and_sample_gaussian_match_jax():
    """``gaussian_kl`` against the JAX function (rtol 1e-6, and 0 at q = p);
    ``sample_gaussian`` returns ``(mu + softplus(rho) eps, eps)`` with eps
    from the generator (one draw, or ``n_samples`` at once), as the JAX
    function forms it from its key's eps."""
    rng = np.random.default_rng(0)
    mu_q = rng.normal(size=(6, 5)).astype(np.float32)
    sig_q = rng.uniform(0.5, 1.5, (6, 5)).astype(np.float32)
    mu_p = rng.normal(size=(6, 5)).astype(np.float32)
    got = dist.gaussian_kl(torch.from_numpy(mu_q), torch.from_numpy(sig_q),
                           torch.from_numpy(mu_p), 1.3)
    want = jdist.gaussian_kl(jnp.asarray(mu_q), jnp.asarray(sig_q), jnp.asarray(mu_p), 1.3)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    assert abs(dist.gaussian_kl(torch.from_numpy(mu_q), torch.from_numpy(sig_q),
                                torch.from_numpy(mu_q), torch.from_numpy(sig_q)).item()) < 1e-5
    mu = torch.from_numpy(mu_q)
    rho = torch.from_numpy(rng.uniform(-3, 0, (6, 5)).astype(np.float32))
    w, eps = dist.sample_gaussian(torch.Generator().manual_seed(4), mu, rho)
    w2, eps2 = dist.sample_gaussian(torch.Generator().manual_seed(4), mu, rho)
    assert torch.equal(w, w2) and torch.equal(eps, eps2) and eps.shape == mu.shape
    assert torch.equal(eps, torch.randn((6, 5), generator=torch.Generator().manual_seed(4)))
    jw = jnp.asarray(mu_q) + jdist.sigma_from_rho(jnp.asarray(rho.numpy())) * jnp.asarray(
        eps.numpy())
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-7)
    ws, es = dist.sample_gaussian(torch.Generator().manual_seed(5), mu, rho, n_samples=3)
    assert ws.shape == (3, 6, 5) and torch.equal(ws, mu + dist.sigma_from_rho(rho) * es)


@pytest.mark.parametrize("shape", [(40, 24), (24,)])
def test_mixture_kl_through_sampled_logprobs_matches_jax(shape):
    """Flipout's and LRT's mixture KL of a leaf: the port's
    ``analytic_leaf_kl`` (a kernel leaf through ``sampled_logprobs``, a bias
    in plain torch) against the JAX package's ``analytic_leaf_kl`` at the
    same ``kl_draws`` draws, in value (rtol 2e-5) and in its gradients of mu
    and rho (1e-4 of each one's largest entry): the op's closed-form VJP is
    the autodiff of the JAX estimate."""
    rng = np.random.default_rng(len(shape))
    mu = rng.uniform(-0.2, 0.2, shape).astype(np.float32)
    rho = rng.uniform(-5.0, -4.0, shape).astype(np.float32)
    key = jax.random.key(7)
    kd = flipout.KL_DRAWS
    spec = types.SimpleNamespace(moped=False)

    def jkl(m, r):
        return jflip.analytic_leaf_kl(spec, None, MIXTURE, kd, "p", m,
                                      jdist.sigma_from_rho(r), key)

    jval, (jdmu, jdrho) = jax.value_and_grad(jkl, argnums=(0, 1))(jnp.asarray(mu),
                                                                  jnp.asarray(rho))
    draws = jax.random.split(jax.random.fold_in(key, 1), kd)
    eps = torch.from_numpy(np.array(jax.vmap(
        lambda k: jax.random.normal(k, shape, jnp.float32))(draws)))
    bmodel = types.SimpleNamespace(spec=types.SimpleNamespace(
        moped=False, prior=ScaleMixturePrior(*MIXTURE)))
    tmu = torch.from_numpy(mu).requires_grad_()
    trho = torch.from_numpy(rho).requires_grad_()
    val = flipout.analytic_leaf_kl(bmodel, "p", tmu, trho, eps=eps)
    np.testing.assert_allclose(val.item(), float(jval), rtol=2e-5)
    val.backward()
    _close(tmu.grad.numpy(), jdmu, 1e-4, "dmu")
    _close(trho.grad.numpy(), jdrho, 1e-4, "drho")


class _JNet(fnn.Module):
    """``_Net`` in Flax: fc1 (12 -> 32), relu, fc2 (32 -> 5)."""

    @fnn.compact
    def __call__(self, x):
        return fnn.Dense(5, name="fc2")(fnn.relu(fnn.Dense(32, name="fc1")(x)))


SMALL = {"frozen-moped": {"delta": 0.05, "freeze": True}, "moped-trainable": {"delta": 0.05},
         "random-init": {"rng": jax.random.key(2)}}


@pytest.fixture(scope="module", params=list(SMALL))
def small(request):
    """(the JAX BayesianModel and BayesParams of the small net under a
    conversion, the port's with the same mu, rho and prior_mu, inputs)."""
    x = np.random.default_rng(0).normal(size=(6, 12)).astype(np.float32)
    net = _JNet()
    params = net.init(jax.random.key(0), jnp.asarray(x))["params"]
    bmodel, bp = bf.to_bayesian(lambda p, a: net.apply({"params": p}, a), params,
                                **SMALL[request.param])
    kw = ({"generator": torch.Generator().manual_seed(0)} if request.param == "random-init"
          else {k: v for k, v in SMALL[request.param].items()})
    port = to_bayesian(_Net(), **kw)
    with torch.no_grad():
        for path, a in flatten_dict(bp.params, sep="/").items():
            leaf(port.model, path).copy_(torch.from_numpy(np.array(a)))
        for path, a in bp.rho.items():
            port.rho[path].copy_(torch.from_numpy(np.array(a)))
        for path, a in bp.prior_mu.items():
            if not port.spec.frozen:
                port.prior_mu[path].copy_(torch.from_numpy(np.array(a)))
    assert set(port.spec.paths) == set(bp.rho)
    return bmodel, bp, port, x


def test_analytic_kl_matches_jax(small):
    """``elbo.analytic_kl`` against the JAX function: the closed form under
    MOPED, and under the mixture the closed-form entropy with the
    cross-entropy at the JAX package's draws (rtol 2e-5); without a seed
    the mixture's raises."""
    bmodel, bp, port, _ = small
    key = jax.random.key(4)
    want = float(jelbo.analytic_kl(bp, bmodel.spec, key, mixture_draws=3))
    index = {p: i for i, p in enumerate(bmodel.spec.paths)}

    def hook(path, shape):
        return _np(_normals(jax.random.fold_in(key, index[path]), shape[0], shape[1:]))

    got = elbo.analytic_kl(port, mixture_draws=3, eps_hook=hook)
    np.testing.assert_allclose(got.item(), want, rtol=2e-5)
    if not bmodel.spec.moped:
        with pytest.raises(ValueError, match="seed"):
            elbo.analytic_kl(port)
        assert torch.isfinite(elbo.analytic_kl(port, seed=1))


def test_predictive_matches_jax(small):
    """``elbo.predictive`` through the fused tier (no weight residuals) and
    through the naive tier against the JAX function at the same draws:
    probabilities, epistemic std, entropy and logits within 1e-5."""
    bmodel, bp, port, x = small
    key = jax.random.key(6)
    index = {p: i for i, p in enumerate(bmodel.spec.paths)}

    def fused_hook(path, n_draws, shape):
        lkey = jax.random.fold_in(key, index[path])
        if path.endswith("/kernel"):
            return _np(jsl.naive_eps(jcommon.seed_from_key(jax.random.split(lkey, n_draws)),
                                     shape))
        return _np(jfused._unit_bias_eps(lkey, n_draws, shape[0], None))

    for fused, hook in ((True, fused_hook), (False, _hook(bmodel, key, "naive"))):
        want = jelbo.predictive(bmodel, bp, key, S, jnp.asarray(x), fused=fused)
        got = elbo.predictive(port, 0, S, torch.from_numpy(x), fused=fused, eps_hook=hook)
        for k in ("probs", "epistemic_std", "entropy", "logits"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0,
                                       atol=1e-5, err_msg=f"fused={fused} {k}")
