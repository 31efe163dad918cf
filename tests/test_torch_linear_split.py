"""The Bayesian linear op's decomposition on the card, by its plain mirrors
on the CPU, against the port's plain op and the JAX package.

The forward runs as a draw pass (W of every sample once, in the operand
type, with per-block log-prob partials), a product ``y[s] = x[s] @ W[s]``
and a fixed-order finalize of the partials (``fl.draw_plain``,
``fl.bmm_plain``, ``fl.draw_finalize_plain``); the reduce splits its walk
over (output tile, pair or sample, chunk of tokens) into equal ranges, one
per block (``fb.plan_slices``), whose partials are summed in block order
(``fb.reduce_sliced_plain``). Each is held against ``bayes_linear_plain``
and the unsliced plain reduces, and against the JAX package's
``bayes_linear`` and ``reduce_abuv(_anti)`` at the same draw, under the
three priors; the planner must cover every (tile, pair, token) once.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayeformers_tpu.ops import common as jcommon
from bayeformers_tpu.ops import fused_backward as jfb
from bayeformers_tpu.ops import fused_linear as jfl
from bayeformers_tpu_torch.core import init as init_lib
from bayeformers_tpu_torch.ops import fused_backward as fb
from bayeformers_tpu_torch.ops import fused_linear as fl
from bayeformers_tpu_torch.ops import logprob
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

MIX = (0.5, 1.0, math.exp(-6.0))
PRIORS = ["on_mu", "gaussian", "mixture"]


def _inputs(S, M, K, N, prior, seed=0):
    """x, mu, rho, prior_mu (Gaussian only), g and g_p: the mixture's mu
    and rho from the uniform init's ranges, the Gaussian priors' from MOPED
    (mu moved off prior_mu under ``gaussian``)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((S, M, K)).astype(np.float32)
    pmu = None
    if prior == "mixture":
        mu = rng.uniform(-0.2, 0.2, (K, N)).astype(np.float32)
        rho = rng.uniform(-5.0, -4.0, (K, N)).astype(np.float32)
    else:
        mu = (rng.standard_normal((K, N)) * 0.02).astype(np.float32)
        rho = init_lib.moped_rho(torch.from_numpy(mu), 0.05).numpy()
        if prior == "gaussian":
            pmu = mu
            mu = (pmu + rng.standard_normal((K, N)) * 0.01).astype(np.float32)
    g = rng.standard_normal((S, M, N)).astype(np.float32)
    g_p = rng.standard_normal(S).astype(np.float32)
    return x, mu, rho, pmu, g, g_p


def _draw(mu, rho, n, salt):
    """The JAX package's seeds and W on the CPU, and the eps they imply."""
    seeds = jcommon.seed_from_key(jax.random.split(jax.random.key(salt), n))
    jw = np.asarray(jfl.regenerate_weights(jnp.asarray(mu), jnp.asarray(rho), seeds))
    sig = np.logaddexp(rho.astype(np.float64), 0.0)
    eps = (jw.astype(np.float64) - mu) / sig
    return seeds, torch.from_numpy(eps.astype(np.float32))


def _kw(prior, pmu, jax_side=False):
    if prior == "mixture":
        return {"mixture": MIX}
    if prior == "gaussian":
        return {"prior_mu": jnp.asarray(pmu) if jax_side else torch.from_numpy(pmu)}
    return {"prior_on_mu": True} if jax_side else {}


@pytest.mark.parametrize("antithetic", [True, False], ids=["antithetic", "fused"])
@pytest.mark.parametrize("prior", PRIORS)
def test_draw_pass_and_product_match_plain_and_jax(prior, antithetic):
    """Draw pass, product and finalize against ``bayes_linear_plain`` (W
    equal, y equal, log-probs 2e-5 relative: the same f32 terms summed by
    block, then by tile) and against the JAX package's ``bayes_linear`` at
    the same draw (y 1e-5, log-probs 2e-5 relative, the CPU tolerances of
    the port's forward tests); the finalize's per-tile partials against
    f64 sums of the plain terms."""
    S, M, K, N = 4, 6, 300, 130
    x, mu, rho, pmu, _, _ = _inputs(S, M, K, N, prior, seed=3 + antithetic)
    n_draws = S // 2 if antithetic else S
    seeds, eps = _draw(mu, rho, n_draws, K + antithetic)
    t = torch.from_numpy
    kw = _kw(prior, pmu)
    w, part, ls = fl.draw_plain(t(mu), t(rho), antithetic=antithetic, eps=eps, **kw)
    n_tiles, n_groups = fl.draw_layout(K, N)
    own = antithetic and prior != "on_mu"
    assert tuple(part.shape) == (n_draws, n_tiles, n_groups, 3 if own else 2)
    assert tuple(ls.shape) == (n_tiles, n_groups)
    y = fl.bmm_plain(t(x), w)
    p = logprob.prior_of(**kw)
    tile_part, lq, lp = fl.draw_finalize_plain(part, ls, K, N, antithetic, p)

    yp, lqp, lpp, wp = fl.bayes_linear_plain(t(x), t(mu), t(rho), antithetic=antithetic,
                                             eps=eps, save_weights=True, **kw)
    assert torch.equal(w, wp)
    assert torch.equal(y, yp)
    np.testing.assert_allclose(lq.numpy(), lqp.numpy(), rtol=2e-5)
    np.testing.assert_allclose(lp.numpy(), lpp.numpy(), rtol=2e-5)
    # each tile's partial sums against f64 sums of the same terms
    ref = part.double().sum(2)
    np.testing.assert_allclose(tile_part.double().numpy(), ref.numpy(),
                               atol=1e-5 * part.double().abs().sum(2).max().item())

    jy, jq, jp = jfl.bayes_linear(jnp.asarray(x), jnp.asarray(mu), jnp.asarray(rho), seeds,
                                  antithetic=antithetic, **_kw(prior, pmu, jax_side=True))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(lq.numpy(), np.asarray(jq), rtol=2e-5)
    np.testing.assert_allclose(lp.numpy(), np.asarray(jp), rtol=2e-5)


@pytest.mark.parametrize("f32", [False, True], ids=["bf16-tiles", "f32-tiles"])
@pytest.mark.parametrize("antithetic", [True, False], ids=["antithetic", "fused"])
@pytest.mark.parametrize("prior", PRIORS)
def test_sliced_reduce_matches_unsliced_and_jax(prior, antithetic, f32):
    """The reduce's partials summed in block order (each kernel's tiles and
    steps, on a grid of 7 blocks so that ranges cut tiles and pairs)
    against the unsliced plain reduce and the JAX package's
    ``reduce_abuv(_anti)`` at the same W: within 1e-5 of each
    accumulator's largest entry."""
    S, M, K, N = 4, 100, 300, 130
    x, mu, rho, pmu, g, g_p = _inputs(S, M, K, N, prior, seed=5 + antithetic)
    _, eps = _draw(mu, rho, S // 2 if antithetic else S, 11)
    t = torch.from_numpy
    w = fl.sample_weights(t(mu), t(rho), eps=eps, antithetic=antithetic)
    mix = MIX if prior == "mixture" else None
    want_u = prior != "on_mu"
    plan = fb.plan_slices(S, M, K, N, antithetic, f32, n_sm=7)
    assert any(q0 > 0 for _, _, q0, _, _ in plan.segments())  # a range starts mid-tile
    args = (t(x), t(g), w, t(mu), t(g_p))
    got = fb.reduce_sliced_plain(*args, plan, antithetic, mixture=mix, want_u=want_u)
    plain = (fb.reduce_abuv_anti_plain if antithetic else fb.reduce_abuv_plain)(
        *args, mixture=mix, want_u=want_u)
    jred = jfb.reduce_abuv_anti if antithetic else jfb.reduce_abuv
    want = jred(*(jnp.asarray(a.numpy()) for a in args), mix, want_u=True)
    names = "ABUV" if want_u else "ABV"
    want = want if want_u else (want[0], want[1], want[3])
    assert len(got) == len(plain) == len(want)
    for name, a, b, c in zip(names, got, plain, want):
        for ref in (b.numpy(), np.asarray(c)):
            np.testing.assert_allclose(a.numpy(), ref, rtol=0,
                                       atol=1e-5 * np.abs(ref).max(), err_msg=name)


# the main path's training shapes (BERT-base, LLaMA's lm_head) and odd ones
PLAN_SHAPES = [(10, 1024, 768, 768), (10, 1024, 768, 3072), (10, 1024, 3072, 768),
               (10, 8, 768, 2), (10, 1024, 768, 32000), (10, 100, 300, 130), (4, 100, 300, 130)]


@pytest.mark.parametrize("f32", [False, True], ids=["bf16-tiles", "f32-tiles"])
@pytest.mark.parametrize("antithetic", [True, False], ids=["antithetic", "fused"])
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_slice_planner_covers_every_pair_and_token_once(shape, antithetic, f32):
    """Every (output tile, pair or sample, token) falls in exactly one
    block's range; every block takes the same number of steps within one,
    the grid fills 132 multiprocessors where there is the work, and the
    slots are distinct and within ``n_slots``."""
    S, M, K, N = shape
    plan = fb.plan_slices(S, M, K, N, antithetic, f32, n_sm=132)
    h = 2 if antithetic else 1
    n_tiles = plan.tiles_k * plan.tiles_n
    assert plan.tiles_k * plan.tile >= K > (plan.tiles_k - 1) * plan.tile
    assert plan.n_mc * plan.tokens >= M > (plan.n_mc - 1) * plan.tokens
    per_sm = fb.F32_BLOCKS_PER_SM if f32 else fb.BF16_BLOCKS_PER_SM
    assert plan.n_blocks == min(132 * per_sm, plan.total)
    groups = S if plan.per_sample else S // h
    counts = np.zeros((n_tiles, groups, plan.n_mc * plan.tokens), np.int64)
    steps, slots = np.zeros(plan.n_blocks, np.int64), set()
    for b, tile, q0, q1, slot in plan.segments():
        assert 0 <= q0 < q1 <= plan.steps_per_tile
        assert 0 <= slot < plan.n_slots and slot not in slots
        slots.add(slot)
        steps[b] += q1 - q0
        for q in range(q0, q1):
            m0 = (q % plan.n_mc) * plan.tokens
            grp = q // plan.n_mc
            if plan.per_sample:
                grp = (grp + plan.rotation(tile)) % groups
                assert plan.rotation(tile) % h == 0  # a pair's members stay together
            counts[tile, grp, m0: m0 + plan.tokens] += 1
    assert (counts[:, :, :M] == 1).all() and (counts[:, :, M:] == 1).all()
    assert steps.max() - steps.min() <= 1 and steps.sum() == plan.total
