"""The combined Bayesian linear op: sampled matmul plus both log-probs.

Counterpart of ``bayeformers_tpu/ops/fused_linear.py::bayes_linear``
(``:1502-1605``), with its signature and defaults and its three priors,
exactly one of which is named:

* ``prior_on_mu=True``: the MOPED Gaussian prior centred on ``mu`` itself,
  for a frozen mu (the GLUE recipe); no third weight array;
* ``prior_mu=``: the MOPED Gaussian prior centred on a separate, fixed
  (K, N) ``prior_mu`` (MOPED with a trainable mu);
* ``mixture=(pi, sigma1, sigma2)``: the zero-mean scale mixture (random
  init, the reference's default conversion).

Two estimators share it:

* independent draws (``antithetic=False``, the reference's default): sample
  s draws eps from ``seeds[s]`` (``seeds`` of shape (S,));
* antithetic pairs (``antithetic=True``): pair t (samples 2t, 2t+1) draws
  eps from ``seeds[t]`` (``seeds`` of shape (S/2,)) and
  ``w[2t + 1] = 2 mu - w[2t]`` (:func:`interleave_antithetic`).

For every sample:

    w[s]      = mu + softplus(rho) * eps
    y[s]      = x[s] @ w[s]        (dot operands in x's dtype, f32 accumulation)
    log_q[s]  = log N(w[s]; mu, sigma^2).sum()
    log_p[s]  = log N(w[s]; mu, MOPED_PRIOR_SIGMA^2).sum()       (prior_on_mu)
              = log N(w[s]; prior_mu, MOPED_PRIOR_SIGMA^2).sum() (prior_mu)
              = mixture_log_pdf(w[s]).sum()                      (mixture)

The log-probs are taken at the f32 W, also where bf16 activations keep a
bf16 W residual.

An independent sample s with seed ``seeds[s]`` draws exactly what
antithetic pair t draws from ``seeds[t]``.

:func:`bayes_linear` is the wrapper: a CPU tensor takes the plain version
:func:`bayes_linear_plain`; a CUDA tensor launches the hand-written kernel
(``csrc/bayes_linear.cu``: ``bft_bayes_linear`` or
``bft_bayes_linear_anti``, each with an instance per activation type, bf16
or f32, and per prior) or raises.
Under autograd there are the reference's two custom VJPs:

* ``save_weights=True``: :class:`BayesLinear` (``_fwd_saved`` /
  ``_bwd_common`` and their antithetic twins). The forward also writes W in
  x's dtype and the backward reads it.
* ``save_weights=False``: :class:`BayesLinearRegen` (``_fwd`` / ``_bwd`` and
  ``_fwd_anti`` / ``_bwd_anti``). The forward writes no W and keeps
  ``(x, mu, rho, seeds)``; the backward rebuilds the f32 W from the seeds
  with :func:`regenerate_weights` (``csrc/regen.cu``, the counterpart of
  ``_fullk_regen_kernel``), interleaved as ``(w, 2 mu - w)`` for pairs.

Both backwards then compute

    dx         = g_y @ W^T               (a batched matmul in x's dtype, as
                                          XLA's einsum)
    (A, B[, U], V) = reduce_abuv[_anti](x, g_y, W, mu, g_p, mixture,
                                        want_u)  (ops/fused_backward)
    dmu, drho  = finalize(A, B, V, rho, g_q, U, prior, mu, prior_mu, g_p)

``want_u`` is on for every prior but ``prior_on_mu``. ``dmu`` is returned
whenever mu requires grad; ``prior_mu`` gets no gradient (the reference
computes one and masks it out of training). Antithetic layers at f32
activations with a padded K above 2048 take the regenerating VJP even when
``save_weights=True``, as the reference routes them (:func:`bayes_linear`).
"""
from __future__ import annotations

import math

import torch

from bayeformers_tpu_torch.core.distributions import LOG_SQRT_2PI, sigma_from_rho
from bayeformers_tpu_torch.core.prior import MOPED_PRIOR_SIGMA
from bayeformers_tpu_torch.ops import _build, common
from bayeformers_tpu_torch.ops import fused_backward as bwd
from bayeformers_tpu_torch.ops import sampled_linear
from bayeformers_tpu_torch.ops.logprob import (
    ON_MU, PRIOR_CODE, PRIOR_TAG, mixture_constants, prior_log_prob, prior_of,
    reduce_keywords)

LAUNCHES = common.LaunchCounter("bayes_linear_anti")
INDEP_LAUNCHES = common.LaunchCounter("bayes_linear")
REGEN_LAUNCHES = common.LaunchCounter("regen")
_BN = 64  # the kernel's column tile (csrc/bayes_linear.cu::BN)
# The reference's f32 antithetic routing: Kp above this takes the
# regenerating VJP (bayeformers_tpu/ops/fused_linear.py:1561).
ANTI_F32_SAVED_MAX_KP = 2048
def interleave_antithetic(w_half: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """(S/2, K, N) draws -> (S, K, N) antithetic pairs ``(w, 2 mu - w)`` at
    (2t, 2t+1)."""
    pair = torch.stack([w_half, 2.0 * mu[None] - w_half], dim=1)
    return pair.reshape((-1,) + tuple(w_half.shape[1:]))


def naive_from_w(x: torch.Tensor, w: torch.Tensor, mu: torch.Tensor,
                 rho: torch.Tensor, prior: tuple = ON_MU, prior_mu=None):
    """Matmul and both log-probs from materialized weights (counterpart of
    ``_naive_from_w``, by default with the MOPED prior centred on mu). ``w``
    is f32; the dot runs on ``w`` cast to x's dtype, accumulated in f32."""
    wd = w.to(x.dtype)
    y = torch.bmm(x.float(), wd.float()).to(x.dtype)
    sigma = sigma_from_rho(rho)
    eps = (w - mu[None]) / sigma[None]
    logq = torch.sum(
        -LOG_SQRT_2PI - torch.log(sigma)[None] - 0.5 * eps * eps, dim=(1, 2)
    )
    return y, logq, prior_log_prob(w, mu if prior == ON_MU else prior_mu, prior,
                                   dim=(1, 2))


def sample_weights(mu, rho, seeds=None, eps=None, *, antithetic: bool = False
                   ) -> torch.Tensor:
    """The (S, K, N) f32 weights of ``seeds`` on the unit stream, or of an
    explicit ``eps``: one draw per sample, or (``antithetic``) one per pair,
    interleaved as ``(w, 2 mu - w)``. The plain version of the forward
    kernel's W and of :func:`regenerate_weights`: ``mu + sigma * eps`` with
    the product and the sum each rounded, as the kernels round them."""
    w = sampled_linear.naive_weights(mu, rho, seeds, eps)
    return interleave_antithetic(w, mu) if antithetic else w


def regenerate_weights(mu, rho, seeds, *, plain: bool = False) -> torch.Tensor:
    """(S', K, N) f32 weights of ``seeds`` (S',) on the unit stream: exactly
    the W that the forward drew for those seeds (the reference's
    ``regenerate_weights`` / ``_regen``). A CPU tensor, or ``plain=True``,
    takes the plain version (:func:`sample_weights`); a CUDA tensor launches
    ``csrc/regen.cu`` (``bft_regen``, Pallas #10) or raises."""
    if plain or mu.device.type == "cpu":
        return sample_weights(mu, rho, seeds)
    return regenerate_weights_cuda(mu, rho, seeds)


def regenerate_weights_cuda(mu, rho, seeds) -> torch.Tensor:
    """Launch ``bft_regen`` (csrc/regen.cu, shared with the split ops'
    ``sampled_linear.regenerate_weights``), counted in
    :data:`REGEN_LAUNCHES`."""
    return sampled_linear.regen_cuda(mu, rho, seeds, REGEN_LAUNCHES)


class SampledWeights(torch.autograd.Function):
    """The reference's ``sampled_weights`` custom VJP: W from
    :func:`regenerate_weights` (or from an injected ``eps``), and the
    reparametrisation backward ``dmu = sum_s g``, ``drho = sum_s g eps
    sigmoid(rho)`` with ``eps = (W - mu) / sigma`` read back from W."""

    @staticmethod
    def forward(ctx, mu, rho, seeds, eps, plain):
        w = (sample_weights(mu, rho, eps=eps) if eps is not None
             else regenerate_weights(mu, rho, seeds, plain=plain))
        ctx.save_for_backward(mu, rho, w)
        return w

    @staticmethod
    def backward(ctx, g):
        mu, rho, w = ctx.saved_tensors
        sigma = sigma_from_rho(rho)
        eps = (w - mu[None]) / sigma[None]
        dmu = torch.sum(g, dim=0)
        drho = torch.sum(g * eps, dim=0) * torch.sigmoid(rho)
        return dmu, drho, None, None, None


def sampled_weights(mu, rho, seeds, *, plain: bool = False, eps=None):
    """Differentiable (S, K, N) sampled weights with :func:`bayes_linear`'s
    eps stream (the reference's ``sampled_weights``), for weights that flow
    into the loss themselves. ``eps`` (S, K, N) injects the draw (tests)."""
    return SampledWeights.apply(mu, rho, seeds, eps, plain)


def bayes_linear_plain(x, mu, rho, seeds=None, *, antithetic: bool = False,
                       eps=None, w=None, save_weights: bool = False,
                       mixture=None, prior_mu=None):
    """Plain-torch version. The draw is, in order of precedence: an explicit
    (S, K, N) ``w``, an explicit ``eps`` (one per draw: (S, K, N), or
    (S/2, K, N) when ``antithetic``), or the unit stream of ``seeds``;
    ``eps``/``w`` are the injection points for parity tests. The prior is
    ``mixture``, ``prior_mu`` or, with neither, the one centred on mu.
    Returns ``(y, log_q, log_p)``, plus W in x's dtype when
    ``save_weights``."""
    if w is None:
        w = sample_weights(mu, rho, seeds, eps, antithetic=antithetic)
    y, lq, lp = naive_from_w(x, w, mu, rho, prior_of(mixture, prior_mu), prior_mu)
    if save_weights:
        return y, lq, lp, w.to(x.dtype)
    return y, lq, lp


def _forward(x, mu, rho, seeds, eps, antithetic: bool, plain: bool, save_w: bool,
             prior: tuple, prior_mu):
    mixture = prior[1:] if prior[0] == "mixture" else None
    if plain or x.device.type == "cpu":
        return bayes_linear_plain(x, mu, rho, seeds, antithetic=antithetic,
                                  eps=eps, save_weights=save_w, mixture=mixture,
                                  prior_mu=prior_mu)
    common.require(eps is None, "an injected eps runs the plain version only")
    return bayes_linear_cuda(x, mu, rho, seeds, antithetic=antithetic,
                             save_weights=save_w, mixture=mixture,
                             prior_mu=prior_mu)


def _backward(ctx, x, mu, rho, w, prior_mu, g_y, g_q, g_p):
    """The gradients of ``(x, mu, rho, seeds, eps, antithetic, plain, prior,
    prior_mu)`` from the (S, K, N) sampled W, the reference's ``_bwd_common``
    and ``_bwd_common_anti``: dx in x's dtype (W cast to it), the reduce on
    W as given (x's dtype when saved, f32 when regenerated), then
    ``finalize``; no gradient for ``prior_mu``."""
    dx = dmu = drho = None
    if ctx.needs_input_grad[0]:
        dx = torch.bmm(g_y.to(x.dtype), w.to(x.dtype).transpose(1, 2)).to(x.dtype)
    if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
        prior = ctx.prior
        if ctx.antithetic:
            reduce = bwd.reduce_abuv_anti_plain if ctx.plain else bwd.reduce_abuv_anti
        else:
            reduce = bwd.reduce_abuv_plain if ctx.plain else bwd.reduce_abuv
        acc = reduce(x, g_y.to(x.dtype).contiguous(), w, mu, g_p,
                     **reduce_keywords(prior))
        u = acc[2] if len(acc) == 4 else None
        dmu, drho = bwd.finalize(acc[0], acc[1], acc[-1], rho, g_q, u, prior=prior,
                                 mu=mu, prior_mu=prior_mu, g_p=g_p)
    return (dx, dmu if ctx.needs_input_grad[1] else None,
            drho if ctx.needs_input_grad[2] else None) + (None,) * 6


class BayesLinear(torch.autograd.Function):
    """``(y, log_q, log_p)`` with the saved-residual backward: the forward
    keeps ``(x, mu, rho, W, prior_mu)``; ``plain`` runs the plain versions
    of both passes on the tensors' device (the reference for the
    kernels)."""

    @staticmethod
    def forward(ctx, x, mu, rho, seeds, eps, antithetic, plain, prior, prior_mu):
        y, lq, lp, w = _forward(x, mu, rho, seeds, eps, antithetic, plain,
                                True, prior, prior_mu)
        ctx.save_for_backward(x, mu, rho, w, prior_mu)
        ctx.antithetic = antithetic
        ctx.plain = plain
        ctx.prior = prior
        return y, lq, lp

    @staticmethod
    def backward(ctx, g_y, g_q, g_p):
        x, mu, rho, w, prior_mu = ctx.saved_tensors
        return _backward(ctx, x, mu, rho, w, prior_mu, g_y, g_q, g_p)


class BayesLinearRegen(torch.autograd.Function):
    """``(y, log_q, log_p)`` with the regenerating backward: the forward
    writes no W and keeps ``(x, mu, rho, seeds, prior_mu)`` (and an injected
    ``eps``); the backward rebuilds the f32 W of the seeds
    (:func:`regenerate_weights`, kernel #10 on the card) and interleaves
    the pairs, as the reference's ``_bwd`` / ``_bwd_anti`` do; ``plain`` as
    in :class:`BayesLinear`."""

    @staticmethod
    def forward(ctx, x, mu, rho, seeds, eps, antithetic, plain, prior, prior_mu):
        y, lq, lp = _forward(x, mu, rho, seeds, eps, antithetic, plain,
                             False, prior, prior_mu)
        ctx.save_for_backward(x, mu, rho, seeds, eps, prior_mu)
        ctx.antithetic = antithetic
        ctx.plain = plain
        ctx.prior = prior
        return y, lq, lp

    @staticmethod
    def backward(ctx, g_y, g_q, g_p):
        x, mu, rho, seeds, eps, prior_mu = ctx.saved_tensors
        if eps is not None:
            w = sample_weights(mu, rho, eps=eps, antithetic=ctx.antithetic)
        else:
            w = regenerate_weights(mu, rho, seeds, plain=ctx.plain)
            if ctx.antithetic:
                w = interleave_antithetic(w, mu)
        return _backward(ctx, x, mu, rho, w, prior_mu, g_y, g_q, g_p)


def takes_regen_vjp(x, antithetic: bool, save_weights: bool) -> bool:
    """Whether :func:`bayes_linear` differentiates through the regenerating
    VJP: ``save_weights=False``, or the reference's f32 antithetic route.

    The reference sends antithetic layers with f32 x and
    ``round_up(K, 256) > 2048`` to the non-saved VJP even when
    ``save_weights=True`` (bayeformers_tpu/ops/fused_linear.py:1555-1562),
    to dodge a Mosaic crash that CUDA does not have. The port copies the
    route all the same: each layer then takes the reference's VJP, so the
    f32 recipe keeps no (S, 3072, 768) f32 residual in each of its 12 FFN
    down-projections (1.13 GB at S=10), and its backward regenerates those
    pairs with kernel #10, as the reference's does."""
    if not save_weights:
        return True
    kp = common.round_up(x.shape[-1], common.UNIT_K)
    return antithetic and x.dtype == torch.float32 and kp > ANTI_F32_SAVED_MAX_KP


def bayes_linear(x, mu, rho, seeds, *, mixture=None, prior_mu=None,
                 prior_on_mu: bool = False, save_weights: bool = True,
                 antithetic: bool = False, plain: bool = False, eps=None):
    """``(y, log_q, log_p)`` for x (S, M, K), mu/rho (K, N) and ``seeds``
    (S,), or (S/2,) when ``antithetic``; log-probs of shape (S,).

    The reference's signature and defaults; exactly one prior is named:
    ``mixture=(pi, sigma1, sigma2)``, ``prior_mu`` (K, N) f32, or
    ``prior_on_mu=True``. Differentiable: when grad mode is on and x, mu or
    rho requires grad, ``save_weights=True`` runs :class:`BayesLinear`,
    which keeps W for its backward, and ``save_weights=False`` runs
    :class:`BayesLinearRegen`, which writes no W and regenerates it in the
    backward; antithetic f32 layers with a padded K above 2048 take the
    latter either way (:func:`takes_regen_vjp`). Without gradients
    (inference) no W is written. Port keywords: ``plain=True`` runs the
    plain versions on the tensors' device (a CPU tensor always does);
    ``eps`` injects the draw into the plain version (tests)."""
    prior = prior_of(mixture, prior_mu, prior_on_mu)
    if torch.is_grad_enabled() and (x.requires_grad or mu.requires_grad
                                    or rho.requires_grad):
        fn = (BayesLinearRegen if takes_regen_vjp(x, antithetic, save_weights)
              else BayesLinear)
        return fn.apply(x, mu, rho, seeds, eps, antithetic, plain, prior, prior_mu)
    return _forward(x, mu, rho, seeds, eps, antithetic, plain, False, prior,
                    prior_mu)


def bayes_linear_with_w(x, mu, rho, seeds, *, antithetic: bool = False,
                        plain: bool = False, eps=None, mixture=None,
                        prior_mu=None):
    """``(y, log_q, log_p, W)`` without gradients, for checks of the draw:
    :func:`bayes_linear`'s forward under the prior ``mixture``,
    ``prior_mu`` or (neither) the one centred on mu, together with the
    sampled W (S, K, N) in x's dtype, as its saved-residual forward writes
    it."""
    with torch.no_grad():
        return _forward(x, mu, rho, seeds, eps, antithetic, plain, True,
                        prior_of(mixture, prior_mu), prior_mu)


def bayes_linear_cuda(x, mu, rho, seeds, *, antithetic: bool = False,
                      save_weights: bool = False, mixture=None, prior_mu=None,
                      logprob_partials: bool = False):
    """Launch ``bft_bayes_linear`` (independent draws, ``seeds`` (S,)) or
    ``bft_bayes_linear_anti`` (pairs, ``seeds`` (S/2,)), csrc/bayes_linear.cu,
    in its instance for x's dtype and the prior (``mixture``, ``prior_mu``
    or, with neither, the one centred on mu); y and W take x's dtype. The
    launch counters key each launch by ``(M, K, N, tag)``, the tag naming
    the dtype and any prior but the one on mu (``"bf16/mixture"``).
    ``logprob_partials`` also returns the log-prob partial sums before their
    constants, (n_draws, ceil(N / 64), 1 + n_lp) f32: per draw and column
    tile of 64, the sum of ``-eps^2 / 2``, then of the log-prior's terms of
    each member with its own (both of a pair under a prior not centred on
    mu, else one), for checks of terms that the constants drown in f32."""
    req = common.require
    req(x.is_cuda, f"bayes_linear kernel needs a CUDA tensor, got {x.device}")
    tag = common.kernel_dtype(x, "bayes_linear")
    prior = prior_of(mixture, prior_mu)
    req(x.dim() == 3 and mu.dim() == 2, "x must be (S, M, K), mu (K, N)")
    S, M, K = x.shape
    N = mu.shape[1]
    req(mu.shape[0] == K and tuple(rho.shape) == (K, N),
        f"mu/rho {tuple(mu.shape)}/{tuple(rho.shape)} do not match K={K}")
    req(mu.dtype == torch.float32 and rho.dtype == torch.float32,
        "mu and rho must be float32")
    if antithetic:
        req(S % 2 == 0 and tuple(seeds.shape) == (S // 2,),
            f"antithetic needs an even S and S/2 seeds; S={S}, "
            f"seeds {tuple(seeds.shape)}")
    else:
        req(tuple(seeds.shape) == (S,),
            f"independent draws need S seeds; S={S}, seeds {tuple(seeds.shape)}")
    req(seeds.dtype == torch.int32, "seeds must be int32")
    tensors = [("x", x), ("mu", mu), ("rho", rho), ("seeds", seeds)]
    if prior_mu is not None:
        req(tuple(prior_mu.shape) == (K, N) and prior_mu.dtype == torch.float32,
            f"prior_mu must be ({K}, {N}) float32, got {tuple(prior_mu.shape)} "
            f"{prior_mu.dtype}")
        tensors.append(("prior_mu", prior_mu))
    for name, t in tensors:
        req(t.device == x.device, f"{name} is on {t.device}, x on {x.device}")
        req(t.is_contiguous(), f"{name} must be contiguous")
    n_draws = seeds.shape[0]
    req(1 <= n_draws <= 1024, "between 1 and 1024 draws")
    lib = _build.library()
    n_tiles = -(-N // _BN)
    # the partial sums of each draw and column tile: log_q, then one log_p
    # per member that has its own (both members of a pair under a prior not
    # centred on mu)
    n_lp = 2 if antithetic and prior != ON_MU else 1
    y = torch.empty((S, M, N), dtype=x.dtype, device=x.device)
    logq = torch.empty((S,), dtype=torch.float32, device=x.device)
    logp = torch.empty((S,), dtype=torch.float32, device=x.device)
    partials = torch.empty((n_draws, n_tiles, 1 + n_lp), dtype=torch.float32,
                           device=x.device)
    ls_part = torch.empty((n_tiles,), dtype=torch.float32, device=x.device)
    w = (torch.empty((S, K, N), dtype=x.dtype, device=x.device)
         if save_weights else None)
    x_vec = int(K % (16 // x.element_size()) == 0 and x.data_ptr() % 16 == 0)
    n_el = K * N
    c_p = 0.0 if prior[0] == "mixture" else n_el * (
        LOG_SQRT_2PI + math.log(MOPED_PRIOR_SIGMA))
    pi, s1, s2 = prior[1:] if prior[0] == "mixture" else (0.5, 1.0, 1.0)
    name = "bft_bayes_linear_anti" if antithetic else "bft_bayes_linear"
    with torch.cuda.device(x.device):
        err = getattr(lib, name)(
            x.data_ptr(), mu.data_ptr(), rho.data_ptr(), seeds.data_ptr(),
            None if prior_mu is None else prior_mu.data_ptr(),
            y.data_ptr(), None if w is None else w.data_ptr(),
            partials.data_ptr(), ls_part.data_ptr(), logq.data_ptr(),
            logp.data_ptr(), S, M, K, N, x_vec, int(tag == "f32"),
            PRIOR_CODE[prior[0]], 1.0 / MOPED_PRIOR_SIGMA,
            n_el * LOG_SQRT_2PI, c_p, *mixture_constants(pi, s1, s2),
            common.cuda_stream(x),
        )
    _build.check(err, name)
    (LAUNCHES if antithetic else INDEP_LAUNCHES).add(
        (M, K, N, tag + PRIOR_TAG[prior[0]]))
    out = (y, logq, logp) + ((w,) if save_weights else ())
    return out + (partials,) if logprob_partials else out

