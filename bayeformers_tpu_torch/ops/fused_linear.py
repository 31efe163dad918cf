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

``unit_offsets=(k0, n0)`` (the reference's keyword, for tensor
parallelism): the (K, N) weight is the shard at element offsets (k0, n0)
of a larger layer, multiples of (256, 128), and draws exactly that slice of
the whole layer's noise, on every path and in the regenerating backward
too. An injected ``eps`` ignores them.

:func:`bayes_linear` is the wrapper: a CPU tensor takes the plain version
:func:`bayes_linear_plain`; a CUDA tensor launches the hand-written kernels
or raises. On the card the op runs in two stages (:func:`bayes_linear_cuda`):
the draw pass (``csrc/regen.cu``, ``bft_draw``, an instance per pair or
sample, operand type and prior) writes the (S, K, N) W in x's dtype and the
log-prob partial sums, the product (``csrc/bayes_linear.cu``, ``bft_bmm``:
wgmma in bf16, 3xTF32 in f32) takes ``y[s] = x[s] @ W[s]``, and
``bft_draw_finalize`` sums the partials in a fixed order. The plain mirror
of that decomposition is :func:`draw_plain`, :func:`draw_finalize_plain`
and :func:`bmm_plain`.
Under autograd there are the reference's two custom VJPs:

* ``save_weights=True``: :class:`BayesLinear` (``_fwd_saved`` /
  ``_bwd_common`` and their antithetic twins). The forward also writes W in
  x's dtype and the backward reads it.
* ``save_weights=False``: :class:`BayesLinearRegen` (``_fwd`` / ``_bwd`` and
  ``_fwd_anti`` / ``_bwd_anti``). The forward writes no W and keeps
  ``(x, mu, rho, seeds)``; the backward rebuilds the f32 W from the seeds
  in one launch of ``csrc/regen.cu`` (the counterpart of
  ``_fullk_regen_kernel``; :func:`regenerate_weights`): pairs already
  interleaved as ``(w, 2 mu - w)``, and for bf16 x with W's bf16 copy for
  dx written in the same pass.

Both backwards then compute

    dx         = g_y @ W^T               (a batched matmul in x's dtype, as
                                          XLA's einsum, on W in x's dtype)
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
    ON_MU, PRIOR_CODE, PRIOR_NONE, PRIOR_TAG, mixture_constants, mixture_log_pdf,
    prior_log_prob, prior_of, reduce_keywords)

LAUNCHES = common.LaunchCounter("bayes_linear_anti")
INDEP_LAUNCHES = common.LaunchCounter("bayes_linear")
REGEN_LAUNCHES = common.LaunchCounter("regen")
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
    y = bmm_plain(x, w)
    sigma = sigma_from_rho(rho)
    eps = (w - mu[None]) / sigma[None]
    logq = torch.sum(
        -LOG_SQRT_2PI - torch.log(sigma)[None] - 0.5 * eps * eps, dim=(1, 2)
    )
    return y, logq, prior_log_prob(w, mu if prior == ON_MU else prior_mu, prior,
                                   dim=(1, 2))


def sample_weights(mu, rho, seeds=None, eps=None, *, antithetic: bool = False,
                   offsets=None) -> torch.Tensor:
    """The (S, K, N) f32 weights of ``seeds`` on the unit stream at a
    shard's ``offsets`` (k0, n0), or of an explicit ``eps``: one draw per
    sample, or (``antithetic``) one per pair, interleaved as ``(w, 2 mu -
    w)``. The plain version of the forward kernel's W and of
    :func:`regenerate_weights`: ``mu + sigma * eps`` with the product and
    the sum each rounded, as the kernels round them."""
    w = sampled_linear.naive_weights(mu, rho, seeds, eps, offsets)
    return interleave_antithetic(w, mu) if antithetic else w


def regenerate_weights(mu, rho, seeds, *, antithetic: bool = False, offsets=None,
                       plain: bool = False) -> torch.Tensor:
    """(S, K, N) f32 weights of ``seeds`` (S',) on the unit stream at a
    shard's ``offsets``: exactly the W that the forward drew for those
    seeds (the reference's ``regenerate_weights`` / ``_regen``), S = S'
    draws, or with ``antithetic`` S = 2 S' members, the pairs interleaved
    (``_regen_anti``). A CPU tensor, or ``plain=True``, takes the plain
    version (:func:`sample_weights`); a CUDA tensor launches
    ``csrc/regen.cu`` (``bft_regen``, Pallas #10) or raises."""
    if plain or mu.device.type == "cpu":
        return sample_weights(mu, rho, seeds, antithetic=antithetic, offsets=offsets)
    return regenerate_weights_cuda(mu, rho, seeds, antithetic=antithetic, offsets=offsets)


def regenerate_weights_cuda(mu, rho, seeds, *, antithetic: bool = False, offsets=None,
                            lo_dtype=None):
    """Launch ``bft_regen`` (csrc/regen.cu, shared with the split ops'
    ``sampled_linear.regenerate_weights``) in its pair instance when
    ``antithetic``, counted in :data:`REGEN_LAUNCHES`; ``lo_dtype=
    torch.bfloat16`` also returns W's bf16 copy, ``(w, w_bf16)``."""
    return sampled_linear.regen_cuda(mu, rho, seeds, REGEN_LAUNCHES, lo_dtype,
                                     pair=antithetic, offsets=offsets)


class SampledWeights(torch.autograd.Function):
    """The reference's ``sampled_weights`` custom VJP: W from
    :func:`regenerate_weights` (or from an injected ``eps``), pairs
    interleaved as ``(w, 2 mu - w)`` when antithetic, and the
    reparametrisation backward ``dmu = sum_s g``, ``drho = sum_s g eps
    sigmoid(rho)`` with each member's ``eps = (W - mu) / sigma`` read back
    from W (a pair's second member reads ``-eps``, the gradient that the
    reference's ``interleave_antithetic`` of the first members carries)."""

    @staticmethod
    def forward(ctx, mu, rho, seeds, eps, antithetic, plain):
        w = (sample_weights(mu, rho, eps=eps, antithetic=antithetic) if eps is not None
             else regenerate_weights(mu, rho, seeds, antithetic=antithetic, plain=plain))
        ctx.save_for_backward(mu, rho, w)
        return w

    @staticmethod
    def backward(ctx, g):
        mu, rho, w = ctx.saved_tensors
        sigma = sigma_from_rho(rho)
        eps = (w - mu[None]) / sigma[None]
        dmu = torch.sum(g, dim=0)
        drho = torch.sum(g * eps, dim=0) * torch.sigmoid(rho)
        return dmu, drho, None, None, None, None


def sampled_weights(mu, rho, seeds, *, antithetic: bool = False, plain: bool = False,
                    eps=None):
    """Differentiable (S, K, N) sampled weights with :func:`bayes_linear`'s
    eps stream (the reference's ``sampled_weights``), for weights that flow
    into the loss themselves (a converted embedding table): one draw per
    seed, or with ``antithetic`` the pairs of ``seeds`` (S/2,) interleaved,
    which the reference forms by ``interleave_antithetic`` of its draws and
    the card writes in one launch of #10's pair instance. ``eps`` (one a
    draw, (S or S/2, K, N)) injects the draw (tests)."""
    return SampledWeights.apply(mu, rho, seeds, eps, antithetic, plain)


def bayes_linear_plain(x, mu, rho, seeds=None, *, antithetic: bool = False,
                       eps=None, w=None, save_weights: bool = False,
                       mixture=None, prior_mu=None, unit_offsets=None):
    """Plain-torch version. The draw is, in order of precedence: an explicit
    (S, K, N) ``w``, an explicit ``eps`` (one per draw: (S, K, N), or
    (S/2, K, N) when ``antithetic``), or the unit stream of ``seeds`` at
    ``unit_offsets``; ``eps``/``w`` are the injection points for parity
    tests. The prior is ``mixture``, ``prior_mu`` or, with neither, the one
    centred on mu. Returns ``(y, log_q, log_p)``, plus W in x's dtype when
    ``save_weights``. A drawn W of many elements is drawn and used in
    chunks of draws and of columns (:func:`common.chunk_len`,
    :func:`common.chunk_cols`), each as the whole is, the log-probs summed
    over the column blocks."""
    if w is None and eps is None:
        h = 2 if antithetic else 1
        K, N = mu.shape
        c = common.chunk_len(len(seeds), h * mu.numel())
        nc = common.chunk_cols(K, N, h)  # one draw's columns, where it alone is over
        if c < len(seeds) or nc < N:
            k0, n0 = common.unit_offsets(unit_offsets)
            y = lq = lp = wx = None  # each output whole, filled a chunk at a time
            for i in range(0, len(seeds), c):
                rows = slice(h * i, h * (i + c))
                for j in range(0, N, nc):
                    cols = slice(j, j + nc)
                    part = bayes_linear_plain(
                        x[rows], mu[:, cols], rho[:, cols], seeds[i:i + c],
                        antithetic=antithetic, save_weights=save_weights, mixture=mixture,
                        prior_mu=None if prior_mu is None else prior_mu[:, cols],
                        unit_offsets=(k0, n0 + j))
                    if y is None:
                        y = part[0].new_empty(x.shape[:2] + (N,))
                        lq, lp = (t.new_zeros((x.shape[0],)) for t in part[1:3])
                        wx = part[3].new_empty((x.shape[0], K, N)) if save_weights else None
                    y[rows, :, cols] = part[0]
                    lq[rows] += part[1]  # the log-probs sum over the column blocks
                    lp[rows] += part[2]
                    if save_weights:
                        wx[rows, :, cols] = part[3]
                    del part
            return (y, lq, lp) + ((wx,) if save_weights else ())
    if w is None:
        w = sample_weights(mu, rho, seeds, eps, antithetic=antithetic,
                           offsets=unit_offsets)
    y, lq, lp = naive_from_w(x, w, mu, rho, prior_of(mixture, prior_mu), prior_mu)
    if save_weights:
        return y, lq, lp, w.to(x.dtype)
    return y, lq, lp


def _forward(x, mu, rho, seeds, eps, antithetic: bool, plain: bool, save_w: bool,
             prior: tuple, prior_mu, offsets):
    mixture = prior[1:] if prior[0] == "mixture" else None
    if plain or x.device.type == "cpu":
        return bayes_linear_plain(x, mu, rho, seeds, antithetic=antithetic,
                                  eps=eps, save_weights=save_w, mixture=mixture,
                                  prior_mu=prior_mu, unit_offsets=offsets)
    common.require(eps is None, "an injected eps runs the plain version only")
    return bayes_linear_cuda(x, mu, rho, seeds, antithetic=antithetic,
                             save_weights=save_w, mixture=mixture,
                             prior_mu=prior_mu, unit_offsets=offsets)


def _backward(ctx, x, mu, rho, w, prior_mu, g_y, g_q, g_p, w_x=None):
    """The gradients of ``(x, mu, rho, seeds, eps, antithetic, plain, prior,
    prior_mu, offsets)`` from the (S, K, N) sampled W, the reference's
    ``_bwd_common`` and ``_bwd_common_anti``: dx in x's dtype on ``w_x``
    (W in x's dtype; W cast to it when not given), the reduce on W as given
    (x's dtype when saved, f32 when regenerated), then ``finalize``; no
    gradient for ``prior_mu``."""
    dx = dmu = drho = None
    if ctx.needs_input_grad[0]:
        if w_x is None:
            w_x = w.to(x.dtype)
        dx = torch.bmm(g_y.to(x.dtype), w_x.transpose(1, 2)).to(x.dtype)
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
            drho if ctx.needs_input_grad[2] else None) + (None,) * 7


class BayesLinear(torch.autograd.Function):
    """``(y, log_q, log_p)`` with the saved-residual backward: the forward
    keeps ``(x, mu, rho, W, prior_mu)``; ``plain`` runs the plain versions
    of both passes on the tensors' device (the reference for the
    kernels)."""

    @staticmethod
    def forward(ctx, x, mu, rho, seeds, eps, antithetic, plain, prior, prior_mu, offsets):
        y, lq, lp, w = _forward(x, mu, rho, seeds, eps, antithetic, plain,
                                True, prior, prior_mu, offsets)
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
    ``eps``) and the offsets; the backward rebuilds the f32 W of the seeds
    at those offsets, the pairs interleaved, as the reference's ``_bwd`` /
    ``_bwd_anti`` do: on the card in one launch of kernel #10
    (:func:`regenerate_weights_cuda`), which for bf16 x also writes the
    bf16 copy that dx takes; ``plain`` as in :class:`BayesLinear`."""

    @staticmethod
    def forward(ctx, x, mu, rho, seeds, eps, antithetic, plain, prior, prior_mu, offsets):
        y, lq, lp = _forward(x, mu, rho, seeds, eps, antithetic, plain,
                             False, prior, prior_mu, offsets)
        ctx.save_for_backward(x, mu, rho, seeds, eps, prior_mu)
        ctx.antithetic = antithetic
        ctx.plain = plain
        ctx.prior = prior
        ctx.offsets = offsets
        return y, lq, lp

    @staticmethod
    def backward(ctx, g_y, g_q, g_p):
        x, mu, rho, seeds, eps, prior_mu = ctx.saved_tensors
        w_x = None
        if eps is not None:
            w = sample_weights(mu, rho, eps=eps, antithetic=ctx.antithetic)
        elif ctx.plain or mu.device.type == "cpu":
            w = regenerate_weights(mu, rho, seeds, antithetic=ctx.antithetic,
                                   offsets=ctx.offsets, plain=True)
        else:
            w = regenerate_weights_cuda(
                mu, rho, seeds, antithetic=ctx.antithetic, offsets=ctx.offsets,
                lo_dtype=None if x.dtype == torch.float32 else x.dtype)
            if x.dtype != torch.float32:
                w, w_x = w
        return _backward(ctx, x, mu, rho, w, prior_mu, g_y, g_q, g_p, w_x)


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
                 antithetic: bool = False, unit_offsets=None, plain: bool = False,
                 eps=None):
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
    (inference) no W is written. ``unit_offsets`` (k0, n0): the element
    offsets of this weight shard within the whole layer, multiples of (256,
    128), else ValueError; the shard draws exactly that slice of the whole
    layer's noise (the reference's tensor-parallel keyword). Port keywords:
    ``plain=True`` runs the plain versions on the tensors' device (a CPU
    tensor always does); ``eps`` injects the draw into the plain version
    (tests), which then ignores the offsets."""
    prior = prior_of(mixture, prior_mu, prior_on_mu)
    offsets = common.unit_offsets(unit_offsets)
    if torch.is_grad_enabled() and (x.requires_grad or mu.requires_grad
                                    or rho.requires_grad):
        fn = (BayesLinearRegen if takes_regen_vjp(x, antithetic, save_weights)
              else BayesLinear)
        return fn.apply(x, mu, rho, seeds, eps, antithetic, plain, prior, prior_mu,
                        offsets)
    return _forward(x, mu, rho, seeds, eps, antithetic, plain, False, prior,
                    prior_mu, offsets)


def bayes_linear_with_w(x, mu, rho, seeds, *, antithetic: bool = False,
                        plain: bool = False, eps=None, mixture=None,
                        prior_mu=None, unit_offsets=None):
    """``(y, log_q, log_p, W)`` without gradients, for checks of the draw:
    :func:`bayes_linear`'s forward under the prior ``mixture``,
    ``prior_mu`` or (neither) the one centred on mu, at ``unit_offsets``,
    together with the sampled W (S, K, N) in x's dtype, as its
    saved-residual forward writes it."""
    with torch.no_grad():
        return _forward(x, mu, rho, seeds, eps, antithetic, plain, True,
                        prior_of(mixture, prior_mu), prior_mu,
                        common.unit_offsets(unit_offsets))


# The draw pass's log-prob partials (csrc/regen.cu): a column tile of 64 (a
# half warp's columns) and a row group of 8 unit rows (16 weight rows), 16
# groups to a 256-row unit.
DRAW_TILE_N = 64
DRAW_GROUP_ROWS = 8
# Serving writes W only for the product: a W of more bytes than this is
# drawn and multiplied in chunks of draws (LLaMA's 768 -> 32000 lm_head at
# S = 10 would take 0.49 GB in bf16).
DRAW_CHUNK_BYTES = 128 << 20


def draw_layout(K: int, N: int) -> tuple[int, int]:
    """(column tiles, row groups) of the draw pass's log-prob partials."""
    n_groups = -(-K // common.UNIT_K) * (common.UNIT_K // 2 // DRAW_GROUP_ROWS)
    return -(-N // DRAW_TILE_N), n_groups


def _block_rows(K: int) -> torch.Tensor:
    """(n_groups, 16) the weight rows of each row group of the draw pass: 8
    unit rows r and their sin-branch twins r + 128 (-1 past K)."""
    half = common.UNIT_K // 2
    n_groups = draw_layout(K, 1)[1]
    g = torch.arange(n_groups)[:, None]
    r = (g % (half // DRAW_GROUP_ROWS)) * DRAW_GROUP_ROWS + torch.arange(DRAW_GROUP_ROWS)[None]
    base = (g // (half // DRAW_GROUP_ROWS)) * common.UNIT_K + r
    rows = torch.cat([base, base + half], dim=1)
    return torch.where(rows < K, rows, torch.full_like(rows, -1))


def draw_plain(mu, rho, seeds=None, *, antithetic: bool = False, eps=None,
               dtype=torch.float32, mixture=None, prior_mu=None, offsets=None):
    """Plain mirror of the draw pass (``bft_draw``) at a shard's unit
    ``offsets``: ``(W, partials, ls_part)`` with W (S, K, N) in ``dtype``
    (pairs interleaved), partials (n_draws, n_tiles, n_groups, 1 + n_lp)
    f32 the per-block sums of ``-eps^2 / 2`` and of each member's log-prior
    terms (both members of a pair under a prior not centred on mu), and
    ls_part (n_tiles, n_groups) the sums of log sigma, each block a
    64-column tile of a row group (:func:`draw_layout`). Sums in f32 in
    torch's order, not the kernel's."""
    prior = prior_of(mixture, prior_mu)
    K, N = mu.shape
    if eps is None:
        eps = common.unit_eps(seeds, (K, N), common.unit_offsets(offsets))
    sigma = sigma_from_rho(rho)
    se = sigma[None] * eps
    w0 = mu[None] + se
    members = [w0]
    if antithetic:
        members.append(2.0 * mu[None] - w0)
    own = antithetic and prior != ON_MU
    terms = [-0.5 * eps * eps]
    for w in members[: 2 if own else 1]:
        if prior == ON_MU:
            terms.append(-0.5 * (se / MOPED_PRIOR_SIGMA) ** 2)
        elif prior[0] == "gaussian":
            terms.append(-0.5 * ((w - prior_mu[None]) / MOPED_PRIOR_SIGMA) ** 2)
        else:
            terms.append(mixture_log_pdf(w, *prior[1:]))
    n_tiles, n_groups = draw_layout(K, N)
    rows = _block_rows(K)

    def block_sums(t):  # (..., K, N) -> (..., n_tiles, n_groups)
        t = torch.nn.functional.pad(t, (0, n_tiles * DRAW_TILE_N - N))
        t = torch.cat([t, torch.zeros_like(t[..., :1, :])], dim=-2)  # row -1: zeros
        t = t[..., rows, :]  # (..., n_groups, 16, n_tiles * 64)
        t = t.reshape(t.shape[:-1] + (n_tiles, DRAW_TILE_N)).sum(dim=(-3, -1))
        return t.transpose(-1, -2)

    partials = torch.stack([block_sums(t) for t in terms], dim=-1)
    ls_part = block_sums(torch.log(sigma))
    w = torch.stack(members, dim=1).reshape((-1, K, N)) if antithetic else w0
    return w.to(dtype), partials, ls_part


def draw_finalize_plain(partials, ls_part, K: int, N: int, antithetic: bool,
                        prior: tuple):
    """Plain mirror of ``bft_draw_finalize``: ``(tile_part, log_q, log_p)``,
    the row groups of each column tile summed in order, then the tiles in
    order, less the constants (:func:`bayes_linear_cuda`)."""
    n_draws, n_tiles, n_groups, n_part = partials.shape
    tile_part = torch.zeros((n_draws, n_tiles, n_part), dtype=torch.float32)
    for g in range(n_groups):
        tile_part = tile_part + partials[:, :, g]
    ls = torch.zeros((), dtype=torch.float32)
    q = torch.zeros((n_draws,), dtype=torch.float32)
    p = torch.zeros((n_draws, n_part - 1), dtype=torch.float32)
    for i in range(n_tiles):
        lt = torch.zeros((), dtype=torch.float32)
        for g in range(n_groups):
            lt = lt + ls_part[i, g]
        ls = ls + lt
        q = q + tile_part[:, i, 0]
        p = p + tile_part[:, i, 1:]
    c_q, c_p = _constants(K, N, prior)
    lq = q - ls - c_q
    lp = p - c_p
    h = 2 if antithetic else 1
    lp = lp.reshape(-1) if n_part == 3 else lp[:, 0].repeat_interleave(h)
    return tile_part, lq.repeat_interleave(h), lp


def bmm_plain(x, w):
    """Plain mirror of the product (``bft_bmm``): ``x[s] @ W[s]`` with W in
    x's dtype, f32 accumulation, y in x's dtype."""
    return torch.bmm(x.float(), w.to(x.dtype).float()).to(x.dtype)


def _constants(K: int, N: int, prior: tuple) -> tuple[float, float]:
    """The log-probs' constants: K N log sqrt(2 pi) for log_q; for log_p K N
    (log sqrt(2 pi) + log sigma_p) under the Gaussian priors and 0 under
    the mixture, whose log-density carries its own."""
    n_el = K * N
    c_p = 0.0 if prior[0] == "mixture" else n_el * (LOG_SQRT_2PI + math.log(MOPED_PRIOR_SIGMA))
    return n_el * LOG_SQRT_2PI, c_p


def launch_forward(x, mu, rho, seeds, y, w, chunk: int, *, pair: bool, prior: tuple,
                   prior_mu=None, scratch=None, part_per_draw: int = 0, logq=None,
                   logp=None, offsets=None) -> None:
    """Launch ``bft_bayes_linear`` (csrc/bayes_linear.cu): the draw pass
    (``bft_draw``, csrc/regen.cu) at a shard's unit ``offsets`` and the
    product (``bft_bmm``) for each chunk of ``chunk`` draws in turn into
    ``w`` (H chunk, K, ldw), y in place, then, under a prior, the
    log-probs' finalize from ``scratch`` = the device addresses of
    (partials, ``part_per_draw`` floats a draw, ls_part, tile_part) into
    ``logq`` / ``logp``. A prior of ``("none",)`` draws and multiplies
    only."""
    k0, n0 = common.unit_offsets(offsets)
    S, M, K = x.shape
    N = mu.shape[1]
    if x.dtype == torch.bfloat16:
        x, ldx = common.tma_rows(x)
        x_vec = 1
    else:
        ldx = K
        x_vec = int(K % 4 == 0 and x.data_ptr() % 16 == 0)
    pi, s1, s2 = prior[1:] if prior[0] == "mixture" else (0.5, 1.0, 1.0)
    c_q, c_p = _constants(K, N, prior) if prior[0] != "none" else (0.0, 0.0)
    err = _build.library().bft_bayes_linear(
        x.data_ptr(), mu.data_ptr(), rho.data_ptr(), seeds.data_ptr(),
        None if prior_mu is None else prior_mu.data_ptr(), y.data_ptr(), w.data_ptr(),
        *(scratch or (None,) * 3), None if logq is None else logq.data_ptr(),
        None if logp is None else logp.data_ptr(), S, M, K, N, ldx, w.shape[-1], chunk,
        part_per_draw, int(pair),
        int(x.dtype == torch.float32), x_vec, PRIOR_CODE.get(prior[0], PRIOR_NONE),
        k0 // common.UNIT_K, n0 // common.UNIT_N, 1.0 / MOPED_PRIOR_SIGMA, c_q, c_p,
        *mixture_constants(pi, s1, s2), common.cuda_stream(x))
    _build.check(err, "bft_bayes_linear")


def bayes_linear_cuda(x, mu, rho, seeds, *, antithetic: bool = False,
                      save_weights: bool = False, mixture=None, prior_mu=None,
                      logprob_partials: bool = False, unit_offsets=None):
    """Launch the draw pass, the product and the log-probs' finalize on the
    card (independent draws, ``seeds`` (S,), or pairs, ``seeds`` (S/2,)),
    each in its instance for x's dtype and the prior (``mixture``,
    ``prior_mu`` or, with neither, the one centred on mu), drawing at the
    shard's ``unit_offsets``; y and W take x's dtype. The launch counters
    key each call by ``(M, K, N, tag)``, the tag naming the dtype and any
    prior but the one on mu (``"bf16/mixture"``).
    Without ``save_weights`` a W of more than :data:`DRAW_CHUNK_BYTES` is
    drawn and multiplied in chunks of draws. ``logprob_partials`` also
    returns the log-prob partial sums before their constants,
    (n_draws, ceil(N / 64), 1 + n_lp) f32: per draw and column tile of 64,
    the sum of ``-eps^2 / 2``, then of the log-prior's terms of each member
    with its own (both of a pair under a prior not centred on mu, else
    one), for checks of terms that the constants drown in f32."""
    req = common.require
    req(x.is_cuda, "bayes_linear kernel needs a CUDA tensor, got {}", x.device)
    tag = common.kernel_dtype(x, "bayes_linear")
    prior = prior_of(mixture, prior_mu)
    req(x.dim() == 3 and mu.dim() == 2, "x must be (S, M, K), mu (K, N)")
    S, M, K = x.shape
    N = mu.shape[1]
    req(mu.shape[0] == K and rho.shape == mu.shape,
        "mu/rho {}/{} do not match K={}", tuple(mu.shape), tuple(rho.shape), K)
    req(mu.dtype == torch.float32 and rho.dtype == torch.float32,
        "mu and rho must be float32")
    n_draws = S // 2 if antithetic else S
    req(seeds.shape == (n_draws,) and (S % 2 == 0 or not antithetic),
        "S={} samples ({}) need ({},) seeds, got {}", S,
        "antithetic pairs" if antithetic else "independent draws", n_draws,
        tuple(seeds.shape))
    req(seeds.dtype == torch.int32, "seeds must be int32")
    tensors = (x, mu, rho, seeds) if prior_mu is None else (x, mu, rho, seeds, prior_mu)
    if prior_mu is not None:
        req(prior_mu.shape == mu.shape and prior_mu.dtype == torch.float32,
            "prior_mu must be ({}, {}) float32, got {} {}", K, N,
            tuple(prior_mu.shape), prior_mu.dtype)
    dev = x.device
    for name, t in zip(("x", "mu", "rho", "seeds", "prior_mu"), tensors):
        req(t.device == dev, "{} is on {}, x on {}", name, t.device, dev)
        req(t.is_contiguous(), "{} must be contiguous", name)
    req(1 <= n_draws <= 1024, "between 1 and 1024 draws")
    h = 2 if antithetic else 1
    n_tiles, n_groups = draw_layout(K, N)
    # the partial sums of each draw and block: log_q, then one log_p per
    # member that has its own (both members of a pair under a prior not
    # centred on mu)
    n_part = 1 + (2 if antithetic and prior != ON_MU else 1)
    ldw = common.round_up(N, 16 // x.element_size())
    per_draw = h * K * ldw * x.element_size()
    chunk = n_draws if save_weights else max(1, min(n_draws, DRAW_CHUNK_BYTES // per_draw))
    # log_q, log_p and the partial sums in one f32 buffer: an allocation
    # costs the host about as much as a small layer's kernels take on the
    # card (y and W stay apart, so that y does not keep W alive)
    y = x.new_empty((S, M, N))
    w = x.new_empty((h * chunk, K, ldw))
    n_p, n_ls = n_draws * n_tiles * n_groups * n_part, n_tiles * n_groups
    f32 = mu.new_empty(2 * S + n_p + n_ls + n_draws * n_tiles * n_part)
    logq, logp = f32[:S], f32[S:2 * S]
    base = f32.data_ptr() + 8 * S
    scratch = (base, base + 4 * n_p, base + 4 * (n_p + n_ls))
    with common.on_device(x):
        launch_forward(x, mu, rho, seeds, y, w, chunk, pair=antithetic, prior=prior,
                       prior_mu=prior_mu, scratch=scratch,
                       part_per_draw=n_tiles * n_groups * n_part, logq=logq, logp=logp,
                       offsets=unit_offsets)
    (LAUNCHES if antithetic else INDEP_LAUNCHES).add(
        (M, K, N, tag + PRIOR_TAG[prior[0]]))
    out = (y, logq, logp)
    if save_weights:
        out += (w if ldw == N else w[..., :N].contiguous(),)
    if logprob_partials:
        out += (f32[2 * S + n_p + n_ls:].view(n_draws, n_tiles, n_part),)
    return out
