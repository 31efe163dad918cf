"""The Bayesian linear op's priors: which one a call names, its log-density
and, for the scale mixture, its score (counterpart of
``bayeformers_tpu/ops/logprob.py::_mixture_log_pdf`` and
``_mixture_score``, and of the prior tuples of
``bayeformers_tpu/ops/fused_linear.py:1541-1548``).

A prior is a tuple: :data:`ON_MU` (the MOPED Gaussian centred on mu
itself, frozen MOPED), :data:`GAUSSIAN` (the MOPED Gaussian centred on a
separate ``prior_mu``) or ``("mixture", pi, sigma1, sigma2)``. The forward
resolves it from its keywords (:func:`prior_of`), the reduce from the
reference's ``(mixture, want_u)`` (:func:`reduce_prior`), and both kernels
take its code (:data:`PRIOR_CODE`, ``csrc/prior.cuh``); the launch
counters tag each instance with :data:`PRIOR_TAG`.

The prior is ``pi N(0, s1^2) + (1 - pi) N(0, s2^2)`` (the reference's
``DEFAULT_SCALED_GAUSSIAN_MIXTURE``: 0.5, e^0, e^-6). Its log-density is
taken as ``logaddexp`` of the two weighted component log-densities, which
stays finite where a component's pdf underflows (at |w| = 0.2 the narrow
component's exponent is about -3,000); the score ``d/dw log p(w)`` weighs
each component's ``-w / s^2`` by its responsibility. The forward and
reduce kernels (``csrc/bayes_linear.cu``, ``csrc/fused_backward.cu``)
evaluate the same expressions; these are their plain versions' terms.

The module also holds the split op :func:`sampled_logprobs` (the
reference's ``sampled_logprobs`` with its two custom VJPs): per draw of a
(K, N) weight, log_q and log_p under the Gaussian on ``prior_mu`` or the
mixture. It is a group of one leaf of :func:`sampled_logprobs_grouped`,
which on the card takes every leaf of a group in one launch of
``csrc/logprob.cu`` (``bft_logprob``, Pallas #11, ``_logprob_kernel``),
and their VJP in one more (``bft_logprob_vjp``: the draws rebuilt in
registers, where the reference rebuilds W by Pallas #13). Flipout and
local reparameterization score the mixture's KL of all their kernel leaves
with one grouped call a forward (``nn/flipout.py::AnalyticKLMC``).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from bayeformers_tpu_torch.core.distributions import LOG_SQRT_2PI, sigma_from_rho
from bayeformers_tpu_torch.core.prior import MOPED_PRIOR_SIGMA, moped_prior_log_prob
from bayeformers_tpu_torch.ops import _build, common, sampled_linear

ON_MU = ("gaussian_on_mu",)
GAUSSIAN = ("gaussian",)
# The kernels' codes of the priors (csrc/prior.cuh::Prior), and the launch
# counters' tag suffix of each
PRIOR_CODE = {"gaussian_on_mu": 0, "gaussian": 1, "mixture": 2}
PRIOR_NONE = 3  # no prior and no log-probs: the split op's sampled matmul
PRIOR_TAG = {"gaussian_on_mu": "", "gaussian": "/gaussian", "mixture": "/mixture"}


def prior_of(mixture=None, prior_mu=None, prior_on_mu=None) -> tuple:
    """The prior tuple of the forward's keywords: exactly one of
    ``mixture`` (``(pi, sigma1, sigma2)``), ``prior_mu`` or
    ``prior_on_mu``, as the reference resolves them. ``prior_on_mu=None``
    (the port's plain and kernel entry points) means the prior on mu when
    neither of the others is given."""
    if prior_on_mu is None:
        prior_on_mu = mixture is None and prior_mu is None
    given = (mixture is not None) + (prior_mu is not None) + bool(prior_on_mu)
    if given != 1:
        raise ValueError(
            "pass exactly one of `mixture`, `prior_mu`, `prior_on_mu`")
    if prior_on_mu:
        return ON_MU
    if prior_mu is not None:
        return GAUSSIAN
    return ("mixture",) + tuple(float(v) for v in mixture)


def reduce_keywords(prior: tuple) -> dict:
    """The reduce's keywords for a prior: its mixture, and ``want_u``, on
    for every prior but the one on mu (the reference's rule,
    ``fused_linear.py:1287`` and ``:1403``)."""
    return {"mixture": prior[1:] if prior[0] == "mixture" else None,
            "want_u": prior != ON_MU}


def reduce_prior(mixture=None, want_u: bool = False) -> tuple:
    """The prior tuple of the reduce's keywords, the inverse of
    :func:`reduce_keywords`; the mixture needs ``want_u`` (its U is the
    score sum)."""
    if mixture is None:
        return GAUSSIAN if want_u else ON_MU
    if not want_u:
        raise ValueError("the mixture prior's reduce needs want_u=True: its "
                         "score sum is U")
    return ("mixture",) + tuple(float(v) for v in mixture)


def prior_log_prob(w: torch.Tensor, centre, prior: tuple, dim) -> torch.Tensor:
    """The log-prior of ``w`` summed over ``dim``: the MOPED Gaussian centred
    on ``centre`` (mu or prior_mu, broadcast against ``w``) or the
    mixture (``centre`` unread)."""
    if prior[0] == "mixture":
        return torch.sum(mixture_log_pdf(w, *prior[1:]), dim=dim)
    return moped_prior_log_prob(w, centre, dim=dim)


def _component_logs(w, pi: float, s1: float, s2: float):
    a1 = math.log(pi) + (-LOG_SQRT_2PI - math.log(s1) - 0.5 * (w / s1) ** 2)
    a2 = math.log1p(-pi) + (-LOG_SQRT_2PI - math.log(s2) - 0.5 * (w / s2) ** 2)
    return a1, a2


def mixture_log_pdf(w: torch.Tensor, pi: float, s1: float, s2: float) -> torch.Tensor:
    """Elementwise ``log(pi N(w; 0, s1^2) + (1 - pi) N(w; 0, s2^2))``."""
    return torch.logaddexp(*_component_logs(w, pi, s1, s2))


def mixture_score(w: torch.Tensor, pi: float, s1: float, s2: float) -> torch.Tensor:
    """Elementwise ``d/dw`` of :func:`mixture_log_pdf`, with normalised
    responsibilities ``r1 = exp(a1 - logaddexp(a1, a2))``."""
    a1, a2 = _component_logs(w, pi, s1, s2)
    r1 = torch.exp(a1 - torch.logaddexp(a1, a2))
    return -w * (r1 / s1 ** 2 + (1.0 - r1) / s2 ** 2)


def mixture_constants(pi: float, s1: float, s2: float) -> tuple[float, ...]:
    """The kernels' mixture terms: each component's log weight with its
    normaliser, ``log(pi) - log sqrt(2 pi) - log s1`` and ``log(1 - pi) -
    log sqrt(2 pi) - log s2``, then the inverse scales ``1 / s1``,
    ``1 / s2``."""
    return (math.log(pi) - LOG_SQRT_2PI - math.log(s1),
            math.log1p(-pi) - LOG_SQRT_2PI - math.log(s2), 1.0 / s1, 1.0 / s2)


# ---------------------------------------------------------------------------
# The split op: per-draw log-probs of sampled weights (Pallas #11) and
# their VJP, for a group of leaves at once
# ---------------------------------------------------------------------------

LAUNCHES = common.LaunchCounter("logprob")
VJP_LAUNCHES = common.LaunchCounter("logprob_vjp")
# quads (the four elements of one Philox call) a block of csrc/logprob.cu
# covers: QUADS * THREADS there
_LOGPROB_BLOCK_QUADS = 8 * 256
# the leaves and draws one grouped launch takes (csrc/logprob.cu: CAP_LARGE,
# MAX_DRAWS)
MAX_LEAVES, MAX_DRAWS = 576, 1024


def logprob_blocks(K: int, N: int) -> int:
    """The blocks of a (K, N) leaf in ``csrc/logprob.cu``: block b of the
    leaf takes quads ``[b, b + 1) * 2048`` in the order (unit row chunk, row
    of the cos half, column pair); see :func:`logprob_block_of`."""
    quads = -(-K // common.UNIT_K) * (common.UNIT_K // 2) * (-(-N // 2))
    return -(-quads // _LOGPROB_BLOCK_QUADS)


def logprob_block_of(K: int, N: int, device=None) -> torch.Tensor:
    """(K, N) int64: the block of its leaf (counted from the leaf's first
    block, :class:`LeafSpan`) that sums each element in ``csrc/logprob.cu``
    (the layout of its partials, for checks against plain f64 sums)."""
    k = torch.arange(K, device=device)[:, None]
    n = torch.arange(N, device=device)[None, :]
    half = common.UNIT_K // 2
    quad = ((k // common.UNIT_K) * half + (k % common.UNIT_K) % half) * (-(-N // 2)) + n // 2
    return quad // _LOGPROB_BLOCK_QUADS


class LeafSpan(NamedTuple):
    """A leaf's place in a grouped launch: its (K, N), its blocks
    ``[first_block, first_block + n_blocks)`` of the grid (and of the
    partials' columns), and ``offset``, its first element in the VJP's flat
    dmu and drho."""
    K: int
    N: int
    first_block: int
    n_blocks: int
    offset: int


def grouped_layout(shapes) -> list[LeafSpan]:
    """The grouped kernels' layout of leaves of ``shapes`` [(K, N), ...]:
    the leaves' blocks and elements one after the other, in order."""
    spans, block, offset = [], 0, 0
    for K, N in shapes:
        n_blocks = logprob_blocks(K, N)
        spans.append(LeafSpan(K, N, block, n_blocks, offset))
        block += n_blocks
        offset += K * N
    return spans


def leaf_table(spans, mus, rhos, seeds, prior_mus=None) -> np.ndarray:
    """The kernels' leaf table (``csrc/logprob.cu::Leaf``, 56 bytes a leaf):
    per leaf the addresses of mu, rho, prior_mu (0 without one) and the
    seeds, the element offset, then K, N and first_block, n_blocks as pairs
    of int32."""
    pms = prior_mus if prior_mus is not None else [None] * len(spans)
    rows = [(mu.data_ptr(), rho.data_ptr(), 0 if pm is None else pm.data_ptr(),
             sd.data_ptr(), sp.offset, sp.K | sp.N << 32,
             sp.first_block | sp.n_blocks << 32)
            for sp, mu, rho, pm, sd in zip(spans, mus, rhos, pms, seeds)]
    return np.asarray(rows, dtype=np.int64)


def logprobs_plain(mu, rho, seeds=None, prior: tuple = GAUSSIAN, prior_mu=None,
                   eps=None):
    """The plain (S,) ``(log_q, log_p)`` of the reference's
    ``_naive_logprobs``: W from the unit stream of ``seeds`` or from an
    injected ``eps`` (S, K, N), eps read back from W."""
    w = sampled_linear.naive_weights(mu, rho, seeds, eps)
    sigma = sigma_from_rho(rho)
    e = (w - mu[None]) / sigma[None]
    logq = torch.sum(-LOG_SQRT_2PI - torch.log(sigma)[None] - 0.5 * e * e, dim=(1, 2))
    return logq, prior_log_prob(w, prior_mu, prior, dim=(1, 2))


def logprob_vjp_plain(mu, rho, g_q, g_p, seeds=None, prior: tuple = GAUSSIAN,
                      prior_mu=None, eps=None):
    """The reference's closed-form VJP (``_mixture_bwd``, ``_gaussian_bwd``)
    over the plain W of ``seeds`` (or of ``eps``), eps read back from W:
    ``(dmu, drho)``, each (K, N)."""
    w = sampled_linear.naive_weights(mu, rho, seeds, eps)
    sigma = sigma_from_rho(rho)
    e = (w - mu[None]) / sigma[None]
    if prior[0] == "mixture":
        score = mixture_score(w, *prior[1:])
    else:
        score = -(w - prior_mu[None]) / MOPED_PRIOR_SIGMA ** 2
    gs = g_p[:, None, None] * score
    dmu = torch.sum(gs, dim=0)
    drho = (torch.sum(gs * e, dim=0) - torch.sum(g_q) / sigma) * torch.sigmoid(rho)
    return dmu, drho


def _check_group(mus, rhos, seeds, prior, prior_mus, what) -> int:
    """Every leaf's device, type, shape and contiguity as the grouped
    kernels take them; returns S."""
    req = common.require
    n = len(mus)
    req(n >= 1 and len(rhos) == n and len(seeds) == n,
        "{}: one rho and one seeds a leaf, got {} mu, {} rho, {} seeds", what, n,
        len(rhos), len(seeds))
    req(n <= MAX_LEAVES, "{}: at most {} leaves, got {}", what, MAX_LEAVES, n)
    req(prior[0] in ("gaussian", "mixture"), "the split op's priors are the Gaussian on "
        "prior_mu and the mixture, got {}", prior)
    gaussian = prior == GAUSSIAN
    req(not gaussian or (prior_mus is not None and len(prior_mus) == n),
        "the Gaussian prior needs a prior_mu a leaf")
    dev = mus[0].device
    req(dev.type == "cuda", "{} kernel needs a CUDA tensor, got {}", what, dev)
    S = seeds[0].shape[0] if seeds[0].dim() == 1 else 0
    req(1 <= S <= MAX_DRAWS, "between 1 and {} draws", MAX_DRAWS)
    for i, (mu, rho, sd) in enumerate(zip(mus, rhos, seeds)):
        req(mu.dim() == 2 and rho.shape == mu.shape,
            "leaf {}: mu and rho must be one (K, N); got {} / {}", i, tuple(mu.shape),
            tuple(rho.shape))
        req(mu.dtype == torch.float32 and rho.dtype == torch.float32,
            "leaf {}: mu and rho must be float32", i)
        req(logprob_blocks(*mu.shape) * _LOGPROB_BLOCK_QUADS < 2**31,
            "leaf {}: {} has 2^31 quads or more", i, tuple(mu.shape))
        req(sd.shape == (S,) and sd.dtype == torch.int32,
            "leaf {}: seeds must be ({},) int32, got {} {}", i, S, tuple(sd.shape), sd.dtype)
        leaf = [("mu", mu), ("rho", rho), ("seeds", sd)]
        if gaussian:
            pm = prior_mus[i]
            req(pm is not None and pm.shape == mu.shape and pm.dtype == torch.float32,
                "leaf {}: the Gaussian prior needs a {} float32 prior_mu", i, tuple(mu.shape))
            leaf.append(("prior_mu", pm))
        for name, t in leaf:
            req(t.device == dev, "leaf {}: {} is on {}, the group on {}", i, name, t.device,
                dev)
            req(t.is_contiguous(), "leaf {}: {} must be contiguous", i, name)
    return S


def _prior_args(prior: tuple) -> tuple[tuple, float]:
    """The kernels' mixture terms and the Gaussian's log-normaliser a
    weight, ``log sqrt(2 pi) + log sigma_p`` (0 under the mixture)."""
    if prior[0] == "mixture":
        return mixture_constants(*prior[1:]), 0.0
    return (0.0, 0.0, 1.0, 1.0), LOG_SQRT_2PI + math.log(MOPED_PRIOR_SIGMA)


def logprobs_grouped_cuda(mus, rhos, seeds, prior: tuple, prior_mus=None, *,
                          partials: bool = False, spans=None):
    """Launch ``bft_logprob`` (csrc/logprob.cu) once over every leaf, in its
    instance for the prior (the Gaussian on each leaf's prior_mu, or the
    mixture): ``(log_q, log_p)``, each (n_leaves, S) f32. The launch counter
    keys each launch by ``(n_leaves, S, prior tag)``. ``partials`` also
    returns the kernel's sums before their constants, (2 S + 1,
    total_blocks) f32: per block, the sum of ``-eps^2 / 2`` of each draw,
    then of log_p's terms of each draw, then of log sigma (a leaf's blocks
    are its span's, :func:`grouped_layout`), for checks of terms that the
    constants drown in f32. ``spans`` replaces the layout (checks of the
    partials' coverage)."""
    S = _check_group(mus, rhos, seeds, prior, prior_mus, "logprob")
    n = len(mus)
    spans = spans or grouped_layout([tuple(mu.shape) for mu in mus])
    total = spans[-1].first_block + spans[-1].n_blocks
    table = leaf_table(spans, mus, rhos, seeds, prior_mus)
    lib = _build.library()
    mu0 = mus[0]
    scratch = mu0.new_empty(((2 * S + 1) * total + 2 * n * S,))
    part = scratch[: (2 * S + 1) * total].view(2 * S + 1, total)
    logq, logp = scratch[(2 * S + 1) * total:].view(2, n, S).unbind(0)
    consts, c_p_unit = _prior_args(prior)
    with common.on_device(mu0):
        err = lib.bft_logprob(table.ctypes.data, n, S, total, PRIOR_CODE[prior[0]],
                              part.data_ptr(), logq.data_ptr(), logp.data_ptr(),
                              1.0 / MOPED_PRIOR_SIGMA, c_p_unit, *consts,
                              common.cuda_stream(mu0))
    _build.check(err, "bft_logprob")
    LAUNCHES.add((n, S, PRIOR_TAG[prior[0]].lstrip("/")))
    return (logq, logp, part) if partials else (logq, logp)


def logprob_vjp_grouped_cuda(mus, rhos, seeds, prior: tuple, g_q, g_p, prior_mus=None):
    """Launch ``bft_logprob_vjp`` (csrc/logprob.cu) once over every leaf: the
    reference's closed-form VJP at the cotangents ``g_q``, ``g_p``
    (n_leaves, S), the draws rebuilt in registers. Returns the lists of
    (K, N) dmu and drho, views of one flat buffer each. The launch counter
    keys each launch by ``(n_leaves, S, prior tag)``."""
    S = _check_group(mus, rhos, seeds, prior, prior_mus, "logprob_vjp")
    n = len(mus)
    req = common.require
    for name, g in (("g_q", g_q), ("g_p", g_p)):
        req(g.shape == (n, S) and g.dtype == torch.float32 and g.device == mus[0].device,
            "{} must be ({}, {}) float32 on {}", name, n, S, mus[0].device)
    g_q, g_p = g_q.contiguous(), g_p.contiguous()
    spans = grouped_layout([tuple(mu.shape) for mu in mus])
    total = spans[-1].first_block + spans[-1].n_blocks
    table = leaf_table(spans, mus, rhos, seeds, prior_mus)
    lib = _build.library()
    n_el = spans[-1].offset + spans[-1].K * spans[-1].N
    out = mus[0].new_empty((2, n_el))
    consts, _ = _prior_args(prior)
    with common.on_device(mus[0]):
        err = lib.bft_logprob_vjp(table.ctypes.data, n, S, total, PRIOR_CODE[prior[0]],
                                  g_q.data_ptr(), g_p.data_ptr(), out[0].data_ptr(),
                                  out[1].data_ptr(), MOPED_PRIOR_SIGMA ** 2, *consts,
                                  common.cuda_stream(mus[0]))
    _build.check(err, "bft_logprob_vjp")
    VJP_LAUNCHES.add((n, S, PRIOR_TAG[prior[0]].lstrip("/")))
    views = [out[:, sp.offset: sp.offset + sp.K * sp.N].view(2, sp.K, sp.N) for sp in spans]
    return [v[0] for v in views], [v[1] for v in views]


def _plain(mus, plain: bool) -> bool:
    return plain or mus[0].device.type == "cpu"


def _grouped(mus, rhos, seeds, eps, plain, prior, prior_mus):
    if _plain(mus, plain):
        pms = prior_mus or [None] * len(mus)
        eps = eps or [None] * len(mus)
        out = [logprobs_plain(mu, rho, sd, prior, pm, e)
               for mu, rho, sd, pm, e in zip(mus, rhos, seeds, pms, eps)]
        return torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out])
    common.require(eps is None, "an injected eps runs the plain version only")
    return logprobs_grouped_cuda(mus, rhos, seeds, prior, prior_mus)


class GroupedLogprobs(torch.autograd.Function):
    """:func:`sampled_logprobs_grouped` with the reference's closed-form VJPs
    (``_mixture_bwd``, ``_gaussian_bwd``) for every leaf: on the card one
    ``bft_logprob_vjp`` launch (the draws rebuilt in registers), else
    :func:`logprob_vjp_plain` a leaf,

        dmu  = sum_s g_p s(W)
        drho = (sum_s g_p s(W) eps - sum_s g_q / sigma) sigmoid(rho)

    with s the prior's score. ``forward(ctx, spec, *mus, *rhos)``, ``spec``
    holding the seeds, the injected eps, ``plain``, the prior and the
    prior_mus, which get no gradient (the reference's is masked out of
    training)."""

    @staticmethod
    def forward(ctx, spec, *tensors):
        n = len(tensors) // 2
        ctx.spec = spec
        ctx.save_for_backward(*tensors)
        return _grouped(tensors[:n], tensors[n:], *spec)

    @staticmethod
    def backward(ctx, g_q, g_p):
        tensors = ctx.saved_tensors
        n = len(tensors) // 2
        mus, rhos = tensors[:n], tensors[n:]
        seeds, eps, plain, prior, prior_mus = ctx.spec
        g_q, g_p = g_q.float(), g_p.float()
        if _plain(mus, plain):
            pms = prior_mus or [None] * n
            eps = eps or [None] * n
            grads = [logprob_vjp_plain(mu, rho, g_q[i], g_p[i], sd, prior, pm, e)
                     for i, (mu, rho, sd, pm, e) in enumerate(zip(mus, rhos, seeds, pms, eps))]
            dmus, drhos = [d[0] for d in grads], [d[1] for d in grads]
        else:
            dmus, drhos = logprob_vjp_grouped_cuda(mus, rhos, seeds, prior, g_q, g_p,
                                                   prior_mus)
        return (None, *dmus, *drhos)


def sampled_logprobs_grouped(mus, rhos, seeds, *, mixture=None, prior_mus=None,
                             plain: bool = False, eps=None):
    """Per-leaf, per-draw ``(log_q, log_p)``, each (n_leaves, S), of the
    weights drawn from each leaf's seeds (``seeds[i]`` (S,)) on the split
    ops' stream, under exactly one prior: ``mixture=(pi, sigma1, sigma2)``
    or the Gaussian on each leaf's ``prior_mus[i]``. Row i is
    :func:`sampled_logprobs` of leaf i; on the card one launch computes every
    row and one launch their VJP (:class:`GroupedLogprobs`). Port keywords:
    ``plain=True`` runs the plain versions on the tensors' device (a CPU
    tensor always does); ``eps`` (a list of (S, K, N)) injects the draws
    into the plain version (tests)."""
    if (mixture is None) == (prior_mus is None):
        raise ValueError("pass exactly one of `mixture` or `prior_mus`")
    prior = prior_of(mixture, None if prior_mus is None else prior_mus[0])
    mus, rhos, seeds = list(mus), list(rhos), list(seeds)
    if prior_mus is not None:
        prior_mus = [pm.detach() for pm in prior_mus]
    eps = None if eps is None else list(eps)
    spec = (seeds, eps, plain, prior, prior_mus)
    if torch.is_grad_enabled() and any(t.requires_grad for t in mus + rhos):
        return GroupedLogprobs.apply(spec, *mus, *rhos)
    return _grouped(mus, rhos, *spec)


def sampled_logprobs(mu, rho, seeds, *, mixture=None, prior_mu=None,
                     plain: bool = False, eps=None):
    """Per-draw ``(log_q, log_p)``, each (S,), of the (K, N) weight drawn
    from each of ``seeds`` (S,) on the split ops' stream (the W of
    ``sampled_linear.sampled_dense`` and ``regenerate_weights`` for the
    same seeds), under exactly one prior: ``mixture=(pi, sigma1, sigma2)``
    or the Gaussian on ``prior_mu`` (K, N). Differentiable in mu and rho
    through the reference's closed-form VJPs. A group of one leaf of
    :func:`sampled_logprobs_grouped`, whose port keywords it takes
    (``eps`` (S, K, N))."""
    if (mixture is None) == (prior_mu is None):
        raise ValueError("pass exactly one of `mixture` or `prior_mu`")
    lq, lp = sampled_logprobs_grouped(
        [mu], [rho], [seeds], mixture=mixture,
        prior_mus=None if prior_mu is None else [prior_mu], plain=plain,
        eps=None if eps is None else [eps])
    return lq[0], lp[0]
