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
mixture, on the card through ``csrc/logprob.cu`` (Pallas #11,
``_logprob_kernel``). Flipout and local reparameterization score the
mixture's KL with it (``nn/flipout.py::analytic_leaf_kl``).
"""
from __future__ import annotations

import math

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
# The split op: per-draw log-probs of a sampled weight (Pallas #11)
# ---------------------------------------------------------------------------

LAUNCHES = common.LaunchCounter("logprob")
# quads (the four elements of one Philox call) a block of csrc/logprob.cu
# covers: QUADS * THREADS there
_LOGPROB_BLOCK_QUADS = 8 * 256


def logprob_blocks(K: int, N: int) -> int:
    """The blocks of one draw in ``csrc/logprob.cu`` at (K, N): block b takes
    quads ``[b, b + 1) * 2048`` in the order (unit row chunk, row of the
    cos half, column pair); see :func:`logprob_block_of`."""
    quads = -(-K // common.UNIT_K) * (common.UNIT_K // 2) * (-(-N // 2))
    return -(-quads // _LOGPROB_BLOCK_QUADS)


def logprob_block_of(K: int, N: int, device=None) -> torch.Tensor:
    """(K, N) int64: the block of ``csrc/logprob.cu`` that sums each element
    (the layout of its partials, for checks against plain f64 sums)."""
    k = torch.arange(K, device=device)[:, None]
    n = torch.arange(N, device=device)[None, :]
    half = common.UNIT_K // 2
    quad = ((k // common.UNIT_K) * half + (k % common.UNIT_K) % half) * (-(-N // 2)) + n // 2
    return quad // _LOGPROB_BLOCK_QUADS


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


def logprobs_cuda(mu, rho, seeds, prior: tuple, prior_mu=None, *,
                  partials: bool = False):
    """Launch ``bft_logprob`` (csrc/logprob.cu) in its instance for the
    prior (the Gaussian on ``prior_mu`` or the mixture). The launch counter
    keys each launch by ``(S, K, N, prior tag)``. ``partials`` also returns
    the kernel's sums before their constants: (S, n_blocks, 2) f32 (per
    draw and block, the sum of ``-eps^2 / 2`` and of log_p's terms) and
    (n_blocks,) f32 (the sum of log sigma), for checks of terms that the
    constants drown in f32."""
    req = common.require
    req(mu.is_cuda, f"logprob kernel needs a CUDA tensor, got {mu.device}")
    req(prior[0] in ("gaussian", "mixture"),
        f"the split op's priors are the Gaussian on prior_mu and the mixture, got {prior}")
    req(mu.dim() == 2 and tuple(rho.shape) == tuple(mu.shape),
        f"mu and rho must be one (K, N); got {tuple(mu.shape)} / {tuple(rho.shape)}")
    req(mu.dtype == torch.float32 and rho.dtype == torch.float32,
        "mu and rho must be float32")
    req(seeds.dim() == 1 and seeds.dtype == torch.int32, "seeds must be (S,) int32")
    tensors = [("mu", mu), ("rho", rho), ("seeds", seeds)]
    K, N = mu.shape
    if prior == GAUSSIAN:
        req(prior_mu is not None and tuple(prior_mu.shape) == (K, N)
            and prior_mu.dtype == torch.float32,
            f"the Gaussian prior needs a ({K}, {N}) float32 prior_mu")
        tensors.append(("prior_mu", prior_mu))
    for name, t in tensors:
        req(t.device == mu.device, f"{name} is on {t.device}, mu on {mu.device}")
        req(t.is_contiguous(), f"{name} must be contiguous")
    S = seeds.shape[0]
    req(1 <= S <= 1024, "between 1 and 1024 draws")
    lib = _build.library()
    n_blocks = logprob_blocks(K, N)
    dev = mu.device
    part = torch.empty((S, n_blocks, 2), dtype=torch.float32, device=dev)
    ls_part = torch.empty((n_blocks,), dtype=torch.float32, device=dev)
    logq = torch.empty((S,), dtype=torch.float32, device=dev)
    logp = torch.empty((S,), dtype=torch.float32, device=dev)
    n_el = K * N
    mixture = prior[0] == "mixture"
    c_p = 0.0 if mixture else n_el * (LOG_SQRT_2PI + math.log(MOPED_PRIOR_SIGMA))
    consts = mixture_constants(*prior[1:]) if mixture else (0.0, 0.0, 1.0, 1.0)
    with torch.cuda.device(dev):
        err = lib.bft_logprob(
            mu.data_ptr(), rho.data_ptr(), None if prior_mu is None else prior_mu.data_ptr(),
            seeds.data_ptr(), part.data_ptr(), ls_part.data_ptr(), logq.data_ptr(),
            logp.data_ptr(), S, K, N, PRIOR_CODE[prior[0]], 1.0 / MOPED_PRIOR_SIGMA,
            n_el * LOG_SQRT_2PI, c_p, *consts, common.cuda_stream(mu))
    _build.check(err, "bft_logprob")
    LAUNCHES.add((S, K, N, PRIOR_TAG[prior[0]].lstrip("/")))
    return (logq, logp, part, ls_part) if partials else (logq, logp)


def _logprobs(mu, rho, seeds, eps, plain, prior, prior_mu):
    if plain or mu.device.type == "cpu":
        return logprobs_plain(mu, rho, seeds, prior, prior_mu, eps)
    common.require(eps is None, "an injected eps runs the plain version only")
    return logprobs_cuda(mu, rho, seeds, prior, prior_mu)


class SampledLogprobs(torch.autograd.Function):
    """:func:`sampled_logprobs` with the reference's closed-form VJPs
    (``_mixture_bwd``, ``_gaussian_bwd``): W rebuilt by
    ``sampled_linear.regenerate_weights`` (kernel #13 on the card),
    ``eps = (W - mu) / sigma`` and the prior's score s(W),

        dmu  = sum_s g_p s(W)
        drho = (sum_s g_p s(W) eps - sum_s g_q / sigma) sigmoid(rho)

    ``prior_mu`` gets no gradient (the reference's is masked out of
    training)."""

    @staticmethod
    def forward(ctx, mu, rho, seeds, eps, plain, prior, prior_mu):
        ctx.save_for_backward(mu, rho, seeds, eps, prior_mu)
        ctx.plain, ctx.prior = plain, prior
        return _logprobs(mu, rho, seeds, eps, plain, prior, prior_mu)

    @staticmethod
    def backward(ctx, g_q, g_p):
        mu, rho, seeds, eps, prior_mu = ctx.saved_tensors
        w = (sampled_linear.naive_weights(mu, rho, eps=eps) if eps is not None
             else sampled_linear.regenerate_weights(mu, rho, seeds, plain=ctx.plain))
        sigma = sigma_from_rho(rho)
        e = (w - mu[None]) / sigma[None]
        if ctx.prior[0] == "mixture":
            score = mixture_score(w, *ctx.prior[1:])
        else:
            score = -(w - prior_mu[None]) / MOPED_PRIOR_SIGMA ** 2
        gs = g_p[:, None, None] * score
        dmu = torch.sum(gs, dim=0)
        drho = (torch.sum(gs * e, dim=0) - torch.sum(g_q) / sigma) * torch.sigmoid(rho)
        return dmu, drho, None, None, None, None, None


def sampled_logprobs(mu, rho, seeds, *, mixture=None, prior_mu=None,
                     plain: bool = False, eps=None):
    """Per-draw ``(log_q, log_p)``, each (S,), of the (K, N) weight drawn
    from each of ``seeds`` (S,) on the split ops' stream (the W of
    ``sampled_linear.sampled_dense`` and ``regenerate_weights`` for the
    same seeds), under exactly one prior: ``mixture=(pi, sigma1, sigma2)``
    or the Gaussian on ``prior_mu`` (K, N). Differentiable in mu and rho
    (:class:`SampledLogprobs`). Port keywords: ``plain=True`` runs the plain
    versions on the tensors' device (a CPU tensor always does); ``eps``
    (S, K, N) injects the draw into the plain version (tests)."""
    if (mixture is None) == (prior_mu is None):
        raise ValueError("pass exactly one of `mixture` or `prior_mu`")
    prior = prior_of(mixture, prior_mu)
    if prior_mu is not None:
        prior_mu = prior_mu.detach()
    if torch.is_grad_enabled() and (mu.requires_grad or rho.requires_grad):
        return SampledLogprobs.apply(mu, rho, seeds, eps, plain, prior, prior_mu)
    return _logprobs(mu, rho, seeds, eps, plain, prior, prior_mu)
