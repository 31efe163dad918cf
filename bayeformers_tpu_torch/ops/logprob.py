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
evaluate the same expressions; these are their plain versions' terms. The
split-path kernel of this module (Pallas #11) comes with the split path.
"""
from __future__ import annotations

import math

import torch

from bayeformers_tpu_torch.core.distributions import LOG_SQRT_2PI
from bayeformers_tpu_torch.core.prior import moped_prior_log_prob

ON_MU = ("gaussian_on_mu",)
GAUSSIAN = ("gaussian",)
# The kernels' codes of the priors (csrc/prior.cuh::Prior), and the launch
# counters' tag suffix of each
PRIOR_CODE = {"gaussian_on_mu": 0, "gaussian": 1, "mixture": 2}
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
