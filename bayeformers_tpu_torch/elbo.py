"""Monte-Carlo ELBO estimation (counterpart of ``bayeformers_tpu/elbo.py``).

The loss of Bayes-by-Backprop (Blundell et al. 2015) with sum-reduced NLL:

    loss = (mean_S log_q - mean_S log_p) / n_batches + nll

The S samples ride the leading axis of the forward's outputs; the KL
term is differentiable end to end, as in the reference. :func:`analytic_kl`
gives the KL with no sampled weight, and :func:`predictive` a classifier's
posterior-predictive summary.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch


def elbo_loss(nll: torch.Tensor, log_prior: torch.Tensor,
              log_variational_posterior: torch.Tensor,
              n_batches: int) -> torch.Tensor:
    """``(mean_S(log_q) - mean_S(log_p)) / n_batches + nll``; ``nll`` is
    sum-reduced over the batch, the log-probs are scalars or (S,)."""
    return (torch.mean(log_variational_posterior)
            - torch.mean(log_prior)) / n_batches + nll


def blundell_weight(batch_index, n_batches: int) -> torch.Tensor:
    """Geometric minibatch KL weight ``pi_i = 2^(M-i) / (2^M - 1)`` (eq. 9),
    in the cancelled form ``2^-i / (1 - 2^-M)`` that neither overflows f32
    nor loses the fractional bits of ``(M - i) log 2``; ``batch_index`` is
    0-based."""
    i = torch.as_tensor(batch_index, dtype=torch.float32) + 1.0
    m = torch.tensor(float(n_batches), dtype=torch.float32)
    log2 = torch.tensor(math.log(2.0), dtype=torch.float32)
    return torch.exp(-i * log2 - torch.log1p(-torch.exp(-m * log2)))


def mc_logits_mean(logits: torch.Tensor) -> torch.Tensor:
    """Average predictions over the leading MC-sample axis."""
    return torch.mean(logits, dim=0)


def nll_sum_from_log_probs(log_probs: torch.Tensor,
                           labels: torch.Tensor) -> torch.Tensor:
    """Sum-reduced NLL over log-probabilities, reduced in float32."""
    log_probs = log_probs.float()
    return -torch.sum(torch.gather(log_probs, -1, labels[:, None].long()))


def cross_entropy_sum(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Sum-reduced softmax cross entropy in float32."""
    return nll_sum_from_log_probs(torch.log_softmax(logits.float(), dim=-1), labels)


def accuracy_and_std(logits: torch.Tensor, labels: torch.Tensor):
    """(accuracy of the S-averaged prediction, std over the S draws of the
    per-draw accuracy), the reference's uncertainty proxy."""
    labels = labels.long()
    mean_pred = torch.argmax(mc_logits_mean(logits), dim=-1)
    acc = torch.mean((mean_pred == labels).float())
    per_sample = torch.mean(
        (torch.argmax(logits, dim=-1) == labels[None, :]).float(), dim=1)
    return acc, torch.std(per_sample, unbiased=False)


def aux_scalars(aux: dict[str, Any]):
    """``(log_prior, log_q)`` out of an aux dict of the fused forward."""
    return aux["log_prior"], aux["log_variational_posterior"]


def analytic_kl(bmodel, seed: Optional[int] = None, mixture_draws: int = 4,
                eps_hook=None) -> torch.Tensor:
    """``KL(q || prior)`` summed over the converted leaves, with no sampled
    weight to score (the reference's extension over its single-draw
    ``log_q - log_p``): the closed form under a MOPED prior (centred on each
    leaf's ``prior_mu``); under the scale mixture, which has none, the
    negative entropy in closed form less the cross-entropy averaged over
    ``mixture_draws`` reparametrized draws per leaf (needs ``seed``: leaf
    i's from a ``torch.Generator`` seeded ``derive_seed(seed, i)``;
    ``eps_hook(path, shape)`` supplies them instead, tests only). Plain
    torch, as it is XLA in the JAX package."""
    from bayeformers_tpu_torch.core import distributions as dist
    from bayeformers_tpu_torch.core.prior import MOPED_PRIOR_SIGMA
    from bayeformers_tpu_torch.nn.fused import derive_seed
    from bayeformers_tpu_torch.nn.surgery import leaf

    spec = bmodel.spec
    kl = torch.zeros((), dtype=torch.float32, device=bmodel.device)
    for i, path in enumerate(spec.paths):
        mu, rho = leaf(bmodel.model, path), bmodel.rho[path]
        sigma = dist.sigma_from_rho(rho)
        if spec.moped:
            kl = kl + dist.gaussian_kl(mu, sigma, bmodel.prior_mu[path], MOPED_PRIOR_SIGMA)
            continue
        if seed is None and eps_hook is None:
            raise ValueError("analytic_kl with a scale-mixture prior needs `seed` for "
                             "the MC cross-entropy term")
        neg_entropy = (-0.5 * mu.numel() * (1.0 + 2.0 * dist.LOG_SQRT_2PI)
                       - torch.sum(torch.log(sigma)))
        if eps_hook is not None:
            w = mu + sigma * eps_hook(path, (mixture_draws,) + tuple(mu.shape)).to(mu.device)
        else:
            gen = torch.Generator(device=mu.device).manual_seed(derive_seed(seed, i))
            w, _ = dist.sample_gaussian(gen, mu, rho, n_samples=mixture_draws)
        cross = bmodel.prior_log_prob(path, w, dim=tuple(range(1, w.dim())))
        kl = kl + neg_entropy - torch.mean(cross)
    return kl


def predictive(bmodel, seed: int, n_samples: int, input_ids, attention_mask=None,
               token_type_ids=None, *, fused: bool = True, **kwargs) -> dict:
    """Posterior-predictive summary of a classifier over S stochastic
    forwards, without gradients: ``probs`` (the mean softmax over the
    draws, (B, C)), ``epistemic_std`` (each class's std across the draws),
    ``entropy`` of the mean distribution (B,) and the raw (S, B, C)
    ``logits``. ``fused=True`` runs the fused tier without weight residuals
    (``save_weights=False``), else the naive tier (:meth:`BayesianModel.
    mc_apply`); ``kwargs`` go to the forward."""
    with torch.inference_mode():
        if fused:
            logits, _ = bmodel.mc_apply_fused(seed, n_samples, input_ids, attention_mask,
                                              token_type_ids, save_weights=False, **kwargs)
        else:
            logits, _ = bmodel.mc_apply(seed, n_samples, input_ids, attention_mask,
                                        token_type_ids, **kwargs)
        probs_s = torch.softmax(logits.float(), dim=-1)
        probs = torch.mean(probs_s, dim=0)
        entropy = -torch.sum(probs * torch.log(torch.clamp(probs, min=1e-12)), dim=-1)
        return {"probs": probs, "epistemic_std": torch.std(probs_s, dim=0, unbiased=False),
                "entropy": entropy, "logits": logits}
