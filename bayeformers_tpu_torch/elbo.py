"""Monte-Carlo ELBO estimation (counterpart of ``bayeformers_tpu/elbo.py``).

The loss of Bayes-by-Backprop (Blundell et al. 2015) with sum-reduced NLL:

    loss = (mean_S log_q - mean_S log_p) / n_batches + nll

The S samples ride the leading axis of the fused forward's outputs; the KL
term is differentiable end to end, as in the reference.
"""
from __future__ import annotations

import math
from typing import Any

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
