"""Stacked Bayesian dense blocks and their microbatch schedule (counterpart
of ``bayeformers_tpu/parallel/pipeline.py`` at one rank).

:class:`BlockStack` holds L identical Bayesian dense blocks with their
parameters stacked along a leading depth axis (mu/rho ``(L, d, d)``, bias
mu/rho ``(L, d)``), under the reference's leaf names. :func:`pipeline_apply`
runs any stack with the block protocol (``leaves()``, ``block_apply(leaf,
seed, global_idx, h)``, ``dummy_input()``; ``TransformerStack`` too) by
the reference's microbatch schedule: the batch split into M microbatches,
each through every resident block in depth order, the outputs in order.

A block's draw is a pure function of (the draw's seed, the global block
index) (``parallel/sampling.py``), so every microbatch sees the same
weights within a draw and the KL is counted once per draw. The reference
takes it from a probe of each block on ``dummy_input()``; here it is the
first microbatch's log-probs, the same function of the same draw.

:func:`make_pp_train_step` is the reference's MC-ELBO step: S draws, each a
full pass, ``loss = sum_s ((log_q - log_p) / n_batches + nll) / S``, then
one optimizer update (``torch.optim.Adam(lr, eps=1e-8)`` is optax's
``adam(lr)``). Process groups: ``None`` or a group of one; the stages'
send/recv schedule over ranks is ROADMAP queue 1 item 6(c).
"""
from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from bayeformers_tpu_torch.models.bert import check_device
from bayeformers_tpu_torch.nn.layers import Generator, as_generator
from bayeformers_tpu_torch.parallel import sampling


class BlockStack(nn.Module):
    """``h <- gelu(h @ W_l + b_l)`` (``+ h`` when ``residual``) for l in
    0..L-1, with ``W_l = mu_l + softplus(rho_l) eps_l`` and ``b_l`` likewise
    (the tanh GELU, ``jax.nn.gelu``'s default); the reference's
    ``Uniform((-0.2, 0.2), (-5, -4))`` init drawn from ``generator`` (a
    ``torch.Generator`` or an int seed), on ``device``."""

    def __init__(self, n_blocks: int, features: int, residual: bool = True, *,
                 generator: Generator = 0, device="cuda"):
        super().__init__()
        self.n_blocks, self.features, self.residual = n_blocks, features, residual
        device = check_device(device, "BlockStack")
        gen = as_generator(generator)
        L, d = n_blocks, features
        self.mu, self.rho = sampling.stacked_uniform(gen, (L, d, d), device)
        self.bias_mu, self.bias_rho = sampling.stacked_uniform(gen, (L, d), device)

    def leaves(self) -> list[dict[str, torch.Tensor]]:
        """Each block's leaves, views of the stacked parameters (one unbind a
        leaf, so the backward stacks each leaf's gradient once)."""
        names = ("mu", "rho", "bias_mu", "bias_rho")
        per = [getattr(self, n).unbind(0) for n in names]
        return [dict(zip(names, ts)) for ts in zip(*per)]

    def dummy_input(self) -> torch.Tensor:
        """The reference's KL-probe activation (1, d)."""
        return self.mu.new_zeros((1, self.features))

    def block_apply(self, leaf, seed: int, global_idx: int, h: torch.Tensor,
                    plain: bool = False):
        """One block on ``h`` (mb, d): ``(h', log_q, log_p)``; the draw is a
        function of (seed, global_idx) only."""
        y, lq, lp = sampling.bayes_dense(h, leaf["mu"], leaf["rho"], leaf["bias_mu"],
                                         leaf["bias_rho"], seed, (global_idx,), plain)
        out = sampling.gelu(y)
        if self.residual:
            out = out + h
        return out, lq, lp


def pipeline_apply(stack, seed: int, x: torch.Tensor, *, n_microbatches: int,
                   group=None, plain: bool = False):
    """``(out, log_q, log_p)`` of ``stack`` on ``x`` (B, ...), B split into
    ``n_microbatches`` microbatches along its leading axis, each through
    every block in depth order; the log-probs once per draw (the first
    microbatch's). ``B % n_microbatches != 0`` raises ``ValueError``."""
    sampling.check_group(group, "pipeline_apply")
    B = x.shape[0]
    if B % n_microbatches:
        raise ValueError(f"batch {B} % microbatches {n_microbatches} != 0")
    leaves = stack.leaves()
    outs, log_q, log_p = [], None, None
    for m, h in enumerate(x.chunk(n_microbatches)):
        for l, leaf in enumerate(leaves):
            h, lq, lp = stack.block_apply(leaf, seed, l, h, plain=plain)
            if m == 0:
                log_q = lq if log_q is None else log_q + lq
                log_p = lp if log_p is None else log_p + lp
        outs.append(h)
    return torch.cat(outs), log_q, log_p


def elbo_step(optimizer, n_samples: int, n_batches: int, forward: Callable,
              loss_fn: Callable, batch: dict, seed: int) -> dict[str, torch.Tensor]:
    """One MC-ELBO step of the stacked tiers: for each of the S draws,
    ``forward(draw_seed) -> (out, log_q, log_p)``, ``(nll, metrics) =
    loss_fn(out, batch)`` and the backward of ``((log_q - log_p) /
    n_batches + nll) / S`` (the gradients summed over the draws, one draw's
    activations alive at a time); then ``optimizer.step()``. Returns the
    metrics (detached, averaged over draws) with ``loss`` and ``nll``."""
    optimizer.zero_grad()
    total, sums = None, {}
    for s_seed in sampling.draw_seeds(seed, n_samples):
        out, lq, lp = forward(s_seed)
        nll, metrics = loss_fn(out, batch)
        part = ((lq - lp) / n_batches + nll) / n_samples
        part.backward()
        total = part.detach() if total is None else total + part.detach()
        for k, v in dict(metrics, nll=nll).items():
            v = torch.as_tensor(v).detach()
            sums[k] = sums[k] + v if k in sums else v
    optimizer.step()
    return dict({k: v / n_samples for k, v in sums.items()}, loss=total)


def make_pp_train_step(stack: BlockStack, optimizer, *, n_samples: int, n_batches: int,
                       n_microbatches: int, loss_fn: Callable, group=None,
                       plain: bool = False):
    """``step(seed, batch) -> metrics``: the MC-ELBO step of the pipeline
    (:func:`elbo_step` over :func:`pipeline_apply` on ``batch["x"]``),
    updating ``stack`` in place through ``optimizer``. ``loss_fn(out,
    batch) -> (nll_sum, metrics)`` on the (B, d) output. ``plain=True``
    runs the op's plain versions (the card's reference)."""
    sampling.check_group(group, "make_pp_train_step")

    def step(seed: int, batch: dict) -> dict[str, torch.Tensor]:
        return elbo_step(optimizer, n_samples, n_batches,
                         lambda s: pipeline_apply(stack, s, batch["x"],
                                                  n_microbatches=n_microbatches,
                                                  plain=plain),
                         loss_fn, batch, seed)

    return step
