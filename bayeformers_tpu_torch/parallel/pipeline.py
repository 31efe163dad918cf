"""Stacked Bayesian dense blocks and their pipeline schedule (counterpart
of ``bayeformers_tpu/parallel/pipeline.py``).

:class:`BlockStack` holds L identical Bayesian dense blocks with their
parameters stacked along a leading depth axis (mu/rho ``(L, d, d)``, bias
mu/rho ``(L, d)``), under the reference's leaf names. :func:`pipeline_apply`
runs any stack with the block protocol (``leaves()``, ``block_apply(leaf,
seed, global_idx, h)``, ``dummy_input()``; ``TransformerStack`` too) by
the reference's schedule: the batch split into M microbatches, each
through every block in depth order, the outputs in order.

Across pp ranks (:func:`make_pp_mesh`: one process a rank under ``python
-m torch.distributed.run``, or one thread a rank on a store) stage s holds
blocks s L/pp .. (s + 1) L/pp - 1 (:func:`shard_stack`) and the schedule is
the reference's tick loop: M + pp - 1 ticks, stage 0 injecting microbatch
t on tick t, each stage running its blocks, the last emitting microbatch
t - (pp - 1), then the activations shifted one stage on
(``collectives.shift_to_next``: a broadcast in a two-rank gloo group, or
``batch_isend_irecv`` under NCCL). The last stage's outputs reach every
rank by ``reduce_from_shards``. A stage skips the compute of its dead
ticks, never their collectives.

A block's draw is a pure function of (the draw's seed, the global block
index) (``parallel/sampling.py``), so every microbatch sees the same
weights within a draw, a rank's blocks draw what the one-process run
draws, and the KL is counted once per draw. The reference takes it from a
probe of each block on ``dummy_input()``; here it is each stage's first
live tick's log-probs (microbatch 0), the same function of the same draw,
summed over the stages by ``reduce_from_shards``.

:func:`make_pp_train_step` is the reference's MC-ELBO step: S draws, each a
full pass, ``loss = sum_s ((log_q - log_p) / n_batches + nll) / S``, then
one optimizer update (``torch.optim.Adam(lr, eps=1e-8)`` is optax's
``adam(lr)``). The gradients of a stage's blocks are its own, so the update
needs no collective; each rank's optimizer holds only its own leaves (the
reference's optimizer-moment specs, ``pipeline.py:262-272``, have no
counterpart).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from bayeformers_tpu_torch.models.bert import check_device
from bayeformers_tpu_torch.nn.layers import Generator, as_generator
from bayeformers_tpu_torch.parallel import collectives as coll
from bayeformers_tpu_torch.parallel import mesh as mesh_lib
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
        self.n_shards = 1
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


def make_pp_mesh(pp: int, *, backend: str, store=None, rank: Optional[int] = None,
                 world_size: Optional[int] = None) -> coll.Ranks:
    """The calling rank's stage on a ``pp``-stage pipeline: its index, the
    world size, the group of all stages and, under gloo, the pair groups of
    the shift. The keywords are ``parallel/mesh.py::make_mesh``'s (the
    default process group from the environment, or gloo groups on a
    ``store``); a world size other than ``pp`` raises ``ValueError``."""
    return mesh_lib.make_axis(pp, "pp", backend=backend, store=store, rank=rank,
                              world_size=world_size, hops=True)


def stack_specs(module: nn.Module) -> dict[str, int]:
    """``{parameter name: 0}`` of the depth-stacked leaves of ``module`` (a
    ``BlockStack``, a dense ``TransformerStack``, or a ``TransformerLM``,
    whose tables replicate): the counterpart of the reference's
    ``stack_specs``. A MoE stack raises, as pp over it does."""
    stack = getattr(module, "stack", module)
    if getattr(stack, "moe", None) is not None:
        raise ValueError("pp over a MoE-FFN TransformerStack needs a pp x ep mesh")
    prefix = "stack." if stack is not module else ""
    return {prefix + n: 0 for n, _ in stack.named_parameters()}


def shard_stack(module: nn.Module, ranks: Optional[coll.Ranks]) -> nn.Module:
    """Keep the stage's L/pp blocks of ``module`` (:func:`stack_specs`), in
    place, and return it; ``ranks`` None is one stage."""
    if ranks is not None and ranks.world_size > 1:
        mesh_lib.shard_params(module, stack_specs(module), ranks)
        getattr(module, "stack", module).n_shards = ranks.world_size
    return module


def unshard_stack(module: nn.Module, ranks: Optional[coll.Ranks]) -> nn.Module:
    """A copy of ``module`` with every stage's blocks gathered (every rank
    calls it)."""
    return mesh_lib.unshard_params(module, stack_specs(module), ranks)


def _stages(stack, seed, x, M, ranks, plain):
    """The tick schedule of :func:`pipeline_apply` on stage ``ranks.rank``."""
    pp, stage = ranks.world_size, ranks.rank
    leaves = stack.leaves()
    n_local = len(leaves)
    xs = x.chunk(M)
    n_ticks = M + pp - 1
    state, outs, log_q, log_p = None, [], None, None
    for t in range(n_ticks):
        m = t - stage  # the microbatch on this stage at tick t
        if stage == 0 and t < M:
            h = xs[t] if state is None else coll.tie(xs[t], state)
        else:
            h = xs[0].new_zeros(xs[0].shape) if state is None else state
            if t < M:
                # another stage's input: not read here, kept in the graph so
                # that a collective upstream of x (the LM's "f") runs its
                # backward on every stage
                h = coll.tie(h, xs[t])
        if 0 <= m < M:
            for l, leaf in enumerate(leaves):
                h, lq, lp = stack.block_apply(leaf, seed, stage * n_local + l, h, plain=plain)
                if m == 0:
                    log_q = lq if log_q is None else log_q + lq
                    log_p = lp if log_p is None else log_p + lp
            if stage == pp - 1:
                outs.append(h)
        if t < n_ticks - 1:
            # a dead tick passes its value on unchanged: every shift's output
            # feeds the next tick, so the reverse shifts of the backward run
            # in one chain, tick by tick, on every stage. What a shift
            # receives must be differentiable whatever this stage sent (a
            # dead zero on a later stage): under grad mode every shift's
            # input is.
            if torch.is_grad_enabled() and not h.requires_grad:
                h = h.detach().requires_grad_()
            state = coll.shift_to_next(h, ranks)
    if stage == pp - 1:
        out = torch.cat(outs)
    else:
        out = coll.tie(x.new_zeros(x.shape), h)
    out = coll.reduce_from_shards(out, ranks.group)
    kl = coll.reduce_from_shards(torch.stack([log_q, log_p]), ranks.group)
    return out, kl[0], kl[1]


def pipeline_apply(stack, seed: int, x: torch.Tensor, *, n_microbatches: int,
                   group=None, plain: bool = False):
    """``(out, log_q, log_p)`` of ``stack`` on ``x`` (B, ...), B split into
    ``n_microbatches`` microbatches along its leading axis, each through
    every block in depth order; the log-probs once per draw (the first
    microbatch's). ``group``: None (one rank) or the stage's
    :func:`make_pp_mesh`, ``stack`` cut by :func:`shard_stack`; every rank
    gets the whole output and log-probs. ``B % n_microbatches != 0`` raises
    ``ValueError``."""
    ranks = sampling.check_group(group, stack, "pipeline_apply")
    B = x.shape[0]
    if B % n_microbatches:
        raise ValueError(f"batch {B} % microbatches {n_microbatches} != 0")
    if ranks is not None:
        return _stages(stack, seed, x, n_microbatches, ranks, plain)
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
    (:func:`elbo_step` over :func:`pipeline_apply` on ``batch["x"]``, the
    whole batch on every rank), updating ``stack`` (the stage's blocks under
    a ``group`` of :func:`make_pp_mesh`) in place through ``optimizer``.
    ``loss_fn(out, batch) -> (nll_sum, metrics)`` on the (B, d) output.
    ``plain=True`` runs the op's plain versions (the card's reference)."""
    sampling.check_group(group, stack, "make_pp_train_step")

    def step(seed: int, batch: dict) -> dict[str, torch.Tensor]:
        return elbo_step(optimizer, n_samples, n_batches,
                         lambda s: pipeline_apply(stack, s, batch["x"],
                                                  n_microbatches=n_microbatches,
                                                  group=group, plain=plain),
                         loss_fn, batch, seed)

    return step
