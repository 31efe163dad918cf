"""Top-1 Bayesian mixture of experts and its expert shards (counterpart
of ``bayeformers_tpu/parallel/moe.py``).

:class:`BayesMoE` is a frequentist router (a plain (d, E) dense) over E
Bayesian expert FFNs ``h -> gelu(h @ W1_e + b1_e) @ W2_e + b2_e`` (the tanh
GELU) whose
parameters are stacked along a leading expert axis, under the reference's
leaf names: ``wi_mu``/``wi_rho`` (E, d, ff), ``wo_mu``/``wo_rho`` (E, ff,
d), ``bi_*`` (E, ff), ``bo_*`` (E, d), ``router`` (d, E). With ``depth=L``
every leaf gains a leading block axis (the MoE FFN of a
``TransformerStack``).

Routing is the reference's: the f32 softmax of ``x @ router``, top-1 (the
first maximum), a static capacity ``C = ceil(T / E * capacity_factor)`` a
expert, the tokens past an expert's capacity dropped (in token order), and
each kept token's output scaled by the top gate, cast to x's dtype. The
reference dispatches and combines by one-hot einsums over (T, E, C); here
an index scatter and gather do the same (every slot holds one token or
zeros), so the outputs, the KL and the router's gradient are the same.

Every expert is sampled and counted in the KL each draw, whatever the
routing: expert e's projection j draws from (the draw's seed, path +
(e, j)) (``parallel/sampling.py``). On a CUDA tensor each projection is
kernel #7/#8 at M = C and #9 in the backward.

Across ep ranks (:func:`make_ep_mesh`: one process a rank under ``python
-m torch.distributed.run``, or one thread a rank on a store) rank r holds
experts r E/ep .. (r + 1) E/ep - 1 (:func:`shard_experts`), x and the
router replicated. The routing runs over all E experts on every rank (so C
and the drops are the reference's); the rank fills only its experts'
capacity slots; the combine and the log-probs are summed over the ranks
by ``reduce_from_shards`` (an all-reduce over gloo or NCCL); x and the
router pass through ``copy_many_to_shards`` (the reference's "f"), whose
backward sums their cotangents, else each rank's would be the partial of
its own experts. Each rank's optimizer holds only its own leaves (the
reference's optimizer-moment specs, ``moe.py:252-262``, have no
counterpart).
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from bayeformers_tpu_torch.models.bert import check_device
from bayeformers_tpu_torch.nn.layers import Generator, as_generator
from bayeformers_tpu_torch.parallel import collectives as coll
from bayeformers_tpu_torch.parallel import mesh as mesh_lib
from bayeformers_tpu_torch.parallel import sampling
from bayeformers_tpu_torch.parallel.pipeline import elbo_step

EXPERT_LEAVES = ("wi_mu", "wi_rho", "wo_mu", "wo_rho", "bi_mu", "bi_rho", "bo_mu", "bo_rho")


class Routing(NamedTuple):
    """Top-1 routing of T tokens: each token's expert and slot in its
    expert's queue, whether it was kept (slot < C) and its gate."""

    expert: torch.Tensor  # (T,) int64
    slot: torch.Tensor    # (T,) int64
    keep: torch.Tensor    # (T,) bool
    gate: torch.Tensor    # (T,) x's dtype, differentiable


class BayesMoE(nn.Module):
    """Top-1 Bayesian MoE ``y[t] = gate[t] * expert_{e(t)}(x[t])``, the
    reference's init drawn from ``generator`` (a ``torch.Generator`` or an
    int seed) in its order (wi, wo, bi, bo, then the router ~ N(0, 1/d)),
    on ``device``."""

    def __init__(self, n_experts: int, features: int, ffn: int,
                 capacity_factor: float = 1.25, *, depth: Optional[int] = None,
                 generator: Generator = 0, device="cuda"):
        super().__init__()
        self.n_experts, self.features, self.ffn = n_experts, features, ffn
        self.capacity_factor, self.depth, self.n_shards = capacity_factor, depth, 1
        device = check_device(device, "BayesMoE")
        gen = as_generator(generator)
        lead = () if depth is None else (depth,)
        E, d, f = n_experts, features, ffn
        self.wi_mu, self.wi_rho = sampling.stacked_uniform(gen, lead + (E, d, f), device)
        self.wo_mu, self.wo_rho = sampling.stacked_uniform(gen, lead + (E, f, d), device)
        self.bi_mu, self.bi_rho = sampling.stacked_uniform(gen, lead + (E, f), device)
        self.bo_mu, self.bo_rho = sampling.stacked_uniform(gen, lead + (E, d), device)
        router = torch.randn(lead + (d, E), generator=gen) * (1.0 / math.sqrt(d))
        self.router = nn.Parameter(router.to(device))

    def capacity(self, n_tokens: int) -> int:
        return max(1, math.ceil(n_tokens / self.n_experts * self.capacity_factor))

    def route(self, router: torch.Tensor, x: torch.Tensor) -> Routing:
        """Top-1 routing of tokens ``x`` (T, d) by ``router`` (d, E)."""
        gates = torch.softmax((x @ router).float(), dim=-1)
        expert = torch.argmax(gates, dim=-1)
        onehot = F.one_hot(expert, self.n_experts)
        slot = torch.sum((torch.cumsum(onehot, 0) - onehot) * onehot, dim=-1)
        gate = torch.gather(gates.to(x.dtype), 1, expert[:, None])[:, 0]
        return Routing(expert, slot, slot < self.capacity(x.shape[0]), gate)

    def params(self) -> dict[str, torch.Tensor]:
        """The layer's own leaves (a standalone layer's (E, ...))."""
        return {k: getattr(self, k) for k in EXPERT_LEAVES + ("router",)}

    def expert_apply(self, leaf, seed: int, path: tuple, h: torch.Tensor,
                     plain: bool = False):
        """One expert FFN on its capacity slots ``h`` (C, d): ``(y (C, d),
        log_q, log_p)``; projection j draws from (seed, path + (j,))."""
        hid, lq1, lp1 = sampling.bayes_dense(h, leaf["wi_mu"], leaf["wi_rho"],
                                             leaf["bi_mu"], leaf["bi_rho"], seed,
                                             path + (0,), plain)
        y, lq2, lp2 = sampling.bayes_dense(sampling.gelu(hid), leaf["wo_mu"], leaf["wo_rho"],
                                           leaf["bo_mu"], leaf["bo_rho"], seed,
                                           path + (1,), plain)
        return y, lq1 + lq2, lp1 + lp2

    def apply_local(self, params: Optional[dict], seed: int, x: torch.Tensor, *,
                    path: tuple = (), group=None, plain: bool = False):
        """The layer on tokens ``x`` (T, d): ``(out (T, d), log_q,
        log_p)``. ``params``: the (E, ...) leaves and (d, E) router (a
        ``TransformerStack`` block's), or None for the layer's own; expert
        e draws from (seed, path + (e, j)). ``group``: None (one rank) or
        the rank's :func:`make_ep_mesh`, the layer cut by
        :func:`shard_experts`; every rank gets the whole output and
        log-probs."""
        ranks = sampling.check_group(group, self, "BayesMoE.apply_local")
        params = self.params() if params is None else params
        router = params["router"]
        if ranks is not None:
            x, router = coll.copy_many_to_shards((x, router), ranks.group)
        T, d = x.shape
        C = self.capacity(T)
        E_local = params["wi_mu"].shape[0]
        e0 = 0 if ranks is None else ranks.rank * E_local
        r = self.route(router, x)
        # each kept token of the rank's experts to its row of the (E_local C)
        # slots, every other token to a spare row past them (its contents
        # never reach the output)
        mine = r.keep & (r.expert >= e0) & (r.expert < e0 + E_local)
        flat = torch.where(mine, (r.expert - e0) * C + r.slot, E_local * C)
        inputs = x.new_zeros((E_local * C + 1, d)).index_put((flat,), x)[:E_local * C]
        inputs = inputs.view(E_local, C, d)
        experts = [dict(zip(EXPERT_LEAVES, ts))
                   for ts in zip(*(params[k].unbind(0) for k in EXPERT_LEAVES))]
        ys, log_q, log_p = [], None, None
        for e, leaf in enumerate(experts):
            y, lq, lp = self.expert_apply(leaf, seed, path + (e0 + e,), inputs[e], plain)
            ys.append(y)
            log_q = lq if log_q is None else log_q + lq
            log_p = lp if log_p is None else log_p + lp
        out = torch.cat(ys + [x.new_zeros((1, d))])[flat] * r.gate[:, None]
        if ranks is None:
            return out, log_q, log_p
        kl = coll.reduce_from_shards(torch.stack([log_q, log_p]), ranks.group)
        return coll.reduce_from_shards(out, ranks.group), kl[0], kl[1]


def make_ep_mesh(ep: int, *, backend: str, store=None, rank: Optional[int] = None,
                 world_size: Optional[int] = None) -> coll.Ranks:
    """The calling rank's expert shard on an ``ep``-rank mesh: its index,
    the world size and the group of all ranks. The keywords are
    ``parallel/mesh.py::make_mesh``'s; a world size other than ``ep``
    raises ``ValueError``."""
    return mesh_lib.make_axis(ep, "ep", backend=backend, store=store, rank=rank,
                              world_size=world_size)


def _moe_layers(module: nn.Module) -> list[tuple[str, "BayesMoE"]]:
    return [(name, m) for name, m in module.named_modules() if isinstance(m, BayesMoE)]


def expert_specs(module: nn.Module) -> dict[str, int]:
    """``{parameter name: dim}`` of the expert leaves of every ``BayesMoE``
    in ``module`` (itself, a MoE ``TransformerStack`` or its LM): the expert
    axis, 0 in a layer's (E, ...) leaves and 1 in a stack's (L, E, ...);
    the routers and everything else replicate. The counterpart of the
    reference's ``expert_specs`` and ``moe_stack_specs``."""
    specs = {}
    for name, m in _moe_layers(module):
        prefix = name + "." if name else ""
        specs.update({prefix + k: 0 if m.depth is None else 1 for k in EXPERT_LEAVES})
    if not specs:
        raise ValueError(f"a {type(module).__name__} holds no BayesMoE to shard over ep")
    return specs


def shard_experts(module: nn.Module, ranks: Optional[coll.Ranks]) -> nn.Module:
    """Keep the rank's E/ep experts of every ``BayesMoE`` in ``module``
    (:func:`expert_specs`), in place, and return it; ``ranks`` None is one
    rank."""
    if ranks is not None and ranks.world_size > 1:
        mesh_lib.shard_params(module, expert_specs(module), ranks)
        for _, m in _moe_layers(module):
            m.n_shards = ranks.world_size
    return module


def unshard_experts(module: nn.Module, ranks: Optional[coll.Ranks]) -> nn.Module:
    """A copy of ``module`` with every rank's experts gathered (every rank
    calls it)."""
    return mesh_lib.unshard_params(module, expert_specs(module), ranks)


def make_ep_train_step(moe: BayesMoE, optimizer, *, n_samples: int, n_batches: int,
                       loss_fn: Callable, group=None, plain: bool = False):
    """``step(seed, batch) -> metrics``: the MC-ELBO step of the layer on
    ``batch["x"]`` (T, d) (``pipeline.elbo_step``), the whole batch on every
    rank, updating ``moe`` (the rank's experts and the router under a
    ``group`` of :func:`make_ep_mesh`) in place through ``optimizer``;
    ``loss_fn(out, batch) -> (nll_sum, metrics)``."""
    sampling.check_group(group, moe, "make_ep_train_step")

    def step(seed: int, batch: dict) -> dict[str, torch.Tensor]:
        return elbo_step(optimizer, n_samples, n_batches,
                         lambda s: moe.apply_local(None, s, batch["x"], group=group,
                                                   plain=plain),
                         loss_fn, batch, seed)

    return step
