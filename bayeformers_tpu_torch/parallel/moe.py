"""Top-1 Bayesian mixture of experts (counterpart of
``bayeformers_tpu/parallel/moe.py`` at ep = 1).

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
kernel #7/#8 at M = C and #9 in the backward. Process groups: ``None`` or
a group of one; the experts' shards over ranks are ROADMAP queue 1 item
6(c).
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from bayeformers_tpu_torch.models.bert import check_device
from bayeformers_tpu_torch.nn.layers import Generator, as_generator
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
        self.capacity_factor = capacity_factor
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
        e draws from (seed, path + (e, j))."""
        sampling.check_group(group, "BayesMoE.apply_local")
        params = self.params() if params is None else params
        T, d = x.shape
        E, C = self.n_experts, self.capacity(T)
        r = self.route(params["router"], x)
        # each kept token's row of the (E C) slots, the dropped ones' a spare
        # row past them (its contents never reach the output)
        flat = torch.where(r.keep, r.expert * C + r.slot, E * C)
        inputs = x.new_zeros((E * C + 1, d)).index_put((flat,), x)[:E * C].view(E, C, d)
        experts = [dict(zip(EXPERT_LEAVES, ts))
                   for ts in zip(*(params[k].unbind(0) for k in EXPERT_LEAVES))]
        ys, log_q, log_p = [], None, None
        for e, leaf in enumerate(experts):
            y, lq, lp = self.expert_apply(leaf, seed, path + (e,), inputs[e], plain)
            ys.append(y)
            log_q = lq if log_q is None else log_q + lq
            log_p = lp if log_p is None else log_p + lp
        out = torch.cat(ys + [x.new_zeros((1, d))])[flat] * r.gate[:, None]
        return out, log_q, log_p


def make_ep_train_step(moe: BayesMoE, optimizer, *, n_samples: int, n_batches: int,
                       loss_fn: Callable, group=None, plain: bool = False):
    """``step(seed, batch) -> metrics``: the MC-ELBO step of the layer on
    ``batch["x"]`` (T, d) (``pipeline.elbo_step``), updating ``moe`` in
    place through ``optimizer``; ``loss_fn(out, batch) -> (nll_sum,
    metrics)``."""
    sampling.check_group(group, "make_ep_train_step")

    def step(seed: int, batch: dict) -> dict[str, torch.Tensor]:
        return elbo_step(optimizer, n_samples, n_batches,
                         lambda s: moe.apply_local(None, s, batch["x"], plain=plain),
                         loss_fn, batch, seed)

    return step
