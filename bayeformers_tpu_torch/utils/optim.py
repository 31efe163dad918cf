"""The optimizer over a model's trainable tensors (counterpart of
``bayeformers_tpu/utils/optim.py::masked_optimizer``).

In optax a mask decides which leaves the wrapped ``chain(clip, adamw)``
sees, and a second mask zeroes the updates of the rest. Here only the
trainable tensors reach the optimizer at all: a frozen tensor has
``requires_grad`` False, so it gets no gradient, no update and no weight
decay, and it stays out of the clip's global norm.
"""
from __future__ import annotations

from typing import Callable, Iterable, Optional, Union

import torch

Schedule = Union[float, Callable[[int], float]]


def global_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    """``sqrt(sum_i sum(g_i^2))`` in float32."""
    return torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in grads))


def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` in place: every gradient becomes
    ``g / norm * max_norm`` unless ``norm < max_norm`` (no epsilon, unlike
    ``torch.nn.utils.clip_grad_norm_``). Returns the norm before clipping."""
    norm = global_norm(grads)
    if not bool(norm < max_norm):
        for g in grads:
            g.div_(norm.to(g.dtype)).mul_(max_norm)
    return norm


class ClippedAdamW:
    """``chain(clip_by_global_norm(clip_norm), adamw(lr(count), eps,
    weight_decay, mask=decays))`` over ``(name, tensor, decays)`` triples.

    The update is optax's, in its order: the moments ``m = b1 m + (1 - b1)
    g`` and ``v = b2 v + (1 - b2) g^2``, ``u = m_hat / (sqrt(v_hat) + eps)``,
    plus ``weight_decay * p`` on the decayed tensors (``add_decayed_weights``),
    then ``p -= lr * u``, in multi-tensor (``torch._foreach_*``) ops. The
    decay is part of the update, as in optax: ``torch.optim.AdamW``'s
    ``p *= 1 - lr * weight_decay`` drops it in f32 once ``lr *
    weight_decay`` is below 2^-24 (the GPT-2 workload's 5e-5 x 1e-4). The
    learning rate is set from the schedule at the update count before each
    step, as ``inject_hyperparams`` does."""

    B1, B2 = 0.9, 0.999

    def __init__(self, named: Iterable[tuple[str, torch.Tensor, bool]],
                 lr: Schedule, weight_decay: float, eps: float = 1e-8,
                 clip_norm: Optional[float] = 1.0):
        named = list(named)
        self.params = [t for _, t, _ in named]
        self.decays = [d for _, _, d in named]
        self.lr = lr
        self.weight_decay = float(weight_decay)
        self.eps = eps
        self.clip_norm = clip_norm
        self.count = 0
        self.m = [torch.zeros_like(t) for t in self.params]
        self.v = [torch.zeros_like(t) for t in self.params]

    def lr_at(self, count: int) -> float:
        return float(self.lr(count)) if callable(self.lr) else float(self.lr)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def grads(self) -> list[torch.Tensor]:
        """The gradients that exist: a tensor without one adds nothing to the
        global norm, nor to a chunked step's average."""
        return [p.grad for p in self.params if p.grad is not None]

    def set_weight_decay(self, weight_decay: float) -> None:
        self.weight_decay = float(weight_decay)

    @torch.no_grad()
    def step(self) -> None:
        """Clip the gradients in place, then one AdamW update of every
        tensor. A tensor whose ``grad`` is None (a trainable leaf the loss
        did not reach) takes a zero gradient, as under optax's ``masked``:
        its moments decay, it takes the m_hat update and it is decayed."""
        if self.clip_norm is not None:
            clip_by_global_norm_(self.grads(), self.clip_norm)
        lr = self.lr_at(self.count)
        self.count += 1
        if not self.params:
            return
        ps, ms, vs = self.params, self.m, self.v
        gs = [torch.zeros_like(p) if p.grad is None else p.grad for p in ps]
        torch._foreach_mul_(ms, self.B1)
        torch._foreach_add_(ms, gs, alpha=1.0 - self.B1)
        torch._foreach_mul_(vs, self.B2)
        torch._foreach_addcmul_(vs, gs, gs, value=1.0 - self.B2)
        den = torch._foreach_div(vs, 1.0 - self.B2 ** self.count)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(ms, 1.0 - self.B1 ** self.count)
        torch._foreach_div_(upd, den)
        if self.weight_decay:
            dec = [j for j, d in enumerate(self.decays) if d]
            if dec:
                torch._foreach_add_([upd[j] for j in dec], [ps[j] for j in dec],
                                    alpha=self.weight_decay)
        torch._foreach_add_(ps, upd, alpha=-lr)


def masked_optimizer(tx, bmodel) -> ClippedAdamW:
    """``tx`` (``training.adamw_with_decay_groups``) over the trainable
    tensors of a converted model only (``BayesianModel.trainable_parameters``,
    which also sets ``requires_grad`` from the trainable mask)."""
    return tx.init(bmodel.trainable_parameters(tx.mask_no_decay))
