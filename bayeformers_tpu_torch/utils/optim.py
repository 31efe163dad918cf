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

    AdamW is ``torch.optim.AdamW`` with two parameter groups (decayed and
    not), whose decoupled decay is optax's ``add_decayed_weights`` before
    the learning-rate scale; the learning rate is set from the schedule at
    the update count before each step, as ``inject_hyperparams`` does."""

    def __init__(self, named: Iterable[tuple[str, torch.Tensor, bool]],
                 lr: Schedule, weight_decay: float, eps: float = 1e-8,
                 clip_norm: Optional[float] = 1.0):
        named = list(named)
        self.params = [t for _, t, _ in named]
        self.lr = lr
        self.clip_norm = clip_norm
        self.count = 0
        groups = [
            {"params": [t for _, t, d in named if d], "weight_decay": weight_decay},
            {"params": [t for _, t, d in named if not d], "weight_decay": 0.0},
        ]
        self._decay_group = groups[0]
        self.opt = torch.optim.AdamW([g for g in groups if g["params"]],
                                     lr=self.lr_at(0), betas=(0.9, 0.999),
                                     eps=eps)

    def lr_at(self, count: int) -> float:
        return float(self.lr(count)) if callable(self.lr) else float(self.lr)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def grads(self) -> list[torch.Tensor]:
        return [p.grad for p in self.params if p.grad is not None]

    def set_weight_decay(self, weight_decay: float) -> None:
        self._decay_group["weight_decay"] = float(weight_decay)

    @torch.no_grad()
    def step(self) -> None:
        """Clip the gradients in place, then one AdamW update."""
        if self.clip_norm is not None:
            clip_by_global_norm_(self.grads(), self.clip_norm)
        lr = self.lr_at(self.count)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        self.count += 1


def masked_optimizer(tx, bmodel) -> ClippedAdamW:
    """``tx`` (``training.adamw_with_decay_groups``) over the trainable
    tensors of a converted model only (``BayesianModel.trainable_parameters``,
    which also sets ``requires_grad`` from the trainable mask)."""
    return tx.init(bmodel.trainable_parameters(tx.mask_no_decay))
