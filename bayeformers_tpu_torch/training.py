"""ELBO train and eval step factories (counterpart of
``bayeformers_tpu/training.py``).

A train step runs the S-sample fused forward, the sum-reduced task loss
plus the KL term divided by the number of minibatches, the backward through
the hand-written kernels, the global-norm clip and one AdamW update. PyTorch
runs eagerly, so a step is a plain function; the integer ``seed`` plays the
role of the reference's step key (per-leaf and per-chunk draws derive from
it through ``nn.fused.derive_seed``).

This slice ports the antithetic estimator of the GLUE recipe; the other
estimators raise ``NotImplementedError`` naming the slice that brings them.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from bayeformers_tpu_torch import elbo
from bayeformers_tpu_torch.nn.fused import derive_seed
from bayeformers_tpu_torch.utils.optim import ClippedAdamW, Schedule

INPUT_KEYS = ("input_ids", "attention_mask", "token_type_ids")


def classification_loss(out, batch):
    """Sum-reduced CE on S-averaged logits + accuracy metrics."""
    labels = batch["labels"]
    nll = elbo.cross_entropy_sum(elbo.mc_logits_mean(out), labels)
    acc, acc_std = elbo.accuracy_and_std(out, labels)
    return nll, {"acc": acc, "acc_std": acc_std}


def regression_loss(out, batch):
    """Sum-reduced MSE on the S-averaged scalar head (STS-B); ``mse_std`` is
    the std of the per-draw MSEs."""
    targets = batch["labels"].float()
    per_sample = out[..., 0].float()  # (S, B)
    preds = torch.mean(per_sample, dim=0)
    nll = torch.sum((preds - targets) ** 2)
    per_sample_mse = torch.mean((per_sample - targets[None]) ** 2, dim=1)
    return nll, {"mse": nll / targets.shape[0],
                 "mse_std": torch.std(per_sample_mse, unbiased=False)}


_LATER_ESTIMATORS = {
    "fused": "independent draws (the `fused` estimator) come with the serving "
             "remainder slice",
    "naive": "the naive (per-sample) tier comes with the estimators slice",
    "flipout": "flipout comes with the estimators slice",
    "local": "local reparameterization comes with the estimators slice",
    "lrt": "local reparameterization comes with the estimators slice",
}


def pick_mc(bmodel, estimator: str = "antithetic"):
    """The MC forward of an estimator: ``"antithetic"`` (the fused forward
    with +- paired draws, the reference's default for even S)."""
    if estimator == "antithetic":
        return functools.partial(bmodel.mc_apply_fused, antithetic=True)
    if estimator in _LATER_ESTIMATORS:
        raise NotImplementedError(f"estimator {estimator!r}: "
                                  f"{_LATER_ESTIMATORS[estimator]}")
    raise ValueError(f"unknown estimator {estimator!r}")


def elbo_objective(mc, seed: int, n_samples: int, batch: dict, n_batches: int,
                   loss_fn: Callable = classification_loss,
                   input_keys: tuple[str, ...] = INPUT_KEYS, **mc_kwargs):
    """``(loss, metrics)`` of one S-sample forward: the reference step's
    ``objective``. ``mc_kwargs`` go to the forward (``impl="plain"`` runs
    every op's plain version, the reference for the kernels on the card)."""
    inputs = {k: batch[k] for k in input_keys if k in batch}
    out, aux = mc(seed, n_samples, **inputs, **mc_kwargs)
    nll, metrics = loss_fn(out, batch)
    loss = elbo.elbo_loss(nll, aux["log_prior"], aux["log_variational_posterior"],
                          n_batches)
    metrics = dict(
        metrics, nll=nll, log_prior=torch.mean(aux["log_prior"]),
        log_variational_posterior=torch.mean(aux["log_variational_posterior"]),
        loss=loss,
    )
    return loss, metrics


def make_elbo_train_step(bmodel, optimizer: ClippedAdamW, n_samples: int,
                         n_batches: int, loss_fn: Callable = classification_loss,
                         input_keys: tuple[str, ...] = INPUT_KEYS,
                         estimator: str = "antithetic",
                         mc_chunk: Optional[int] = None,
                         eps_hook: Optional[Callable] = None):
    """Returns ``step(seed, batch) -> metrics`` (detached 0-d tensors:
    loss, nll, acc/acc_std or mse/mse_std, log_prior,
    log_variational_posterior), which updates the trainable tensors of
    ``bmodel`` in place through ``optimizer`` (``utils.optim.masked_optimizer``).

    ``mc_chunk``: run the S samples in chunks of this size with gradient
    accumulation (fresh draws per chunk, seeds ``derive_seed(seed, c)``);
    losses, gradients and metrics are averaged over chunks.
    ``eps_hook(chunk, path, n_draws, shape)`` supplies each leaf's draw
    (tests only)."""
    mc = pick_mc(bmodel, estimator)
    n_chunks, chunk = 1, n_samples
    if mc_chunk is not None and mc_chunk < n_samples:
        if n_samples % mc_chunk:
            raise ValueError(f"mc_chunk={mc_chunk} must divide n_samples={n_samples}")
        n_chunks, chunk = n_samples // mc_chunk, mc_chunk

    def step(seed: int, batch: dict) -> dict[str, torch.Tensor]:
        optimizer.zero_grad()
        totals: dict[str, torch.Tensor] = {}
        for c in range(n_chunks):
            hook = None if eps_hook is None else functools.partial(eps_hook, c)
            loss, metrics = elbo_objective(
                mc, seed if n_chunks == 1 else derive_seed(seed, c), chunk, batch,
                n_batches, loss_fn, input_keys, eps_hook=hook)
            loss.backward()
            for k, v in metrics.items():
                v = torch.as_tensor(v).detach()
                totals[k] = totals[k] + v if k in totals else v
        if n_chunks > 1:
            with torch.no_grad():
                for g in optimizer.grads():
                    g.div_(n_chunks)
            totals = {k: v / n_chunks for k, v in totals.items()}
        optimizer.step()
        return totals

    return step


def make_elbo_eval_step(bmodel, n_samples: int,
                        loss_fn: Callable = classification_loss,
                        input_keys: tuple[str, ...] = INPUT_KEYS,
                        estimator: str = "antithetic"):
    """Returns ``eval_step(seed, batch) -> (out, metrics)``, run under
    ``torch.inference_mode()`` without weight residuals."""
    mc = functools.partial(pick_mc(bmodel, estimator), save_weights=False)

    @torch.inference_mode()
    def eval_step(seed: int, batch: dict):
        inputs = {k: batch[k] for k in input_keys if k in batch}
        out, aux = mc(seed, n_samples, **inputs)
        nll, metrics = loss_fn(out, batch)
        metrics = dict(
            metrics, nll=nll, log_prior=torch.mean(aux["log_prior"]),
            log_variational_posterior=torch.mean(aux["log_variational_posterior"]),
        )
        return out, metrics

    return eval_step


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Callable[[int], float]:
    """optax's ``linear_schedule``, with its arithmetic: the Python-float
    difference of the ends, then float32."""
    f32 = np.float32

    def schedule(count: int) -> float:
        if transition_steps <= 0:
            return float(f32(init_value))
        c = min(max(count, 0), transition_steps)
        frac = f32(1.0) - f32(c) / f32(transition_steps)
        return float(f32(init_value - end_value) * frac + f32(end_value))

    return schedule


def join_schedules(schedules: list[Callable[[int], float]],
                   boundaries: list[int]) -> Callable[[int], float]:
    """optax's ``join_schedules``: schedule i runs from boundary i - 1, its
    count restarted there."""
    def schedule(count: int) -> float:
        start = 0
        for fn, bound in zip(schedules, boundaries):
            if count < bound:
                return fn(count - start)
            start = bound
        return schedules[len(boundaries)](count - start)

    return schedule


@dataclasses.dataclass(frozen=True)
class AdamWDecayGroups:
    """The optimizer of :func:`adamw_with_decay_groups`; ``init`` builds
    it over ``(name, tensor, decays)`` triples."""

    lr: Schedule
    weight_decay: float
    mask_no_decay: Callable[[str], bool]
    eps: float = 1e-8
    clip_norm: Optional[float] = 1.0

    def init(self, named: Iterable[tuple[str, torch.Tensor, bool]]) -> ClippedAdamW:
        return ClippedAdamW(named, self.lr, self.weight_decay, eps=self.eps,
                            clip_norm=self.clip_norm)


def adamw_with_decay_groups(lr: Schedule, weight_decay: float,
                            mask_no_decay: Callable[[str], bool],
                            eps: float = 1e-8,
                            clip_norm: Optional[float] = 1.0) -> AdamWDecayGroups:
    """AdamW with the ``mask_no_decay(path)`` parameters (bias, LayerNorm)
    and every rho out of weight decay, after a global-norm clip over the
    trainable tensors; ``lr`` is a float or a schedule of the update
    count."""
    return AdamWDecayGroups(lr, weight_decay, mask_no_decay, eps, clip_norm)


def set_weight_decay(optimizer: ClippedAdamW, weight_decay: float) -> ClippedAdamW:
    """Set the decayed group's ``weight_decay`` (the reference replaces the
    injected hyperparameter in the optimizer state)."""
    optimizer.set_weight_decay(weight_decay)
    return optimizer


def default_no_decay(path: str) -> bool:
    """bias and normalisation parameters skip weight decay (HF convention):
    leaves named ``bias`` or ``scale``, and anything under a LayerNorm."""
    lowered = path.lower()
    return (lowered.endswith("bias") or lowered.endswith("scale")
            or "layernorm" in lowered.replace("_", ""))


def model_parameters(model: torch.nn.Module, mask_no_decay: Callable[[str], bool]
                     ) -> list[tuple[str, torch.Tensor, bool]]:
    """``(path, tensor, decays)`` of every parameter of a frequentist model,
    all made trainable (the reference's phase A trains the whole tree)."""
    out = []
    for name, p in model.named_parameters():
        path = name.replace(".", "/")
        p.requires_grad_(True)
        out.append((path, p, not mask_no_decay(path)))
    return out
