"""ELBO train and eval step factories (counterpart of
``bayeformers_tpu/training.py``).

A train step runs the S-sample fused forward, the sum-reduced task loss
plus the KL term divided by the number of minibatches, the backward through
the hand-written kernels, the global-norm clip and one AdamW update. PyTorch
runs eagerly, so a step is a plain function; the integer ``seed`` plays the
role of the reference's step key (per-leaf and per-chunk draws derive from
it through ``nn.fused.derive_seed``).

Every estimator of the reference runs (:func:`pick_mc`): the fused tier's
independent draws (``fused``) and antithetic pairs (``antithetic``), the
naive tier, flipout and local reparameterization.

``input_keys`` names the batch's model inputs, passed to the forward by
name: the text models' ``("input_ids", "attention_mask",
"token_type_ids")`` (the default), ViT's ``("pixel_values",)``, CLIP's
``("input_ids", "pixel_values", "attention_mask")``, whose similarity
couples the two tiled batches and takes ``untile_axes=(1,)``
(``nn/fused.py::untile_samples``).
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


def qa_span_loss(out, batch):
    """SQuAD span loss (reference ``training.py:45-58``): the mean of the
    start and end CE on S-averaged logits, each sum-reduced over the batch,
    with the mean of their accuracy metrics. ``out`` is ``(start_logits,
    end_logits)``, each (S, B, L)."""
    start_logits, end_logits = out
    nll = 0.5 * (
        elbo.cross_entropy_sum(elbo.mc_logits_mean(start_logits), batch["start_positions"])
        + elbo.cross_entropy_sum(elbo.mc_logits_mean(end_logits), batch["end_positions"]))
    start_acc, start_std = elbo.accuracy_and_std(start_logits, batch["start_positions"])
    end_acc, end_std = elbo.accuracy_and_std(end_logits, batch["end_positions"])
    return nll, {"acc": 0.5 * (start_acc + end_acc),
                 "acc_std": 0.5 * (start_std + end_std)}


def pick_mc(bmodel, fused: bool, estimator: Optional[str] = None,
            save_weights: bool = True):
    """The MC forward of an estimator, the reference's table and signature
    (``bayeformers_tpu/training.py::pick_mc``): ``"fused"`` (the fused
    forward with independent draws, ``mc_apply_fused``), ``"antithetic"``
    (the fused forward with +- paired draws; needs an even S), ``"naive"``
    (per-sample weights, ``mc_apply``), ``"flipout"`` (per-example
    sign-flipped perturbations, ``mc_apply_flipout``) and ``"local"`` /
    ``"lrt"`` (local reparameterization, ``mc_apply_lrt``). ``estimator=
    None`` takes ``"fused"``, or ``"naive"`` with ``fused=False``.
    ``save_weights`` goes to the fused tier's two entries (keep W for the
    backward, or regenerate it); the other tiers keep no weights."""
    if estimator is None:
        estimator = "fused" if fused else "naive"
    apply_fused = functools.partial(bmodel.mc_apply_fused, save_weights=save_weights)
    table = {
        "fused": functools.partial(apply_fused, antithetic=False),
        "antithetic": functools.partial(apply_fused, antithetic=True),
        "naive": bmodel.mc_apply,
        "flipout": bmodel.mc_apply_flipout,
        "local": bmodel.mc_apply_lrt,
        "lrt": bmodel.mc_apply_lrt,
    }
    if estimator not in table:
        raise ValueError(f"unknown estimator {estimator!r}")
    return table[estimator]


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
                         fused: bool = True,
                         input_keys: tuple[str, ...] = INPUT_KEYS,
                         estimator: Optional[str] = None,
                         mc_chunk: Optional[int] = None,
                         eps_hook: Optional[Callable] = None,
                         untile_axes: tuple[int, ...] = ()):
    """Returns ``step(seed, batch) -> metrics`` (detached 0-d tensors:
    loss, nll, acc/acc_std or mse/mse_std, log_prior,
    log_variational_posterior), which updates the trainable tensors of
    ``bmodel`` in place through ``optimizer`` (``utils.optim.masked_optimizer``).
    ``fused`` and ``estimator`` pick the MC forward as :func:`pick_mc` does:
    by default the fused tier's independent draws, as in the reference.

    ``mc_chunk``: run the S samples in chunks of this size with gradient
    accumulation (fresh draws per chunk, seeds ``derive_seed(seed, c)``);
    losses, gradients and metrics are averaged over chunks.
    ``eps_hook(chunk, *args)`` supplies each leaf's draw (tests only), as the
    estimator's forward calls its hook with ``args`` (the fused tier's
    ``(path, n_draws, shape)``, flipout's and LRT's ``(path, what, shape)``,
    the naive tier's ``(path, shape)``). An antithetic chunk must be even;
    the others may be odd. ``untile_axes`` goes to the forward (CLIP:
    ``(1,)``)."""
    mc = pick_mc(bmodel, fused, estimator)
    n_chunks, chunk = chunks(n_samples, mc_chunk)

    def step(seed: int, batch: dict) -> dict[str, torch.Tensor]:
        totals = accumulate_grads(mc, optimizer, seed, n_chunks, chunk, batch, n_batches,
                                  loss_fn, input_keys, eps_hook, untile_axes)
        optimizer.step()
        return totals

    return step


def chunks(n_samples: int, mc_chunk: Optional[int]) -> tuple[int, int]:
    """``(n_chunks, chunk)`` of S samples run ``mc_chunk`` at a time (one
    chunk of S without it); ``mc_chunk`` must divide S."""
    if mc_chunk is not None and mc_chunk < n_samples:
        if n_samples % mc_chunk:
            raise ValueError(f"mc_chunk={mc_chunk} must divide n_samples={n_samples}")
        return n_samples // mc_chunk, mc_chunk
    return 1, n_samples


def accumulate_grads(mc, optimizer: ClippedAdamW, seed: int, n_chunks: int, chunk: int,
                     batch: dict, n_batches: int, loss_fn: Callable,
                     input_keys: tuple[str, ...], eps_hook: Optional[Callable] = None,
                     untile_axes: tuple[int, ...] = (), **mc_kwargs) -> dict:
    """A step's gradients in ``optimizer``'s tensors (zeroed first): the
    ELBO objective of each chunk (seeds ``derive_seed(seed, c)`` when there
    are several) backwarded, then the gradients and the metrics averaged
    over the chunks; returns the metrics (detached 0-d tensors).
    ``mc_kwargs`` go to the forward."""
    optimizer.zero_grad()
    totals: dict[str, torch.Tensor] = {}
    for c in range(n_chunks):
        hook = None if eps_hook is None else functools.partial(eps_hook, c)
        loss, metrics = elbo_objective(
            mc, seed if n_chunks == 1 else derive_seed(seed, c), chunk, batch,
            n_batches, loss_fn, input_keys, eps_hook=hook, untile_axes=untile_axes,
            **mc_kwargs)
        loss.backward()
        for k, v in metrics.items():
            v = torch.as_tensor(v).detach()
            totals[k] = totals[k] + v if k in totals else v
    if n_chunks > 1:
        with torch.no_grad():
            for g in optimizer.grads():
                g.div_(n_chunks)
        totals = {k: v / n_chunks for k, v in totals.items()}
    return totals


def make_elbo_eval_step(bmodel, n_samples: int,
                        loss_fn: Callable = classification_loss,
                        fused: bool = True,
                        input_keys: tuple[str, ...] = INPUT_KEYS,
                        estimator: Optional[str] = None,
                        untile_axes: tuple[int, ...] = ()):
    """Returns ``eval_step(seed, batch) -> (out, metrics)``, run under
    ``torch.inference_mode()`` (the fused tier without weight residuals);
    ``fused`` and ``estimator`` as in :func:`pick_mc`, ``untile_axes`` as in
    :func:`make_elbo_train_step`."""
    mc = pick_mc(bmodel, fused, estimator, save_weights=False)

    @torch.inference_mode()
    def eval_step(seed: int, batch: dict):
        inputs = {k: batch[k] for k in input_keys if k in batch}
        out, aux = mc(seed, n_samples, **inputs, untile_axes=untile_axes)
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
