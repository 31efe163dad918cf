"""MNIST MLP workload on one GPU (counterpart of
``bayeformers_tpu/workloads/mlp_mnist.py``, the reference's
``examples/mlp_mnist.py``).

The reference's four phases:

1. frequentist training (Adam lr 1e-3, the NLL summed over the batch on
   the log-softmax outputs, one epoch, batch 64);
2. ``to_bayesian(model, delta=0.05)`` (MOPED; mu trains, the prior sits on
   a fixed copy of the weights);
3. Bayesian evaluation with S=10 samples on the whole test set;
4. Bayesian ELBO training with a fresh Adam over the trainable tensors.

As in the JAX workload, phase 4 gets a fresh optimizer (the reference
reuses the frequentist one and never steps the converted model) and the KL
term is differentiable. ``--estimator`` picks the MC forward of phases 3
and 4 (``training.pick_mc``): ``naive`` (the default: per-sample weights
from a ``torch.Generator`` multiplied by ``torch.bmm``, no Bayesian linear
kernel), ``fused`` (kernels #7/#8 forward, #9 backward), ``antithetic``,
``flipout`` or ``local``. Data: the MNIST idx files under ``--data-dir``
(plain or gzipped), else the JAX package's synthetic stand-in from the
seed (``utils/data.py::load_mnist``). Scalars go to ``logs/<run>.jsonl``
and the results tree to ``logs/<run>.results.json``.

    python -m bayeformers_tpu_torch.workloads.mlp_mnist --limit-batches 3
    python -m bayeformers_tpu_torch.workloads.mlp_mnist --estimator fused
"""
from __future__ import annotations

import argparse
import itertools
import os
import time

import torch

from bayeformers_tpu_torch import elbo, training
from bayeformers_tpu_torch.models.mlp import build_mlp
from bayeformers_tpu_torch.nn.fused import derive_seed
from bayeformers_tpu_torch.nn.surgery import to_bayesian
from bayeformers_tpu_torch.utils import data as data_lib
from bayeformers_tpu_torch.utils.dumper import Dumper
from bayeformers_tpu_torch.utils.metrics import MetricsWriter, Report, run_name
from bayeformers_tpu_torch.utils.optim import ClippedAdamW, masked_optimizer

# Reference constants (``examples/mlp_mnist.py:30-35``)
EPOCHS = 1
B_EPOCHS = 1
SAMPLES = 10
BATCH_SIZE = 64
LR = 1e-3
DELTA = 0.05
ESTIMATORS = ("naive", "fused", "flipout", "antithetic", "local")
INPUT_KEYS = ("input_ids",)  # the images ride the models' first input


def mlp_loss(out, batch):
    """The NLL summed over the batch of the S-mean log-probabilities, with
    the accuracy of the S-mean prediction and the std of the per-draw
    accuracies."""
    labels = batch["labels"]
    nll = elbo.nll_sum_from_log_probs(elbo.mc_logits_mean(out), labels)
    acc, acc_std = elbo.accuracy_and_std(out, labels)
    return nll, {"acc": acc, "acc_std": acc_std}


def adam(named, lr: float) -> ClippedAdamW:
    """optax's ``adam(lr)``: no weight decay, no clip, eps 1e-8."""
    return ClippedAdamW(named, lr, 0.0, eps=1e-8, clip_norm=None)


def train(exp: str = "mlp_mnist", data_dir: str = "dataset/mnist", logs: str = "logs",
          epochs: int = EPOCHS, b_epochs: int = B_EPOCHS, samples: int = SAMPLES,
          batch_size: int = BATCH_SIZE, lr: float = LR, delta: float = DELTA,
          seed: int = 0, limit_batches: int | None = None, estimator: str = "naive",
          device: str = "cuda") -> dict[str, float]:
    """Run phases 1-4; returns the frequentist, MOPED and final Bayesian
    test accuracies and the last ``acc_std``."""
    if estimator not in ESTIMATORS:
        raise ValueError(f"unknown estimator {estimator!r}; one of {ESTIMATORS}")
    x_train, y_train, x_test, y_test, synthetic = data_lib.load_mnist(data_dir)
    if synthetic:
        print("[mlp_mnist] MNIST not found; using synthetic stand-in data")
    n_batches = data_lib.num_batches(len(x_train), batch_size)
    if limit_batches:
        n_batches = min(n_batches, limit_batches)

    dev = torch.device(device)
    name = run_name(exp, delta=delta)
    writer = MetricsWriter(logs, name)
    dumper = Dumper(os.path.join(logs, name + ".results"))
    model = build_mlp(seed, input_dim=x_train.shape[-1], device=dev)
    test = {"input_ids": torch.from_numpy(x_test).to(dev),
            "labels": torch.from_numpy(y_test).to(dev)}

    def epoch_batches(shuffle_seed):
        for i, (x, y) in enumerate(data_lib.batches(x_train, y_train, batch_size,
                                                    seed=shuffle_seed)):
            if limit_batches and i >= limit_batches:
                break
            yield {"input_ids": torch.from_numpy(x).to(dev),
                   "labels": torch.from_numpy(y).to(dev)}

    # ---------------- Phase 1: frequentist train ---------------------------
    opt = adam(training.model_parameters(model, lambda p: False), lr)

    def f_step(batch):
        opt.zero_grad()
        loss = elbo.nll_sum_from_log_probs(model(batch["input_ids"]), batch["labels"])
        loss.backward()
        opt.step()
        return loss.detach()

    @torch.inference_mode()
    def f_eval():
        log_probs = model(test["input_ids"])
        acc = torch.mean((torch.argmax(log_probs, -1) == test["labels"]).float())
        return {"nll": float(elbo.nll_sum_from_log_probs(log_probs, test["labels"]))
                / len(x_test), "acc": float(acc)}

    with dumper.section("frequentist_train"):
        for epoch in range(epochs):
            report = Report("nll")
            for batch in epoch_batches(seed + epoch):
                report.update(nll=float(f_step(batch)))
            metrics = f_eval()
            writer.scalars("frequentist", metrics, epoch)
            dumper.record(**{f"epoch_{epoch}_{k}": v for k, v in metrics.items()})
            print(f"[freq {epoch}] test nll={metrics['nll']:.4f} acc={metrics['acc']:.4f}")
    freq_acc = metrics["acc"]
    opt.zero_grad()

    # ---------------- Phase 2: MOPED conversion ----------------------------
    bmodel = to_bayesian(model, delta=delta)

    # ---------------- Phase 3 & 4: Bayesian eval + ELBO train --------------
    eval_step = training.make_elbo_eval_step(bmodel, samples, loss_fn=mlp_loss,
                                             input_keys=INPUT_KEYS, estimator=estimator)
    b_opt = masked_optimizer(training.adamw_with_decay_groups(
        lr, 0.0, training.default_no_decay, eps=1e-8, clip_norm=None), bmodel)
    b_step = training.make_elbo_train_step(bmodel, b_opt, samples, n_batches,
                                           loss_fn=mlp_loss, input_keys=INPUT_KEYS,
                                           estimator=estimator)
    draws = itertools.count()  # the step key stream: seed + 1, split per use

    def next_seed() -> int:
        return derive_seed(seed + 1, next(draws))

    def b_eval(with_kl: bool):
        _, m = eval_step(next_seed(), test)
        metrics = {"nll": float(m["nll"]) / len(x_test), "acc": float(m["acc"]),
                   "acc_std": float(m["acc_std"])}
        if with_kl:
            metrics["log_prior"] = float(m["log_prior"])
            metrics["log_variational_posterior"] = float(m["log_variational_posterior"])
        return metrics

    with dumper.section("bayesian_eval"):
        metrics = b_eval(True)
        writer.scalars("bayesian_eval", metrics, 0)
        dumper.record(**metrics)
        print(f"[baye eval] acc={metrics['acc']:.4f} acc_std={metrics['acc_std']:.4f}")
    moped_acc = metrics["acc"]

    with dumper.section("bayesian_train"):
        for epoch in range(b_epochs):
            report = Report("loss", "nll")
            for batch in epoch_batches(seed + 100 + epoch):
                m = b_step(next_seed(), batch)
                report.update(loss=float(m["loss"]), nll=float(m["nll"]))
            metrics = b_eval(False)
            writer.scalars("bayesian", metrics, epoch)
            dumper.record(**{f"epoch_{epoch}_{k}": v for k, v in metrics.items()})
            print(f"[baye {epoch}] test nll={metrics['nll']:.4f} acc={metrics['acc']:.4f} "
                  f"acc_std={metrics['acc_std']:.4f}")
    writer.close()
    dumper.flush()
    return {"freq_acc": freq_acc, "moped_acc": moped_acc, "bayesian_acc": metrics["acc"],
            "acc_std": metrics["acc_std"]}


def main():
    parser = argparse.ArgumentParser(description="Bayesian MLP on MNIST (one GPU)")
    parser.add_argument("--data-dir", default="dataset/mnist")
    parser.add_argument("--logs", default="logs")
    parser.add_argument("--epochs", type=int, default=EPOCHS)
    parser.add_argument("--b-epochs", type=int, default=B_EPOCHS)
    parser.add_argument("--samples", type=int, default=SAMPLES)
    parser.add_argument("--batch-size", type=int, default=BATCH_SIZE)
    parser.add_argument("--lr", type=float, default=LR)
    parser.add_argument("--delta", type=float, default=DELTA)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--limit-batches", type=int, default=None)
    parser.add_argument("--estimator", default="naive", choices=list(ESTIMATORS))
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    t0 = time.time()
    results = train(data_dir=args.data_dir, logs=args.logs, epochs=args.epochs,
                    b_epochs=args.b_epochs, samples=args.samples,
                    batch_size=args.batch_size, lr=args.lr, delta=args.delta,
                    seed=args.seed, limit_batches=args.limit_batches,
                    estimator=args.estimator, device=args.device)
    print(f"done in {time.time() - t0:.1f}s: {results}")


if __name__ == "__main__":
    main()
