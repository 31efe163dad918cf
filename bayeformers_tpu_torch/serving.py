"""Batched posterior-predictive inference (counterpart of
``bayeformers_tpu/serving.py::Predictor``).

A :class:`Predictor` pads a ragged request up to the smallest configured
(batch, sequence) bucket, always masking the padding, runs one fused
S-sample forward without weight residuals, drops the padded rows, and
returns posterior-predictive summaries: mean probabilities, epistemic std,
predictive entropy and the BALD mutual information.

Deterministic serving: a request's draws derive from the caller's seed and
its bucket, so identical (inputs, seed) give identical outputs on the same
hardware (the kernels sum in a fixed order; nothing uses float atomics).

Usage::

    predictor = Predictor(bmodel, n_samples=10, batch_sizes=(8,),
                          seq_lens=(128,))
    out = predictor(batch, seed=123)      # dict of numpy arrays, depadded
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from bayeformers_tpu_torch.nn.fused import derive_seed

INPUT_KEYS = ("input_ids", "attention_mask", "token_type_ids")


def _trim_pad_columns(batch: dict) -> dict:
    """Drop trailing all-pad token columns so short requests land in the
    smallest sequence bucket that fits (featurizers pad to the largest)."""
    true_l = max(1, int(np.asarray(batch["attention_mask"]).sum(-1).max()))
    return {k: np.asarray(v)[:, :true_l] for k, v in batch.items()}


def _bucket(value: int, sizes: tuple[int, ...], kind: str) -> int:
    for s in sorted(sizes):
        if value <= s:
            return s
    raise ValueError(
        f"{kind}={value} exceeds the largest configured bucket {max(sizes)}; "
        f"raise Predictor({kind}s=...) or shard the request"
    )


def summarize(logits: torch.Tensor) -> dict[str, torch.Tensor]:
    """(S, B, C) logits -> posterior-predictive summaries over the S draws."""
    probs_s = torch.softmax(logits.float(), dim=-1)
    probs = probs_s.mean(0)

    def ent(p):
        return -torch.sum(p * torch.log(torch.clamp(p, min=1e-12)), dim=-1)

    entropy = ent(probs)
    return {
        "probs": probs,
        "epistemic_std": probs_s.std(0, unbiased=False),
        "entropy": entropy,
        # BALD: H[mean_s p_s] - mean_s H[p_s], the epistemic share
        "mutual_info": entropy - ent(probs_s).mean(0),
        "pred": torch.argmax(probs, dim=-1),
    }


@dataclasses.dataclass
class Predictor:
    """Bucketed Bayesian classification serving over a converted model.

    This slice serves the antithetic estimator (``antithetic=True``, even
    ``n_samples``) for ``task="classification"``.
    """

    bmodel: Any
    n_samples: int = 10
    batch_sizes: tuple[int, ...] = (1, 8, 32)
    seq_lens: tuple[int, ...] = (128,)
    pad_id: int = 0
    antithetic: bool = True
    task: str = "classification"

    def __post_init__(self):
        if not self.antithetic:
            raise NotImplementedError(
                "Predictor: the independent-draw estimator (antithetic=False) "
                "comes with the next slice of the port"
            )
        if self.n_samples % 2:
            raise ValueError("antithetic serving needs an even n_samples")
        if self.task != "classification":
            raise NotImplementedError(
                f"Predictor: task {self.task!r} comes with a later slice"
            )

    def __call__(self, batch: dict, seed: int = 0) -> dict[str, np.ndarray]:
        """Run one request batch; returns depadded numpy arrays."""
        inputs = {k: np.asarray(batch[k]) for k in INPUT_KEYS if k in batch}
        n, L = inputs["input_ids"].shape
        if "attention_mask" not in inputs:
            # bucket padding must be masked even when the caller omits the
            # mask, else results depend on the bucket the request lands in
            inputs["attention_mask"] = np.ones((n, L), np.int64)
        nb = _bucket(n, self.batch_sizes, "batch_size")
        lb = _bucket(L, self.seq_lens, "seq_len")
        dev = self.bmodel.device
        padded = {}
        for k, v in inputs.items():
            fill = self.pad_id if k == "input_ids" else 0
            out = np.full((nb, lb), fill, np.int64)
            out[:n, :L] = v
            padded[k] = torch.from_numpy(out).to(dev)
        key = derive_seed(seed, nb * 100003 + lb)
        with torch.inference_mode():
            logits, _ = self.bmodel.mc_apply_fused(
                key, self.n_samples, padded["input_ids"],
                padded["attention_mask"], padded.get("token_type_ids"),
                save_weights=False, antithetic=True,
            )
            return {k: v[:n].cpu().numpy() for k, v in summarize(logits).items()}

    def predict_featurized(self, batch: dict, seed: int = 0) -> dict[str, np.ndarray]:
        """Serve a batch a featurizer padded to its own maximum length: the
        trailing all-pad columns go first, so it lands in the smallest
        sequence bucket that fits."""
        return self(_trim_pad_columns(batch), seed=seed)
