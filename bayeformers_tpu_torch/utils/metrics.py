"""Metrics logging and GLUE scores (counterpart of
``bayeformers_tpu/utils/metrics.py``): the ``Report`` accumulator, the
JSON-lines scalar writer (one ``{"step", "tag", "value", "wall"}`` object
per line), run naming, the official GLUE metrics and the expected
calibration error; with ``tensorboard=True`` the writer also writes
TensorBoard event files (``utils/tb.py``).
"""
from __future__ import annotations

import json
import os
import time

import numpy as np


class Report:
    """Running-mean accumulator for scalar metrics.

    ``report.update(loss=..., acc=...)`` adds weighted values;
    ``report.means(n)`` divides by the given denominator. Matches the
    reference's usage where totals are divided by dataset size at epoch end.
    """

    def __init__(self, *names: str):
        self.totals = {name: 0.0 for name in names}

    def update(self, **values: float) -> None:
        for name, v in values.items():
            self.totals[name] = self.totals.get(name, 0.0) + float(v)

    def means(self, denom: float) -> dict[str, float]:
        return {name: total / denom for name, total in self.totals.items()}

    def reset(self) -> None:
        for name in self.totals:
            self.totals[name] = 0.0


class MetricsWriter:
    """Append-only JSONL scalar writer, one file per run
    (``logdir/<run_name>.jsonl``). ``tensorboard=True`` also writes
    TensorBoard event files under ``logdir/<run_name>/`` (``utils/tb.py``:
    the reference's tensorboardX scalars without the dependency)."""

    def __init__(self, logdir: str, run_name: str, tensorboard: bool = False):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, f"{run_name}.jsonl")
        self._fh = open(self.path, "a", buffering=1)
        self._t0 = time.time()
        self._tb = None
        if tensorboard:
            from bayeformers_tpu_torch.utils.tb import EventWriter

            self._tb = EventWriter(logdir, run_name)

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._fh.write(json.dumps({
            "step": step, "tag": tag, "value": float(value),
            "wall": round(time.time() - self._t0, 3),
        }) + "\n")
        if self._tb is not None:
            self._tb.scalar(tag, float(value), step)

    def scalars(self, prefix: str, values: dict[str, float], step: int) -> None:
        for tag, v in values.items():
            self.scalar(f"{prefix}/{tag}", v, step)

    def close(self) -> None:
        self._fh.close()
        if self._tb is not None:
            self._tb.close()


class NullWriter:
    """A :class:`MetricsWriter` that writes nothing: the ranks other than 0
    of a data- or tensor-parallel run."""

    def scalar(self, tag: str, value: float, step: int) -> None:
        pass

    def scalars(self, prefix: str, values: dict[str, float], step: int) -> None:
        pass

    def close(self) -> None:
        pass


def run_name(exp: str, **qualifiers) -> str:
    """``exp.KEY_value`` naming (reference `bert_glue.py:91-92`)."""
    parts = [exp] + [f"{k.upper()}_{v}" for k, v in qualifiers.items()]
    return ".".join(parts)


# GLUE evaluation metrics (numpy, host-side): CoLA (Matthews corrcoef),
# MRPC/QQP (acc + F1), STS-B (Pearson/Spearman), accuracy elsewhere.

def matthews_corrcoef(preds, labels) -> float:
    preds = np.asarray(preds).astype(np.int64)
    labels = np.asarray(labels).astype(np.int64)
    tp = float(np.sum((preds == 1) & (labels == 1)))
    tn = float(np.sum((preds == 0) & (labels == 0)))
    fp = float(np.sum((preds == 1) & (labels == 0)))
    fn = float(np.sum((preds == 0) & (labels == 1)))
    denom = np.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
    return float((tp * tn - fp * fn) / denom) if denom > 0 else 0.0


def f1_binary(preds, labels) -> float:
    preds = np.asarray(preds).astype(np.int64)
    labels = np.asarray(labels).astype(np.int64)
    tp = float(np.sum((preds == 1) & (labels == 1)))
    fp = float(np.sum((preds == 1) & (labels == 0)))
    fn = float(np.sum((preds == 0) & (labels == 1)))
    denom = 2 * tp + fp + fn
    return float(2 * tp / denom) if denom > 0 else 0.0


def pearson_corr(x, y) -> float:
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    xc, yc = x - x.mean(), y - y.mean()
    denom = np.sqrt(np.sum(xc * xc) * np.sum(yc * yc))
    return float(np.sum(xc * yc) / denom) if denom > 0 else 0.0


def spearman_corr(x, y) -> float:
    def rank(a):
        # average ranks for ties (the scipy convention)
        order = np.argsort(a, kind="stable")
        ranks = np.empty(len(a), np.float64)
        ranks[order] = np.arange(len(a), dtype=np.float64)
        sorted_a = np.asarray(a)[order]
        i = 0
        while i < len(a):
            j = i
            while j + 1 < len(a) and sorted_a[j + 1] == sorted_a[i]:
                j += 1
            ranks[order[i : j + 1]] = 0.5 * (i + j)
            i = j + 1
        return ranks

    return pearson_corr(rank(np.asarray(x, np.float64)),
                        rank(np.asarray(y, np.float64)))


def glue_metrics(metric: str, preds, labels) -> dict[str, float]:
    """Official per-task GLUE scores; ``score`` is the headline value."""
    preds = np.asarray(preds)
    labels = np.asarray(labels)
    if metric == "pearson_spearman":
        p, s = pearson_corr(preds, labels), spearman_corr(preds, labels)
        return {"pearson": p, "spearman": s, "score": 0.5 * (p + s)}
    acc = float(np.mean(preds == labels))
    if metric == "mcc":
        m = matthews_corrcoef(preds, labels)
        return {"acc": acc, "mcc": m, "score": m}
    if metric == "acc_f1":
        f1 = f1_binary(preds, labels)
        return {"acc": acc, "f1": f1, "score": 0.5 * (acc + f1)}
    return {"acc": acc, "score": acc}


def expected_calibration_error(probs, labels, n_bins: int = 15) -> float:
    """ECE of max-probability predictions (Guo et al. 2017, eq. 3).

    Extension over the reference's ``acc_std`` uncertainty proxy
    (`examples/bert_glue.py:186`): calibration is the property MOPED-style
    BNNs are deployed for (Krishnan et al. 2020, cited at reference
    `bayeformers/__init__.py:42-44`). ``probs`` is (B, C) — typically the
    MC-averaged softmax from ``elbo.predictive``.
    """
    probs = np.asarray(probs, np.float64)
    labels = np.asarray(labels).astype(np.int64)
    conf = probs.max(axis=-1)
    correct = (probs.argmax(axis=-1) == labels).astype(np.float64)
    return ece_from_confidence(conf, correct, n_bins)


def ece_from_confidence(conf, correct, n_bins: int = 15) -> float:
    """ECE from precomputed (confidence, correctness) vectors — the form
    LM workloads use so the (B*L, V) predictive never materializes on host
    (GPT-2's vocab makes the full probs array gigabytes)."""
    conf = np.asarray(conf, np.float64).reshape(-1)
    correct = np.asarray(correct, np.float64).reshape(-1)
    edges = np.linspace(0.0, 1.0, n_bins + 1)
    ece = 0.0
    n = len(conf)
    for lo, hi in zip(edges[:-1], edges[1:]):
        sel = (conf > lo) & (conf <= hi) if lo > 0 else (conf <= hi)
        if not sel.any():
            continue
        ece += sel.sum() / n * abs(correct[sel].mean() - conf[sel].mean())
    return float(ece)
