"""GLUE from raw TSVs (counterpart of ``bayeformers_tpu/utils/glue.py``): the
task registry (TSV layout, label semantics and the official metric of each
task), the TSV reader, the ``[CLS] a [SEP] (b [SEP])`` featurizer and the
loader of a task directory, whose features are cached next to the TSVs.
"""
from __future__ import annotations

import csv
import dataclasses
import os
from typing import Callable, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class TaskSpec:
    """Raw-TSV layout + label semantics for one GLUE task."""

    text_a: int
    text_b: Optional[int]          # None: single-sentence task
    label: int                     # column index (may be -1 = last)
    header: bool
    n_labels: int                  # 1 => regression (STS-B)
    label_map: Optional[tuple] = None  # string labels -> class index
    metric: str = "acc"            # acc | acc_f1 | mcc | pearson_spearman
    dev_file: str = "dev.tsv"

    @property
    def regression(self) -> bool:
        return self.n_labels == 1

    def parse_label(self, raw: str):
        if self.regression:
            return float(raw)
        if self.label_map is not None:
            return self.label_map.index(raw)
        return int(raw)


_NLI = ("contradiction", "entailment", "neutral")
_ENTAIL = ("entailment", "not_entailment")
TASKS = {
    "cola": TaskSpec(3, None, 1, header=False, n_labels=2, metric="mcc"),
    "sst2": TaskSpec(0, None, 1, header=True, n_labels=2),
    "mrpc": TaskSpec(3, 4, 0, header=True, n_labels=2, metric="acc_f1"),
    "stsb": TaskSpec(7, 8, -1, header=True, n_labels=1,
                     metric="pearson_spearman"),
    "qqp": TaskSpec(3, 4, 5, header=True, n_labels=2, metric="acc_f1"),
    "mnli": TaskSpec(8, 9, -1, header=True, n_labels=3, label_map=_NLI,
                     dev_file="dev_matched.tsv"),
    "mnli-mm": TaskSpec(8, 9, -1, header=True, n_labels=3, label_map=_NLI,
                        dev_file="dev_mismatched.tsv"),
    "qnli": TaskSpec(1, 2, -1, header=True, n_labels=2, label_map=_ENTAIL),
    "rte": TaskSpec(1, 2, -1, header=True, n_labels=2, label_map=_ENTAIL),
    "wnli": TaskSpec(1, 2, -1, header=True, n_labels=2),
}
_ALIASES = {"sst-2": "sst2", "sts-b": "stsb"}


def task_spec(task: str) -> TaskSpec:
    name = task.lower()
    name = _ALIASES.get(name, name)
    if name not in TASKS:
        raise ValueError(f"unknown GLUE task {task!r}; known: {sorted(TASKS)}")
    return TASKS[name]


def read_tsv(path: str, has_header: bool) -> list[list[str]]:
    with open(path, encoding="utf-8") as fh:
        rows = list(csv.reader(fh, delimiter="\t", quoting=csv.QUOTE_NONE))
    return rows[1:] if has_header else rows


def featurize_pairs(pairs: list[tuple[str, Optional[str]]], labels: list,
                    tokenize: Callable[[str], list[int]], *, max_seq: int = 128,
                    cls_id: int = 101, sep_id: int = 102, pad_id: int = 0,
                    regression: bool = False) -> dict[str, np.ndarray]:
    """``[CLS] a [SEP] (b [SEP])`` with 0/1 token types, truncated longest
    first to fit the specials (the reference tokenizer's policy) and padded
    to ``max_seq``; int32 arrays, labels float32 for a regression task."""
    n = len(pairs)
    input_ids = np.full((n, max_seq), pad_id, np.int32)
    attention = np.zeros((n, max_seq), np.int32)
    type_ids = np.zeros((n, max_seq), np.int32)
    for i, (a, b) in enumerate(pairs):
        ids_a = tokenize(a)
        ids_b = tokenize(b) if b else []
        budget = max_seq - (3 if ids_b else 2)
        while len(ids_a) + len(ids_b) > budget:
            if len(ids_a) >= len(ids_b):
                ids_a.pop()
            else:
                ids_b.pop()
        ids = [cls_id] + ids_a + [sep_id]
        types = [0] * len(ids)
        if ids_b:
            ids += ids_b + [sep_id]
            types += [1] * (len(ids_b) + 1)
        input_ids[i, :len(ids)] = ids
        attention[i, :len(ids)] = 1
        type_ids[i, :len(types)] = types
    return {
        "input_ids": input_ids,
        "attention_mask": attention,
        "token_type_ids": type_ids,
        "labels": np.asarray(labels, np.float32 if regression else np.int32),
    }


FEATURE_KEYS = ("input_ids", "attention_mask", "token_type_ids", "labels")


def load_glue_task(data_dir: str, task: str, tokenize: Callable[[str], list[int]], *,
                   max_seq: int = 128, train_file: str = "train.tsv",
                   dev_file: str | None = None, cache: bool = True, cls_id: int = 101,
                   sep_id: int = 102, pad_id: int = 0) -> tuple[dict, dict]:
    """``(train, dev)`` dicts of numpy arrays for a GLUE task directory, the
    features cached in ``features_<task>_<max_seq>.npz`` there (read back
    on the next call). The special ids default to BERT's vocabulary's, as
    in the JAX package; a caller with a tokenizer passes its own."""
    spec = task_spec(task)
    dev_file = dev_file or spec.dev_file
    cache_path = os.path.join(data_dir, f"features_{task.lower()}_{max_seq}.npz")
    if cache and os.path.exists(cache_path):
        z = np.load(cache_path)
        return ({k: z[f"train_{k}"] for k in FEATURE_KEYS},
                {k: z[f"dev_{k}"] for k in FEATURE_KEYS})

    def build(path):
        rows = read_tsv(path, spec.header)
        pairs = [(r[spec.text_a], r[spec.text_b] if spec.text_b is not None else None)
                 for r in rows]
        labels = [spec.parse_label(r[spec.label]) for r in rows]
        return featurize_pairs(pairs, labels, tokenize, max_seq=max_seq, cls_id=cls_id,
                               sep_id=sep_id, pad_id=pad_id, regression=spec.regression)

    train = build(os.path.join(data_dir, train_file))
    dev = build(os.path.join(data_dir, dev_file))
    if cache:
        np.savez(cache_path, **{f"train_{k}": v for k, v in train.items()},
                 **{f"dev_{k}": v for k, v in dev.items()})
    return train, dev
