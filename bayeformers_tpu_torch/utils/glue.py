"""The GLUE task registry (counterpart of ``bayeformers_tpu/utils/glue.py``'s
``TaskSpec`` and ``task_spec``): TSV layout, label semantics and the
official metric of each task. Featurising raw TSVs needs the native
WordPiece tokenizer and comes with the tokenizer slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


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
