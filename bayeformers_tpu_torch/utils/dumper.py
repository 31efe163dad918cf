"""Hierarchical structured-results dumper (counterpart of
``bayeformers_tpu/utils/dumper.py``): nest named sections (phase, epoch) as
context managers, record scalar results inside them, and flush the whole
tree to a JSON file.
"""
from __future__ import annotations

import json
import os
from typing import Any, Optional


class Section:
    def __init__(self, name: str, parent: Optional["Section"] = None):
        self.name = name
        self.parent = parent
        self.children: dict[str, "Section"] = {}
        self.values: dict[str, Any] = {}

    def child(self, name: str) -> "Section":
        if name not in self.children:
            self.children[name] = Section(name, parent=self)
        return self.children[name]

    def record(self, **values: Any) -> None:
        self.values.update(values)

    def to_dict(self) -> dict[str, Any]:
        out: dict[str, Any] = dict(self.values)
        for name, child in self.children.items():
            out[name] = child.to_dict()
        return out


class Dumper:
    """Usage::

        dumper = Dumper("results/run")
        with dumper.section("bayesian_train"):
            with dumper.section("epoch_0"):
                dumper.record(loss=1.23, acc=0.9)
        dumper.flush()   # also flushed automatically on outermost __exit__
    """

    def __init__(self, path: str):
        self.path = path if path.endswith(".json") else path + ".json"
        self.root = Section("root")
        self._stack: list[Section] = [self.root]

    def section(self, name: str) -> "_SectionCtx":
        return _SectionCtx(self, name)

    def record(self, **values: Any) -> None:
        self._stack[-1].record(**values)

    def flush(self) -> None:
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(self.path, "w") as fh:
            json.dump(self.root.to_dict(), fh, indent=2, default=float)


class _SectionCtx:
    def __init__(self, dumper: Dumper, name: str):
        self.dumper = dumper
        self.name = name

    def __enter__(self) -> Section:
        section = self.dumper._stack[-1].child(self.name)
        self.dumper._stack.append(section)
        return section

    def __exit__(self, *exc) -> None:
        self.dumper._stack.pop()
        if len(self.dumper._stack) == 1:
            self.dumper.flush()
