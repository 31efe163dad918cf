"""Random hyperparameter search (counterpart of
``bayeformers_tpu/utils/hypersearch.py``, the reference's
``examples/hypersearch.py``).

Register ``name -> ((lo, hi), scale)`` ranges, sample each uniformly (in
linear or log10 space) from a numpy generator, call the train function N
times and keep the highest score. The scale is stored with its range (the
reference zips two separate lists), and a trial that raises is recorded as
-inf and the search goes on, unless ``on_error="raise"`` (the reference's
behaviour).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np


@dataclasses.dataclass
class Score:
    """Best-so-far tracker; higher is better."""

    value: float = -np.inf
    hyperparameters: dict[str, float] = dataclasses.field(default_factory=dict)

    def update(self, value: float, hyperparameters: dict[str, float]) -> bool:
        if value > self.value:
            self.value = value
            self.hyperparameters = dict(hyperparameters)
            return True
        return False


class HyperSearch:
    """Usage (as the reference GLUE script, ``examples/bert_glue.py:324-331``)::

        hs = HyperSearch(seed=42)
        hs["delta"] = (1e-2, 1e-1), HyperSearch.LOG_SCALE
        hs["weight_decay"] = (0.0, 1e-3), HyperSearch.LINEAR_SCALE
        best = hs.search(train_fn, iterations=10, **fixed_kwargs)
    """

    LINEAR_SCALE = 0
    LOG_SCALE = 1

    def __init__(self, seed: Optional[int] = None):
        self.parameters: dict[str, tuple[tuple[float, float], int]] = {}
        self.rng = np.random.default_rng(seed)

    def __setitem__(self, name: str, value: tuple[tuple[float, float], int]) -> None:
        rng_range, scale = value
        self.parameters[name] = (tuple(rng_range), scale)

    def _sample(self) -> dict[str, float]:
        out = {}
        for name, ((lo, hi), scale) in self.parameters.items():
            if scale == self.LOG_SCALE:
                out[name] = float(10 ** self.rng.uniform(np.log10(lo), np.log10(hi)))
            else:
                out[name] = float(self.rng.uniform(lo, hi))
        return out

    def search(self, train_fn: Callable[..., float], iterations: int = 10, *args: Any,
               on_error: str = "skip", **kwargs: Any) -> Score:
        """Run ``train_fn(*args, **sampled, **kwargs)`` ``iterations`` times;
        returns the best :class:`Score`. ``on_error="skip"`` counts a trial
        that raises as -inf; ``"raise"`` lets it through."""
        score = Score()
        for _ in range(iterations):
            sampled = self._sample()
            try:
                value = float(train_fn(*args, **sampled, **kwargs))
            except Exception:
                if on_error == "raise":
                    raise
                continue
            score.update(value, sampled)
        return score


def search_delta_weight_decay(train_fn: Callable[..., float], iterations: int,
                              search_seed: int, **kwargs: Any) -> Score:
    """The reference's search of the GLUE and SQuAD scripts: ``delta``
    log-uniform over (1e-2, 1e-1) and ``weight_decay`` uniform over [0,
    1e-3], ``iterations`` trials of ``train_fn(delta=..., weight_decay=...,
    **kwargs)`` from a generator seeded ``search_seed``."""
    hs = HyperSearch(seed=search_seed)
    hs["delta"] = (1e-2, 1e-1), HyperSearch.LOG_SCALE
    hs["weight_decay"] = (0.0, 1e-3), HyperSearch.LINEAR_SCALE
    return hs.search(train_fn, iterations=iterations, **kwargs)
