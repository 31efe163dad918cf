"""Flipout, local reparameterization and the naive tier on GPT-2 against
the JAX package, on the CPU in f32.

A one-layer tiny Flax GPT-2 (``models/gpt2.py``: n_embd 128, two heads,
vocab 1024) is converted by ``bayeformers_tpu.to_bayesian`` and carried
over with ``from_jax_params``; each estimator runs on both sides at the
JAX package's own draws (``tests/test_torch_estimators.py::check_against_jax``:
logits 1e-4, the KL or log-probs 2e-5 relative, every trained leaf's
gradient of the logits' part and of the KL part within 1e-4 of its
largest entry). Flipout and LRT define a Conv1D leaf's draws on the
transposed (in, out) view and score its KL on a transposed ``prior_mu``;
the naive tier draws in the stored (out, in) orientation.
"""
import jax
import numpy as np
import pytest
from flax.traverse_util import flatten_dict

import bayeformers_tpu as bf
import bayeformers_tpu_torch as bt
from bayeformers_tpu.models import gpt2 as jgpt2
from test_torch_estimators import B, CONVERSIONS, S, check_against_jax
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

L = 12
# flipout and LRT share the KL (``AnalyticKLMC``): flipout takes the Gaussian
# on a transposed prior_mu, LRT the mixture on transposed draws
RUNS = (("flipout", "moped-trainable"), ("local", "random-init"),
        ("naive", "frozen-moped"))


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 1024, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[1, 8:] = 0
    return {"input_ids": ids, "attention_mask": mask}


@pytest.fixture(scope="module")
def bundle():
    return jgpt2.build_gpt2(size="tiny", seed=0, n_layer=1)


_converted = {}


def _conversion(bundle, name):
    if name not in _converted:
        held = {}

        def convert(params):
            held["bmodel"], bp = bf.to_bayesian(bundle.apply_fn, params,
                                                **CONVERSIONS[name])
            return bp

        bp = jax.jit(convert)(bundle.params)
        spec = held["bmodel"].spec
        port = bt.from_jax_params(
            flatten_dict(bp.params, sep="/"), {p: np.asarray(r) for p, r in bp.rho.items()},
            prior_mu={p: np.asarray(m) for p, m in bp.prior_mu.items()},
            prior=(spec.prior.pi, spec.prior.sigma1, spec.prior.sigma2),
            moped=spec.moped, frozen=spec.frozen, device="cpu")
        _converted[name] = (name, held["bmodel"], bp, port)
    return _converted[name]


@pytest.mark.parametrize("estimator,name", RUNS)
def test_estimator_on_gpt2_matches_jax(bundle, estimator, name):
    """One estimator under one conversion on GPT-2 at the JAX package's
    draws; the Gaussian on a trainable mu's ``prior_mu`` and the mixture
    exercise the transposed KL."""
    conv = _conversion(bundle, name)
    assert len(conv[3].spec.paths) == 8
    check_against_jax(conv, estimator, _batch(), out_shape=(B, L, 1024))
