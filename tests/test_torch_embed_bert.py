"""A tiny BERT's embedding tables under ``EMBEDDING_RULE`` (word, position
and token-type tables) in the port against the JAX package, on the CPU in
f32: a one-layer tiny Flax BERT converted by the JAX package's
``to_bayesian(rules=(*DEFAULT_RULES, EMBEDDING_RULE))`` and carried over
with ``from_jax_params``, each tier at the JAX package's own draws
(``tests/test_torch_estimators.py::check_against_jax``: logits 1e-4,
log-probs or KL 2e-5 relative, gradients 1e-4 of each leaf's largest
entry); flipout raises, as the reference's does.
"""
import functools

import jax
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import bayeformers_tpu as bf
import bayeformers_tpu_torch as bt
from bayeformers_tpu.models import bert as jbert
from test_torch_estimators import CONVERSIONS, _batch, check_against_jax
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

TABLES = ("bert/embeddings/position_embeddings/embedding",
          "bert/embeddings/token_type_embeddings/embedding",
          "bert/embeddings/word_embeddings/embedding")


@functools.lru_cache(maxsize=None)
def pair(conversion):
    bundle = jbert.build_bert(size="tiny", seed=0, num_hidden_layers=1)
    held = {}

    def convert(params):
        held["bmodel"], bp = bf.to_bayesian(
            bundle.apply_fn, params, rules=(*bf.DEFAULT_RULES, bf.EMBEDDING_RULE),
            **CONVERSIONS[conversion])
        return bp

    bp = jax.jit(convert)(bundle.params)
    bmodel = held["bmodel"]
    spec = bmodel.spec
    port = bt.from_jax_params(
        flatten_dict(bp.params, sep="/"), {p: np.asarray(r) for p, r in bp.rho.items()},
        prior_mu={p: np.asarray(m) for p, m in bp.prior_mu.items()},
        prior=(spec.prior.pi, spec.prior.sigma1, spec.prior.sigma2),
        moped=spec.moped, frozen=spec.frozen, device="cpu")
    return conversion, bmodel, bp, port


def test_bert_embedding_paths_match_jax():
    """The three tables join the Dense leaves, in the JAX package's order."""
    _, bmodel, _, port = pair("frozen-moped")
    assert set(TABLES) <= set(bmodel.spec.paths)
    assert port.spec.paths == bmodel.spec.paths
    assert bt.find_convertible_paths(port.model, (*bt.DEFAULT_RULES, bt.EMBEDDING_RULE)
                                     ) == bmodel.spec.paths
    assert not set(TABLES) & set(bt.find_convertible_paths(port.model))


@pytest.mark.parametrize("estimator", ["antithetic", "local"])
def test_bert_embeddings_match_jax(estimator):
    """BERT's three converted tables under frozen MOPED in the fused tier's
    antithetic pairs (sampled tables) and LRT (per-occurrence noise); the
    independent draws under random init and the naive tier in
    ``tests/test_torch_embed_bert_fused.py`` and ``_naive.py``, one test
    process each."""
    check_against_jax(pair("frozen-moped"), estimator, _batch(), n_samples=4)


def test_bert_flipout_refuses_converted_embeddings():
    """Flipout has no embedding handler (the JAX package raises there too:
    ``tests/test_torch_embed.py``): the port raises, naming the tables."""
    _, _, _, port = pair("frozen-moped")
    with pytest.raises(NotImplementedError, match="word_embeddings"):
        port.mc_apply_flipout(0, 2, **{k: torch.from_numpy(v).long()
                                       for k, v in _batch().items()})
