"""bf16 activations: the port against the JAX package (HF's Flax BERT with
``dtype=bfloat16``) at the same weights, on the CPU.

A tiny BERT (seed 0, two layers, hidden width 128) is converted by the JAX
package's ``to_bayesian(delta=0.05, freeze=True)`` and carried over with
``from_jax_params(dtype=torch.bfloat16)``. Compared: the frequentist
forward, and ``mc_apply_fused`` under both estimators at the JAX package's
own draws (injected through the eps hook).

Tolerance: logits within two bf16 steps of the largest |logit| (a step is
2**(floor(log2 max|logit|) - 7)), which the antithetic case needs; the
frequentist and independent cases stay within one. The embeddings are
bit-equal (both sum the bf16 lookups in bf16, in HF's order); what remains
are one-ulp flips where f32 sums taken in another order (the matmuls'
accumulation, LayerNorm's statistics) round to bf16 differently, and XLA's
own erf in GELU (one ulp off torch's erf rounded once on part of GELU's
outputs), carried through two layers. Log-probs stay f32 sums: 2e-5
relative, as in f32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import bayeformers_tpu as bf
import bayeformers_tpu_torch as bt
from bayeformers_tpu.models import bert as jbert
from test_torch_bert import _batch, _jax_hook
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

S = 4


@pytest.fixture(scope="module")
def pair16():
    bundle = jbert.build_bert(size="tiny", seed=0, dtype=jnp.bfloat16)
    bmodel, bp = bf.to_bayesian(bundle.apply_fn, bundle.params, delta=0.05,
                                freeze=True)
    port = bt.from_jax_params(
        flatten_dict(bp.params, sep="/"),
        {p: np.asarray(r) for p, r in bp.rho.items()},
        dtype=torch.bfloat16, device="cpu",
    )
    return bundle, bmodel, bp, port


def _within_two_bf16_steps(got: torch.Tensor, want) -> None:
    assert got.dtype == torch.bfloat16
    want = np.asarray(want).astype(np.float32)
    step = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=2 * step)


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


def test_bf16_frequentist_forward_matches_flax(pair16):
    bundle, _, bp, port = pair16
    ids, mask, tok = _batch()
    want = bundle.apply_fn(bp.params, jnp.asarray(ids), jnp.asarray(mask),
                           jnp.asarray(tok))
    _within_two_bf16_steps(port.model(_t(ids), _t(mask), _t(tok)), want)
    # the embeddings: HF sums the bf16 lookups in bf16, and so does the port
    emb = bundle.hf_model.module.apply(
        {"params": bp.params}, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(tok),
        jnp.broadcast_to(jnp.arange(ids.shape[1]), ids.shape), None,
        output_hidden_states=True, return_dict=True).hidden_states[0]
    b = port.model.bert
    pos = torch.arange(ids.shape[1]).expand(ids.shape)
    got = b.embeddings(_t(ids), _t(tok), pos)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(emb, np.float32))


@pytest.mark.parametrize("antithetic", [True, False])
def test_bf16_fused_forward_matches_jax(pair16, antithetic):
    _, bmodel, bp, port = pair16
    key = jax.random.key(3)
    ids, mask, tok = _batch()
    out, aux = bmodel.mc_apply_fused(
        bp, key, S, input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask),
        token_type_ids=jnp.asarray(tok), save_weights=False, antithetic=antithetic)
    logits, taux = port.mc_apply_fused(0, S, _t(ids), _t(mask), _t(tok),
                                       antithetic=antithetic,
                                       eps_hook=_jax_hook(bmodel, key))
    _within_two_bf16_steps(logits, out)
    for k in ("log_variational_posterior", "log_prior"):
        np.testing.assert_allclose(taux[k].numpy(), np.asarray(aux[k]), rtol=2e-5)
