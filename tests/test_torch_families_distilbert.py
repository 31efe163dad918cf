"""DistilBERT in the port against the JAX package, on the CPU in f32
(``tests/test_torch_families.py`` has the helpers): frozen MOPED with
antithetic pairs, random init with independent draws, and its attention
handler with DistilBERT's ``-1e30 * (1 - mask)`` bias and a fully padded
row.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayeformers_tpu_torch.models import families
from bayeformers_tpu_torch.nn import fused as tfused
from bayeformers_tpu_torch.ops import attention as ops_attention
from test_torch_bert import _jax_hook
from test_torch_families import S, cached_pair, check_family, family_batch, inputs_of
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)


@pytest.mark.parametrize("conversion,antithetic", [("frozen-moped", True),
                                                   ("random-init", False)])
def test_distilbert_matches_jax(conversion, antithetic):
    check_family("distilbert-base-uncased", conversion, antithetic)


def test_distilbert_handler_and_padded_row(monkeypatch):
    """DistilBERT's block goes through ``distilbert_attention`` (once a layer)
    with the bias ``-1e30 * (1 - mask)``; a fully padded row's attention is
    uniform over its keys, and the model's logits for it are the JAX
    package's."""
    bundle, bmodel, bp, port = cached_pair("distilbert-base-uncased", "frozen-moped")
    seen = []
    orig = tfused.MCBase.distilbert_attention

    def spy(self, mod, hidden, bias):
        seen.append(bias.clone())
        return orig(self, mod, hidden, bias)

    monkeypatch.setattr(tfused.MCBase, "distilbert_attention", spy)
    batch = family_batch(bundle)
    batch["attention_mask"][2] = 0  # a fully padded row
    inputs = {k: jnp.asarray(v) for k, v in inputs_of(batch).items()}
    key = jax.random.key(9)
    jout, _ = bmodel.mc_apply_fused(bp, key, S, antithetic=True, **inputs)
    t = {k: torch.from_numpy(v).long() for k, v in inputs_of(batch).items()}
    out, _ = port.mc_apply_fused(0, S, **t, antithetic=True, eps_hook=_jax_hook(bmodel, key))
    assert len(seen) == bundle.config.n_layers
    mask = torch.from_numpy(np.tile(batch["attention_mask"], (S, 1))).float()
    torch.testing.assert_close(seen[0], -1e30 * (1.0 - mask), rtol=0, atol=0)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=1e-4)
    assert torch.isfinite(out).all()
    q, k, v = (torch.randn(2, 6, 128, generator=torch.Generator().manual_seed(i))
               for i in range(3))
    keep = torch.ones(2, 6)
    keep[1] = 0
    ctx = ops_attention.mha(q, k, v, families.distilbert_bias(keep), 2)
    torch.testing.assert_close(ctx[1], v[1].mean(0).expand(6, 128), rtol=0, atol=1e-6)
