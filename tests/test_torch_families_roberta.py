"""RoBERTa, and CamemBERT through RoBERTa's builder, in the port against
the JAX package, on the CPU in f32 (``tests/test_torch_families.py`` has
the helpers): RoBERTa under frozen MOPED with antithetic pairs, CamemBERT
under random init with independent draws, and RoBERTa's position ids.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import bayeformers_tpu_torch as bt
from bayeformers_tpu.models import bert as jbert
from bayeformers_tpu_torch.models import families
from bayeformers_tpu_torch.models.bert import BertConfig
from test_torch_families import check_family
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)


@pytest.mark.parametrize("name,conversion,antithetic", [
    ("roberta-base", "frozen-moped", True),
    ("camembert-base", "random-init", False)])
def test_roberta_matches_jax(name, conversion, antithetic):
    check_family(name, conversion, antithetic)


def test_roberta_position_ids_skip_padding():
    """RoBERTa's positions start at pad_id + 1 and do not advance over the
    padding, as HF's ``create_position_ids_from_input_ids`` gives them;
    with right padding the port's logits are the JAX package's (whose
    apply builds the same ids)."""
    ids = torch.tensor([[5, 6, 7, 1, 1], [1, 8, 9, 10, 1]])
    pos = families.roberta_positions(ids, 1)
    assert pos.tolist() == [[2, 3, 4, 1, 1], [1, 2, 3, 4, 1]]
    bundle = jbert.build_model("roberta-base", size="tiny", seed=0, num_hidden_layers=1)
    port = bt.from_jax_params(
        flatten_dict(bundle.params, sep="/"), {}, device="cpu",
        config=BertConfig.from_hf("roberta", bundle.config.to_dict()))
    rng = np.random.default_rng(0)
    ids = rng.integers(4, 1024, (2, 12)).astype(np.int32)
    ids[0, 9:] = 1
    mask = (ids != 1).astype(np.int32)
    want = bundle.apply_fn(bundle.params, jnp.asarray(ids), jnp.asarray(mask))
    got = port.model(torch.from_numpy(ids).long(), torch.from_numpy(mask).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
