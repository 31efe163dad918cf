"""``--pretrained DIR`` for the other encoder families the port builds
(DistilBERT, RoBERTa, Electra) against the JAX package's
``build_model(pretrained=DIR)``, as ``tests/test_torch_pretrained.py``
holds BERT and ALBERT: one directory with the PyTorch and the Flax files
of one random tiny model, logits within 1e-4, and a span head from the
same files (RoBERTa's and DistilBERT's checkpoints carry no pooler it
would drop, Electra's none it takes)."""
import numpy as np
import pytest
import torch
from test_torch_pretrained import write_checkpoint
from torch_threads import one_torch_thread  # noqa: F401

from bayeformers_tpu.models import bert as jbert
from bayeformers_tpu_torch import pretrained

TINY = dict(vocab_size=128, max_position_embeddings=130)
SPECS = {
    "distilbert": ("DistilBertConfig", "DistilBertForSequenceClassification",
                   "FlaxDistilBertForSequenceClassification",
                   dict(TINY, dim=32, n_layers=2, n_heads=2, hidden_dim=64)),
    "roberta": ("RobertaConfig", "RobertaForSequenceClassification",
                "FlaxRobertaForSequenceClassification",
                dict(TINY, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                     intermediate_size=64, type_vocab_size=1, pad_token_id=1)),
    "electra": ("ElectraConfig", "ElectraForSequenceClassification",
                "FlaxElectraForSequenceClassification",
                dict(TINY, embedding_size=16, hidden_size=32, num_hidden_layers=2,
                     num_attention_heads=2, intermediate_size=64)),
}


@pytest.mark.parametrize("family", sorted(SPECS))
def test_family_logits_match_jax(tmp_path, family):
    path = write_checkpoint(tmp_path, family, spec=SPECS[family])
    rng = np.random.default_rng(1)
    ids = rng.integers(3, 128, (3, 12)).astype(np.int32)
    mask = np.ones((3, 12), np.int32)
    mask[2, 7:] = 0
    if family == "roberta":
        ids[2, 7:] = 1  # its pad id: the positions skip it
    bundle = jbert.build_model(family, task="classification", n_labels=3, pretrained=path)
    inputs = jbert.prune_inputs(bundle, {"input_ids": ids, "attention_mask": mask,
                                         "token_type_ids": np.zeros_like(ids)})
    want = np.asarray(bundle.apply_fn(bundle.params, **inputs))
    model = pretrained.load_pretrained(path, "classification", 3, device="cpu")
    assert model.config.family == family
    with torch.no_grad():
        got = model(**{k: torch.from_numpy(v).long() for k, v in inputs.items()}).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    qa = pretrained.load_pretrained(path, "qa", device="cpu")
    assert qa.task == "qa" and not hasattr(qa, "classifier")
