"""``--pretrained DIR`` (``bayeformers_tpu_torch/pretrained.py``) against the
JAX package's ``build_model(pretrained=DIR)``: one directory holds the
PyTorch files (``model.safetensors``, or an older ``pytorch_model.bin``
with LayerNorm ``gamma``/``beta``) and the Flax file of the same random
tiny BERT and ALBERT (written by ``transformers``), and both packages'
logits agree at ``tests/test_torch_bert.py``'s tolerance (1e-4). Also the
hand-written safetensors reader against the ``safetensors`` package, the
heads a checkpoint may lack, and the keys that must raise."""
import json

import numpy as np
import pytest
import safetensors.torch as safetensors_torch
import torch
import transformers
from torch_threads import one_torch_thread  # noqa: F401

from bayeformers_tpu.models import bert as jbert
from bayeformers_tpu_torch import pretrained
from bayeformers_tpu_torch.workloads import bert_glue, bert_squad

CONFIGS = {
    "bert": ("BertConfig", "BertForSequenceClassification",
             "FlaxBertForSequenceClassification",
             dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
                  num_attention_heads=2, intermediate_size=64,
                  max_position_embeddings=128)),
    "albert": ("AlbertConfig", "AlbertForSequenceClassification",
               "FlaxAlbertForSequenceClassification",
               dict(vocab_size=128, embedding_size=16, hidden_size=32,
                    num_hidden_layers=3, num_attention_heads=2, intermediate_size=64,
                    max_position_embeddings=128)),
}


def write_checkpoint(root, family: str, seed: int = 0, n_labels: int = 3,
                     spec=None) -> str:
    """A random tiny HF model of ``family`` (``spec``: its config class,
    PyTorch and Flax classes and config fields; default ``CONFIGS``) saved
    by transformers in both formats: PyTorch (safetensors) and Flax
    (converted from the former)."""
    cfg_cls, pt_cls, flax_cls, kw = spec or CONFIGS[family]
    torch.manual_seed(seed)
    cfg = getattr(transformers, cfg_cls)(num_labels=n_labels, **kw)
    model = getattr(transformers, pt_cls)(cfg).eval()
    path = root / family
    model.save_pretrained(str(path), safe_serialization=True)
    getattr(transformers, flax_cls).from_pretrained(str(path), from_pt=True).save_pretrained(
        str(path))
    return str(path)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("hf")
    return {f: write_checkpoint(root, f) for f in CONFIGS}


def _batch(seed=0, B=3, L=10, vocab=128):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[1, 6:] = 0
    tok = np.zeros((B, L), np.int32)
    tok[:, L // 2:] = 1
    return ids, mask, tok


def _port_logits(model, batch):
    t = [torch.from_numpy(a).long() for a in batch]
    with torch.no_grad():
        return model(*t).numpy()


@pytest.mark.parametrize("family", sorted(CONFIGS))
def test_logits_match_jax(checkpoints, family):
    path = checkpoints[family]
    bundle = jbert.build_model(family, task="classification", n_labels=3, pretrained=path)
    batch = _batch()
    want = np.asarray(bundle.apply_fn(bundle.params, *batch))
    model = pretrained.load_pretrained(path, "classification", 3, device="cpu")
    assert model.config.family == family
    np.testing.assert_allclose(_port_logits(model, batch), want, atol=1e-4)


def test_old_bin_names_load_the_same(checkpoints, tmp_path):
    """A ``pytorch_model.bin`` with LayerNorm ``gamma``/``beta`` (older
    files) and ``position_ids`` buffers gives the same model."""
    src = checkpoints["bert"]
    state = pretrained.read_state_dict(src)
    old = {}
    for k, v in state.items():
        k = k.replace("LayerNorm.weight", "LayerNorm.gamma").replace("LayerNorm.bias",
                                                                      "LayerNorm.beta")
        old[k] = v
    old["bert.embeddings.position_ids"] = torch.arange(128)[None]
    d = tmp_path / "old"
    d.mkdir()
    (d / "config.json").write_text(open(f"{src}/config.json").read())
    torch.save(old, d / "pytorch_model.bin")
    a = pretrained.load_pretrained(src, "classification", 3, device="cpu")
    b = pretrained.load_pretrained(str(d), "classification", 3, device="cpu")
    for (n, p), (m, q) in zip(a.named_parameters(), b.named_parameters()):
        assert n == m and torch.equal(p, q), n


def test_safetensors_reader_matches_the_package(tmp_path):
    rng = np.random.default_rng(0)
    tensors = {"a": torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32)),
               "b": torch.from_numpy(rng.standard_normal(7).astype(np.float16)),
               "c": torch.from_numpy(rng.standard_normal((2, 2))).to(torch.bfloat16),
               "d": torch.arange(6, dtype=torch.int64).reshape(2, 3)}
    path = str(tmp_path / "t.safetensors")
    safetensors_torch.save_file(tensors, path)
    got = pretrained.read_safetensors(path)
    for k, v in tensors.items():
        want = v.float() if v.dtype == torch.bfloat16 else v
        assert got[k].dtype == want.dtype and torch.equal(got[k], want), k


def _write_state(d, config: dict, state: dict):
    d.mkdir()
    (d / "config.json").write_text(json.dumps(config))
    safetensors_torch.save_file({k: v.contiguous() for k, v in state.items()},
                                str(d / "model.safetensors"))


def test_heads_a_checkpoint_may_lack(checkpoints, tmp_path, capsys):
    """A pre-training checkpoint (HF's ``cls.*`` head, no classifier) loads
    its encoder and starts the task head from the seed; a span head drops
    the pooler it has none of."""
    src = checkpoints["bert"]
    config = json.loads(open(f"{src}/config.json").read())
    state = pretrained.read_state_dict(src)
    pre = {k: v for k, v in state.items() if not k.startswith("classifier.")}
    pre["cls.predictions.bias"] = torch.zeros(128)
    pre["cls.predictions.transform.dense.weight"] = torch.zeros(32, 32)
    _write_state(tmp_path / "pre", config, pre)
    full = pretrained.load_pretrained(src, "classification", 3, device="cpu")
    model = pretrained.load_pretrained(str(tmp_path / "pre"), "classification", 3,
                                       device="cpu")
    assert "new classification head" in capsys.readouterr().out
    for (n, p), (_, q) in zip(full.named_parameters(), model.named_parameters()):
        if not n.startswith("classifier."):
            assert torch.equal(p, q), n
    qa = pretrained.load_pretrained(src, "qa", device="cpu")
    assert torch.equal(qa.bert.embeddings.word_embeddings.embedding,
                       full.bert.embeddings.word_embeddings.embedding)
    # a base model's file: names without the family prefix
    base = {k[len("bert."):]: v for k, v in state.items() if k.startswith("bert.")}
    _write_state(tmp_path / "base", config, base)
    again = pretrained.load_pretrained(str(tmp_path / "base"), "classification", 3,
                                       device="cpu")
    assert torch.equal(again.bert.pooler.dense.kernel, full.bert.pooler.dense.kernel)


def test_keys_that_raise(checkpoints, tmp_path):
    src = checkpoints["bert"]
    config = json.loads(open(f"{src}/config.json").read())
    state = pretrained.read_state_dict(src)
    extra = dict(state, **{"bert.encoder.layer.9.output.dense.weight": torch.zeros(32, 64)})
    _write_state(tmp_path / "extra", config, extra)
    with pytest.raises(ValueError, match="unexpected .*layer.9"):
        pretrained.load_pretrained(str(tmp_path / "extra"), "classification", 3,
                                   device="cpu")
    missing = {k: v for k, v in state.items() if "layer.1.output.dense" not in k}
    _write_state(tmp_path / "missing", config, missing)
    with pytest.raises(ValueError, match="missing .*layer.1.output.dense"):
        pretrained.load_pretrained(str(tmp_path / "missing"), "classification", 3,
                                   device="cpu")
    with pytest.raises(ValueError, match="shape"):
        pretrained.load_pretrained(src, "classification", 2, device="cpu")
    with pytest.raises(ValueError, match="not an encoder family"):
        pretrained.hf_family({"model_type": "gpt2"})
    assert pretrained.hf_family({"model_type": "camembert"}) == "roberta"


def test_workloads_start_from_pretrained(checkpoints, tmp_path):
    kw = dict(epochs=1, b_epochs=1, samples=2, batch_size=4, limit_batches=1,
              device="cpu", logs=str(tmp_path))
    score = bert_glue.train(pretrained=checkpoints["albert"], task="mnli", **kw)
    assert 0.0 <= score <= 1.0
    score = bert_squad.train(pretrained=checkpoints["bert"], data_dir=None, max_seq=32,
                             **kw)
    assert 0.0 <= score <= 1.0
