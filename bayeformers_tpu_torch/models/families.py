"""BERT's sibling encoder families, the family table and ``build_model``.

Counterpart of the JAX package's ``_FAMILIES`` registry and its per-style
quirks (``bayeformers_tpu/models/bert.py:67-177``), written as plain
``nn.Module``s whose parameter names are the Flax paths:

- **DistilBERT**: word + position embeddings (no token types), blocks of
  ``attention/{q_lin,k_lin,v_lin,out_lin}``, ``sa_layer_norm``,
  ``ffn/{lin1,lin2}``, ``output_layer_norm``; the mask is the additive
  ``-1e30 * (1 - mask)`` of HF's DistilBERT, not ``finfo.min``; the head is
  ``pre_classifier`` + ReLU + ``classifier``.
- **RoBERTa** (CamemBERT is dispatched to it): BERT's encoder, one token
  type, position ids ``cumsum(not_pad) * not_pad + pad_id`` (they start at
  ``pad_id + 1`` and skip padding), the head ``classifier/{dense,out_proj}``
  with tanh, no pooler.
- **Electra**: BERT's encoder behind an ``embeddings_project`` where the
  embedding width is not the hidden width (the tiny preset's 64 -> 128;
  base has none); the head ``classifier/{dense,out_proj}`` with GELU.
- **ALBERT**: 128-wide embeddings mapped to the hidden width by
  ``encoder/embedding_hidden_mapping_in``, ONE layer group whose one layer
  is called ``num_hidden_layers`` times (its leaves are shared: the fused
  tier draws each the same on every call and counts its KL once), the
  ``gelu_new`` (tanh) activation, attention whose module holds the output
  ``dense`` and its LayerNorm, a tanh ``pooler`` and a ``classifier``.

Every family takes ``task="qa"``: HF's ``*ForQuestionAnswering``,
``qa_outputs`` (H -> 2) on every position and no pooler, returning
``(start_logits, end_logits)``. Activation dtypes follow the Flax modules:
DistilBERT's, Electra's and ALBERT's embeddings sum f32 lookups (their
``nn.Embed`` has no dtype) and cast after the LayerNorm.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from bayeformers_tpu_torch.models.bert import (
    BERT_BASE_KWARGS,
    BERT_TINY_KWARGS,
    BertConfig,
    BertEmbeddings,
    BertForSequenceClassification,
    BertModule,
    EncoderModel,
    LayerNorm,
    activation,
    check_device,
    init_weights,
)
from bayeformers_tpu_torch.nn.dense import Dense
from bayeformers_tpu_torch.ops import attention as ops_attention

# the reference's presets (``bayeformers_tpu/models/bert.py:67-118``) under
# the port's BERT names; the families' defaults beyond them are HF's
# (ALBERT's gelu_new, RoBERTa's pad id 1)
PRESETS = {
    "bert": (BERT_BASE_KWARGS, BERT_TINY_KWARGS),
    "distilbert": (
        dict(vocab_size=30522, hidden_size=768, num_hidden_layers=6,
             num_attention_heads=12, intermediate_size=3072, max_position_embeddings=512,
             type_vocab_size=0),
        dict(vocab_size=1024, hidden_size=128, num_hidden_layers=2,
             num_attention_heads=2, intermediate_size=256, max_position_embeddings=128,
             type_vocab_size=0)),
    "roberta": (
        dict(vocab_size=50265, hidden_size=768, num_hidden_layers=12,
             num_attention_heads=12, intermediate_size=3072, max_position_embeddings=514,
             type_vocab_size=1, pad_token_id=1),
        dict(vocab_size=1024, hidden_size=128, num_hidden_layers=2,
             num_attention_heads=2, intermediate_size=256, max_position_embeddings=136,
             type_vocab_size=1, pad_token_id=1)),
    "electra": (
        dict(vocab_size=30522, embedding_size=768, hidden_size=768,
             num_hidden_layers=12, num_attention_heads=12, intermediate_size=3072,
             max_position_embeddings=512),
        dict(vocab_size=1024, embedding_size=64, hidden_size=128,
             num_hidden_layers=2, num_attention_heads=2, intermediate_size=256,
             max_position_embeddings=128)),
    "albert": (
        dict(vocab_size=30000, embedding_size=128, hidden_size=768,
             num_hidden_layers=12, num_attention_heads=12, intermediate_size=3072,
             max_position_embeddings=512, hidden_act="gelu_new"),
        dict(vocab_size=1024, embedding_size=32, hidden_size=128,
             num_hidden_layers=2, num_attention_heads=2, intermediate_size=256,
             max_position_embeddings=128, hidden_act="gelu_new")),
}

# DistilBERT's additive mask: scores - 1e30 * (1 - mask) (HF's
# FlaxMultiHeadSelfAttention; the reference's handler passes it to mha)
DISTILBERT_MASK = 1e30


def distilbert_bias(attention_mask: torch.Tensor) -> torch.Tensor:
    """(N, L) keep-mask -> DistilBERT's f32 key bias ``-1e30 * (1 - mask)``."""
    return -DISTILBERT_MASK * (1.0 - attention_mask.float())


# ---------------------------------------------------------------------------
# DistilBERT
# ---------------------------------------------------------------------------

class MultiHeadSelfAttention(nn.Module):
    """DistilBERT's attention: q/k/v and the output projection in one module."""

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        h = cfg.hidden_size
        self.q_lin = Dense(h, h, device=device)
        self.k_lin = Dense(h, h, device=device)
        self.v_lin = Dense(h, h, device=device)
        self.out_lin = Dense(h, h, device=device)
        self.n_heads = cfg.num_attention_heads

    def forward(self, hidden, bias, mc=None):
        if mc is not None:
            return mc.distilbert_attention(self, hidden, bias)
        ctx = ops_attention.mha(self.q_lin(hidden), self.k_lin(hidden),
                                self.v_lin(hidden), bias, self.n_heads)
        return self.out_lin(ctx)


class FFN(nn.Module):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.lin1 = Dense(cfg.hidden_size, cfg.intermediate_size, device=device)
        self.lin2 = Dense(cfg.intermediate_size, cfg.hidden_size, device=device)
        self.act = cfg.hidden_act

    def forward(self, hidden, mc=None):
        return self.lin2(activation(self.lin1(hidden, mc), self.act), mc)


class TransformerBlock(nn.Module):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.attention = MultiHeadSelfAttention(cfg, device)
        self.sa_layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, device=device)
        self.ffn = FFN(cfg, device)
        self.output_layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                           device=device)

    def forward(self, hidden, bias, mc=None):
        sa = self.sa_layer_norm(self.attention(hidden, bias, mc) + hidden)
        return self.output_layer_norm(self.ffn(sa, mc) + sa)


class Transformer(nn.Module):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.layer = nn.ModuleList(TransformerBlock(cfg, device)
                                   for _ in range(cfg.num_hidden_layers))

    def forward(self, hidden, bias, mc=None):
        for block in self.layer:
            hidden = block(hidden, bias, mc)
        return hidden


class DistilBertModule(nn.Module):
    def __init__(self, cfg: BertConfig, dtype, device=None):
        super().__init__()
        self.embeddings = BertEmbeddings(cfg, dtype, device)
        self.transformer = Transformer(cfg, device)


class DistilBertForSequenceClassification(EncoderModel):
    """DistilBERT; takes no token types (``token_type_ids`` is ignored)."""

    family = "distilbert"
    uses_token_type_ids = False

    def build(self, cfg, dtype, device):
        self.distilbert = DistilBertModule(cfg, dtype, device)
        if self.task == "classification":
            self.pre_classifier = Dense(cfg.hidden_size, cfg.hidden_size, device=device)
            self.classifier = Dense(cfg.hidden_size, cfg.num_labels, device=device)

    def encode(self, input_ids, attention_mask, token_type_ids, mc):
        d = self.distilbert
        hidden = d.embeddings(input_ids, None, self.positions(input_ids), mc)
        return d.transformer(hidden, distilbert_bias(attention_mask), mc)

    def classify(self, hidden, mc):
        pooled = activation(self.pre_classifier(hidden[:, 0], mc), "relu")
        return self.classifier(pooled, mc)


# ---------------------------------------------------------------------------
# RoBERTa (and CamemBERT) and Electra: BERT's encoder, their own heads
# ---------------------------------------------------------------------------

class ClassificationHead(nn.Module):
    """RoBERTa's (tanh) and Electra's (GELU) head on the first token."""

    def __init__(self, cfg: BertConfig, act: str, device=None):
        super().__init__()
        self.dense = Dense(cfg.hidden_size, cfg.hidden_size, device=device)
        self.out_proj = Dense(cfg.hidden_size, cfg.num_labels, device=device)
        self.act = act

    def forward(self, hidden, mc=None):
        y = self.dense(hidden[:, 0], mc)
        y = torch.tanh(y.float()).to(y.dtype) if self.act == "tanh" else activation(y, self.act)
        return self.out_proj(y, mc)


def roberta_positions(input_ids: torch.Tensor, pad_id: int) -> torch.Tensor:
    """HF's ``create_position_ids_from_input_ids``: ``cumsum(not_pad) *
    not_pad + pad_id``, positions from ``pad_id + 1`` that skip padding."""
    not_pad = (input_ids != pad_id).long()
    return torch.cumsum(not_pad, dim=-1) * not_pad + pad_id


class RobertaForSequenceClassification(EncoderModel):
    """RoBERTa (and CamemBERT): one token type, pad-aware positions."""

    family = "roberta"
    uses_token_type_ids = False

    def build(self, cfg, dtype, device):
        self.roberta = BertModule(cfg, dtype, device, pooler=False)
        if self.task == "classification":
            self.classifier = ClassificationHead(cfg, "tanh", device)

    def encode(self, input_ids, attention_mask, token_type_ids, mc):
        bias = ops_attention.mask_to_bias(attention_mask)
        pos = roberta_positions(input_ids, self.config.pad_token_id)
        return self.roberta(input_ids, bias, token_type_ids, pos, mc)

    def classify(self, hidden, mc):
        return self.classifier(hidden, mc)


class ElectraForSequenceClassification(EncoderModel):
    """Electra: BERT's encoder behind ``embeddings_project`` where the
    embedding width differs from the hidden width."""

    family = "electra"

    def build(self, cfg, dtype, device):
        self.electra = BertModule(cfg, dtype, device, pooler=False)
        if self.task == "classification":
            self.classifier = ClassificationHead(cfg, "gelu", device)

    def encode(self, input_ids, attention_mask, token_type_ids, mc):
        bias = ops_attention.mask_to_bias(attention_mask)
        return self.electra(input_ids, bias, token_type_ids, self.positions(input_ids), mc)

    def classify(self, hidden, mc):
        return self.classifier(hidden, mc)


# ---------------------------------------------------------------------------
# ALBERT
# ---------------------------------------------------------------------------

class AlbertSelfAttention(nn.Module):
    """ALBERT's attention block: q/k/v, the output ``dense`` and the
    LayerNorm over ``proj + hidden``, in one module."""

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        h = cfg.hidden_size
        self.query = Dense(h, h, device=device)
        self.key = Dense(h, h, device=device)
        self.value = Dense(h, h, device=device)
        self.dense = Dense(h, h, device=device)
        self.LayerNorm = LayerNorm(h, cfg.layer_norm_eps, device=device)
        self.n_heads = cfg.num_attention_heads

    def forward(self, hidden, bias, mc=None):
        if mc is not None:
            return mc.albert_attention(self, hidden, bias)
        ctx = ops_attention.mha(self.query(hidden), self.key(hidden), self.value(hidden),
                                bias, self.n_heads)
        return self.LayerNorm(self.dense(ctx) + hidden)


class AlbertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.attention = AlbertSelfAttention(cfg, device)
        self.ffn = Dense(cfg.hidden_size, cfg.intermediate_size, device=device)
        self.ffn_output = Dense(cfg.intermediate_size, cfg.hidden_size, device=device)
        self.full_layer_layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                               device=device)
        self.act = cfg.hidden_act

    def forward(self, hidden, bias, mc=None):
        a = self.attention(hidden, bias, mc)
        f = self.ffn_output(activation(self.ffn(a, mc), self.act), mc)
        return self.full_layer_layer_norm(f + a)


class AlbertLayerGroup(nn.Module):
    """One layer group (``albert_layers``: HF's ``inner_group_num`` = 1)."""

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.albert_layers = nn.ModuleList([AlbertLayer(cfg, device)])

    def forward(self, hidden, bias, mc=None):
        for layer in self.albert_layers:
            hidden = layer(hidden, bias, mc)
        return hidden


class AlbertEncoder(nn.Module):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.embedding_hidden_mapping_in = Dense(cfg.embedding_width, cfg.hidden_size,
                                                 device=device)
        # HF's num_hidden_groups = 1: every repetition calls group 0
        self.albert_layer_groups = nn.ModuleList([AlbertLayerGroup(cfg, device)])
        self.n_layers = cfg.num_hidden_layers

    def forward(self, hidden, bias, mc=None):
        hidden = self.embedding_hidden_mapping_in(hidden, mc)
        for _ in range(self.n_layers):
            hidden = self.albert_layer_groups[0](hidden, bias, mc)
        return hidden


class AlbertModule(nn.Module):
    def __init__(self, cfg: BertConfig, dtype, device=None, *, pooler=True):
        super().__init__()
        self.embeddings = BertEmbeddings(cfg, dtype, device)
        self.encoder = AlbertEncoder(cfg, device)
        if pooler:
            self.pooler = Dense(cfg.hidden_size, cfg.hidden_size, device=device)


class AlbertForSequenceClassification(EncoderModel):
    """ALBERT: one shared layer, called ``num_hidden_layers`` times."""

    family = "albert"

    def build(self, cfg, dtype, device):
        self.albert = AlbertModule(cfg, dtype, device, pooler=self.task == "classification")
        if self.task == "classification":
            self.classifier = Dense(cfg.hidden_size, cfg.num_labels, device=device)

    def encode(self, input_ids, attention_mask, token_type_ids, mc):
        a = self.albert
        hidden = a.embeddings(input_ids, token_type_ids, self.positions(input_ids), mc)
        return a.encoder(hidden, ops_attention.mask_to_bias(attention_mask), mc)

    def classify(self, hidden, mc):
        y = self.albert.pooler(hidden[:, 0], mc)
        return self.classifier(torch.tanh(y.float()).to(y.dtype), mc)


MODEL_CLASSES = {
    "bert": BertForSequenceClassification,
    "distilbert": DistilBertForSequenceClassification,
    "roberta": RobertaForSequenceClassification,
    "electra": ElectraForSequenceClassification,
    "albert": AlbertForSequenceClassification,
}


def family_of(model_name: str) -> str:
    """The encoder family of a model name, in the reference's order
    (``build_model``, ``bayeformers_tpu/models/bert.py:286-297``):
    DistilBERT, then RoBERTa or CamemBERT (RoBERTa's builder), Electra,
    ALBERT, and BERT for any other name."""
    name = model_name.lower()
    if "distilbert" in name:
        return "distilbert"
    if "roberta" in name or "camembert" in name:
        return "roberta"
    if "electra" in name:
        return "electra"
    if "albert" in name:
        return "albert"
    return "bert"


def build_family(family: str, task: str = "classification", n_labels: int = 2,
                 size: str = "base", seed: int = 0, dtype=torch.bfloat16,
                 device="cuda", pretrained: Optional[str] = None,
                 **overrides) -> EncoderModel:
    """An encoder of ``family`` for ``task`` at its ``base`` or ``tiny``
    preset (config fields overridden by ``overrides``), initialised from
    ``seed`` as HF initialises it, or with ``pretrained`` a local HF
    directory's config and weights (a task head it lacks from ``seed``:
    ``pretrained.py``). ``dtype`` is the activation dtype; parameters stay
    f32."""
    if pretrained is not None:
        from bayeformers_tpu_torch.pretrained import load_pretrained

        return load_pretrained(pretrained, task, n_labels, seed, dtype, device)
    base, tiny = PRESETS[family]
    cfg = BertConfig(num_labels=n_labels, family=family,
                     **dict(base if size == "base" else tiny, **overrides))
    device = check_device(device, f"build_{family}")
    model = MODEL_CLASSES[family](cfg, dtype=dtype, device=device, task=task)
    init_weights(model, seed)
    model.requires_grad_(False)
    return model


def build_model(model_name: str, task: str = "classification", n_labels: int = 2,
                size: str = "base", seed: int = 0, dtype=torch.bfloat16,
                device="cuda", pretrained: Optional[str] = None,
                **overrides) -> nn.Module:
    """Family dispatch by model name, in the reference's order
    (``bayeformers_tpu/models/bert.py:261-297``): GPT-2, T5, the LLaMA
    families (causal LMs: ``task="causal-lm"``), ViT (image
    classification), then the encoders (:func:`family_of`). T5 is the
    seq2seq LM at ``size="small"`` (the default ``"base"`` reads as the
    reference's default, t5-small) or ``"tiny"``. ``pretrained``, a local
    HF directory, goes to the family's build function, as in the reference."""
    name = model_name.lower()
    causal = task in ("causal-lm", None)
    if "gpt2" in name or "gpt-2" in name:
        if not causal:
            raise ValueError(f"gpt2 supports task='causal-lm'; got {task!r}")
        from bayeformers_tpu_torch.models.gpt2 import build_gpt2

        return build_gpt2(size, seed=seed, dtype=dtype, device=device, pretrained=pretrained,
                          **overrides)
    if "t5" in name:
        from bayeformers_tpu_torch.models.t5 import build_t5

        # the reference's build_t5 defaults to t5-small; any task is ignored
        return build_t5("small" if size == "base" else size, seed=seed, dtype=dtype,
                        device=device, pretrained=pretrained, **overrides)
    for fam in ("llama", "mistral", "gemma"):
        if fam in name:
            if not causal:
                raise ValueError(f"{fam} supports task='causal-lm'; got {task!r}")
            from bayeformers_tpu_torch.models.llama import build_llama_family

            return build_llama_family(fam, size, seed=seed, dtype=dtype, device=device,
                                      pretrained=pretrained, **overrides)
    if "vit" in name:
        from bayeformers_tpu_torch.models.vit import build_vit

        return build_vit(task or "classification", n_labels, size, seed, dtype, device,
                         pretrained, **overrides)
    return build_family(family_of(name), task or "classification", n_labels, size, seed,
                        dtype, device, pretrained, **overrides)


def uses_token_type_ids(model: nn.Module) -> bool:
    """Whether the model takes token types (DistilBERT and RoBERTa do not)."""
    return getattr(model, "uses_token_type_ids", True)


def input_keys(model: nn.Module) -> tuple[str, ...]:
    """The model's inputs, pruned per family as the reference prunes them
    (ViT's pixels, CLIP's ids, pixels and mask: the model's own
    ``input_keys``)."""
    if hasattr(model, "input_keys"):
        return model.input_keys
    keys = ("input_ids", "attention_mask")
    return keys + (("token_type_ids",) if uses_token_type_ids(model) else ())


def prune_inputs(model: nn.Module, inputs: dict) -> dict:
    """Drop ``token_type_ids`` for families that do not take them
    (reference ``examples/bert_squad.py:184-185``)."""
    if not uses_token_type_ids(model):
        inputs = {k: v for k, v in inputs.items() if k != "token_type_ids"}
    return inputs


def synthetic_batch(rng, batch_size: int, seq_len: int, vocab_size: int,
                    n_labels: int = 2, task: str = "classification") -> dict:
    """Offline stand-in for a tokenized GLUE or SQuAD batch as numpy arrays,
    the reference's draws in its order (``models/bert.py:308-324``)."""
    ids = rng.integers(0, vocab_size, (batch_size, seq_len))
    batch = {
        "input_ids": np.asarray(ids, np.int32),
        "attention_mask": np.ones((batch_size, seq_len), np.int32),
        "token_type_ids": np.zeros((batch_size, seq_len), np.int32),
    }
    if task == "classification":
        batch["labels"] = np.asarray(rng.integers(0, n_labels, (batch_size,)))
    else:
        batch["start_positions"] = np.asarray(rng.integers(0, seq_len, (batch_size,)))
        batch["end_positions"] = np.asarray(rng.integers(0, seq_len, (batch_size,)))
    return batch
