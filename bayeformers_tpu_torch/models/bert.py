"""A plain-torch BERT encoder with a sequence-classification head.

Written for the port so that it needs no ``transformers``. The computation
is that of HF's BERT as the JAX package builds it
(``bayeformers_tpu/models/bert.py``, FlaxBertForSequenceClassification):
word + token-type + position embeddings, LayerNorm (eps 1e-12), post-LN
encoder layers with exact GELU, a tanh pooler on the first token, and a
linear classifier. Dropout is omitted: the port runs deterministic forwards.

Parameter names follow the Flax tree: ``Dense`` (``nn/dense.py``) holds
``kernel`` (in, out) and ``bias``, ``LayerNorm`` holds ``scale`` and
``bias``, ``Embed`` holds ``embedding``, and the submodule names match, so
``name.replace('.', '/')`` of a torch parameter is its Flax path. The (in,
out) orientation is the one that defines the eps stream.

Every forward takes an optional ``mc`` (:class:`nn.fused.FusedMC`): when
given, converted ``Dense`` layers and self-attention blocks dispatch to it.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from bayeformers_tpu_torch.nn.dense import Dense, assign_paths
from bayeformers_tpu_torch.ops import attention as ops_attention

BERT_BASE_KWARGS = dict(
    vocab_size=30522, hidden_size=768, num_hidden_layers=12,
    num_attention_heads=12, intermediate_size=3072, max_position_embeddings=512,
)
BERT_TINY_KWARGS = dict(
    vocab_size=1024, hidden_size=128, num_hidden_layers=2,
    num_attention_heads=2, intermediate_size=256, max_position_embeddings=128,
)


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int
    hidden_size: int
    num_hidden_layers: int
    num_attention_heads: int
    intermediate_size: int
    max_position_embeddings: int
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    num_labels: int = 2
    initializer_range: float = 0.02


class LayerNorm(nn.Module):
    """LayerNorm with statistics in f32; the output takes the input dtype."""

    def __init__(self, n: int, eps: float, *, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(n, device=device))
        self.bias = nn.Parameter(torch.zeros(n, device=device))
        self.eps = eps

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = (xf * xf).mean(-1, keepdim=True) - mean * mean
        mul = torch.rsqrt(var.clamp_min(0.0) + self.eps) * self.scale
        return ((xf - mean) * mul + self.bias).to(x.dtype)


class _Lookup(torch.autograd.Function):
    """Table rows by id, with a backward that sums each row's gradients in
    a fixed order: ids sorted stably, gradients prefix-summed in float64
    and differenced at the ends of the runs of equal ids. PyTorch's own
    embedding backward on the card adds heavily repeated ids (token types,
    padding) in an order that changes from run to run."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.table_shape = table.shape
        return F.embedding(ids, table)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        flat = ids.reshape(-1)
        order = torch.argsort(flat, stable=True)
        sorted_ids = flat[order]
        # (features, tokens): the scan runs along the innermost dimension,
        # which the card's scan kernels do ~10x faster than the outer one
        gt = g.reshape(-1, g.shape[-1])[order].double().t().contiguous()
        csum = torch.cumsum(gt, dim=1)
        run_end = torch.ones_like(sorted_ids, dtype=torch.bool)
        run_end[:-1] = sorted_ids[1:] != sorted_ids[:-1]
        ends = csum[:, run_end]
        sums = torch.diff(ends, dim=1, prepend=torch.zeros_like(ends[:, :1]))
        out = torch.zeros(ctx.table_shape, dtype=g.dtype, device=g.device)
        out[sorted_ids[run_end]] = sums.t().to(g.dtype)
        return out, None


class Embed(nn.Module):
    def __init__(self, n: int, d: int, *, device=None):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(n, d, device=device))

    def forward(self, ids):
        return _Lookup.apply(self.embedding, ids)


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig, dtype, device=None):
        super().__init__()
        h = cfg.hidden_size
        self.word_embeddings = Embed(cfg.vocab_size, h, device=device)
        self.position_embeddings = Embed(cfg.max_position_embeddings, h, device=device)
        self.token_type_embeddings = Embed(cfg.type_vocab_size, h, device=device)
        self.LayerNorm = LayerNorm(h, cfg.layer_norm_eps, device=device)
        self.dtype = dtype

    def forward(self, input_ids, token_type_ids, position_ids):
        x = (self.word_embeddings(input_ids)
             + self.token_type_embeddings(token_type_ids)
             + self.position_embeddings(position_ids))
        return self.LayerNorm(x).to(self.dtype)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        h = cfg.hidden_size
        self.query = Dense(h, h, device=device)
        self.key = Dense(h, h, device=device)
        self.value = Dense(h, h, device=device)
        self.n_heads = cfg.num_attention_heads

    def forward(self, hidden, bias, mc=None):
        if mc is not None:
            return mc.self_attention(self, hidden, bias)
        return ops_attention.mha(
            self.query(hidden), self.key(hidden), self.value(hidden), bias,
            self.n_heads,
        )


class BertSelfOutput(nn.Module):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.dense = Dense(cfg.hidden_size, cfg.hidden_size, device=device)
        self.LayerNorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, device=device)

    def forward(self, hidden, residual, mc=None):
        return self.LayerNorm(self.dense(hidden, mc) + residual)


class BertAttention(nn.Module):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.self = BertSelfAttention(cfg, device)
        self.output = BertSelfOutput(cfg, device)

    def forward(self, hidden, bias, mc=None):
        return self.output(self.self(hidden, bias, mc), hidden, mc)


class BertIntermediate(nn.Module):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.dense = Dense(cfg.hidden_size, cfg.intermediate_size, device=device)

    def forward(self, hidden, mc=None):
        y = self.dense(hidden, mc)
        return F.gelu(y.float()).to(y.dtype)  # exact (erf) GELU


class BertOutput(nn.Module):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.dense = Dense(cfg.intermediate_size, cfg.hidden_size, device=device)
        self.LayerNorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, device=device)

    def forward(self, hidden, residual, mc=None):
        return self.LayerNorm(self.dense(hidden, mc) + residual)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.attention = BertAttention(cfg, device)
        self.intermediate = BertIntermediate(cfg, device)
        self.output = BertOutput(cfg, device)

    def forward(self, hidden, bias, mc=None):
        a = self.attention(hidden, bias, mc)
        return self.output(self.intermediate(a, mc), a, mc)


class BertEncoder(nn.Module):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.layer = nn.ModuleList(
            BertLayer(cfg, device) for _ in range(cfg.num_hidden_layers)
        )

    def forward(self, hidden, bias, mc=None):
        for layer in self.layer:
            hidden = layer(hidden, bias, mc)
        return hidden


class BertPooler(nn.Module):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.dense = Dense(cfg.hidden_size, cfg.hidden_size, device=device)

    def forward(self, hidden, mc=None):
        y = self.dense(hidden[:, 0], mc)
        return torch.tanh(y.float()).to(y.dtype)


class BertModule(nn.Module):
    def __init__(self, cfg: BertConfig, dtype, device=None):
        super().__init__()
        self.embeddings = BertEmbeddings(cfg, dtype, device)
        self.encoder = BertEncoder(cfg, device)
        self.pooler = BertPooler(cfg, device)


class BertForSequenceClassification(nn.Module):
    """``forward(input_ids, attention_mask, token_type_ids, mc=None)`` ->
    logits (N, num_labels) in the activation dtype."""

    def __init__(self, cfg: BertConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.config = cfg
        self.dtype = dtype
        self.bert = BertModule(cfg, dtype, device)
        self.classifier = Dense(cfg.hidden_size, cfg.num_labels, device=device)
        assign_paths(self)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                mc=None):
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        L = input_ids.shape[-1]
        position_ids = torch.arange(L, device=input_ids.device).expand_as(input_ids)
        bias = ops_attention.mask_to_bias(attention_mask)
        b = self.bert
        hidden = b.embeddings(input_ids, token_type_ids, position_ids)
        hidden = b.encoder(hidden, bias, mc)
        return self.classifier(b.pooler(hidden, mc), mc)


@torch.no_grad()
def init_weights(model: BertForSequenceClassification, seed: int) -> None:
    """HF's BERT init from a seed: N(0, initializer_range) kernels and
    embedding tables, zero biases, unit LayerNorm scales."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    std = model.config.initializer_range
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("kernel", "embedding"):
            p.normal_(0.0, std, generator=gen)
        elif leaf == "scale":
            p.fill_(1.0)
        else:
            p.zero_()


def build_bert(size: str = "base", n_labels: int = 2, seed: int = 0,
               dtype=torch.bfloat16, device="cuda") -> BertForSequenceClassification:
    """BERT for sequence classification at ``BERT_BASE_KWARGS`` (``size=
    "base"``) or ``BERT_TINY_KWARGS`` (``"tiny"``), initialised from
    ``seed``. ``dtype`` is the activation dtype; parameters stay f32."""
    kwargs = BERT_BASE_KWARGS if size == "base" else BERT_TINY_KWARGS
    cfg = BertConfig(num_labels=n_labels, **kwargs)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_bert(device='cuda'): no CUDA device")
    model = BertForSequenceClassification(cfg, dtype=dtype, device=device)
    init_weights(model, seed)
    model.requires_grad_(False)
    return model
