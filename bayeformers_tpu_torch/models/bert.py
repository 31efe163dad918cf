"""A plain-torch BERT encoder with a sequence-classification or a span
(question-answering) head, and the pieces its sibling families share
(``models/families.py``: DistilBERT, RoBERTa/CamemBERT, Electra, ALBERT).

Written for the port so that it needs no ``transformers``. The computation
is that of HF's BERT as the JAX package builds it
(``bayeformers_tpu/models/bert.py``, FlaxBertForSequenceClassification and
FlaxBertForQuestionAnswering): word + token-type + position embeddings,
LayerNorm (eps 1e-12), post-LN encoder layers with exact GELU, a tanh
pooler on the first token, and a linear classifier; the QA head is
``qa_outputs`` (H -> 2) on every position, with no pooler. Dropout is
omitted: the port runs deterministic forwards.

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
from typing import Optional

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


FAMILIES = ("bert", "distilbert", "roberta", "electra", "albert")
TASKS = ("classification", "qa")


@dataclasses.dataclass(frozen=True)
class BertConfig:
    """The configuration of every encoder family (``family``): BERT's
    fields, plus ``embedding_size`` (Electra's and ALBERT's embedding
    width; None: ``hidden_size``), ``hidden_act`` (``"gelu"`` exact,
    ``"gelu_new"`` tanh: ALBERT's) and ``pad_token_id`` (RoBERTa's
    position ids skip it)."""

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
    family: str = "bert"
    embedding_size: Optional[int] = None
    hidden_act: str = "gelu"
    pad_token_id: int = 0

    @property
    def embedding_width(self) -> int:
        return self.embedding_size or self.hidden_size

    @classmethod
    def from_hf(cls, family: str, d: dict) -> "BertConfig":
        """The port's config from an HF config's ``to_dict()`` of
        ``family`` (DistilBERT's ``dim``, ``n_layers``, ``n_heads``,
        ``hidden_dim`` and ``activation`` under their BERT names)."""
        if family not in FAMILIES:
            raise ValueError(f"unknown encoder family {family!r}")
        if family == "distilbert":
            d = dict(hidden_size=d["dim"], num_hidden_layers=d["n_layers"],
                     num_attention_heads=d["n_heads"], intermediate_size=d["hidden_dim"],
                     hidden_act=d["activation"], vocab_size=d["vocab_size"],
                     max_position_embeddings=d["max_position_embeddings"],
                     type_vocab_size=0, num_labels=d.get("num_labels", 2),
                     initializer_range=d.get("initializer_range", 0.02))
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in names}
        if family not in ("electra", "albert"):
            kw.pop("embedding_size", None)
        return cls(**dict(kw, family=family))


def activation(y: torch.Tensor, act: str) -> torch.Tensor:
    """HF's ``ACT2FN`` in f32, back in ``y``'s dtype: ``"gelu"`` exact
    (erf), ``"gelu_new"`` the tanh form, ``"relu"``."""
    yf = y.float()
    if act == "gelu":
        out = F.gelu(yf)
    elif act == "gelu_new":
        out = F.gelu(yf, approximate="tanh")
    elif act == "relu":
        out = torch.relu(yf)
    else:
        raise ValueError(f"unsupported activation {act!r}")
    return out.to(y.dtype)


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


def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` with the fixed-order backward of :class:`_Lookup`."""
    return _Lookup.apply(table, ids)


class Embed(nn.Module):
    """Flax's ``nn.Embed``: ``embedding`` (n, d), looked up in f32. A
    converted table (``EMBEDDING_RULE``) hands itself to the tier of the
    call (``mc.embed(self, ids)``), as a ``Dense`` does."""

    def __init__(self, n: int, d: int, *, device=None):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(n, d, device=device))
        self.path = ""  # the Flax path of this module, set by assign_paths

    def forward(self, ids, mc=None):
        if mc is not None:
            return mc.embed(self, ids)
        return lookup(self.embedding, ids)

    def lookup_shared(self, ids, mc=None):
        """A lookup of ids that are not batch-shaped, shared by every
        example of an S-major batch (T5's (Lq, Lk) buckets, Whisper's
        encoder positions): (G, *ids.shape, D), G = 1 but where the tier
        draws a whole table per sample (``mc.embed_unbatched``)."""
        if mc is not None:
            return mc.embed_unbatched(self, ids)
        return lookup(self.embedding, ids)[None]


class BertEmbeddings(nn.Module):
    """Word + token-type + position embeddings and their LayerNorm, at the
    config's embedding width. BERT and RoBERTa (Flax's ``nn.Embed(dtype=
    ...)``) take each lookup in the activation dtype and sum in it;
    DistilBERT (no token types), Electra and ALBERT sum f32 lookups and
    cast after the LayerNorm."""

    def __init__(self, cfg: BertConfig, dtype, device=None):
        super().__init__()
        e = cfg.embedding_width
        self.word_embeddings = Embed(cfg.vocab_size, e, device=device)
        self.position_embeddings = Embed(cfg.max_position_embeddings, e, device=device)
        if cfg.family != "distilbert":
            self.token_type_embeddings = Embed(cfg.type_vocab_size, e, device=device)
        self.LayerNorm = LayerNorm(e, cfg.layer_norm_eps, device=device)
        self.dtype = dtype
        self.cast_lookups = cfg.family in ("bert", "roberta")

    def forward(self, input_ids, token_type_ids, position_ids, mc=None):
        # as HF's Flax embeddings: word, token type, position, in this order
        dt = self.dtype if self.cast_lookups else torch.float32
        x = self.word_embeddings(input_ids, mc).to(dt)
        if hasattr(self, "token_type_embeddings"):
            x = x + self.token_type_embeddings(token_type_ids, mc).to(dt)
        x = x + self.position_embeddings(position_ids, mc).to(dt)
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
        self.act = cfg.hidden_act

    def forward(self, hidden, mc=None):
        return activation(self.dense(hidden, mc), self.act)


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
    """BERT's backbone; RoBERTa's (pad-aware positions, no pooler) and
    Electra's (an ``embeddings_project`` where the embedding width is not
    the hidden width) share it."""

    def __init__(self, cfg: BertConfig, dtype, device=None, *, pooler=True):
        super().__init__()
        self.embeddings = BertEmbeddings(cfg, dtype, device)
        if cfg.embedding_width != cfg.hidden_size:
            self.embeddings_project = Dense(cfg.embedding_width, cfg.hidden_size,
                                            device=device)
        self.encoder = BertEncoder(cfg, device)
        if pooler:
            self.pooler = BertPooler(cfg, device)

    def forward(self, input_ids, bias, token_type_ids, position_ids, mc=None):
        hidden = self.embeddings(input_ids, token_type_ids, position_ids, mc)
        if hasattr(self, "embeddings_project"):
            hidden = self.embeddings_project(hidden, mc)
        return self.encoder(hidden, bias, mc)


class EncoderModel(nn.Module):
    """An encoder family with the head of ``task``: ``"classification"``
    (``forward`` -> logits (N, num_labels)) or ``"qa"`` (HF's
    ``*ForQuestionAnswering``: ``qa_outputs`` over every position, no
    pooler; ``forward`` -> ``(start_logits, end_logits)``, each (N, L)).
    Activations are in ``dtype``; parameters stay f32. A subclass builds
    its backbone in :meth:`build` and runs it in :meth:`encode`; its
    classification head is :meth:`classify`."""

    family = "bert"
    uses_token_type_ids = True

    def __init__(self, cfg: BertConfig, dtype=torch.float32, device=None,
                 task: str = "classification"):
        super().__init__()
        if task not in TASKS:
            raise ValueError(f"task must be one of {TASKS}, got {task!r}")
        if cfg.family != self.family:
            raise ValueError(f"{type(self).__name__} takes a {self.family!r} config, "
                             f"got {cfg.family!r}")
        self.config = cfg
        self.dtype = dtype
        self.task = task
        self.build(cfg, dtype, device)
        if task == "qa":
            self.qa_outputs = Dense(cfg.hidden_size, cfg.num_labels, device=device)
        assign_paths(self)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                mc=None):
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        hidden = self.encode(input_ids, attention_mask, token_type_ids, mc)
        if self.task == "qa":
            y = self.qa_outputs(hidden, mc)
            return y[..., 0].contiguous(), y[..., 1].contiguous()
        return self.classify(hidden, mc)

    def positions(self, input_ids):
        L = input_ids.shape[-1]
        return torch.arange(L, device=input_ids.device).expand_as(input_ids)


class BertForSequenceClassification(EncoderModel):
    """BERT: ``forward(input_ids, attention_mask, token_type_ids, mc=None)``
    -> logits (N, num_labels) in the activation dtype, or with
    ``task="qa"`` the start and end logits."""

    def build(self, cfg, dtype, device):
        self.bert = BertModule(cfg, dtype, device, pooler=self.task == "classification")
        if self.task == "classification":
            self.classifier = Dense(cfg.hidden_size, cfg.num_labels, device=device)

    def encode(self, input_ids, attention_mask, token_type_ids, mc):
        bias = ops_attention.mask_to_bias(attention_mask)
        return self.bert(input_ids, bias, token_type_ids, self.positions(input_ids), mc)

    def classify(self, hidden, mc):
        return self.classifier(self.bert.pooler(hidden, mc), mc)


@torch.no_grad()
def init_weights(model: nn.Module, seed: int) -> None:
    """HF's init from a seed: N(0, initializer_range) kernels and
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


def check_device(device, what: str) -> torch.device:
    """``device`` as a ``torch.device``; raises for ``cuda`` without a card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what}(device='cuda'): no CUDA device")
    return device


def build_bert(size: str = "base", n_labels: int = 2, seed: int = 0,
               dtype=torch.bfloat16, device="cuda") -> BertForSequenceClassification:
    """BERT for sequence classification at ``BERT_BASE_KWARGS`` (``size=
    "base"``) or ``BERT_TINY_KWARGS`` (``"tiny"``), initialised from
    ``seed``: ``families.build_family("bert", ...)``."""
    from bayeformers_tpu_torch.models.families import build_family

    return build_family("bert", "classification", n_labels, size, seed, dtype, device)
