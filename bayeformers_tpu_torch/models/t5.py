"""A plain-torch T5 encoder-decoder (seq2seq LM), the counterpart of HF's
``FlaxT5ForConditionalGeneration`` as the JAX package builds it
(``bayeformers_tpu/models/t5.py``).

The computation is the Flax module's (transformers 4.57):

- RMS LayerNorm (``layer_norm/weight``): no mean and no bias, the variance
  in f32, eps ``layer_norm_epsilon`` (1e-6);
- attention with unscaled logits (the Flax module multiplies q by
  ``sqrt(d_kv)`` to undo ``dot_product_attention``'s scaling), plus a
  position bias: block 0 of each stack holds a ``relative_attention_bias``
  table (buckets x heads) that it looks up with bidirectional buckets in
  the encoder and causal ones in the decoder; the bias, with the mask added,
  is reused by every later block of its stack. The cross-attention has no
  table: its bias is the encoder mask alone;
- the FFN ``wo(act(wi(x)))`` (``feed_forward_proj="relu"``, T5 v1.0) or
  ``wo(act(wi_0(x)) * wi_1(x))`` (``"gated-gelu"``, v1.1, the tanh GELU);
- a head tied to ``shared`` (the output scaled by ``d_model ** -0.5``
  first) or an untied ``lm_head`` (``tie_word_embeddings=False``).

Parameter names are the Flax paths (``shared/embedding``,
``encoder/block/0/layer/0/SelfAttention/q/kernel``, ...,
``decoder/block/1/layer/2/DenseReluDense/wo/kernel``). Every projection is
a bias-free ``Dense``, so the default rules convert every q/k/v/o and
wi/wo kernel (the tied head stays frequentist, as in the reference);
``EMBEDDING_RULE`` converts ``shared`` and the two bias tables too. The
reference's fused tier does not intercept T5's attention: each Dense goes
to the tier and the attention stays plain torch (f32 scores and softmax,
probabilities in the activation dtype), as XLA computes it there.

A table looked up with ids that are not batch-shaped (the (Lq, Lk)
buckets) goes through ``Embed.lookup_shared`` (``models/bert.py``), which
returns one bias per draw group: one for every sample in the interception
tiers, one per sample in the naive tier, as each of the reference's tiers
computes it. The tied head reads ``mc.tied_table`` (mu, or the naive tier's
per-sample tables).

Decoding: :meth:`T5ForConditionalGeneration.encode` runs the encoder once
and computes every cross-attention's K and V; :meth:`decode_step` runs the
decoder on new ids at cache positions ``[start, start + l)`` with the
self-attention's K and V cached (``generation.py::mc_generate``).
Activations are in ``dtype``; parameters stay f32. Dropout is omitted.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from bayeformers_tpu_torch import elbo
from bayeformers_tpu_torch.models.bert import Embed, activation, check_device
from bayeformers_tpu_torch.nn.dense import Dense, assign_paths
from bayeformers_tpu_torch.ops.attention import cache_kv, mask_to_bias, plain_attention

# decoder_start_token_id = pad (0), as every released T5 checkpoint has it
T5_SMALL_KWARGS = dict(
    vocab_size=32128, d_model=512, d_kv=64, d_ff=2048,
    num_layers=6, num_heads=8, decoder_start_token_id=0,
)
T5_TINY_KWARGS = dict(
    vocab_size=512, d_model=64, d_kv=16, d_ff=128,
    num_layers=2, num_heads=4, decoder_start_token_id=0,
)


@dataclasses.dataclass(frozen=True)
class T5Config:
    """HF's ``T5Config`` fields that the model reads, with its defaults."""

    vocab_size: int = 32128
    d_model: int = 512
    d_kv: int = 64
    d_ff: int = 2048
    num_layers: int = 6
    num_heads: int = 8
    num_decoder_layers: Optional[int] = None
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    initializer_factor: float = 1.0
    feed_forward_proj: str = "relu"
    tie_word_embeddings: bool = True
    pad_token_id: int = 0
    eos_token_id: int = 1
    decoder_start_token_id: Optional[int] = 0

    @property
    def is_gated_act(self) -> bool:
        return self.feed_forward_proj.split("-")[0] == "gated"

    @property
    def dense_act_fn(self) -> str:
        """HF's mapping: ``"gated-gelu"`` takes the tanh GELU."""
        if self.feed_forward_proj == "gated-gelu":
            return "gelu_new"
        return self.feed_forward_proj.split("-")[-1]

    @property
    def n_decoder_layers(self) -> int:
        return self.num_decoder_layers or self.num_layers

    @property
    def start_id(self) -> int:
        """The decoder's first id: ``decoder_start_token_id``, else pad."""
        s = self.decoder_start_token_id
        return self.pad_token_id if s is None else s

    @classmethod
    def from_hf(cls, d: dict) -> "T5Config":
        """The fields of an HF ``T5Config.to_dict()`` or ``config.json``."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


def shift_right(labels: torch.Tensor, start_id: int, pad_id: int) -> torch.Tensor:
    """HF's ``shift_tokens_right``: the start id, then ``labels[:, :-1]``,
    with ``-100`` replaced by the pad id."""
    shifted = torch.zeros_like(labels)
    shifted[:, 1:] = labels[:, :-1]
    shifted[:, 0] = start_id
    return torch.where(shifted == -100, torch.full_like(shifted, pad_id), shifted)


def relative_position_bucket(rel: torch.Tensor, bidirectional: bool, num_buckets: int,
                             max_distance: int) -> torch.Tensor:
    """Flax's ``_relative_position_bucket`` of ``rel = key - query``: half
    the buckets (both signs when bidirectional) exact up to ``num_buckets /
    2``, the rest logarithmic up to ``max_distance``, in f32 as Flax computes
    them."""
    buckets = torch.zeros_like(rel)
    if bidirectional:
        num_buckets //= 2
        buckets = buckets + (rel > 0).to(rel.dtype) * num_buckets
        rel = rel.abs()
    else:
        rel = -torch.clamp(rel, max=0)
    max_exact = num_buckets // 2
    is_small = rel < max_exact
    large = max_exact + (torch.log(rel.float() / max_exact) / math.log(max_distance / max_exact)
                         * (num_buckets - max_exact))
    large = torch.clamp(large, max=num_buckets - 1)
    return buckets + torch.where(is_small, rel.float(), large).to(rel.dtype)


class T5LayerNorm(nn.Module):
    """T5's RMS LayerNorm: ``weight * x / sqrt(mean(x^2) + eps)`` in f32;
    the output takes ``dtype``."""

    def __init__(self, n: int, eps: float, dtype, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n, device=device))
        self.eps = eps
        self.dtype = dtype

    def forward(self, x):
        xf = x.float()
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        return (self.weight * (xf / torch.sqrt(var + self.eps))).to(self.dtype)


def grouped_bias(position_bias: torch.Tensor, mask_bias: torch.Tensor) -> torch.Tensor:
    """``position_bias`` (G, H, Lq, Lk), one for each of G groups of the
    S-major batch (G = 1: one for all), plus ``mask_bias`` (N, 1, Lq or 1,
    Lk) -> (N, H, Lq, Lk)."""
    G, N = position_bias.shape[0], mask_bias.shape[0]
    out = mask_bias.reshape((G, N // G) + tuple(mask_bias.shape[1:])) + position_bias[:, None]
    return out.reshape((N,) + tuple(out.shape[2:]))


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool, causal: bool, device=None):
        super().__init__()
        inner = cfg.num_heads * cfg.d_kv
        self.q = Dense(cfg.d_model, inner, use_bias=False, device=device)
        self.k = Dense(cfg.d_model, inner, use_bias=False, device=device)
        self.v = Dense(cfg.d_model, inner, use_bias=False, device=device)
        self.o = Dense(inner, cfg.d_model, use_bias=False, device=device)
        if has_bias:
            self.relative_attention_bias = Embed(cfg.relative_attention_num_buckets,
                                                 cfg.num_heads, device=device)
        self.n_heads = cfg.num_heads
        self.causal = causal
        self.num_buckets = cfg.relative_attention_num_buckets
        self.max_distance = cfg.relative_attention_max_distance

    def position_bias(self, q_pos: torch.Tensor, k_len: int, mc=None) -> torch.Tensor:
        """The table's bias for queries at ``q_pos`` over keys ``0 ..
        k_len - 1``: (G, H, Lq, Lk) f32, G draw groups
        (``Embed.lookup_shared``)."""
        rel = torch.arange(k_len, device=q_pos.device)[None, :] - q_pos[:, None]
        buckets = relative_position_bucket(rel, not self.causal, self.num_buckets,
                                           self.max_distance)
        values = self.relative_attention_bias.lookup_shared(buckets, mc)  # (G, Lq, Lk, H)
        return values.float().permute(0, 3, 1, 2)

    def forward(self, hidden, kv, bias, mc=None, cache=None):
        """``kv``: the keys' and values' input, or their projections (K, V)
        already made (a decode's cross-attention, made once by the model's
        ``encode``); ``cache``: a decode's self-attention (K, V, start),
        which k and v go into."""
        q = self.q(hidden, mc)
        if isinstance(kv, tuple):
            k, v = kv
        else:
            k, v = self.k(kv, mc), self.v(kv, mc)
            if cache is not None:
                k, v = cache_kv(cache, k, v)
        return self.o(plain_attention(q, k, v, bias, self.n_heads, scale=False), mc)


class T5LayerSelfAttention(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool, causal: bool, dtype, device=None):
        super().__init__()
        self.SelfAttention = T5Attention(cfg, has_bias, causal, device)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon, dtype, device)

    def forward(self, hidden, bias, mc=None, cache=None):
        h = self.layer_norm(hidden)
        return hidden + self.SelfAttention(h, h, bias, mc, cache)


class T5LayerCrossAttention(nn.Module):
    def __init__(self, cfg: T5Config, dtype, device=None):
        super().__init__()
        self.EncDecAttention = T5Attention(cfg, False, False, device)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon, dtype, device)

    def forward(self, hidden, enc, bias, mc=None):
        return hidden + self.EncDecAttention(self.layer_norm(hidden), enc, bias, mc)


class T5DenseReluDense(nn.Module):
    """HF's ``FlaxT5DenseActDense`` (``wi``, ``wo``) or, gated,
    ``FlaxT5DenseGatedActDense`` (``wi_0``, ``wi_1``, ``wo``)."""

    def __init__(self, cfg: T5Config, device=None):
        super().__init__()
        self.gated = cfg.is_gated_act
        if self.gated:
            self.wi_0 = Dense(cfg.d_model, cfg.d_ff, use_bias=False, device=device)
            self.wi_1 = Dense(cfg.d_model, cfg.d_ff, use_bias=False, device=device)
        else:
            self.wi = Dense(cfg.d_model, cfg.d_ff, use_bias=False, device=device)
        self.wo = Dense(cfg.d_ff, cfg.d_model, use_bias=False, device=device)
        self.act = cfg.dense_act_fn

    def forward(self, x, mc=None):
        if self.gated:
            h = activation(self.wi_0(x, mc), self.act) * self.wi_1(x, mc)
        else:
            h = activation(self.wi(x, mc), self.act)
        return self.wo(h, mc)


class T5LayerFF(nn.Module):
    def __init__(self, cfg: T5Config, dtype, device=None):
        super().__init__()
        self.DenseReluDense = T5DenseReluDense(cfg, device)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon, dtype, device)

    def forward(self, hidden, mc=None):
        return hidden + self.DenseReluDense(self.layer_norm(hidden), mc)


class T5Block(nn.Module):
    """``layer``: self-attention, cross-attention (decoder), the FFN."""

    def __init__(self, cfg: T5Config, has_bias: bool, causal: bool, dtype, device=None):
        super().__init__()
        layers = [T5LayerSelfAttention(cfg, has_bias, causal, dtype, device)]
        if causal:
            layers.append(T5LayerCrossAttention(cfg, dtype, device))
        layers.append(T5LayerFF(cfg, dtype, device))
        self.layer = nn.ModuleList(layers)


class T5Stack(nn.Module):
    """An encoder (``causal=False``) or decoder stack: ``block`` and
    ``final_layer_norm``; the token table is the model's ``shared``."""

    def __init__(self, cfg: T5Config, causal: bool, dtype, device=None):
        super().__init__()
        n = cfg.n_decoder_layers if causal else cfg.num_layers
        self.block = nn.ModuleList(T5Block(cfg, i == 0, causal, dtype, device)
                                   for i in range(n))
        self.final_layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon, dtype, device)
        self.causal = causal

    @property
    def attention0(self) -> T5Attention:
        return self.block[0].layer[0].SelfAttention

    def self_bias(self, mask: torch.Tensor, q_pos: torch.Tensor, k_len: int,
                  mc=None) -> torch.Tensor:
        """Block 0's position bias plus the mask's, shared by every block:
        ``mask`` (N, Lk) keys kept, queries at ``q_pos``; the decoder's keys
        causal too. (N, H, Lq, Lk) f32."""
        keep = (mask[:, None, :] > 0).expand(mask.shape[0], q_pos.shape[0], k_len)
        if self.causal:
            keep = keep & (torch.arange(k_len, device=mask.device)[None, :]
                           <= q_pos[:, None])[None]
        return grouped_bias(self.attention0.position_bias(q_pos, k_len, mc),
                            mask_to_bias(keep)[:, None])

    def forward(self, hidden, mask, enc=None, enc_bias=None, mc=None, cache=None, start=0):
        """``mask`` (N, start + L) over the keys; the decoder's ``enc`` is
        the encoder's output or, decoding, a list of each block's cross
        (K, V); ``cache``: a decode's per-block self-attention (K, V),
        written from position ``start`` on."""
        end = start + hidden.shape[1]
        bias = self.self_bias(mask, torch.arange(start, end, device=hidden.device), end, mc)
        for i, blk in enumerate(self.block):
            hidden = blk.layer[0](hidden, bias, mc, None if cache is None else (*cache[i], start))
            if self.causal:
                hidden = blk.layer[1](hidden, enc[i] if isinstance(enc, list) else enc,
                                      enc_bias, mc)
            hidden = blk.layer[-1](hidden, mc)
        return self.final_layer_norm(hidden)


class T5ForConditionalGeneration(nn.Module):
    """``forward(input_ids, attention_mask=None, decoder_input_ids=None,
    decoder_attention_mask=None, labels=None, mc=None)`` -> decoder logits
    (N, L_dec, vocab) in the activation dtype; the decoder ids default to
    :func:`shift_right` of ``labels`` (the reference's ``apply_fn``)."""

    family = "t5"
    uses_token_type_ids = False
    input_keys = ("input_ids", "attention_mask", "decoder_input_ids",
                  "decoder_attention_mask", "labels")
    generation = "seq2seq"

    def __init__(self, cfg: T5Config, dtype=torch.float32, device=None):
        super().__init__()
        self.config = cfg
        self.dtype = dtype
        self.shared = Embed(cfg.vocab_size, cfg.d_model, device=device)
        self.encoder = T5Stack(cfg, False, dtype, device)
        self.decoder = T5Stack(cfg, True, dtype, device)
        if not cfg.tie_word_embeddings:
            self.lm_head = Dense(cfg.d_model, cfg.vocab_size, use_bias=False, device=device)
        assign_paths(self)

    def shift_right(self, labels: torch.Tensor) -> torch.Tensor:
        return shift_right(labels, self.config.start_id, self.config.pad_token_id)

    def embed(self, ids, mc=None):
        return self.shared(ids, mc).to(self.dtype)

    def run_encoder(self, input_ids, attention_mask, mc=None):
        return self.encoder(self.embed(input_ids, mc), attention_mask, mc=mc)

    def head(self, hidden, mc=None):
        """Logits of the decoder's output: the tied table after the
        ``d_model ** -0.5`` scale (``mc.tied_table``: mu, or the naive
        tier's (S, V, D) tables), or the untied ``lm_head``."""
        if not self.config.tie_word_embeddings:
            return self.lm_head(hidden, mc)
        h = (hidden.float() * self.config.d_model ** -0.5).to(self.dtype)
        table = self.shared.embedding if mc is None else mc.tied_table(self.shared)
        return tied_logits(h, table)

    def forward(self, input_ids, attention_mask=None, decoder_input_ids=None,
                decoder_attention_mask=None, labels=None, mc=None):
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        if decoder_input_ids is None:
            if labels is None:
                raise ValueError("T5's forward needs decoder_input_ids or labels")
            decoder_input_ids = self.shift_right(labels)
        if decoder_attention_mask is None:
            decoder_attention_mask = torch.ones_like(decoder_input_ids)
        enc = self.run_encoder(input_ids, attention_mask, mc)
        enc_bias = mask_to_bias(attention_mask)[:, None, None, :]
        hidden = self.decoder(self.embed(decoder_input_ids, mc), decoder_attention_mask,
                              enc, enc_bias, mc)
        return self.head(hidden, mc)

    # -- decoding with a KV cache ---------------------------------------------
    def encode(self, input_ids, attention_mask=None) -> dict:
        """The encoder run once for decoding: every decoder layer's
        cross-attention K and V and the encoder mask's bias."""
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        enc = self.run_encoder(input_ids, attention_mask)
        cross = [(blk.layer[1].EncDecAttention.k(enc), blk.layer[1].EncDecAttention.v(enc))
                 for blk in self.decoder.block]
        return {"cross": cross, "enc_bias": mask_to_bias(attention_mask)[:, None, None, :]}

    def init_cache(self, batch: int, max_len: int, device=None) -> list:
        """Per decoder layer, zero K and V of (batch, max_len, inner)."""
        inner = self.config.num_heads * self.config.d_kv
        z = lambda: torch.zeros(batch, max_len, inner, dtype=self.dtype,  # noqa: E731
                                device=device or self.shared.embedding.device)
        return [(z(), z()) for _ in self.decoder.block]

    def decode_step(self, ids, start: int, cache: list, enc: dict) -> torch.Tensor:
        """Decoder ids (B, l) at positions ``[start, start + l)``: the
        decoder's forward with their self-attention K and V written into
        ``cache``, each query attending to the cached keys up to itself and
        to the encoder (:meth:`encode`); returns the logits (B, l,
        vocab)."""
        B, l = ids.shape
        mask = torch.ones(B, start + l, dtype=torch.long, device=ids.device)
        hidden = self.decoder(self.embed(ids), mask, enc["cross"], enc["enc_bias"],
                              cache=cache, start=start)
        return self.head(hidden)


def tied_logits(hidden: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``hidden @ table.T`` in the activation dtype with f32 accumulation;
    a (S, V, D) ``table`` (the naive tier's draws) multiplies each sample's
    block of the S-major batch."""
    if table.dim() == 2:
        return torch.matmul(hidden.float(), table.to(hidden.dtype).float().t()).to(hidden.dtype)
    S = table.shape[0]
    hs = hidden.reshape(S, -1, hidden.shape[-1]).float()
    out = torch.bmm(hs, table.to(hidden.dtype).float().transpose(1, 2)).to(hidden.dtype)
    return out.reshape(tuple(hidden.shape[:-1]) + (table.shape[1],))


@torch.no_grad()
def init_t5(model: T5ForConditionalGeneration, seed: int) -> None:
    """A random init from ``seed`` at the Flax module's scales: ``shared``
    and ``lm_head`` N(0, f), q N(0, f (inner d_kv)^-1/2), k, v, o and the
    bias tables N(0, f inner^-1/2), wi N(0, f d_model^-1/2), wo N(0, f
    d_ff^-1/2), unit norms (f = ``initializer_factor``)."""
    cfg = model.config
    f, inner = cfg.initializer_factor, cfg.num_heads * cfg.d_kv
    std = {"shared": f, "lm_head": f, "q": f * (inner * cfg.d_kv) ** -0.5,
           "k": f * inner ** -0.5, "v": f * inner ** -0.5, "o": f * inner ** -0.5,
           "relative_attention_bias": f * inner ** -0.5, "wi": f * cfg.d_model ** -0.5,
           "wi_0": f * cfg.d_model ** -0.5, "wi_1": f * cfg.d_model ** -0.5,
           "wo": f * cfg.d_ff ** -0.5}
    gen = torch.Generator(device=model.shared.embedding.device).manual_seed(seed)
    for name, p in model.named_parameters():
        owner, leaf = name.split(".")[-2:]
        if leaf == "weight":
            p.fill_(1.0)
        else:
            p.normal_(0.0, std[owner], generator=gen)


def build_t5(size: str = "small", seed: int = 0, dtype=torch.bfloat16, device="cuda",
             pretrained: Optional[str] = None, **overrides) -> T5ForConditionalGeneration:
    """T5 at ``T5_SMALL_KWARGS`` (``size="small"``, t5-small's published
    config) or ``T5_TINY_KWARGS``, fields overridden by ``overrides``,
    initialised from ``seed`` (or, with ``pretrained``, a local HF
    directory's weights: ``pretrained.py``), on ``device`` (the card unless
    the caller passes ``"cpu"``). ``dtype`` is the activation dtype;
    parameters stay f32."""
    if pretrained is not None:
        from bayeformers_tpu_torch.pretrained import load_pretrained

        return load_pretrained(pretrained, dtype=dtype, device=device)
    if size not in ("small", "tiny"):
        raise ValueError(f"build_t5 takes size='small' or 'tiny', got {size!r}")
    kwargs = dict(T5_SMALL_KWARGS if size == "small" else T5_TINY_KWARGS)
    kwargs.update(overrides)
    device = check_device(device, "build_t5")
    model = T5ForConditionalGeneration(T5Config(**kwargs), dtype=dtype, device=device)
    init_t5(model, seed)
    model.requires_grad_(False)
    return model


def synthetic_seq2seq_batch(rng: np.random.Generator, batch: int, src_len: int, tgt_len: int,
                            vocab: int) -> dict:
    """The reference's copy-with-substitution task as numpy arrays, its
    draws in its order (``bayeformers_tpu/models/t5.py:121-135``): the
    target is the source's first ``tgt_len`` ids through a fixed random
    permutation (ids 0 and 1 reserved)."""
    table = rng.permutation(vocab - 2) + 2
    src = rng.integers(2, vocab, (batch, src_len))
    tgt = table[src[:, :tgt_len] - 2]
    return {"input_ids": src.astype(np.int32),
            "attention_mask": np.ones((batch, src_len), np.int32),
            "labels": tgt.astype(np.int32)}


def seq2seq_loss(out, batch):
    """Teacher-forced token CE, sum-reduced, on the S-averaged logits
    against ``labels`` (``-100`` ignored), and the token accuracy: the
    reference's T5 loss (``tests/test_models.py:296-305``)."""
    labels = batch["labels"].long()
    logits = elbo.mc_logits_mean(out).float()
    lp = torch.log_softmax(logits, dim=-1)
    keep = labels != -100
    picked = lp.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    nll = -(picked * keep).sum()
    acc = ((logits.argmax(-1) == labels) & keep).sum() / keep.sum()
    return nll, {"acc": acc}
