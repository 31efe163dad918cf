"""LLaMA-architecture causal language models (LLaMA, Mistral, Gemma) in
plain torch.

Written for the port so that it needs no ``transformers``. The computation
is that of HF's ``FlaxLlamaForCausalLM``, ``FlaxMistralForCausalLM`` and
``FlaxGemmaForCausalLM`` as the JAX package builds them
(``bayeformers_tpu/models/llama.py``), copied from the stock Flax modules
(transformers 4.57): a token embedding in the activation dtype, pre-norm
decoder layers (RMSNorm, grouped-query causal self-attention with rotary
position embeddings, a gated MLP ``down(up(x) * act(gate(x)))``), a final
RMSNorm and an ``lm_head`` (untied at the presets; with
``tie_word_embeddings``, stock Gemma's default, the token table). Every
projection is a bias-free ``Dense``. Dropout is omitted: the port runs deterministic forwards.

The stock numerics, family by family:

- RMSNorm: ``x / sqrt(mean(x^2) + eps)`` in f32 (eps 1e-6), rounded to the
  activation dtype, then times ``weight`` (Gemma: ``1 + weight``). The stock
  product is f32 (an f32 parameter times the rounded value) and the next
  ``nn.Dense(dtype=...)`` casts it to the activation dtype; here the norm
  returns it in the activation dtype, which is the same value.
- Rotary: the stock table ``create_sinusoidal_positions`` built in numpy
  (inverse frequencies ``10000 ** (-arange(0, d, 2) / d)``: the stock code
  hard-codes 10000 and never reads ``rope_theta``), ``sin`` and ``cos`` of
  the concatenated half-frequencies, applied as ``x cos + rotate_half(x)
  sin`` in f32 and rounded to the activation dtype; its width is the head
  width (LLaMA and Mistral: ``hidden // heads``; Gemma: ``head_dim``).
- GQA: k and v repeat to the full head count after rotary (``jnp.repeat``
  on the head axis: each kv head ``heads // kv_heads`` times in a row).
- The MLP's activation: SiLU (LLaMA, Mistral), the tanh GELU (Gemma's
  ``gelu_pytorch_tanh``), each in f32 and rounded.
- Gemma scales the embedding by ``sqrt(hidden)`` in the activation dtype.
- Mistral bands its causal mask by ``sliding_window`` (key ``j`` with
  ``i - window <= j <= i``); at the families' presets the window equals
  the maximum position, so it never bites.

Attention runs ``ops/attention.py::mha(causal=True)`` (the kernels on the
card), as the JAX package's ``handle_gqa_attention`` does, except where
Mistral's window bites (``L > sliding_window``): the JAX package's handler
then declines and the stock attention runs in XLA, so the port runs
:func:`banded_attention` in plain torch (f32 scores and softmax, the mask
added as a finfo(f32).min bias, as the stock module adds it).

Parameter names follow the Flax tree (``model/embed_tokens/embedding``,
``model/layers/{i}/self_attn/q_proj/kernel``, ``model/norm/weight``,
``lm_head/kernel``), so ``name.replace('.', '/')`` of a torch parameter is
its Flax path. Every forward takes an optional ``mc`` (an S-sample tier's
state): converted ``Dense`` layers dispatch to it and each attention block
to ``mc.gqa_attention``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from bayeformers_tpu_torch.models.bert import Embed
from bayeformers_tpu_torch.nn.dense import Dense, assign_paths
from bayeformers_tpu_torch.ops import attention as ops_attention

# the JAX package's presets (bayeformers_tpu/models/llama.py:58-101)
_COMMON_BASE = dict(
    vocab_size=32000, hidden_size=768, intermediate_size=2048,
    num_hidden_layers=12, num_attention_heads=12, num_key_value_heads=4,
    max_position_embeddings=1024,
)
_COMMON_TINY = dict(
    vocab_size=1024, hidden_size=128, intermediate_size=256,
    num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
    max_position_embeddings=128,
)
FAMILY_KWARGS = {
    "llama": {"base": dict(_COMMON_BASE), "tiny": dict(_COMMON_TINY)},
    # sliding_window = max_position_embeddings: the band never bites
    "mistral": {"base": dict(_COMMON_BASE, sliding_window=1024),
                "tiny": dict(_COMMON_TINY, sliding_window=128)},
    "gemma": {"base": dict(_COMMON_BASE, head_dim=64),
              "tiny": dict(_COMMON_TINY, head_dim=32)},
}
FAMILIES = tuple(FAMILY_KWARGS)
# Published models at their widths, as ``build_llama_family(family, "base",
# **overrides)`` takes them, from each model's public ``config.json``; the
# depth is the caller's. Both keep the presets' max_position_embeddings
# (1024; published 8192 and 32768), and Gemma the presets' untied lm_head.
PUBLISHED = {
    # google/gemma-2b: 8 heads of 256 over one kv head
    "gemma-2b-w256": ("gemma", dict(
        vocab_size=256000, hidden_size=2048, intermediate_size=16384,
        num_attention_heads=8, num_key_value_heads=1, head_dim=256, rms_norm_eps=1e-6)),
    # mistralai/Mistral-7B-v0.1: 32 heads of 128 over 8 kv heads; its
    # 4096-key window never bites within 1024 positions
    "mistral-7b-w128": ("mistral", dict(
        vocab_size=32000, hidden_size=4096, intermediate_size=14336,
        num_attention_heads=32, num_key_value_heads=8, rms_norm_eps=1e-5,
        sliding_window=4096)),
}
ACTIVATIONS = {"llama": "silu", "mistral": "silu", "gemma": "gelu_pytorch_tanh"}


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """A family's configuration: the stock config's fields that the
    computation reads, with their stock defaults."""

    family: str
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_hidden_layers: int
    num_attention_heads: int
    num_key_value_heads: int
    max_position_embeddings: int
    head_dim: Optional[int] = None        # Gemma's; else hidden // heads
    sliding_window: Optional[int] = None  # Mistral's
    rms_norm_eps: float = 1e-6
    initializer_range: float = 0.02
    # the head reads the token table (stock Gemma's default; the presets
    # untie it, as the JAX package's do)
    tie_word_embeddings: bool = False
    # None: the stock config's (LLaMA and Mistral: eos 2, no pad; Gemma:
    # eos 1, pad 0), set in __post_init__
    eos_token_id: Optional[int] = None
    pad_token_id: Optional[int] = None

    def __post_init__(self):
        if self.family not in FAMILY_KWARGS:
            raise ValueError(f"unknown family {self.family!r}; one of {FAMILIES}")
        if self.num_attention_heads % self.num_key_value_heads:
            raise ValueError("num_attention_heads must be a multiple of "
                             "num_key_value_heads")
        gemma = self.family == "gemma"
        if self.eos_token_id is None:
            object.__setattr__(self, "eos_token_id", 1 if gemma else 2)
        if self.pad_token_id is None and gemma:
            object.__setattr__(self, "pad_token_id", 0)

    @property
    def attn_head_dim(self) -> int:
        """The attention's head width (and the rotary table's)."""
        if self.family == "gemma" and self.head_dim is not None:
            return self.head_dim
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def from_dict(cls, family: str, d: dict) -> "LlamaConfig":
        """The fields of a stock config's ``to_dict()`` (others ignored)."""
        names = {f.name for f in dataclasses.fields(cls)} - {"family"}
        kw = {k: d[k] for k in names if d.get(k) is not None}
        if family != "gemma":
            kw.pop("head_dim", None)
        if family != "mistral":
            kw.pop("sliding_window", None)
        return cls(family=family, **kw)


def llama_config(family: str, size: str = "base", **overrides) -> LlamaConfig:
    """The JAX package's ``base`` or ``tiny`` preset of ``family`` with
    config ``overrides`` (as ``build_llama_family(**config_overrides)``)."""
    if family not in FAMILY_KWARGS:
        raise ValueError(f"unknown family {family!r}; one of {FAMILIES}")
    kwargs = dict(FAMILY_KWARGS[family]["base" if size == "base" else "tiny"])
    kwargs.update(overrides)
    return LlamaConfig(family=family, **kwargs)


def sinusoidal_positions(num_pos: int, dim: int) -> torch.Tensor:
    """The stock ``create_sinusoidal_positions`` (numpy, float32 sin and
    cos of the float32 angles; its last-axis slice kept as it is)."""
    inv_freq = 1.0 / (10000 ** (np.arange(0, dim, 2)[: dim // 2] / dim))
    freqs = np.einsum("i , j -> i j", np.arange(num_pos), inv_freq).astype("float32")
    emb = np.concatenate((freqs, freqs), axis=-1)
    out = np.concatenate((np.sin(emb)[:, None, :], np.cos(emb)[:, None, :]), axis=-1)
    return torch.from_numpy(np.ascontiguousarray(out[:, :, :num_pos]))


def rotate_half(t: torch.Tensor) -> torch.Tensor:
    half = t.shape[-1] // 2
    return torch.cat((-t[..., half:], t[..., :half]), dim=-1)


class Rotary(nn.Module):
    """The stock rotary embedding over (N, L, heads, d) keys and queries."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        table = sinusoidal_positions(cfg.max_position_embeddings, cfg.attn_head_dim)
        self.register_buffer("sincos", table.to(device), persistent=False)

    def forward(self, key, query, position_ids):
        sin, cos = torch.chunk(self.sincos[position_ids], 2, dim=-1)  # (N, L, 1, d)

        def apply(t):
            return (t.float() * cos + rotate_half(t).float() * sin).to(t.dtype)

        return apply(key), apply(query)


class RMSNorm(nn.Module):
    def __init__(self, cfg: LlamaConfig, dtype, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(cfg.hidden_size, device=device))
        self.eps = cfg.rms_norm_eps
        self.offset = cfg.family == "gemma"  # Gemma's (1 + weight)
        self.dtype = dtype

    def forward(self, x):
        xf = x.float()
        y = (xf / torch.sqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + self.eps)
             ).to(self.dtype)
        w = 1.0 + self.weight if self.offset else self.weight
        return (w * y.float()).to(self.dtype)


def banded_attention(q, k, v, bias, n_heads: int, window: int) -> torch.Tensor:
    """Causal attention over (N, L, H) q/k/v banded to keys ``i - window <=
    j <= i`` (the stock Mistral mask), in plain torch: f32 scores scaled
    after the product, the combined mask added as a finfo(f32).min bias,
    the softmax in f32, P in the input dtype for P v with f32
    accumulation."""
    N, L, H = q.shape
    d = H // n_heads

    def heads(t):
        return t.reshape(N, L, n_heads, d).permute(0, 2, 1, 3).float()

    s = torch.matmul(heads(q), heads(k).transpose(-1, -2)) * (1.0 / math.sqrt(d))
    rows = torch.arange(L, device=q.device)[:, None]
    cols = torch.arange(L, device=q.device)[None, :]
    band = (cols <= rows) & (cols >= rows - window)
    full = torch.where(band[None], bias[:, None, :].float(),
                       torch.full((), ops_attention.NEG_BIG, device=q.device))
    p = torch.softmax(s + full[:, None], dim=-1)
    out = torch.matmul(p.to(q.dtype).float(), heads(v))
    return out.permute(0, 2, 1, 3).reshape(N, L, H).to(q.dtype)


def gqa_attention(mod, hidden, bias, position_ids, dense, plain: bool = False, cache=None,
                  n_heads=None, n_kv=None):
    """The LLaMA-architecture attention block (the JAX package's
    ``handle_gqa_attention``, ``nn/fused.py:778-873``): q/k/v through
    ``dense``, rotary, k/v repeated to the full head count, ``mha(causal=
    True)`` (or :func:`banded_attention` where Mistral's window bites) and
    ``o_proj``. With a decode's ``cache`` (K, V, start), the rotated k and v
    (the shared kv heads) go into it and q attends to its keys in plain
    torch, ``bias`` being ``cache_bias``'s (Mistral's band in it).
    ``n_heads`` / ``n_kv`` (default the module's) are a tensor-parallel
    rank's heads."""
    N, L = hidden.shape[:2]
    nh, nkv, d = n_heads or mod.n_heads, n_kv or mod.n_kv_heads, mod.head_dim
    qh = dense(mod.q_proj, hidden).reshape(N, L, nh, d)
    kh = dense(mod.k_proj, hidden).reshape(N, L, nkv, d)
    vh = dense(mod.v_proj, hidden).reshape(N, L, nkv, d)
    kh, qh = mod.rotary_emb(kh, qh, position_ids)
    if cache is not None:
        kh, vh = ops_attention.cache_kv(cache, kh, vh)
    Lk = kh.shape[1]
    if nh > nkv:
        kh = torch.repeat_interleave(kh, nh // nkv, dim=2)
        vh = torch.repeat_interleave(vh, nh // nkv, dim=2)
    q = qh.reshape(N, L, nh * d)
    k, v = (t.reshape(N, Lk, nh * d) for t in (kh, vh))
    if cache is not None:
        ctx = ops_attention.plain_attention(q, k, v, bias, nh)
    else:
        q, k, v = (t.contiguous() for t in (q, k, v))
        if mod.sliding_window and L > mod.sliding_window:
            ctx = banded_attention(q, k, v, bias, nh, mod.sliding_window)
        else:
            ctx = ops_attention.mha(q, k, v, bias, nh, causal=True, plain=plain)
    return dense(mod.o_proj, ctx)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        d = cfg.attn_head_dim
        nh, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
        e = cfg.hidden_size
        self.q_proj = Dense(e, nh * d, use_bias=False, device=device)
        self.k_proj = Dense(e, nkv * d, use_bias=False, device=device)
        self.v_proj = Dense(e, nkv * d, use_bias=False, device=device)
        self.o_proj = Dense(nh * d, e, use_bias=False, device=device)
        self.rotary_emb = Rotary(cfg, device)
        self.n_heads, self.n_kv_heads, self.head_dim = nh, nkv, d
        self.sliding_window = cfg.sliding_window

    def forward(self, hidden, bias, position_ids, mc=None, cache=None):
        if mc is not None:
            return mc.gqa_attention(self, hidden, bias, position_ids)
        return gqa_attention(self, hidden, bias, position_ids, lambda m, x: m(x), cache=cache)


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        e, inner = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = Dense(e, inner, use_bias=False, device=device)
        self.up_proj = Dense(e, inner, use_bias=False, device=device)
        self.down_proj = Dense(inner, e, use_bias=False, device=device)
        self.act = ACTIVATIONS[cfg.family]

    def forward(self, hidden, mc=None):
        up = self.up_proj(hidden, mc)
        gate = self.gate_proj(hidden, mc)
        if self.act == "silu":
            gate = F.silu(gate.float()).to(gate.dtype)
        else:
            gate = F.gelu(gate.float(), approximate="tanh").to(gate.dtype)
        return self.down_proj(up * gate, mc)


class LlamaDecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, dtype, device=None):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg, dtype, device)
        self.self_attn = LlamaAttention(cfg, device)
        self.post_attention_layernorm = RMSNorm(cfg, dtype, device)
        self.mlp = LlamaMLP(cfg, device)

    def forward(self, hidden, bias, position_ids, mc=None, cache=None):
        hidden = hidden + self.self_attn(self.input_layernorm(hidden), bias, position_ids,
                                         mc, cache)
        return hidden + self.mlp(self.post_attention_layernorm(hidden), mc)


class LlamaModule(nn.Module):
    def __init__(self, cfg: LlamaConfig, dtype, device=None):
        super().__init__()
        self.embed_tokens = Embed(cfg.vocab_size, cfg.hidden_size, device=device)
        self.layers = nn.ModuleList(LlamaDecoderLayer(cfg, dtype, device)
                                    for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg, dtype, device)
        self.dtype = dtype
        self.embed_scale = (math.sqrt(cfg.hidden_size) if cfg.family == "gemma"
                            else None)

    def embed(self, input_ids, mc=None):
        hidden = self.embed_tokens(input_ids, mc).to(self.dtype)
        if self.embed_scale is not None:
            # Gemma: sqrt(hidden) as a scalar of the activation dtype
            hidden = hidden * torch.tensor(self.embed_scale, dtype=self.dtype,
                                           device=hidden.device)
        return hidden

    def forward(self, input_ids, position_ids, bias, mc=None, cache=None, start=0):
        """``cache``: a decode's per-layer (K, V), written from cache
        position ``start`` on (:meth:`LlamaForCausalLM.decode_step`)."""
        hidden = self.embed(input_ids, mc)
        for i, layer in enumerate(self.layers):
            hidden = layer(hidden, bias, position_ids, mc,
                           None if cache is None else (*cache[i], start))
        return self.norm(hidden)


class LlamaForCausalLM(nn.Module):
    """``forward(input_ids, attention_mask=None, token_type_ids=None,
    mc=None, position_ids=None)`` -> next-token logits (N, L, vocab) in the
    activation dtype. Positions default to ``arange(L)`` (the JAX package's
    ``apply_fn`` default); ``token_type_ids`` is ignored, as that
    ``apply_fn`` ignores it."""

    def __init__(self, cfg: LlamaConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.config = cfg
        self.dtype = dtype
        self.model = LlamaModule(cfg, dtype, device)
        if not cfg.tie_word_embeddings:
            self.lm_head = Dense(cfg.hidden_size, cfg.vocab_size, use_bias=False,
                                 device=device)
        assign_paths(self)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None, mc=None,
                position_ids=None):
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        L = input_ids.shape[-1]
        if L > self.config.max_position_embeddings:
            raise ValueError(f"sequence length {L} exceeds max_position_embeddings="
                             f"{self.config.max_position_embeddings}")
        if position_ids is None:
            position_ids = torch.arange(L, device=input_ids.device).expand_as(input_ids)
        bias = ops_attention.mask_to_bias(attention_mask)
        hidden = self.model(input_ids, position_ids, bias, mc)
        return self.head(hidden, mc)

    def head(self, hidden, mc=None):
        """The ``lm_head``, or with ``tie_word_embeddings`` the token table's
        transpose in the activation dtype (stock Flax's tied ``Dense``, which
        no tier converts: it holds no leaf of its own)."""
        if self.config.tie_word_embeddings:
            table = self.model.embed_tokens.embedding
            return torch.matmul(hidden, table.to(hidden.dtype).t())
        return self.lm_head(hidden, mc)

    # -- decoding with a KV cache ---------------------------------------------
    generation = "causal"

    def init_cache(self, batch: int, max_len: int) -> list:
        """Per layer, zero K (after rotary) and V of (batch, max_len,
        kv_heads, head_dim): GQA caches the shared kv heads only."""
        cfg = self.config
        shape = (batch, max_len, cfg.num_key_value_heads, cfg.attn_head_dim)
        dev = self.model.embed_tokens.embedding.device
        return [(torch.zeros(shape, dtype=self.dtype, device=dev),
                 torch.zeros(shape, dtype=self.dtype, device=dev)) for _ in self.model.layers]

    def decode_step(self, ids, position_ids, key_mask, start: int, cache: list):
        """Ids (B, l) at cache positions ``[start, start + l)``, rotary at
        ``position_ids``: the layers' forward with their K and V written
        into ``cache``, each query attending to the real cached keys up to
        itself (``key_mask`` (B, max_len)); Gemma's embedding scale applies;
        Mistral's band is kept (at the presets' lengths it never binds).
        Returns the logits (B, l, vocab)."""
        bias = ops_attention.cache_bias(key_mask, start, ids.shape[1],
                                        self.config.sliding_window)
        return self.head(self.model(ids, position_ids, bias, cache=cache, start=start))


@torch.no_grad()
def init_weights(model: LlamaForCausalLM, seed: int) -> None:
    """The stock init from a seed: N(0, initializer_range) kernels and
    embedding table (Mistral's attention projections: Flax's default
    ``lecun_normal``, a normal of variance 1 / fan_in truncated at two
    standard deviations), unit RMSNorm weights."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    cfg = model.config
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "weight":
            p.fill_(1.0)
        elif cfg.family == "mistral" and ".self_attn." in name:
            # lecun_normal: truncated normal, std sqrt(1 / fan_in) / .8796
            std = math.sqrt(1.0 / p.shape[0]) / 0.87962566103423978
            nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std, generator=gen)
        else:
            p.normal_(0.0, cfg.initializer_range, generator=gen)


def build_llama_family(family: str, size: str = "base", seed: int = 0,
                       dtype=torch.float32, device="cuda",
                       pretrained: Optional[str] = None, **overrides
                       ) -> LlamaForCausalLM:
    """A LLaMA, Mistral or Gemma causal LM at the JAX package's ``base`` or
    ``tiny`` preset (:data:`FAMILY_KWARGS`), with config ``overrides``,
    initialised from ``seed`` (or, with ``pretrained``, a local HF
    directory's config and weights: ``pretrained.py``). ``dtype`` is the
    activation dtype (f32 by default, as in the JAX package); parameters
    stay f32."""
    if pretrained is not None:
        from bayeformers_tpu_torch.pretrained import load_causal_lm

        return load_causal_lm(pretrained, family, dtype=dtype, device=device)
    cfg = llama_config(family, size, **overrides)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_llama_family(device='cuda'): no CUDA device")
    model = LlamaForCausalLM(cfg, dtype=dtype, device=device)
    init_weights(model, seed)
    model.requires_grad_(False)
    return model
