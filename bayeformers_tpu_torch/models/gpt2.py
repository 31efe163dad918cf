"""A plain-torch GPT-2 causal language model.

Written for the port so that it needs no ``transformers``. The computation
is that of HF's ``FlaxGPT2LMHeadModel`` as the JAX package builds it
(``bayeformers_tpu/models/gpt2.py``): token + position embeddings, pre-LN
blocks (LayerNorm eps 1e-5, causal self-attention through one packed
``c_attn`` projection, an MLP with the tanh GELU ``gelu_new``), a final
LayerNorm and an LM head tied to the token embedding. Dropout is omitted:
the port runs deterministic forwards.

Parameter names follow the Flax tree (``transformer/wte/embedding``,
``transformer/h/{i}/attn/c_attn/kernel``, ..., ``transformer/ln_f/scale``):
the projections are ``Conv1D`` (``nn/dense.py``), stored (out, in) as
``FlaxConv1D`` stores them, so ``name.replace('.', '/')`` of a torch
parameter is its Flax path. The tied head has no leaf of its own: it is a
plain ``torch.matmul`` on ``wte``, as the JAX package leaves it to XLA,
outside any Pallas kernel, and ``to_bayesian`` leaves it (and the
embeddings and LayerNorms) frequentist. The embeddings use the port's
fixed-order ``Embed`` backward, so the tied ``wte`` takes the lookup's
gradient plus the head's.

Every forward takes an optional ``mc`` (an S-sample tier's state): when
given, converted ``Conv1D`` layers dispatch to it and each attention block
to ``mc.gpt2_attention``; every tier's attention runs ``mha(causal=True)``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from bayeformers_tpu_torch.models.bert import Embed, LayerNorm
from bayeformers_tpu_torch.nn.dense import Conv1D, assign_paths
from bayeformers_tpu_torch.ops import attention as ops_attention

GPT2_BASE_KWARGS = dict(
    vocab_size=50257, n_embd=768, n_layer=12, n_head=12, n_positions=1024,
)
GPT2_TINY_KWARGS = dict(
    vocab_size=1024, n_embd=128, n_layer=2, n_head=2, n_positions=128,
)


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int
    n_embd: int
    n_layer: int
    n_head: int
    n_positions: int
    n_inner: Optional[int] = None  # 4 * n_embd
    layer_norm_epsilon: float = 1e-5
    initializer_range: float = 0.02
    eos_token_id: Optional[int] = 50256
    pad_token_id: Optional[int] = None


def causal_attention(mod, hidden, bias, dense, plain: bool = False, cache=None,
                     n_heads=None):
    """GPT-2's attention block (the JAX package's ``handle_gpt2_attention``,
    ``nn/fused.py:771-775``): the packed ``c_attn`` through ``dense``, a
    three-way split, ``mha(causal=True)`` and ``c_proj``. The split's
    q/k/v are column slices of the packed (.., 3H) output: each is copied
    contiguous, since the attention kernels read (N, L, H) rows. With a
    decode's ``cache`` (K, V, start), k and v go into it and q attends to
    its keys in plain torch, ``bias`` being ``ops_attention.cache_bias``'s.
    ``n_heads`` (default the module's) is the heads of a tensor-parallel
    rank's block of c_attn."""
    n_heads = n_heads or mod.n_heads
    q, k, v = torch.chunk(dense(mod.c_attn, hidden), 3, dim=-1)
    if cache is not None:
        ctx = ops_attention.plain_attention(q, *ops_attention.cache_kv(cache, k, v), bias,
                                            n_heads)
    else:
        q, k, v = (t.contiguous() for t in (q, k, v))
        ctx = ops_attention.mha(q, k, v, bias, n_heads, causal=True, plain=plain)
    return dense(mod.c_proj, ctx)


class GPT2Attention(nn.Module):
    def __init__(self, cfg: GPT2Config, device=None):
        super().__init__()
        e = cfg.n_embd
        self.c_attn = Conv1D(e, 3 * e, device=device)
        self.c_proj = Conv1D(e, e, device=device)
        self.n_heads = cfg.n_head

    def forward(self, hidden, bias, mc=None, cache=None):
        if mc is not None:
            return mc.gpt2_attention(self, hidden, bias)
        return causal_attention(self, hidden, bias, lambda m, x: m(x), cache=cache)


class GPT2MLP(nn.Module):
    def __init__(self, cfg: GPT2Config, device=None):
        super().__init__()
        inner = cfg.n_inner or 4 * cfg.n_embd
        self.c_fc = Conv1D(cfg.n_embd, inner, device=device)
        self.c_proj = Conv1D(inner, cfg.n_embd, device=device)

    def forward(self, hidden, mc=None):
        y = self.c_fc(hidden, mc)
        y = F.gelu(y.float(), approximate="tanh").to(y.dtype)  # gelu_new
        return self.c_proj(y, mc)


class GPT2Block(nn.Module):
    def __init__(self, cfg: GPT2Config, device=None):
        super().__init__()
        eps = cfg.layer_norm_epsilon
        self.ln_1 = LayerNorm(cfg.n_embd, eps, device=device)
        self.attn = GPT2Attention(cfg, device)
        self.ln_2 = LayerNorm(cfg.n_embd, eps, device=device)
        self.mlp = GPT2MLP(cfg, device)

    def forward(self, hidden, bias, mc=None, cache=None):
        hidden = self.attn(self.ln_1(hidden), bias, mc, cache) + hidden
        return hidden + self.mlp(self.ln_2(hidden), mc)


class GPT2Module(nn.Module):
    def __init__(self, cfg: GPT2Config, dtype, device=None):
        super().__init__()
        self.wte = Embed(cfg.vocab_size, cfg.n_embd, device=device)
        self.wpe = Embed(cfg.n_positions, cfg.n_embd, device=device)
        self.h = nn.ModuleList(GPT2Block(cfg, device) for _ in range(cfg.n_layer))
        self.ln_f = LayerNorm(cfg.n_embd, cfg.layer_norm_epsilon, device=device)
        self.dtype = dtype

    def forward(self, input_ids, position_ids, bias, mc=None, cache=None, start=0):
        """``cache``: a decode's per-block (K, V), written from cache
        position ``start`` on (:meth:`GPT2LMHeadModel.decode_step`)."""
        # as HF's FlaxGPT2Module: both lookups in the activation dtype, summed in it
        hidden = (self.wte(input_ids, mc).to(self.dtype)
                  + self.wpe(position_ids, mc).to(self.dtype))
        for i, block in enumerate(self.h):
            hidden = block(hidden, bias, mc, None if cache is None else (*cache[i], start))
        return self.ln_f(hidden)


class GPT2LMHeadModel(nn.Module):
    """``forward(input_ids, attention_mask=None, token_type_ids=None,
    mc=None, position_ids=None)`` -> next-token logits (N, L, vocab) in the
    activation dtype. Positions default to ``arange(L)`` (the JAX package's
    ``apply_fn`` default); GPT-2 has no token types, so ``token_type_ids``
    is ignored, as that ``apply_fn`` ignores it."""

    def __init__(self, cfg: GPT2Config, dtype=torch.float32, device=None):
        super().__init__()
        self.config = cfg
        self.dtype = dtype
        self.transformer = GPT2Module(cfg, dtype, device)
        assign_paths(self)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None, mc=None,
                position_ids=None):
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        if position_ids is None:
            L = input_ids.shape[-1]
            position_ids = torch.arange(L, device=input_ids.device).expand_as(input_ids)
        bias = ops_attention.mask_to_bias(attention_mask)
        hidden = self.transformer(input_ids, position_ids, bias, mc)
        return self.head(hidden)

    def head(self, hidden):
        """The head tied to wte, in the activation dtype (HF's lm_head
        Dense)."""
        wte = self.transformer.wte.embedding
        return torch.matmul(hidden, wte.to(hidden.dtype).t())

    # -- decoding with a KV cache ---------------------------------------------
    generation = "causal"

    def init_cache(self, batch: int, max_len: int) -> list:
        """Per block, zero K and V of (batch, max_len, n_embd)."""
        t = self.transformer
        z = lambda: torch.zeros(batch, max_len, self.config.n_embd,  # noqa: E731
                                dtype=self.dtype, device=t.wte.embedding.device)
        return [(z(), z()) for _ in t.h]

    def decode_step(self, ids, position_ids, key_mask, start: int, cache: list):
        """Ids (B, l) at cache positions ``[start, start + l)`` with their
        position ids: the blocks' forward with their K and V written into
        ``cache``, each query attending to the real cached keys up to itself
        (``key_mask`` (B, max_len)); returns the logits (B, l, vocab). A
        prompt is one call from ``start=0``, each new token one call of
        l = 1."""
        bias = ops_attention.cache_bias(key_mask, start, ids.shape[1])
        return self.head(self.transformer(ids, position_ids, bias, cache=cache, start=start))


@torch.no_grad()
def init_weights(model: GPT2LMHeadModel, seed: int) -> None:
    """HF's GPT-2 init from a seed: N(0, initializer_range) kernels and
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


def build_gpt2(size: str = "base", seed: int = 0, dtype=torch.float32,
               device="cuda", pretrained: Optional[str] = None,
               **overrides) -> GPT2LMHeadModel:
    """GPT-2 LM at ``GPT2_BASE_KWARGS`` (``size="base"``) or
    ``GPT2_TINY_KWARGS`` (``"tiny"``), with config ``overrides``, initialised
    from ``seed`` (or, with ``pretrained``, a local HF directory's config
    and weights: ``pretrained.py``). ``dtype`` is the activation dtype (f32
    by default, as in the JAX package); parameters stay f32."""
    if pretrained is not None:
        from bayeformers_tpu_torch.pretrained import load_causal_lm

        return load_causal_lm(pretrained, "gpt2", dtype=dtype, device=device)
    kwargs = dict(GPT2_BASE_KWARGS if size == "base" else GPT2_TINY_KWARGS)
    kwargs.update(overrides)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_gpt2(device='cuda'): no CUDA device")
    model = GPT2LMHeadModel(GPT2Config(**kwargs), dtype=dtype, device=device)
    init_weights(model, seed)
    model.requires_grad_(False)
    return model


def synthetic_lm_batch(rng: np.random.Generator, batch: int, seq: int, vocab: int,
                       order_frac: float = 0.85) -> dict[str, np.ndarray]:
    """The JAX package's synthetic Markov language (``models/gpt2.py:103-
    126``), with its numpy draws in its order, so one seed gives the same
    ids in both packages: a fixed random successor table followed with
    probability ``order_frac`` a step, uniform otherwise. The Bayes-optimal
    next-token accuracy is ``order_frac + (1 - order_frac) / vocab``."""
    succ = rng.permutation(vocab)
    ids = np.empty((batch, seq), np.int64)
    ids[:, 0] = rng.integers(0, vocab, batch)
    follow = rng.random((batch, seq - 1)) < order_frac
    noise = rng.integers(0, vocab, (batch, seq - 1))
    for t in range(1, seq):
        ids[:, t] = np.where(follow[:, t - 1], succ[ids[:, t - 1]], noise[:, t - 1])
    return {"input_ids": ids, "attention_mask": np.ones((batch, seq), np.int32)}
