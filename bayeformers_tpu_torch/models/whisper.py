"""A plain-torch Whisper speech-to-text model, the counterpart of HF's
``FlaxWhisperForConditionalGeneration`` as the JAX package builds it
(``bayeformers_tpu/models/whisper.py``).

The computation is the Flax module's (transformers 4.57): the log-mel
features (B, mels, 2 T) transposed to channels-last, two 1-D ``Conv`` stems
(``nn/conv.py``; kernel 3, padding 1, the second with stride 2, each
followed by the exact GELU), the sinusoidal encoder position table added
under ``stop_gradient`` (here ``detach``), pre-LN encoder layers, the
encoder's final LayerNorm; the decoder's token and learned position
embeddings, pre-LN layers with causal self-attention and a cross-attention
over the encoder, its final LayerNorm, and ``proj_out`` tied to the token
table (an untied ``lm_head`` with ``tie_word_embeddings=False``). In every
attention q is scaled by ``head_dim ** -0.5`` after its projection and
``k_proj`` has no bias; LayerNorm eps is 1e-5.

Parameter names are the Flax paths (``model/encoder/conv1/kernel``,
``model/decoder/layers/0/encoder_attn/k_proj/kernel``, ...). The default
rules convert every attention projection and MLP ``fc1``/``fc2`` of both
towers; ``CONV_RULE`` converts the two stems, ``EMBEDDING_RULE`` the three
tables. The reference's fused tier does not intercept Whisper's attention:
each Dense goes to the tier and the attention stays plain torch (f32
scores and softmax, probabilities in the activation dtype). The encoder's
positions are one lookup shared by every example (``Embed.lookup_shared``),
as the Flax module's ``embed_positions(arange(T))`` is.

The reference builds full-size Whisper only from a checkpoint; here any
width is built from a seed through ``config_overrides``
(:data:`WHISPER_BASE_KWARGS`: openai/whisper-base's published widths), or
from a local HF directory (``pretrained=``). Activations are in ``dtype``;
parameters stay f32. Dropout is omitted.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from bayeformers_tpu_torch import elbo
from bayeformers_tpu_torch.models.bert import Embed, LayerNorm, activation, check_device
from bayeformers_tpu_torch.models.t5 import tied_logits
from bayeformers_tpu_torch.nn.conv import Conv
from bayeformers_tpu_torch.nn.dense import Dense, assign_paths
from bayeformers_tpu_torch.ops.attention import mask_to_bias, plain_attention

WHISPER_TINY_KWARGS = dict(
    vocab_size=128, num_mel_bins=16, d_model=64,
    encoder_layers=2, encoder_attention_heads=2, encoder_ffn_dim=128,
    decoder_layers=2, decoder_attention_heads=2, decoder_ffn_dim=128,
    max_source_positions=24, max_target_positions=16,
)
# openai/whisper-base's published config.json, as config overrides
WHISPER_BASE_KWARGS = dict(
    vocab_size=51865, num_mel_bins=80, d_model=512,
    encoder_layers=6, encoder_attention_heads=8, encoder_ffn_dim=2048,
    decoder_layers=6, decoder_attention_heads=8, decoder_ffn_dim=2048,
    max_source_positions=1500, max_target_positions=448,
)


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    """HF's ``WhisperConfig`` fields that the model reads, with its
    defaults."""

    vocab_size: int = 51865
    num_mel_bins: int = 80
    d_model: int = 384
    encoder_layers: int = 4
    encoder_attention_heads: int = 6
    encoder_ffn_dim: int = 1536
    decoder_layers: int = 4
    decoder_attention_heads: int = 6
    decoder_ffn_dim: int = 1536
    max_source_positions: int = 1500
    max_target_positions: int = 448
    activation_function: str = "gelu"
    init_std: float = 0.02
    tie_word_embeddings: bool = True

    @classmethod
    def from_hf(cls, d: dict) -> "WhisperConfig":
        """The fields of an HF ``WhisperConfig.to_dict()`` or
        ``config.json``."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


def sinusoids(length: int, channels: int) -> torch.Tensor:
    """Flax Whisper's ``sinusoidal_embedding_init``: sin then cos of
    ``t exp(-log(10000) / (channels / 2 - 1) i)``, in f32."""
    inc = math.log(10000) / (channels // 2 - 1)
    inv = torch.exp(-inc * torch.arange(channels // 2, dtype=torch.float32))
    t = torch.arange(length, dtype=torch.float32)[:, None] * inv[None, :]
    return torch.cat([torch.sin(t), torch.cos(t)], dim=1)


class WhisperAttention(nn.Module):
    def __init__(self, d_model: int, n_heads: int, causal: bool, device=None):
        super().__init__()
        self.q_proj = Dense(d_model, d_model, device=device)
        self.k_proj = Dense(d_model, d_model, use_bias=False, device=device)
        self.v_proj = Dense(d_model, d_model, device=device)
        self.out_proj = Dense(d_model, d_model, device=device)
        self.n_heads = n_heads
        self.causal = causal

    def forward(self, hidden, kv, mc=None):
        bias = None
        if self.causal:
            keep = torch.ones(hidden.shape[1], kv.shape[1], dtype=torch.bool,
                              device=hidden.device).tril()
            bias = mask_to_bias(keep)
        ctx = plain_attention(self.q_proj(hidden, mc), self.k_proj(kv, mc),
                              self.v_proj(kv, mc), bias, self.n_heads)
        return self.out_proj(ctx, mc)


class WhisperEncoderLayer(nn.Module):
    def __init__(self, cfg: WhisperConfig, dtype, device=None):
        super().__init__()
        d = cfg.d_model
        self.self_attn = WhisperAttention(d, cfg.encoder_attention_heads, False, device)
        self.self_attn_layer_norm = LayerNorm(d, 1e-5, device=device)
        self.fc1 = Dense(d, cfg.encoder_ffn_dim, device=device)
        self.fc2 = Dense(cfg.encoder_ffn_dim, d, device=device)
        self.final_layer_norm = LayerNorm(d, 1e-5, device=device)
        self.act = cfg.activation_function

    def forward(self, hidden, mc=None):
        h = self.self_attn_layer_norm(hidden)
        hidden = hidden + self.self_attn(h, h, mc)
        h = activation(self.fc1(self.final_layer_norm(hidden), mc), self.act)
        return hidden + self.fc2(h, mc)


class WhisperDecoderLayer(nn.Module):
    def __init__(self, cfg: WhisperConfig, dtype, device=None):
        super().__init__()
        d, nh = cfg.d_model, cfg.decoder_attention_heads
        self.self_attn = WhisperAttention(d, nh, True, device)
        self.self_attn_layer_norm = LayerNorm(d, 1e-5, device=device)
        self.encoder_attn = WhisperAttention(d, nh, False, device)
        self.encoder_attn_layer_norm = LayerNorm(d, 1e-5, device=device)
        self.fc1 = Dense(d, cfg.decoder_ffn_dim, device=device)
        self.fc2 = Dense(cfg.decoder_ffn_dim, d, device=device)
        self.final_layer_norm = LayerNorm(d, 1e-5, device=device)
        self.act = cfg.activation_function

    def forward(self, hidden, enc, mc=None):
        h = self.self_attn_layer_norm(hidden)
        hidden = hidden + self.self_attn(h, h, mc)
        hidden = hidden + self.encoder_attn(self.encoder_attn_layer_norm(hidden), enc, mc)
        h = activation(self.fc1(self.final_layer_norm(hidden), mc), self.act)
        return hidden + self.fc2(h, mc)


class WhisperEncoder(nn.Module):
    def __init__(self, cfg: WhisperConfig, dtype, device=None):
        super().__init__()
        d = cfg.d_model
        self.conv1 = Conv(cfg.num_mel_bins, d, (3,), padding=1, device=device)
        self.conv2 = Conv(d, d, (3,), strides=(2,), padding=1, device=device)
        self.embed_positions = Embed(cfg.max_source_positions, d, device=device)
        self.layers = nn.ModuleList(WhisperEncoderLayer(cfg, dtype, device)
                                    for _ in range(cfg.encoder_layers))
        self.layer_norm = LayerNorm(d, 1e-5, device=device)
        self.n_pos = cfg.max_source_positions
        self.dtype = dtype

    def forward(self, features, mc=None):
        x = features.to(self.dtype).transpose(1, 2)  # (N, 2 T, mels), channels-last
        x = F.gelu(self.conv1(x, mc).float()).to(self.dtype)
        x = F.gelu(self.conv2(x, mc).float()).to(self.dtype)
        ids = torch.arange(self.n_pos, device=x.device)
        pos = self.embed_positions.lookup_shared(ids, mc).detach().to(self.dtype)  # (G, T, d)
        G = pos.shape[0]
        hidden = (x.reshape((G, -1) + tuple(x.shape[1:])) + pos[:, None]).reshape(x.shape)
        for layer in self.layers:
            hidden = layer(hidden, mc)
        return self.layer_norm(hidden)


class WhisperDecoder(nn.Module):
    def __init__(self, cfg: WhisperConfig, dtype, device=None):
        super().__init__()
        d = cfg.d_model
        self.embed_tokens = Embed(cfg.vocab_size, d, device=device)
        self.embed_positions = Embed(cfg.max_target_positions, d, device=device)
        self.layers = nn.ModuleList(WhisperDecoderLayer(cfg, dtype, device)
                                    for _ in range(cfg.decoder_layers))
        self.layer_norm = LayerNorm(d, 1e-5, device=device)
        self.dtype = dtype

    def forward(self, ids, enc, mc=None):
        positions = torch.arange(ids.shape[1], device=ids.device).expand_as(ids)
        hidden = (self.embed_tokens(ids, mc).to(self.dtype)
                  + self.embed_positions(positions, mc).to(self.dtype))
        for layer in self.layers:
            hidden = layer(hidden, enc, mc)
        return self.layer_norm(hidden)


class WhisperModule(nn.Module):
    def __init__(self, cfg: WhisperConfig, dtype, device=None):
        super().__init__()
        self.encoder = WhisperEncoder(cfg, dtype, device)
        self.decoder = WhisperDecoder(cfg, dtype, device)


class WhisperForConditionalGeneration(nn.Module):
    """``forward(input_features, decoder_input_ids, mc=None)``: log-mel
    features (N, num_mel_bins, 2 max_source_positions) and decoder ids
    (N, T <= max_target_positions) -> logits (N, T, vocab) in the activation
    dtype (the reference's ``apply_fn``: all-ones decoder mask, positions
    ``arange(T)``)."""

    family = "whisper"
    uses_token_type_ids = False
    input_keys = ("input_features", "decoder_input_ids")

    def __init__(self, cfg: WhisperConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.config = cfg
        self.dtype = dtype
        self.model = WhisperModule(cfg, dtype, device)
        if not cfg.tie_word_embeddings:
            self.lm_head = Dense(cfg.d_model, cfg.vocab_size, use_bias=False, device=device)
        assign_paths(self)

    def forward(self, input_features, decoder_input_ids, mc=None):
        cfg = self.config
        want = (cfg.num_mel_bins, 2 * cfg.max_source_positions)
        if tuple(input_features.shape[1:]) != want:
            raise ValueError(f"input_features must be (N, {want[0]}, {want[1]}), got "
                             f"{tuple(input_features.shape)}")
        if decoder_input_ids.shape[1] > cfg.max_target_positions:
            raise ValueError(f"{decoder_input_ids.shape[1]} decoder ids exceed "
                             f"max_target_positions={cfg.max_target_positions}")
        enc = self.model.encoder(input_features, mc)
        hidden = self.model.decoder(decoder_input_ids, enc, mc)
        if not cfg.tie_word_embeddings:
            return self.lm_head(hidden, mc)
        table = self.model.decoder.embed_tokens
        return tied_logits(hidden, table.embedding if mc is None else mc.tied_table(table))


@torch.no_grad()
def init_whisper(model: WhisperForConditionalGeneration, seed: int) -> None:
    """A random init from ``seed``: N(0, init_std) kernels and tables (HF's
    ``kernel_init`` and Flax's default ``nn.Embed`` init differ in scale;
    both here take ``init_std``), the sinusoid encoder table, zero biases,
    unit LayerNorm scales."""
    cfg = model.config
    gen = torch.Generator(device=model.model.encoder.conv1.kernel.device).manual_seed(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if name == "model.encoder.embed_positions.embedding":
            p.copy_(sinusoids(*p.shape))
        elif leaf in ("kernel", "embedding"):
            p.normal_(0.0, cfg.init_std, generator=gen)
        elif leaf == "scale":
            p.fill_(1.0)
        else:
            p.zero_()


def build_whisper(size: str = "tiny", seed: int = 0, dtype=torch.bfloat16, device="cuda",
                  pretrained: Optional[str] = None, **overrides
                  ) -> WhisperForConditionalGeneration:
    """Whisper at ``WHISPER_TINY_KWARGS`` with ``overrides`` over it (the
    published widths, :data:`WHISPER_BASE_KWARGS`, are such overrides; the
    reference's offline build takes ``size="tiny"`` only), initialised from
    ``seed``, or from a local HF directory with ``pretrained``, on
    ``device`` (the card unless the caller passes ``"cpu"``). ``dtype`` is
    the activation dtype; parameters stay f32."""
    if pretrained is not None:
        from bayeformers_tpu_torch.pretrained import load_pretrained

        return load_pretrained(pretrained, dtype=dtype, device=device)
    if size != "tiny":
        raise ValueError("the offline build takes size='tiny' (with config overrides for "
                         "other widths, e.g. WHISPER_BASE_KWARGS)")
    cfg = WhisperConfig(**dict(WHISPER_TINY_KWARGS, **overrides))
    device = check_device(device, "build_whisper")
    model = WhisperForConditionalGeneration(cfg, dtype=dtype, device=device)
    init_whisper(model, seed)
    model.requires_grad_(False)
    return model


def synthetic_speech_batch(rng: np.random.Generator, batch: int, config,
                           n_classes: int = 4) -> dict:
    """Paired features and transcripts as numpy arrays, the reference's
    draws in its order (``bayeformers_tpu/models/whisper.py:94-122``): class
    k plays a fixed random mel pattern plus noise and reads a fixed id
    sequence starting with id 1."""
    t_src = 2 * config.max_source_positions
    t_dec = config.max_target_positions
    labels = rng.integers(0, n_classes, batch)
    mel = rng.normal(size=(batch, config.num_mel_bins, t_src)) * 0.3
    patterns = np.stack([np.random.default_rng(500 + k).normal(
        size=(config.num_mel_bins, t_src)) for k in range(n_classes)])
    mel += patterns[labels]
    scripts = np.stack([np.random.default_rng(900 + k).integers(2, config.vocab_size, t_dec)
                        for k in range(n_classes)])
    dec = scripts[labels]
    dec[:, 0] = 1
    return {"input_features": mel.astype(np.float32),
            "decoder_input_ids": dec.astype(np.int32), "labels": labels}


def teacher_forced_loss(out, batch):
    """Teacher-forced next-token CE, sum-reduced, of the S-averaged logits:
    position t predicts decoder id t + 1 (the reference's Whisper loss,
    ``tests/test_whisper.py:19-24``), and the token accuracy."""
    ids = batch["decoder_input_ids"].long()
    logits = elbo.mc_logits_mean(out)[:, :-1].float()
    tgt = ids[:, 1:]
    nll = -torch.log_softmax(logits, dim=-1).gather(-1, tgt[..., None]).sum()
    return nll, {"acc": (logits.argmax(-1) == tgt).float().mean()}
