"""A plain-torch CLIP dual encoder, the counterpart of HF's ``FlaxCLIPModel``
as the JAX package builds it (``bayeformers_tpu/models/clip.py``).

Two pre-LN transformer towers with quick-GELU MLPs. The text tower embeds
ids and positions (two ``Embed`` tables, f32 lookups), masks each query to
the keys at or before it that the attention mask keeps (causal plus
padding), and pools the final LayerNorm's output at the first EOS id
(``eos_token_id``; at the highest id where a config names 2, as HF does
for old checkpoints). The vision tower puts a ``class_embedding`` in front
of a bias-free patch ``Conv`` (``nn/conv.py``), adds the position table,
runs ``pre_layrnorm``, the encoder, and ``post_layernorm`` on token 0. The
two pooled vectors go through the bias-free ``visual_projection`` and
``text_projection``, are normalised, and ``logits_per_image`` (B_img,
B_txt) is their cosine similarity times ``exp(logit_scale)``.

Parameter names are the Flax paths (``text_model/encoder/layers/0/
self_attn/q_proj/kernel``, ``vision_model/embeddings/class_embedding``,
``logit_scale``, ...). The default rules convert every Dense of both
towers and both projections; the patch conv converts under ``CONV_RULE``,
the two towers' tables under ``EMBEDDING_RULE``; the class embedding,
LayerNorms and ``logit_scale`` stay frequentist. The attention is plain
torch (``ops/attention.py::plain_attention``; each Dense still reaches the
tier), because the reference's fused
tier does not intercept ``FlaxCLIPAttention``: scores in f32 with the mask
as a ``finfo.min`` bias, softmax in f32, probabilities in the activation
dtype.

A tiled tier sees ``(S*B_img, S*B_txt)`` similarities: call it with
``untile_axes=(1,)``, which keeps each sample's diagonal block
(``nn/fused.py::untile_samples``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from bayeformers_tpu_torch.models.bert import Embed, LayerNorm, check_device
from bayeformers_tpu_torch.nn.conv import Conv
from bayeformers_tpu_torch.nn.dense import Dense, assign_paths
from bayeformers_tpu_torch.ops.attention import plain_attention

CLIP_TINY_KWARGS = dict(
    text_config=dict(
        hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=2, vocab_size=128, max_position_embeddings=32,
    ),
    vision_config=dict(
        hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=2, image_size=32, patch_size=8,
    ),
    projection_dim=32,
)


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    """HF's ``CLIPTextConfig`` fields, its defaults (ViT-B/32's text tower)."""

    vocab_size: int = 49408
    hidden_size: int = 512
    intermediate_size: int = 2048
    num_hidden_layers: int = 12
    num_attention_heads: int = 8
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5
    eos_token_id: int = 49407


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    """HF's ``CLIPVisionConfig`` fields, its defaults (ViT-B/32's vision
    tower)."""

    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    num_channels: int = 3
    image_size: int = 224
    patch_size: int = 32
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


def _fields(cls, d: dict) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in (d or {}).items() if k in names}


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    """HF's ``CLIPConfig``: the two towers' configs, ``projection_dim`` and
    ``logit_scale_init_value``."""

    text_config: CLIPTextConfig = CLIPTextConfig()
    vision_config: CLIPVisionConfig = CLIPVisionConfig()
    projection_dim: int = 512
    logit_scale_init_value: float = 2.6592
    initializer_range: float = 0.02

    @classmethod
    def from_hf(cls, d: dict) -> "CLIPConfig":
        """The port's config from a ``CLIPConfig(**kwargs)``'s kwargs or an
        HF ``CLIPConfig.to_dict()``: each tower's fields over HF's
        defaults."""
        top = _fields(cls, d)
        top["text_config"] = CLIPTextConfig(**_fields(CLIPTextConfig, d.get("text_config")))
        top["vision_config"] = CLIPVisionConfig(
            **_fields(CLIPVisionConfig, d.get("vision_config")))
        return cls(**top)


def quick_gelu(y: torch.Tensor) -> torch.Tensor:
    """HF's ``quick_gelu``, ``x sigmoid(1.702 x)``, in f32, back in ``y``'s
    dtype."""
    yf = y.float()
    return (yf * torch.sigmoid(1.702 * yf)).to(y.dtype)


class CLIPAttention(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        h = cfg.hidden_size
        self.k_proj = Dense(h, h, device=device)
        self.v_proj = Dense(h, h, device=device)
        self.q_proj = Dense(h, h, device=device)
        self.out_proj = Dense(h, h, device=device)
        self.n_heads = cfg.num_attention_heads

    def forward(self, hidden, bias, mc=None):
        """``bias`` (N or 1, L, L) f32, 0 where a query sees a key and
        ``finfo.min`` where it does not, or None."""
        q, k, v = (p(hidden, mc) for p in (self.q_proj, self.k_proj, self.v_proj))
        ctx = plain_attention(q, k, v, None if bias is None else bias[:, None], self.n_heads)
        return self.out_proj(ctx, mc)


class CLIPMLP(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        self.fc1 = Dense(cfg.hidden_size, cfg.intermediate_size, device=device)
        self.fc2 = Dense(cfg.intermediate_size, cfg.hidden_size, device=device)
        if cfg.hidden_act != "quick_gelu":
            raise ValueError(f"CLIP's MLP takes quick_gelu, got {cfg.hidden_act!r}")

    def forward(self, hidden, mc=None):
        return self.fc2(quick_gelu(self.fc1(hidden, mc)), mc)


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg, dtype, device=None):
        super().__init__()
        self.self_attn = CLIPAttention(cfg, device)
        self.layer_norm1 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, device=device)
        self.mlp = CLIPMLP(cfg, device)
        self.layer_norm2 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, device=device)
        self.dtype = dtype

    def forward(self, hidden, bias, mc=None):
        hidden = hidden + self.self_attn(self.layer_norm1(hidden).to(self.dtype), bias, mc)
        return hidden + self.mlp(self.layer_norm2(hidden).to(self.dtype), mc)


class CLIPEncoder(nn.Module):
    def __init__(self, cfg, dtype, device=None):
        super().__init__()
        self.layers = nn.ModuleList(CLIPEncoderLayer(cfg, dtype, device)
                                    for _ in range(cfg.num_hidden_layers))

    def forward(self, hidden, bias, mc=None):
        for layer in self.layers:
            hidden = layer(hidden, bias, mc)
        return hidden


class CLIPTextEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, device=None):
        super().__init__()
        self.token_embedding = Embed(cfg.vocab_size, cfg.hidden_size, device=device)
        self.position_embedding = Embed(cfg.max_position_embeddings, cfg.hidden_size,
                                        device=device)


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, dtype, device=None):
        super().__init__()
        self.embeddings = CLIPTextEmbeddings(cfg, device)
        self.encoder = CLIPEncoder(cfg, dtype, device)
        self.final_layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, device=device)
        self.eos_token_id = cfg.eos_token_id
        self.dtype = dtype

    def forward(self, input_ids, attention_mask, mc=None):
        N, L = input_ids.shape
        e = self.embeddings
        positions = torch.arange(L, device=input_ids.device).expand(N, L)
        hidden = e.token_embedding(input_ids, mc) + e.position_embedding(positions, mc)
        # causal plus padding: query i sees key j <= i that the mask keeps
        keep = torch.ones(L, L, dtype=torch.bool, device=input_ids.device).tril()
        keep = keep[None] & (attention_mask[:, None, :] > 0)
        bias = torch.where(keep, 0.0, torch.finfo(torch.float32).min)
        hidden = self.final_layer_norm(self.encoder(hidden, bias, mc))
        if self.eos_token_id == 2:  # HF: old configs name 2; pool at the highest id
            at = input_ids.argmax(dim=-1)
        else:
            at = (input_ids == self.eos_token_id).int().argmax(dim=-1)
        return hidden[torch.arange(N, device=hidden.device), at].to(self.dtype)


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, device=None):
        super().__init__()
        h, p = cfg.hidden_size, cfg.patch_size
        self.class_embedding = nn.Parameter(torch.empty(h, device=device))
        self.patch_embedding = Conv(cfg.num_channels, h, (p, p), strides=(p, p),
                                    padding="VALID", use_bias=False, device=device)
        self.position_embedding = Embed(cfg.num_patches + 1, h, device=device)

    def forward(self, pixel_values, mc=None):
        y = self.patch_embedding(pixel_values, mc)
        B = y.shape[0]
        patches = y.reshape(B, -1, y.shape[-1]).float()
        cls = self.class_embedding.expand(B, 1, -1)
        # every image's positions, so that a converted table's draw is its
        # own sample's (the same lookup as HF's one (1, P + 1) row)
        positions = torch.arange(patches.shape[1] + 1, device=y.device).expand(B, -1)
        return torch.cat([cls, patches], dim=1) + self.position_embedding(positions, mc)


class CLIPVisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, dtype, device=None):
        super().__init__()
        eps = cfg.layer_norm_eps
        self.embeddings = CLIPVisionEmbeddings(cfg, device)
        self.pre_layrnorm = LayerNorm(cfg.hidden_size, eps, device=device)
        self.encoder = CLIPEncoder(cfg, dtype, device)
        self.post_layernorm = LayerNorm(cfg.hidden_size, eps, device=device)
        self.dtype = dtype

    def forward(self, pixel_values, mc=None):
        hidden = self.pre_layrnorm(self.embeddings(pixel_values.to(self.dtype), mc))
        hidden = self.encoder(hidden.to(self.dtype), None, mc)
        return self.post_layernorm(hidden[:, 0]).to(self.dtype)


class CLIPModel(nn.Module):
    """``forward(input_ids, pixel_values, attention_mask=None, mc=None)``:
    ids (B_txt, L), NHWC pixels (B_img, image_size, image_size, channels)
    -> ``logits_per_image`` (B_img, B_txt) in the activation dtype
    (``logits_per_text`` is its transpose)."""

    family = "clip"
    uses_token_type_ids = False
    input_keys = ("input_ids", "pixel_values", "attention_mask")

    def __init__(self, cfg: CLIPConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.config = cfg
        self.dtype = dtype
        self.text_model = CLIPTextTransformer(cfg.text_config, dtype, device)
        self.vision_model = CLIPVisionTransformer(cfg.vision_config, dtype, device)
        self.visual_projection = Dense(cfg.vision_config.hidden_size, cfg.projection_dim,
                                       use_bias=False, device=device)
        self.text_projection = Dense(cfg.text_config.hidden_size, cfg.projection_dim,
                                     use_bias=False, device=device)
        self.logit_scale = nn.Parameter(torch.tensor(cfg.logit_scale_init_value,
                                                     device=device))
        assign_paths(self)

    def forward(self, input_ids, pixel_values, attention_mask=None, mc=None):
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        image = self.visual_projection(self.vision_model(pixel_values, mc), mc).float()
        text = self.text_projection(self.text_model(input_ids, attention_mask, mc), mc).float()
        image = image / torch.linalg.vector_norm(image, dim=-1, keepdim=True)
        text = text / torch.linalg.vector_norm(text, dim=-1, keepdim=True)
        logits_per_text = torch.matmul(text, image.t()) * torch.exp(self.logit_scale)
        return logits_per_text.t().to(self.dtype)


@torch.no_grad()
def init_clip(model: CLIPModel, seed: int) -> None:
    """A random init from ``seed``: N(0, initializer_range) kernels, tables
    and the class embedding, zero biases, unit LayerNorm scales, and
    ``logit_scale`` at its init value."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    std = model.config.initializer_range
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("kernel", "embedding", "class_embedding"):
            p.normal_(0.0, std, generator=gen)
        elif leaf == "scale":
            p.fill_(1.0)
        elif leaf == "logit_scale":
            p.fill_(model.config.logit_scale_init_value)
        else:
            p.zero_()


def build_clip(size: str = "tiny", seed: int = 0, dtype=torch.bfloat16, device="cuda",
               pretrained: Optional[str] = None, **config_overrides) -> CLIPModel:
    """CLIP at ``CLIP_TINY_KWARGS`` with ``config_overrides`` over it (a
    tower's dict replaces that tower's, whose fields then default to HF's:
    ViT-B/32's widths), initialised from ``seed``, or from a local HF
    directory with ``pretrained`` (``pretrained.py``), on ``device`` (the
    card unless the caller passes ``"cpu"``); the reference's offline build
    takes ``size="tiny"`` only. ``dtype`` is the activation dtype;
    parameters stay f32."""
    if pretrained is not None:
        from bayeformers_tpu_torch.pretrained import load_pretrained

        return load_pretrained(pretrained, seed=seed, dtype=dtype, device=device)
    if size != "tiny":
        raise ValueError("the offline build takes size='tiny' (with config_overrides "
                         "for other widths)")
    cfg = CLIPConfig.from_hf(dict(CLIP_TINY_KWARGS, **config_overrides))
    device = check_device(device, "build_clip")
    model = CLIPModel(cfg, dtype=dtype, device=device)
    init_clip(model, seed)
    model.requires_grad_(False)
    return model


def synthetic_clip_batch(rng: np.random.Generator, batch: int, seq: int, image_size: int,
                         vocab: int, n_classes: int = 4, num_channels: int = 3,
                         eos_token_id: Optional[int] = None) -> dict:
    """A paired image and text batch as numpy arrays, the reference's draws
    in its order (``bayeformers_tpu/models/clip.py:108-134``): class k
    shifts an image quadrant and fixes a class caption of ``seq`` ids.
    ``eos_token_id`` (port keyword) ends each caption with that id, so that
    the text tower pools a real position of a full-vocabulary model."""
    labels = rng.integers(0, n_classes, batch)
    base = rng.normal(size=(batch, image_size, image_size, num_channels))
    q = image_size // 2
    for k in range(n_classes):
        mask = labels == k
        base[mask, :q, :q, k % num_channels] += 2.0 * (k + 1)
    captions = np.stack([np.random.default_rng(1000 + k).integers(1, vocab, seq)
                         for k in range(n_classes)])
    ids = captions[labels].astype(np.int32)
    if eos_token_id is not None:
        ids[:, -1] = eos_token_id
    return {"pixel_values": base.astype(np.float32), "input_ids": ids, "labels": labels}


def clip_contrastive_loss(logits_per_image: torch.Tensor) -> torch.Tensor:
    """Symmetric InfoNCE over a paired batch, sum-reduced (the reference's
    NLL-sum convention): the matched pairs are the diagonal."""
    logits = logits_per_image.float()
    targets = torch.arange(logits.shape[0], device=logits.device)
    li = torch.log_softmax(logits, dim=-1)
    lt = torch.log_softmax(logits.t(), dim=-1)
    pick = lambda lp: lp.gather(-1, targets[:, None])[:, 0]  # noqa: E731
    return -0.5 * (pick(li).sum() + pick(lt).sum())
