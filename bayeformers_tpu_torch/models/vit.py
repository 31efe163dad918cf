"""A plain-torch ViT image classifier, the counterpart of HF's
``FlaxViTForImageClassification`` as the JAX package builds it
(``bayeformers_tpu/models/vit.py``).

The computation is the Flax module's: the NHWC pixels' patch embedding (a
``Conv`` with ``VALID`` padding and the patch as its stride,
``nn/conv.py``), a ``cls_token`` in front, ``position_embeddings`` added
(both plain parameters that stay frequentist under every rule), pre-LN
encoder layers (LayerNorm eps 1e-12, exact GELU), the final LayerNorm and a
linear classifier on token 0. The sequence is ``(image_size /
patch_size)^2 + 1`` long: 197 at ViT-base/16's 224 pixels, a length that
is not a multiple of 8, which the port's attention kernels take (the JAX
package's Pallas kernel needs 8-aligned rows and sends it to XLA).

Parameter names are the Flax paths (``vit/embeddings/cls_token``,
``vit/encoder/layer/0/attention/attention/query/kernel``, ...), so
``from_jax_params`` carries a JAX conversion over one to one. The default
rules convert every Dense (q/k/v, the attention output, the MLP and the
classifier); ``CONV_RULE`` converts the patch projection too. Each
self-attention block is BERT's (``models/bert.py::BertSelfAttention``):
under a tier it hands itself to ``mc.self_attention`` with a zero key bias
(images have no padding), as the reference's fused tier intercepts
``FlaxViTSelfAttention`` (``nn/fused.py:612-620``). Activations are in
``dtype``: the patch embedding and each Dense's output, while the residual
stream stays f32 as Flax's promotion keeps it (the f32 embeddings plus a
bf16 branch are f32); parameters stay f32. Dropout is omitted.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from bayeformers_tpu_torch.models.bert import (
    BertSelfAttention,
    LayerNorm,
    activation,
    check_device,
)
from bayeformers_tpu_torch.nn.conv import Conv
from bayeformers_tpu_torch.nn.dense import Dense, assign_paths

VIT_BASE_KWARGS = dict(
    hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
    intermediate_size=3072, image_size=224, patch_size=16, num_channels=3,
)
# tiny: 16 patches + CLS = 17 positions, head_dim 64
VIT_TINY_KWARGS = dict(
    hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
    intermediate_size=256, image_size=32, patch_size=8, num_channels=3,
)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """HF's ``ViTConfig`` fields that the classifier reads."""

    hidden_size: int
    num_hidden_layers: int
    num_attention_heads: int
    intermediate_size: int
    image_size: int
    patch_size: int
    num_channels: int = 3
    layer_norm_eps: float = 1e-12
    num_labels: int = 2
    initializer_range: float = 0.02
    hidden_act: str = "gelu"

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


class ViTPatchEmbeddings(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        p = cfg.patch_size
        self.projection = Conv(cfg.num_channels, cfg.hidden_size, (p, p), strides=(p, p),
                               padding="VALID", device=device)

    def forward(self, pixel_values, mc=None):
        y = self.projection(pixel_values, mc)  # (B, h, w, H)
        return y.reshape(y.shape[0], -1, y.shape[-1])


class ViTEmbeddings(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        h = cfg.hidden_size
        self.cls_token = nn.Parameter(torch.empty(1, 1, h, device=device))
        self.patch_embeddings = ViTPatchEmbeddings(cfg, device)
        self.position_embeddings = nn.Parameter(
            torch.empty(1, cfg.num_patches + 1, h, device=device))

    def forward(self, pixel_values, mc=None):
        patches = self.patch_embeddings(pixel_values, mc)
        cls = self.cls_token.expand(patches.shape[0], 1, patches.shape[-1])
        return torch.cat([cls, patches.float()], dim=1) + self.position_embeddings


class ViTSelfOutput(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        self.dense = Dense(cfg.hidden_size, cfg.hidden_size, device=device)


class ViTAttention(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        self.attention = BertSelfAttention(cfg, device)
        self.output = ViTSelfOutput(cfg, device)

    def forward(self, hidden, bias, mc=None):
        return self.output.dense(self.attention(hidden, bias, mc), mc)


class ViTDense(nn.Module):
    """HF's ``FlaxViTIntermediate`` / ``FlaxViTOutput``: one ``dense``."""

    def __init__(self, n_in: int, n_out: int, device=None):
        super().__init__()
        self.dense = Dense(n_in, n_out, device=device)


class ViTLayer(nn.Module):
    def __init__(self, cfg: ViTConfig, dtype, device=None):
        super().__init__()
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.attention = ViTAttention(cfg, device)
        self.intermediate = ViTDense(h, cfg.intermediate_size, device)
        self.output = ViTDense(cfg.intermediate_size, h, device)
        self.layernorm_before = LayerNorm(h, eps, device=device)
        self.layernorm_after = LayerNorm(h, eps, device=device)
        self.act = cfg.hidden_act
        self.dtype = dtype

    def forward(self, hidden, bias, mc=None):
        # pre-LN: LayerNorm before the attention and before the MLP
        a = self.attention(self.layernorm_before(hidden).to(self.dtype), bias, mc) + hidden
        x = self.layernorm_after(a).to(self.dtype)
        x = activation(self.intermediate.dense(x, mc), self.act)
        return self.output.dense(x, mc) + a


class ViTEncoder(nn.Module):
    def __init__(self, cfg: ViTConfig, dtype, device=None):
        super().__init__()
        self.layer = nn.ModuleList(ViTLayer(cfg, dtype, device)
                                   for _ in range(cfg.num_hidden_layers))

    def forward(self, hidden, bias, mc=None):
        for layer in self.layer:
            hidden = layer(hidden, bias, mc)
        return hidden


class ViTModule(nn.Module):
    def __init__(self, cfg: ViTConfig, dtype, device=None):
        super().__init__()
        self.embeddings = ViTEmbeddings(cfg, device)
        self.encoder = ViTEncoder(cfg, dtype, device)
        self.layernorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, device=device)


class ViTForImageClassification(nn.Module):
    """``forward(pixel_values, mc=None)``: NHWC pixels (B, image_size,
    image_size, num_channels) -> logits (B, num_labels) in the activation
    dtype."""

    family = "vit"
    uses_token_type_ids = False
    input_keys = ("pixel_values",)

    def __init__(self, cfg: ViTConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.config = cfg
        self.dtype = dtype
        self.vit = ViTModule(cfg, dtype, device)
        self.classifier = Dense(cfg.hidden_size, cfg.num_labels, device=device)
        assign_paths(self)

    def forward(self, pixel_values, mc=None):
        if pixel_values.shape[-1] != self.config.num_channels:
            raise ValueError(f"pixel_values must be NHWC with {self.config.num_channels} "
                             f"channels, got {tuple(pixel_values.shape)}")
        v = self.vit
        hidden = v.embeddings(pixel_values.to(self.dtype), mc)
        # no padding in an image: a zero key bias, as the reference's handler
        bias = torch.zeros(hidden.shape[:2], dtype=torch.float32, device=hidden.device)
        hidden = v.layernorm(v.encoder(hidden, bias, mc)).to(self.dtype)
        return self.classifier(hidden[:, 0], mc)


@torch.no_grad()
def init_vit(model: nn.Module, seed: int) -> None:
    """A random init from ``seed``: N(0, initializer_range) kernels, the CLS
    token and the position embeddings, zero biases, unit LayerNorm
    scales."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    std = model.config.initializer_range
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("kernel", "cls_token", "position_embeddings"):
            p.normal_(0.0, std, generator=gen)
        elif leaf == "scale":
            p.fill_(1.0)
        else:
            p.zero_()


def build_vit(task: str = "classification", n_labels: int = 2, size: str = "base",
              seed: int = 0, dtype=torch.bfloat16, device="cuda",
              pretrained: Optional[str] = None,
              **config_overrides) -> ViTForImageClassification:
    """The ViT image classifier at ``VIT_BASE_KWARGS`` (``size="base"``,
    google/vit-base-patch16-224's widths) or ``VIT_TINY_KWARGS``
    (``"tiny"``), fields overridden by ``config_overrides``, initialised from
    ``seed`` (or, with ``pretrained``, a local HF directory's weights and a
    classifier of ``n_labels`` where it has none: ``pretrained.py``), on
    ``device`` (the card unless the caller passes ``"cpu"``). ``dtype`` is
    the activation dtype; parameters stay f32."""
    if task != "classification":
        raise ValueError(f"vit supports task='classification'; got {task!r}")
    if pretrained is not None:
        from bayeformers_tpu_torch.pretrained import load_pretrained

        return load_pretrained(pretrained, n_labels=n_labels, seed=seed, dtype=dtype,
                               device=device)
    kwargs = dict(VIT_BASE_KWARGS if size == "base" else VIT_TINY_KWARGS)
    kwargs.update(config_overrides)
    cfg = ViTConfig(num_labels=n_labels, **kwargs)
    device = check_device(device, "build_vit")
    model = ViTForImageClassification(cfg, dtype=dtype, device=device)
    init_vit(model, seed)
    model.requires_grad_(False)
    return model


def synthetic_image_batch(rng: np.random.Generator, batch: int, image_size: int,
                          n_labels: int = 2, num_channels: int = 3) -> dict:
    """Separable synthetic images as numpy arrays, the reference's draws in
    its order (``bayeformers_tpu/models/vit.py:98-118``): class k shifts
    one quadrant of channel ``k % num_channels`` by ``2 (k + 1)``."""
    labels = rng.integers(0, n_labels, batch)
    base = rng.normal(size=(batch, image_size, image_size, num_channels))
    q = image_size // 2
    signal = np.zeros_like(base)
    for k in range(n_labels):
        mask = labels == k
        signal[mask, :q, :q, k % num_channels] = 2.0 * (k + 1)
    return {"pixel_values": (base + signal).astype(np.float32), "labels": labels}
