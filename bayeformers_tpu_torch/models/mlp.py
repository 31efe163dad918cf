"""The reference MNIST MLP (counterpart of ``bayeformers_tpu/models/mlp.py``,
reference ``examples/mlp_mnist.py:16-26``).

784 -> 512 -> 512 -> 10 with ReLU and a LogSoftmax head, trained with the
sum-reduced NLL of its log-probabilities. Its three layers are the port's
``Dense`` (``fc1``, ``fc2``, ``head``, the Flax module's names), so
``to_bayesian`` converts them and every tier's ``mc`` reaches them: the
forward takes the images as its first input (``run_mc`` tiles it S-major
like token ids) and ignores the encoders' mask and token types.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from bayeformers_tpu_torch.models.bert import check_device
from bayeformers_tpu_torch.nn.dense import Dense, assign_paths


class MLP(nn.Module):
    def __init__(self, input_dim: int = 784, hidden: int = 512, n_classes: int = 10,
                 device=None):
        super().__init__()
        self.fc1 = Dense(input_dim, hidden, device=device)
        self.fc2 = Dense(hidden, hidden, device=device)
        self.head = Dense(hidden, n_classes, device=device)
        assign_paths(self)

    def forward(self, x, attention_mask=None, token_type_ids=None, mc=None):
        x = x.reshape(x.shape[0], -1)
        x = torch.relu(self.fc1(x, mc))
        x = torch.relu(self.fc2(x, mc))
        return torch.log_softmax(self.head(x, mc).float(), dim=-1).to(x.dtype)


@torch.no_grad()
def build_mlp(seed: int = 0, input_dim: int = 784, hidden: int = 512, n_classes: int = 10,
              device="cuda") -> MLP:
    """The reference MLP with Flax's ``Dense`` init from ``seed``: kernels
    from the truncated normal of ``lecun_normal`` (std sqrt(1 / fan_in) /
    0.8796, cut at two standard deviations), zero biases."""
    device = check_device(device, "build_mlp")
    model = MLP(input_dim, hidden, n_classes, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for mod in (model.fc1, model.fc2, model.head):
        std = math.sqrt(1.0 / mod.kernel.shape[0]) / 0.87962566103423978
        w = torch.randn(mod.kernel.shape, generator=gen, device=device)
        while True:  # redraw what falls outside two standard deviations
            bad = w.abs() > 2.0
            if not bool(bad.any()):
                break
            w = torch.where(bad, torch.randn(w.shape, generator=gen, device=device), w)
        mod.kernel.copy_(w * std)
        mod.bias.zero_()
    model.requires_grad_(False)
    return model
