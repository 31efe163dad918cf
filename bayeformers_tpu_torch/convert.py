"""Carry the JAX package's converted BERT over to the port.

``from_jax_params(params, rho, prior_mu=None)`` takes the Flax BERT
parameter tree (nested dicts, or a flat ``{'/'-joined path: array}``) and
the ``BayesParams.rho`` dict of the JAX package, as numpy arrays, and builds
the port's :class:`~models.bert.BertForSequenceClassification` and
:class:`~nn.surgery.BayesianModel` over them. The port's parameter names
are the Flax paths, so the mapping is one to one; both then compute the
same function. The JAX package is never imported: callers pass arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from bayeformers_tpu_torch.models.bert import BertConfig, BertForSequenceClassification
from bayeformers_tpu_torch.nn.surgery import SEP, BayesianModel, ConversionSpec, leaf


def flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dicts -> ``{'/'-joined path: array}``; a flat dict passes."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{SEP}{k}" if prefix else str(k)
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _config_from(flat: dict[str, np.ndarray], n_heads) -> BertConfig:
    word = flat["bert/embeddings/word_embeddings/embedding"]
    hidden = word.shape[1]
    n_layers = len({p.split(SEP)[3] for p in flat
                    if p.startswith("bert/encoder/layer/")})
    return BertConfig(
        vocab_size=word.shape[0],
        hidden_size=hidden,
        num_hidden_layers=n_layers,
        num_attention_heads=n_heads or hidden // 64,
        intermediate_size=flat["bert/encoder/layer/0/intermediate/dense/kernel"].shape[1],
        max_position_embeddings=flat["bert/embeddings/position_embeddings/embedding"].shape[0],
        type_vocab_size=flat["bert/embeddings/token_type_embeddings/embedding"].shape[0],
        num_labels=flat["classifier/kernel"].shape[1],
    )


@torch.no_grad()
def from_jax_params(params, rho, prior_mu=None, *, num_attention_heads=None,
                    dtype=torch.float32, device="cuda") -> BayesianModel:
    """A frozen-MOPED :class:`BayesianModel` holding the JAX package's mu
    (``params``) and ``rho``, on ``device`` (the card unless the caller
    passes ``"cpu"``). ``prior_mu``, when given, must equal mu at every
    converted leaf (the frozen recipe centres the prior on mu).
    ``num_attention_heads`` defaults to BERT's 64-wide heads."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("from_jax_params(device='cuda'): no CUDA device")
    flat = flatten(params)
    rho_flat = flatten(rho)
    cfg = _config_from(flat, num_attention_heads)
    model = BertForSequenceClassification(cfg, dtype=dtype, device=dev)
    names = {n.replace(".", SEP) for n, _ in model.named_parameters()}
    if names != set(flat):
        raise ValueError(
            "params do not match the port's BERT: missing "
            f"{sorted(names - set(flat))}, unexpected {sorted(set(flat) - names)}"
        )
    for path, arr in flat.items():
        leaf(model, path).copy_(torch.from_numpy(np.array(arr, np.float32)))
    model.requires_grad_(False)
    if prior_mu is not None:
        for path, arr in flatten(prior_mu).items():
            if not np.array_equal(np.asarray(arr), flat[path]):
                raise NotImplementedError(
                    f"prior_mu at {path} differs from mu: a prior away from a "
                    "frozen mu comes with the slice that ports a trainable mu "
                    "and the other priors (ROADMAP queue 1, items 2 and 3)"
                )
    rho_t = {p: torch.from_numpy(np.array(a, np.float32)).to(dev)
             for p, a in rho_flat.items()}
    spec = ConversionSpec(
        paths=tuple(sorted(rho_t, key=lambda p: tuple(p.split(SEP)))),
        moped=True, frozen=True, delta=None,
    )
    return BayesianModel(model, spec, rho_t)
