"""``to_bayesian`` over the port's own modules.

Counterpart of ``bayeformers_tpu/nn/surgery.py``. Every ``Dense``
(``nn/dense.py``, the port's ``nn.Dense``) kernel and bias
(``DEFAULT_RULES``, the reference's ``{nn.Linear: Linear}`` scope) becomes
a variational pair: ``mu`` is the module's own parameter, ``rho``
lives in :attr:`BayesianModel.rho` under the leaf's Flax path. This slice
ports the MOPED recipe of the GLUE path: ``delta`` set and ``freeze=True``,
so the prior is centred on the frozen ``mu``. What trains then is every
``rho`` and every unconverted parameter (embeddings, LayerNorm scale and
bias): :meth:`BayesianModel.trainable_mask` and
:meth:`BayesianModel.trainable_parameters`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch import nn

from bayeformers_tpu_torch.core import init as init_lib
from bayeformers_tpu_torch.nn.dense import Dense, assign_paths

SEP = "/"


def _match_linear(name: str, mod: nn.Module) -> bool:
    return isinstance(mod, Dense)


# leaf-owner predicates; a matching module converts its kernel and bias
DEFAULT_RULES: tuple[Callable[[str, nn.Module], bool], ...] = (_match_linear,)


@dataclasses.dataclass(frozen=True)
class ConversionSpec:
    """Static description of a conversion."""

    paths: tuple[str, ...]
    moped: bool
    frozen: bool
    delta: Optional[float]


def find_convertible_paths(model: nn.Module) -> tuple[str, ...]:
    """'/'-joined leaf paths of every converted parameter, in the order of
    the JAX package (sorted by path components)."""
    assign_paths(model)
    out = []
    for name, mod in model.named_modules():
        if any(rule(name, mod) for rule in DEFAULT_RULES):
            for leaf, _ in mod.named_parameters(recurse=False):
                out.append(tuple(name.split(".")) + (leaf,))
    return tuple(SEP.join(p) for p in sorted(out))


def leaf(model: nn.Module, path: str) -> torch.Tensor:
    """The parameter at a '/'-joined path."""
    return model.get_parameter(path.replace(SEP, "."))


class BayesianModel:
    """A converted model: the module tree holds ``mu`` (frozen, and the
    prior's centre); ``rho`` is a ``{path: tensor}`` dict."""

    def __init__(self, model: nn.Module, spec: ConversionSpec,
                 rho: dict[str, torch.Tensor]):
        self.model = model
        self.spec = spec
        self.rho = rho

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def mc_apply_fused(self, seed: int, n_samples: int, input_ids,
                       attention_mask=None, token_type_ids=None, *,
                       save_weights: bool = True, antithetic: bool = True,
                       impl: str = "kernel", eps_hook=None):
        """S Monte-Carlo forwards as one S-major super-batch through the
        fused tier. Returns ``(logits (S, B, ...), aux)`` with aux's
        ``log_prior`` / ``log_variational_posterior`` of shape (S,).
        Differentiable: ``save_weights=True`` keeps each layer's W pair for
        the backward (``save_weights=False``, for inference, writes none).
        ``antithetic=False`` comes with a later slice and raises.

        ``seed`` is the request's integer key; per-leaf draws derive from it
        (:func:`nn.fused.derive_seed`). ``impl="plain"`` runs every op's
        plain version on the tensors' device (the reference for the kernels
        on the card); ``eps_hook(path, n_draws, shape)`` supplies each
        leaf's draw (tests only; implies the plain versions)."""
        from bayeformers_tpu_torch.nn import fused as fused_lib

        return fused_lib.fused_mc_apply(
            self, seed, n_samples, input_ids, attention_mask, token_type_ids,
            save_weights=save_weights, antithetic=antithetic, impl=impl,
            eps_hook=eps_hook,
        )

    # -- trainability -------------------------------------------------------
    def trainable_mask(self) -> dict[str, dict[str, bool]]:
        """``{"params": {path: bool}, "rho": {path: bool}}``, False = do not
        train (the reference's ``trainable_mask``): with ``freeze`` the
        converted mu leaves are frozen; every rho and every unconverted
        parameter trains. The port has no ``prior_mu`` leaf: the frozen
        recipe's prior is centred on mu itself."""
        frozen = set(self.spec.paths) if self.spec.frozen else set()
        params = {name.replace(".", SEP): name.replace(".", SEP) not in frozen
                  for name, _ in self.model.named_parameters()}
        return {"params": params, "rho": {p: True for p in self.rho}}

    def trainable_parameters(self, no_decay: Optional[Callable[[str], bool]] = None
                             ) -> list[tuple[str, torch.Tensor, bool]]:
        """``(name, tensor, decays)`` of every trainable tensor, named
        ``params/<path>`` or ``rho/<path>``, after setting ``requires_grad``
        from :meth:`trainable_mask` (frozen tensors lose it). ``decays`` is
        False for rho (sigma never decays) and where ``no_decay(path)``
        (default ``training.default_no_decay``: biases and normalisation)."""
        if no_decay is None:
            from bayeformers_tpu_torch.training import default_no_decay

            no_decay = default_no_decay
        mask = self.trainable_mask()
        out = []
        for path, trainable in mask["params"].items():
            t = leaf(self.model, path)
            t.requires_grad_(trainable)
            if trainable:
                out.append((f"params{SEP}{path}", t, not no_decay(path)))
        for path, t in self.rho.items():
            t.requires_grad_(True)
            out.append((f"rho{SEP}{path}", t, False))
        return out


def to_bayesian(model: nn.Module, *, delta: Optional[float] = 0.05,
                freeze: bool = True) -> BayesianModel:
    """Convert a port model into a Bayesian one with MOPED init:
    ``mu <- w``, ``rho <- softplus^-1(delta |w|)`` (the -inf -> 0 patch),
    prior N(w, softplus(1)^2); ``freeze`` keeps ``mu`` fixed."""
    if delta is None or not freeze:
        raise NotImplementedError(
            "to_bayesian: this slice ports MOPED with freeze=True (the "
            "serving recipe); random init with the mixture prior and a "
            "trainable mu come with the training slice"
        )
    paths = find_convertible_paths(model)
    rho = {}
    with torch.no_grad():
        for path in paths:
            w = leaf(model, path)
            w.requires_grad_(False)
            rho[path] = init_lib.moped_rho(w.detach(), delta)
    spec = ConversionSpec(paths=paths, moped=True, frozen=True, delta=delta)
    return BayesianModel(model, spec, rho)
