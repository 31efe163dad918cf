"""``to_bayesian`` over the port's own modules.

Counterpart of ``bayeformers_tpu/nn/surgery.py``. A conversion rule
classifies parameter leaves, as the JAX package's rules classify the leaves
of a Flax tree: ``match(path, group)`` sees a leaf's path (a tuple of str)
and the parameters its module holds directly, ``{leaf name: tensor}``, the
Flax sibling group. The rules are the reference's (``:64-95``):

- ``LINEAR_RULE`` (``DEFAULT_RULES``, the reference's ``{nn.Linear:
  Linear}`` scope): a 2-D ``kernel`` with an optional 1-D ``bias``, so every
  ``Dense`` (``nn/dense.py``, the port's ``nn.Dense``) and ``Conv1D``
  (GPT-2's projections, stored (out, in));
- ``CONV_RULE`` (opt in): a ``(*kernel_size, cin, cout)`` kernel of 1-3
  spatial dims with an optional 1-D bias, the port's ``Conv``
  (``nn/conv.py``, Flax's ``nn.Conv``);
- ``EMBEDDING_RULE`` (opt in): a 2-D ``embedding``, the port's ``Embed``.

A matched leaf becomes a variational pair: ``mu`` is the module's own
parameter, ``rho`` lives in :attr:`BayesianModel.rho` under the leaf's Flax
path. The reference's conversions (``to_bayesian(model, initialization,
prior, delta, freeze)``):

- ``delta=None`` (the default): random init of mu and rho from
  ``initialization`` under the scale-mixture ``prior``; mu trains;
- ``delta`` set: MOPED, ``mu <- w``, ``rho <- softplus^-1(delta |w|)``, and
  a Gaussian prior centred on the pretrained weights, kept in
  :attr:`BayesianModel.prior_mu` (never trained); ``freeze=True`` (the GLUE
  recipe) freezes mu, so the prior sits on mu itself.

What trains is every ``rho``, mu unless frozen, and every unconverted
parameter (embeddings, LayerNorm scale and bias; GPT-2's tied LM head is
its ``wte`` and stays frequentist):
:meth:`BayesianModel.trainable_mask` and
:meth:`BayesianModel.trainable_parameters`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Optional, Sequence

import torch
from torch import nn

from bayeformers_tpu_torch.core import distributions as dist
from bayeformers_tpu_torch.core import init as init_lib
from bayeformers_tpu_torch.core import prior as prior_lib
from bayeformers_tpu_torch.nn.dense import assign_paths
from bayeformers_tpu_torch.ops.logprob import mixture_log_pdf

SEP = "/"


@dataclasses.dataclass(frozen=True)
class ConversionRule:
    """Classifies parameter leaves as convertible: ``match(path, group)``
    receives the leaf's path (tuple of str) and its module's direct
    parameters ``{leaf name: tensor}``, and returns True if the leaf should
    become a Gaussian variational parameter."""

    name: str
    match: Callable[[tuple[str, ...], Mapping[str, Any]], bool]


def _is_dense_group(group: Mapping[str, Any]) -> bool:
    # a Dense group: 2-D ``kernel``, optional 1-D ``bias``
    if "kernel" not in group or group["kernel"].ndim != 2:
        return False
    if "bias" in group and group["bias"].ndim != 1:
        return False
    return set(group) <= {"kernel", "bias"}


def _match_linear(path: tuple[str, ...], group: Mapping[str, Any]) -> bool:
    return path[-1] in ("kernel", "bias") and _is_dense_group(group)


def _match_embedding(path: tuple[str, ...], group: Mapping[str, Any]) -> bool:
    return path[-1] == "embedding" and group["embedding"].ndim == 2


def _match_conv(path: tuple[str, ...], group: Mapping[str, Any]) -> bool:
    # a Conv group: (*kernel_size, cin, cout) ``kernel`` with 1-3 spatial
    # dims, optional 1-D ``bias``
    if path[-1] not in ("kernel", "bias") or "kernel" not in group:
        return False
    if group["kernel"].ndim not in (3, 4, 5):
        return False
    if "bias" in group and group["bias"].ndim != 1:
        return False
    return set(group) <= {"kernel", "bias"}


LINEAR_RULE = ConversionRule("linear", _match_linear)
EMBEDDING_RULE = ConversionRule("embedding", _match_embedding)
CONV_RULE = ConversionRule("conv", _match_conv)
DEFAULT_RULES: tuple[ConversionRule, ...] = (LINEAR_RULE,)


@dataclasses.dataclass(frozen=True)
class ConversionSpec:
    """Static description of a conversion."""

    paths: tuple[str, ...]
    prior: prior_lib.ScaleMixturePrior
    moped: bool
    frozen: bool
    delta: Optional[float]


def find_convertible_paths(model: nn.Module,
                           rules: Sequence[ConversionRule] = DEFAULT_RULES
                           ) -> tuple[str, ...]:
    """'/'-joined paths of every leaf that a rule matches, in the JAX
    package's order (sorted by path components)."""
    assign_paths(model)
    out = []
    for name, mod in model.named_modules():
        group = dict(mod.named_parameters(recurse=False))
        prefix = tuple(name.split(".")) if name else ()
        for leaf_name in group:
            path = prefix + (leaf_name,)
            if any(rule.match(path, group) for rule in rules):
                out.append(path)
    return tuple(SEP.join(p) for p in sorted(out))


def leaf(model: nn.Module, path: str) -> torch.Tensor:
    """The parameter at a '/'-joined path."""
    return model.get_parameter(path.replace(SEP, "."))


class BayesianModel:
    """A converted model: the module tree holds ``mu``; ``rho`` and, under
    MOPED, ``prior_mu`` (the prior's fixed centre, never trained) are
    ``{path: tensor}`` dicts."""

    def __init__(self, model: nn.Module, spec: ConversionSpec,
                 rho: dict[str, torch.Tensor],
                 prior_mu: Optional[dict[str, torch.Tensor]] = None):
        self.model = model
        self.spec = spec
        self.rho = rho
        self.prior_mu = prior_mu if prior_mu is not None else {}

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def mc_apply_fused(self, seed: int, n_samples: int, *args,
                       save_weights: bool = True, antithetic: bool = False,
                       impl: str = "kernel", eps_hook=None,
                       untile_axes: tuple[int, ...] = (), tp=None, **inputs):
        """S Monte-Carlo forwards as one S-major super-batch through the
        fused tier, of the model's inputs (``args`` and ``inputs``, as the
        model's forward takes them: ``input_ids, attention_mask,
        token_type_ids`` for the text models, ``pixel_values`` for ViT,
        ``input_ids, pixel_values, attention_mask`` for CLIP). Returns
        ``(logits (S, B, ...), aux)`` with aux's
        ``log_prior`` / ``log_variational_posterior`` of shape (S,).
        ``antithetic=False`` (the default, as in the reference) draws each
        sample's weights independently; ``antithetic=True`` draws one eps
        per pair of samples (2t, 2t+1) and uses it with both signs (even
        ``n_samples``). Differentiable: ``save_weights=True`` keeps each
        layer's sampled W for the backward; ``save_weights=False`` writes
        none, and a backward regenerates each layer's W from its seeds
        (inference passes it so). Antithetic f32 layers with a padded K
        above 2048 regenerate either way, as in the reference.

        ``seed`` is the request's integer key; per-leaf draws derive from it
        (:func:`nn.fused.derive_seed`). ``impl="plain"`` runs every op's
        plain version on the tensors' device (the reference for the kernels
        on the card); ``eps_hook(path, n_draws, shape)`` supplies each
        leaf's draw (tests only; implies the plain versions).
        ``untile_axes``: the output's other S-tiled axes, of which each
        sample's diagonal block is kept (CLIP's similarity: ``(1,)``;
        ``nn.fused.untile_samples``). ``tp``: the tensor-parallel context
        of a sharded model (``nn.fused.fused_mc_apply``)."""
        from bayeformers_tpu_torch.nn import fused as fused_lib

        return fused_lib.fused_mc_apply(
            self, seed, n_samples, *args, save_weights=save_weights,
            antithetic=antithetic, impl=impl, eps_hook=eps_hook,
            untile_axes=untile_axes, tp=tp, **inputs)

    def sample(self, generator: torch.Generator):
        """Draw one concrete set of converted leaves with ``generator`` (the
        JAX package's key), each ``sample_gaussian(generator, mu, rho)`` in
        path order. Returns ``(params {path: w}, log_prior, log_q)``, the
        log-probs summed over the leaves: the posterior's Gaussian
        log-density and the conversion's prior (the MOPED Gaussian on
        ``prior_mu``, or the scale mixture) at the drawn weights."""
        params = {}
        log_p = log_q = torch.zeros((), dtype=torch.float32, device=self.device)
        for path in self.spec.paths:
            mu, rho = leaf(self.model, path), self.rho[path]
            w, _ = dist.sample_gaussian(generator, mu, rho)
            log_q = log_q + dist.gaussian_log_prob(w, mu, dist.sigma_from_rho(rho))
            log_p = log_p + self.prior_log_prob(path, w)
            params[path] = w
        return params, log_p, log_q

    def prior_log_prob(self, path: str, w: torch.Tensor, dim=None) -> torch.Tensor:
        """The conversion's log-prior of a leaf's sampled ``w``, summed over
        every element or over ``dim``: the MOPED Gaussian on the leaf's
        ``prior_mu`` (a frozen mu's own values), or the scale mixture."""
        if self.spec.moped:
            return prior_lib.moped_prior_log_prob(w, self.prior_mu[path], dim=dim)
        p = self.spec.prior
        return torch.sum(mixture_log_pdf(w, p.pi, p.sigma1, p.sigma2), dim=dim)

    def apply(self, generator: torch.Generator, *args, **inputs):
        """One stochastic forward of the model's inputs: the model run on
        the leaves of :meth:`sample`. Returns ``(output, aux)`` with aux's
        ``log_prior`` and ``log_variational_posterior`` scalars."""
        params, log_p, log_q = self.sample(generator)
        out = torch.func.functional_call(
            self.model, {p.replace(SEP, "."): w for p, w in params.items()}, args, inputs)
        return out, {"log_prior": log_p, "log_variational_posterior": log_q}

    def mc_apply(self, seed: int, n_samples: int, *args, impl: str = "kernel",
                 eps_hook=None, untile_axes: tuple[int, ...] = (), **inputs):
        """The naive tier: S Monte-Carlo forwards, each on its own draw of
        every converted leaf, as one S-major super-batch with per-sample
        (S, K, N) weights, which computes what the reference's vmap of
        :meth:`apply` over S keys computes. Leaf i draws its S samples with
        ``sample_gaussian`` from a ``torch.Generator`` seeded
        ``derive_seed(seed, i)`` and scores them in plain torch; the products
        are ``torch.bmm``, as they are XLA in the JAX package, and attention
        runs its kernels. Returns ``(logits (S, B, ...), aux)`` with aux's
        ``log_prior`` / ``log_variational_posterior`` of shape (S,).
        ``eps_hook(path, shape)`` supplies each leaf's (S, *shape) eps (tests
        only; implies ``impl="plain"``). Inputs and ``untile_axes`` as in
        :meth:`mc_apply_fused`."""
        from bayeformers_tpu_torch.nn import naive as naive_lib

        return naive_lib.naive_mc_apply(self, seed, n_samples, *args, impl=impl,
                                        eps_hook=eps_hook, untile_axes=untile_axes,
                                        **inputs)

    def mc_apply_flipout(self, seed: int, n_samples: int, *args, **kwargs):
        """The flipout estimator (``nn/flipout.py``): per-example
        decorrelated perturbations around shared weight draws and the
        analytic KL. Same return contract as :meth:`mc_apply`, with the KL
        in aux's ``kl``."""
        from bayeformers_tpu_torch.nn import flipout as flipout_lib

        return flipout_lib.flipout_mc_apply(self, seed, n_samples, *args, **kwargs)

    def mc_apply_lrt(self, seed: int, n_samples: int, *args, **kwargs):
        """The local reparameterization estimator (``nn/lrt.py``):
        activations drawn from their exact Gaussian marginals and the
        analytic KL. Same return contract as :meth:`mc_apply_flipout`."""
        from bayeformers_tpu_torch.nn import lrt as lrt_lib

        return lrt_lib.lrt_mc_apply(self, seed, n_samples, *args, **kwargs)

    # -- trainability -------------------------------------------------------
    def trainable_mask(self) -> dict[str, dict[str, bool]]:
        """``{"params": {path: bool}, "rho": {path: bool}, "prior_mu":
        {path: bool}}``, False = do not train (the reference's
        ``trainable_mask``): with ``freeze`` the converted mu leaves are
        frozen; every rho and every unconverted parameter trains; no
        ``prior_mu`` ever does."""
        frozen = set(self.spec.paths) if self.spec.frozen else set()
        params = {name.replace(".", SEP): name.replace(".", SEP) not in frozen
                  for name, _ in self.model.named_parameters()}
        return {"params": params, "rho": {p: True for p in self.rho},
                "prior_mu": {p: False for p in self.prior_mu}}

    def trainable_parameters(self, no_decay: Optional[Callable[[str], bool]] = None
                             ) -> list[tuple[str, torch.Tensor, bool]]:
        """``(name, tensor, decays)`` of every trainable tensor, named
        ``params/<path>`` (mu of an unfrozen conversion among them) or
        ``rho/<path>``, after setting ``requires_grad`` from
        :meth:`trainable_mask` (frozen tensors lose it; ``prior_mu`` never
        has it). ``decays`` is False for rho (sigma never decays) and where
        ``no_decay(path)`` (default ``training.default_no_decay``: biases and
        normalisation)."""
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


def to_bayesian(model: nn.Module, *,
                initialization: init_lib.UniformInit = init_lib.DEFAULT_UNIFORM,
                prior: prior_lib.ScaleMixturePrior = prior_lib.DEFAULT_SCALE_MIXTURE,
                delta: Optional[float] = None, freeze: bool = False,
                generator: Optional[torch.Generator] = None,
                rules: Sequence[ConversionRule] = DEFAULT_RULES) -> BayesianModel:
    """Convert a port model into a Bayesian one, in place, with the
    reference's signature and defaults (``bayeformers/__init__.py:19-24``;
    the JAX package's ``rng`` is ``generator`` here):

    - ``delta=None``: random init, ``(mu, rho) = initialization(generator,
      shape)`` for each converted leaf in path order, under the
      scale-mixture ``prior``; needs ``generator`` (a ``torch.Generator``),
      as the JAX package needs ``rng``;
    - ``delta`` set: MOPED, ``mu <- w``, ``rho <- softplus^-1(delta |w|)``
      (the -inf -> 0 patch), prior N(w, softplus(1)^2) centred on a fixed
      copy of w (``prior_mu``); ``freeze`` keeps ``mu`` fixed (and the prior
      then sits on mu itself, with no copy).

    ``freeze`` applies to MOPED only, as in the reference. ``rules`` picks
    the converted leaves (:data:`DEFAULT_RULES`: the Dense layers; add
    :data:`CONV_RULE` and :data:`EMBEDDING_RULE` for convolutions and
    embedding tables)."""
    paths = find_convertible_paths(model, rules)
    rho, prior_mu = {}, {}
    frozen = freeze and delta is not None
    with torch.no_grad():
        if delta is None:
            if generator is None:
                raise ValueError(
                    "to_bayesian(delta=None) needs `generator` for random init")
            for path in paths:
                w = leaf(model, path)
                mu, r = initialization(generator, w.shape, w.dtype, w.device)
                w.copy_(mu)
                rho[path] = r
        else:
            for path in paths:
                w = leaf(model, path).detach()
                rho[path] = init_lib.moped_rho(w, delta)
                # a frozen mu is the prior's centre itself
                prior_mu[path] = w if frozen else w.clone()
    for path in paths:
        leaf(model, path).requires_grad_(not frozen)
    spec = ConversionSpec(paths=paths, prior=prior, moped=delta is not None,
                          frozen=frozen, delta=delta)
    return BayesianModel(model, spec, rho, prior_mu)
