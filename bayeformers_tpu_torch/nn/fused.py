"""Fused Monte-Carlo forward: S samples as one S-major super-batch.

Counterpart of ``bayeformers_tpu/nn/fused.py::fused_mc_apply``. The model
runs ONCE over an ``S*B`` batch tiled S-major (``x_tiled[s*B + b] ==
x[b]``); every converted ``Dense`` reshapes its ``(S*B, ..., K)`` input to
``(S, B*..., K)`` and runs the Bayesian linear op with a per-sample weight
axis, and each self-attention block runs q/k/v through the same path and
attention through the flat-layout ``mha`` op. Where the JAX package
intercepts Flax module calls, the port dispatches at module level: each
module's ``forward(..., mc)`` hands itself to the :class:`FusedMC` of the
call.

Per-leaf seeds come from the request's integer seed through
:func:`derive_seed` (a splitmix64 chain), so identical (inputs, seed) give
identical draws. Log-probs are collected once per converted leaf and summed
model-wide.

The forward is differentiable: with ``save_weights=True`` (the default, as
in the reference) each Bayesian linear op keeps its W pair for the
backward of ``ops/fused_linear.py::BayesLinearAnti``, attention runs its
own backward, and the sampled biases and their log-probs differentiate
through plain autograd. Serving calls it with ``save_weights=False`` inside
``torch.inference_mode()``.
"""
from __future__ import annotations

import math

import torch

from bayeformers_tpu_torch.core import distributions as dist
from bayeformers_tpu_torch.core import prior as prior_lib
from bayeformers_tpu_torch.ops import attention as ops_attention
from bayeformers_tpu_torch.ops import common as ops_common
from bayeformers_tpu_torch.ops import fused_linear as ops_fused

SEP = "/"
_M64 = (1 << 64) - 1


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def derive_seed(seed: int, *path: int) -> int:
    """A 31-bit kernel seed from an integer seed and a path of integers:
    ``h = splitmix64(seed); h = splitmix64(h ^ p)`` for each ``p``."""
    h = _splitmix64(seed & _M64)
    for p in path:
        h = _splitmix64(h ^ (p & _M64))
    return h & 0x7FFFFFFF


def tile_samples(x: torch.Tensor, n_samples: int) -> torch.Tensor:
    """(B, ...) -> (S*B, ...), S-major."""
    return x.unsqueeze(0).expand((n_samples,) + tuple(x.shape)).reshape(
        (n_samples * x.shape[0],) + tuple(x.shape[1:])
    )


def untile_samples(x: torch.Tensor, n_samples: int) -> torch.Tensor:
    """Inverse of :func:`tile_samples`: (S*B, ...) -> (S, B, ...)."""
    return x.reshape((n_samples, x.shape[0] // n_samples) + tuple(x.shape[1:]))


def check_converted_paths_seen(paths, seen: set, tier: str) -> None:
    """Raise if a converted leaf never went through this tier's handlers: it
    would otherwise run at mu with no sampling and no KL term. A converted
    bias counts as seen when its sibling kernel was handled."""
    missed = []
    for p in paths:
        head, _, leaf = p.rpartition(SEP)
        if leaf == "bias":
            sibling = (head + SEP + "kernel") if head else "kernel"
            if p not in seen and sibling not in seen:
                missed.append(p)
        elif p not in seen:
            missed.append(p)
    if missed:
        raise NotImplementedError(
            f"{tier} tier: converted parameter(s) {missed} were never "
            "dispatched during the forward pass; running them at mu would "
            "silently bias the ELBO"
        )


def bias_logprobs(b, bmu, bsig, beps, prior_mu):
    """(S,) log_q and MOPED log_p of a sampled bias (small; plain torch)."""
    lq = torch.sum(-dist.LOG_SQRT_2PI - torch.log(bsig)[None] - 0.5 * beps * beps,
                   dim=-1)
    z = (b - prior_mu[None]) / prior_lib.MOPED_PRIOR_SIGMA
    lp = torch.sum(
        -dist.LOG_SQRT_2PI - math.log(prior_lib.MOPED_PRIOR_SIGMA) - 0.5 * z * z,
        dim=-1,
    )
    return lq, lp


class FusedMC:
    """The state of one fused S-sample forward, handed to every module's
    ``forward(..., mc)``."""

    def __init__(self, bmodel, seed: int, n_samples: int, *,
                 antithetic: bool, impl: str, eps_hook):
        if not antithetic:
            raise NotImplementedError(
                "fused_mc_apply: this slice ports the antithetic estimator; "
                "independent draws (antithetic=False) come with the next slice"
            )
        if n_samples % 2:
            raise ValueError(f"antithetic needs an even n_samples; got {n_samples}")
        if impl not in ("kernel", "plain"):
            raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
        self.bmodel = bmodel
        self.S = n_samples
        self.n_draws = n_samples // 2
        self.plain = impl == "plain" or eps_hook is not None
        self.eps_hook = eps_hook
        self.paths = bmodel.spec.paths
        self.path_index = {p: i for i, p in enumerate(self.paths)}
        dev = bmodel.device
        # every leaf's S/2 seeds, uploaded once per request
        self.seeds = torch.tensor(
            [[derive_seed(seed, i, t) for t in range(self.n_draws)]
             for i in range(len(self.paths))],
            dtype=torch.int32,
        ).to(dev)
        self.bias_eps = {} if eps_hook is not None else self._all_bias_eps()
        self.collected: list[tuple[torch.Tensor, torch.Tensor]] = []
        self.seen: set[str] = set()

    def _all_bias_eps(self) -> dict[str, torch.Tensor]:
        """Every converted bias's (S/2, N) eps in one batched draw: bias
        element j of draw t is the unit stream's element (0, j) for the
        leaf's seed t, a pure function of (seed, j // 128, j % 128) like
        the JAX package's ``_unit_bias_eps``."""
        bpaths = [p for p in self.paths if p.endswith(SEP + "bias")]
        if not bpaths:
            return {}
        rows = self.seeds[[self.path_index[p] for p in bpaths]]  # (nb, S/2)
        widths = [self.bmodel.rho[p].shape[0] for p in bpaths]
        eps = ops_common.unit_eps(rows.reshape(-1), (1, max(widths)))
        eps = eps.reshape(len(bpaths), self.n_draws, -1)
        return {p: eps[i, :, :w] for i, (p, w) in enumerate(zip(bpaths, widths))}

    @staticmethod
    def interleave(a_half: torch.Tensor) -> torch.Tensor:
        """(S/2, ...) draws -> (S, ...) antithetic +- pairs along axis 0."""
        return torch.stack([a_half, -a_half], dim=1).reshape(
            (-1,) + tuple(a_half.shape[1:])
        )

    def _route_matmul(self, kpath, mu, rho, xs):
        seeds = self.seeds[self.path_index[kpath]]
        eps = None
        if self.eps_hook is not None:
            eps = self.eps_hook(kpath, self.n_draws, tuple(mu.shape))
        y, lq, lp = ops_fused.bayes_linear(xs, mu, rho, seeds, plain=self.plain,
                                           eps=eps)
        new_leaf = kpath not in self.seen
        if new_leaf:
            self.seen.add(kpath)
            self.collected.append((lq, lp))
        return y, new_leaf

    def dense(self, mod, x: torch.Tensor) -> torch.Tensor:
        """A converted ``Dense`` over an S-major (S*B, ..., K) input."""
        kpath = mod.path + SEP + "kernel"
        if kpath not in self.bmodel.rho:
            return mod(x)
        lead, K = tuple(x.shape[:-1]), x.shape[-1]
        xs = x.reshape(self.S, -1, K).contiguous()
        y, new_leaf = self._route_matmul(kpath, mod.kernel, self.bmodel.rho[kpath], xs)
        bpath = mod.path + SEP + "bias"
        if bpath in self.bmodel.rho:
            y = self._add_bias(y, mod, bpath, new_leaf)
        else:
            y = y + mod.bias.to(y.dtype)
        return y.reshape(lead + (y.shape[-1],))

    def _add_bias(self, y, mod, bpath, new_leaf):
        bmu = mod.bias
        brho = self.bmodel.rho[bpath]
        if self.eps_hook is not None:
            beps = self.eps_hook(bpath, self.n_draws, tuple(bmu.shape))
        else:
            beps = self.bias_eps[bpath]
        beps = self.interleave(beps.to(bmu.dtype))
        bsig = dist.sigma_from_rho(brho)
        b = bmu[None] + bsig[None] * beps
        y = y + b[:, None, :].to(y.dtype)  # bf16 activations stay bf16
        if new_leaf:
            self.collected.append(bias_logprobs(b, bmu, bsig, beps, bmu))
        return y

    def self_attention(self, mod, hidden, bias):
        """The whole self-attention block: q/k/v through :meth:`dense` and
        attention through the flat-layout mha op."""
        q = self.dense(mod.query, hidden)
        k = self.dense(mod.key, hidden)
        v = self.dense(mod.value, hidden)
        return ops_attention.mha(q, k, v, bias, mod.n_heads, plain=self.plain)

    def aux(self) -> dict[str, torch.Tensor]:
        if not self.collected:
            raise ValueError("fused_mc_apply dispatched no converted layers")
        check_converted_paths_seen(self.paths, self.seen, "fused")
        return {
            "log_prior": torch.stack([lp for _, lp in self.collected]).sum(0),
            "log_variational_posterior": torch.stack(
                [lq for lq, _ in self.collected]).sum(0),
        }


def fused_mc_apply(bmodel, seed: int, n_samples: int, input_ids,
                   attention_mask=None, token_type_ids=None, *,
                   save_weights: bool = True, antithetic: bool = True,
                   impl: str = "kernel", eps_hook=None):
    """S-sample fused forward of a converted model. Returns ``(outputs,
    aux)``: outputs (S, B, ...) and aux ``log_prior`` /
    ``log_variational_posterior`` of shape (S,). ``save_weights=False``
    writes no W residuals; a backward through such a forward (it would
    regenerate W) comes with a later slice and raises here."""
    if not save_weights and torch.is_grad_enabled() and any(
            r.requires_grad for r in bmodel.rho.values()):
        raise NotImplementedError(
            "fused_mc_apply(save_weights=False) under autograd: the backward "
            "that regenerates W instead of reading the residual comes with a "
            "later slice; pass save_weights=True or run under "
            "torch.inference_mode()"
        )
    mc = FusedMC(bmodel, seed, n_samples, antithetic=antithetic, impl=impl,
                 eps_hook=eps_hook)
    tiled = [None if a is None else tile_samples(a, n_samples)
             for a in (input_ids, attention_mask, token_type_ids)]
    out = bmodel.model(*tiled, mc=mc)
    return untile_samples(out, n_samples), mc.aux()
