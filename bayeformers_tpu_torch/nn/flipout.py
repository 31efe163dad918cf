"""Flipout estimator (Wen et al. 2018), counterpart of
``bayeformers_tpu/nn/flipout.py``.

Bayes-by-Backprop shares one weight draw across the whole batch; flipout
decorrelates the perturbation per example with Rademacher sign flips
around a shared Gaussian draw:

    y_b = x_b @ mu + ((x_b * r_b) @ (sigma * eps)) * s_b,   r_b, s_b = +-1

The perturbation matmul runs through the split op
``ops/sampled_linear.py::sampled_dense`` with ``mu = 0`` (Pallas #12 on the
card; its VJP rebuilds the draw with #13 and hands it to the dmu/drho
reduce). Each converted bias is drawn with its own signs.

The KL term is analytic (:func:`analytic_leaf_kl`): the closed form
``gaussian_kl`` under a MOPED prior (centred on mu itself when mu is
frozen, on ``prior_mu`` when it trains), and under the scale mixture the
``kl_draws``-draw MC estimate ``mean(log_q - log_p)``: for the kernel
leaves one ``ops/logprob.py::sampled_logprobs_grouped`` call over all of
them a forward (one Pallas #11 launch on the card, and one launch of its
VJP, which rebuilds the draws in registers), for a bias its plain version,
as in ``nn/fused.py::bias_logprobs``.

Where the JAX package intercepts Flax module calls, the port's model hands
each converted ``Dense`` or ``Conv1D`` and each attention block to
:class:`FlipoutMC` (the models' ``mc=``), as it does to
``nn/fused.py::FusedMC``. A ``Conv1D`` (GPT-2, stored (out, in)) runs on
(in, out) copies of mu and rho, and its KL on a transposed ``prior_mu``,
as the JAX package's ``handle_dense(transposed=True)`` does
(``nn/flipout.py:54-64``, :153-168).

Draws, per converted kernel leaf i of the request's integer ``seed``: the
perturbation's S seeds ``derive_seed(seed, i, 0, s)`` and the mixture KL's
``derive_seed(seed, i, 1, t)`` on the unit stream; the signs r, s and the
bias's signs from ``torch.Generator``s seeded ``derive_seed(seed, i, 2)``,
``(seed, i, 3)`` and ``(seed, i, 5)``; the bias's eps and its KL draws from
the unit stream of ``derive_seed(seed, i, 4, s)`` and ``(seed, i, 6, t)``.
The JAX package's draws differ (another stream); tests inject them through
``eps_hook(path, what, shape)``, ``what`` one of ``"r"``, ``"s"``,
``"eps"`` (the perturbation's (S, K, N)), ``"kl"`` (the KL's
(kl_draws, K, N)), ``"bias_eps"``, ``"bias_s"`` and ``"bias_kl"``; (K, N)
is the (in, out) view for a ``Conv1D`` too.

A converted ``Conv`` (``CONV_RULE``; the reference's ``handle_conv``,
``nn/flipout.py:174-192``) runs the same perturbation on its im2col
patches (``nn/conv.py::lower_conv``) with mu and rho in the channel-major
(K, cout) view (``reorder``), which the ``"eps"`` draw's shape names, and
scores its KL on the stored ``(*kernel_size, cin, cout)`` leaf, whose
shape the ``"kl"`` draw takes (the sums do not depend on the layout). As
in the reference there is no embedding handler: a converted ``Embed``
runs at mu, is never marked seen, and the forward raises
(``nn/fused.py::check_converted_paths_seen``).
"""
from __future__ import annotations

import torch

from bayeformers_tpu_torch.core import distributions as dist
from bayeformers_tpu_torch.core.prior import MOPED_PRIOR_SIGMA
from bayeformers_tpu_torch.nn import conv as conv_lib
from bayeformers_tpu_torch.nn.fused import (
    SEP, MCBase, bias_logprobs, derive_seed, run_mc, transposed_view, unit_bias_eps)
from bayeformers_tpu_torch.ops import logprob as ops_logprob
from bayeformers_tpu_torch.ops import sampled_linear as ops_linear

KL_DRAWS = 4


def analytic_leaf_kl(bmodel, path: str, mu, rho, seeds=None, *, plain: bool = False,
                     eps=None, transposed: bool = False) -> torch.Tensor:
    """Per-leaf ``KL(q || prior)`` for the estimators with no sampled weight
    to score (flipout, local reparameterization): the closed form under a
    MOPED prior (centred on mu itself when mu is frozen, else on the leaf's
    ``prior_mu``, transposed where ``mu`` and ``rho`` are a ``Conv1D``'s
    (in, out) copies); under the scale mixture, the MC estimate ``mean(log_q
    - log_p)``: a kernel leaf over the draws of ``seeds`` (kl_draws,), or of
    an injected ``eps`` (kl_draws, K, N), through ``sampled_logprobs`` (its
    kernel on the card unless ``plain``); a bias leaf (1-D) over its draws
    ``eps`` (kl_draws, N), in plain torch."""
    spec = bmodel.spec
    sigma = dist.sigma_from_rho(rho)
    if spec.moped:
        centre = mu
        if not spec.frozen:
            centre = bmodel.prior_mu[path].t() if transposed else bmodel.prior_mu[path]
        return dist.gaussian_kl(mu, sigma, centre, MOPED_PRIOR_SIGMA)
    mixture = (spec.prior.pi, spec.prior.sigma1, spec.prior.sigma2)
    if mu.dim() == 1:
        b = mu[None] + sigma[None] * eps
        lq, lp = bias_logprobs(b, sigma, eps, ("mixture",) + mixture)
    else:
        lq, lp = ops_logprob.sampled_logprobs(mu, rho, seeds, mixture=mixture,
                                              plain=plain, eps=eps)
    return torch.mean(lq - lp)


def rademacher(seed: int, shape, device, dtype) -> torch.Tensor:
    """+-1 of ``shape`` from a ``torch.Generator`` seeded with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    bits = torch.randint(0, 2, shape, generator=gen, device=device, dtype=torch.int8)
    return (bits * 2 - 1).to(dtype)


class AnalyticKLMC(MCBase):
    """What the analytic-KL tiers (flipout, local reparameterization) share:
    the request's seed, each converted leaf's KL collected once per forward
    (:func:`analytic_leaf_kl`; under the mixture the kernel leaves' in one
    grouped call, :meth:`deferred_kl`) and the aux. Under the scale mixture
    each kernel leaf i's KL draws come from the seeds ``derive_seed(seed,
    i, 1, t)`` and its bias's from ``derive_seed(seed, i, 6, t)``, uploaded
    once per request; under MOPED the KL is closed-form and nothing is
    drawn."""

    def __init__(self, bmodel, seed: int, n_samples: int, *, kl_draws: int = KL_DRAWS,
                 impl: str = "kernel", eps_hook=None):
        super().__init__(bmodel, n_samples, impl, eps_hook)
        self.seed = seed
        self.kl_draws = kl_draws
        self.needs_draws = not bmodel.spec.moped
        self.kl_terms: list[torch.Tensor] = []
        # the mixture's kernel leaves: (slot in kl_terms, mu, rho, seeds, eps)
        self.deferred: list[tuple] = []
        self.kl_seeds, self.bias_kl_eps = None, {}
        if self.needs_draws:
            self.kl_seeds = self.seed_table(((1, kl_draws), (6, kl_draws)))
            if eps_hook is None:
                self.bias_kl_eps = self.bias_draws(self.kl_seeds[:, kl_draws:])

    def seed_table(self, streams) -> torch.Tensor:
        """(n_leaves, sum of counts) int32 on the device: for each
        ``(stream, count)`` the leaf i's seeds ``derive_seed(seed, i, stream,
        t)``, t < count, side by side."""
        return torch.tensor(
            [[derive_seed(self.seed, i, stream, t) for stream, n in streams
              for t in range(n)] for i in range(len(self.paths))],
            dtype=torch.int32).to(self.bmodel.device)

    def bias_draws(self, columns: torch.Tensor) -> dict[str, torch.Tensor]:
        """Every converted bias's eps in one batched draw from its kernel
        leaf's row of the seed ``columns`` (n_leaves, n)."""
        bpaths = self.bias_paths()
        if not bpaths:
            return {}
        rows = columns[[self.path_index[p.rsplit(SEP, 1)[0] + SEP + "kernel"]
                        for p in bpaths]]
        widths = [self.bmodel.rho[p].shape[0] for p in bpaths]
        return dict(zip(bpaths, unit_bias_eps(rows.contiguous(), widths)))

    def _draw(self, path, what, shape, make):
        if self.eps_hook is not None:
            return self.eps_hook(path, what, shape).to(self.bmodel.device)
        return make()

    def kernel_kl(self, kpath, i, mu, rho, transposed: bool = False, stored=None) -> None:
        """Collect a kernel leaf's KL once per forward; ``transposed``: ``mu``
        and ``rho`` are a ``Conv1D``'s (in, out) copies; ``stored``: a
        ``Conv``'s (mu, rho) in their stored shape, of which ``mu`` and
        ``rho`` are the (K, N) views. Under MOPED its closed form now (on
        the stored leaf); under the mixture the leaf's (K, N) ``(mu, rho)``
        and KL draws (its seeds, or the hook's ``"kl"``, drawn in the stored
        shape and viewed as (K, N)) are recorded in its place among the
        terms, and :meth:`aux` scores every such leaf in one grouped
        call."""
        if kpath in self.seen:
            return
        self.seen.add(kpath)
        if not self.needs_draws:
            m, r = (mu, rho) if stored is None else stored
            self.kl_terms.append(analytic_leaf_kl(self.bmodel, kpath, m, r,
                                                  transposed=transposed))
            return
        kd = self.kl_draws
        eps = seeds = None
        if self.eps_hook is not None:
            shape = tuple((mu if stored is None else stored[0]).shape)
            eps = self._draw(kpath, "kl", (kd,) + shape, None)
            if stored is not None:
                eps = conv_lib.reorder(eps, lead=1)
        else:
            seeds = self.kl_seeds[i][:kd]
        self.deferred.append((len(self.kl_terms), mu, rho, seeds, eps))
        self.kl_terms.append(None)

    def deferred_kl(self) -> None:
        """Every recorded kernel leaf's mixture KL, ``mean(log_q - log_p)``
        over its draws, from one ``sampled_logprobs_grouped`` call (one
        kernel launch on the card, one for its VJP), each put in its leaf's
        place among the terms."""
        if not self.deferred:
            return
        slots, mus, rhos, seeds, eps = zip(*self.deferred)
        spec = self.bmodel.spec.prior
        lq, lp = ops_logprob.sampled_logprobs_grouped(
            mus, rhos, seeds, mixture=(spec.pi, spec.sigma1, spec.sigma2), plain=self.plain,
            eps=None if self.eps_hook is None else eps)
        for j, slot in enumerate(slots):
            self.kl_terms[slot] = torch.mean(lq[j] - lp[j])
        self.deferred = []

    def bias_kl(self, bpath, bmu, brho) -> None:
        """Collect a bias leaf's KL once per forward, in plain torch."""
        if bpath in self.seen:
            return
        self.seen.add(bpath)
        eps = None
        if self.needs_draws:
            eps = self._draw(bpath, "bias_kl", (self.kl_draws, bmu.shape[0]),
                             lambda: self.bias_kl_eps[bpath])
        self.kl_terms.append(analytic_leaf_kl(self.bmodel, bpath, bmu, brho, eps=eps))

    def aux(self) -> dict[str, torch.Tensor]:
        self.check_seen(self.kl_terms)
        self.deferred_kl()
        return kl_aux(torch.stack(self.kl_terms).sum(), self.S)


class FlipoutMC(AnalyticKLMC):
    """The state of one flipout S-sample forward, handed to every module's
    ``forward(..., mc)``."""

    tier = "flipout"

    def __init__(self, bmodel, seed: int, n_samples: int, **kwargs):
        super().__init__(bmodel, seed, n_samples, **kwargs)
        S = n_samples
        # every leaf's perturbation seeds and its bias's, uploaded once per request
        self.seeds = self.seed_table(((0, S), (4, S)))
        self.bias_eps = {} if self.eps_hook is not None else self.bias_draws(self.seeds[:, S:])

    def _signs(self, path, what, i, stream, shape, dtype):
        return self._draw(path, what, shape, lambda: rademacher(
            derive_seed(self.seed, i, stream), shape, self.bmodel.device, dtype)).to(dtype)

    def _flip_core(self, kpath, i, mu, rho, xs):
        """The flipout product over ``xs`` (S, M, K) of a kernel whose (K,
        N) ``mu`` and ``rho`` define the perturbation's draw (the
        reference's ``_flip_core``), then the layer's bias."""
        S, M, K = xs.shape
        N = mu.shape[1]
        r = self._signs(kpath, "r", i, 2, (S, M, K), xs.dtype)
        s_out = self._signs(kpath, "s", i, 3, (S, M, N), xs.dtype)
        eps = None if self.eps_hook is None else self._draw(kpath, "eps", (S, K, N), None)
        pert = ops_linear.sampled_dense((xs * r).contiguous(), torch.zeros_like(mu), rho,
                                        self.seeds[i][:S], plain=self.plain, eps=eps)
        return torch.matmul(xs, mu.to(xs.dtype)) + pert * s_out

    def _bias(self, y, mod, i, M):
        bpath = mod.path + SEP + "bias"
        if bpath in self.bmodel.rho:
            return self._add_bias(y, mod, bpath, i, M)
        return mod.add_bias(y)

    def dense(self, mod, x: torch.Tensor) -> torch.Tensor:
        """A converted ``Dense`` or ``Conv1D`` over an S-major (S*B, ..., K)
        input."""
        kpath = mod.path + SEP + "kernel"
        if kpath not in self.bmodel.rho:
            return mod(x)
        i = self.path_index[kpath]
        mu, rho = transposed_view(mod, self.bmodel.rho[kpath])
        lead = tuple(x.shape[:-1])
        xs = x.reshape(self.S, -1, x.shape[-1])
        y = self._flip_core(kpath, i, mu, rho, xs)
        self.kernel_kl(kpath, i, mu, rho, mod.transposed)
        return self._bias(y, mod, i, xs.shape[1]).reshape(lead + (mu.shape[1],))

    def conv(self, mod, x: torch.Tensor) -> torch.Tensor:
        """A converted ``Conv`` over an S-major (S*B, *spatial, cin) input:
        the perturbation on its im2col patches, the KL on the stored
        leaf."""
        kpath = mod.path + SEP + "kernel"
        if kpath not in self.bmodel.rho:
            return mod(x)
        kpath, patches, out_spatial = conv_lib.lower_conv(mod, x)
        i = self.path_index[kpath]
        mu4, rho4 = mod.kernel, self.bmodel.rho[kpath]
        mu, rho = conv_lib.reorder(mu4), conv_lib.reorder(rho4)
        xs = patches.reshape(self.S, -1, patches.shape[-1])
        y = self._flip_core(kpath, i, mu, rho, xs)
        self.kernel_kl(kpath, i, mu, rho, stored=(mu4, rho4))
        y = self._bias(y, mod, i, xs.shape[1])
        return y.reshape((x.shape[0],) + out_spatial + (mu.shape[1],))

    def _add_bias(self, y, mod, bpath, i, M):
        bmu, brho = mod.bias, self.bmodel.rho[bpath]
        S, N = self.S, bmu.shape[0]
        bsig = dist.sigma_from_rho(brho)
        beps = self._draw(bpath, "bias_eps", (S, N), lambda: self.bias_eps[bpath])
        bs = self._signs(bpath, "bias_s", i, 5, (S, M, N), torch.float32)
        y = (y.float() + bmu[None, None, :] + (bsig[None] * beps)[:, None, :] * bs
             ).to(y.dtype)
        self.bias_kl(bpath, bmu, brho)
        return y


def kl_aux(kl: torch.Tensor, n_samples: int) -> dict[str, torch.Tensor]:
    """The aux of the analytic-KL tiers: ``kl``, and ``(-kl, 0)`` shaped
    (S,) as ``log_prior`` / ``log_variational_posterior``, so that the ELBO
    plumbing (``elbo.elbo_loss``) works unchanged."""
    return {"kl": kl, "log_prior": (-kl).expand(n_samples),
            "log_variational_posterior": torch.zeros(n_samples, dtype=torch.float32,
                                                     device=kl.device)}


def flipout_mc_apply(bmodel, seed: int, n_samples: int, *args, kl_draws: int = KL_DRAWS,
                     impl: str = "kernel", eps_hook=None, untile_axes: tuple[int, ...] = (),
                     **inputs):
    """S flipout forwards as one S-major super-batched pass over the model's
    inputs (``nn/fused.py::run_mc``). Returns ``(outputs (S, B, ...), aux)``
    with aux ``kl`` (the analytic KL summed over the converted leaves) and
    ``log_prior`` / ``log_variational_posterior`` ``(-kl, 0)`` of shape
    (S,)."""
    mc = FlipoutMC(bmodel, seed, n_samples, kl_draws=kl_draws, impl=impl,
                   eps_hook=eps_hook)
    return run_mc(mc, n_samples, *args, untile_axes=untile_axes, **inputs)
