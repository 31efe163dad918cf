"""Hand-built Bayesian layers (counterpart of ``bayeformers_tpu/nn/layers.py``,
the reference's ``bayeformers.nn`` zoo: ``bnn.Linear`` and
``Model.log_prior()``, reference ``README.md:34-56``).

:class:`BayesLinear` is an ``nn.Module`` with Gaussian variational ``mu``
and ``rho`` parameters (the reference's ``Uniform((-0.2, 0.2), (-5, -4))``
init) under the default scale-mixture prior. Each call draws fresh weights
and routes through ``ops/fused_linear.py::bayes_linear`` with independent
draws: on a CUDA tensor the forward is kernels #7/#8 (``bft_bayes_linear``)
and the backward the reduce #9 (``bft_reduce_abuv``); on a CPU tensor their
plain versions. Each call records its ``log_prior`` and
``log_variational_posterior`` (S,); :func:`collect_kl` sums them model-wide
and :func:`bayes_apply` runs a module with a generator and returns both.

The draws come from an explicit ``torch.Generator`` (or an int seed): the
weights' kernel seeds and the bias's eps, in that order, as the JAX layer
takes two keys from its ``'bayes'`` stream. The generator is passed to the
call, or to :func:`bayes_apply`, which lends it to every layer of the
module; a call with neither raises, as the JAX layer does without its RNG.

Sample axis: with ``sample_axis=True`` the input carries a leading MC axis
``(S, ..., K)`` and each sample gets its own weights in one launch; with
the default ``sample_axis=False`` a call takes ``(..., K)`` and draws one
weight set (S = 1), the reference's per-forward sampling.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch
from torch import nn

from bayeformers_tpu_torch.core import distributions as dist
from bayeformers_tpu_torch.core import init as init_lib
from bayeformers_tpu_torch.core import prior as prior_lib
from bayeformers_tpu_torch.ops import fused_linear as ops_fused
from bayeformers_tpu_torch.ops.logprob import mixture_log_pdf

Generator = Union[torch.Generator, int]


def as_generator(generator: Generator) -> torch.Generator:
    """A ``torch.Generator``: itself, or a CPU generator seeded with an int."""
    if isinstance(generator, torch.Generator):
        return generator
    return torch.Generator().manual_seed(int(generator))


class BayesLinear(nn.Module):
    """Bayesian dense layer ``y = x @ (mu + softplus(rho) eps) + b``, ``b``
    sampled likewise from ``(bias_mu, bias_rho)`` when ``use_bias``.

    ``mu`` and ``rho`` are (in, out), the orientation of the eps stream;
    they are drawn at construction from ``generator`` (a
    ``torch.Generator`` or an int seed) by ``initialization``. Parameters
    stay float32; y takes x's dtype (bf16 or f32 on the card)."""

    def __init__(self, in_features: int, out_features: int, *, use_bias: bool = True,
                 initialization: init_lib.UniformInit = init_lib.DEFAULT_UNIFORM,
                 prior: prior_lib.ScaleMixturePrior = prior_lib.DEFAULT_SCALE_MIXTURE,
                 sample_axis: bool = False, generator: Generator = 0, device=None):
        super().__init__()
        gen = as_generator(generator)
        self.in_features, self.out_features = in_features, out_features
        self.prior = prior
        self.sample_axis = sample_axis
        mu, rho = initialization(gen, (in_features, out_features), torch.float32, device)
        self.mu, self.rho = nn.Parameter(mu), nn.Parameter(rho)
        self.use_bias = use_bias
        if use_bias:
            b_mu, b_rho = initialization(gen, (out_features,), torch.float32, device)
            self.bias_mu, self.bias_rho = nn.Parameter(b_mu), nn.Parameter(b_rho)
        self.kl_terms: list[tuple[torch.Tensor, torch.Tensor]] = []
        self.lent_generator: Optional[torch.Generator] = None

    @property
    def mixture(self) -> tuple[float, float, float]:
        return (self.prior.pi, self.prior.sigma1, self.prior.sigma2)

    def forward(self, x: torch.Tensor, generator: Optional[Generator] = None, *,
                eps: Optional[torch.Tensor] = None,
                bias_eps: Optional[torch.Tensor] = None,
                plain: bool = False) -> torch.Tensor:
        """One stochastic forward; records ``(log_q, log_p)`` of shape (S,)
        in :attr:`kl_terms`. ``eps`` (S, K, N) and ``bias_eps`` (S, N)
        inject the draws (tests; ``eps`` runs the plain version);
        ``plain=True`` runs the plain versions of both passes on the
        tensors' device (the reference for the kernels on the card)."""
        if generator is None:
            generator = self.lent_generator
        if generator is None and (eps is None or (self.use_bias and bias_eps is None)):
            raise ValueError("BayesLinear needs a generator: pass one to the call or "
                             "run the module through bayes_apply")
        K, N = self.in_features, self.out_features
        lead = tuple(x.shape[:-1])
        S = x.shape[0] if self.sample_axis else 1
        xs = x.reshape(S, -1, K)
        gen = None if generator is None else as_generator(generator)
        if gen is not None:
            seeds = torch.randint(0, 2**31 - 1, (S,), generator=gen, device=gen.device)
            seeds = seeds.to(device=x.device, dtype=torch.int32)
        else:
            seeds = torch.zeros((S,), dtype=torch.int32, device=x.device)
        y, log_q, log_p = ops_fused.bayes_linear(xs.contiguous(), self.mu, self.rho, seeds,
                                                 mixture=self.mixture, eps=eps, plain=plain)
        if self.use_bias:
            if bias_eps is None:
                bias_eps = torch.randn((S, N), generator=gen, device=gen.device)
            b_eps = bias_eps.to(device=x.device, dtype=torch.float32)
            b_sig = dist.sigma_from_rho(self.bias_rho)
            b = self.bias_mu[None] + b_sig[None] * b_eps
            y = y + b[:, None, :].to(y.dtype)
            log_q = log_q + torch.sum(
                -dist.LOG_SQRT_2PI - torch.log(b_sig)[None] - 0.5 * b_eps * b_eps, dim=-1)
            log_p = log_p + torch.sum(mixture_log_pdf(b, *self.mixture), dim=-1)
        self.kl_terms.append((log_q, log_p))
        return y.reshape(lead + (N,))


def bayes_layers(module: nn.Module) -> list[BayesLinear]:
    return [m for m in module.modules() if isinstance(m, BayesLinear)]


def collect_kl(module: nn.Module) -> dict[str, torch.Tensor]:
    """The recorded log-probs of every :class:`BayesLinear` call in
    ``module``, summed model-wide (the reference's ``Model.log_prior()``):
    ``{"log_prior", "log_variational_posterior"}`` of shape (S,) (S = 1
    for layers without a sample axis), and clears the records. Raises when
    no call recorded any."""
    layers = bayes_layers(module)
    terms = [t for m in layers for t in m.kl_terms]
    for m in layers:
        m.kl_terms = []
    if not terms:
        raise ValueError("no Bayesian layers recorded KL terms in this forward")
    return {"log_prior": sum(lp for _, lp in terms),
            "log_variational_posterior": sum(lq for lq, _ in terms)}


@contextlib.contextmanager
def _lend(module: nn.Module, generator: torch.Generator):
    layers = bayes_layers(module)
    for m in layers:
        m.kl_terms = []
        m.lent_generator = generator
    try:
        yield
    finally:
        for m in layers:
            m.lent_generator = None


def bayes_apply(module: nn.Module, generator: Generator, *args, **kwargs):
    """Run a hand-built Bayesian module with ``generator`` (a
    ``torch.Generator`` or an int seed) lent to its layers; returns ``(out,
    {"log_prior", "log_variational_posterior"})`` from :func:`collect_kl`
    over this call's records."""
    with _lend(module, as_generator(generator)):
        out = module(*args, **kwargs)
    return out, collect_kl(module)
