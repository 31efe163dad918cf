"""Local reparameterization estimator (Kingma, Salimans & Welling 2015),
counterpart of ``bayeformers_tpu/nn/lrt.py``.

For a Gaussian-posterior linear layer the pre-activations given the input
are Gaussian themselves,

    y ~ N(x @ mu + b_mu, (x * x) @ sigma^2 + b_sigma^2),

so the estimator samples the activations: per layer two shared-weight
matmuls whatever S is (the mean, and the variance with f32 accumulation)
and an (S, tokens, N) f32 standard normal, ``y = m + sqrt(max(v, 0)) *
eps``. No weight is drawn, so the Bayesian linear kernels do not run; the
matmuls stay ``torch.matmul`` as they stay XLA in the JAX package. The KL
term is shared with flipout (``nn/flipout.py::analytic_leaf_kl``): the
closed form under MOPED, and under the scale mixture the ``kl_draws``-draw
MC estimate of all kernel leaves through one ``sampled_logprobs_grouped``
call a forward (one Pallas #11 launch on the card, one of its VJP).

Draws, per converted kernel leaf i of the request's integer ``seed``: the
activation noise from a ``torch.Generator`` seeded ``derive_seed(seed, i,
7)``, the mixture KL's as in flipout. Tests inject the JAX package's draws
through ``eps_hook(path, what, shape)``, ``what`` one of ``"eps"`` (the
(S, M, N) noise), ``"kl"`` and ``"bias_kl"``.

A ``Conv1D`` (GPT-2, stored (out, in)) runs on (in, out) copies of mu and
rho and its KL on a transposed ``prior_mu``, as the JAX package's
``handle_dense(transposed=True)`` (``nn/lrt.py:98-121``, :211-214). The
embed and conv branches (``handle_embed``, ``handle_conv``) are not ported
(ROADMAP queue 1: the other model families and their handlers).
"""
from __future__ import annotations

import torch

from bayeformers_tpu_torch.core import distributions as dist
from bayeformers_tpu_torch.nn.flipout import KL_DRAWS, AnalyticKLMC
from bayeformers_tpu_torch.nn.fused import SEP, derive_seed, run_mc, transposed_view


class LrtMC(AnalyticKLMC):
    """The state of one local-reparameterization S-sample forward, handed to
    every module's ``forward(..., mc)``; its KL is flipout's."""

    tier = "lrt"

    def dense(self, mod, x: torch.Tensor) -> torch.Tensor:
        """A converted ``Dense`` or ``Conv1D`` over an S-major (S*B, ..., K)
        input."""
        kpath = mod.path + SEP + "kernel"
        if kpath not in self.bmodel.rho:
            return mod(x)
        i = self.path_index[kpath]
        S = self.S
        mu, rho = transposed_view(mod, self.bmodel.rho[kpath])
        sigma = dist.sigma_from_rho(rho)
        lead, K = tuple(x.shape[:-1]), x.shape[-1]
        N = mu.shape[1]
        xs = x.reshape(S, -1, K)
        M = xs.shape[1]
        m = torch.matmul(xs, mu.to(xs.dtype))
        # the variance: operands in x's dtype, products accumulated in f32
        v = torch.matmul((xs * xs).float(), (sigma * sigma).to(xs.dtype).float())
        self.kernel_kl(kpath, i, mu, rho, mod.transposed)
        bpath = mod.path + SEP + "bias"
        if bpath in self.bmodel.rho:
            bmu, brho = mod.bias, self.bmodel.rho[bpath]
            bsig = dist.sigma_from_rho(brho)
            m = m + bmu.to(m.dtype)
            # the bias draw is Gaussian and independent: exact fold into v
            v = v + bsig * bsig
            self.bias_kl(bpath, bmu, brho)
        else:
            m = mod.add_bias(m)
        dev = self.bmodel.device
        eps = self._draw(kpath, "eps", (S, M, N), lambda: torch.randn(
            (S, M, N), generator=torch.Generator(device=dev).manual_seed(
                derive_seed(self.seed, i, 7)), device=dev))
        y = m + (torch.sqrt(torch.clamp_min(v, 0.0)) * eps).to(m.dtype)
        return y.reshape(lead + (N,))


def lrt_mc_apply(bmodel, seed: int, n_samples: int, input_ids, attention_mask=None,
                 token_type_ids=None, *, kl_draws: int = KL_DRAWS, impl: str = "kernel",
                 eps_hook=None):
    """S local-reparameterization forwards as one S-major super-batched pass.
    Returns ``(outputs (S, B, ...), aux)`` with aux ``kl`` and ``log_prior``
    / ``log_variational_posterior`` ``(-kl, 0)`` of shape (S,)."""
    mc = LrtMC(bmodel, seed, n_samples, kl_draws=kl_draws, impl=impl, eps_hook=eps_hook)
    return run_mc(mc, n_samples, input_ids, attention_mask, token_type_ids)
