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
``handle_dense(transposed=True)`` (``nn/lrt.py:98-121``, :211-214).

A converted ``Conv`` (``CONV_RULE``; ``handle_conv``, ``nn/lrt.py:140-179``)
takes the same two products on its im2col patches (``nn/conv.py``): mean
``patches @ mu``, variance ``patches^2 @ sigma^2`` with mu and sigma in the
channel-major (K, cout) view, and its KL on the stored leaf (the ``"kl"``
draw in that shape). A converted ``Embed`` (``EMBEDDING_RULE``;
``handle_embed``, :181-202) is its own pre-activation: each looked-up row
is ``mu[id] + sigma[id] * eps`` with fresh noise per occurrence (the
``"eps"`` draw of shape (S, ids a sample, D)), and the table's KL is a
kernel leaf's.
"""
from __future__ import annotations

import torch

from bayeformers_tpu_torch.core import distributions as dist
from bayeformers_tpu_torch.models.bert import lookup
from bayeformers_tpu_torch.nn import conv as conv_lib
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
        mu, rho = transposed_view(mod, self.bmodel.rho[kpath])
        lead = tuple(x.shape[:-1])
        y = self._local(mod, kpath, i, mu, rho, x.reshape(self.S, -1, x.shape[-1]),
                        mod.transposed)
        return y.reshape(lead + (mu.shape[1],))

    def conv(self, mod, x: torch.Tensor) -> torch.Tensor:
        """A converted ``Conv`` over an S-major (S*B, *spatial, cin) input:
        the two products on its im2col patches, the KL on the stored
        leaf."""
        kpath = mod.path + SEP + "kernel"
        if kpath not in self.bmodel.rho:
            return mod(x)
        kpath, patches, out_spatial = conv_lib.lower_conv(mod, x)
        mu4, rho4 = mod.kernel, self.bmodel.rho[kpath]
        mu, rho = conv_lib.reorder(mu4), conv_lib.reorder(rho4)
        xs = patches.reshape(self.S, -1, patches.shape[-1])
        y = self._local(mod, kpath, self.path_index[kpath], mu, rho, xs,
                        stored=(mu4, rho4))
        return y.reshape((x.shape[0],) + out_spatial + (mu.shape[1],))

    def embed(self, mod, ids: torch.Tensor) -> torch.Tensor:
        """A converted ``Embed`` over S-major (S*B, ...) ids: each looked-up
        row ``mu[id] + sigma[id] * eps``, fresh noise per occurrence (an
        (S, ids a sample, D) f32 normal from a ``torch.Generator`` seeded
        ``derive_seed(seed, i, 7)``), and the table's KL."""
        epath = mod.path + SEP + "embedding"
        if epath not in self.bmodel.rho:
            return mod(ids)
        i = self.path_index[epath]
        mu, rho = mod.embedding, self.bmodel.rho[epath]
        sigma = dist.sigma_from_rho(rho)
        ids_s = ids.reshape(self.S, -1)
        m, sg = lookup(mu, ids_s), lookup(sigma, ids_s)
        eps = self._noise(epath, i, tuple(m.shape))
        self.kernel_kl(epath, i, mu, rho)
        return (m + sg * eps.to(sg.dtype)).reshape(tuple(ids.shape) + (mu.shape[1],))

    def _noise(self, path, i, shape):
        dev = self.bmodel.device
        return self._draw(path, "eps", shape, lambda: torch.randn(
            shape, generator=torch.Generator(device=dev).manual_seed(
                derive_seed(self.seed, i, 7)), device=dev))

    def _local(self, mod, kpath, i, mu, rho, xs, transposed=False, stored=None):
        """The sampled pre-activation of a kernel in its (K, N) view over
        ``xs`` (S, M, K), with the layer's bias folded into mean and
        variance; ``transposed`` and ``stored`` as :meth:`kernel_kl` takes
        them."""
        S, M, K = xs.shape
        N = mu.shape[1]
        sigma = dist.sigma_from_rho(rho)
        m = torch.matmul(xs, mu.to(xs.dtype))
        # the variance: operands in x's dtype, products accumulated in f32
        v = torch.matmul((xs * xs).float(), (sigma * sigma).to(xs.dtype).float())
        self.kernel_kl(kpath, i, mu, rho, transposed, stored)
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
        eps = self._noise(kpath, i, (S, M, N))
        return m + (torch.sqrt(torch.clamp_min(v, 0.0)) * eps).to(m.dtype)


def lrt_mc_apply(bmodel, seed: int, n_samples: int, *args, kl_draws: int = KL_DRAWS,
                 impl: str = "kernel", eps_hook=None, untile_axes: tuple[int, ...] = (),
                 **inputs):
    """S local-reparameterization forwards as one S-major super-batched pass
    over the model's inputs (``nn/fused.py::run_mc``). Returns ``(outputs
    (S, B, ...), aux)`` with aux ``kl`` and ``log_prior`` /
    ``log_variational_posterior`` ``(-kl, 0)`` of shape (S,)."""
    mc = LrtMC(bmodel, seed, n_samples, kl_draws=kl_draws, impl=impl, eps_hook=eps_hook)
    return run_mc(mc, n_samples, *args, untile_axes=untile_axes, **inputs)
