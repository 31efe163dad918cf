"""The naive tier, counterpart of ``BayesianModel.mc_apply`` in
``bayeformers_tpu/nn/surgery.py``: S Monte-Carlo forwards, each on its own
draw of every converted leaf, run as one S-major super-batch with
per-sample (S, K, N) weights, which computes what the reference's vmap of
``apply`` over S keys computes. Leaf i draws its S samples with
``sample_gaussian`` from a ``torch.Generator`` seeded ``derive_seed(seed,
i)`` and scores them in plain torch (``BayesianModel.prior_log_prob``); the
products are ``torch.bmm``, as they are XLA in the JAX package, so no
Bayesian linear kernel runs, and attention runs its kernels. A converted
``Conv`` or ``Embed`` draws its leaf in the stored orientation too
(``(*kernel_size, cin, cout)``, ``(V, D)``): the eps hook names those
shapes.
"""
from __future__ import annotations

import torch

from bayeformers_tpu_torch.core import distributions as dist
from bayeformers_tpu_torch.models.bert import lookup
from bayeformers_tpu_torch.nn import conv as conv_lib
from bayeformers_tpu_torch.nn.fused import SEP, MCBase, derive_seed, run_mc


class NaiveMC(MCBase):
    """The state of one naive-tier S-sample forward (:meth:`BayesianModel.
    mc_apply`), handed to every module's ``forward(..., mc)``: each converted
    ``Dense`` draws its (S, K, N) weights and (S, N) bias and runs the
    per-sample products."""

    tier = "naive"

    def __init__(self, bmodel, seed: int, n_samples: int, *, impl: str = "kernel",
                 eps_hook=None):
        super().__init__(bmodel, n_samples, impl, eps_hook)
        self.seed = seed
        self.collected: list[tuple[torch.Tensor, torch.Tensor]] = []

    def _sample(self, path: str, mu, rho):
        """Leaf ``path``'s (S, *shape) weights, scored: ``(w, log_q, log_p)``
        with log-probs of shape (S,)."""
        dims = tuple(range(1, mu.dim() + 1))
        if self.eps_hook is not None:
            eps = self.eps_hook(path, tuple(mu.shape)).to(mu.device)
            w = mu + dist.sigma_from_rho(rho) * eps
        else:
            gen = torch.Generator(device=mu.device).manual_seed(
                derive_seed(self.seed, self.path_index[path]))
            w, _ = dist.sample_gaussian(gen, mu, rho, n_samples=self.S)
        lq = dist.gaussian_log_prob(w, mu, dist.sigma_from_rho(rho), dim=dims)
        return w, lq, self.bmodel.prior_log_prob(path, w, dim=dims)

    def _leaf(self, path, mu, rho):
        w, lq, lp = self._sample(path, mu, rho)
        if path not in self.seen:
            self.seen.add(path)
            self.collected.append((lq, lp))
        return w

    def dense(self, mod, x: torch.Tensor) -> torch.Tensor:
        """A converted ``Dense`` or ``Conv1D`` over an S-major (S*B, ..., K)
        input, with the arithmetic of ``Dense.forward`` on each sample's
        weights; a ``Conv1D``'s are drawn in its stored (out, in)
        orientation, as ``bmodel.sample`` draws every leaf."""
        kpath = mod.path + SEP + "kernel"
        if kpath not in self.bmodel.rho:
            return mod(x)
        lead, K = tuple(x.shape[:-1]), x.shape[-1]
        xs = x.reshape(self.S, -1, K)
        w = self._leaf(kpath, mod.kernel, self.bmodel.rho[kpath]).to(x.dtype).float()
        y = torch.bmm(xs.float(), w.transpose(1, 2) if mod.transposed else w).to(x.dtype)
        bpath = mod.path + SEP + "bias"
        if bpath in self.bmodel.rho:
            y = y + self._leaf(bpath, mod.bias, self.bmodel.rho[bpath])[:, None, :].to(x.dtype)
        else:
            y = mod.add_bias(y)
        return y.reshape(lead + (y.shape[-1],))

    def conv(self, mod, x: torch.Tensor) -> torch.Tensor:
        """A converted ``Conv`` over an S-major (S*B, *spatial, cin) input:
        its (S, *kernel_size, cin, cout) weights drawn in the stored
        orientation, as ``bmodel.sample`` draws every leaf, and each
        sample's im2col patches times its own ``reorder``-ed kernel."""
        kpath = mod.path + SEP + "kernel"
        if kpath not in self.bmodel.rho:
            return mod(x)
        kpath, patches, out_spatial = conv_lib.lower_conv(mod, x)
        w = self._leaf(kpath, mod.kernel, self.bmodel.rho[kpath]).to(x.dtype).float()
        xs = patches.reshape(self.S, -1, patches.shape[-1])
        y = torch.bmm(xs.float(), conv_lib.reorder(w, lead=1)).to(x.dtype)
        bpath = mod.path + SEP + "bias"
        if bpath in self.bmodel.rho:
            y = y + self._leaf(bpath, mod.bias, self.bmodel.rho[bpath])[:, None, :].to(x.dtype)
        else:
            y = mod.add_bias(y)
        return y.reshape((x.shape[0],) + out_spatial + (y.shape[-1],))

    def embed(self, mod, ids: torch.Tensor) -> torch.Tensor:
        """A converted ``Embed`` over S-major (S*B, ...) ids: its (S, V, D)
        tables drawn whole, each sample's ids looked up in its own."""
        epath = mod.path + SEP + "embedding"
        if epath not in self.bmodel.rho:
            return mod(ids)
        tables = self._leaf(epath, mod.embedding, self.bmodel.rho[epath])
        V, D = mod.embedding.shape
        ids_s = ids.reshape(self.S, -1)
        offset = torch.arange(self.S, device=ids.device)[:, None] * V
        out = lookup(tables.reshape(self.S * V, D), ids_s + offset)
        return out.reshape(tuple(ids.shape) + (D,))

    def embed_unbatched(self, mod, ids: torch.Tensor) -> torch.Tensor:
        """A lookup shared by every example (``Embed.lookup_shared``): each
        sample's ids in its own (V, D) table, (S, *ids.shape, D), as the
        reference's vmap over whole draws looks them up."""
        epath = mod.path + SEP + "embedding"
        if epath not in self.bmodel.rho:
            return mod(ids)[None]
        tables = self._leaf(epath, mod.embedding, self.bmodel.rho[epath])
        V, D = mod.embedding.shape
        offset = torch.arange(self.S, device=ids.device).reshape((self.S,) + (1,) * ids.dim())
        return lookup(tables.reshape(self.S * V, D), ids[None] + offset * V)

    def tied_table(self, mod):
        """The table a tied head reads: each sample's (V, D) draw of a
        converted table, (S, V, D) (the reference's vmap reads the drawn
        parameter), else mu."""
        epath = mod.path + SEP + "embedding"
        if epath not in self.bmodel.rho:
            return mod.embedding
        return self._leaf(epath, mod.embedding, self.bmodel.rho[epath])

    def aux(self) -> dict[str, torch.Tensor]:
        self.check_seen(self.collected)
        return {"log_prior": torch.stack([lp for _, lp in self.collected]).sum(0),
                "log_variational_posterior": torch.stack(
                    [lq for lq, _ in self.collected]).sum(0)}


def naive_mc_apply(bmodel, seed: int, n_samples: int, *args, impl: str = "kernel",
                   eps_hook=None, untile_axes: tuple[int, ...] = (), **inputs):
    """S naive-tier forwards as one S-major super-batched pass over the
    model's inputs (``nn/fused.py::run_mc``). Returns ``(outputs (S, B,
    ...), aux)`` with aux's ``log_prior`` / ``log_variational_posterior`` of
    shape (S,)."""
    mc = NaiveMC(bmodel, seed, n_samples, impl=impl, eps_hook=eps_hook)
    return run_mc(mc, n_samples, *args, untile_axes=untile_axes, **inputs)
