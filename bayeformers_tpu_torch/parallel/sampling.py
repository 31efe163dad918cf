"""The sampling contract that the stacked tiers share.

Every projection of ``BlockStack``, ``BayesMoE`` and ``TransformerStack``
is one sampled dense (:func:`bayes_dense`): the weight through
``ops/fused_linear.py::bayes_linear`` with independent draws, S = 1 a
call, the scale-mixture prior and ``save_weights=True`` (on a CUDA tensor
kernels #7/#8 forward and #9 backward), then a sampled bias.

A projection's draw is a pure function of the draw's integer seed and the
projection's path of integers, never of the activation, the microbatch or
the routing: the weight's kernel seed is ``derive_seed(seed, *path, 0)``
and the bias's eps comes from a ``torch.Generator`` on the activation's
device seeded with ``derive_seed(seed, *path, 1)``. The paths are those of
the reference's key folds (``fold_in(key, global_idx)``, then
``fold_in(bkey, j)``, the bias from ``fold_in(skey, 1)``): a block ``(l,)``
(BlockStack), an expert's two projections ``(e, j)`` (BayesMoE), a
transformer block's four ``(l, j)`` and its experts' ``(l, 2, e, j)``. The
S draws of a step take the seeds :func:`draw_seeds` (the reference's
``jax.random.split(key, S)``).

:func:`eps_hook` installs a function ``hook(seed, path, what, shape)``
(``what`` is ``"kernel"``, shape (K, N), or ``"bias"``, shape (N,)) that
supplies the draws instead (tests: the JAX package's draws); each sampled
dense then runs the plain version of the op.

Across ranks (``pipeline.make_pp_mesh``, ``moe.make_ep_mesh``) a stacked
module keeps only its rank's block of the stacked axis
(``mesh.shard_params``, which the pipeline's ``shard_stack`` and the
experts' ``shard_experts`` call); its ``n_shards`` says into how many
blocks it was cut, and :func:`check_group` holds a step's group to it.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from bayeformers_tpu_torch.core import distributions as dist
from bayeformers_tpu_torch.core import prior as prior_lib
from bayeformers_tpu_torch.core.init import DEFAULT_UNIFORM
from bayeformers_tpu_torch.nn.fused import derive_seed
from bayeformers_tpu_torch.ops import fused_linear as ops_fused
from bayeformers_tpu_torch.ops.logprob import mixture_log_pdf
from bayeformers_tpu_torch.parallel import collectives as coll

_PRIOR = prior_lib.DEFAULT_SCALE_MIXTURE
MIXTURE = (_PRIOR.pi, _PRIOR.sigma1, _PRIOR.sigma2)

_hook: Optional[Callable] = None


@contextlib.contextmanager
def eps_hook(hook: Callable):
    """Within the context every sampled dense takes its draws from
    ``hook(seed, path, what, shape)``."""
    global _hook
    prev, _hook = _hook, hook
    try:
        yield
    finally:
        _hook = prev


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh form."""
    return F.gelu(x, approximate="tanh")


def draw_seeds(seed: int, n_samples: int) -> list[int]:
    """The seeds of a step's ``n_samples`` draws."""
    return [derive_seed(seed, s) for s in range(n_samples)]


def check_group(group, module, what: str) -> Optional[coll.Ranks]:
    """The rank's place for a step over ``module``: None (one rank) for a
    group of None or of one, else the :class:`collectives.Ranks` of
    ``make_pp_mesh`` / ``make_ep_mesh``. A group of another size than the
    number of shards ``module`` was cut into raises ``ValueError``."""
    size, shards = coll.group_size(group), getattr(module, "n_shards", 1)
    if size != shards:
        raise ValueError(
            f"{what}: a group of {size} ranks, but the module is cut into {shards} "
            "shard(s); shard it for this mesh (pipeline.shard_stack, moe.shard_experts)")
    if size == 1:
        return None
    if not isinstance(group, coll.Ranks):
        raise TypeError(f"{what}: pass the Ranks of make_pp_mesh / make_ep_mesh as group, "
                        f"not a {type(group).__name__}")
    return group


def bayes_dense(h: torch.Tensor, mu, rho, b_mu, b_rho, seed: int, path: tuple,
                plain: bool = False):
    """One sampled dense on ``h`` (N, K): ``(y (N, N_out), log_q, log_p)``,
    the log-probs 0-d (weight and bias). ``plain=True`` runs the op's plain
    version on the tensors' device (the card's reference for the
    kernels)."""
    eps = b_eps = None
    if _hook is not None:
        eps = _hook(seed, path, "kernel", tuple(mu.shape))[None].to(mu.device)
        b_eps = _hook(seed, path, "bias", tuple(b_mu.shape)).to(b_mu.device)
        plain = True
    seeds = torch.tensor([derive_seed(seed, *path, 0)], dtype=torch.int32, device=h.device)
    y, lq, lp = ops_fused.bayes_linear(h[None], mu, rho, seeds, mixture=MIXTURE,
                                       eps=eps, plain=plain)
    if b_eps is None:
        gen = torch.Generator(device=b_mu.device).manual_seed(derive_seed(seed, *path, 1))
        b_eps = torch.randn(tuple(b_mu.shape), generator=gen, device=b_mu.device)
    b_sig = dist.sigma_from_rho(b_rho)
    b = b_mu + b_sig * b_eps
    log_q = lq[0] + torch.sum(-dist.LOG_SQRT_2PI - torch.log(b_sig) - 0.5 * b_eps * b_eps)
    log_p = lp[0] + torch.sum(mixture_log_pdf(b, *MIXTURE))
    return y[0] + b[None].to(y.dtype), log_q, log_p


def stacked_uniform(generator: torch.Generator, shape, device):
    """(mu, rho) of the reference's ``DEFAULT_UNIFORM`` as parameters."""
    mu, rho = DEFAULT_UNIFORM(generator, shape, torch.float32, device)
    return torch.nn.Parameter(mu), torch.nn.Parameter(rho)
