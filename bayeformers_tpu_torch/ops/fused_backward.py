"""The dmu/drho reduce of the Bayesian linear backward.

Counterpart of ``bayeformers_tpu/ops/fused_backward.py``. Everything the
gradients of mu and rho need is three or four (K, N) accumulators. Over S
independent samples (:func:`reduce_abuv`, the counterpart of
``reduce_abuv`` / ``_xla_reduce``):

    p = x[s]^T g[s],  wc = W[s] - mu
    A = sum_s p,  B = sum_s p * wc
    U = sum_s g_p[s] * wc,       V = sum_s g_p[s] * wc^2       (Gaussian priors)
    U = sum_s g_p[s] * score(W[s]),  V = sum_s g_p[s] * score(W[s]) * wc
                                                               (mixture)

Over an interleaved antithetic batch (:func:`reduce_abuv_anti`, the
counterpart of ``reduce_abuv_anti`` / ``_xla_reduce_anti``), of which only
the even (+) members' weights are read (``w1 - mu = -(w0 - mu)``):

    p0 = x[2t]^T g[2t],  p1 = x[2t+1]^T g[2t+1],  wc = W[2t] - mu
    A = sum_t (p0 + p1),  B = sum_t (p0 - p1) * wc
    U = sum_t (g_p[2t] - g_p[2t+1]) * wc,  V = sum_t (g_p[2t] + g_p[2t+1]) * wc^2
    (mixture: s0 = score(mu + wc), s1 = score(mu - wc),
     U = sum_t g_p[2t] s0 + g_p[2t+1] s1,  V = sum_t (g_p[2t] s0 - g_p[2t+1] s1) * wc)

with ``score`` the mixture's (``ops/logprob.py::mixture_score``), taken on
the W the reduce is given: the saved residual (bf16 in bf16 runs) or the
regenerated f32 W. U is computed only when asked (``want_u``: every prior
but the one centred on mu, which never reads it); the reduce then returns
``(A, B, U, V)``, else ``(A, B, V)``. :func:`finalize` turns them into dmu
and drho with elementwise torch on (K, N) tensors, as XLA does it in the
reference.

Each reduce is a wrapper: a CPU tensor takes its plain version; a CUDA
tensor launches ``csrc/fused_backward.cu`` (``bft_reduce_abuv`` or
``bft_reduce_abuv_anti``) or raises. The kernel splits the walk over
(output tile, pair or sample, chunk of tokens) into equal contiguous
ranges, one per block of a grid that fills the card (:func:`plan_slices`);
each block writes partial A and B for the tiles it touches, and a second
pass sums them in block order and takes U and V. The plain mirror of that
decomposition is :func:`reduce_sliced_plain`. The kernel has an instance per prior
(centred on mu; Gaussian with U; mixture) and per pair of types of x and g
and of W: (bf16, bf16) behind the saved bf16 residual, (f32, f32) at f32
activations, and (bf16, f32) behind the regenerating backward at bf16,
which hands the reduce the regenerated f32 W as the reference does; the
launch counters key each launch by ``(M, K, N, tag)`` with tag ``"bf16"``,
``"f32"`` or ``"bf16x-f32w"``, followed by ``"/gaussian"`` or
``"/mixture"`` for those priors.
"""
from __future__ import annotations

import torch

import functools
from typing import NamedTuple

from bayeformers_tpu_torch.core.distributions import sigma_from_rho
from bayeformers_tpu_torch.core.prior import MOPED_PRIOR_SIGMA
from bayeformers_tpu_torch.ops import _build, common
from bayeformers_tpu_torch.ops.logprob import (
    ON_MU, PRIOR_CODE, PRIOR_TAG, mixture_constants, mixture_score, reduce_prior)

LAUNCHES = common.LaunchCounter("reduce_abuv_anti")
INDEP_LAUNCHES = common.LaunchCounter("reduce_abuv")


def _results(a, b, u, v, want_u: bool):
    return (a, b, u, v) if want_u else (a, b, v)


def _chunked(reduce, c: int, h: int, x, g, w, mu, g_p, mixture, want_u):
    """``reduce`` over chunks of ``c`` draws of ``h`` members each, and of
    columns where one draw alone is large (:func:`common.chunk_cols`); the
    chunks' accumulators added in order."""
    K, N = mu.shape
    nc = common.chunk_cols(K, N, h)
    total = None
    for i in range(0, x.shape[0], h * c):
        j = i + h * c
        part = [reduce(x[i:j], g[i:j, :, n:n + nc], w[i:j, :, n:n + nc], mu[:, n:n + nc],
                       g_p[i:j], mixture, want_u) for n in range(0, N, nc)]
        part = tuple(torch.cat(t, dim=1) for t in zip(*part))
        total = part if total is None else tuple(a + b for a, b in zip(total, part))
    return total


def reduce_abuv_plain(x, g, w, mu, g_p, mixture=None, want_u: bool = False):
    """Plain version (``_xla_reduce``): the per-sample products in f32 from
    the operands as given, W minus mu in f32. Returns ``(A, B, V)``, or
    ``(A, B, U, V)`` with ``want_u``, (K, N) f32 each; a W of many elements
    in chunks of draws and columns (:func:`_chunked`)."""
    reduce_prior(mixture, want_u)
    c = common.chunk_len(x.shape[0], w[0].numel())
    if c < x.shape[0] or common.chunk_cols(*mu.shape, 1) < mu.shape[1]:
        return _chunked(reduce_abuv_plain, c, 1, x, g, w, mu, g_p, mixture, want_u)
    dw = torch.bmm(x.float().transpose(1, 2), g.float())
    wc = w.float() - mu[None]
    a = torch.sum(dw, dim=0)
    b = torch.sum(dw * wc, dim=0)
    gp = g_p.float()[:, None, None]
    if mixture is None:
        u = torch.sum(gp * wc, dim=0) if want_u else None
        v = torch.sum(gp * wc * wc, dim=0)
    else:
        score = mixture_score(w.float(), *mixture)
        u = torch.sum(gp * score, dim=0)
        v = torch.sum(gp * score * wc, dim=0)
    return _results(a, b, u, v, want_u)


def reduce_abuv(x, g, w, mu, g_p, mixture=None, want_u: bool = False):
    """``(A, B, V)`` or, with ``want_u``, ``(A, B, U, V)`` for x (S, M, K),
    g (S, M, N), the sampled weights W (S, K, N), mu (K, N) and the
    log-prior cotangent g_p (S,); ``mixture=(pi, sigma1, sigma2)`` takes
    U and V of the mixture's score. A CPU tensor runs the plain version; a
    CUDA tensor the kernel."""
    if x.device.type == "cpu":
        return reduce_abuv_plain(x, g, w, mu, g_p, mixture, want_u)
    return reduce_abuv_cuda(x, g, w, mu, g_p, mixture, want_u)


def reduce_abuv_anti_plain(x, g, w, mu, g_p, mixture=None, want_u: bool = False):
    """Plain version (``_xla_reduce_anti``): the per-pair products in f32
    from the operands as given, W's even members minus mu in f32. Returns
    ``(A, B, V)``, or ``(A, B, U, V)`` with ``want_u``, (K, N) f32 each; a W
    of many elements in chunks of pairs and columns (:func:`_chunked`)."""
    reduce_prior(mixture, want_u)
    c = common.chunk_len(x.shape[0] // 2, 2 * w[0].numel())
    if c < x.shape[0] // 2 or common.chunk_cols(*mu.shape, 2) < mu.shape[1]:
        return _chunked(reduce_abuv_anti_plain, c, 2, x, g, w, mu, g_p, mixture, want_u)
    S, M, K = x.shape
    N = mu.shape[1]
    x2 = x.reshape(S // 2, 2, M, K).float()
    g2 = g.reshape(S // 2, 2, M, N).float()
    dw0 = torch.bmm(x2[:, 0].transpose(1, 2), g2[:, 0])
    dw1 = torch.bmm(x2[:, 1].transpose(1, 2), g2[:, 1])
    wc = w[0::2].float() - mu[None]
    gp2 = g_p.reshape(S // 2, 2).float()
    gp0, gp1 = gp2[:, 0, None, None], gp2[:, 1, None, None]
    a = torch.sum(dw0 + dw1, dim=0)
    b = torch.sum((dw0 - dw1) * wc, dim=0)
    if mixture is None:
        u = torch.sum((gp0 - gp1) * wc, dim=0) if want_u else None
        v = torch.sum((gp0 + gp1) * wc * wc, dim=0)
    else:
        score0 = mixture_score(mu[None] + wc, *mixture)
        score1 = mixture_score(mu[None] - wc, *mixture)
        u = torch.sum(gp0 * score0 + gp1 * score1, dim=0)
        v = torch.sum((gp0 * score0 - gp1 * score1) * wc, dim=0)
    return _results(a, b, u, v, want_u)


def reduce_abuv_anti(x, g, w, mu, g_p, mixture=None, want_u: bool = False):
    """``(A, B, V)`` or, with ``want_u``, ``(A, B, U, V)`` for x (S, M, K),
    g (S, M, N), the pair weights W (S, K, N), mu (K, N) and the log-prior
    cotangent g_p (S,); ``mixture`` as in :func:`reduce_abuv`. A CPU tensor
    runs the plain version; a CUDA tensor the kernel."""
    if x.device.type == "cpu":
        return reduce_abuv_anti_plain(x, g, w, mu, g_p, mixture, want_u)
    return reduce_abuv_anti_cuda(x, g, w, mu, g_p, mixture, want_u)


class SlicePlan(NamedTuple):
    """The reduce kernel's split: ``n_blocks`` blocks share the ``total =
    n_tiles * steps_per_tile`` steps in equal contiguous ranges; step j
    covers output tile ``j // steps_per_tile`` (``tiles_k`` x ``tiles_n``
    tiles of ``tile`` x ``tile``), group ``q // n_mc`` and tokens ``[(q %
    n_mc) * tokens, + tokens)`` of it, ``q = j % steps_per_tile``, the group
    being a sample (``per_sample``, the bf16 kernel, which walks a pair's
    members one after the other) or a pair (the f32 kernel, whose step
    holds both members). Block b writes its partials of tile t into slot
    ``t + b``, one of ``n_slots = n_tiles + n_blocks - 1``. The bf16
    kernel walks tile t's samples from ``rotation(t)`` on."""
    n_blocks: int
    per_sample: bool
    pair: bool
    tile: int
    tokens: int
    tiles_k: int
    tiles_n: int
    n_mc: int
    steps_per_tile: int
    total: int

    @property
    def n_slots(self) -> int:
        return self.tiles_k * self.tiles_n + self.n_blocks - 1

    def begin(self, b: int) -> int:
        """Block b's first step (csrc/fused_backward.cu::range_begin)."""
        return b * self.total // self.n_blocks

    def rotation(self, t: int) -> int:
        """The first sample of tile t's walk (csrc/fused_backward.cu::
        sample_rotation): where the block that reaches t's first step would
        be had it walked its range from sample 0 (even for pairs), so that
        the blocks walk the samples nearly in step; 0 for the f32 kernel."""
        if not self.per_sample:
            return 0
        first = t * self.steps_per_tile
        b = ((first + 1) * self.n_blocks + self.total - 1) // self.total - 1
        r = ((first - self.begin(b)) // self.n_mc) % (self.steps_per_tile // self.n_mc)
        return r & ~1 if self.pair else r

    def segments(self):
        """``(block, tile, q_begin, q_end, slot)`` of every block's run of
        steps within one tile, in block order."""
        T = self.steps_per_tile
        for b in range(self.n_blocks):
            j, end = self.begin(b), self.begin(b + 1)
            while j < end:
                tile = j // T
                stop = min(end, (tile + 1) * T)
                yield b, tile, j - tile * T, stop - tile * T, tile + b
                j = stop


# The kernels' tiles: bf16 (wgmma) 128 x 128 with 64 tokens of one sample a
# step, one block an SM; f32 (WMMA) 64 x 64 with 64 token rows a step (32
# of each member of a pair), two blocks an SM.
BF16_TILE, BF16_TOKENS, BF16_BLOCKS_PER_SM = 128, 64, 1
F32_TILE, F32_ROWS, F32_BLOCKS_PER_SM = 64, 64, 2


@functools.lru_cache(maxsize=256)
def plan_slices(S: int, M: int, K: int, N: int, antithetic: bool, f32: bool,
                n_sm: int) -> SlicePlan:
    """The reduce kernel's split of its steps over a grid that fills
    ``n_sm`` multiprocessors once (fewer blocks where there are fewer
    steps): every block takes the same number of steps, within one."""
    h = 2 if antithetic else 1
    if f32:
        tile, tokens, per_sm, groups = F32_TILE, F32_ROWS // h, F32_BLOCKS_PER_SM, S // h
    else:
        tile, tokens, per_sm, groups = BF16_TILE, BF16_TOKENS, BF16_BLOCKS_PER_SM, S
    tiles_k, tiles_n = -(-K // tile), -(-N // tile)
    n_mc = -(-M // tokens)
    T = groups * n_mc
    total = tiles_k * tiles_n * T
    return SlicePlan(min(n_sm * per_sm, total), not f32, antithetic, tile, tokens, tiles_k,
                     tiles_n, n_mc, T, total)


def reduce_sliced_plain(x, g, w, mu, g_p, plan: SlicePlan, antithetic: bool,
                        mixture=None, want_u: bool = False):
    """Plain mirror of the kernel's split: each block's partial A and B of
    each tile it touches, from f32 products over the steps of a group,
    folded at the end of the group or of the block's run, then each tile's
    slots summed in block order. The bf16 kernel's group is a sample (its
    walk rotated by ``plan.rotation``): ``A += p``, ``B += p * wc``, a
    pair's second member with -wc; the f32 kernel's is a pair: ``A += p0 +
    p1``, ``B += (p0 - p1) * wc``. U and V, which the kernel's sum pass
    takes unsplit, come from the unsliced plain reduce. Returns what
    :func:`reduce_abuv_plain` / :func:`reduce_abuv_anti_plain` return."""
    h = 2 if antithetic else 1
    K, N = mu.shape
    tl, tk, n_mc = plan.tile, plan.tokens, plan.n_mc
    slots = {}
    for b, tile, q0, q1, slot in plan.segments():
        k0, n0 = (tile // plan.tiles_n) * tl, (tile % plan.tiles_n) * tl
        ks, ns = slice(k0, min(K, k0 + tl)), slice(n0, min(N, n0 + tl))
        a_p = torch.zeros((ks.stop - k0, ns.stop - n0))
        b_p = torch.zeros_like(a_p)
        p = [torch.zeros_like(a_p), torch.zeros_like(a_p)]
        for q in range(q0, q1):
            grp, m0 = q // n_mc, (q % n_mc) * tk
            if plan.per_sample:
                s = (grp + plan.rotation(tile)) % (plan.steps_per_tile // n_mc)
                members = [(s, 0)]
            else:
                members = [(h * grp + m, m) for m in range(h)]
            for s, m in members:
                p[m] = p[m] + x[s, m0: m0 + tk, ks].float().T @ g[s, m0: m0 + tk, ns].float()
            if q % n_mc != n_mc - 1 and q != q1 - 1:
                continue
            s = members[0][0]
            wc = w[s - s % h, ks, ns].float() - mu[ks, ns]
            if plan.per_sample:
                a_p = a_p + p[0]
                b_p = b_p + p[0] * (-wc if s % h else wc)
            else:
                a_p = a_p + (p[0] + p[1])
                b_p = b_p + (p[0] - p[1]) * wc
            p = [torch.zeros_like(a_p), torch.zeros_like(a_p)]
        slots[slot] = (tile, a_p, b_p)
    a = torch.zeros((K, N))
    b = torch.zeros((K, N))
    for slot in sorted(slots):
        tile, a_p, b_p = slots[slot]
        k0, n0 = (tile // plan.tiles_n) * tl, (tile % plan.tiles_n) * tl
        a[k0: k0 + a_p.shape[0], n0: n0 + a_p.shape[1]] += a_p
        b[k0: k0 + b_p.shape[0], n0: n0 + b_p.shape[1]] += b_p
    unsliced = (reduce_abuv_anti_plain if antithetic else reduce_abuv_plain)(
        x, g, w, mu, g_p, mixture, want_u)
    return (a, b) + tuple(unsliced[2:])


def reduce_abuv_anti_cuda(x, g, w, mu, g_p, mixture=None, want_u: bool = False):
    """Launch ``bft_reduce_abuv_anti`` (csrc/fused_backward.cu)."""
    return _reduce_cuda(x, g, w, mu, g_p, mixture, want_u, antithetic=True)


def reduce_abuv_cuda(x, g, w, mu, g_p, mixture=None, want_u: bool = False):
    """Launch ``bft_reduce_abuv`` (csrc/fused_backward.cu)."""
    return _reduce_cuda(x, g, w, mu, g_p, mixture, want_u, antithetic=False)


def _reduce_cuda(x, g, w, mu, g_p, mixture, want_u: bool, antithetic: bool):
    req = common.require
    prior = reduce_prior(mixture, want_u)
    req(x.is_cuda, "reduce_abuv kernel needs a CUDA tensor, got {}", x.device)
    req(x.dim() == 3 and g.dim() == 3 and w.dim() == 3 and mu.dim() == 2,
        "x must be (S, M, K), g (S, M, N), w (S, K, N), mu (K, N)")
    S, M, K = x.shape
    N = mu.shape[1]
    req(S % 2 == 0 or not antithetic, "antithetic needs an even S, got {}", S)
    req(g.shape == (S, M, N), "g is {}, want {}", tuple(g.shape), (S, M, N))
    req(w.shape == (S, K, N), "w is {}, want {}", tuple(w.shape), (S, K, N))
    req(mu.shape[0] == K, "mu is {}, x has K={}", tuple(mu.shape), K)
    req(g_p.shape == (S,), "g_p is {}, want ({},)", tuple(g_p.shape), S)
    xt = common.kernel_dtype(x, "reduce_abuv")
    wt = common.kernel_dtype(w, "reduce_abuv")
    req(g.dtype == x.dtype, "g must be {} as x, got {}", x.dtype, g.dtype)
    req(xt == "bf16" or wt == "f32",
        "reduce_abuv kernel takes W as f32 or, with bf16 x, as bf16; got x {}, W {}",
        x.dtype, w.dtype)
    for name, t in (("mu", mu), ("g_p", g_p)):
        req(t.dtype == torch.float32, "{} must be float32, got {}", name, t.dtype)
    for name, t in (("x", x), ("g", g), ("w", w), ("mu", mu), ("g_p", g_p)):
        req(t.device == x.device, "{} is on {}, x on {}", name, t.device, x.device)
        req(t.is_contiguous(), "{} must be contiguous", name)
    lib = _build.library()
    dev = x.device
    acc = mu.new_empty((3 + want_u, K, N))
    a, b, v = acc[0], acc[1], acc[-1]
    u = acc[2] if want_u else None
    pi, s1, s2 = prior[1:] if prior[0] == "mixture" else (0.5, 1.0, 1.0)
    f32 = xt == "f32"
    plan = plan_slices(S, M, K, N, antithetic, f32, common.sm_count(x))
    part = mu.new_empty((plan.n_slots, 2, plan.tile, plan.tile))
    if f32:
        ldx, ldg = K, N
        x_vec = int(K % 4 == 0 and x.data_ptr() % 16 == 0)
        g_vec = int(N % 4 == 0 and g.data_ptr() % 16 == 0)
    else:
        (x, ldx), (g, ldg) = common.tma_rows(x), common.tma_rows(g)
        x_vec = g_vec = 1
    name = "bft_reduce_abuv_anti" if antithetic else "bft_reduce_abuv"
    with common.on_device(x):
        err = getattr(lib, name)(
            x.data_ptr(), g.data_ptr(), w.data_ptr(), mu.data_ptr(),
            g_p.data_ptr(), a.data_ptr(), b.data_ptr(),
            None if u is None else u.data_ptr(), v.data_ptr(), part.data_ptr(),
            S, M, K, N, ldx, ldg, plan.n_blocks, x_vec, g_vec,
            int(f32), int(wt == "f32"), PRIOR_CODE[prior[0]],
            *mixture_constants(pi, s1, s2), common.cuda_stream(x),
        )
    _build.check(err, name)
    tag = (xt if xt == wt else f"{xt}x-{wt}w") + PRIOR_TAG[prior[0]]
    (LAUNCHES if antithetic else INDEP_LAUNCHES).add((M, K, N, tag))
    return _results(a, b, u, v, want_u)


def finalize(a, b, v, rho, g_q, u=None, *, prior=ON_MU, mu=None,
             prior_mu=None, g_p=None):
    """``(dmu, drho)`` from the accumulators, the reference's ``finalize``
    for each prior (its ``dprior_mu`` is never trained and not returned):

      gaussian_on_mu:  dmu = A,  prior_eps = -V / (sigma_p^2 sigma)
      gaussian:        pr = -(U + (mu - prior_mu) sum(g_p)) / sigma_p^2,
                       dmu = A + pr,
                       prior_eps = -(V + (mu - prior_mu) U) / (sigma_p^2 sigma)
      mixture:         dmu = A + U,  prior_eps = V / sigma

    and ``drho = (B / sigma + prior_eps - sum(g_q) / sigma) sigmoid(rho)``."""
    sigma = sigma_from_rho(rho)
    sum_gq = torch.sum(g_q)
    ps2 = MOPED_PRIOR_SIGMA ** 2
    if prior[0] == "gaussian":
        d = mu - prior_mu
        dmu = a - (u + d * torch.sum(g_p)) / ps2
        prior_eps = -(v + d * u) / (ps2 * sigma)
    elif prior[0] == "gaussian_on_mu":
        dmu = a
        prior_eps = -v / (ps2 * sigma)
    else:
        dmu = a + u
        prior_eps = v / sigma
    drho = (b / sigma + prior_eps - sum_gq / sigma) * torch.sigmoid(rho)
    return dmu, drho
