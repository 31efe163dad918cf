"""The split ops' sampled matmul, ``y[s] = x[s] @ (mu + softplus(rho) * eps[s])``,
and the regeneration of its W.

Counterpart of ``bayeformers_tpu/ops/sampled_linear.py``: ``sampled_dense``
with the reference's custom VJP (``_sampled_dense_bwd``),
``regenerate_weights`` and the plain versions ``naive_weights`` /
``naive_sampled_dense``. Layout as there: x (S, M, K) with the Monte-Carlo
sample axis first, mu and rho (K, N) f32, ``seeds`` (S,) int32, one
independent draw per sample. Flipout (``nn/flipout.py``) runs its weight
perturbation through :func:`sampled_dense` with ``mu = 0``.

**The draw stream.** The split ops draw from the port's one stream, the
absolute-unit Philox stream of ``ops/common.py`` and ``csrc/eps.cuh``, the
stream of the fused op (``ops/fused_linear.py``) too. On the TPU the split
kernels draw from a second, tile-keyed stream (``tile_eps``), whose units
follow the VMEM tiling and do not carry over to Hopper; the JAX package's
docstring of ``regenerate_weights`` (:239-241) therefore says that its W
differs from ``fused_linear.regenerate_weights``'s. In the port the two are
the same W for the same seeds, bit for bit, since one backend uses one
stream.

Kernels (``csrc/``), each launched by its wrapper for a CUDA tensor (a CPU
tensor, or ``plain=True``, takes the plain version; there is no fallback):

* :func:`sampled_dense_cuda`: the fused op's two stages with no prior
  (Pallas #12, ``_fused_kernel``): the draw pass (``bft_draw``,
  ``csrc/regen.cu``) writes W in x's dtype and the product (``bft_bmm``,
  ``csrc/bayes_linear.cu``) takes y, bf16 or f32 x;
* :func:`regen_cuda`: ``bft_regen`` (``csrc/regen.cu``), the (S, K, N) f32 W
  of S seeds (Pallas #13, ``_regen_kernel``, and #10 of the fused op, which
  on one stream compute the same W), or of S / 2 antithetic pairs (#10's
  pair instance), and on request the same W in bf16, written in the same
  pass. :func:`regenerate_weights` and the VJP count its launches in
  :data:`REGEN_LAUNCHES`, ``fused_linear.regenerate_weights`` in its own
  counter.

The VJP (:func:`sampled_dense_vjp`, the reference's ``_sampled_dense_bwd``)
rebuilds W and takes

    dx   = g @ W^T                     (x's dtype, f32 accumulation)
    dmu  = sum_s x^T g = A
    drho = sum_s (x^T g) * eps * sigmoid(rho) = B / sigma * sigmoid(rho)

with ``B = sum_s (x^T g)(W - mu)`` and ``eps = (W - mu) / sigma``. dx is an
XLA einsum outside Pallas in the JAX package and ``torch.bmm`` here; A and
B are the dmu/drho reduce's (``ops/fused_backward.py::reduce_abuv``,
``bft_reduce_abuv`` on the card, taking the f32 W with bf16 or f32 x and
g), turned into dmu and drho by its ``finalize`` with no prior term. No
(S, K, N) dW is formed.
"""
from __future__ import annotations

import torch

from bayeformers_tpu_torch.core.distributions import sigma_from_rho
from bayeformers_tpu_torch.ops import _build, common

LAUNCHES = common.LaunchCounter("sampled_dense")
REGEN_LAUNCHES = common.LaunchCounter("sampled_regen")


def naive_weights(mu, rho, seeds=None, eps=None, offsets=None) -> torch.Tensor:
    """The plain (S, K, N) f32 weights ``mu + softplus(rho) * eps`` of
    ``seeds`` on the unit stream, or of an explicit ``eps`` (S, K, N): the
    product and the sum each rounded, as the kernels round them.
    ``offsets`` (k0, n0): the element offsets of this shard in its whole
    layer, multiples of (256, 128) (:func:`common.unit_offsets`); an
    injected ``eps`` ignores them."""
    if eps is None:
        eps = common.unit_eps(seeds, tuple(mu.shape), common.unit_offsets(offsets))
    return mu[None] + sigma_from_rho(rho)[None] * eps


def naive_sampled_dense(x, mu, rho, seeds=None, eps=None) -> torch.Tensor:
    """The plain sampled matmul: W cast to x's dtype, products accumulated in
    f32, y in x's dtype."""
    w = naive_weights(mu, rho, seeds, eps)
    return torch.bmm(x.float(), w.to(x.dtype).float()).to(x.dtype)


def regen_cuda(mu, rho, seeds, counter: common.LaunchCounter, lo_dtype=None, *,
               pair: bool = False, offsets=None):
    """Launch ``bft_regen`` (csrc/regen.cu): the (S, K, N) f32 W of ``seeds``
    (S,) on the unit stream, or with ``pair`` the (2S, K, N) antithetic
    pairs ``(w, 2 mu - w)`` interleaved; ``offsets`` (k0, n0) a shard's unit
    offsets (:func:`common.unit_offsets`). ``counter`` takes the launch,
    keyed by ``(S, K, N)`` and a tag naming the pair instance and the bf16
    copy. ``lo_dtype=torch.bfloat16`` also returns W rounded to bf16,
    written in the same pass: ``(w, w_bf16)``."""
    req = common.require
    req(mu.is_cuda, f"regen kernel needs a CUDA tensor, got {mu.device}")
    req(mu.dim() == 2 and tuple(rho.shape) == tuple(mu.shape),
        f"mu and rho must be one (K, N); got {tuple(mu.shape)} / {tuple(rho.shape)}")
    req(mu.dtype == torch.float32 and rho.dtype == torch.float32,
        "mu and rho must be float32")
    req(seeds.dim() == 1 and seeds.dtype == torch.int32, "seeds must be (S,) int32")
    req(lo_dtype in (None, torch.bfloat16), f"regen's second W is bf16, got {lo_dtype}")
    for name, t in (("mu", mu), ("rho", rho), ("seeds", seeds)):
        req(t.device == mu.device, f"{name} is on {t.device}, mu on {mu.device}")
        req(t.is_contiguous(), f"{name} must be contiguous")
    k0, n0 = common.unit_offsets(offsets)
    K, N = mu.shape
    S = seeds.shape[0]
    req(S >= 1, "at least one seed")
    lib = _build.library()
    shape = ((2 if pair else 1) * S, K, N)
    w = torch.empty(shape, dtype=torch.float32, device=mu.device)
    lo = None if lo_dtype is None else torch.empty(shape, dtype=lo_dtype, device=mu.device)
    with common.on_device(mu):
        err = lib.bft_regen(mu.data_ptr(), rho.data_ptr(), seeds.data_ptr(), w.data_ptr(),
                            None if lo is None else lo.data_ptr(), S, K, N, int(pair),
                            k0 // common.UNIT_K, n0 // common.UNIT_N, common.cuda_stream(mu))
    _build.check(err, "bft_regen")
    tags = ("pair",) * pair + ("bf16",) * (lo is not None)
    counter.add((S, K, N) + (("/".join(tags),) if tags else ()))
    return w if lo is None else (w, lo)


def regenerate_weights(mu, rho, seeds, *, plain: bool = False) -> torch.Tensor:
    """(S, K, N) f32 weights of ``seeds`` (S,): exactly the W that
    :func:`sampled_dense` drew for those seeds, and the W that
    ``fused_linear.regenerate_weights`` returns for them. A CPU tensor, or
    ``plain=True``, takes :func:`naive_weights`; a CUDA tensor launches
    ``bft_regen`` (Pallas #13) or raises."""
    if plain or mu.device.type == "cpu":
        return naive_weights(mu, rho, seeds)
    return regen_cuda(mu, rho, seeds, REGEN_LAUNCHES)


def sampled_dense_cuda(x, mu, rho, seeds) -> torch.Tensor:
    """Launch the no-prior instance of the forward's draw pass
    (``bft_draw``, csrc/regen.cu) and the product (``bft_bmm``,
    csrc/bayes_linear.cu) in their instances for x's dtype; y takes x's
    dtype. The launch counter keys each call by ``(M, K, N, dtype tag)``."""
    req = common.require
    req(x.is_cuda, "sampled_dense kernel needs a CUDA tensor, got {}", x.device)
    tag = common.kernel_dtype(x, "sampled_dense")
    req(x.dim() == 3 and mu.dim() == 2, "x must be (S, M, K), mu (K, N)")
    S, M, K = x.shape
    N = mu.shape[1]
    req(mu.shape[0] == K and rho.shape == mu.shape,
        "mu/rho {}/{} do not match K={}", tuple(mu.shape), tuple(rho.shape), K)
    req(mu.dtype == torch.float32 and rho.dtype == torch.float32,
        "mu and rho must be float32")
    req(seeds.shape == (S,) and seeds.dtype == torch.int32,
        "S={} samples need (S,) int32 seeds, got {} {}", S, tuple(seeds.shape), seeds.dtype)
    for name, t in (("x", x), ("mu", mu), ("rho", rho), ("seeds", seeds)):
        req(t.device == x.device, "{} is on {}, x on {}", name, t.device, x.device)
        req(t.is_contiguous(), "{} must be contiguous", name)
    req(1 <= S <= 65535, "between 1 and 65535 samples")
    from bayeformers_tpu_torch.ops import fused_linear  # it imports this module

    ldw = common.round_up(N, 16 // x.element_size())
    chunk = max(1, min(S, fused_linear.DRAW_CHUNK_BYTES // (K * ldw * x.element_size())))
    y = x.new_empty((S, M, N))
    w = x.new_empty((chunk, K, ldw))
    with common.on_device(x):
        fused_linear.launch_forward(x, mu, rho, seeds, y, w, chunk, pair=False,
                                    prior=("none",))
    LAUNCHES.add((M, K, N, tag))
    return y


def _forward(x, mu, rho, seeds, eps, plain: bool) -> torch.Tensor:
    if plain or x.device.type == "cpu":
        return naive_sampled_dense(x, mu, rho, seeds, eps)
    common.require(eps is None, "an injected eps runs the plain version only")
    return sampled_dense_cuda(x, mu, rho, seeds)


def sampled_dense_vjp(x, mu, rho, seeds, g, *, eps=None, plain: bool = False,
                      need_x: bool = True):
    """The reference's VJP (``_sampled_dense_bwd``) of :func:`sampled_dense`
    at the cotangent g: ``(dx, dmu, drho)``. W is rebuilt once, in f32 and,
    for dx, in x's dtype (on the card ``bft_regen``, #13, writes both in one
    pass); ``dx = g @ W^T`` in x's dtype (``torch.bmm``, an einsum outside
    Pallas in the reference); dmu and drho from the dmu/drho reduce over the
    f32 W with no prior (``fused_backward.reduce_abuv``: A = sum_s x^T g,
    B = sum_s (x^T g)(W - mu), on the card ``bft_reduce_abuv``, #9) and
    ``finalize`` with g_p = g_q = 0: dmu = A, drho = B / sigma
    sigmoid(rho). A CPU tensor, ``plain=True`` or an injected ``eps`` takes
    the plain versions of each (``reduce_abuv_plain``). ``need_x=False``
    skips dx (None)."""
    from bayeformers_tpu_torch.ops import fused_backward  # it imports this module

    dtype = x.dtype
    if plain or eps is not None or x.device.type == "cpu":
        w = naive_weights(mu, rho, seeds, eps)
        w_x = w.to(dtype)
        reduce = fused_backward.reduce_abuv_plain
    elif dtype == torch.float32:
        w = w_x = regen_cuda(mu, rho, seeds, REGEN_LAUNCHES)
        reduce = fused_backward.reduce_abuv_cuda
    else:
        w, w_x = regen_cuda(mu, rho, seeds, REGEN_LAUNCHES, lo_dtype=dtype)
        reduce = fused_backward.reduce_abuv_cuda
    g = g.to(dtype).contiguous()
    dx = torch.bmm(g, w_x.transpose(1, 2)).to(dtype) if need_x else None
    zeros = mu.new_zeros((x.shape[0],))
    a, b, v = reduce(x.contiguous(), g, w, mu, zeros)
    dmu, drho = fused_backward.finalize(a, b, v, rho, zeros)
    return dx, dmu, drho


class SampledDense(torch.autograd.Function):
    """:func:`sampled_dense` with the reference's VJP
    (:func:`sampled_dense_vjp`): the forward keeps ``(x, mu, rho, seeds)``
    (and an injected ``eps``) and no W; the backward rebuilds W (#13 on the
    card) and hands it to the reduce."""

    @staticmethod
    def forward(ctx, x, mu, rho, seeds, eps, plain):
        ctx.save_for_backward(x, mu, rho, seeds, eps)
        ctx.plain = plain
        return _forward(x, mu, rho, seeds, eps, plain)

    @staticmethod
    def backward(ctx, g):
        x, mu, rho, seeds, eps = ctx.saved_tensors
        dx, dmu, drho = sampled_dense_vjp(x, mu, rho, seeds, g, eps=eps, plain=ctx.plain,
                                          need_x=ctx.needs_input_grad[0])
        return (dx, dmu if ctx.needs_input_grad[1] else None,
                drho if ctx.needs_input_grad[2] else None, None, None, None)


def sampled_dense(x, mu, rho, seeds, *, plain: bool = False, eps=None) -> torch.Tensor:
    """``(S, M, K) @ sampled (K, N) -> (S, M, N)`` with one independent draw
    per sample, ``seeds`` (S,); y in x's dtype. Differentiable in x, mu and
    rho through the reference's VJP (:class:`SampledDense`). Port keywords:
    ``plain=True`` runs the plain versions on the tensors' device (a CPU
    tensor always does); ``eps`` (S, K, N) injects the draw into the plain
    version (tests)."""
    if torch.is_grad_enabled() and (x.requires_grad or mu.requires_grad
                                    or rho.requires_grad):
        return SampledDense.apply(x, mu, rho, seeds, eps, plain)
    return _forward(x, mu, rho, seeds, eps, plain)
