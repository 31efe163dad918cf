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

Each layer's prior follows the conversion, as in the reference
(``nn/fused.py:368-386``): frozen MOPED centres it on mu itself
(``prior_on_mu``), MOPED with a trainable mu on the fixed ``prior_mu``,
and a random-init conversion takes the scale mixture; the sampled biases'
log-priors follow the same choice.

Per-leaf seeds come from the request's integer seed through
:func:`derive_seed` (a splitmix64 chain), so identical (inputs, seed) give
identical draws. Log-probs are collected once per converted leaf and summed
model-wide.

Two estimators: independent draws (``antithetic=False``, the reference's
default; one draw per sample, seeds ``derive_seed(seed, leaf, s)``) and
antithetic pairs (``antithetic=True``; one draw per pair t, seeds
``derive_seed(seed, leaf, t)``, interleaved as ``(mu + d, mu - d)``).

The forward is differentiable: with ``save_weights=True`` (the default, as
in the reference) each Bayesian linear op keeps its W for the backward of
``ops/fused_linear.py::BayesLinear``; with ``save_weights=False`` it writes
no W and its backward (``BayesLinearRegen``) regenerates W from the seeds.
Attention runs its own backward, and the sampled biases and their
log-probs differentiate through plain autograd. Serving calls it with
``save_weights=False`` inside ``torch.inference_mode()``.
"""
from __future__ import annotations

import torch

from bayeformers_tpu_torch.core import distributions as dist
from bayeformers_tpu_torch.models.bert import lookup
from bayeformers_tpu_torch.models.gpt2 import causal_attention
from bayeformers_tpu_torch.models.llama import gqa_attention
from bayeformers_tpu_torch.nn import conv as conv_lib
from bayeformers_tpu_torch.ops import attention as ops_attention
from bayeformers_tpu_torch.ops import common as ops_common
from bayeformers_tpu_torch.ops import fused_linear as ops_fused
from bayeformers_tpu_torch.ops.logprob import ON_MU, prior_log_prob, prior_of
from bayeformers_tpu_torch.parallel import collectives as coll

SEP = "/"
_M64 = (1 << 64) - 1
# the text models' inputs, in the order their forwards take them
TEXT_INPUTS = ("input_ids", "attention_mask", "token_type_ids")


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


def untile_samples(x, n_samples: int, extra_axes: tuple[int, ...] = ()):
    """Inverse of :func:`tile_samples`: (S*B, ...) -> (S, B, ...), mapped
    over a tuple of outputs (the QA heads' start and end logits).

    ``extra_axes`` (axes of the model's untiled output, each > 0) are
    further S-tiled axes of an output that couples two tiled batches, as
    CLIP's ``logits_per_image`` (B_img, B_txt) is (S*B_img, S*B_txt) on
    tiled inputs (pass ``(1,)``): of each such axis only the sample's own
    block is kept, so that axis k of size S*Bk becomes Bk, the entries whose
    sample index matches the leading sample axis (the reference's
    ``untile_samples``, ``nn/fused.py:51-83``)."""
    if isinstance(x, tuple):
        return tuple(untile_samples(t, n_samples, extra_axes) for t in x)
    S = n_samples
    a = x.reshape((S, x.shape[0] // S) + tuple(x.shape[1:]))
    # axis k of the natural output sits at k + 1 after the sample axis
    for ax in sorted(ax + 1 for ax in extra_axes):
        a = a.reshape(tuple(a.shape[:ax]) + (S, a.shape[ax] // S) + tuple(a.shape[ax + 1:]))
        idx = torch.arange(S, device=a.device).reshape((S,) + (1,) * (a.dim() - 1))
        idx = idx.expand(tuple(a.shape[:ax]) + (1,) + tuple(a.shape[ax + 1:]))
        a = torch.gather(a, ax, idx).squeeze(ax)
    return a


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


def bias_logprobs(b, bsig, beps, prior, centre=None):
    """(S,) log_q and log_p of a sampled bias (small; plain torch) under a
    prior tuple (``ops/logprob.py``): the MOPED prior centred on ``centre``
    (the bias's mu or its prior_mu), or the scale mixture."""
    lq = torch.sum(-dist.LOG_SQRT_2PI - torch.log(bsig)[None] - 0.5 * beps * beps,
                   dim=-1)
    return lq, prior_log_prob(b, centre, prior, dim=-1)


def transposed_view(mod, rho):
    """A converted layer's (mu, rho) in the (in, out) orientation that
    defines the fused, flipout and LRT tiers' draws: a ``Conv1D``'s
    (stored (out, in)) as contiguous transposed copies, a ``Dense``'s as
    they are."""
    if mod.transposed:
        return mod.kernel.t().contiguous(), rho.t().contiguous()
    return mod.kernel, rho


def unit_bias_eps(seed_rows: torch.Tensor, widths, offsets=None) -> list[torch.Tensor]:
    """Biases' eps in one batched draw: ``seed_rows`` (n_leaves, n) int32,
    ``widths`` the leaves' N; returns each leaf's (n, N) eps, element j of
    draw t being the unit stream's element (0, n0 + j) for the leaf's seed
    t, a pure function of (seed, (n0 + j) // 128, (n0 + j) % 128) like the
    JAX package's ``_unit_bias_eps``. ``offsets`` gives each leaf's column
    offset n0 (a column shard's place in its whole bias; default 0)."""
    offsets = offsets or [0] * len(widths)
    eps = ops_common.unit_eps(seed_rows.reshape(-1),
                              (1, max(o + w for o, w in zip(offsets, widths))))
    eps = eps.reshape(seed_rows.shape[0], seed_rows.shape[1], -1)
    return [eps[i, :, o:o + w] for i, (o, w) in enumerate(zip(offsets, widths))]


class MCBase:
    """What every S-sample forward's state shares (the fused, flipout,
    local-reparameterization and naive tiers): the converted leaves and
    their indices, the leaves dispatched so far, the prior, and the
    self-attention block, whose q/k/v go through the tier's :meth:`dense`
    and attention through the flat-layout mha op (its kernels on the card).
    ``impl="plain"`` runs every op's plain version on the tensors' device
    (the reference for the kernels on the card); an ``eps_hook`` supplies
    the draws (tests only) and implies it."""

    tier = ""
    tp = None  # the tensor-parallel context; only the fused tier takes one

    def __init__(self, bmodel, n_samples: int, impl: str, eps_hook):
        if impl not in ("kernel", "plain"):
            raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
        self.bmodel = bmodel
        self.S = n_samples
        self.plain = impl == "plain" or eps_hook is not None
        self.eps_hook = eps_hook
        self.paths = bmodel.spec.paths
        spec = bmodel.spec
        self.mixture = (spec.prior.pi, spec.prior.sigma1, spec.prior.sigma2)
        self.path_index = {p: i for i, p in enumerate(self.paths)}
        self.seen: set[str] = set()

    def bias_paths(self) -> list[str]:
        return [p for p in self.paths if p.endswith(SEP + "bias")]

    def kind(self, kpath: str) -> str:
        """A converted leaf's tensor-parallel kind (``'col'``, ``'row'``);
        ``'rep'`` without tp and for an unconverted one."""
        if self.tp is None or kpath not in self.bmodel.rho:
            return "rep"
        return self.tp.kind_fn(kpath)

    def local_heads(self, mod, names, n_heads: int, n_kv=None, row=None):
        """This rank's head counts (the reference's ``_local_heads``):
        ``(n_heads, n_kv)`` as given without tp or with q/k/v (the layers
        ``names``) replicated, divided by tp where they are column-sharded
        (the rules' blocks are whole heads). Mixed kinds, a head count that
        tp does not divide, and an output projection (``row``: GPT-2's
        c_proj) that is not row-sharded under column-sharded q/k/v raise."""
        kinds = {self.kind(getattr(mod, n).path + SEP + "kernel") for n in names}
        out = "rep" if row is None else self.kind(getattr(mod, row).path + SEP + "kernel")
        if kinds == {"rep"} and out == "rep":
            return n_heads, n_kv
        where = getattr(mod, names[0]).path.rpartition(SEP)[0]
        if kinds != {"col"} or (row is not None and out != "row"):
            raise ValueError(f"tp sharding of attention {where} must column-shard all of "
                             f"{names} (and row-shard {row}) or none; got {kinds}, {out}")
        tp = self.tp.size
        if n_heads % tp or (n_kv is not None and n_kv % tp):
            kv = "" if n_kv is None else f" and n_kv={n_kv}"
            raise ValueError(f"n_heads={n_heads}{kv} must divide by tp={tp} "
                             f"(attention {where})")
        return n_heads // tp, None if n_kv is None else n_kv // tp

    def self_attention(self, mod, hidden, bias):
        """The whole self-attention block: q/k/v through :meth:`dense` and
        attention through the flat-layout mha op, on this rank's heads."""
        nh, _ = self.local_heads(mod, ("query", "key", "value"), mod.n_heads)
        q = self.dense(mod.query, hidden)
        k = self.dense(mod.key, hidden)
        v = self.dense(mod.value, hidden)
        return ops_attention.mha(q, k, v, bias, nh, plain=self.plain)

    def albert_attention(self, mod, hidden, bias):
        """ALBERT's attention block (``handle_albert_attention``): q/k/v and
        the output ``dense`` through :meth:`dense`, the flat-layout mha op,
        then the module's own LayerNorm over ``proj + hidden``. ALBERT's one
        layer is called once a repetition: each call draws the same W (the
        leaf's seeds) and the leaf's log-probs count once (``seen``)."""
        nh, _ = self.local_heads(mod, ("query", "key", "value"), mod.n_heads)
        q = self.dense(mod.query, hidden)
        k = self.dense(mod.key, hidden)
        v = self.dense(mod.value, hidden)
        ctx = ops_attention.mha(q, k, v, bias, nh, plain=self.plain)
        return mod.LayerNorm(self.dense(mod.dense, ctx) + hidden)

    def distilbert_attention(self, mod, hidden, bias):
        """DistilBERT's attention block (``handle_distilbert_attention``):
        q/k/v and ``out_lin`` through :meth:`dense`, the flat-layout mha op
        with DistilBERT's f32 bias ``-1e30 * (1 - mask)`` as it is."""
        nh, _ = self.local_heads(mod, ("q_lin", "k_lin", "v_lin"), mod.n_heads)
        q = self.dense(mod.q_lin, hidden)
        k = self.dense(mod.k_lin, hidden)
        v = self.dense(mod.v_lin, hidden)
        ctx = ops_attention.mha(q, k, v, bias, nh, plain=self.plain)
        return self.dense(mod.out_lin, ctx)

    def gpt2_attention(self, mod, hidden, bias):
        """GPT-2's attention block (``handle_gpt2_attention``): the packed
        ``c_attn`` and ``c_proj`` through :meth:`dense`, attention through
        the flat-layout mha op with the causal mask; under tp the packed
        c_attn is column-sharded in the head-aligned layout of
        ``parallel/mesh.py::permute_gpt2_qkv`` and c_proj row-sharded."""
        nh, _ = self.local_heads(mod, ("c_attn",), mod.n_heads, row="c_proj")
        return causal_attention(mod, hidden, bias, self.dense, plain=self.plain, n_heads=nh)

    def gqa_attention(self, mod, hidden, bias, position_ids):
        """The LLaMA-architecture attention block (``handle_gqa_attention``):
        q/k/v and o_proj through :meth:`dense`, rotary, k/v repeated to the
        full head count, the flat-layout mha op with the causal mask (plain
        banded attention where Mistral's window bites), on this rank's
        heads: under GQA tp must divide the kv heads too."""
        nh, nkv = self.local_heads(mod, ("q_proj", "k_proj", "v_proj"), mod.n_heads,
                                   mod.n_kv_heads)
        return gqa_attention(mod, hidden, bias, position_ids, self.dense, plain=self.plain,
                             n_heads=nh, n_kv=nkv)

    def embed(self, mod, ids):
        """A tier with no embedding handler (flipout, as in the reference)
        runs the lookup at mu and does not mark the table seen, so that
        :meth:`check_seen` raises for a converted one."""
        return mod(ids)

    def embed_unbatched(self, mod, ids):
        """A lookup shared by every example (``Embed.lookup_shared``), (1,
        *ids.shape, D). A converted table goes through the tier's
        :meth:`embed`, which splits the ids across the S draws
        (``ids.reshape(S, -1)``, one chunk a draw), as the reference's
        ``handle_embed`` does with such ids: every sample sees the same mix
        of draws, and S must divide the ids (the reference raises
        otherwise)."""
        epath = mod.path + SEP + "embedding"
        if epath in self.bmodel.rho and ids.numel() % self.S:
            raise ValueError(
                f"{self.tier} tier: converted table {epath} is looked up with {ids.numel()} "
                f"ids shared by every example, which the reference's handler splits "
                f"across the draws: S={self.S} must divide them")
        return self.embed(mod, ids)[None]

    def tied_table(self, mod):
        """The table a tied output head reads (T5's ``shared``, Whisper's
        token table): mu, as the reference's interception tiers read the
        module's parameter."""
        return mod.embedding

    def check_seen(self, collected) -> None:
        if not collected:
            raise ValueError(f"{self.tier}_mc_apply dispatched no converted layers")
        check_converted_paths_seen(self.paths, self.seen, self.tier)


def run_mc(mc: MCBase, n_samples: int, *args, untile_axes: tuple[int, ...] = (),
           **inputs):
    """Run the converted model once over the S-major tiled inputs with the
    tier state ``mc``; returns ``(outputs (S, B, ...), mc.aux())``, the
    outputs a tuple of such where the model returns one (a QA head's start
    and end logits). ``args`` and ``inputs`` go to the model's forward as
    given, each tensor tiled (None passes): ViT's pixels, CLIP's ids,
    pixels and mask by name; the text models' inputs (only
    :data:`TEXT_INPUTS` by name) by position, in that order, so that a
    model's first input, whatever its name (the MNIST MLP's float images,
    ``models/mlp.py``), rides ``input_ids``. ``untile_axes`` as in
    :func:`untile_samples`."""
    def tile(a):
        return a if a is None else tile_samples(a, n_samples)

    if not args and set(inputs) <= set(TEXT_INPUTS):
        args, inputs = tuple(inputs.get(k) for k in TEXT_INPUTS), {}

    out = mc.bmodel.model(*(tile(a) for a in args),
                          **{k: tile(v) for k, v in inputs.items()}, mc=mc)
    return untile_samples(out, n_samples, untile_axes), mc.aux()


class FusedMC(MCBase):
    """The state of one fused S-sample forward, handed to every module's
    ``forward(..., mc)``."""

    tier = "fused"

    def __init__(self, bmodel, seed: int, n_samples: int, *,
                 antithetic: bool, save_weights: bool, impl: str, eps_hook, tp=None):
        if antithetic and n_samples % 2:
            raise ValueError(f"antithetic needs an even n_samples; got {n_samples}")
        super().__init__(bmodel, n_samples, impl, eps_hook)
        self.antithetic = antithetic
        self.save_weights = save_weights
        self.n_draws = n_samples // 2 if antithetic else n_samples
        self.tp = tp if tp is not None and tp.size > 1 else None
        # every leaf's n_draws seeds, uploaded once per request; under tp
        # also the seeds of a leaf whose shards draw apart (see _plan)
        self.seeds = self._seed_table(seed)
        self.rank_seeds = (self.seeds if self.tp is None
                           else self._seed_table(seed, self.tp.rank))
        self.bias_eps = {} if eps_hook is not None else self._all_bias_eps()
        # (log_q, log_p, sharded over tp) of each leaf, once a forward
        self.collected: list[tuple[torch.Tensor, torch.Tensor, bool]] = []
        self._f_in = None  # (source, f(xs)) of the last column input

    def _seed_table(self, seed: int, *extra: int) -> torch.Tensor:
        """(n_leaves, n_draws) int32 seeds ``derive_seed(seed, leaf, t,
        *extra)`` on the model's device."""
        return torch.tensor(
            [[derive_seed(seed, i, t, *extra) for t in range(self.n_draws)]
             for i in range(len(self.paths))],
            dtype=torch.int32,
        ).to(self.bmodel.device)

    def _plan(self, kpath: str, shape) -> tuple[str, tuple[int, int], bool]:
        """``(kind, unit_offsets, apart)`` of a converted kernel whose local
        (K, N) view is ``shape`` (the reference's ``_tp_kernel_plan``): a
        column shard sits at (0, r N), a row shard at (r K, 0); where that
        lands on the (256, 128) unit grid the shard draws exactly its slice
        of the whole layer's noise, else (``apart``) it takes the rank's own
        seeds, ``derive_seed(seed, leaf, t, rank)``, so that the shards of
        one layer never share noise."""
        kind = self.kind(kpath)
        r = 0 if self.tp is None else self.tp.rank
        K, N = shape
        if kind == "col":
            return (kind, (0, r * N), False) if N % ops_common.UNIT_N == 0 else (kind, (0, 0), True)
        if kind == "row":
            return (kind, (r * K, 0), False) if K % ops_common.UNIT_K == 0 else (kind, (0, 0), True)
        return kind, (0, 0), False

    def _bias_plan(self, bpath: str, N: int) -> tuple[bool, int, bool]:
        """``(sharded, n0, apart)`` of a converted bias with N local columns:
        sharded with its kernel's column shard, at element offset r N where
        N is whole 128-wide units, else on the rank's own seeds."""
        if self.kind(bpath.rpartition(SEP)[0] + SEP + "kernel") != "col":
            return False, 0, False
        if N % ops_common.UNIT_N == 0:
            return True, self.tp.rank * N, False
        return True, 0, True

    def _global_eps(self, path: str, shape, kind: str) -> torch.Tensor:
        """The eps hook's draw of a leaf: the hook gives the whole layer's
        (n_draws, *shape) draw; a shard takes its rank's block of it."""
        tp = 1 if kind == "rep" else self.tp.size
        dim = {"col": len(shape) - 1, "row": 0, "rep": 0}[kind]
        whole = list(shape)
        whole[dim] *= tp
        eps = self.eps_hook(path, self.n_draws, tuple(whole))
        if tp == 1:
            return eps
        return eps.narrow(dim + 1, self.tp.rank * shape[dim], shape[dim])

    def _all_bias_eps(self) -> dict[str, torch.Tensor]:
        """Every converted bias's (n_draws, N) eps in one batched draw
        (:func:`unit_bias_eps` on the leaf's seeds, at its column offset)."""
        bpaths = self.bias_paths()
        if not bpaths:
            return {}
        widths = [self.bmodel.rho[p].shape[0] for p in bpaths]
        plans = [self._bias_plan(p, w) for p, w in zip(bpaths, widths)]
        idx = [self.path_index[p] for p in bpaths]
        rows = self.seeds[idx]  # (nb, n_draws)
        apart = [j for j, (_, _, a) in enumerate(plans) if a]
        if apart:
            rows[apart] = self.rank_seeds[[idx[j] for j in apart]]
        return dict(zip(bpaths, unit_bias_eps(rows, widths, [n0 for _, n0, _ in plans])))

    @staticmethod
    def interleave(a_half: torch.Tensor) -> torch.Tensor:
        """(S/2, ...) draws -> (S, ...) antithetic +- pairs along axis 0."""
        return torch.stack([a_half, -a_half], dim=1).reshape(
            (-1,) + tuple(a_half.shape[1:])
        )

    def _prior_kwargs(self, path, view=None) -> dict:
        """The prior keyword of :func:`ops.fused_linear.bayes_linear` for a
        converted leaf: frozen MOPED's prior sits on mu itself, so the
        kernel streams no third array; MOPED with a trainable mu centres it
        on ``prior_mu`` (through ``view``, the map that gives the leaf's
        (K, N) orientation: a ``Conv1D``'s transpose, a ``Conv``'s
        :func:`nn.conv.reorder`); random init takes the mixture."""
        spec = self.bmodel.spec
        if spec.moped and spec.frozen:
            return {"prior_on_mu": True}
        if spec.moped:
            pm = self.bmodel.prior_mu[path]
            return {"prior_mu": pm if view is None else view(pm)}
        return {"mixture": self.mixture}

    def _copy_to_shards(self, xs, source):
        """Megatron's "f" on a column shard's input ``xs``, once for each
        ``source`` tensor it was reshaped from: q, k and v read one hidden
        state, whose cotangents autograd then sums before one all-reduce
        (the reference applies f per layer; the sum is the same)."""
        if source is not None and self._f_in is not None and self._f_in[0] is source:
            return self._f_in[1]
        fx = coll.copy_to_shards(xs, self.tp.group)
        self._f_in = (source, fx)
        return fx

    def _route_matmul(self, kpath, mu, rho, xs, view=None, source=None):
        """The Bayesian linear op of a converted kernel in its (K, N)
        orientation (``mu``, ``rho``; ``view`` as in :meth:`_prior_kwargs`)
        over ``xs`` (S, M, K), shared by :meth:`dense` and :meth:`conv`; the
        leaf's log-probs are collected once a forward. Under tp (the
        reference's Megatron plan) a column shard's input passes "f"
        (:meth:`_copy_to_shards`, ``xs`` reshaped from ``source``) and a row
        shard's partial output "g" (``parallel/collectives.py``). Returns
        ``(y, new_leaf, kind)``."""
        kind, offsets, apart = self._plan(kpath, tuple(mu.shape))
        seeds = (self.rank_seeds if apart else self.seeds)[self.path_index[kpath]]
        eps = None
        if self.eps_hook is not None:
            eps = self._global_eps(kpath, tuple(mu.shape), kind)
        if kind == "col":
            xs = self._copy_to_shards(xs, source)
        y, lq, lp = ops_fused.bayes_linear(
            xs, mu, rho, seeds, save_weights=self.save_weights,
            antithetic=self.antithetic, plain=self.plain, eps=eps,
            unit_offsets=offsets, **self._prior_kwargs(kpath, view))
        if kind == "row":
            y = coll.reduce_from_shards(y, self.tp.group)
        new_leaf = kpath not in self.seen
        if new_leaf:
            self.seen.add(kpath)
            self.collected.append((lq, lp, kind != "rep"))
        return y, new_leaf, kind

    def dense(self, mod, x: torch.Tensor) -> torch.Tensor:
        """A converted ``Dense`` or ``Conv1D`` over an S-major (S*B, ..., K)
        input. A ``Conv1D`` kernel (stored (out, in)) goes to the op as
        (in, out) copies of mu and rho (and ``prior_mu``), so its eps stream
        is defined on the transposed view, as the JAX package's
        ``handle_dense(transposed=True)`` defines it (``nn/fused.py:397-
        420``); the copies are the reference's cost too."""
        kpath = mod.path + SEP + "kernel"
        if kpath not in self.bmodel.rho:
            return mod(x)
        lead, K = tuple(x.shape[:-1]), x.shape[-1]
        xs = x.reshape(self.S, -1, K).contiguous()
        mu, rho = transposed_view(mod, self.bmodel.rho[kpath])
        view = (lambda a: a.t().contiguous()) if mod.transposed else None
        y, new_leaf, _ = self._route_matmul(kpath, mu, rho, xs, view, source=x)
        return self._bias(y, mod, new_leaf).reshape(lead + (y.shape[-1],))

    def _bias(self, y, mod, new_leaf):
        """A converted layer's bias: sampled where it is converted, else
        the frequentist one (under tp a column layer's block of it; a row
        layer's whole bias, added once after "g")."""
        bpath = mod.path + SEP + "bias"
        if bpath in self.bmodel.rho:
            return self._add_bias(y, mod, bpath, new_leaf)
        return mod.add_bias(y)

    def conv(self, mod, x: torch.Tensor) -> torch.Tensor:
        """A converted ``Conv`` (``CONV_RULE``; the reference's
        ``handle_conv``, ``nn/fused.py:422-440``) over an S-major (S*B,
        *spatial, cin) input: its im2col patches (``nn/conv.py::lower_conv``)
        through the same Bayesian linear op as a ``Dense``, the draw defined
        on the channel-major (K, cout) view of mu and rho (``reorder``), then
        the bias. Unsupported configurations raise (``lower_conv``)."""
        kpath = mod.path + SEP + "kernel"
        if kpath not in self.bmodel.rho:
            return mod(x)
        kpath, patches, out_spatial = conv_lib.lower_conv(mod, x)
        mu, rho = conv_lib.reorder(mod.kernel), conv_lib.reorder(self.bmodel.rho[kpath])
        xs = patches.reshape(self.S, -1, patches.shape[-1]).contiguous()
        y, new_leaf, _ = self._route_matmul(kpath, mu, rho, xs, conv_lib.reorder)
        y = self._bias(y, mod, new_leaf)
        return y.reshape((x.shape[0],) + out_spatial + (y.shape[-1],))

    def embed(self, mod, ids: torch.Tensor) -> torch.Tensor:
        """A converted ``Embed`` (``EMBEDDING_RULE``; the reference's
        ``handle_embed``, ``nn/fused.py:477-512``) over S-major (S*B, ...)
        ids: the S sampled (V, D) tables of ``ops/fused_linear.py::
        sampled_weights`` (kernel #10 on the card, its pair instance for
        antithetic draws), each sample's ids looked up in its own table,
        and the log-probs evaluated at those tables in plain torch (the
        reference's XLA), so that they score the draw the forward used."""
        epath = mod.path + SEP + "embedding"
        if epath not in self.bmodel.rho:
            return mod(ids)
        mu, rho = mod.embedding, self.bmodel.rho[epath]
        V, D = mu.shape
        eps = None
        if self.eps_hook is not None:
            eps = self.eps_hook(epath, self.n_draws, (V, D))
        tables = ops_fused.sampled_weights(
            mu, rho, self.seeds[self.path_index[epath]], antithetic=self.antithetic,
            plain=self.plain, eps=eps)  # (S, V, D)
        ids_s = ids.reshape(self.S, -1)
        offset = torch.arange(self.S, device=ids.device)[:, None] * V
        out = lookup(tables.reshape(self.S * V, D), ids_s + offset)
        if epath not in self.seen:
            self.seen.add(epath)
            dims = (1, 2)
            lq = dist.gaussian_log_prob(tables, mu, dist.sigma_from_rho(rho), dim=dims)
            self.collected.append(
                (lq, self.bmodel.prior_log_prob(epath, tables, dim=dims), False))
        return out.reshape(tuple(ids.shape) + (D,))

    def _add_bias(self, y, mod, bpath, new_leaf):
        bmu = mod.bias
        brho = self.bmodel.rho[bpath]
        sharded = self._bias_plan(bpath, bmu.shape[0])[0]
        if self.eps_hook is not None:
            beps = self._global_eps(bpath, tuple(bmu.shape), "col" if sharded else "rep")
        else:
            beps = self.bias_eps[bpath]
        beps = beps.to(bmu.dtype)
        if self.antithetic:
            beps = self.interleave(beps)
        bsig = dist.sigma_from_rho(brho)
        b = bmu[None] + bsig[None] * beps
        y = y + b[:, None, :].to(y.dtype)  # bf16 activations stay bf16
        if new_leaf:
            kw = self._prior_kwargs(bpath)
            prior = prior_of(**kw)
            centre = bmu if prior == ON_MU else kw.get("prior_mu")
            self.collected.append(bias_logprobs(b, bsig, beps, prior, centre) + (sharded,))
        return y

    def aux(self) -> dict[str, torch.Tensor]:
        """The summed log-probs; under tp the sharded leaves' local sums
        are all-reduced once ("g"), the replicated leaves counted once."""
        self.check_seen(self.collected)
        out = {}
        for key, j in (("log_prior", 1), ("log_variational_posterior", 0)):
            total = torch.stack([c[j] for c in self.collected if not c[2]]).sum(0)
            sharded = [c[j] for c in self.collected if c[2]]
            if sharded:
                total = total + coll.reduce_from_shards(torch.stack(sharded).sum(0),
                                                        self.tp.group)
            out[key] = total
        return out


def fused_mc_apply(bmodel, seed: int, n_samples: int, *args,
                   save_weights: bool = True, antithetic: bool = False,
                   impl: str = "kernel", eps_hook=None, untile_axes: tuple[int, ...] = (),
                   tp=None, **inputs):
    """S-sample fused forward of a converted model over its inputs (``args``
    and ``inputs``, as the model takes them: :func:`run_mc`). Returns
    ``(outputs, aux)``: outputs (S, B, ...) and aux ``log_prior`` /
    ``log_variational_posterior`` of shape (S,). ``antithetic=True`` pairs
    the draws (even ``n_samples``). ``save_weights=False`` writes no W
    residuals; a backward through such a forward regenerates each layer's
    W from its seeds (``ops/fused_linear.py::BayesLinearRegen``).
    ``untile_axes``: :func:`untile_samples`. ``tp`` (a
    ``parallel.collectives.TPContext``) runs the Megatron plan over a model
    whose leaves hold this rank's shards (``parallel/mesh.py``); an
    ``eps_hook`` then still gives each leaf's whole draw, of which the rank
    takes its block."""
    mc = FusedMC(bmodel, seed, n_samples, antithetic=antithetic,
                 save_weights=save_weights, impl=impl, eps_hook=eps_hook, tp=tp)
    return run_mc(mc, n_samples, *args, untile_axes=untile_axes, **inputs)
