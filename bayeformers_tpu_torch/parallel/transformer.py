"""Depth-stacked Bayesian transformer blocks and their causal LM (counterpart
of ``bayeformers_tpu/parallel/transformer.py``).

:class:`TransformerStack` holds L pre-LN blocks ``h <- h + O(attn(LN1(h)))``,
``h <- h + FFN(LN2(h))`` with every projection a Gaussian variational
posterior (``parallel/sampling.py::bayes_dense``: kernels #7/#8 forward and
#9 backward on a CUDA tensor), parameters stacked along a leading depth
axis under the reference's leaf names: ``qkv_mu``/``qkv_rho`` (L, d, 3d),
``qkv_bmu``/``qkv_brho`` (L, 3d), ``o_*``, ``ln1_scale``/``ln1_bias``,
``ln2_*`` and either the dense FFN's ``wi_*``/``wo_*`` or, with ``moe=``, a
``BayesMoE`` of depth L under ``moe.`` (leaves (L, E, ...), router (L, d,
E)). LayerNorm (eps 1e-6, biased variance), the router and the LM's
embeddings stay frequentist. The attention is plain torch, as the
reference's is XLA einsums: scores scaled by 1/sqrt(hd), masked by
``where(causal, s, -1e30)``, softmax in f32, the probabilities cast back.

Block l's projections j = 0..3 (packed QKV, output, FFN in, FFN out) draw
from (the draw's seed, (l, j)); its experts from (seed, (l, 2, e, j)).

:class:`TransformerLM` (:func:`lm_init`) adds a token table ``embed`` (V,
d) and positions ``pos`` (T, d), the readout tied to ``embed``. The three
step factories are the reference's: :func:`make_single_lm_train_step`,
:func:`make_pp_lm_train_step` (the pipeline schedule over microbatches; a
MoE stack raises) and :func:`make_ep_lm_train_step` (a MoE stack). Across
ranks (``group``, one process or thread a rank, collectives over gloo or
NCCL) the pp step runs the stack's stages by ``pipeline_apply`` over the
point-to-point shift, every stage embedding the batch (through the "f"
``copy_to_shards``, so that the embed and pos gradients are whole and
equal on every stage) and reading out the whole output; the ep step runs
every block's experts as ``BayesMoE`` shards (``moe.shard_experts``), the
attention, LayerNorms, routers and tables replicated.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from bayeformers_tpu_torch.models.bert import check_device, lookup
from bayeformers_tpu_torch.nn.layers import Generator, as_generator
from bayeformers_tpu_torch.parallel import collectives as coll
from bayeformers_tpu_torch.parallel import sampling
from bayeformers_tpu_torch.parallel.moe import BayesMoE
from bayeformers_tpu_torch.parallel.pipeline import elbo_step, pipeline_apply

def _layer_norm(x, scale, bias, eps: float = 1e-6):
    m = torch.mean(x, dim=-1, keepdim=True)
    v = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    return (x - m) * torch.rsqrt(v + eps) * scale + bias


def _dense(leaf, name: str, h, seed: int, path: tuple, plain: bool):
    return sampling.bayes_dense(h, leaf[f"{name}_mu"], leaf[f"{name}_rho"],
                                leaf[f"{name}_bmu"], leaf[f"{name}_brho"], seed, path,
                                plain)


class TransformerStack(nn.Module):
    """L stacked pre-LN Bayesian transformer blocks with causal attention
    (the reference's default; no caller unmasks it) of width ``d_model``,
    ``n_heads`` heads, FFN width ``d_ff`` (dense) or the MoE FFN of
    ``moe=dict(n_experts=, ffn=, capacity_factor=)``; the reference's init
    (uniform variational pairs, unit LayerNorm scales, zero biases) from
    ``generator``, on ``device``."""

    def __init__(self, n_blocks: int, d_model: int, n_heads: int, d_ff: int,
                 moe: Optional[dict] = None, *, generator: Generator = 0, device="cuda"):
        super().__init__()
        if d_model % n_heads:
            raise ValueError(f"d_model {d_model} % n_heads {n_heads} != 0")
        self.n_blocks, self.d_model, self.n_heads, self.d_ff = n_blocks, d_model, n_heads, d_ff
        self.n_shards = 1
        device = check_device(device, "TransformerStack")
        gen = as_generator(generator)
        L, d, f = n_blocks, d_model, d_ff
        shapes = {"qkv": (d, 3 * d), "o": (d, d)}
        if moe is None:
            shapes.update(wi=(d, f), wo=(f, d))
        for name, (k, n) in shapes.items():
            mu, rho = sampling.stacked_uniform(gen, (L, k, n), device)
            bmu, brho = sampling.stacked_uniform(gen, (L, n), device)
            setattr(self, f"{name}_mu", mu)
            setattr(self, f"{name}_rho", rho)
            setattr(self, f"{name}_bmu", bmu)
            setattr(self, f"{name}_brho", brho)
        for ln in ("ln1", "ln2"):
            setattr(self, f"{ln}_scale", nn.Parameter(torch.ones(L, d, device=device)))
            setattr(self, f"{ln}_bias", nn.Parameter(torch.zeros(L, d, device=device)))
        self.moe = None if moe is None else BayesMoE(
            features=d, depth=L, generator=gen, device=device, **moe)

    def leaves(self) -> list[dict]:
        """Each block's leaves, views of the stacked parameters (the MoE's
        under ``"moe"``), one unbind a leaf."""
        names = [n for n, _ in self.named_parameters(recurse=False)]
        per = [getattr(self, n).unbind(0) for n in names]
        out = [dict(zip(names, ts)) for ts in zip(*per)]
        if self.moe is not None:
            moe = self.moe.params()
            for leaf, ts in zip(out, zip(*(v.unbind(0) for v in moe.values()))):
                leaf["moe"] = dict(zip(moe, ts))
        return out

    def dummy_input(self) -> torch.Tensor:
        """The reference's KL-probe activation, a 1-token sequence (1, 1, d)."""
        return self.ln1_scale.new_zeros((1, 1, self.d_model))

    def block_apply(self, leaf, seed: int, global_idx: int, h: torch.Tensor,
                    plain: bool = False, group=None):
        """One block on ``h`` (mb, T, d): ``(h', log_q, log_p)``; the draws
        are functions of (seed, global_idx) only. ``group``: the ep ranks
        of a MoE stack's expert shards."""
        mb, T, d = h.shape
        nh, hd = self.n_heads, d // self.n_heads
        x = _layer_norm(h, leaf["ln1_scale"], leaf["ln1_bias"])
        qkv, lq, lp = _dense(leaf, "qkv", x.reshape(mb * T, d), seed, (global_idx, 0), plain)
        qkv = qkv.reshape(mb, T, 3, nh, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / torch.sqrt(
            torch.tensor(hd, dtype=h.dtype, device=h.device))
        mask = torch.tril(torch.ones(T, T, dtype=torch.bool, device=h.device))
        scores = torch.where(mask, scores, torch.tensor(-1e30, dtype=scores.dtype,
                                                        device=h.device))
        probs = torch.softmax(scores.float(), dim=-1)
        attn = torch.einsum("bhqk,bkhd->bqhd", probs.to(h.dtype), v)
        o, lq2, lp2 = _dense(leaf, "o", attn.reshape(mb * T, d), seed, (global_idx, 1), plain)
        h = h + o.reshape(mb, T, d)
        tokens = _layer_norm(h, leaf["ln2_scale"], leaf["ln2_bias"]).reshape(mb * T, d)
        if self.moe is None:
            hidden, lq3, lp3 = _dense(leaf, "wi", tokens, seed, (global_idx, 2), plain)
            out, lq4, lp4 = _dense(leaf, "wo", sampling.gelu(hidden), seed,
                                   (global_idx, 3), plain)
            lq_ffn, lp_ffn = lq3 + lq4, lp3 + lp4
        else:
            out, lq_ffn, lp_ffn = self.moe.apply_local(leaf["moe"], seed, tokens,
                                                       path=(global_idx, 2), group=group,
                                                       plain=plain)
        h = h + out.reshape(mb, T, d)
        return h, lq + lq2 + lq_ffn, lp + lp2 + lp_ffn

    def apply_stack(self, seed: int, h: torch.Tensor, *, group=None, plain: bool = False):
        """Every block in depth order on ``h`` (B, T, d): ``(h', log_q,
        log_p)``. ``group``: the ep ranks of a MoE stack cut by
        ``moe.shard_experts`` (a dense stack runs over ranks by
        ``pipeline_apply``)."""
        if self.moe is None and coll.group_size(group) > 1:
            raise ValueError("apply_stack's group shards a MoE stack's experts; a dense "
                             "stack runs its stages over ranks by pipeline_apply")
        sampling.check_group(group, self.moe, "TransformerStack.apply_stack")
        log_q = log_p = None
        for l, leaf in enumerate(self.leaves()):
            h, lq, lp = self.block_apply(leaf, seed, l, h, plain, group)
            log_q = lq if log_q is None else log_q + lq
            log_p = lp if log_p is None else log_p + lp
        return h, log_q, log_p


class TransformerLM(nn.Module):
    """The stack with a frequentist token table ``embed`` (V, d) and
    positions ``pos`` (T, d) ~ N(0, 1/d), the readout tied to ``embed``."""

    def __init__(self, stack: TransformerStack, vocab: int, seq_len: int,
                 generator: Generator = 1):
        super().__init__()
        gen = as_generator(generator)
        d, dev = stack.d_model, stack.ln1_scale.device
        self.stack = stack
        self.embed = nn.Parameter((torch.randn(vocab, d, generator=gen) * d ** -0.5).to(dev))
        self.pos = nn.Parameter((torch.randn(seq_len, d, generator=gen) * d ** -0.5).to(dev))

    def inputs(self, tokens: torch.Tensor) -> torch.Tensor:
        """``embed[tokens] + pos[:T]`` (the lookup's fixed-order backward)."""
        return lookup(self.embed, tokens) + self.pos[None, : tokens.shape[1]]

    def readout(self, h: torch.Tensor) -> torch.Tensor:
        return h @ self.embed.t()


def lm_init(stack: TransformerStack, vocab: int, seq_len: int,
            generator: Generator = 1) -> TransformerLM:
    """The LM around ``stack``: its tables drawn from ``generator``."""
    return TransformerLM(stack, vocab, seq_len, generator)


def lm_logits_single(lm: TransformerLM, seed: int, tokens: torch.Tensor,
                     plain: bool = False, group=None):
    """``tokens`` (B, T) -> ``(logits (B, T, V), log_q, log_p)``; ``group``:
    a MoE stack's ep ranks."""
    h, lq, lp = lm.stack.apply_stack(seed, lm.inputs(tokens), group=group, plain=plain)
    return lm.readout(h), lq, lp


def _lm_loss(logits, batch):
    """Next-token CE summed over B T, with ``acc`` and ``copy_acc`` (the
    accuracy on ``batch["eval_mask"]``'s positions)."""
    targets = batch["targets"].long()
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -torch.sum(torch.gather(logp, -1, targets[..., None]))
    hit = (torch.argmax(logits, -1) == targets).float()
    mask = batch["eval_mask"].float()
    return nll, {"acc": torch.mean(hit),
                 "copy_acc": torch.sum(hit * mask) / torch.clamp_min(torch.sum(mask), 1.0)}


def make_single_lm_train_step(lm: TransformerLM, optimizer, *, n_samples: int,
                              n_batches: int, plain: bool = False, group=None):
    """``step(seed, batch) -> metrics``: the LM's MC-ELBO step on
    ``batch["tokens"]`` (``pipeline.elbo_step``), updating ``lm`` in place
    through ``optimizer``; ``group`` the ranks of a MoE stack's experts
    (:func:`make_ep_lm_train_step`)."""
    def step(seed: int, batch: dict) -> dict[str, torch.Tensor]:
        return elbo_step(optimizer, n_samples, n_batches,
                         lambda s: lm_logits_single(lm, s, batch["tokens"], plain, group),
                         _lm_loss, batch, seed)

    return step


def make_pp_lm_train_step(lm: TransformerLM, optimizer, *, n_samples: int, n_batches: int,
                          n_microbatches: int, group=None, plain: bool = False):
    """The LM's step with the stack run by ``pipeline_apply`` over
    ``n_microbatches`` microbatches, its stages over the ranks of ``group``
    (``pipeline.make_pp_mesh``, the stack cut by ``pipeline.shard_stack``);
    a MoE stack raises, as in the reference."""
    if lm.stack.moe is not None:
        raise NotImplementedError(
            "pp over a MoE-FFN TransformerStack needs a pp x ep mesh; "
            "shard experts with make_ep_lm_train_step or use a dense FFN")
    ranks = sampling.check_group(group, lm.stack, "make_pp_lm_train_step")

    def forward(s, tokens):
        h = lm.inputs(tokens)
        if ranks is not None:
            # the "f": only stage 0 reads the embedded input, so its
            # cotangent is summed onto every stage in the backward
            h = coll.copy_to_shards(h, ranks.group)
        out, lq, lp = pipeline_apply(lm.stack, s, h, n_microbatches=n_microbatches,
                                     group=group, plain=plain)
        return lm.readout(out), lq, lp

    def step(seed: int, batch: dict) -> dict[str, torch.Tensor]:
        return elbo_step(optimizer, n_samples, n_batches,
                         lambda s: forward(s, batch["tokens"]), _lm_loss, batch, seed)

    return step


def make_ep_lm_train_step(lm: TransformerLM, optimizer, *, n_samples: int, n_batches: int,
                          group=None, plain: bool = False):
    """The MoE-FFN LM's step, every block's experts over the ranks of
    ``group`` (``moe.make_ep_mesh``, the LM cut by ``moe.shard_experts``;
    at one rank :func:`make_single_lm_train_step`'s computation); a dense
    stack raises ``ValueError``, as in the reference."""
    if lm.stack.moe is None:
        raise ValueError("make_ep_lm_train_step needs a MoE TransformerStack")
    sampling.check_group(group, lm.stack.moe, "make_ep_lm_train_step")
    return make_single_lm_train_step(lm, optimizer, n_samples=n_samples, n_batches=n_batches,
                                     plain=plain, group=group)
