"""Bayesian autoregressive generation: posterior-predictive decoding, the
counterpart of ``bayeformers_tpu/generation.py``.

A draw from the posterior is a function: one coherent weight set
(:meth:`BayesianModel.sample`), under which a whole sequence is decoded.
Weights are never re-sampled per token, which would decode under an
"average" model that no draw is. The draws are taken one after another and
never stacked (S GPT-2 posteriors at once are ~5 GB); each runs the model
through ``torch.func.functional_call`` with its sampled leaves, and decodes
with a KV cache (``decode_step`` of ``models/gpt2.py``, ``models/llama.py``
and ``models/t5.py``). The decode is plain torch, as the reference's is
HF's stock ``generate`` in XLA: no Bayesian linear kernel runs, the
weights being concrete.

HF's ``generate`` semantics (its Flax greedy and sampling loops): the
prompt, then one token a step up to ``max_length = L0 + max_new_tokens``;
greedy takes the argmax, sampling divides the logits by ``temperature``,
keeps the ``top_k`` largest and draws from the softmax; a row that emits
``eos_token_id`` is finished and padded with ``pad_token_id`` from then
on, and decoding stops when every row has finished. A decoder-only model's
sequences carry the prompt; T5's are decoder-side, from its start id, with
the same ``max_length``. Disagreement between the S sequences is the
epistemic signal: ``agreement`` is the per-position share of draws that
voted for the majority token.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from bayeformers_tpu_torch.nn.fused import derive_seed


def _majority_and_agreement(seqs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(S, B, T) int sequences -> the per-position majority token (B, T)
    (the smallest among tied counts, as ``np.unique`` orders them) and the
    share of draws that agree with it (B, T)."""
    S = seqs.shape[0]
    maj = np.empty(seqs.shape[1:], seqs.dtype)
    agree = np.empty(seqs.shape[1:], np.float32)
    for b in range(seqs.shape[1]):
        for t in range(seqs.shape[2]):
            vals, counts = np.unique(seqs[:, b, t], return_counts=True)
            i = int(np.argmax(counts))
            maj[b, t] = vals[i]
            agree[b, t] = counts[i] / S
    return maj, agree


class _Bound(nn.Module):
    """Holds a model so that ``torch.func.functional_call`` can swap its
    parameters for a whole decode: ``forward(fn, *args)`` is ``fn(model,
    *args)``."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, fn, *args):
        return fn(self.model, *args)


def _next_token(logits, do_sample, temperature, top_k, gen):
    """The next ids of (B, V) f32 logits: the argmax, or a draw from the
    softmax of the logits over ``temperature`` kept to the ``top_k``
    largest."""
    if not do_sample:
        return torch.argmax(logits, dim=-1)
    if temperature != 1.0:
        logits = logits / temperature
    if top_k:
        kth = torch.topk(logits, min(top_k, logits.shape[-1]), dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, torch.full_like(logits, -float("inf")), logits)
    return torch.multinomial(torch.softmax(logits, dim=-1), 1, generator=gen)[:, 0]


def _decode(model, ids, mask, max_length, pick, pad_id, eos_id, use_cache, scores):
    """One draw's decode (the model holds the draw's weights): (B,
    max_length) sequences; each step's f32 logits appended to ``scores``."""
    B, L0 = ids.shape
    dev = ids.device
    seq2seq = model.generation == "seq2seq"
    first = 1 if seq2seq else L0
    seq = torch.full((B, max_length), pad_id, dtype=torch.long, device=dev)
    if seq2seq:
        seq[:, 0] = model.config.start_id
        enc = model.encode(ids, mask) if use_cache else None
    else:
        seq[:, :L0] = ids
        key_mask = torch.ones(B, max_length, dtype=torch.long, device=dev)
        key_mask[:, :L0] = mask
        pos = (mask.cumsum(-1) - 1).clamp_min(0)
    cache = model.init_cache(B, max_length) if use_cache else None
    finished = torch.zeros(B, dtype=torch.bool, device=dev)
    # a finished row is fed its pad id, which may lie outside the table
    # (GPT-2's fallback 50256 in a tiny vocabulary); its logits are unused
    feed = seq.clamp(max=model.config.vocab_size - 1)
    for t in range(first, max_length):
        if seq2seq and use_cache:
            logits = model.decode_step(feed[:, t - 1:t], t - 1, cache, enc)
        elif seq2seq:
            logits = model(ids, mask, decoder_input_ids=feed[:, :t])
        elif use_cache:
            # the prompt in one call, then one new id a call
            lo = 0 if t == L0 else t - 1
            logits = model.decode_step(feed[:, lo:t], pos, key_mask, lo, cache)
        else:
            # the cache's positions: the prompt's from its mask (a left-padded
            # row starts at its first real id), then one more a step
            steps = (key_mask[:, :t].cumsum(-1) - 1).clamp_min(0)
            logits = model(feed[:, :t], key_mask[:, :t], position_ids=steps)
        last = logits[:, -1].float()
        if scores is not None:
            scores.append(last)
        nxt = torch.where(finished, torch.full_like(finished, pad_id, dtype=torch.long),
                          pick(last))
        if eos_id is not None:
            finished = finished | (nxt == eos_id)
        seq[:, t] = nxt
        feed[:, t] = nxt.clamp(max=model.config.vocab_size - 1)
        if not seq2seq:
            pos = pos[:, -1:] + 1
        if bool(finished.all()):
            break
    return seq


@torch.no_grad()
def decode_draw(model: nn.Module, params: dict, ids, mask, max_length: int, pick,
                pad_id: int, eos_id: Optional[int], use_cache: bool = True,
                scores: Optional[list] = None) -> torch.Tensor:
    """One draw's decode: ``model`` run with the converted leaves ``params``
    ({path: w}, :meth:`BayesianModel.sample`'s) in place of its own through
    ``torch.func.functional_call``; ``pick`` maps (B, V) f32 logits to the
    next ids. Returns the (B, max_length) sequences; each step's logits go
    into ``scores`` when it is a list."""
    return torch.func.functional_call(
        _Bound(model), {"model." + p.replace("/", "."): w for p, w in params.items()},
        (_decode, ids, mask, max_length, pick, pad_id, eos_id, use_cache, scores))


@torch.no_grad()
def mc_generate(model: nn.Module, bmodel, n_samples: int, input_ids, attention_mask=None,
                max_new_tokens: int = 20, do_sample: bool = False, temperature: float = 1.0,
                top_k: Optional[int] = None, pad_token_id: Optional[int] = None,
                seed: int = 0, eos_token_id: Optional[int] = None, use_cache: bool = True,
                output_scores: bool = False) -> dict:
    """Decode ``n_samples`` posterior-predictive continuations of
    ``input_ids`` (B, L0).

    ``model`` is the port's causal LM (GPT-2, the LLaMA families) or T5,
    ``bmodel`` the conversion over it (``bmodel.model is model``). Draw s
    takes its weights from a ``torch.Generator`` seeded ``derive_seed(seed,
    s, 0)`` and, with ``do_sample``, its tokens from one seeded
    ``derive_seed(seed, s, 1)``. ``do_sample=False`` is greedy per draw:
    the sequences then differ only through the weights. ``pad_token_id``
    defaults to the reference's fallback, the config's pad id or else its
    eos id or else 0 (a pad id of 0 falls through, as it does there);
    ``eos_token_id`` (a port keyword) to the config's. ``use_cache=False``
    recomputes the whole prefix every step, at the cache's positions (the
    yardstick of the cache); ``output_scores`` returns every step's
    logits.

    Returns host numpy: ``sequences`` (S, B, L0 + max_new_tokens), the
    prompt included (T5: decoder-side, from its start id), ``majority`` and
    ``agreement`` (B, T), ``prompt_len``, and with ``output_scores``
    ``scores`` (S, B, steps, vocab) f32. Whisper raises: the reference's
    ``mc_generate`` passes its features as ids and fails, and the port adds
    no Whisper decode that the reference lacks."""
    if getattr(model, "family", None) == "whisper":
        raise ValueError("mc_generate does not decode Whisper: the reference's mc_generate "
                         "takes input_features for input_ids and fails on its shapes")
    if not hasattr(model, "decode_step"):
        raise ValueError(f"mc_generate decodes GPT-2, the LLaMA families and T5, not "
                         f"{type(model).__name__}")
    if bmodel.model is not model:
        raise ValueError("bmodel must be the conversion of model")
    dev = bmodel.device
    ids = torch.as_tensor(input_ids, device=dev).long()
    mask = (torch.ones_like(ids) if attention_mask is None
            else torch.as_tensor(attention_mask, device=dev).long())
    cfg = model.config
    if pad_token_id is None:
        pad_token_id = cfg.pad_token_id or cfg.eos_token_id or 0
    if eos_token_id is None:
        eos_token_id = cfg.eos_token_id
    max_length = ids.shape[1] + max_new_tokens
    seqs, all_scores = [], []
    for s in range(n_samples):
        wgen = torch.Generator(device=dev).manual_seed(derive_seed(seed, s, 0))
        dgen = torch.Generator(device=dev).manual_seed(derive_seed(seed, s, 1))
        params, _, _ = bmodel.sample(wgen)
        scores = [] if output_scores else None

        def pick(logits, dgen=dgen):
            return _next_token(logits, do_sample, temperature, top_k, dgen)

        seq = decode_draw(model, params, ids, mask, max_length, pick, pad_token_id,
                          eos_token_id, use_cache, scores)
        seqs.append(seq.cpu().numpy())
        if output_scores:
            all_scores.append(torch.stack(scores, dim=1).cpu().numpy())
        del params
    seqs = np.stack(seqs)
    majority, agreement = _majority_and_agreement(seqs)
    out = {"sequences": seqs, "majority": majority, "agreement": agreement,
           "prompt_len": int(ids.shape[1])}
    if output_scores:
        out["scores"] = np.stack(all_scores)
    return out
