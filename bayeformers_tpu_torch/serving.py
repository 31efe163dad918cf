"""Batched posterior-predictive inference (counterpart of
``bayeformers_tpu/serving.py::Predictor``).

A :class:`Predictor` pads a ragged request up to the smallest configured
(batch, sequence) bucket, always masking the padding, runs one fused
S-sample forward without weight residuals, drops the padded rows, and
returns posterior-predictive summaries: mean probabilities, epistemic std,
predictive entropy and the BALD mutual information. ``task="causal-lm"``
(GPT-2) summarises the next token after each row's last live position:
its ``top_k`` ids, their mean probabilities and epistemic std, the
entropy and the mutual information. ``task="qa"`` (a span head) gives
the same summaries of the start and of the end position over the
sequence (``start_*``, ``end_*``), each draw's log-probabilities
(``start_logp_draws`` / ``end_logp_draws``, (n, S, L)) and each row's
``n_best`` answer spans (``spans``).

Deterministic serving: a request's draws derive from the caller's seed and
its bucket, so identical (inputs, seed) give identical outputs on the same
hardware (the kernels sum in a fixed order; nothing uses float atomics).

Usage::

    predictor = Predictor(bmodel, n_samples=10, batch_sizes=(8,),
                          seq_lens=(128,))
    out = predictor(batch, seed=123)      # dict of numpy arrays, depadded
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from bayeformers_tpu_torch.models import families
from bayeformers_tpu_torch.nn.fused import derive_seed
from bayeformers_tpu_torch.utils import squad as squad_lib


def _trim_pad_columns(batch: dict) -> dict:
    """Drop trailing all-pad token columns so short requests land in the
    smallest sequence bucket that fits (featurizers pad to the largest)."""
    true_l = max(1, int(np.asarray(batch["attention_mask"]).sum(-1).max()))
    return {k: np.asarray(v)[:, :true_l] for k, v in batch.items()}


def _bucket(value: int, sizes: tuple[int, ...], kind: str) -> int:
    for s in sorted(sizes):
        if value <= s:
            return s
    raise ValueError(
        f"{kind}={value} exceeds the largest configured bucket {max(sizes)}; "
        f"raise Predictor({kind}s=...) or shard the request"
    )


def summarize_qa(start: torch.Tensor, end: torch.Tensor,
                 attention_mask: torch.Tensor) -> dict[str, torch.Tensor]:
    """(S, B, L) start and end logits -> the summaries of each over the
    sequence (reference ``serving.py:102-128``): padded positions (the
    bucket's among them) take ``finfo(f32).min`` first, so no probability
    reaches them; ``start_*`` / ``end_*`` as :func:`summarize` gives them,
    and each draw's log-probabilities, (B, S, L)."""
    neg = torch.finfo(torch.float32).min
    live = attention_mask[None] > 0
    out = {}
    for tag, logits in (("start", start), ("end", end)):
        masked = torch.where(live, logits.float(), torch.full((), neg, device=logits.device))
        out.update({f"{tag}_{k}": v for k, v in summarize(masked).items()})
        out[f"{tag}_logp_draws"] = torch.log_softmax(masked, dim=-1).transpose(0, 1)
    return out


def summarize(logits: torch.Tensor) -> dict[str, torch.Tensor]:
    """(S, B, C) logits -> posterior-predictive summaries over the S draws."""
    probs_s = torch.softmax(logits.float(), dim=-1)
    probs = probs_s.mean(0)

    def ent(p):
        return -torch.sum(p * torch.log(torch.clamp(p, min=1e-12)), dim=-1)

    entropy = ent(probs)
    return {
        "probs": probs,
        "epistemic_std": probs_s.std(0, unbiased=False),
        "entropy": entropy,
        # BALD: H[mean_s p_s] - mean_s H[p_s], the epistemic share
        "mutual_info": entropy - ent(probs_s).mean(0),
        "pred": torch.argmax(probs, dim=-1),
    }


def summarize_causal_lm(logits: torch.Tensor, attention_mask: torch.Tensor,
                        top_k: int) -> dict[str, torch.Tensor]:
    """(S, B, L, V) next-token logits -> the summaries of the token after
    each row's last live position (the JAX package's ``serving.py:132-
    162``): ``topk_ids`` / ``topk_probs`` / ``topk_epistemic_std`` (B,
    top_k) of the S-mean distribution, its ``entropy``, the BALD
    ``mutual_info`` and ``pred``. An all-pad bucket row gathers position 0
    and is depadded by the caller."""
    idx = torch.clamp_min(attention_mask.sum(-1) - 1, 0)  # (B,)
    rows = torch.arange(logits.shape[1], device=logits.device)
    last = logits[:, rows, idx].float()  # (S, B, V)
    probs_s = torch.softmax(last, dim=-1)
    probs = probs_s.mean(0)

    def ent(p):
        return -torch.sum(p * torch.log(torch.clamp(p, min=1e-12)), dim=-1)

    entropy = ent(probs)
    top_p, top_ids = torch.topk(probs, top_k, dim=-1)
    std_at_top = torch.gather(probs_s.std(0, unbiased=False), -1, top_ids)
    return {
        "topk_ids": top_ids,
        "topk_probs": top_p,
        "topk_epistemic_std": std_at_top,
        "entropy": entropy,
        "mutual_info": entropy - ent(probs_s).mean(0),
        "pred": top_ids[:, 0],
    }


@dataclasses.dataclass
class Predictor:
    """Bucketed Bayesian serving over a converted model.

    ``antithetic=False`` (the default, as in the reference) draws every
    sample's weights independently; ``antithetic=True`` pairs the draws and
    needs an even ``n_samples``. ``task`` is ``"classification"``,
    ``"qa"`` (a span head: :func:`summarize_qa` and the ``n_best`` spans of
    at most ``max_answer_len`` tokens, :meth:`_decode_spans`) or
    ``"causal-lm"`` (a decoder such as GPT-2: next-token summaries at each
    row's last live position, :func:`summarize_causal_lm`, ``top_k``
    candidates). ``input_keys`` are the model's inputs and ``pad_id`` fills
    the bucket's padded ids; left as None they come from the model
    (``models.families.input_keys``: DistilBERT and RoBERTa take no token
    types; the config's ``pad_token_id``, RoBERTa's 1, else 0).
    """

    bmodel: Any
    n_samples: int = 10
    batch_sizes: tuple[int, ...] = (1, 8, 32)
    seq_lens: tuple[int, ...] = (128,)
    pad_id: Optional[int] = None
    antithetic: bool = False
    task: str = "classification"
    max_answer_len: int = 30  # qa: span-length cap (HF's default)
    n_best: int = 5           # qa: spans returned a row
    top_k: int = 50  # causal-lm: next-token candidates returned
    input_keys: Optional[tuple[str, ...]] = None

    def __post_init__(self):
        model = self.bmodel.model
        if self.input_keys is None:
            self.input_keys = families.input_keys(model)
        if self.pad_id is None:
            self.pad_id = getattr(getattr(model, "config", None), "pad_token_id", None) or 0
        if self.antithetic and self.n_samples % 2:
            raise ValueError("antithetic serving needs an even n_samples")
        if self.task not in ("classification", "qa", "causal-lm"):
            raise ValueError(f"unknown task {self.task!r}")
        head = getattr(model, "task", None)  # an encoder's head
        if (self.task == "qa") != (head == "qa") and self.task != "causal-lm":
            raise ValueError(f"Predictor(task={self.task!r}) over a model whose head is "
                             f"{head!r}: task='qa' needs a span head (task='qa') and "
                             "a span head serves task='qa'")

    def __call__(self, batch: dict, seed: int = 0, features: list | None = None,
                 contexts: list | None = None) -> dict:
        """Run one request batch; returns numpy arrays with the padded rows
        dropped (causal-lm summaries are per row: no position to depad; qa's
        per-position arrays drop the padded positions too, and ``spans``
        holds each row's n-best ``{"start", "end", "score", "text"}``, the
        text decoded where ``features`` and ``contexts``, ``featurize``'s
        features and their context strings, one a row, are given)."""
        inputs = {k: np.asarray(batch[k]) for k in self.input_keys if k in batch}
        n, L = inputs["input_ids"].shape
        if "attention_mask" not in inputs:
            # bucket padding must be masked even when the caller omits the
            # mask, else results depend on the bucket the request lands in
            inputs["attention_mask"] = np.ones((n, L), np.int64)
        nb = _bucket(n, self.batch_sizes, "batch_size")
        lb = _bucket(L, self.seq_lens, "seq_len")
        dev = self.bmodel.device
        padded = {}
        for k, v in inputs.items():
            fill = self.pad_id if k == "input_ids" else 0
            out = np.full((nb, lb), fill, np.int64)
            out[:n, :L] = v
            padded[k] = torch.from_numpy(out).to(dev)
        key = derive_seed(seed, nb * 100003 + lb)
        with torch.inference_mode():
            logits, _ = self.bmodel.mc_apply_fused(
                key, self.n_samples, padded["input_ids"],
                padded["attention_mask"], padded.get("token_type_ids"),
                save_weights=False, antithetic=self.antithetic,
            )
            if self.task == "causal-lm":
                out = summarize_causal_lm(logits, padded["attention_mask"], self.top_k)
            elif self.task == "qa":
                out = summarize_qa(*logits, padded["attention_mask"])
            else:
                out = summarize(logits)
            out = {k: v.cpu().numpy() for k, v in out.items()}
        if self.task != "qa":
            return {k: v[:n] for k, v in out.items()}
        result = {}
        for k, v in out.items():
            if k.endswith("_logp_draws"):  # (B, S, L): draws, not rows
                result[k] = v[:n, :, :L]
            elif v.ndim >= 2:
                result[k] = v[:n, :L]
            else:
                result[k] = v[:n]
        result["spans"] = self._decode_spans(result, n, features, contexts)
        return result

    def _decode_spans(self, result, n, features, contexts):
        """Each row's ``n_best`` spans by descending ``log p(start) + log
        p(end)`` under the S-mean distributions (reference ``serving.py:
        391-417``), with the answer text where the row's feature and context
        are given."""
        log_start = np.log(np.clip(result["start_probs"], 1e-12, None))
        log_end = np.log(np.clip(result["end_probs"], 1e-12, None))
        spans = []
        for i in range(n):
            feat = features[i] if features else None
            offset = feat["context_offset"] if feat else 0
            best = squad_lib.n_best_spans(log_start[i], log_end[i], offset,
                                          max_answer_len=self.max_answer_len,
                                          n_best=self.n_best)
            spans.append([
                {"start": s, "end": e, "score": score,
                 "text": (squad_lib.decode_span(feat, contexts[i], s, e)
                          if feat is not None and contexts is not None else None)}
                for s, e, score in best])
        return spans

    def predict_texts(self, texts: list, *, tokenizer, seed: int = 0) -> dict:
        """Raw-string serving needs the native tokenizer, which the port
        does not bind yet."""
        raise NotImplementedError(
            "Predictor.predict_texts needs the native WordPiece/BPE tokenizer "
            "(ROADMAP queue 1 item 2, the native tokenizer binding)")

    def predict_featurized(self, batch: dict, seed: int = 0, **kwargs) -> dict:
        """Serve a batch a featurizer padded to its own maximum length: the
        trailing all-pad columns go first, so it lands in the smallest
        sequence bucket that fits (``kwargs``: qa's features and contexts)."""
        return self(_trim_pad_columns(batch), seed=seed, **kwargs)
