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

Raw strings go through :meth:`Predictor.predict_texts` and the native
tokenizers (``bayeformers_tpu_torch/native``): sentence pairs featurized
as GLUE is, (question, context) pairs in SQuAD's ``doc_stride`` windows
whose spans compete per question, or text encoded by a BPE or Unigram
tokenizer for a causal LM. :meth:`Predictor.warmup` runs every (batch,
sequence) bucket once ahead of traffic.

Usage::

    predictor = Predictor(bmodel, n_samples=10, batch_sizes=(8,),
                          seq_lens=(128,))
    out = predictor(batch, seed=123)      # dict of numpy arrays, depadded
    out = predictor.predict_texts([("a sentence", "its pair")], tokenizer=wp)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from bayeformers_tpu_torch.models import families
from bayeformers_tpu_torch.nn.fused import derive_seed
from bayeformers_tpu_torch.utils import glue as glue_lib
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
    doc_stride: int = 128     # qa: window advance over a long context
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

    def warmup(self, seed: int = 0) -> int:
        """Run every (batch, sequence) bucket once ahead of traffic (an
        all-pad request each); returns the number of buckets run."""
        n = 0
        for b in self.batch_sizes:
            for L in self.seq_lens:
                self({"input_ids": np.full((b, L), self.pad_id, np.int64),
                      "attention_mask": np.zeros((b, L), np.int64),
                      "token_type_ids": np.zeros((b, L), np.int64)}, seed=seed)
                n += 1
        return n

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
        """Serve raw strings through a native tokenizer (the JAX package's
        ``serving.py:242-380``). ``texts`` by task:

        - ``classification``: strings or (sentence_a, sentence_b) pairs,
          encoded ``[CLS] a [SEP] (b [SEP])`` by ``glue.featurize_pairs``
          with a :class:`~bayeformers_tpu_torch.native.WordPieceTokenizer`;
        - ``qa``: (question, context) pairs featurized into SQuAD's
          ``doc_stride`` windows (``squad.featurize`` with the tokenizer's
          subword offsets), every window run (in chunks of the largest
          batch bucket) and each question's n-best spans gathered across its
          windows by descending score; the per-position arrays are per
          window (``feature_qid`` maps each to its question), with each
          draw's best answer a question (``draw_answers``) and the share of
          draws that agree with the most common one (``span_agreement``);
        - ``causal-lm``: strings encoded by a BPE or Unigram tokenizer and
          cut to their last ``max(seq_lens)`` tokens; ``topk_tokens`` holds
          the decoded candidates.
        """
        if tokenizer is None:
            raise ValueError("predict_texts needs a tokenizer (bayeformers_tpu_torch."
                             "native: WordPiece for the encoders, BPE or Unigram for "
                             "a causal LM)")
        max_seq = max(self.seq_lens)
        if self.task == "causal-lm":
            rows = [tokenizer.encode(t)[-max_seq:] for t in texts]
            L = max(1, max((len(r) for r in rows), default=1))
            ids = np.full((len(rows), L), self.pad_id, np.int64)
            mask = np.zeros((len(rows), L), np.int64)
            for i, r in enumerate(rows):
                ids[i, :len(r)] = r
                mask[i, :len(r)] = 1
            out = self({"input_ids": ids, "attention_mask": mask}, seed=seed)
            out["topk_tokens"] = [[tokenizer.decode([int(t)]) for t in row]
                                  for row in out["topk_ids"]]
            return out
        cls_id, sep_id = tokenizer.special_id("cls"), tokenizer.special_id("sep")
        if self.task == "qa":
            return self._predict_qa(texts, tokenizer, cls_id, sep_id, max_seq, seed)
        pairs = [t if isinstance(t, tuple) else (t, None) for t in texts]
        batch = glue_lib.featurize_pairs(pairs, [0] * len(pairs), tokenizer.tokenize,
                                         max_seq=max_seq, cls_id=cls_id, sep_id=sep_id,
                                         pad_id=self.pad_id)
        batch.pop("labels")
        return self(_trim_pad_columns(batch), seed=seed)

    def _predict_qa(self, texts, tokenizer, cls_id, sep_id, max_seq, seed) -> dict:
        """:meth:`predict_texts` for span heads: every window of every
        question, the n-best spans and each draw's answer per question."""
        examples = [{"qid": str(i), "question": q, "context": c, "answers": []}
                    for i, (q, c) in enumerate(texts)]
        feats = squad_lib.featurize(
            examples, tokenizer.tokenize, max_seq=max_seq, doc_stride=self.doc_stride,
            cls_id=cls_id, sep_id=sep_id, pad_id=self.pad_id, is_training=False,
            offsets_fn=getattr(tokenizer, "tokenize_with_offsets", None))
        nmax = max(self.batch_sizes)
        parts = []
        for lo in range(0, len(feats), nmax):
            chunk = feats[lo:lo + nmax]
            batch = {k: np.asarray([f[k] for f in chunk], np.int64)
                     for k in ("input_ids", "attention_mask", "token_type_ids")}
            parts.append(self(_trim_pad_columns(batch), seed=seed, features=chunk,
                              contexts=[texts[int(f["qid"])][1] for f in chunk]))
        # the chunks may trim to different lengths: per-position arrays are
        # padded to the widest, log-probs with -1e30 so that no span starts
        # in the padding
        widest = max(p["start_probs"].shape[1] for p in parts)
        out: dict = {}
        for k in parts[0]:
            if k == "spans":
                continue
            rows = [np.asarray(p[k]) for p in parts]
            if k.endswith("_logp_draws"):
                rows = [np.pad(r, [(0, 0), (0, 0), (0, widest - r.shape[2])],
                               constant_values=-1e30) for r in rows]
            elif rows[0].ndim >= 2:
                rows = [np.pad(r, [(0, 0), (0, widest - r.shape[1])]
                               + [(0, 0)] * (r.ndim - 2)) for r in rows]
            out[k] = np.concatenate(rows, axis=0)
        out["feature_qid"] = np.asarray([int(f["qid"]) for f in feats], np.int32)
        per_q: list[list] = [[] for _ in texts]
        for f, spans in zip(feats, [s for p in parts for s in p["spans"]]):
            per_q[int(f["qid"])].extend(spans)
        out["spans"] = [sorted(sp, key=lambda d: -d["score"])[:self.n_best]
                        for sp in per_q]
        # each draw decodes its own answer a question (its windows compete)
        n_draws = out["start_logp_draws"].shape[1]
        best_dq: list[list] = [[None] * n_draws for _ in texts]
        for fi, f in enumerate(feats):
            qi = int(f["qid"])
            for d in range(n_draws):
                (s, e), score = squad_lib.best_span(
                    out["start_logp_draws"][fi, d], out["end_logp_draws"][fi, d],
                    f["context_offset"], max_answer_len=self.max_answer_len)
                prev = best_dq[qi][d]
                if prev is None or score > prev[0]:
                    best_dq[qi][d] = (score, squad_lib.decode_span(f, texts[qi][1], s, e))
        out["draw_answers"] = [[t for _, t in per_d] for per_d in best_dq]
        agreement = []
        for answers in out["draw_answers"]:
            counts: dict[str, int] = {}
            for a in answers:
                counts[a] = counts.get(a, 0) + 1
            agreement.append(max(counts.values()) / n_draws)
        out["span_agreement"] = np.asarray(agreement, np.float32)
        return out

    def predict_featurized(self, batch: dict, seed: int = 0, **kwargs) -> dict:
        """Serve a batch a featurizer padded to its own maximum length: the
        trailing all-pad columns go first, so it lands in the smallest
        sequence bucket that fits (``kwargs``: qa's features and contexts)."""
        return self(_trim_pad_columns(batch), seed=seed, **kwargs)
