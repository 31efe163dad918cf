"""SQuAD v1.1 data pipeline and metrics, dependency-free (counterpart of
``bayeformers_tpu/utils/squad.py``, a copy of its pure-Python code).

- :func:`load_squad_json` parses the official JSON;
- :func:`windowize` is the doc-stride overlapping-window chunker;
- :func:`featurize` builds ``[CLS] question [SEP] context-window [SEP]``
  features with any ``tokenize(text) -> list[int]`` callable, mapping
  character answers to token spans;
- :func:`exact_match_score` / :func:`f1_score` / :func:`squad_evaluate`
  reproduce the official normalisation, :func:`draw_metrics` the answers'
  spread over MC draws;
- :func:`best_span`, :func:`n_best_spans` and :func:`decode_span` decode
  token spans back to answer text.

One change from the reference: span scores ``start[s] + end[e]`` are
taken in f32 as there, but where that sum overflows (two masked
``finfo(f32).min`` logits give ``-inf``) the f64 sum stands in, so every
valid span keeps a finite score and a ranking. Wherever the reference's
score is finite, the spans and scores are the reference's.
"""
from __future__ import annotations

import collections
import json
import re
import string
from typing import Callable, Iterable


# ---------------------------------------------------------------------------
# Official answer normalization + metrics
# ---------------------------------------------------------------------------

def normalize_answer(s: str) -> str:
    s = s.lower()
    s = "".join(ch for ch in s if ch not in set(string.punctuation))
    s = re.sub(r"\b(a|an|the)\b", " ", s)
    return " ".join(s.split())


def exact_match_score(prediction: str, ground_truth: str) -> float:
    return float(normalize_answer(prediction) == normalize_answer(ground_truth))


def f1_score(prediction: str, ground_truth: str) -> float:
    pred_tokens = normalize_answer(prediction).split()
    gt_tokens = normalize_answer(ground_truth).split()
    common = collections.Counter(pred_tokens) & collections.Counter(gt_tokens)
    num_same = sum(common.values())
    if num_same == 0:
        return 0.0
    precision = num_same / len(pred_tokens)
    recall = num_same / len(gt_tokens)
    return 2 * precision * recall / (precision + recall)


def metric_max_over_ground_truths(metric_fn, prediction, ground_truths):
    return max(metric_fn(prediction, gt) for gt in ground_truths)


def squad_evaluate(
    predictions: dict[str, str], references: dict[str, list[str]]
) -> dict[str, float]:
    """EM/F1 over {qid: predicted_text} vs {qid: [gold answers]}."""
    em = f1 = 0.0
    for qid, golds in references.items():
        pred = predictions.get(qid, "")
        em += metric_max_over_ground_truths(exact_match_score, pred, golds)
        f1 += metric_max_over_ground_truths(f1_score, pred, golds)
    n = max(len(references), 1)
    return {"exact_match": 100.0 * em / n, "f1": 100.0 * f1 / n}


def draw_metrics(
    per_draw_texts: list[dict[str, str]],
    references: dict[str, list[str]],
) -> dict[str, float]:
    """Span-level uncertainty over S MC draws' decoded answers.

    The reference's acc_std idiom (`examples/bert_squad.py:481-484`)
    elevated from token positions to ANSWERS: ``per_draw_texts[d]`` maps
    qid -> the answer decoded from draw d alone. Returns the per-draw
    EM/F1 mean and std across draws, plus ``span_agreement`` — the mean
    (over questions) fraction of draws producing the question's modal
    answer (1.0 = the posterior is certain about every span)."""
    import numpy as np

    ems, f1s = [], []
    for texts in per_draw_texts:
        m = squad_evaluate(texts, references)
        ems.append(m["exact_match"])
        f1s.append(m["f1"])
    n_draws = max(len(per_draw_texts), 1)
    qids = set()
    for texts in per_draw_texts:
        qids.update(texts)
    agreements = []
    for qid in qids:
        answers = [texts.get(qid, "") for texts in per_draw_texts]
        counts: dict[str, int] = {}
        for a in answers:
            counts[a] = counts.get(a, 0) + 1
        agreements.append(max(counts.values()) / n_draws)
    return {
        "em_mean_of_draws": float(np.mean(ems)) if ems else 0.0,
        "em_std_of_draws": float(np.std(ems)) if ems else 0.0,
        "f1_mean_of_draws": float(np.mean(f1s)) if f1s else 0.0,
        "f1_std_of_draws": float(np.std(f1s)) if f1s else 0.0,
        "span_agreement": float(np.mean(agreements)) if agreements else 1.0,
    }


# ---------------------------------------------------------------------------
# JSON loading
# ---------------------------------------------------------------------------

def load_squad_json(path: str) -> list[dict]:
    """Flatten the official JSON into [{qid, question, context, answers:
    [{text, answer_start}]}]."""
    with open(path) as fh:
        data = json.load(fh)["data"]
    examples = []
    for article in data:
        for para in article["paragraphs"]:
            context = para["context"]
            for qa in para["qas"]:
                examples.append(
                    {
                        "qid": qa["id"],
                        "question": qa["question"],
                        "context": context,
                        "answers": qa["answers"],
                    }
                )
    return examples


# ---------------------------------------------------------------------------
# Doc-stride windowing + featurization
# ---------------------------------------------------------------------------

def tokenize_with_offsets(
    text: str, tokenize: Callable[[str], list[int]]
) -> tuple[list[int], list[tuple[int, int]]]:
    """Token ids + per-token (char_start, char_end) spans — word-granular
    FALLBACK for opaque tokenize callables.

    Tokenizes whitespace-delimited words independently and assigns each
    word's character span to all of its sub-word pieces, so decoded answers
    snap to word boundaries (punctuation attached to a word leaks into the
    decoded text). Prefer passing ``offsets_fn`` to :func:`featurize` — e.g.
    ``WordPieceTokenizer.tokenize_with_offsets`` — which is subword-exact.
    """
    ids: list[int] = []
    offsets: list[tuple[int, int]] = []
    pos = 0
    for word in text.split():
        start = text.index(word, pos)
        end = start + len(word)
        pos = end
        for tid in tokenize(word):
            ids.append(tid)
            offsets.append((start, end))
    return ids, offsets

def windowize(n_tokens: int, max_len: int, doc_stride: int) -> list[tuple[int, int]]:
    """(start, end) windows of at most ``max_len`` tokens covering
    ``n_tokens``, advancing by ``doc_stride`` (reference behavior: overlap
    long documents, `examples/bert_squad.py:221-222`)."""
    if n_tokens <= max_len:
        return [(0, n_tokens)]
    windows = []
    start = 0
    while True:
        end = min(start + max_len, n_tokens)
        windows.append((start, end))
        if end == n_tokens:
            return windows
        # advance by at most the window actually taken (HF semantics:
        # squad_convert_examples_to_features steps min(length, doc_stride)),
        # so an oversized doc_stride can never skip context tokens
        start += min(end - start, doc_stride)


def featurize(
    examples: Iterable[dict],
    tokenize: Callable[[str], list[int]],
    *,
    max_seq: int = 384,
    doc_stride: int = 128,
    cls_id: int = 101,
    sep_id: int = 102,
    pad_id: int = 0,
    is_training: bool = True,
    offsets_fn: Callable[[str], tuple[list, list]] | None = None,
) -> list[dict]:
    """[CLS] question [SEP] context-window [SEP] features.

    Answer char spans are mapped to token spans through per-token character
    offsets. ``offsets_fn(text) -> (ids, [(char_start, char_end)])`` supplies
    subword-exact offsets (e.g. the native tokenizer's
    ``tokenize_with_offsets``); without it a word-granular fallback is used.
    Training features whose window does not contain the answer point both
    positions at [CLS] (index 0), mirroring HF semantics.
    """
    features = []
    for ex in examples:
        q_ids = tokenize(ex["question"])
        if offsets_fn is not None:
            c_ids, c_offsets = offsets_fn(ex["context"])
        else:
            c_ids, c_offsets = tokenize_with_offsets(ex["context"], tokenize)
        q_len = len(q_ids) + 2  # CLS + question + SEP
        window_len = max_seq - q_len - 1  # room for trailing SEP
        if window_len <= 0:
            continue

        tok_start = tok_end = None
        if is_training and ex["answers"]:
            ans = ex["answers"][0]
            a0 = ans["answer_start"]
            a1 = a0 + len(ans["text"])
            overlap = [
                i for i, (cs, ce) in enumerate(c_offsets) if ce > a0 and cs < a1
            ]
            if overlap:
                tok_start, tok_end = overlap[0], overlap[-1]

        for w_start, w_end in windowize(len(c_ids), window_len, doc_stride):
            ids = [cls_id] + q_ids + [sep_id] + c_ids[w_start:w_end] + [sep_id]
            type_ids = [0] * (q_len) + [1] * (w_end - w_start + 1)
            mask = [1] * len(ids)
            pad = max_seq - len(ids)
            feature = {
                "qid": ex["qid"],
                "input_ids": ids + [pad_id] * pad,
                "attention_mask": mask + [0] * pad,
                "token_type_ids": type_ids + [0] * pad,
                "window_start": w_start,
                "context_offset": q_len,
                # char spans of this window's context tokens, for decoding
                # predicted token spans back to answer text (EM/F1)
                "offsets": c_offsets[w_start:w_end],
            }
            if is_training:
                if (
                    tok_start is not None
                    and w_start <= tok_start
                    and tok_end < w_end
                ):
                    feature["start_position"] = q_len + (tok_start - w_start)
                    feature["end_position"] = q_len + (tok_end - w_start)
                else:
                    feature["start_position"] = 0  # [CLS]
                    feature["end_position"] = 0
            features.append(feature)
    return features


def span_scores(start_logits, end_logits):
    """(L, L) scores ``start[s] + end[e]`` as f64 holding the f32 sums; an
    f32 sum that overflows (two masked ``finfo(f32).min`` logits) takes the
    f64 sum instead, finite and below every finite f32 sum."""
    import numpy as np

    s64 = np.asarray(start_logits, np.float32).astype(np.float64)
    e64 = np.asarray(end_logits, np.float32).astype(np.float64)
    with np.errstate(over="ignore"):
        s32 = (s64.astype(np.float32)[:, None] + e64.astype(np.float32)[None, :])
    exact = s64[:, None] + e64[None, :]
    return np.where(np.isfinite(s32) | ~np.isfinite(exact), s32.astype(np.float64), exact)


def best_span(start_logits, end_logits, context_offset: int, max_answer_len: int = 30):
    """Highest-scoring (start <= end) span within the context region: for
    each start the largest end logit in reach, the first of equal scores."""
    import numpy as np

    end_logits = np.asarray(end_logits, np.float32)
    scores = span_scores(start_logits, end_logits)
    n = scores.shape[0]
    best = (context_offset, context_offset)
    best_score = -np.inf
    for s in range(context_offset, n):
        e_hi = min(s + max_answer_len, n)
        e_rel = int(np.argmax(end_logits[s:e_hi]))
        score = scores[s, s + e_rel]
        if score > best_score:
            best_score = score
            best = (s, s + e_rel)
    return best, float(best_score)


def n_best_spans(
    start_logits,
    end_logits,
    context_offset: int,
    max_answer_len: int = 30,
    n_best: int = 5,
):
    """Top-``n_best`` (start <= end) spans within the context region.

    Vectorized analog of :func:`best_span` for serving: the (L, L)
    pair-score matrix (:func:`span_scores`) masked to valid spans
    (``context_offset <= s <= e < s + max_answer_len``), returned as
    ``[(start, end, score), ...]`` by descending score (the n-best of HF's
    ``compute_predictions_logits`` that the reference calls).
    """
    import numpy as np

    scores = span_scores(start_logits, end_logits)
    n = scores.shape[0]
    s_idx = np.arange(n)[:, None]
    e_idx = np.arange(n)[None, :]
    valid = (
        (s_idx >= context_offset)
        & (e_idx >= s_idx)
        & (e_idx < s_idx + max_answer_len)
    )
    scores = np.where(valid, scores, -np.inf)
    flat = scores.ravel()
    k = min(n_best, int(valid.sum()))
    if k == 0:
        return [(context_offset, context_offset, float("-inf"))]
    top = np.argpartition(flat, -k)[-k:]
    top = top[np.argsort(flat[top])[::-1]]
    return [(int(i // n), int(i % n), float(flat[i])) for i in top]


def decode_span(feature: dict, context: str, s: int, e: int) -> str:
    """Answer text for token span [s, e] (absolute positions incl. the
    question prefix) using the feature's stored char offsets."""
    off = feature["context_offset"]
    offsets = feature["offsets"]
    i0 = min(max(s - off, 0), len(offsets) - 1)
    i1 = min(max(e - off, 0), len(offsets) - 1)
    if not offsets:
        return ""
    return context[offsets[i0][0] : offsets[i1][1]]
