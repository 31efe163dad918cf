"""BERT SQuAD v1.1 QA workload on one GPU (counterpart of
``bayeformers_tpu/workloads/bert_squad.py``).

Four phases, as in the GLUE workload, with SQuAD's specifics: a span head
with the 0.5/0.5 start/end CE (``training.qa_span_loss``), ``max_seq`` 384
windows advancing by ``doc_stride`` 128 (``utils/squad.py::featurize``),
EM/F1 by the official normalisation, and the reference's constants (S=10,
batch 13, lr 5e-5, clip 1.0):

  A. frequentist fine-tune (AdamW, eps 1e-8, global-norm clip 1.0, linear
     LR decay);
  B. ``to_bayesian(model, delta, freeze=True)`` (MOPED);
  C. Bayesian eval: span accuracy and its std across draws on labelled
     features (the synthetic stand-in), or on real data EM/F1 of the
     S-mean logits (the best window of each question wins) and each
     draw's answers' spread (``utils/squad.py::draw_metrics``);
  D. Bayesian ELBO fine-tune (rho, embeddings and LayerNorm train; mu
     frozen), evaluated after each epoch.

``--model`` dispatches through ``models/families.py::build_model``
(DistilBERT, RoBERTa/CamemBERT, Electra, ALBERT or BERT, each with its QA
head) and prunes the inputs per family. Data: ``--data-dir`` with
``{train,dev}-v1.1.json`` is read with ``--tokenizer``, a ``vocab.txt`` or
a directory holding one (the native WordPiece tokenizer, its subword-exact
offsets mapping the answer spans), or, from Python, a ``tokenize``
callable (text -> ids), the features cached next to the JSON; otherwise
the reference's synthetic stand-in is generated from the seed. A tokenizer
directory without ``vocab.txt`` raises: the JAX package reads it with
``transformers``' ``BertTokenizerFast``, which the card does not have.
``--pretrained DIR`` starts from a local Hugging Face checkpoint,
``--save-dir`` / ``--resume`` write and continue the Bayesian phase and
``--hypersearch N`` runs the reference's random search, as in
``bert_glue``, as do ``--dp``/``--tp``/``--independent-draws`` (the
data- and tensor-parallel tier over ``torch.distributed.run``'s ranks;
``--sp`` is ROADMAP queue 1 item 6(d)). The
estimator is antithetic pairs when S (and
``--mc-chunk``) is even and independent draws otherwise, or
``--estimator``. Activations are f32 by default and bf16 with ``--bf16``.

    python -m bayeformers_tpu_torch.workloads.bert_squad --bf16 --limit-batches 3
    python -m bayeformers_tpu_torch.workloads.bert_squad --mc-chunk 2
"""
from __future__ import annotations

import argparse
import itertools
import os
import pickle
import time
from typing import Callable, Optional

import numpy as np
import torch

from bayeformers_tpu_torch import elbo, training
from bayeformers_tpu_torch.models import families
from bayeformers_tpu_torch.nn.fused import derive_seed
from bayeformers_tpu_torch.nn.surgery import to_bayesian
from bayeformers_tpu_torch.parallel import train as ptrain
from bayeformers_tpu_torch.parallel.mesh import shard_batch
from bayeformers_tpu_torch.parallel.train import add_mesh_args, launcher_print, mesh_kwargs
from bayeformers_tpu_torch.pretrained import load_pretrained
from bayeformers_tpu_torch.utils import checkpoint as ckpt_lib
from bayeformers_tpu_torch.utils import squad as squad_lib
from bayeformers_tpu_torch.utils.hypersearch import search_delta_weight_decay
from bayeformers_tpu_torch.utils.metrics import Report, run_name
from bayeformers_tpu_torch.utils.optim import masked_optimizer

# Reference constants (``bayeformers_tpu/workloads/bert_squad.py:42-51``)
EPOCHS = 3
SAMPLES = 10
BATCH_SIZE = 13
MAX_SEQ = 384
DOC_STRIDE = 128
LR = 5e-5
ADAM_EPSILON = 1e-8
CLIP_NORM = 1.0
INPUT_KEYS = training.INPUT_KEYS
LABEL_KEYS = ("start_positions", "end_positions")


def _features_to_arrays(features, is_training=True) -> dict:
    out = {k: np.asarray([f[k] for f in features], np.int32) for k in INPUT_KEYS}
    if is_training:
        out["start_positions"] = np.asarray([f["start_position"] for f in features],
                                            np.int32)
        out["end_positions"] = np.asarray([f["end_position"] for f in features], np.int32)
    return out


def load_squad(data_dir: Optional[str], tokenize: Optional[Callable], vocab_size: int,
               max_seq: int, seed: int = 0, doc_stride: int = DOC_STRIDE,
               offsets_fn: Optional[Callable] = None, pad_id: int = 0, cls_id: int = 101,
               sep_id: int = 102):
    """``(train, dev, dev_features, dev_examples, synthetic)``: dicts of
    numpy int32 arrays. Real data needs ``{train,dev}-v1.1.json`` in
    ``data_dir`` and a ``tokenize`` callable; its features are cached in
    ``data_dir`` after the first build. Otherwise the reference's
    synthetic stand-in: 256 training and 64 dev features with labelled
    spans, and no examples to score."""
    train_json = data_dir and os.path.join(data_dir, "train-v1.1.json")
    dev_json = data_dir and os.path.join(data_dir, "dev-v1.1.json")
    if data_dir and tokenize is not None and os.path.exists(train_json) \
            and os.path.exists(dev_json):
        cache = os.path.join(data_dir, f"features_{max_seq}_{doc_stride}.pkl")
        if os.path.exists(cache):
            with open(cache, "rb") as fh:
                train_arrays, dev_arrays, dev_feats, dev_examples = pickle.load(fh)
            return train_arrays, dev_arrays, dev_feats, dev_examples, False
        kw = dict(max_seq=max_seq, doc_stride=doc_stride, offsets_fn=offsets_fn,
                  pad_id=pad_id, cls_id=cls_id, sep_id=sep_id)
        train_feats = squad_lib.featurize(squad_lib.load_squad_json(train_json), tokenize,
                                          is_training=True, **kw)
        dev_examples = squad_lib.load_squad_json(dev_json)
        dev_feats = squad_lib.featurize(dev_examples, tokenize, is_training=False, **kw)
        train_arrays = _features_to_arrays(train_feats, True)
        dev_arrays = _features_to_arrays(dev_feats, False)
        with open(cache, "wb") as fh:
            pickle.dump((train_arrays, dev_arrays, dev_feats, dev_examples), fh)
        return train_arrays, dev_arrays, dev_feats, dev_examples, False

    rng = np.random.default_rng(seed)

    def make(n):
        ids = rng.integers(4, vocab_size, (n, max_seq))
        start = rng.integers(1, max_seq - 8, (n,))
        return {
            "input_ids": ids.astype(np.int32),
            "attention_mask": np.ones((n, max_seq), np.int32),
            "token_type_ids": np.zeros((n, max_seq), np.int32),
            "start_positions": start.astype(np.int32),
            "end_positions": (start + rng.integers(0, 8, (n,))).astype(np.int32),
        }
    return make(256), make(64), None, None, True


def batch_iter(data: dict, batch_size: int, seed: Optional[int] = None):
    n = data["input_ids"].shape[0]
    idx = np.arange(n - n % batch_size)
    if seed is not None:
        np.random.default_rng(seed).shuffle(idx)
    for start in range(0, len(idx), batch_size):
        sel = idx[start: start + batch_size]
        yield {k: v[sel] for k, v in data.items()}


def wordpiece_vocab(tokenizer: str) -> str:
    """The ``vocab.txt`` of ``--tokenizer``: the file itself, or the one in
    the directory it names. Raises otherwise: the JAX package reads such a
    directory with ``transformers``, which the port does not use."""
    if os.path.isfile(tokenizer):
        return tokenizer
    vocab = os.path.join(tokenizer, "vocab.txt")
    if os.path.isfile(vocab):
        return vocab
    raise ValueError(f"bert_squad: --tokenizer {tokenizer!r} is neither a vocab.txt nor "
                     "a directory holding one; the port reads WordPiece vocabularies "
                     "with its native tokenizer (no transformers tokenizers)")


def train(
    exp: str = "bert_squad",
    delta: float = 0.05,
    weight_decay: float = 0.0,
    *,
    model: str = "bert-base-uncased",
    data_dir: Optional[str] = "dataset/squadv1",
    tokenizer: Optional[str] = None,
    tokenize: Optional[Callable] = None,
    offsets_fn: Optional[Callable] = None,
    logs: str = "logs",
    epochs: int = EPOCHS,
    b_epochs: int = EPOCHS,
    samples: int = SAMPLES,
    batch_size: int = BATCH_SIZE,
    max_seq: int = MAX_SEQ,
    doc_stride: int = DOC_STRIDE,
    lr: float = LR,
    size: str = "base",
    bf16: bool = False,
    pretrained: Optional[str] = None,
    seed: int = 0,
    limit_batches: Optional[int] = None,
    fused: bool = True,
    save_dir: Optional[str] = None,
    resume: bool = False,
    dp: int = 1,
    tp: int = 1,
    sp: int = 1,
    estimator: Optional[str] = None,
    mc_chunk: Optional[int] = None,
    independent_draws: bool = False,
    backend: Optional[str] = None,
    device: str = "cuda",
) -> float:
    """Run phases A-D; returns the dev F1 after phase D on real data, or the
    span accuracy on the synthetic stand-in. ``dp``/``tp``,
    ``independent_draws`` and ``backend`` as in ``bert_glue.train``."""
    if estimator is None:
        anti_ok = samples % 2 == 0 and (mc_chunk is None or mc_chunk % 2 == 0)
        estimator = ("antithetic" if anti_ok else "fused") if fused else "naive"
    ptrain.check_mesh(dp, tp, estimator, batch_size)
    mesh, dev = ptrain.init_mesh(dp, tp, sp, backend, device)
    tp = 1 if mesh is None else mesh.tp
    special = {}
    if tokenizer:
        from bayeformers_tpu_torch.native import WordPieceTokenizer

        wp = WordPieceTokenizer(wordpiece_vocab(tokenizer))
        tokenize, offsets_fn = wp.tokenize, wp.tokenize_with_offsets
        special = {"cls_id": wp.special_id("cls"), "sep_id": wp.special_id("sep")}

    name = run_name(exp, delta=round(delta, 5), weight_decay=round(weight_decay, 6))
    writer, dumper, say = ptrain.rank_logging(mesh, logs, name)

    dtype = torch.bfloat16 if bf16 else torch.float32
    if pretrained:
        net = load_pretrained(pretrained, "qa", seed=seed, dtype=dtype, device=dev)
    else:
        net = families.build_model(
            model, task="qa", size=size, seed=seed, dtype=dtype, device=dev,
            **({} if size == "base" else {"max_position_embeddings": max_seq + 8}))
    # model-family input pruning (reference ``bert_squad.py:184-185``)
    input_keys = families.input_keys(net)
    train_data, dev_data, dev_feats, dev_examples, synthetic = load_squad(
        data_dir, tokenize, net.config.vocab_size, max_seq, seed, doc_stride, offsets_fn,
        net.config.pad_token_id, **special)
    if synthetic:
        say("[bert_squad] no dataset/tokenizer found; synthetic stand-in")
    n_batches = train_data["input_ids"].shape[0] // batch_size
    if limit_batches:
        n_batches = min(n_batches, limit_batches)

    def to_dev(batch):
        return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}

    def batches(data, shuffle_seed=None, limit=None):
        for i, batch in enumerate(batch_iter(data, batch_size, seed=shuffle_seed)):
            if limit and i >= limit:
                break
            yield to_dev(batch)

    def qa_apply(batch):
        """The whole batch's (start, end) logits, each dp rank running its
        slice."""
        local = shard_batch(batch, mesh)
        return ptrain.gather_outputs(net(**{k: local[k] for k in input_keys}), mesh, dim=0)

    # ---------------- Phase A: frequentist fine-tune -----------------------
    tx = training.adamw_with_decay_groups(
        training.linear_schedule(lr, 0.0, max(1, n_batches * epochs)), weight_decay,
        training.default_no_decay, eps=ADAM_EPSILON, clip_norm=CLIP_NORM)
    opt = tx.init(training.model_parameters(net, tx.mask_no_decay))

    def f_step(batch):
        opt.zero_grad()
        local = shard_batch(batch, mesh)
        start, end = net(**{k: local[k] for k in input_keys})
        loss = 0.5 * (elbo.cross_entropy_sum(start, local["start_positions"])
                      + elbo.cross_entropy_sum(end, local["end_positions"]))
        loss.backward()
        ptrain.all_reduce_grads(opt.params, mesh)
        opt.step()
        return ptrain.dp_sum(loss.detach(), mesh)

    with dumper.section("frequentist"):
        for epoch in range(epochs):
            losses = [float(f_step(batch))
                      for batch in batches(train_data, seed + epoch, limit_batches)]
            writer.scalar("frequentist/loss", float(np.mean(losses)), epoch)
            dumper.record(**{f"epoch_{epoch}_loss": float(np.mean(losses))})
            say(f"[freq {epoch}] train loss={np.mean(losses):.4f}")
    opt.zero_grad()

    def decode_and_score(get_logits):
        """EM/F1 over the dev set: the best-scoring window of each question
        (the reference's all-features decode). ``get_logits(batch) -> (s,
        e)``, numpy (B, L) each."""
        predictions = {}
        for bi, batch in enumerate(batch_iter(dev_data, batch_size)):
            s_log, e_log = get_logits(batch)
            for row in range(s_log.shape[0]):
                feat = dev_feats[bi * batch_size + row]
                (s, e), score = squad_lib.best_span(s_log[row], e_log[row],
                                                    feat["context_offset"])
                prev = predictions.get(feat["qid"])
                if prev is None or score > prev[0]:
                    predictions[feat["qid"]] = (score, s, e, feat)
        return squad_lib.squad_evaluate(*_texts_and_refs([predictions])[0])

    def _texts_and_refs(per_draw):
        contexts = {ex["qid"]: ex["context"] for ex in dev_examples}
        refs = {ex["qid"]: [a["text"] for a in ex["answers"]] or [""]
                for ex in dev_examples}
        return [({qid: squad_lib.decode_span(feat, contexts[qid], s, e)
                  for qid, (_, s, e, feat) in preds.items()}, refs) for preds in per_draw]

    def decode_and_score_draws(draw_logits):
        """Each draw's answers (its windows compete, as above) and their
        spread (``squad_lib.draw_metrics``). ``draw_logits`` is a list, one
        per dev batch, of numpy (S, B, L) start and end logits."""
        predictions = [dict() for _ in range(samples)]
        for bi, (s_log, e_log) in enumerate(draw_logits):
            for row in range(s_log.shape[1]):
                feat = dev_feats[bi * batch_size + row]
                for d in range(samples):
                    (s, e), score = squad_lib.best_span(s_log[d, row], e_log[d, row],
                                                        feat["context_offset"])
                    prev = predictions[d].get(feat["qid"])
                    if prev is None or score > prev[0]:
                        predictions[d][feat["qid"]] = (score, s, e, feat)
        pairs = _texts_and_refs(predictions)
        return squad_lib.draw_metrics([t for t, _ in pairs], pairs[0][1])

    def numpy_logits(out):
        return tuple(o.float().cpu().numpy() for o in out)

    if dev_examples:
        # phase-level EM/F1 (the reference scores phase A too)
        with torch.inference_mode():
            freq_metrics = decode_and_score(lambda b: numpy_logits(qa_apply(to_dev(b))))
        writer.scalars("frequentist_eval", freq_metrics, 0)
        with dumper.section("frequentist_eval"):
            dumper.record(**freq_metrics)
        say(f"[freq eval] {freq_metrics}")

    # ---------------- Phase B: conversion ----------------------------------
    bmodel = to_bayesian(net, delta=delta, freeze=True)
    ptrain.prepare_bayes_params(bmodel, mesh)
    # --resume (the reference only saves): phase D continues from the latest step
    start_epoch = ckpt_lib.resume_epoch(save_dir, bmodel, resume, "bert_squad", mesh)
    eval_step = ptrain.make_eval_step(
        bmodel, samples, mesh, loss_fn=training.qa_span_loss, fused=fused,
        input_keys=input_keys, estimator=estimator)
    mc = ptrain.make_mc(bmodel, mesh, fused, estimator, save_weights=False, gather=True)
    draws = itertools.count()  # the step key stream: seed + 1, split per use

    def next_seed() -> int:
        return derive_seed(seed + 1, next(draws))

    def eval_bayesian():
        """Span accuracy on labelled features, or EM/F1 on real data."""
        if "start_positions" in dev_data:
            report = Report("nll", "acc", "acc_std", "n")
            for batch in batches(dev_data):
                _, m = eval_step(next_seed(), batch)
                bsz = batch["input_ids"].shape[0]
                report.update(nll=float(m["nll"]), acc=float(m["acc"]) * bsz,
                              acc_std=float(m["acc_std"]) * bsz, n=bsz)
            n = max(report.totals.pop("n"), 1)
            return report.means(n)
        # one forward sweep: each draw's spans for the spread, the same
        # draws' mean logits for EM/F1 (the reference's single S-sample run)
        draw_logits = []
        with torch.inference_mode():
            for batch in batches(dev_data):
                out, _ = mc(next_seed(), samples, **{k: batch[k] for k in input_keys})
                draw_logits.append(numpy_logits(out))
        means = iter([(s.mean(0), e.mean(0)) for s, e in draw_logits])
        metrics = decode_and_score_draws(draw_logits)
        metrics.update(decode_and_score(lambda _: next(means)))
        return metrics

    # ---------------- Phase C: Bayesian eval -------------------------------
    with dumper.section("bayesian_eval"):
        metrics = eval_bayesian()
        writer.scalars("bayesian_eval", metrics, 0)
        dumper.record(**metrics)
        say(f"[baye eval] {metrics}")

    # ---------------- Phase D: Bayesian ELBO fine-tune ---------------------
    # under tp the step clips sharded-aware (see bert_glue)
    btx = training.adamw_with_decay_groups(
        training.linear_schedule(lr, 0.0, max(1, n_batches * b_epochs)), weight_decay,
        training.default_no_decay, eps=ADAM_EPSILON, clip_norm=None if tp > 1 else CLIP_NORM)
    b_opt = masked_optimizer(btx, bmodel)
    b_step = ptrain.make_train_step(
        bmodel, b_opt, samples, n_batches, mesh, loss_fn=training.qa_span_loss, fused=fused,
        input_keys=input_keys, estimator=estimator, mc_chunk=mc_chunk,
        independent_draws=independent_draws, clip_norm=CLIP_NORM if tp > 1 else None)
    with dumper.section("bayesian_train"):
        for epoch in range(start_epoch, b_epochs):
            for batch in batches(train_data, seed + 100 + epoch, limit_batches):
                m = b_step(next_seed(), shard_batch(batch, mesh))
            metrics = eval_bayesian()
            writer.scalars("bayesian_test", metrics, epoch)
            dumper.record(**{f"epoch_{epoch}_{k}": v for k, v in metrics.items()})
            say(f"[baye {epoch}] train loss={float(m['loss']):.4f} "
                f"acc={float(m['acc']):.4f} {metrics}")
            ckpt_lib.save_epoch(save_dir, bmodel, epoch, {
                "delta": delta, "weight_decay": weight_decay, **metrics}, mesh)
    if start_epoch >= b_epochs and start_epoch > 0:
        # resumed past the end: evaluate the restored state
        metrics = eval_bayesian()
        writer.scalars("bayesian_test", metrics, start_epoch)
    writer.close()
    dumper.flush()
    return float(metrics.get("f1", metrics.get("acc", 0.0)))


def main():
    parser = argparse.ArgumentParser(description="Bayesian BERT on SQuAD v1.1 (one GPU)")
    parser.add_argument("--exp", default="bert_squad")
    parser.add_argument("--model", default="bert-base-uncased",
                        help="model family: bert / distilbert / roberta / camembert / "
                             "electra / albert (drives input pruning)")
    parser.add_argument("--data-dir", default="dataset/squadv1")
    parser.add_argument("--tokenizer", default=None,
                        help="vocab.txt of the native WordPiece tokenizer, or a "
                             "directory holding one")
    parser.add_argument("--pretrained", default=None,
                        help="local Hugging Face model directory")
    parser.add_argument("--size", default="base", choices=["base", "tiny"])
    parser.add_argument("--logs", default="logs")
    parser.add_argument("--epochs", type=int, default=EPOCHS)
    parser.add_argument("--b-epochs", type=int, default=EPOCHS)
    parser.add_argument("--samples", type=int, default=SAMPLES)
    parser.add_argument("--batch-size", type=int, default=BATCH_SIZE)
    parser.add_argument("--max-seq", type=int, default=MAX_SEQ)
    parser.add_argument("--lr", type=float, default=LR)
    parser.add_argument("--delta", type=float, default=0.05)
    parser.add_argument("--weight-decay", type=float, default=0.0)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--limit-batches", type=int, default=None)
    parser.add_argument("--no-fused", action="store_true")
    parser.add_argument("--estimator", default=None,
                        choices=["fused", "naive", "flipout", "antithetic", "local"],
                        help="MC gradient estimator for the Bayesian phase")
    parser.add_argument("--mc-chunk", type=int, default=None,
                        help="run the S MC samples in chunks of this size with "
                             "gradient accumulation (memory lever: the f32 recipe, "
                             "S=10, batch 13, seq 384, runs at --mc-chunk 2)")
    parser.add_argument("--bf16", action="store_true",
                        help="bf16 activations (variational numerics stay f32)")
    parser.add_argument("--save-dir", default=None,
                        help="write the variational state after each Bayesian epoch")
    parser.add_argument("--resume", action="store_true",
                        help="continue the Bayesian phase from --save-dir")
    add_mesh_args(parser)
    parser.add_argument("--hypersearch", type=int, default=0,
                        help="run N random-search trials over delta/weight_decay")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    kwargs = dict(
        exp=args.exp, model=args.model, data_dir=args.data_dir, tokenizer=args.tokenizer,
        logs=args.logs,
        epochs=args.epochs, b_epochs=args.b_epochs, samples=args.samples,
        batch_size=args.batch_size, max_seq=args.max_seq, lr=args.lr, size=args.size,
        bf16=args.bf16, pretrained=args.pretrained, seed=args.seed,
        limit_batches=args.limit_batches, fused=not args.no_fused,
        estimator=args.estimator, mc_chunk=args.mc_chunk, save_dir=args.save_dir,
        resume=args.resume, device=args.device, **mesh_kwargs(args))
    t0 = time.time()
    if args.hypersearch:
        best = search_delta_weight_decay(train, args.hypersearch, args.seed, **kwargs)
        launcher_print(f"best score={best.value:.4f} with {best.hyperparameters}")
    else:
        score = train(delta=args.delta, weight_decay=args.weight_decay, **kwargs)
        launcher_print(f"final score={score:.4f}")
    launcher_print(f"done in {time.time() - t0:.1f}s")
    ptrain.finish()


if __name__ == "__main__":
    main()
