"""BERT GLUE fine-tune workload on one GPU (counterpart of
``bayeformers_tpu/workloads/bert_glue.py``). ``--model`` dispatches by the
reference's order (``models/families.py::build_model``): DistilBERT,
RoBERTa or CamemBERT (RoBERTa's builder), Electra, ALBERT, else BERT, each
with its classification head, and the inputs are pruned per family
(DistilBERT and RoBERTa take no token types).

Four phases, as in the reference recipe:
  A. frequentist fine-tune (AdamW lr=2e-5 eps=1e-8, CE-sum, global-norm
     clip 1.0, linear LR decay);
  B. ``to_bayesian(model, delta, freeze=True)`` (MOPED);
  C. Bayesian eval (S=10; acc + acc_std across MC draws, ECE);
  D. Bayesian ELBO fine-tune (fresh AdamW over rho, embeddings and
     LayerNorm; mu frozen).

Data, in the JAX package's order: ``--data`` names an .npz with arrays
``{train,dev}_{input_ids,attention_mask,token_type_ids,labels}`` (tokenized
GLUE, any task); or a GLUE task directory of raw TSVs (``train.tsv`` and
the task's dev file) with ``--vocab`` a ``vocab.txt``, featurized by the
native WordPiece tokenizer (``utils/glue.py::load_glue_task``, cached next
to the TSVs); otherwise the reference's synthetic stand-in is generated
from the seed, bit for bit. ``--pretrained DIR`` starts from a local
Hugging Face checkpoint (``pretrained.py``); ``--save-dir`` writes the
variational state after each Bayesian epoch (``utils/checkpoint.py``) and
``--resume`` continues phase D from the latest one (a resume past the last
epoch evaluates the restored state); ``--hypersearch N`` runs N trials of
the reference's random search over ``delta`` and ``weight_decay``
(``utils/hypersearch.py``). ``--dp``/``--tp`` run the data- and
tensor-parallel tier (``parallel/``) over ranks that ``python -m
torch.distributed.run`` starts, ``--backend gloo`` where ranks share a
card; ``--sp`` (and tp on the naive tier) is ROADMAP queue 1 item 6(d).
The estimator is antithetic pairs when S (and
``--mc-chunk``) is even and independent draws (``fused``) otherwise, as in
the reference, or ``--estimator`` (any of the reference's five:
``fused``, ``naive``, ``flipout``, ``antithetic``, ``local``), under which
phases C and D run. Activations are f32 by default, as in
the reference, and bf16 with ``--bf16``; the kernels take either. At f32
and even S the FFN down-projections (K = 3072) regenerate their W pairs in
the backward, as the reference routes them.

    python -m bayeformers_tpu_torch.workloads.bert_glue --limit-batches 3
    python -m bayeformers_tpu_torch.workloads.bert_glue --bf16 --samples 9
    python -m bayeformers_tpu_torch.workloads.bert_glue --data glue/MRPC \
        --vocab bert/vocab.txt --bf16 --save-dir ckpt
    python -m torch.distributed.run --nproc-per-node 2 \
        -m bayeformers_tpu_torch.workloads.bert_glue --dp 2 --backend gloo
"""
from __future__ import annotations

import argparse
import itertools
import os
import time

import numpy as np
import torch

from bayeformers_tpu_torch import elbo, training
from bayeformers_tpu_torch.models import families
from bayeformers_tpu_torch.nn.fused import derive_seed
from bayeformers_tpu_torch.nn.surgery import to_bayesian
from bayeformers_tpu_torch.parallel import train as ptrain
from bayeformers_tpu_torch.parallel.train import add_mesh_args, launcher_print, mesh_kwargs
from bayeformers_tpu_torch.parallel.mesh import shard_batch
from bayeformers_tpu_torch.pretrained import load_pretrained
from bayeformers_tpu_torch.utils import checkpoint as ckpt_lib
from bayeformers_tpu_torch.utils import glue as glue_lib
from bayeformers_tpu_torch.utils import metrics as metrics_lib
from bayeformers_tpu_torch.utils.hypersearch import search_delta_weight_decay
from bayeformers_tpu_torch.utils.metrics import Report, run_name
from bayeformers_tpu_torch.utils.optim import masked_optimizer

# Reference constants
EPOCHS = 5
SAMPLES = 10
BATCH_SIZE = 8
MAX_SEQ = 128
LR = 2e-5
ADAM_EPSILON = 1e-8
CLIP_NORM = 1.0
INPUT_KEYS = training.INPUT_KEYS


def load_glue(data_path: str | None, vocab_size: int, seed: int = 0,
              n_labels: int = 2, regression: bool = False, task: str = "mrpc",
              vocab: str | None = None):
    """``(train, dev, synthetic)``: dicts of numpy arrays (int32 inputs,
    int32 or float32 labels) from a pre-tokenized .npz; from a GLUE task
    directory holding ``train.tsv`` with ``vocab`` a ``vocab.txt``,
    featurized by the native WordPiece tokenizer; else the reference's
    synthetic stand-in, which plants a label-dependent token block and 12%
    ambiguous template rows."""
    label_dtype = np.float32 if regression else np.int32
    if data_path and os.path.isfile(data_path):
        z = np.load(data_path)

        def split(prefix):
            return {
                "input_ids": np.asarray(z[f"{prefix}_input_ids"], np.int32),
                "attention_mask": np.asarray(z[f"{prefix}_attention_mask"], np.int32),
                "token_type_ids": np.asarray(z[f"{prefix}_token_type_ids"], np.int32),
                "labels": np.asarray(z[f"{prefix}_labels"], label_dtype),
            }
        return split("train"), split("dev"), False
    if (data_path and os.path.isdir(data_path)
            and os.path.exists(os.path.join(data_path, "train.tsv"))
            and vocab and os.path.exists(vocab)):
        from bayeformers_tpu_torch.native import WordPieceTokenizer

        tok = WordPieceTokenizer(vocab)
        train, dev = glue_lib.load_glue_task(
            data_path, task, tok.tokenize, max_seq=MAX_SEQ, cls_id=tok.special_id("cls"),
            sep_id=tok.special_id("sep"), pad_id=tok.special_id("pad"))

        def typed(d):
            return {k: np.asarray(v, label_dtype if k == "labels" else np.int32)
                    for k, v in d.items()}
        return typed(train), typed(dev), False
    rng = np.random.default_rng(seed)

    def make(n):
        ids = rng.integers(4, vocab_size, (n, MAX_SEQ))
        if regression:
            labels = rng.uniform(0.0, 5.0, (n,)).astype(np.float32)
            ids[:, 1] = 4 + (labels * 4).astype(np.int64)  # score-binned token
        else:
            labels = rng.integers(0, n_labels, (n,))
            ids[:, 1:9] = (4 + labels * 7)[:, None]  # planted signal block
            # 12% ambiguous rows: 8 templates whose signal block holds every
            # label's token and whose filler is constant, so their labels
            # are coin flips given the input
            ambiguous = rng.random(n) < 0.12
            conf_tokens = 4 + (np.arange(8)[None, :] % n_labels) * 7
            ids[:, 1:9] = np.where(ambiguous[:, None], conf_tokens, ids[:, 1:9])
            tmpl = rng.integers(0, 8, n)
            filler = np.broadcast_to((vocab_size - 1 - tmpl)[:, None],
                                     (n, MAX_SEQ - 9))
            ids[:, 9:] = np.where(ambiguous[:, None], filler, ids[:, 9:])
        return {
            "input_ids": ids.astype(np.int32),
            "attention_mask": np.ones((n, MAX_SEQ), np.int32),
            "token_type_ids": np.zeros((n, MAX_SEQ), np.int32),
            "labels": np.asarray(labels, label_dtype),
        }
    return make(2048), make(256), True


def batch_iter(data: dict, batch_size: int, seed: int | None = None):
    n = data["labels"].shape[0]
    idx = np.arange(n - n % batch_size)
    if seed is not None:
        np.random.default_rng(seed).shuffle(idx)
    for start in range(0, len(idx), batch_size):
        sel = idx[start: start + batch_size]
        yield {k: v[sel] for k, v in data.items()}


def train(
    exp: str = "bert_glue",
    model_name: str = "bert-base-uncased",
    delta: float = 0.05,
    weight_decay: float = 0.0,
    *,
    data: str | None = None,
    task: str = "mrpc",
    vocab: str | None = None,
    logs: str = "logs",
    epochs: int = EPOCHS,
    b_epochs: int = EPOCHS,
    samples: int = SAMPLES,
    batch_size: int = BATCH_SIZE,
    lr: float = LR,
    size: str = "base",
    bf16: bool = False,
    pretrained: str | None = None,
    seed: int = 0,
    limit_batches: int | None = None,
    save_dir: str | None = None,
    resume: bool = False,
    dp: int = 1,
    tp: int = 1,
    sp: int = 1,
    independent_draws: bool = False,
    backend: str | None = None,
    estimator: str | None = None,
    mc_chunk: int | None = None,
    warmup: float = 0.0,
    device: str = "cuda",
    keep: dict | None = None,
) -> float:
    """Run phases A-D; returns the task's headline dev score after phase D.
    ``dp``/``tp`` (``dp=0``: the world over tp) run on the ranks of the
    launcher (``parallel/train.py::init_mesh``, ``backend``): each rank takes
    its dp slice of every batch, phase A all-reduces its gradients and is
    replicated over tp, phase D is ``parallel/train.py::make_train_step``
    (``independent_draws``: each dp rank its own draws), the evaluations
    sum over dp, and rank 0 alone logs and writes checkpoints (whole, the tp
    shards gathered). ``keep``, a dict, receives the rank's converted model
    and mesh at the end (``"bmodel"``, ``"mesh"``)."""
    if any(f in model_name.lower() for f in ("gpt2", "gpt-2", "llama", "mistral", "gemma")):
        raise ValueError(f"bert_glue: model {model_name!r} is a causal LM; the causal "
                         "LMs run in workloads/gpt2_lm.py")
    if estimator is None:
        anti_ok = samples % 2 == 0 and (mc_chunk is None or mc_chunk % 2 == 0)
        estimator = "antithetic" if anti_ok else "fused"
    ptrain.check_mesh(dp, tp, estimator, batch_size)
    mesh, dev = ptrain.init_mesh(dp, tp, sp, backend, device)
    tp = 1 if mesh is None else mesh.tp

    name = run_name(exp, delta=round(delta, 5), weight_decay=round(weight_decay, 6))
    writer, dumper, say = ptrain.rank_logging(mesh, logs, name)

    spec = glue_lib.task_spec(task)
    regression = spec.regression
    loss_fn = training.regression_loss if regression else training.classification_loss
    dtype = torch.bfloat16 if bf16 else torch.float32
    if pretrained:
        model = load_pretrained(pretrained, "classification", spec.n_labels, seed, dtype, dev)
    else:
        model = families.build_model(model_name, n_labels=spec.n_labels, size=size,
                                     seed=seed, dtype=dtype, device=dev)
    # model-family input pruning (reference ``bert_glue.py:229-232``)
    input_keys = families.input_keys(model)
    train_data, dev_data, synthetic = load_glue(
        data, model.config.vocab_size, seed, n_labels=spec.n_labels,
        regression=regression, task=task, vocab=vocab)
    if synthetic:
        say("[bert_glue] no dataset found; using synthetic stand-in")
    n_batches = len(train_data["labels"]) // batch_size
    if limit_batches:
        n_batches = min(n_batches, limit_batches)

    def to_dev(batch):
        return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}

    def batches(data, shuffle_seed=None, limit=None):
        for i, batch in enumerate(batch_iter(data, batch_size, seed=shuffle_seed)):
            if limit and i >= limit:
                break
            yield to_dev(batch)

    # linear decay from lr to 0, optionally after a linear warmup
    def make_schedule(peak, total):
        w = int(total * warmup)
        if w <= 0:
            return training.linear_schedule(peak, 0.0, total)
        return training.join_schedules(
            [training.linear_schedule(0.0, peak, w),
             training.linear_schedule(peak, 0.0, total - w)], [w])

    def frequentist_nll(logits, labels):
        if regression:
            return torch.sum((logits[..., 0].float() - labels) ** 2)
        return elbo.cross_entropy_sum(logits, labels)

    # ---------------- Phase A: frequentist fine-tune -----------------------
    tx = training.adamw_with_decay_groups(
        make_schedule(lr, max(1, n_batches * epochs)), weight_decay,
        training.default_no_decay, eps=ADAM_EPSILON, clip_norm=CLIP_NORM)
    opt = tx.init(training.model_parameters(model, tx.mask_no_decay))

    def f_step(batch):
        # the rank's dp slice; the gradients summed over dp are the batch's
        opt.zero_grad()
        local = shard_batch(batch, mesh)
        logits = model(**{k: local[k] for k in input_keys})
        loss = frequentist_nll(logits, local["labels"])
        loss.backward()
        ptrain.all_reduce_grads(opt.params, mesh)
        opt.step()
        return ptrain.dp_sum(loss.detach(), mesh)

    @torch.inference_mode()
    def eval_frequentist():
        report = Report("nll", "n")
        preds, labels = [], []
        for batch in batches(dev_data):
            local = shard_batch(batch, mesh)
            logits = ptrain.gather_outputs(model(**{k: local[k] for k in input_keys}),
                                           mesh, dim=0)
            nll = frequentist_nll(logits, batch["labels"])
            report.update(nll=float(nll), n=len(batch["labels"]))
            p = logits[..., 0].float() if regression else torch.argmax(logits, -1)
            preds.append(p.cpu().numpy())
            labels.append(batch["labels"].cpu().numpy())
        n = max(report.totals.pop("n"), 1)
        means = report.means(n)
        means.update(metrics_lib.glue_metrics(
            spec.metric, np.concatenate(preds), np.concatenate(labels)))
        return means

    with dumper.section("frequentist"):
        for epoch in range(epochs):
            for batch in batches(train_data, seed + epoch, limit_batches):
                loss = f_step(batch)
            metrics = eval_frequentist()
            writer.scalars("frequentist_test", metrics, epoch)
            dumper.record(**{f"epoch_{epoch}_{k}": v for k, v in metrics.items()})
            say(f"[freq {epoch}] train loss={float(loss):.4f} "
                f"nll={metrics['nll']:.4f} {spec.metric}={metrics['score']:.4f}")
    opt.zero_grad()

    # ---------------- Phase B: conversion ----------------------------------
    bmodel = to_bayesian(model, delta=delta, freeze=True)
    # replicas equal to rank 0's, then the rank's tp shards
    ptrain.prepare_bayes_params(bmodel, mesh)
    # --resume (the reference only saves): phase D continues from the latest step
    start_epoch = ckpt_lib.resume_epoch(save_dir, bmodel, resume, "bert_glue", mesh)
    eval_step = ptrain.make_eval_step(
        bmodel, samples, mesh, loss_fn=loss_fn, input_keys=input_keys,
        estimator=estimator)
    sample_keys = ("mse", "mse_std") if regression else ("acc", "acc_std")
    draws = itertools.count()  # the step key stream: seed + 1, split per use

    def next_seed() -> int:
        return derive_seed(seed + 1, next(draws))

    def eval_bayesian():
        report = Report("nll", *sample_keys, "log_prior",
                        "log_variational_posterior", "n")
        preds, labels, probs = [], [], []
        n_b = 0
        for batch in batches(dev_data):
            out, m = eval_step(next_seed(), batch)
            bsz = len(batch["labels"])
            report.update(
                nll=float(m["nll"]),
                **{k: float(m[k]) * bsz for k in sample_keys},
                log_prior=float(m["log_prior"]),
                log_variational_posterior=float(m["log_variational_posterior"]),
                n=bsz,
            )
            mean_out = elbo.mc_logits_mean(out).float().cpu().numpy()
            preds.append(mean_out[..., 0] if regression else mean_out.argmax(-1))
            if not regression:
                probs.append(torch.softmax(out.float(), -1).mean(0).cpu().numpy())
            labels.append(batch["labels"].cpu().numpy())
            n_b += 1
        n = max(report.totals.pop("n"), 1)
        means = report.means(n)
        for tag in ("log_prior", "log_variational_posterior"):
            means[tag] = means[tag] * n / max(n_b, 1)  # per-batch scalars
        means.update(metrics_lib.glue_metrics(
            spec.metric, np.concatenate(preds), np.concatenate(labels)))
        if not regression:
            means["ece"] = metrics_lib.expected_calibration_error(
                np.concatenate(probs), np.concatenate(labels))
        return means

    # ---------------- Phase C: Bayesian eval -------------------------------
    with dumper.section("bayesian_eval"):
        metrics = eval_bayesian()
        writer.scalars("bayesian_eval", metrics, 0)
        dumper.record(**metrics)
        say(f"[baye eval] {spec.metric}={metrics['score']:.4f} "
            f"{sample_keys[1]}={metrics[sample_keys[1]]:.4f}")

    # ---------------- Phase D: Bayesian ELBO fine-tune ---------------------
    # under tp the step clips sharded-aware: the optimizer's own clip would
    # take each rank's norm and desynchronise the replicated leaves
    btx = training.adamw_with_decay_groups(
        make_schedule(lr, max(1, n_batches * b_epochs)), weight_decay,
        training.default_no_decay, eps=ADAM_EPSILON,
        clip_norm=None if tp > 1 else CLIP_NORM)
    b_opt = masked_optimizer(btx, bmodel)
    b_step = ptrain.make_train_step(
        bmodel, b_opt, samples, n_batches, mesh, loss_fn=loss_fn,
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
                f"nll={metrics['nll']:.4f} {spec.metric}={metrics['score']:.4f} "
                f"{sample_keys[1]}={metrics[sample_keys[1]]:.4f}")
            ckpt_lib.save_epoch(save_dir, bmodel, epoch, {
                "delta": delta, "weight_decay": weight_decay, **metrics}, mesh)
    if start_epoch >= b_epochs and start_epoch > 0:
        # resumed past the end of the Bayesian phase: the loop never ran, so
        # evaluate the restored state, not return phase C's score
        metrics = eval_bayesian()
        writer.scalars("bayesian_test", metrics, start_epoch)
    writer.close()
    dumper.flush()
    if keep is not None:
        keep.update(bmodel=bmodel, mesh=mesh)
    return float(metrics["score"])


def main():
    parser = argparse.ArgumentParser(description="Bayesian BERT on GLUE (one GPU)")
    parser.add_argument("--exp", default="bert_glue")
    parser.add_argument("--model", default="bert-base-uncased")
    parser.add_argument("--data", default=None,
                        help=".npz of tokenized GLUE, or a task directory of raw TSVs")
    parser.add_argument("--task", default="mrpc",
                        help="GLUE task name for raw-TSV featurization")
    parser.add_argument("--vocab", default=None,
                        help="vocab.txt of the native WordPiece tokenizer (raw TSVs)")
    parser.add_argument("--pretrained", default=None,
                        help="local Hugging Face model directory (config.json and "
                             "model.safetensors or pytorch_model.bin)")
    parser.add_argument("--size", default="base", choices=["base", "tiny"])
    parser.add_argument("--logs", default="logs")
    parser.add_argument("--epochs", type=int, default=EPOCHS)
    parser.add_argument("--b-epochs", type=int, default=EPOCHS)
    parser.add_argument("--samples", type=int, default=SAMPLES)
    parser.add_argument("--batch-size", type=int, default=BATCH_SIZE)
    parser.add_argument("--lr", type=float, default=LR)
    parser.add_argument("--delta", type=float, default=0.05)
    parser.add_argument("--weight-decay", type=float, default=0.0)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--limit-batches", type=int, default=None)
    parser.add_argument("--mc-chunk", type=int, default=None,
                        help="run the S MC samples in chunks of this size with "
                             "gradient accumulation")
    parser.add_argument("--estimator", default=None,
                        choices=["fused", "naive", "flipout", "antithetic", "local"],
                        help="MC estimator of phases C and D; default: antithetic "
                             "when --samples (and --mc-chunk) is even, fused "
                             "(independent draws) otherwise")
    parser.add_argument("--bf16", action="store_true",
                        help="bf16 activations (variational numerics stay f32)")
    parser.add_argument("--warmup", type=float, default=0.0,
                        help="linear-warmup fraction of total steps")
    parser.add_argument("--save-dir", default=None,
                        help="write the variational state after each Bayesian epoch")
    parser.add_argument("--resume", action="store_true",
                        help="continue the Bayesian phase from --save-dir")
    parser.add_argument("--device", default="cuda")
    add_mesh_args(parser)
    parser.add_argument("--hypersearch", type=int, default=0,
                        help="run N random-search trials over delta/weight_decay")
    args = parser.parse_args()
    kwargs = dict(
        exp=args.exp, model_name=args.model, data=args.data, task=args.task,
        vocab=args.vocab, logs=args.logs, epochs=args.epochs, b_epochs=args.b_epochs,
        samples=args.samples, batch_size=args.batch_size, lr=args.lr,
        size=args.size, bf16=args.bf16, pretrained=args.pretrained, seed=args.seed,
        limit_batches=args.limit_batches, save_dir=args.save_dir, resume=args.resume,
        estimator=args.estimator, mc_chunk=args.mc_chunk, warmup=args.warmup,
        device=args.device, **mesh_kwargs(args),
    )
    t0 = time.time()
    if args.hypersearch:
        # the reference script: delta log-uniform over (1e-2, 1e-1), weight
        # decay uniform over [0, 1e-3] (``examples/bert_glue.py:324-331``)
        best = search_delta_weight_decay(train, args.hypersearch, args.seed, **kwargs)
        launcher_print(f"best score={best.value:.4f} with {best.hyperparameters}")
    else:
        score = train(delta=args.delta, weight_decay=args.weight_decay, **kwargs)
        launcher_print(f"final score={score:.4f}")
    launcher_print(f"done in {time.time() - t0:.1f}s")
    ptrain.finish()


if __name__ == "__main__":
    main()
