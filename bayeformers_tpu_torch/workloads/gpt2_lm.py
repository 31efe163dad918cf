"""Causal-LM workload on one GPU (counterpart of
``bayeformers_tpu/workloads/gpt2_lm.py``): GPT-2, and with ``--model
llama|mistral|gemma`` the LLaMA-architecture families.

The four-phase recipe on a decoder: (1) frequentist next-token training
(AdamW, optax's defaults: weight decay 1e-4 on every leaf), (2) MOPED
``to_bayesian(delta, freeze=True)``, (3) Bayesian MC eval (S=10: next-token
accuracy of the S-mean logits, ``acc_std`` the std of the per-draw
accuracies, the mean predictive entropy and the ECE) and (4) the ELBO
fine-tune (AdamW over the trainable leaves, rho included, as optax's
``adamw`` behind the trainable mask decays them). Data is the JAX package's
synthetic Markov language (``models/gpt2.py::synthetic_lm_batch``, the same
numpy draws), so the Bayes-optimal accuracy is known; ``--corpus PATH`` (a
``.txt`` file or a directory of them) trains on real text instead, packed
into ``seq``-token windows by the native BPE tokenizer (``vocab.json`` and
``merges.txt`` next to the corpus) or the Unigram one (``tokenizer.json``)
(``utils/data.py::load_lm_corpus``), the model's vocabulary sized to the
tokenizer's.

The defaults are the JAX workload's: the naive estimator, f32 activations,
S=10, B=8, L=128; ``--estimator`` takes the reference's five, ``--bf16``
bf16 activations. The evals run the test set in batches of ``batch_size``
and sum exactly what the JAX workload takes over the whole set at once
(an S x n_test x L x vocab logits array would be 33 GB in f32 at GPT-2
base). ``train(**config_overrides)`` go to the model's build function, as
in the JAX workload (``max_position_embeddings=1024``,
``sliding_window=...``); ``--seq`` may go up to the model's maximum
position. ``--dp``/``--tp``/``--independent-draws`` run the data- and
tensor-parallel tier over the ranks of ``python -m torch.distributed.run``
(``parallel/``; tp needs ``--estimator fused`` or ``antithetic``: tp on the
naive tier and ``--sp`` are ROADMAP queue 1 item 6(d)).

    python -m bayeformers_tpu_torch.workloads.gpt2_lm --limit-batches 3
    python -m bayeformers_tpu_torch.workloads.gpt2_lm --estimator antithetic --bf16
    python -m bayeformers_tpu_torch.workloads.gpt2_lm --model llama --limit-batches 3
    python -m torch.distributed.run --nproc-per-node 2 -m \
        bayeformers_tpu_torch.workloads.gpt2_lm --tp 2 --estimator antithetic --backend gloo
"""
from __future__ import annotations

import argparse
import itertools
import time

import numpy as np
import torch

from bayeformers_tpu_torch import elbo, training
from bayeformers_tpu_torch.models.gpt2 import build_gpt2, synthetic_lm_batch
from bayeformers_tpu_torch.models.llama import FAMILIES, build_llama_family
from bayeformers_tpu_torch.nn.fused import derive_seed
from bayeformers_tpu_torch.nn.surgery import to_bayesian
from bayeformers_tpu_torch.parallel import train as ptrain
from bayeformers_tpu_torch.parallel.mesh import shard_batch
from bayeformers_tpu_torch.parallel.train import add_mesh_args, launcher_print, mesh_kwargs
from bayeformers_tpu_torch.utils.data import load_lm_corpus
from bayeformers_tpu_torch.utils.metrics import Report, ece_from_confidence, run_name
from bayeformers_tpu_torch.utils.optim import ClippedAdamW

EPOCHS = 1
B_EPOCHS = 1
SAMPLES = 10
BATCH_SIZE = 8
SEQ = 128
LR = 5e-5
DELTA = 0.05
ORDER_FRAC = 0.85
WEIGHT_DECAY = 1e-4  # optax.adamw's default
ESTIMATORS = ("naive", "fused", "flipout", "antithetic", "local")
MODELS = ("gpt2",) + FAMILIES


def adamw(named, lr: float) -> ClippedAdamW:
    """``optax.adamw(lr)`` over ``(name, tensor, _)`` triples, as the JAX
    workload takes it in both phases: weight decay 1e-4 on every tensor it
    sees (rho included), no clip."""
    return ClippedAdamW([(n, t, True) for n, t, _ in named], lr, WEIGHT_DECAY,
                        clip_norm=None)


def lm_nll_sum(logits: torch.Tensor, input_ids: torch.Tensor) -> torch.Tensor:
    """Sum-reduced next-token cross entropy (position t predicts t+1), the
    log-softmax in f32 over the vocabulary, summed in a fixed order."""
    lp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    tgt = input_ids[:, 1:].long()
    return -torch.sum(torch.gather(lp, -1, tgt[..., None])[..., 0])


def lm_accuracy_and_std(mc_logits: torch.Tensor, input_ids: torch.Tensor):
    """(next-token accuracy of the S-averaged logits, std of the per-draw
    accuracies, mean predictive entropy of the S-averaged distribution)."""
    tgt = input_ids[:, 1:].long()
    mean_logits = elbo.mc_logits_mean(mc_logits)[:, :-1]
    acc = torch.mean((torch.argmax(mean_logits, -1) == tgt).float())
    per_draw = torch.mean(
        (torch.argmax(mc_logits[:, :, :-1], -1) == tgt[None]).float(), dim=(1, 2))
    probs = torch.softmax(mean_logits.float(), -1)
    entropy = -torch.mean(torch.sum(probs * torch.log(torch.clamp(probs, min=1e-12)),
                                    dim=-1))
    return acc, torch.std(per_draw, unbiased=False), entropy


def lm_loss(out, batch):
    """``make_elbo_train_step``'s loss contract: (sum NLL, metrics)."""
    ids = batch["input_ids"]
    with torch.no_grad():
        acc, acc_std, _ = lm_accuracy_and_std(out, ids)
    return lm_nll_sum(elbo.mc_logits_mean(out), ids), {"acc": acc, "acc_std": acc_std}


def _eval_sums(out: torch.Tensor, ids: torch.Tensor) -> dict:
    """One test batch's share of the Bayesian eval: sums over its tokens
    (NLL of the S-mean logits, correct predictions of the mean and of each
    draw, predictive entropy) and its (confidence, correct) vectors."""
    tgt = ids[:, 1:].long()
    mean_logits = elbo.mc_logits_mean(out)
    probs = torch.softmax(mean_logits[:, :-1].float(), -1)
    ent = -torch.sum(probs * torch.log(torch.clamp(probs, min=1e-12)), dim=-1)
    # the reference's calibration inputs: the mean of the per-draw softmaxes
    pbar = torch.softmax(out[:, :, :-1].float(), -1).mean(0)
    conf, pred = torch.max(pbar, dim=-1)
    return {
        "nll": float(lm_nll_sum(mean_logits, ids)),
        "correct": float((torch.argmax(mean_logits[:, :-1], -1) == tgt).sum()),
        "per_draw": (torch.argmax(out[:, :, :-1], -1) == tgt[None]).sum((1, 2)).double(),
        "entropy": float(ent.sum()),
        "conf": conf.reshape(-1).cpu().numpy(),
        "hit": (pred == tgt).reshape(-1).cpu().numpy(),
    }


def build_lm(model: str, size: str, seed: int, dtype, device, **overrides):
    """GPT-2 or a LLaMA-architecture family at ``size``, from ``seed``;
    returns ``(model, vocab size, maximum position)``."""
    if model == "gpt2":
        net = build_gpt2(size=size, seed=seed, dtype=dtype, device=device, **overrides)
        return net, net.config.vocab_size, net.config.n_positions
    if model not in FAMILIES:
        raise ValueError(f"unknown model {model!r}; one of {MODELS}")
    net = build_llama_family(model, size=size, seed=seed, dtype=dtype, device=device,
                             **overrides)
    return net, net.config.vocab_size, net.config.max_position_embeddings


def train(
    exp: str | None = None,
    model: str = "gpt2",
    logs: str = "logs",
    epochs: int = EPOCHS,
    b_epochs: int = B_EPOCHS,
    samples: int = SAMPLES,
    batch_size: int = BATCH_SIZE,
    seq: int = SEQ,
    n_train: int = 512,
    n_test: int = 128,
    lr: float = LR,
    delta: float = DELTA,
    order_frac: float = ORDER_FRAC,
    seed: int = 0,
    size: str = "base",
    estimator: str = "naive",
    limit_batches: int | None = None,
    bf16: bool = False,
    dp: int = 1,
    tp: int = 1,
    sp: int = 1,
    mc_chunk: int | None = None,
    independent_draws: bool = False,
    backend: str | None = None,
    corpus: str | None = None,
    device: str = "cuda",
    **config_overrides,
) -> dict[str, float]:
    """Run phases 1-4; returns the frequentist, MOPED and final Bayesian
    next-token accuracies, the last ``acc_std`` and, on the synthetic
    language, the Bayes rate. ``dp``/``tp``, ``independent_draws`` and
    ``backend`` as in ``bert_glue.train``; GPT-2's packed c_attn is permuted
    to the head-aligned tp layout before sharding."""
    if estimator not in ESTIMATORS:
        raise ValueError(f"unknown estimator {estimator!r}")
    ptrain.check_mesh(dp, tp, estimator, batch_size)
    mesh, dev = ptrain.init_mesh(dp, tp, sp, backend, device)
    exp = exp or f"{model}_lm"
    rng = np.random.default_rng(seed)
    corpus_split = None
    if corpus is not None:
        corpus_split = load_lm_corpus(corpus, seq, seed=seed)
        # the embedding and LM head must cover the tokenizer's ids
        config_overrides.setdefault("vocab_size", corpus_split[2])
    net, vocab, max_pos = build_lm(model, size, seed,
                                   torch.bfloat16 if bf16 else torch.float32, dev,
                                   **config_overrides)
    if not 2 <= seq <= max_pos:
        raise ValueError(f"seq={seq} must be in [2, {max_pos}], the model's maximum "
                         "position")
    if corpus_split is not None:
        tr, te, tok_vocab, _ = corpus_split
        if tok_vocab > vocab:
            raise ValueError(f"tokenizer vocab {tok_vocab} exceeds model vocab {vocab}")
        train_ids = tr[:n_train] if n_train else tr
        test_ids = te[:n_test] if n_test else te
        n_train, n_test = len(train_ids), len(test_ids)
        bayes_rate = None  # unknown for real text
    else:
        train_ids = synthetic_lm_batch(rng, n_train, seq, vocab, order_frac)["input_ids"]
        test_ids = synthetic_lm_batch(rng, n_test, seq, vocab, order_frac)["input_ids"]
        bayes_rate = order_frac + (1 - order_frac) / vocab
    n_batches = max(1, n_train // batch_size)
    if limit_batches:
        n_batches = min(n_batches, limit_batches)
    n_tok = n_test * (seq - 1)

    name = run_name(exp, delta=delta)
    writer, dumper, say = ptrain.rank_logging(mesh, logs, name)

    def epoch_batches(ep):
        order = np.random.default_rng(seed + ep).permutation(len(train_ids))
        for i in range(n_batches):
            yield torch.from_numpy(train_ids[order[i * batch_size:(i + 1) * batch_size]]).to(dev)

    def test_batches():
        for i in range(0, n_test, batch_size):
            yield torch.from_numpy(test_ids[i:i + batch_size]).to(dev)

    # ---------------- Phase 1: frequentist train ---------------------------
    opt = adamw(training.model_parameters(net, lambda p: False), lr)

    @torch.inference_mode()
    def f_eval():
        sums = torch.zeros(2, dtype=torch.float64, device=dev)  # nll, correct
        for ids in test_batches():
            ids = shard_batch(ids, mesh)
            logits = net(ids)
            sums[0] += lm_nll_sum(logits, ids).double()
            sums[1] += (torch.argmax(logits[:, :-1], -1) == ids[:, 1:]).sum().double()
        nll, correct = ptrain.dp_sum(sums, mesh).tolist()
        return {"nll": nll / n_tok, "acc": correct / n_tok,
                **({"bayes_rate": bayes_rate} if bayes_rate is not None else {})}

    with dumper.section("frequentist_train"):
        for epoch in range(epochs):
            report = Report("nll")
            for ids in epoch_batches(epoch):
                opt.zero_grad()
                ids = shard_batch(ids, mesh)
                loss = lm_nll_sum(net(ids), ids)
                loss.backward()
                ptrain.all_reduce_grads(opt.params, mesh)
                opt.step()
                report.update(nll=float(ptrain.dp_sum(loss.detach(), mesh)))
            metrics = f_eval()
            writer.scalars("frequentist", metrics, epoch)
            dumper.record(**{f"epoch_{epoch}_{k}": v for k, v in metrics.items()})
            ceiling = f" (bayes rate {bayes_rate:.4f})" if bayes_rate is not None else ""
            say(f"[freq {epoch}] nll/tok={metrics['nll']:.4f} acc={metrics['acc']:.4f}"
                f"{ceiling}")
    opt.zero_grad()
    freq_acc = metrics["acc"]

    # ---------------- Phase 2: MOPED conversion ----------------------------
    bmodel = to_bayesian(net, delta=delta, freeze=True)
    ptrain.prepare_bayes_params(bmodel, mesh)

    # ---------------- Phase 3 & 4: Bayesian eval + ELBO train --------------
    # each rank evaluates its dp slice of every test batch; the sums add up
    eval_mc = ptrain.make_mc(bmodel, mesh, True, estimator, save_weights=False)
    draws = itertools.count()  # the key stream: seed + 1, split per use

    def next_seed() -> int:
        return derive_seed(seed + 1, next(draws))

    @torch.inference_mode()
    def b_eval():
        key = next_seed()
        sums = {"nll": 0.0, "correct": 0.0, "entropy": 0.0}
        per_draw, conf, hit, aux_p, aux_q = 0.0, [], [], [], []
        for j, ids in enumerate(test_batches()):
            ids = shard_batch(ids, mesh)
            out, aux = eval_mc(derive_seed(key, j), samples, ids)
            part = _eval_sums(out, ids)
            for k in sums:
                sums[k] += part[k]
            per_draw = per_draw + part["per_draw"]
            conf.append(part["conf"])
            hit.append(part["hit"])
            aux_p.append(float(torch.mean(aux["log_prior"])))
            aux_q.append(float(torch.mean(aux["log_variational_posterior"])))
        if mesh is not None and mesh.dp > 1:
            total = ptrain.dp_sum(torch.tensor(list(sums.values()), dtype=torch.float64,
                                               device=dev), mesh)
            sums = dict(zip(sums, total.tolist()))
            per_draw = ptrain.dp_sum(per_draw, mesh)
            conf, hit = ([ptrain.gather_outputs(torch.from_numpy(np.concatenate(a)).to(dev),
                                                mesh, dim=0).cpu().numpy()] for a in (conf, hit))
        return {
            "nll": sums["nll"] / n_tok, "acc": sums["correct"] / n_tok,
            "acc_std": float(torch.std(per_draw / n_tok, unbiased=False)),
            "entropy": sums["entropy"] / n_tok,
            "ece": ece_from_confidence(np.concatenate(conf), np.concatenate(hit)),
            "log_prior": float(np.mean(aux_p)),
            "log_variational_posterior": float(np.mean(aux_q)),
        }

    b_opt = adamw(bmodel.trainable_parameters(), lr)
    b_step = ptrain.make_train_step(
        bmodel, b_opt, samples, n_batches, mesh, loss_fn=lm_loss, input_keys=("input_ids",),
        estimator=estimator, mc_chunk=mc_chunk, independent_draws=independent_draws)

    with dumper.section("bayesian_eval"):
        metrics = b_eval()
        writer.scalars("bayesian_eval", metrics, 0)
        dumper.record(**metrics)
        say(f"[baye eval] acc={metrics['acc']:.4f} acc_std={metrics['acc_std']:.4f} "
            f"H={metrics['entropy']:.4f}")
    moped_acc = metrics["acc"]

    with dumper.section("bayesian_train"):
        for epoch in range(b_epochs):
            report = Report("loss", "nll")
            for ids in epoch_batches(100 + epoch):
                m = b_step(next_seed(), {"input_ids": shard_batch(ids, mesh)})
                report.update(loss=float(m["loss"]), nll=float(m["nll"]))
            metrics = b_eval()
            writer.scalars("bayesian", metrics, epoch)
            dumper.record(**{f"epoch_{epoch}_{k}": v for k, v in metrics.items()})
            say(f"[baye {epoch}] loss={float(m['loss']):.4f} acc={metrics['acc']:.4f} "
                f"acc_std={metrics['acc_std']:.4f}")

    writer.close()
    dumper.flush()
    return {"freq_acc": freq_acc, "moped_acc": moped_acc, "bayesian_acc": metrics["acc"],
            "acc_std": metrics["acc_std"],
            **({"bayes_rate": bayes_rate} if bayes_rate is not None else {})}


def main():
    parser = argparse.ArgumentParser(description="Bayesian causal LM (one GPU)")
    parser.add_argument("--model", default="gpt2", choices=list(MODELS))
    parser.add_argument("--logs", default="logs")
    parser.add_argument("--epochs", type=int, default=EPOCHS)
    parser.add_argument("--b-epochs", type=int, default=B_EPOCHS)
    parser.add_argument("--samples", type=int, default=SAMPLES)
    parser.add_argument("--batch-size", type=int, default=BATCH_SIZE)
    parser.add_argument("--seq", type=int, default=SEQ)
    parser.add_argument("--n-train", type=int, default=512)
    parser.add_argument("--n-test", type=int, default=128)
    parser.add_argument("--lr", type=float, default=LR)
    parser.add_argument("--delta", type=float, default=DELTA)
    parser.add_argument("--order-frac", type=float, default=ORDER_FRAC)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--size", default="base", choices=["base", "tiny"])
    parser.add_argument("--estimator", default="naive", choices=list(ESTIMATORS))
    parser.add_argument("--limit-batches", type=int, default=None)
    parser.add_argument("--bf16", action="store_true")
    add_mesh_args(parser)
    parser.add_argument("--mc-chunk", type=int, default=None)
    parser.add_argument("--corpus", default=None,
                        help="real-text corpus (.txt file or directory); needs "
                             "vocab.json + merges.txt (or tokenizer.json) next to it")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    t0 = time.time()
    results = train(
        model=args.model, logs=args.logs, epochs=args.epochs, b_epochs=args.b_epochs,
        samples=args.samples, batch_size=args.batch_size, seq=args.seq,
        n_train=args.n_train, n_test=args.n_test, lr=args.lr, delta=args.delta,
        order_frac=args.order_frac, seed=args.seed, size=args.size,
        estimator=args.estimator, limit_batches=args.limit_batches, bf16=args.bf16,
        mc_chunk=args.mc_chunk, corpus=args.corpus, device=args.device,
        **mesh_kwargs(args),
    )
    launcher_print(f"done in {time.time() - t0:.1f}s: {results}")
    ptrain.finish()


if __name__ == "__main__":
    main()
