#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``bayeformers_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for ``sm_90a``) and
``nvcc``; it builds the kernels from ``bayeformers_tpu_torch/csrc`` itself.
Phases, each timed, each raising on failure:

1. the card's name and power limit (``nvidia-smi``);
2. the kernel build (one ``nvcc`` call);
3. the eps stream: the device stream against the plain-torch stream (equal
   bits, normals within 1e-6; the uniform, the Box-Muller radius and the
   angle's cos and sin over all 2^24 uniforms it can form bit-equal), its
   moments, seed determinism;
4. ``bayes_linear_anti`` and ``bayes_linear`` (independent draws) against
   their plain versions at every shape of the BERT-base serving path (S=10,
   B=8, L=128), and where x must be copied into zero-padded rows for the
   product's TMA loads (K % 8 != 0, and x not 16-byte aligned), with
   bit-identical reruns;
5. ``mha_fwd`` against its plain version at the serving shape, with padded
   keys and one fully masked row;
6. serving, antithetic and then independent draws (the ``Predictor``
   default): BERT-base from a seed, MOPED conversion, a ``Predictor`` that
   answers three ragged requests through the kernels (launch counts read
   around exactly those requests), determinism per seed, the logits
   against the plain path on the card, and the request latency;
7. timings of each kernel, its plain version and one PyTorch library call
   at each shape;
8. ``reduce_abuv_anti`` and ``reduce_abuv`` (the backward's dmu/drho
   reduce) against their plain versions at every shape of the training
   path and one odd shape, on the W the forward kernel wrote, with
   bit-identical reruns;
9. ``mha_bwd`` against its plain version at the training shape (padded
   keys, one fully masked row) and at L = 512, with bit-identical reruns;
10. the ELBO step, antithetic and then independent draws (``fused``):
    BERT-base from a seed, MOPED-converted, through
    ``make_elbo_train_step`` at S=10, B=8, L=128, bf16: finite loss and
    log-probs, the ELBO falling over steps on one batch and draw, the
    gradients through the kernels against the ``impl="plain"`` step on the
    card, bit-identical reruns, launch counts read around exactly the timed
    steps, and the median step time;
11. the workload: ``workloads/bert_glue.train`` phases A-D at BERT-base on
    the synthetic data, three batches an epoch, at S=10 (antithetic) and at
    S=3 (the default pick for an odd S: independent draws), in bf16;
12. f32, the recipe's default activations (every f32 phase after the
    check that torch's f32 matmuls run in full f32, no TF32, so that the
    plain versions are a true-f32 yardstick): ``regen`` (Pallas #10), its
    independent and pair instances (one launch writes the interleaved
    pairs ``(w, 2 mu - w)``), each with and without the bf16 copy, against
    the plain stream and against the f32 and bf16 W of both forward
    kernels, bit for bit; the unit offsets of every draw instance (shards
    of a 1024 x 512 layer at (256, 0), (0, 128), (512, 256): ``bft_regen``
    and the forward's draw pass, W bit-equal to the whole layer's slice, y
    and log-probs within their gates, and a planted fault, each launch with
    its offsets zeroed, that must fail; :func:`phase_offsets`); the
    regenerating backward's one launch and no interleave, stack or cast of
    W in torch (:func:`regen_vjp_check`); the f32 forward instances at the
    serving shapes (y within 2e-5 of max |y|, log-probs 1e-5 relative, W
    bit-equal); the f32 and the (bf16 x, f32 W) reduces (A/B/V within 1e-5
    of each one's largest entry); f32 ``mha_fwd`` / ``mha_bwd`` (1e-4
    absolute plus 1e-4 relative); f32 serving under both estimators (logits
    within 1e-4 of the plain path); the f32 ELBO step of each estimator
    against the plain f32 step (loss 1e-6 relative, every gradient group
    1e-3 relative L2, reruns bit-equal, #10's pair instance launched 12
    times a step antithetic and #10 never ``fused``); in bf16, each
    estimator's step with ``save_weights=False`` (the regenerating
    backward, #10 on all 74 layers, in its instance with the bf16 copy,
    pairs for antithetic draws) against its plain regenerating step under
    the bf16 step's gates; the workload at its f32 default at S=10, which
    must launch #10;
13. the other two priors, in each dtype beside the phases above, whose
    instances the forward and reduce templates carry: MOPED with a
    trainable mu (the Gaussian prior on a separate prior_mu; mu moved off
    it by 1e-3 N(0, 1)) and the reference's default conversion, random
    init under the scale mixture. Each kernel instance against its plain
    version at the same shapes and gates (a pair's log_p per member; U and
    V of the reduce with A and B), and the forward's log-prob partial sums
    before their constants against plain f64 sums, 1e-5 of their sum of
    |terms|, on inputs whose pair members stand at least 10x that gate
    apart (:func:`check_logprob_terms`); serving under both estimators,
    every layer of the request held against its plain version, partials
    included (:class:`LayerCheck`), and the logits at the existing gates,
    but for random init, whose logits are ill-conditioned
    (:func:`mixture_logits_gate`); the ELBO step of both estimators in each
    dtype against its plain step, mu now trained (its gradients judged as
    the LayerNorm ones are in bf16), the gradients of the prior part alone
    against the plain step's (:func:`check_prior_grads`; under the
    mixture in bf16 also with each reduce's U, then V, zeroed, which it
    must fail), mu moved and prior_mu bit-identical after one step.

14. the estimators slice: the split ops' kernels, each with the MUFU count
    of its compiled code (``cuobjdump -sass``) in its bound: the grouped
    ``logprob`` (#11, one launch over all of BERT-base's 74 leaves and an
    odd shape) under both priors, its per-leaf partial sums against plain
    f64 sums, its log-probs against the plain version a leaf, and a planted
    fault (the last leaf's last block dropped) that must fail
    (:func:`phase_logprob`); ``bft_regen`` (#13) at flipout's S = 10, W
    bit-equal to the plain stream and to ``fused_linear.regenerate_weights``
    and its bf16 copy to W rounded; the grouped log-prob VJP that replaced
    #13's W behind the KL (dmu, drho against the plain VJP a leaf, no (S,
    K, N) tensor allocated, a planted fault: draw S - 1 dropped); flipout's
    ``sampled_dense`` VJP through #13 and the reduce against its plain
    route, no f32 ``torch.bmm`` (:func:`phase_split_regen`);
    ``sampled_dense`` (Pallas #12) in bf16 and f32 with mu = 0 and mu != 0
    against its plain version and ``x @ regenerate_weights`` at gates
    scaled to y, which two planted faults must fail; then flipout and local
    reparameterization under the GLUE recipe and random init, and the naive
    tier under the GLUE recipe, in bf16 and f32: the 8x128 request and the
    ELBO step against their plain runs (:func:`phase_estimator`), with
    launch counts (#12 on every flipout layer a forward, #13 and the reduce
    a backward; under the mixture one grouped #11 launch a forward and one
    grouped VJP launch a backward; no Bayesian linear kernel on the local
    and naive paths); and ``bert_glue --estimator flipout`` and ``local``.
15. GPT-2 base, the causal LM: the causal instances of ``mha_fwd`` (#3) and
    ``mha_bwd`` (#5) against their plain versions at N = S B = 80, L = 128,
    H = 768 and at L = 512, in bf16 and f32, at the attention gates, with
    right-padded keys, a fully masked row and a first-key-masked row (finite
    and uniform over all L keys), bit-equal reruns, and two planted faults
    that must fail the gates (the non-causal instance against the causal
    plain output; the plain mask one column off); the forward and reduce
    kernels at the packed c_attn's 768 -> 2304; ``Predictor(task=
    "causal-lm")`` on GPT-2 base (seed 0, zero leaves 0.01, MOPED 0.05
    frozen) under both estimators in bf16 and f32, with launch counts read
    around exactly three ragged requests (48 Bayesian linear launches and 12
    causal ``mha_fwd`` a request) and the logits against the plain path; the
    ELBO step with the LM loss under both estimators in each dtype against
    the plain step (48 reduces and 12 causal ``mha_bwd`` a step, 12 #10 in
    the f32 antithetic step), peak memory; ``workloads/gpt2_lm.train`` for
    3 batches at its default (naive, f32) and antithetic bf16; flipout and
    local on GPT-2 in bf16 through :func:`phase_estimator`.
16. the LLaMA-architecture families: the head-width-32, key-tiled (L > 128
    in bf16, L > 512 in f32), one-tile ragged (L = 77) and #4 instances of
    ``mha_fwd`` / ``mha_bwd`` against their plain versions
    (:func:`phase_attention16`: planted faults, a width-96 refusal), and a
    causal L = 1024 query tile that mixes rows whose whole prefix is masked
    with normal rows, where the causal skip must not fire
    (:func:`mixed_tile_check`, with a planted fault); the forward and
    reduce kernels at LLaMA's shapes; LLaMA base served under both
    estimators and trained (antithetic) in bf16 and f32
    (:func:`phase_serving_gpt2`, :func:`phase_train`); the tiny LLaMA at
    8x128 (head width 32) and at (1, 1024) with 1024 positions (#4's
    path), LLaMA base and GPT-2 base at (1, 1024), Mistral and Gemma base
    (:func:`phase_lm_once`); ``gpt2_lm --model llama``; flipout and local
    requests. bf16 logits of these paths are held against an f32 plain run
    (:func:`f32_logits_gate`).
17. wide heads: #3, #4's instance and #5 at head widths 128 and 256
    (:func:`phase_attention17`) in bf16 and f32 against their plain versions
    at the attention gates, causal and not, with right-padded keys, a fully
    masked row and a first-key-masked row, bit-equal reruns, and planted
    faults that must fail (the score scale of the other width, the plain
    mask one column off, the non-causal instance); at Gemma-2B's (N = 80, L
    = 128, H = 2048, 8 heads; f32 N = 20) and Mistral-7B's (80, 128, 4096,
    32 heads) request and step, the key-tiled walk at L = 1024, and #4's
    shapes (H = 256 in heads of 128 and 256, L = 1024, counted in
    ``mha_fwd_per_head``); width 96 raises. The forward and reduce kernels
    at the published models' FFN and lm_head shapes. Gemma-2B and
    Mistral-7B at their published widths (``models/llama.py::PUBLISHED``,
    one layer (:data:`WIDE_LAYERS`), random weights from seed 0, MOPED 0.05
    frozen) served and trained through ``Predictor(task="causal-lm")`` and
    ``make_elbo_train_step`` (:func:`phase_lm_once`: 8 Bayesian linear and
    1 causal ``mha_fwd`` launch a request, 1 ``mha_bwd`` a step) in bf16
    at 8x128 and in f32 at 8x128 (Gemma 2x128, one step), the logits and the
    step against the plain path, peak memory; their 1x1024 requests, and
    the tiny models at #4's shapes.

18. BERT's sibling families and the SQuAD QA path at base width
    (:func:`phase18`): #3 and #5 at SQuAD's shapes (N = S B = 130, L = 384,
    H = 768, 12 heads, non-causal; f32 also at the chunked step's N = 26)
    against their plain versions at the attention gates, with right-padded
    keys, fully masked rows, bit-equal reruns, and ragged right padding
    (rows of 1-3 live keys, two whole key tiles masked) under both the
    ``finfo.min`` bias and DistilBERT's ``-1e30 * (1 - mask)``, where the
    plain mask one column off must fail (:func:`squad_mask_checks`); the
    forward and reduce kernels at the QA head's 768 -> 2 (M = 13 x 384,
    both estimators) and ALBERT's 128 -> 768; BERT-base with its span head
    (seed 0, frozen MOPED 0.05) served by ``Predictor(task="qa",
    seq_lens=(384,))`` under both estimators (three ragged requests, 73
    Bayesian linear and 12 ``mha_fwd`` launches a request; the start and
    end logits against the plain path, :func:`encoder_logits_gate`, and the
    best spans against the plain path's, :func:`spans_check`), its
    ``qa_span_loss`` ELBO step at S = 10, B = 13, L = 384 against the plain
    step (antithetic bf16; 6 ``mha_bwd`` a step), one independent-draw
    step, and the f32 antithetic step at ``mc_chunk=2`` against its plain
    step and the plain step in f64 (each leaf within 1e-3 of the f64
    gradient plus twice the plain f32 step's distance from it:
    :func:`check_f32_leaves`; :func:`train_encoder`, peak memory);
    DistilBERT-base (6 layers),
    ALBERT-base (its layer 6 times: 6 launches a forward of each shared
    leaf), RoBERTa-base and Electra-base, every encoder (BERT's QA path
    too) at 6 layers (:data:`ENCODER_DEPTH18`), an 8x128
    classification request and an ELBO step each against the plain path
    (:func:`serve_encoder`, :func:`train_encoder`); and
    ``workloads/bert_squad.train`` and ``bert_glue --model
    distilbert-base-uncased`` for three batches an epoch in bf16.

19. the recipes' file front end and the hand-built ``BayesLinear`` on files
    it writes into a temporary directory (:func:`phase19`): #7 and #9 at the
    MNIST MLP's shapes (784 -> 512, 512 -> 512, 512 -> 10 at M = 64, S = 10;
    the mixture instance, bf16 and f32) against their plain versions at the
    gates of the rows above; the hand-built BayesLinear MLP's forward and
    ELBO step against their plain runs (:func:`phase_bayes_mlp`); (a)
    ``bert_glue`` at BERT-base from MRPC TSVs and a ``vocab.txt`` (the
    native WordPiece tokenizer) with ``--save-dir``, then ``--resume``, the
    restored leaves bit-equal to the saved; (b) ``Predictor.warmup``, then
    ``predict_texts`` on 8 raw sentence pairs, equal to ``__call__`` on the
    same features bit for bit; (d) ``mlp_mnist --estimator fused
    --limit-batches 3`` on MNIST idx files.

20. the vision families, convolutions and embedding tables
    (:func:`phase20`): (a) #3 and #5 at ViT's shapes (N = S B = 80, L =
    197, H = 768, 12 heads; f32 also N = 20; ViT-tiny's L = 17, 2 heads)
    at the attention gates, and a planted fault that must fail them, the
    plain version with each query also seeing one key of the next sequence
    (:func:`attention20`); (b) the forward and reduce kernels at ViT's
    shapes (the patch conv's im2col, 768 -> 768 at M = 8 x 196; the
    encoder at M = 8 x 197; the 1000-way head), CLIP's bias-free patch
    conv (3072 -> 768 at M = 8 x 49) and TinyCNN's K = 27 and K = 16 convs,
    both estimators; (c) #10 at BERT-base's tables (30522, 512 and 2 rows
    of 768), pair and independent instances, and the ``sampled_weights``
    VJP, bit-equal to the plain versions (:func:`embed_regen20`); (d)
    ViT-base/16 at its published widths, 6 of its 12 layers
    (:data:`VISION_DEPTH`) (seed 0, frozen MOPED 0.05 under
    ``(*DEFAULT_RULES, CONV_RULE)``: the patch conv Bayesian) served at S =
    10, B = 8 under both estimators (outputs and the posterior summary
    against the plain path, :func:`serve_vision`) and trained (bf16 steps
    against the plain step, an independent-draw step, an f32 request and
    step at B = 2; :func:`train_vision`), flipout and LRT (a forward and a
    step each) and the naive tier (a forward at B = 2), launches counted
    around each; (e) CLIP at ViT-B/32's widths, 6 layers a tower, with ``CONV_RULE``, its
    fused forward untiled by ``untile_axes=(1,)`` and one contrastive ELBO
    step against the plain path; TinyCNN served and trained; (f) BERT-base
    with ``EMBEDDING_RULE``: an antithetic request (#10's pair instance a
    table) and an independent-draw step against the plain path, an LRT
    request, and flipout raising as the reference does.

21. the encoder-decoder families and posterior-predictive generation
    (:func:`phase21`): (a) the forward and reduce kernels at T5-small's
    bias-free shapes (512 -> 512, 512 -> 2048, 2048 -> 512 at the source's
    8 x 256 rows and the target's 8 x 64; both estimators) and
    Whisper-base's (its conv stems as im2col products, 240 -> 512 at 2 x
    3000 frames and 1536 -> 512 at 2 x 1500, and the three at its encoder's
    2 x 1500 and decoder's 2 x 64 rows; antithetic), and flipout's #12,
    #13 and VJP at T5-small's (:func:`flipout21`); (b) T5-small at
    ``T5_SMALL_KWARGS`` (t5-small's published config, seed 0, frozen MOPED
    0.05) served (three requests through ``mc_apply_fused`` and the mean
    logits, S = 10, B = 8, 256 source and 64 target ids, bf16) and trained
    (three ELBO steps through ``make_elbo_train_step`` with the
    teacher-forced token CE as ``loss_fn``) under both estimators, and
    Whisper-base at openai/whisper-base's widths (``WHISPER_BASE_KWARGS``,
    both at 3 of their 6 + 6 layers, :data:`SEQ2SEQ_DEPTH`;
    ``CONV_RULE``: the stems through the kernels; features (2, 80, 3000),
    64 decoder ids) antithetic: launches counted around exactly the timed
    requests and steps, reruns bit-equal, the log-probs and gradients
    against the plain path, the bf16 logits against an f32 plain run, the
    ELBO falling on one batch and draw (:func:`serve21`, :func:`train21`);
    T5-small's regenerating objective (``save_weights=False``: #10's pair
    instance and the (bf16 x, f32 W) reduce once a kernel,
    :func:`regen21`) and its flipout and LRT request and step, their ELBO
    objective's gradients against the plain path (:func:`tier21`);
    (c) ``mc_generate`` on GPT-2 base and T5-small (S = 4, B = 2,
    ``max_new_tokens=16``, greedy, f32): delta -> 0 draws' logits against
    the frequentist greedy decode's, the KV cache against a decode that
    recomputes the prefix, and the wall time a step of each, in turns
    (:func:`generate21`).

22. the stacked hand-built tiers and ``pretrained=`` for the causal LMs
    (:func:`phase22`; random init under the scale mixture, f32, S = 2,
    every projection one call of #7/#8 forward and #9 backward at S = 1):
    (a) #7 and #9 against their plain versions at the tiers' new shapes
    (768 -> 768 at M = 16; 768 -> 2304, 768 -> 768, 768 -> 3072 and
    3072 -> 768 at M = 8 x 127; 768 -> 3072 and 3072 -> 768 at M = 159, one
    expert's capacity); (b) BlockStack at BERT-base's width and depth (12 x
    768, B = 64 in 4 microbatches): an ELBO step against the plain step
    (loss 1e-5, see :func:`block22`; each leaf 1e-3 relative L2), a
    bit-equal rerun, #7/#9 96 times each around exactly that step, M = 1
    and M = 4 equal, three Adam steps timed; (c) the transformer LM at
    GPT-2 small's widths on a 2-block copy against the plain path (logits,
    log-probs, a step; ``make_pp_lm_train_step`` at M = 2 against the single
    step), then ``stack_lm --arch transformer`` at 12 blocks for three
    steps; (d) the same with Switch-Base-8's MoE FFN through
    ``make_ep_lm_train_step`` (at 6 of 12 blocks), each block's kept and
    dropped tokens by expert and the routers' gradients printed (non-zero);
    each step also
    run plain in f64 (:func:`module_f64`); (e) GPT-2 base and LLaMA base
    written under HF names into a safetensors file and built by
    ``build_model(name, pretrained=DIR)``: an 8 x 128 request's logits equal
    to the source model's.

23. the data- and tensor-parallel tier (``parallel/``; :func:`phase23`), two
    ranks sharing the card over gloo (NCCL refuses two ranks on one device;
    gloo takes CUDA tensors for all-reduce and broadcast, the only
    collectives of a step): #1, #6, #3 and #5 at BERT-base's tp = 2 shard
    shapes (768 -> 384, 768 -> 1536, 384 -> 768, 1536 -> 768 at M = 1024;
    6 heads of 64) in bf16 and f32, and #2 at 3072 -> 768, M = 512 (the dp
    = 2 step's rows) and 2048 -> 1024 (BERT-large's row shard) against
    their plain versions, timed; then two ranks spawned (:func:`rank23`,
    launches counted in them): (a) dp = 2 in f32 against the one-process
    step on the whole batch; (b) tp = 2 in f32 and bf16 ((a) and (b) at 6
    of BERT-base's 12 layers, :data:`DEPTH23`), each rank's
    objective through the kernels against its plain one at the same draws;
    (c) tp = 2 at BERT-large's widths (2 layers), every shard on the unit
    grid, against the one-process objective; (d) GPT-2 base at tp = 2
    (c_attn permuted) in bf16, kernels against plain; (e) ``bert_glue --dp
    2 --backend gloo`` under ``torch.distributed.run`` (:func:`glue23`),
    rank 0's checkpoint reloaded in one process with its plain logits bit
    for bit. Its times are two ranks sharing one card, not a scaling figure.

24. pp and ep across ranks (:func:`phase24`; random init under the scale
    mixture, f32, S = 2, at phase 22's widths), two ranks sharing the card
    over gloo: (a) #7 and #9 at the pipeline's LM microbatch (768 -> 2304,
    768 -> 768, 768 -> 3072, 3072 -> 768 at M = 8 x 127 / 4 = 254) against
    their plain versions, timed, with ``torch.bmm``; then two ranks spawned
    (:func:`rank24`, launches counted in them around exactly the timed
    steps): (b) BlockStack 12 x 768 at pp = 2 (6 blocks a stage, B = 64 in
    4 microbatches) against the one-process step at the same seed (loss
    1e-6, gathered gradients and, after three Adam steps, leaves 1e-5
    relative L2); (c) the LM at GPT-2 small's widths at pp = 2 against the
    one-process ``make_pp_lm_train_step`` at the same microbatches, the
    embed and pos gradients bit-equal on both ranks; (d) the LM with
    Switch-Base-8's MoE FFN at ep = 2 (4 experts a rank) against the
    one-process step: the routers' gradients bit-equal on both ranks, the
    experts' gradients slices of the one-process ones, the kept and
    dropped tokens by expert equal on both ranks and to one process's; (e) ``stack_lm --pp 2`` and ``--ep 2
    --backend gloo`` under ``torch.distributed.run`` (:func:`stack24`),
    the ``--pp 2`` losses within 1e-5 of ``--pp 1``'s. Its times are two
    ranks sharing one card, not a scaling figure.

The timed requests and steps of phases 13-16 are three each
(:data:`TIMED`). ``python3 chip_smoke.py --from 16`` (or ``--from 17``
... ``--from 24``) runs the build, the eps stream and the phases from
there on only. The line before the last is a JSON object with one entry per kernel,
instance (operand types and prior) and shape; the last line is
``{"ok": true, "device": {...}}``.
Without a CUDA card it prints no result and exits with code 2.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

H100_BF16_FLOPS = 989e12   # dense tensor-core rate, NVIDIA data sheet (SXM)
# A true f32 product as 3xTF32 takes three TF32 products: the dense TF32
# peak (494.7 TFLOP/s, same sheet) over three, the least time an f32
# product could take on the tensor cores
H100_F32_FLOPS = 494.7e12 / 3
H100_BYTES_PER_S = 3.35e12  # HBM3
BF16, F32 = torch.bfloat16, torch.float32
TAG = {BF16: "bf16", F32: "f32"}
# The fused tier's three priors, by the conversion that chooses each: frozen
# MOPED (the prior on mu itself), MOPED with a trainable mu (the Gaussian
# prior on a separate prior_mu) and the reference's default, random init
# under the scale mixture (0.5, e^0, e^-6).
PRIORS = ("on_mu", "gaussian", "mixture")
MIXTURE = (0.5, 1.0, math.exp(-6.0))
# Each kernel's and library call's time is the median of this many windows
# of CUDA-event timing (one window of 20 launches could catch a slow spell)
WINDOWS = 5
# converted kernels of BERT-base: 12 x 6, the pooler, the classifier
BERT_BASE_LAYERS = 74
# the timed requests and steps of phases 13-16 (each phase's launch counts
# are read around exactly these): the median of three
TIMED = 3


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def say(*parts) -> None:
    print(*parts, flush=True)


def time_ms(fn, iters: int, warmup: int = 2, windows: int = 1) -> float:
    """Device time of one call of ``fn`` in ms: the mean by CUDA events over
    ``iters`` calls, the median of ``windows`` such windows."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return float(np.median(times))


def bound(n_bytes: float, n_flops: float, dtype=BF16) -> tuple[float, str]:
    """The least time (ms) for the bytes at the HBM rate and the products'
    flops at the tensor rate of their type; which of the two is larger."""
    rate = H100_F32_FLOPS if dtype == F32 else H100_BF16_FLOPS
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def row(name, counter, shape, path, source, replaces, err, ms, plain_ms, b,
        lib_ms) -> dict:
    """One entry of the kernels line, before its launches are known:
    ``counter``/``shape`` name the launch count it takes from the run of
    ``path`` (a phase's key in main)."""
    return dict(name=name, counter=counter, shape=shape, path=path, route="cuda",
                source=source, replaces=replaces, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1], library_ms=lib_ms)


def require_f32_matmuls() -> None:
    """torch's f32 matmuls must run in full f32: the plain versions are the
    yardstick of the kernels' true-f32 products, and a TF32 yardstick would
    hide a TF32 kernel."""
    check(torch.get_float32_matmul_precision() == "highest",
          f"float32 matmul precision is {torch.get_float32_matmul_precision()!r}")
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are allowed")


def phase_eps(lib, common, _build) -> None:
    dev = torch.device("cuda")
    seeds = torch.tensor([1, 7, 123456789], dtype=torch.int32, device=dev)
    for K, N, k0, n0 in ((512, 256, 0, 0), (300, 130, 256, 128), (768, 768, 512, 1024)):
        eps = torch.empty((3, K, N), dtype=torch.float32, device=dev)
        bits = torch.empty((3, K, N, 2), dtype=torch.int32, device=dev)
        _build.check(lib.bft_unit_eps(seeds.data_ptr(), 3, K, N, k0, n0,
                                      eps.data_ptr(), bits.data_ptr(),
                                      common.cuda_stream(eps)), "bft_unit_eps")
        torch.cuda.synchronize()
        b1, b2, _ = common.philox_bits(
            seeds, torch.arange(K, device=dev) + k0, torch.arange(N, device=dev) + n0)
        words = bits.to(torch.int64) & 0xFFFFFFFF
        check(bool((words[..., 0] == b1).all() and (words[..., 1] == b2).all()),
              f"device eps bits differ from the plain stream at {(K, N, k0, n0)}")
        err = (eps - common.unit_eps(seeds, (K, N), (k0, n0))).abs().max().item()
        check(err <= 1e-6, f"device eps differs by {err} at {(K, N, k0, n0)}")
        say(f"eps K={K} N={N} offsets=({k0},{n0}): bits equal, max |d eps| = {err}")
    # every uniform the stream can form, its radius and its angle's cos and
    # sin (sincosf, the uniform by one fma) against the plain stream's torch
    # ops on the card, bit for bit
    n = 1 << 24
    parts = torch.empty((4, n), dtype=torch.float32, device=dev)
    _build.check(lib.bft_stream_parts(*(p.data_ptr() for p in parts),
                                      common.cuda_stream(parts)), "bft_stream_parts")
    u = common.uniform_from_bits(torch.arange(n, dtype=torch.int64, device=dev) << 8)
    theta = torch.tensor(common.TWO_PI, dtype=torch.float32, device=dev) * u
    want = torch.stack([u, torch.sqrt(-2.0 * torch.log(u)), torch.cos(theta),
                        torch.sin(theta)])
    differ = (parts.view(torch.int32) != want.view(torch.int32)).sum(dim=1).tolist()
    check(sum(differ) == 0, f"the device stream's uniform, radius, cos, sin differ from the "
          f"plain stream's at {differ} of its {n} uniforms")
    say(f"eps parts over all {n} uniforms: uniform, radius, cos, sin bit-equal to the plain "
        f"stream's ({differ} differ)")
    del parts, u, theta, want
    draw = common.unit_eps(torch.tensor([42], dtype=torch.int32, device=dev), (768, 768))
    again = common.unit_eps(torch.tensor([42], dtype=torch.int32, device=dev), (768, 768))
    other = common.unit_eps(torch.tensor([43], dtype=torch.int32, device=dev), (768, 768))
    mean, var = draw.mean().item(), draw.var().item()
    say(f"eps 768x768 draw: mean {mean:.6f} var {var:.6f}")
    check(abs(mean) < 0.01 and abs(var - 1.0) < 0.01, "eps moments off")
    check(torch.equal(draw, again), "same seed gave another draw")
    check(not torch.equal(draw, other), "another seed gave the same draw")


def bayes_linear_inputs(S, M, K, N, moped_rho, n_draws, offset=0, dtype=BF16,
                        prior="on_mu"):
    """Seeded x (S, M, K) in ``dtype``, f32 mu/rho (K, N), ``n_draws`` seeds
    on the card and the op's prior keywords: MOPED mu and rho for the
    Gaussian priors, with a prior_mu that mu has moved sigma N(0, 1) away
    from under ``gaussian`` (on the scale of sigma, so that the two members
    of a pair differ in their log-prior terms as much as they can, see
    :func:`check_partials`); the uniform init's mu and rho (U(-0.2, 0.2),
    U(-5, -4)) under ``mixture``. ``offset`` > 0 starts x that many
    elements into its buffer, so that it is contiguous but not 16-byte
    aligned."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(M * 7 + K * 3 + N)
    buf = torch.empty(S * M * K + offset, dtype=dtype, device=dev)
    x = buf[offset:].view(S, M, K)
    x.copy_(torch.randn(S, M, K, device=dev, generator=gen))
    if prior == "mixture":
        mu = torch.rand(K, N, device=dev, generator=gen) * 0.4 - 0.2
        rho = torch.rand(K, N, device=dev, generator=gen) - 5.0
    else:
        mu = torch.randn(K, N, device=dev, generator=gen) * 0.02
        rho = moped_rho(mu, 0.05)
    seeds = torch.randint(0, 2**31 - 1, (n_draws,), device=dev, generator=gen,
                          dtype=torch.int32)
    kw = {}
    if prior == "gaussian":
        sigma = torch.nn.functional.softplus(rho)
        kw["prior_mu"] = mu + sigma * torch.randn(K, N, device=dev, generator=gen)
    elif prior == "mixture":
        kw["mixture"] = MIXTURE
    return x, mu, rho, seeds, kw


def prior_suffix(prior: str) -> str:
    """The launch counters' tag suffix of a prior (``ops/fused_linear.py``)."""
    return "" if prior == "on_mu" else f"/{prior}"


def plain_partials(common, mu, rho, seeds, antithetic, kw):
    """The forward kernel's log-prob partial sums (``bayes_linear_cuda(...,
    logprob_partials=True)``) in f64 from the plain f32 draw, with each
    one's sum of |terms|, the scale of its f32 rounding: per draw and
    column tile of 64, the sum of -eps^2 / 2, then of each member's
    log-prior terms (before the constants) where the members have their
    own (a pair under a prior not centred on mu)."""
    from bayeformers_tpu_torch.core.distributions import sigma_from_rho
    from bayeformers_tpu_torch.core.prior import MOPED_PRIOR_SIGMA
    from bayeformers_tpu_torch.ops.logprob import mixture_log_pdf

    K, N = mu.shape
    n_tiles = -(-N // 64)

    def tile_sums(t):
        t = torch.nn.functional.pad(t, (0, n_tiles * 64 - N))
        return t.view(t.shape[0], t.shape[1], n_tiles, 64).sum(dim=(1, 3))

    # in chunks of whole eps units of rows, at a wide layer (an lm_head)
    unit = common.UNIT_K
    step = max(1, common.PLAIN_CHUNK_ELEMS // (len(seeds) * N * unit)) * unit
    ref = scale = 0.0
    for r0 in range(0, K, step):
        rows = slice(r0, min(K, r0 + step))
        m = mu[rows]
        eps = common.unit_eps(seeds, tuple(m.shape), (r0, 0))
        se = sigma_from_rho(rho[rows])[None] * eps  # f32, as the kernel rounds it
        w0 = m[None] + se
        members = [w0, 2.0 * m[None] - w0] if antithetic and kw else [w0]
        terms = [-0.5 * eps.double() ** 2]
        for w in members:
            if "mixture" in kw:
                terms.append(mixture_log_pdf(w.double(), *kw["mixture"]))
            else:
                d = w.double() - kw["prior_mu"][rows].double() if kw else se.double()
                terms.append(-0.5 * (d / MOPED_PRIOR_SIGMA) ** 2)
        ref = ref + torch.stack([tile_sums(t) for t in terms], -1)
        scale = scale + torch.stack([tile_sums(t.abs()) for t in terms], -1)
        del eps, se, w0, members, terms
    return ref, scale


def check_partials(common, part, mu, rho, seeds, antithetic, kw, what) -> tuple[float, float]:
    """The forward kernel's log-prob partials against :func:`plain_partials`:
    each within 1e-5 of its sum of |terms|. The log-prob outputs cannot
    show these terms: they add a constant of K N (log sqrt(2 pi) + log
    sigma_p) (7.0e5 at 768x768 under a Gaussian prior, one f32 step 0.06)
    to a data part that, for MOPED weights, is tens of nats, and a pair's
    two members differ by 1e-3 to 1e-2 of it. Returns (the largest error
    over its gate, and for a pair with a log-prior each, the largest
    difference of the members' plain partials over their gate: how far a
    kernel that wrote one member's terms for both, or swapped them, would
    miss it; 0 otherwise)."""
    ref, scale = plain_partials(common, mu, rho, seeds, antithetic, kw)
    check(tuple(part.shape) == tuple(ref.shape),
          f"{what}: partials {tuple(part.shape)}, want {tuple(ref.shape)}")
    gate = 1e-5 * scale
    ratio = ((part.double() - ref).abs() / gate).max().item()
    check(ratio <= 1.0, f"{what}: log-prob partials differ from the plain f64 sums by "
          f"{ratio:.3g}x their gate (1e-5 of the sum of |terms|)")
    sep = 0.0
    if ref.shape[-1] == 3:
        sep = ((ref[..., 1] - ref[..., 2]).abs()
               / torch.maximum(gate[..., 1], gate[..., 2])).max().item()
    return ratio, sep


def check_logprob_terms(fl, x, mu, rho, seeds, antithetic, kw, lp, what,
                        need_sep: bool = True) -> str:
    """A rerun of the forward kernel that returns its log-prob partials:
    the partials against the plain f64 sums (:func:`check_partials`); with
    ``need_sep``, a pair's members, where each has a log-prior, far enough
    apart in the inputs (10x the gate) that a member written for the other
    would fail it; and ``lp``, the log_p that the kernel's finalize wrote, equal to
    each member's partials summed less the constant, to within f32 steps
    of the running sums. Returns the partials' largest error over their
    gate and the members' distances over the partials' gate and over
    finalize's f32 steps (0 where the members share a log-prior)."""
    from bayeformers_tpu_torch.core.distributions import LOG_SQRT_2PI
    from bayeformers_tpu_torch.core.prior import MOPED_PRIOR_SIGMA
    from bayeformers_tpu_torch.ops import common

    part = fl.bayes_linear_cuda(x, mu, rho, seeds, antithetic=antithetic,
                                logprob_partials=True, **kw)[-1]
    ratio, sep = check_partials(common, part, mu, rho, seeds, antithetic, kw, what)
    if need_sep and part.shape[-1] == 3:
        check(sep >= 10.0, f"{what}: the inputs' pair members differ by only {sep:.3g}x "
              "the partials' gate")
    n_tiles = part.shape[1]
    c_p = 0.0 if "mixture" in kw else mu.numel() * (LOG_SQRT_2PI
                                                    + math.log(MOPED_PRIOR_SIGMA))
    sums = part[..., 1:].double().sum(1)
    want = (sums.reshape(-1) if part.shape[-1] == 3
            else sums[:, 0].repeat_interleave(2 if antithetic else 1)) - c_p
    tol = 2.0 ** -23 * (n_tiles * part[..., 1:].double().abs().sum(1).max()
                        + want.abs().max()).item()
    fin = (lp.double() - want).abs().max().item()
    check(fin <= tol, f"{what}: log_p is {fin} from its partials' sums less the "
          f"constant (f32 steps {tol:.3g})")
    msep = (want[0::2] - want[1::2]).abs().max().item() / tol if sep else 0.0
    return ratio, sep, msep


def partials_summary(ratio, sep, msep) -> str:
    summary = f"partials within {ratio:.3g}x their gate"
    if sep:
        summary += (f", members apart {sep:.3g}x the gate in the partials and "
                    f"{msep:.3g}x finalize's f32 steps in log_p")
    return summary


def compare_bayes_linear(fl, x, mu, rho, seeds, antithetic, kw=None):
    """The forward kernel against its plain version on one input under the
    prior of ``kw``, and a rerun; raises on a mismatch. Returns (max |d y|,
    the kernel's W, a summary)."""
    kw = kw or {}
    shape = tuple(x.shape[1:]) + (mu.shape[1], TAG[x.dtype]) + tuple(kw)
    name = "bayes_linear_anti" if antithetic else "bayes_linear"
    y, lq, lp, w = fl.bayes_linear_with_w(x, mu, rho, seeds, antithetic=antithetic, **kw)
    again = fl.bayes_linear_with_w(x, mu, rho, seeds, antithetic=antithetic, **kw)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip((y, lq, lp, w), again))
    del again  # an lm_head's y and W are GBs: compared a draw at a time below
    yp, lqp, lpp, wp = fl.bayes_linear_plain(x, mu, rho, seeds, antithetic=antithetic,
                                             save_weights=True, **kw)
    check(same, f"{name} reruns differ at {shape}")
    err = max((a.float() - b.float()).abs().max().item() for a, b in zip(y, yp))
    if x.dtype == F32:
        # true f32 products: 2e-5 of max |y| (one TF32 product would miss
        # it by about ten times)
        scale = yp.abs().max().item()
        check(err <= 2e-5 * scale, f"{name} y differs at {shape}: max {err}, "
              f"{err / scale:.3g} of max |y|")
    else:
        check(all(torch.allclose(a.float(), b.float(), rtol=2e-2, atol=2e-2)
                  for a, b in zip(y, yp)), f"{name} y differs at {shape}: max {err}")
    # log_q, and log_p of every member (a pair's two under the priors not
    # centred on mu): 1e-5 relative
    for tag, a, b in (("log_q", lq, lqp), ("log_p", lp, lpp)):
        check(torch.allclose(a, b, rtol=1e-5, atol=0.0),
              f"{name} {tag} differs at {shape}: {a} vs {b}")
    lp_err = ((lp - lpp).abs() / lpp.abs()).max().item()
    lp_check = partials_summary(*check_logprob_terms(fl, x, mu, rho, seeds, antithetic,
                                                     kw, lp, f"{name} at {shape}"))
    # W = mu + softplus(rho) eps in x's dtype (and 2 mu - w for a pair's
    # second member), each step rounded as the plain version rounds it, from
    # the same normals (phase eps): equal to the plain W
    w_err = max((a.float() - b.float()).abs().max().item() for a, b in zip(w, wp))
    check(torch.equal(w, wp), f"{name} W differs at {shape}: max {w_err}")
    equal = sum((a == b).sum().item() for a, b in zip(w, wp)) / w.numel()
    return err, w, (
        f"y max|d| {err:.3g}, W max|d| {w_err:.3g} "
        f"({equal:.6f} equal), "
        f"log_q {lq[0].item():.6g} vs {lqp[0].item():.6g}, log_p rel err {lp_err:.3g}, "
        f"{lp_check}, reruns equal")


SERVING_SHAPES = ((1024, 768, 768), (1024, 768, 3072), (1024, 3072, 768),
                  (8, 768, 768), (8, 768, 2))
# the model families of the main paths: BERT-base, GPT-2 base (phase 15) and
# the LLaMA-architecture families at base (phase 16), whose launch paths
# carry the prefixes "gpt2/", "llama/", "mistral/" and "gemma/"
BERT, GPT2 = "", "gpt2/"
LLAMA, MISTRAL, GEMMA = "llama/", "mistral/", "gemma/"
LM_NAME = {GPT2: "GPT-2", LLAMA: "LLaMA", MISTRAL: "Mistral", GEMMA: "Gemma"}
LM_VOCAB = {GPT2: 50257, LLAMA: 32000, MISTRAL: 32000, GEMMA: 32000}
# the causal LMs' converted (K, N) and their launches a forward: GPT-2's four
# Conv1D layers a block; the LLaMA families' q/o (768 -> 768), k/v (768 ->
# 256: 4 kv heads), gate/up (768 -> 2048) and down (2048 -> 768) a block, and
# the untied lm_head (768 -> 32000)
LM_LAYERS = {GPT2: {(768, 2304): 12, (768, 768): 12, (768, 3072): 12, (3072, 768): 12},
             LLAMA: {(768, 768): 24, (768, 256): 24, (768, 2048): 24, (2048, 768): 12,
                     (768, 32000): 1}}
LM_LAYERS[MISTRAL] = LM_LAYERS[GEMMA] = LM_LAYERS[LLAMA]
# the serving shapes of a family that the rows do not hold yet: GPT-2's packed
# c_attn, 768 -> 2304; the LLaMA families' k/v, gate/up, down and lm_head
FAMILY_SHAPES = {GPT2: ((1024, 768, 2304),),
                 LLAMA: ((1024, 768, 256), (1024, 768, 2048), (1024, 2048, 768),
                         (1024, 768, 32000))}


def plain_iters(K: int, N: int) -> tuple[int, int]:
    """The calls and warm-up calls that time a linear kernel's plain
    version: (3, 1), or (1, 0) at a layer of more than 2^24 weights (the
    published models' FFNs and lm_heads, whose plain draws take seconds)."""
    return (3, 1) if K * N <= 1 << 24 else (1, 0)


def phase_bayes_linear(fl, moped_rho, antithetic, dtype=BF16, prior="on_mu",
                       family=BERT, path=None, S=10) -> list[dict]:
    """A forward kernel's instance for ``dtype`` and ``prior`` against its
    plain version, at the shapes of ``family``'s serving path that the
    rows do not hold yet, at ``S`` samples; returns the timing rows, whose
    launches come from the run of ``path`` (default: the family's
    requests)."""
    n_draws = S // 2 if antithetic else S
    name = "bayes_linear_anti" if antithetic else "bayes_linear"
    tag, isz = TAG[dtype], torch.finfo(dtype).bits // 8
    label = tag + ("" if prior == "on_mu" else f", {prior}")
    rows = []
    for M, K, N in (FAMILY_SHAPES[family] if family else SERVING_SHAPES):
        x, mu, rho, seeds, kw = bayes_linear_inputs(S, M, K, N, moped_rho, n_draws,
                                                    dtype=dtype, prior=prior)
        err, w, summary = compare_bayes_linear(fl, x, mu, rho, seeds, antithetic, kw)
        ms = time_ms(lambda: fl.bayes_linear(x, mu, rho, seeds, antithetic=antithetic,
                                             prior_on_mu=not kw, **kw), 20, windows=WINDOWS)
        plain_ms = time_ms(lambda: fl.bayes_linear_plain(
            x, mu, rho, seeds, antithetic=antithetic, **kw), *plain_iters(K, N))
        lib_ms = time_ms(lambda: torch.bmm(x, w), 20, windows=WINDOWS)
        # x, mu, rho (and prior_mu) read, y written, the log-probs and seeds
        n_bytes = (S * M * K * isz + (2 + ("prior_mu" in kw)) * K * N * 4
                   + S * M * N * isz + 2 * S * 4 + n_draws * 4)
        b = bound(n_bytes, 2.0 * S * M * K * N, dtype)
        say(f"{name} ({label}) M={M} K={K} N={N}: {summary}; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.bmm {lib_ms:.4f} ms, "
            f"bound {b[0]:.4f} ms ({b[1]})")
        if antithetic:
            line = 912 if K >= 2048 else 636
        else:
            line = 412 if K >= 2048 else 106
        suffix = ("" if dtype == BF16 else f",{tag}") + (
            "" if prior == "on_mu" else f",{prior}")
        rows.append(row(
            f"{name}[M={M},K={K},N={N}{suffix}]", name,
            (M, K, N, tag + prior_suffix(prior)),
            path or f"serve/{family}{'anti' if antithetic else 'indep'}/{tag}"
                    f"{prior_suffix(prior)}",
            "bayeformers_tpu_torch/csrc/bayes_linear.cu",
            f"bayeformers_tpu/ops/fused_linear.py:{line}", err, ms, plain_ms, b,
            lib_ms))
    if family:
        return rows
    # x copied into zero-padded rows for the product's TMA loads, when its
    # rows are not whole 16-byte chunks or it is not 16-byte aligned: off
    # the serving path, so checked here but neither timed nor counted
    per16 = 16 // isz
    for M, K, N, offset in ((100, 300 if dtype == BF16 else 302, 130, 0),
                            (64, 768, 130, 1)):
        x, mu, rho, seeds, kw = bayes_linear_inputs(S, M, K, N, moped_rho, n_draws,
                                                    offset, dtype, prior)
        check(K % per16 != 0 or x.data_ptr() % 16 != 0,
              f"{(M, K, N, offset)} does not take the padded x path")
        _, _, summary = compare_bayes_linear(fl, x, mu, rho, seeds, antithetic, kw)
        say(f"{name} ({label}) padded x path M={M} K={K} N={N} "
            f"x offset {offset}: {summary}")
    return rows


def phase_mha(at, dtype=BF16, shape=(80, 128, 768, 12), path=None) -> dict:
    """Kernel #3's instance for ``dtype`` against its plain version at
    ``shape`` (N, L, H, heads), timed; its launches come from the run of
    ``path`` (default: the antithetic requests)."""
    dev = torch.device("cuda")
    N, L, H, nh = shape
    tag, isz = TAG[dtype], torch.finfo(dtype).bits // 8
    gen = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn(N, L, H, device=dev, generator=gen).to(dtype)
               for _ in range(3))
    mask = torch.ones(N, L, device=dev)
    mask[: N // 2, L - 40:] = 0   # padded keys in half the rows
    mask[N - 1] = 0               # one fully masked row
    bias = at.mask_to_bias(mask)
    out = at.mha(q, k, v, bias, nh)
    again = at.mha(q, k, v, bias, nh)
    torch.cuda.synchronize()
    ref = at.mha_plain(q, k, v, bias, nh)
    err = (out.float() - ref.float()).abs().max().item()
    check(bool(torch.isfinite(out.float()).all()), "mha output not finite")
    if dtype == F32:
        check(torch.allclose(out, ref, rtol=1e-4, atol=1e-4),
              f"f32 mha differs from its plain version: max {err}")
    else:
        check(err <= 2e-2, f"mha differs from its plain version: max {err}")
    check(torch.equal(out, again), f"mha ({tag}) reruns differ")
    ms = time_ms(lambda: at.mha(q, k, v, bias, nh), 50, windows=WINDOWS)
    plain_ms = time_ms(lambda: at.mha_plain(q, k, v, bias, nh), 5, 1)
    sdpa_mask = bias.clamp_min(torch.finfo(dtype).min).to(dtype)
    sdpa_mask = sdpa_mask[:, None, None, :]

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            q.view(N, L, nh, H // nh).transpose(1, 2),
            k.view(N, L, nh, H // nh).transpose(1, 2),
            v.view(N, L, nh, H // nh).transpose(1, 2), attn_mask=sdpa_mask)

    lib_ms = time_ms(sdpa, 50, windows=WINDOWS)
    b = bound(4 * N * L * H * isz + N * L * 4, 4.0 * N * L * L * H, dtype)
    say(f"mha_fwd ({tag}) N={N} L={L} H={H}: max|d| {err:.3g}, reruns equal; kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
        f"{b[0]:.4f} ms ({b[1]})")
    suffix = "" if dtype == BF16 else f",{tag}"
    return row(f"mha_fwd[N={N},L={L},H={H}{suffix}]", "mha_fwd", (N, L, H, tag, False),
               path or f"serve/anti/{tag}", "bayeformers_tpu_torch/csrc/mha.cu",
               "bayeformers_tpu/ops/attention.py:119", err, ms, plain_ms, b, lib_ms)


def convert(bt, model, prior):
    """The conversion that chooses each prior: frozen MOPED (delta 0.05,
    the GLUE recipe); MOPED with a trainable mu (``freeze=False``), whose mu
    is then moved 1e-3 N(0, 1) off its prior_mu as fine-tuning moves it
    (seed 1), so that the Gaussian prior's centre is not mu; or the
    reference's default, random init from a generator (seed 0)."""
    from bayeformers_tpu_torch.nn.surgery import leaf

    if prior == "on_mu":
        return bt.to_bayesian(model, delta=0.05, freeze=True)
    if prior == "mixture":
        return bt.to_bayesian(model, generator=torch.Generator(device="cuda").manual_seed(0))
    bmodel = bt.to_bayesian(model, delta=0.05, freeze=False)
    gen = torch.Generator(device="cuda").manual_seed(1)
    with torch.no_grad():
        for path in bmodel.spec.paths:
            w = leaf(bmodel.model, path)
            w.add_(1e-3 * torch.randn(w.shape, device=w.device, generator=gen))
    return bmodel


def converted_base(bt, dtype, prior="on_mu", family=BERT, size="base", **overrides):
    """BERT-base (with config ``overrides``: a cut depth; or, ``family=GPT2``,
    GPT-2 base; ``LLAMA``, ``MISTRAL``, ``GEMMA``: that family at ``size``
    with config ``overrides``) from seed
    0 in ``dtype`` activations, converted for ``prior`` (:func:`convert`),
    and its trainable tensors. GPT-2's zero leaves (its biases) are set to
    0.01 first, as the JAX package's tests do (``tests/test_models.py:204-
    211``): MOPED would give a zero weight sigma = softplus(0) = 0.69."""
    if family in (LLAMA, MISTRAL, GEMMA):
        model = bt.build_llama_family(family[:-1], size, seed=0, dtype=dtype,
                                      device="cuda", **overrides)
    elif family == GPT2:
        from bayeformers_tpu_torch.models.gpt2 import build_gpt2

        model = build_gpt2(size, seed=0, dtype=dtype, device="cuda", **overrides)
        with torch.no_grad():
            for p in model.parameters():
                p.masked_fill_(p == 0, 0.01)
    elif overrides:
        model = bt.build_model("bert-base-uncased", size="base", seed=0, dtype=dtype,
                               device="cuda", **overrides)
    else:
        model = bt.build_bert(size="base", n_labels=2, seed=0, dtype=dtype, device="cuda")
    bmodel = convert(bt, model, prior)
    return bmodel, bmodel.trainable_parameters()


def build_predictor(bt, antithetic=True, dtype=BF16, prior="on_mu"):
    """BERT-base from seed 0, converted for ``prior``, served at S=10,
    antithetic or with independent draws, in ``dtype`` activations, in one
    (8, 128) bucket on the card."""
    bmodel, _ = converted_base(bt, dtype, prior)
    return bt.Predictor(bmodel, n_samples=10, batch_sizes=(8,), seq_lens=(128,),
                        antithetic=antithetic)


def serving_requests(bt) -> list[dict]:
    """Three ragged requests (3x77, 8x128, 5x20 token ids) from a seed; the
    second fills the (8, 128) bucket."""
    rng = np.random.default_rng(0)
    vocab = bt.BERT_BASE_KWARGS["vocab_size"]
    return [{"input_ids": rng.integers(1, vocab, (n, L)),
             "attention_mask": np.ones((n, L), np.int64),
             "token_type_ids": np.zeros((n, L), np.int64)}
            for n, L in ((3, 77), (8, 128), (5, 20))]


class LayerCheck:
    """Holds every Bayesian linear launch of a forward against its plain
    version on the same inputs (the kernel phases' gates: y 2e-2 in bf16,
    2e-5 of max |y| in f32; log-probs 1e-5 relative, and their partials,
    :func:`check_logprob_terms`), by wrapping ``bayes_linear`` while the
    forward runs. A well-conditioned check of a path whose end-to-end
    logits are not (random init), and of each layer's log-prior, which the
    model's summed log-probs cannot resolve (see ``phase_serving``)."""

    def __init__(self, fl):
        self.fl, self.orig = fl, fl.bayes_linear
        self.n, self.y_err, self.lp_err = 0, 0.0, 0.0
        self.part_err, self.sep, self.msep = 0.0, math.inf, math.inf

    def __enter__(self):
        def wrapped(x, mu, rho, seeds, **kw):
            out = self.orig(x, mu, rho, seeds, **kw)
            ref = self.orig(x, mu, rho, seeds, **dict(kw, plain=True))
            pkw = {k: kw[k] for k in ("mixture", "prior_mu") if kw.get(k) is not None}
            ratio, sep, msep = check_logprob_terms(
                self.fl, x, mu, rho, seeds, kw["antithetic"], pkw, out[2],
                f"layer {tuple(x.shape)}x{tuple(mu.shape)}", need_sep=False)
            self.part_err = max(self.part_err, ratio)
            if sep:
                self.sep, self.msep = min(self.sep, sep), min(self.msep, msep)
            y, yp = out[0].float(), ref[0].float()
            err = (y - yp).abs().max().item()
            if x.dtype == F32:
                ok = err <= 2e-5 * yp.abs().max().item()
            else:
                ok = torch.allclose(y, yp, rtol=2e-2, atol=2e-2)
            check(ok, f"a layer's y differs from its plain version at "
                  f"{tuple(x.shape)}x{tuple(mu.shape)}: max {err}")
            for a, b in zip(out[1:], ref[1:]):
                check(torch.allclose(a, b, rtol=1e-5, atol=0.0),
                      f"a layer's log-probs differ from the plain version: {a} vs {b}")
                self.lp_err = max(self.lp_err, ((a - b).abs() / b.abs()).max().item())
            self.n += 1
            self.y_err = max(self.y_err, err)
            return out

        self.fl.bayes_linear = wrapped
        return self

    def __exit__(self, *exc):
        self.fl.bayes_linear = self.orig


def max_dist(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def phase_serving(bt, fl, at, antithetic, dtype=BF16, prior="on_mu") -> tuple[dict, float]:
    """Returns per-kernel launch counts by shape over the three requests,
    and the median latency (ms) of the 8x128 request."""
    t0 = time.perf_counter()
    pred = build_predictor(bt, antithetic, dtype, prior)
    fwd, fwd_name = ((fl.LAUNCHES, "bayes_linear_anti") if antithetic
                     else (fl.INDEP_LAUNCHES, "bayes_linear"))
    tag = (("antithetic" if antithetic else "independent") + f", {TAG[dtype]}"
           + ("" if prior == "on_mu" else f", {prior}"))
    bmodel = pred.bmodel
    torch.cuda.synchronize()
    say(f"serving ({tag}): BERT-base built and converted in "
        f"{time.perf_counter() - t0:.2f} s ({len(bmodel.spec.paths)} converted leaves)")
    requests = serving_requests(bt)
    pred(requests[0], seed=100)  # the first request pays one-time set-up
    torch.cuda.synchronize()

    reset_counters(fl, at)
    outs = [pred(r, seed=100 + i) for i, r in enumerate(requests)]
    torch.cuda.synchronize()
    launches = {fwd_name: dict(fwd.by_shape), "mha_fwd": dict(at.LAUNCHES.by_shape)}
    check(fwd.count > 0 and at.LAUNCHES.count > 0,
          f"the requests launched no kernel: {launches}")
    say(f"serving ({tag}): launches over 3 requests: {fwd_name} "
        f"{fwd.count} {launches[fwd_name]}, mha_fwd "
        f"{at.LAUNCHES.count} {launches['mha_fwd']}")

    for r, o in zip(requests, outs):
        n = r["input_ids"].shape[0]
        check(o["probs"].shape == (n, 2), f"probs shape {o['probs'].shape}")
        check(all(np.isfinite(v).all() for v in o.values()), "non-finite output")
        check(np.allclose(o["probs"].sum(-1), 1.0, atol=1e-5), "probs do not sum to 1")
        check(bool((o["mutual_info"] >= -1e-6).all()
                   and (o["mutual_info"] <= o["entropy"] + 1e-6).all()),
              "BALD mutual information outside [0, entropy]")
    again = pred(requests[1], seed=101)
    other = pred(requests[1], seed=999)
    check(all(np.array_equal(again[k], outs[1][k]) for k in again),
          "the same seed gave other outputs")
    check(not np.array_equal(other["probs"], outs[1]["probs"]),
          "another seed gave the same outputs")
    say(f"serving ({tag}): probs of request 2: "
        f"{outs[1]['probs'][:, 0].round(4).tolist()}")

    # logits through the kernels against the plain path, on the card
    dev = bmodel.device
    batch = {k: torch.from_numpy(v).to(dev) for k, v in requests[1].items()}
    args = (batch["input_ids"], batch["attention_mask"], batch["token_type_ids"])
    with torch.inference_mode():
        if prior != "on_mu":
            with LayerCheck(fl) as layers:
                lk, auxk = bmodel.mc_apply_fused(12345, 10, *args, antithetic=antithetic)
            check(layers.n == BERT_BASE_LAYERS, f"the request ran {layers.n} Bayesian "
                  f"linear layers through the check, want {BERT_BASE_LAYERS}")
            say(f"serving ({tag}): every Bayesian linear launch of the request against "
                f"its plain version on the same inputs: {layers.n} layers, y max|d| "
                f"{layers.y_err:.3g}, log-probs rel err {layers.lp_err:.3g}, "
                + partials_summary(layers.part_err, layers.sep if antithetic else 0.0,
                                   layers.msep)
                + (" (least over the layers)" if antithetic else ""))
        else:
            lk, auxk = bmodel.mc_apply_fused(12345, 10, *args, antithetic=antithetic)
        lp, auxp = bmodel.mc_apply_fused(12345, 10, *args, antithetic=antithetic,
                                         impl="plain")
    err = max_dist(lk, lp)
    if prior != "mixture":
        limit = 1e-4 if dtype == F32 else 5e-2
        check(err <= limit, f"logits through the kernels differ from the plain path by {err}")
    else:
        err_note = mixture_logits_gate(bt, fl, bmodel, args, antithetic, dtype, lk, lp, err)
        say(f"serving ({tag}): {err_note}")
    for key in auxk:
        check(torch.allclose(auxk[key], auxp[key], rtol=1e-5, atol=0.0),
              f"{key} differs from the plain path: {auxk[key]} vs {auxp[key]}")
    say(f"serving ({tag}): logits kernels vs plain max|d| {err:.4g} (S=10, B=8, L=128); "
        f"log_q {auxk['log_variational_posterior'][0].item():.7g} vs "
        f"{auxp['log_variational_posterior'][0].item():.7g}, log_p "
        f"{auxk['log_prior'][0].item():.7g} vs {auxp['log_prior'][0].item():.7g}")

    lat = []
    for i in range(TIMED):
        torch.cuda.synchronize()
        t = time.perf_counter()
        pred(requests[1], seed=200 + i)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t) * 1e3)
    latency = float(np.median(lat))
    say(f"serving ({tag}): 8x128 request latency (S=10) median {latency:.3f} ms "
        f"over {TIMED}: {[round(v, 3) for v in lat]}")
    del pred, bmodel
    torch.cuda.empty_cache()
    return launches, latency


MIXTURE_F32_LOGITS = 2e-3


def mixture_logits_gate(bt, fl, bmodel, args, antithetic, dtype, lk, lp, err,
                        forward=None, overrides=None) -> str:
    """The end-to-end gate of the random-init (mixture) path, whose logits
    are ill-conditioned: at U(-0.2, 0.2) weights each layer amplifies a
    rounding difference, so that f32 products taken in f64 instead moved
    BERT-base's logits by 7.5e-5 on the CPU (2.4e-7 after MOPED). Set as
    the existing bf16 gates were, against a less exact path: bf16 logits
    through the kernels no further from the f32 plain path's than 1.5x the
    bf16 plain path's. f32 logits within 2e-3 of the plain path's (read
    2.1e-4 on an H100), a gate that the same plain path with TF32 products
    (read 0.13) must fail: the f32 instances must be true f32. Every layer
    is also held against its plain version (:class:`LayerCheck`).
    ``forward(bmodel, impl)`` runs the request's forward (default: the
    fused tier's at ``antithetic``); ``overrides``, the config's, as
    :func:`converted_base` takes them (the f32 twin's depth)."""
    if forward is None:
        def forward(m, impl):
            return m.mc_apply_fused(12345, 10, *args, antithetic=antithetic, impl=impl)[0]
    if dtype == BF16:
        twin, _ = converted_base(bt, F32, "mixture", **(overrides or {}))
        with torch.inference_mode():
            l32 = forward(twin, "plain")
        dk, dp = max_dist(lk, l32), max_dist(lp, l32)
        del twin
        check(dk <= 1.5 * dp, f"bf16 logits through the kernels are {dk} from the f32 "
              f"plain path's, the bf16 plain path's {dp}")
        return (f"logits kernels vs f32 plain max|d| {dk:.4g}, bf16 plain vs f32 plain "
                f"{dp:.4g} (gate 1.5x)")
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with torch.inference_mode():
            ltf = forward(bmodel, "plain")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    require_f32_matmuls()
    dtf = max_dist(ltf, lp)
    check(err <= MIXTURE_F32_LOGITS, f"f32 logits through the kernels are {err} from the "
          f"plain path's (gate {MIXTURE_F32_LOGITS})")
    check(dtf > MIXTURE_F32_LOGITS, f"the plain path with TF32 products is only {dtf} from "
          f"the true f32 one: the gate {MIXTURE_F32_LOGITS} would not fail a TF32 kernel")
    return (f"logits kernels vs plain max|d| {err:.4g} (gate {MIXTURE_F32_LOGITS}), plain "
            f"with TF32 products {dtf:.4g}")


def reset_counters(*modules) -> None:
    """Every launch counter of the given op modules to 0."""
    for m in modules:
        for name in ("LAUNCHES", "INDEP_LAUNCHES", "BWD_LAUNCHES", "REGEN_LAUNCHES",
                     "VJP_LAUNCHES"):
            if hasattr(m, name):
                getattr(m, name).reset()


def rel_err(a, b) -> float:
    """max |a - b| over max |b| (f32 sums of the same products in another
    order are judged against the scale of the result)."""
    return ((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30)).item()


TRAIN_SHAPES = ((1024, 768, 768), (1024, 768, 3072), (1024, 3072, 768),
                (8, 768, 768), (8, 768, 2))


REDUCE_INSTANCES = {  # tag: (x's and g's type, W's type, path of its launches)
    "bf16": (BF16, BF16, "train/{est}/bf16"),
    "f32": (F32, F32, "train/{est}/f32"),
    "bf16x-f32w": (BF16, F32, "regen/{est}/bf16"),
}


def phase_reduce(fl, fb, moped_rho, antithetic, tag="bf16", prior="on_mu",
                 family=BERT, path=None, S=10) -> list[dict]:
    """A reduce kernel's instance against its plain version, on the W the
    forward kernel wrote (saved residuals: bf16, f32) or on the regenerated
    f32 W (``bf16x-f32w``), under ``prior`` (the priors not centred on mu
    add U, the mixture's taken of its score); returns the timing rows of
    the training shapes, whose launches come from the run of ``path``
    (default: the family's steps), at ``S`` samples. A/B/(U/)V within 1e-4
    (bf16) or 1e-5 (an f32 operand: x or W) of each one's largest entry."""
    n_draws = S // 2 if antithetic else S
    xdt, wdt, instance_path = REDUCE_INSTANCES[tag]
    path = path or instance_path + prior_suffix(prior)
    est = family + ("anti" if antithetic else "indep")
    label = tag + ("" if prior == "on_mu" else f", {prior}")
    if antithetic:
        name, fn, plain = "reduce_abuv_anti", fb.reduce_abuv_anti, fb.reduce_abuv_anti_plain
    else:
        name, fn, plain = "reduce_abuv", fb.reduce_abuv, fb.reduce_abuv_plain
    from bayeformers_tpu_torch.ops.logprob import prior_of, reduce_keywords

    limit = 1e-5 if F32 in (xdt, wdt) else 1e-4
    isz = torch.finfo(xdt).bits // 8
    rows = []
    for M, K, N in (FAMILY_SHAPES[family] if family else TRAIN_SHAPES + ((100, 300, 130),)):
        x, mu, rho, seeds, kw = bayes_linear_inputs(S, M, K, N, moped_rho, n_draws,
                                                    dtype=xdt, prior=prior)
        if wdt == xdt:
            w = fl.bayes_linear_with_w(x, mu, rho, seeds, antithetic=antithetic, **kw)[3]
        else:
            w = fl.regenerate_weights(mu, rho, seeds)
            w = fl.interleave_antithetic(w, mu) if antithetic else w
        gen = torch.Generator(device="cuda").manual_seed(M + K + N)
        g = (torch.randn(S, M, N, device="cuda", generator=gen) * 0.01).to(xdt)
        g_p = torch.randn(S, device="cuda", generator=gen)
        pkw = reduce_keywords(prior_of(**kw))
        out = fn(x, g, w, mu, g_p, **pkw)
        again = fn(x, g, w, mu, g_p, **pkw)
        torch.cuda.synchronize()
        ref = plain(x, g, w, mu, g_p, **pkw)
        errs = [rel_err(a, r) for a, r in zip(out, ref)]
        names = "A/B/V" if prior == "on_mu" else "A/B/U/V"
        check(max(errs) <= limit, f"{name} ({label}) differs at {(M, K, N)}: "
              f"{names} rel err {errs}")
        check(all(torch.equal(a, b) for a, b in zip(out, again)),
              f"{name} ({label}) reruns differ at {(M, K, N)}")
        summary = f"{names} rel err " + "/".join(f"{e:.3g}" for e in errs)
        if (M, K, N) not in TRAIN_SHAPES + FAMILY_SHAPES.get(family, ()):
            say(f"{name} ({label}) odd shape M={M} K={K} N={N}: {summary}, reruns equal")
            continue
        ms = time_ms(lambda: fn(x, g, w, mu, g_p, **pkw), 20, windows=WINDOWS)
        plain_ms = time_ms(lambda: plain(x, g, w, mu, g_p, **pkw), *plain_iters(K, N))
        xt = x.transpose(1, 2)
        lib_ms = time_ms(lambda: torch.bmm(xt, g), 20, windows=WINDOWS)
        # the pair reduce reads the even half of W, the independent one all
        wsz = torch.finfo(wdt).bits // 8
        n_bytes = (S * M * (K + N) * isz + n_draws * K * N * wsz + K * N * 4 + S * 4
                   + len(out) * K * N * 4)
        b = bound(n_bytes, 2.0 * S * M * K * N, xdt)
        say(f"{name} ({label}) M={M} K={K} N={N}: {summary}, reruns equal; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.bmm x^T g "
            f"{lib_ms:.4f} ms, bound {b[0]:.4f} ms ({b[1]})")
        suffix = ("" if tag == "bf16" else f",{tag}") + (
            "" if prior == "on_mu" else f",{prior}")
        rows.append(row(
            f"{name}[M={M},K={K},N={N}{suffix}]", name, (M, K, N, tag + prior_suffix(prior)),
            path.format(est=est), "bayeformers_tpu_torch/csrc/fused_backward.cu",
            ("bayeformers_tpu/ops/fused_backward.py:202" if antithetic
             else "bayeformers_tpu/ops/fused_backward.py:97"),
            max((a - r).abs().max().item() for a, r in zip(out, ref)),
            ms, plain_ms, b, lib_ms))
    return rows


# A whole layer and its shards for the unit offsets' checks: (shard K, N,
# its offsets (k0, n0)) in a 1024 x 512 layer
OFFSET_LAYER = (1024, 512)
OFFSET_SHARDS = ((512, 256, 256, 0), (512, 256, 0, 128), (512, 256, 512, 256),
                 (300, 130, 512, 256))


def regen_bytes(S: int, K: int, N: int, pair: bool, lo: bool) -> int:
    """The bytes ``bft_regen`` must move: W of every member written once (and
    its bf16 copy), mu and rho read once, the seeds."""
    return (2 if pair else 1) * S * K * N * (4 + 2 * lo) + 2 * K * N * 4 + 4 * S


def offsets_ok(w, whole, k0, n0) -> bool:
    """Whether a shard's W at offsets (k0, n0) is the whole layer's W there,
    bit for bit."""
    K, N = w.shape[-2:]
    return torch.equal(w, whole[:, k0:k0 + K, n0:n0 + N])


def phase_offsets(fl) -> str:
    """The unit offsets (``unit_offsets``, the reference's off_ref) of every
    draw-kernel instance: shards of a 1024 x 512 layer at offsets (256, 0),
    (0, 128), (512, 256) (and a ragged 300 x 130 shard at (512, 256)).
    ``bft_regen`` (pair and independent, f32 W and with its bf16 copy) and
    the forward's draw pass through ``bayes_linear_with_w`` (pair and
    independent, x f32 and bf16, all three priors): W bit-equal to the
    slice of the whole layer's W (the whole layer's own W bit-equal to the
    plain stream), y within the y gate of ``x_shard @ W_slice``, and the
    log-probs within their gate (1e-5 relative) of the plain version at the
    same offsets. A planted fault, each launch again with the offsets
    zeroed, must fail the W check."""
    S, M = 10, 64
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(29)
    KL, NL = OFFSET_LAYER
    mu = torch.randn(KL, NL, device=dev, generator=gen) * 0.02
    rho = torch.rand(KL, NL, device=dev, generator=gen) - 5.0
    prior_mu = mu + torch.nn.functional.softplus(rho) * torch.randn(
        KL, NL, device=dev, generator=gen)
    seeds = torch.randint(0, 2**31 - 1, (S,), device=dev, generator=gen, dtype=torch.int32)
    n_checks = n_faults = 0
    for pair in (True, False):
        sd = seeds[:S // 2] if pair else seeds
        whole = fl.regenerate_weights(mu, rho, sd, antithetic=pair)
        check(torch.equal(whole, fl.sample_weights(mu, rho, sd, antithetic=pair)),
              f"regen ({'pair' if pair else 'independent'}) differs from the plain stream "
              f"at {OFFSET_LAYER}")
        for K, N, k0, n0 in OFFSET_SHARDS:
            rows, cols = slice(k0, k0 + K), slice(n0, n0 + N)
            mu_s, rho_s = mu[rows, cols].contiguous(), rho[rows, cols].contiguous()
            where = f"{'pair' if pair else 'independent'} {K}x{N} at ({k0}, {n0})"
            for lo in (None, BF16):
                out = fl.regenerate_weights_cuda(mu_s, rho_s, sd, antithetic=pair,
                                                 offsets=(k0, n0), lo_dtype=lo)
                w, w_lo = out if lo else (out, None)
                check(offsets_ok(w, whole, k0, n0), f"regen {where}: W is not the whole "
                      f"layer's slice")
                check(w_lo is None or offsets_ok(w_lo, whole.to(BF16), k0, n0),
                      f"regen {where}: the bf16 copy is not the whole layer's slice rounded")
                zeroed = fl.regenerate_weights_cuda(mu_s, rho_s, sd, antithetic=pair,
                                                    offsets=(0, 0), lo_dtype=lo)
                check(not offsets_ok(zeroed[0] if lo else zeroed, whole, k0, n0),
                      f"regen {where}: the planted fault (offsets zeroed) passed")
                n_checks, n_faults = n_checks + 1, n_faults + 1
            for dtype in (F32, BF16):
                x = torch.randn(S, M, K, device=dev, generator=gen).to(dtype)
                for prior in PRIORS:
                    kw = ({"prior_mu": prior_mu[rows, cols].contiguous()} if prior == "gaussian"
                          else {"mixture": MIXTURE} if prior == "mixture" else {})
                    y, lq, lp, w = fl.bayes_linear_with_w(x, mu_s, rho_s, sd, antithetic=pair,
                                                          unit_offsets=(k0, n0), **kw)
                    torch.cuda.synchronize()
                    label = f"bayes_linear ({TAG[dtype]}, {prior}) {where}"
                    check(offsets_ok(w, whole.to(dtype), k0, n0),
                          f"{label}: W is not the whole layer's slice")
                    yp = fl.bmm_plain(x, whole[:, rows, cols])
                    if dtype == F32:
                        err = (y - yp).abs().max().item()
                        check(err <= 2e-5 * yp.abs().max().item(), f"{label}: y off by {err}")
                    else:
                        check(torch.allclose(y.float(), yp.float(), rtol=2e-2, atol=2e-2),
                              f"{label}: y off by {max_dist(y, yp)}")
                    _, lqp, lpp = fl.bayes_linear_plain(x, mu_s, rho_s, sd, antithetic=pair,
                                                        unit_offsets=(k0, n0), **kw)
                    check(torch.allclose(lq, lqp, rtol=1e-5, atol=0.0)
                          and torch.allclose(lp, lpp, rtol=1e-5, atol=0.0),
                          f"{label}: log-probs {lq} {lp} vs plain {lqp} {lpp}")
                    n_checks += 1
                    if prior == "on_mu":
                        w0 = fl.bayes_linear_with_w(x, mu_s, rho_s, sd, antithetic=pair,
                                                    unit_offsets=(0, 0), **kw)[3]
                        check(not offsets_ok(w0, whole.to(dtype), k0, n0),
                              f"{label}: the planted fault (offsets zeroed) passed")
                        n_faults += 1
    return (f"{n_checks} shard checks bit-equal to the whole layer's W at offsets "
            f"{[s_[2:] for s_ in OFFSET_SHARDS]}, y and log-probs within their gates; "
            f"{n_faults} planted faults (offsets zeroed) failed the W check")


def regen_vjp_check(fl, moped_rho) -> str:
    """``BayesLinearRegen.backward`` on the card, one layer at 3072 -> 768,
    S = 10: antithetic f32 and bf16 x, independent bf16 x. One ``bft_regen``
    launch in its instance (the pair, the bf16 copy for bf16 x) and no
    ``aten.stack``, ``aten.cat`` or copy of an (S, K, N) tensor (a
    ``TorchDispatchMode``): no interleave and no cast of W in torch; dx
    bit-equal to the plain regenerating backward's (the same W in x's
    dtype, the same ``torch.bmm``)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    S, M, K, N = 10, 1024, 3072, 768
    copies = {torch.ops.aten.stack, torch.ops.aten.cat, torch.ops.aten._to_copy,
              torch.ops.aten.copy_, torch.ops.aten.clone}
    seen, bmms = [], []

    class Log(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.overloadpacket is torch.ops.aten.bmm:
                bmms.append(tuple(out.shape))
            elif func.overloadpacket in copies and isinstance(out, torch.Tensor) \
                    and out.dim() == 3 and tuple(out.shape[1:]) == (K, N):
                seen.append((str(func.overloadpacket), tuple(out.shape), out.dtype))
            return out

    said = []
    for pair, dtype in ((True, F32), (True, BF16), (False, BF16)):
        x, mu, rho, seeds, _ = bayes_linear_inputs(S, M, K, N, moped_rho,
                                                   S // 2 if pair else S, dtype=dtype)
        g = torch.randn(S, M, N, device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(3)).to(dtype)

        def dx(plain):
            xg, mug, rhog = (t.detach().clone().requires_grad_() for t in (x, mu, rho))
            y, _, _ = fl.bayes_linear(xg, mug, rhog, seeds, prior_on_mu=True,
                                      antithetic=pair, save_weights=False, plain=plain)
            with Log():
                y.backward(g)
            return xg.grad

        fl.REGEN_LAUNCHES.reset()
        seen.clear()
        bmms.clear()
        got = dx(False)
        want_key = (S // 2 if pair else S, K, N) + (
            ("/".join(("pair",) * pair + ("bf16",) * (dtype == BF16)),)
            if pair or dtype == BF16 else ())
        label = f"regenerating backward ({'pair' if pair else 'independent'}, {TAG[dtype]} x)"
        check(fl.REGEN_LAUNCHES.by_shape == {want_key: 1},
              f"{label}: regen launches {fl.REGEN_LAUNCHES.by_shape}, want {{{want_key}: 1}}")
        check(bmms == [(S, M, K)], f"{label}: torch.bmm {bmms} seen in the backward, want "
              "dx's alone")
        check(not seen, f"{label}: torch copied or stacked a W: {seen}")
        check(torch.equal(got, dx(True)), f"{label}: dx differs from the plain backward's")
        said.append(f"{label}: one launch {want_key}, no W stacked or cast in torch, dx "
                    "bit-equal to the plain backward's")
    return "; ".join(said)


def phase_regen(fl, moped_rho, sass, rate) -> list[dict]:
    """Kernel #10, its independent and pair instances, each with and
    without the bf16 copy, against the plain stream (pairs: interleaved by
    ``interleave_antithetic``) and against the W that each forward kernel
    draws for the same seeds, f32 and bf16, bit for bit, and a rerun; the
    unit offsets (:func:`phase_offsets`); the regenerating backward's one
    launch (:func:`regen_vjp_check`). Returns the timing rows at the f32
    recipe's shape (the FFN down-projection, five pairs or draws), each
    bound counting the MUFU instructions as :func:`regen_instructions`
    does, with the issue time of all its instructions beside it."""
    S, M = 10, 64
    for K, N in ((768, 768), (768, 3072), (3072, 768), (300, 130)):
        for pair in (True, False):
            n_draws = S // 2 if pair else S
            x, mu, rho, seeds, _ = bayes_linear_inputs(S, M, K, N, moped_rho, n_draws,
                                                       dtype=F32)
            w = fl.regenerate_weights(mu, rho, seeds, antithetic=pair)
            again = fl.regenerate_weights(mu, rho, seeds, antithetic=pair)
            w_lo = fl.regenerate_weights_cuda(mu, rho, seeds, antithetic=pair,
                                              lo_dtype=BF16)
            torch.cuda.synchronize()
            plain = fl.sample_weights(mu, rho, seeds)
            if pair:
                plain = fl.interleave_antithetic(plain, mu)
            where = f"{'pair' if pair else 'independent'} {(n_draws, K, N)}"
            check(torch.equal(w, again), f"regen reruns differ at {where}")
            check(torch.equal(w, plain), f"regen differs from the plain stream at "
                  f"{where}: max {(w - plain).abs().max().item()}")
            check(torch.equal(w_lo[0], plain) and torch.equal(w_lo[1], plain.to(BF16)),
                  f"regen with its bf16 copy differs from the plain stream at {where}")
            for dtype in (F32, BF16):
                w_fwd = fl.bayes_linear_with_w(x.to(dtype), mu, rho, seeds,
                                               antithetic=pair)[3]
                got = w if dtype == F32 else w_lo[1]
                check(torch.equal(got, w_fwd), f"regen differs from the {TAG[dtype]} forward "
                      f"kernel's W at {where}: max {max_dist(got, w_fwd)}")
    say("regen: W, pairs and independent draws, with and without the bf16 copy, bit-equal "
        "to the plain stream and to both forward kernels' f32 and bf16 W at (S', K, N) = "
        "(5|10, 768, 768), (5|10, 768, 3072), (5|10, 3072, 768), (5|10, 300, 130); reruns "
        "equal")
    say(f"regen offsets: {phase_offsets(fl)}")
    say(regen_vjp_check(fl, moped_rho))
    n, K, N = 5, 3072, 768
    _, mu, rho, seeds, _ = bayes_linear_inputs(S, 8, K, N, moped_rho, n, dtype=F32)
    _, _, _, seeds10, _ = bayes_linear_inputs(S, 8, K, N, moped_rho, 10, dtype=F32)
    rows = []
    # (name, draws, pair, bf16 copy, path and counter shape of its launches)
    for name, sd, pair, lo, path in (
            ("regen_pair", seeds, True, False, "train/anti/f32"),
            ("regen_pair", seeds, True, True, "regen/anti/bf16"),
            ("regen", seeds, False, False, None),
            ("regen", seeds10, False, True, "regen/indep/bf16")):
        S_ = sd.shape[0]
        ms = time_ms(lambda: fl.regenerate_weights_cuda(
            mu, rho, sd, antithetic=pair, lo_dtype=BF16 if lo else None), 50, windows=WINDOWS)
        plain_ms = time_ms(lambda: fl.sample_weights(mu, rho, sd, antithetic=pair), 5, 1)
        n_mufu, n_all = regen_instructions(sass, pair, lo, [(K, N)], S_)
        b = bound_mufu(regen_bytes(S_, K, N, pair, lo), n_mufu, rate)
        tag = "/".join(("pair",) * pair + ("bf16",) * lo)
        say(f"{name} S'={S_} K={K} N={N}{', bf16 copy' if lo else ''}: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {b[0]:.4f} ms ({b[1]}; MUFU {n_mufu:.4g}, "
            f"{n_mufu / rate * 1e3:.4f} ms; issue, {n_all:.4g} instructions, "
            f"{issue_ms(n_all, rate):.4f} ms), no library call")
        rows.append(row(f"{name}[S={S_},K={K},N={N}{',bf16' if lo else ''}]", "regen",
                        (S_, K, N) + ((tag,) if tag else ()), path,
                        "bayeformers_tpu_torch/csrc/regen.cu",
                        "bayeformers_tpu/ops/fused_linear.py:1143", 0.0, ms, plain_ms, b,
                        None))
    return rows


def mha_bwd_inputs(at, N, L, H, seed, dtype=BF16):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, g = (torch.randn(N, L, H, device=dev, generator=gen).to(dtype)
                  for _ in range(4))
    mask = torch.ones(N, L, device=dev)
    mask[: N // 2, L - L // 3:] = 0  # padded keys in half the rows
    mask[N - 1] = 0                  # one fully masked row
    return q, k, v, at.mask_to_bias(mask), g


def phase_mha_bwd(at, dtype=BF16, shapes=((80, 128, 768), (8, 512, 768)), nh=12,
                  path=None) -> dict:
    """Kernel #5's instance for ``dtype`` against its plain version at
    ``shapes`` (N, L, H) of ``nh`` heads; returns the timing row of the
    training shape (L = 128), whose launches come from the run of ``path``
    (default: the antithetic steps)."""
    tag, isz = TAG[dtype], torch.finfo(dtype).bits // 8
    out_row = None
    for N, L, H in shapes:
        q, k, v, bias, g = mha_bwd_inputs(at, N, L, H, L, dtype)
        out = at.mha_bwd_cuda(q, k, v, bias, g, nh)
        again = at.mha_bwd_cuda(q, k, v, bias, g, nh)
        torch.cuda.synchronize()
        ref = at.mha_bwd_plain(q, k, v, bias, g, nh)
        errs = [(a.float() - r.float()).abs().max().item() for a, r in zip(out, ref)]
        # bf16 outputs: 2e-2 absolute as the forward, plus 2e-2 relative
        # where gradients reach |x| ~ 10 and one bf16 step is 0.06; f32
        # outputs of true f32 products: 1e-4 absolute plus 1e-4 relative
        tol = 1e-4 if dtype == F32 else 2e-2
        for name, a, r in zip(("dq", "dk", "dv"), out, ref):
            check(bool(torch.isfinite(a.float()).all()), f"mha_bwd {name} not finite")
            check(torch.allclose(a.float(), r.float(), rtol=tol, atol=tol),
                  f"mha_bwd ({tag}) {name} differs at {(N, L, H)}: max {errs}")
        check(all(torch.equal(a, b) for a, b in zip(out, again)),
              f"mha_bwd ({tag}) reruns differ at {(N, L, H)}")
        summary = "dq/dk/dv max|d| " + "/".join(f"{e:.3g}" for e in errs)
        if L != 128:
            say(f"mha_bwd ({tag}) N={N} L={L} H={H}: {summary}, reruns equal")
            continue
        ms = time_ms(lambda: at.mha_bwd_cuda(q, k, v, bias, g, nh), 20, windows=WINDOWS)
        plain_ms = time_ms(lambda: at.mha_bwd_plain(q, k, v, bias, g, nh), 3, 1)
        d = H // nh
        heads = [t.view(N, L, nh, d).transpose(1, 2).detach().requires_grad_()
                 for t in (q, k, v)]
        sdpa_mask = bias.clamp_min(torch.finfo(dtype).min).to(dtype)
        o = torch.nn.functional.scaled_dot_product_attention(
            *heads, attn_mask=sdpa_mask[:, None, None, :])
        go = g.view(N, L, nh, d).transpose(1, 2)
        lib_ms = time_ms(lambda: torch.autograd.grad(o, heads, go, retain_graph=True), 20,
                         windows=WINDOWS)
        b = bound(7 * N * L * H * isz + N * L * 4, 10.0 * N * L * L * H, dtype)
        say(f"mha_bwd ({tag}) N={N} L={L} H={H}: {summary}, reruns equal; kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa backward {lib_ms:.4f} ms, "
            f"bound {b[0]:.4f} ms ({b[1]})")
        suffix = "" if dtype == BF16 else f",{tag}"
        out_row = row(f"mha_bwd[N={N},L={L},H={H}{suffix}]", "mha_bwd", (N, L, H, tag, False),
                      path or f"train/anti/{tag}", "bayeformers_tpu_torch/csrc/mha_bwd.cu",
                      "bayeformers_tpu/ops/attention.py:181", max(errs), ms, plain_ms,
                      b, lib_ms)
    return out_row


def train_batch(bt, B=8, L=128, seed=7, family=BERT, vocab=None):
    if family:  # the causal-LM workload's synthetic language
        from bayeformers_tpu_torch.models.gpt2 import synthetic_lm_batch

        ids = synthetic_lm_batch(np.random.default_rng(seed), B, L,
                                 vocab or LM_VOCAB[family])["input_ids"]
        return {"input_ids": torch.from_numpy(ids).cuda()}
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, bt.BERT_BASE_KWARGS["vocab_size"], (B, L))
    mask = np.ones((B, L), np.int64)
    mask[B // 2:, L - 30:] = 0
    return {k: torch.from_numpy(v).cuda() for k, v in (
        ("input_ids", ids), ("attention_mask", mask),
        ("token_type_ids", np.zeros((B, L), np.int64)),
        ("labels", rng.integers(0, 2, (B,))))}


def loss_keywords(family) -> dict:
    """The ELBO objective's loss and inputs for a family: BERT's
    classification loss on its three inputs, the causal LMs' LM loss on
    their ids."""
    if family:
        from bayeformers_tpu_torch.workloads.gpt2_lm import lm_loss

        return {"loss_fn": lm_loss, "input_keys": ("input_ids",)}
    return {}


def grads_of(bt, bmodel, named, seed, batch, impl, estimator, save_weights=True,
             family=BERT):
    """Loss and gradients of one ELBO objective (S=10) at the given draw;
    ``save_weights=False`` differentiates through the regenerating VJP."""
    for _, t, _ in named:
        t.grad = None
    loss, m = bt.training.elbo_objective(
        bt.training.pick_mc(bmodel, True, estimator, save_weights), seed, 10, batch, 256,
        impl=impl, **loss_keywords(family))
    loss.backward()
    return loss.detach(), m, {n: t.grad.clone() for n, t, _ in named}


@contextlib.contextmanager
def broken_reduce(fb, fault: str):
    """While the block runs, every reduce kernel's U (``"U"``) or V
    (``"V"``) output is zeroed: a broken kernel that a gate must fail."""
    orig = fb.reduce_abuv_anti, fb.reduce_abuv

    def broken(fn):
        def run(*args, **kw):
            acc = list(fn(*args, **kw))
            i = 2 if fault == "U" else len(acc) - 1
            acc[i] = torch.zeros_like(acc[i])
            return tuple(acc)
        return run

    fb.reduce_abuv_anti, fb.reduce_abuv = map(broken, orig)
    try:
        yield
    finally:
        fb.reduce_abuv_anti, fb.reduce_abuv = orig


def prior_grads(bt, bmodel, named, batch, impl, estimator, save_weights=True) -> dict:
    """The gradients of the ELBO's prior part alone, mean log_q - mean
    log_p, at :func:`grads_of`'s draw (seed 123)."""
    for _, t, _ in named:
        t.grad = None
    _, m = bt.training.elbo_objective(
        bt.training.pick_mc(bmodel, True, estimator, save_weights), 123, 10, batch, 256,
        impl=impl)
    (m["log_variational_posterior"] - m["log_prior"]).backward()
    return {n: t.grad.clone() for n, t, _ in named if t.grad is not None}


PRIOR_GRADS_GATE = 1e-3


def check_prior_grads(bt, fb, bmodel, named, batch, estimator, label, mu_names,
                      save_weights=True, faults=False) -> None:
    """The prior part's gradients of mu and rho through the kernels against
    the plain step's, each leaf within 1e-3 relative L2. Without the task
    loss every reduce sees g_y = 0, so A and B vanish and what is compared
    is U, V and finalize on the same W: sums of the same operands in
    another order, free of the rounding that bf16 activations spread
    through a random-init network (which blurs the whole step's rho
    gradients by 0.15 relative L2). With ``faults``, the same check of a
    run with every reduce's U, and one with its V, zeroed must fail."""
    gk = prior_grads(bt, bmodel, named, batch, "kernel", estimator, save_weights)
    gp = prior_grads(bt, bmodel, named, batch, "plain", estimator, save_weights)
    rho = [n for n in gp if n.startswith("rho/")]
    mu = [n for n in mu_names if n in gp]
    for group, names in (("mu", mu), ("rho", rho)):
        rel, cos, at_ = worst_agreement(gk, gp, names)
        say(f"{label}: prior-part {group} gradients ({len(names)} leaves), kernels vs "
            f"plain: worst rel L2 {rel:.4g} ({at_}), worst cosine {cos:.9f}")
        check(rel <= PRIOR_GRADS_GATE, f"{label}: the prior part's {group} gradients "
              f"through the kernels differ from the plain step's: rel L2 {rel} at {at_}")
    if not faults:
        return
    for fault, group, names in (("U", "mu", mu), ("V", "rho", rho)):
        with broken_reduce(fb, fault):
            gf = prior_grads(bt, bmodel, named, batch, "kernel", estimator, save_weights)
        rel, _, at_ = worst_agreement(gf, gp, names)
        say(f"{label}: with every reduce's {fault} zeroed, prior-part {group} gradients "
            f"worst rel L2 {rel:.4g} ({at_}), gate {PRIOR_GRADS_GATE}")
        check(rel > PRIOR_GRADS_GATE, f"{label}: the prior-part check passed a reduce "
              f"with {fault} zeroed")


def worst_agreement(a: dict, b: dict, names) -> tuple[float, float, str]:
    """(largest relative L2 error, smallest cosine, the leaf of the first)
    of gradients ``a`` against ``b`` over ``names``."""
    worst = (0.0, 1.0, "")
    for n in names:
        x, y = a[n].double().flatten(), b[n].double().flatten()
        rel = ((x - y).norm() / y.norm().clamp_min(1e-300)).item()
        cos = (x @ y / (x.norm() * y.norm()).clamp_min(1e-300)).item()
        worst = (max(worst[0], rel), min(worst[1], cos), n if rel > worst[0] else worst[2])
    return worst


def param_groups(names) -> dict[str, list[str]]:
    """The trainable unconverted parameters by group: the norms' scales and
    biases (BERT's LayerNorm, GPT-2's ln_1, ln_2 and ln_f, DistilBERT's
    sa_layer_norm and output_layer_norm, ALBERT's full_layer_layer_norm), the LLaMA
    families' RMSNorm weights, and the embeddings (GPT-2's wte is its tied
    head too); the groups a model has."""
    params = [n for n in names if n.startswith("params/")]
    norm = [n for n in params if "LayerNorm/" in n or "/ln_" in n or "layer_norm/" in n]
    groups = {"LayerNorm/scale": [n for n in norm if n.endswith("/scale")],
              "LayerNorm/bias": [n for n in norm if n.endswith("/bias")],
              "RMSNorm/weight": [n for n in params if n.endswith("norm/weight")],
              "embedding": [n for n in params if n.endswith("embedding")]}
    return {k: v for k, v in groups.items() if v}


def grad_groups(names) -> dict[str, list[str]]:
    """The trainable leaves by group: rho, LayerNorm scales and biases,
    embeddings, and any other parameter."""
    groups = {"rho": [n for n in names if n.startswith("rho/")]}
    groups.update(param_groups(names))
    seen = {n for v in groups.values() for n in v}
    rest = [n for n in names if n not in seen]
    if rest:
        groups["other"] = rest
    return groups


def check_bf16_step(label, loss_k, loss_p, mk, mp, gk, gp, g32, mu_names=(),
                    rho_by_f32=False) -> None:
    """A bf16 step through the kernels against the plain bf16 step at the
    same draw: loss 1e-2 relative, rho gradients 5e-2 relative L2 and cosine
    0.999; LayerNorm and embedding gradients, which bf16 activations blur
    on both paths, no further from the f32 plain step ``g32`` than 1.5x the
    plain bf16 step's distance; and so the trained mu's (``mu_names``,
    under the priors not centred on a frozen mu), whose task part bf16
    blurs as well. ``rho_by_f32``: rho is judged that way too (random init,
    where rho's task part is as large as its KL part and bf16 blurs it by
    ~0.15 relative L2 on both paths)."""
    for key in ("loss", "log_prior", "log_variational_posterior", "nll"):
        check(bool(torch.isfinite(mk[key])), f"{key} is not finite: {mk[key]}")
    loss_rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    check(loss_rel <= 1e-2, f"{label} loss kernels {loss_k.item()} vs plain {loss_p.item()}")
    say(f"{label}: loss kernels {loss_k.item():.9g} vs plain {loss_p.item():.9g} (rel "
        f"{loss_rel:.3g}), nll {mk['nll'].item():.7g} vs {mp['nll'].item():.7g}; "
        "reruns bit-equal")
    rho = [n for n in gk if n.startswith("rho/")]
    rel, cos, at_ = worst_agreement(gk, gp, rho)
    say(f"{label}: rho gradients ({len(rho)} leaves), kernels vs plain: worst rel L2 "
        f"{rel:.4g} ({at_}), worst cosine {cos:.7f}")
    if not rho_by_f32:
        check(rel <= 5e-2 and cos >= 0.999, f"{label} rho gradients through the kernels "
              f"differ from the plain step: rel L2 {rel}, cosine {cos}")
    groups = param_groups(list(gk))
    if mu_names:
        groups["mu"] = list(mu_names)
    if rho_by_f32:
        groups["rho"] = rho
    for group, names in groups.items():
        rk, ck, nk = worst_agreement(gk, g32, names)
        rp, cp, _ = worst_agreement(gp, g32, names)
        rkp, ckp, _ = worst_agreement(gk, gp, names)
        say(f"{label}: {group} gradients ({len(names)} leaves) against the f32 plain "
            f"step: kernels rel L2 {rk:.4g} ({nk}) cosine {ck:.6f}; bf16 plain "
            f"rel L2 {rp:.4g} cosine {cp:.6f}; kernels vs bf16 plain rel L2 "
            f"{rkp:.4g} cosine {ckp:.6f}")
        check(rk <= 1.5 * rp and 1.0 - ck <= 1.5 * (1.0 - cp),
              f"{label} {group} gradients through the kernels are further from the "
              "f32 step than the bf16 plain step's")


def phase_train(bt, fl, at, fb, estimator, dtype=BF16, prior="on_mu", family=BERT
                ) -> tuple[dict, float, dict]:
    """The ELBO step at the recipe in ``dtype`` activations, under the
    conversion of ``prior``, on BERT-base or (``family=GPT2``) GPT-2 base
    with the LM loss: returns the launch counts by kernel and shape over
    the timed steps, the median step time (ms) and, in bf16 on BERT, the
    launch counts of one step through the regenerating backward
    (``save_weights=False``)."""
    from bayeformers_tpu_torch.nn.surgery import leaf

    S, n_batches = 10, 256
    anti = estimator == "antithetic"
    tag = TAG[dtype]
    sfx = prior_suffix(prior)
    label = (f"train{' ' + LM_NAME[family] if family else ''} ({estimator}, {tag}"
             + ("" if prior == "on_mu" else f", {prior}") + ")")
    batch = train_batch(bt, family=family)
    regen_counts = {}
    if dtype == BF16:
        # the same step in f32 activations through the plain versions: the
        # yardstick for gradients that bf16 activations blur on either path
        bmodel32, named32 = converted_base(bt, F32, prior, family)
        _, _, g32 = grads_of(bt, bmodel32, named32, 123, batch, "plain", estimator,
                             family=family)
        del bmodel32, named32
        torch.cuda.empty_cache()

    bmodel, named = converted_base(bt, dtype, prior, family)
    mu_names = ([] if prior == "on_mu" else
                [f"params/{p}" for p in bmodel.spec.paths])
    # the step through the kernels against the plain step, same draw; #10
    # runs in the f32 antithetic step's 12 FFN down-projections only
    reset_counters(fl)
    loss_k, mk, gk = grads_of(bt, bmodel, named, 123, batch, "kernel", estimator,
                              family=family)
    n_regen = dict(fl.REGEN_LAUNCHES.by_shape)
    # (the LLaMA families' widest K, 2048, pads to no more than 2048: none)
    want = ({(S // 2, 3072, 768, "pair"): 12}
            if anti and dtype == F32 and family in (BERT, GPT2) else {})
    check(n_regen == want, f"{label}: regen launched {n_regen}, want {want}")
    loss_k2, _, gk2 = grads_of(bt, bmodel, named, 123, batch, "kernel", estimator,
                               family=family)
    loss_p, mp, gp = grads_of(bt, bmodel, named, 123, batch, "plain", estimator,
                              family=family)
    check(torch.equal(loss_k, loss_k2) and all(torch.equal(gk[n], gk2[n]) for n in gk),
          f"{label}: the same seed gave another loss or gradient through the kernels")
    if dtype == BF16:
        check_bf16_step(label, loss_k, loss_p, mk, mp, gk, gp, g32, mu_names,
                        prior == "mixture")
        if prior != "on_mu":
            check_prior_grads(bt, fb, bmodel, named, batch, estimator, label, mu_names,
                              faults=prior == "mixture")
        if prior == "mixture":
            # the whole step's rho gate (1.5x the bf16 plain step's distance
            # from the f32 one) against the same fault: a reading
            with broken_reduce(fb, "V"):
                _, _, gv = grads_of(bt, bmodel, named, 123, batch, "kernel", estimator)
            rho = [n for n in gk if n.startswith("rho/")]
            say(f"{label}: with every reduce's V zeroed, the whole step's rho gradients "
                f"are rel L2 {worst_agreement(gv, g32, rho)[0]:.4g} from the f32 plain "
                "step's (gate: 1.5x the bf16 plain step's "
                f"{worst_agreement(gp, g32, rho)[0]:.4g})")
            del gv
    if dtype == BF16 and family == BERT:
        # the regenerating backward (save_weights=False): #10 on every layer,
        # the reduce on the regenerated f32 W; counts read around this step
        rlabel = label[:-1] + ", save_weights=False)"
        reset_counters(fl, at, fb)
        loss_r, mr, gr = grads_of(bt, bmodel, named, 123, batch, "kernel", estimator,
                                  save_weights=False)
        red = fb.LAUNCHES if anti else fb.INDEP_LAUNCHES
        regen_counts = {"regen": dict(fl.REGEN_LAUNCHES.by_shape),
                        red.name: dict(red.by_shape)}
        check(fl.REGEN_LAUNCHES.count == BERT_BASE_LAYERS,
              f"{rlabel}: regen launched {fl.REGEN_LAUNCHES.count} times, want {BERT_BASE_LAYERS}")
        # one launch a layer writes what the backward reads: the pairs (for
        # antithetic draws) and their bf16 copy for dx
        inst = "pair/bf16" if anti else "bf16"
        check(all(k[3:] == (inst,) for k in fl.REGEN_LAUNCHES.by_shape),
              f"{rlabel}: regen launched {fl.REGEN_LAUNCHES.by_shape}, want the {inst} "
              "instance alone")
        check(sum(n for s_, n in red.by_shape.items() if s_[3] == "bf16x-f32w" + sfx)
              == BERT_BASE_LAYERS,
              f"{rlabel}: the (bf16 x, f32 W) reduce did not serve every layer: "
              f"{red.by_shape}")
        loss_r2, _, gr2 = grads_of(bt, bmodel, named, 123, batch, "kernel", estimator,
                                   save_weights=False)
        loss_rp, mrp, grp = grads_of(bt, bmodel, named, 123, batch, "plain", estimator,
                                     save_weights=False)
        check(torch.equal(loss_r, loss_r2) and all(torch.equal(gr[n], gr2[n]) for n in gr),
              f"{rlabel}: the same seed gave another loss or gradient")
        check_bf16_step(rlabel, loss_r, loss_rp, mr, mrp, gr, grp, g32, mu_names,
                        prior == "mixture")
        if prior != "on_mu":
            check_prior_grads(bt, fb, bmodel, named, batch, estimator, rlabel, mu_names,
                              save_weights=False)
        say(f"{rlabel}: launches in one step: {regen_counts}")
        del gr, gr2, grp
    if dtype == BF16:
        del g32
    else:
        loss_rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
        say(f"{label}: loss kernels {loss_k.item():.9g} vs plain {loss_p.item():.9g} "
            f"(rel {loss_rel:.3g}); reruns bit-equal; regen launches {n_regen}")
        check(loss_rel <= 1e-6, f"{label}: loss kernels {loss_k.item()} vs plain "
              f"{loss_p.item()}")
        for group, names in grad_groups(list(gk)).items():
            rel, cos, at_ = worst_agreement(gk, gp, names)
            say(f"{label}: {group} gradients ({len(names)} leaves), kernels vs plain "
                f"f32: worst rel L2 {rel:.4g} ({at_}), worst cosine {cos:.9f}")
            check(rel <= 1e-3, f"{label}: {group} gradients differ from the plain f32 "
                  f"step: rel L2 {rel} at {at_}")
        if prior != "on_mu":
            check_prior_grads(bt, fb, bmodel, named, batch, estimator, label, mu_names)
    del gk, gk2, gp

    # the ELBO falls on one batch and one draw
    tx = bt.training.adamw_with_decay_groups(
        bt.training.linear_schedule(2e-5, 0.0, 100), 0.0,
        bt.training.default_no_decay, eps=1e-8, clip_norm=1.0)
    opt = tx.init(named)
    step = bt.training.make_elbo_train_step(bmodel, opt, S, n_batches,
                                            estimator=estimator, **loss_keywords(family))
    # after one step a trained mu has moved, a frozen one has not, and
    # prior_mu (MOPED with a trainable mu) is bit-identical
    mu0 = {p: leaf(bmodel.model, p).detach().clone() for p in bmodel.spec.paths}
    pmu0 = ({p: t.clone() for p, t in bmodel.prior_mu.items()}
            if prior == "gaussian" else {})
    losses = [step(55, batch)["loss"].item()]
    moved = sum(not torch.equal(leaf(bmodel.model, p), mu0[p]) for p in mu0)
    check(moved == (0 if prior == "on_mu" else len(mu0)),
          f"{label}: {moved} of {len(mu0)} mu leaves moved in one step")
    check(all(torch.equal(t, pmu0[p]) for p, t in bmodel.prior_mu.items() if p in pmu0)
          and len(pmu0) == (len(mu0) if prior == "gaussian" else 0),
          f"{label}: prior_mu changed in a step")
    say(f"{label}: after one step {moved} of {len(mu0)} mu leaves moved"
        + (f", prior_mu bit-identical ({len(pmu0)} leaves)" if pmu0 else ""))
    del mu0, pmu0
    losses += [step(55, batch)["loss"].item() for _ in range(3)]
    say(f"{label}: loss over 4 steps at one batch and draw: {losses}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], "the ELBO did not fall")

    # timed steps, fresh draws; launches and peak memory read around exactly these
    torch.cuda.synchronize()
    reset_counters(fl, at, fb)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(TIMED):
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = step(1000 + i, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        check(bool(torch.isfinite(m["loss"])), f"step {i} loss {m['loss']}")
    fwd, red = ((fl.LAUNCHES, fb.LAUNCHES) if anti
                else (fl.INDEP_LAUNCHES, fb.INDEP_LAUNCHES))
    check(all(k[3].endswith(sfx) if sfx else "/" not in k[3]
              for c in (fwd, red) for k in c.by_shape),
          f"{label}: a launch of another prior's instance: {fwd.by_shape} {red.by_shape}")
    launches = {fwd.name: dict(fwd.by_shape),
                "mha_fwd": dict(at.LAUNCHES.by_shape),
                "mha_bwd": dict(at.BWD_LAUNCHES.by_shape),
                red.name: dict(red.by_shape)}
    check(all(sum(v.values()) > 0 for v in launches.values()),
          f"the train steps launched no kernel of some kind: {launches}")
    launches["regen"] = dict(fl.REGEN_LAUNCHES.by_shape)
    check(fl.REGEN_LAUNCHES.count == TIMED * sum(want.values()),
          f"{label}: regen launched {fl.REGEN_LAUNCHES.count} times in {TIMED} steps")
    if family:
        # a step: each converted shape's reduce once a layer, the causal
        # attention backward once a layer
        per_step = {(1024, k, n, tag): c for (k, n), c in LM_LAYERS[family].items()}
        got = {k: v / TIMED for k, v in red.by_shape.items()}
        check(got == per_step, f"{label}: reduce launches a step {got}, want {per_step}")
        check(at.BWD_LAUNCHES.by_shape == {(80, 128, 768, tag, True): 12 * TIMED},
              f"{label}: mha_bwd launches {at.BWD_LAUNCHES.by_shape} in {TIMED} steps, "
              "want 12 causal a step")
    step_ms = float(np.median(times))
    say(f"{label}: launches over {TIMED} steps: {launches}")
    say(f"{label}: ELBO step (S=10, B=8, L=128, {tag}) median {step_ms:.3f} ms over {TIMED}: "
        f"{[round(v, 3) for v in times]}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del opt, step, named, bmodel
    torch.cuda.empty_cache()
    return launches, step_ms, regen_counts


def phase_workload(fl, fb, samples, bf16=True) -> float:
    """bert_glue phases A-D at ``samples`` draws; an odd S must run the
    independent-draw kernels and no antithetic one; at the f32 default and
    S=10 the FFN down-projections' backward must launch #10."""
    from bayeformers_tpu_torch.workloads import bert_glue

    reset_counters(fl, fb)
    with tempfile.TemporaryDirectory() as logs:
        score = bert_glue.train(size="base", limit_batches=3, epochs=1, b_epochs=1,
                                bf16=bf16, logs=logs, samples=samples)
    check(np.isfinite(score), f"bert_glue score {score}")
    counts = {c.name: c.count for c in (fl.LAUNCHES, fl.INDEP_LAUNCHES,
                                         fb.LAUNCHES, fb.INDEP_LAUNCHES)}
    odd = samples % 2 == 1
    check(all((counts[n] > 0) == (("anti" in n) != odd) for n in counts),
          f"bert_glue at S={samples} took the wrong estimator's kernels: {counts}")
    counts["regen"] = fl.REGEN_LAUNCHES.count
    check((counts["regen"] > 0) == (not bf16 and not odd),
          f"bert_glue at S={samples}, {'bf16' if bf16 else 'f32'}: regen launched "
          f"{counts['regen']} times")
    say(f"workload: bert_glue phases A-D at S={samples}, {'bf16' if bf16 else 'f32'}, "
        f"3 batches an epoch: score {score:.4f}; launches {counts}")
    return score


# ---------------------------------------------------------------------------
# Phase 14: the estimators (flipout, local reparameterization, naive) and
# the split ops' kernels (#11 logprob, #12 sampled_dense, #13 regen)
# ---------------------------------------------------------------------------

KL_DRAWS = 4  # nn/flipout.py::KL_DRAWS: the mixture KL's draws per leaf


def sampled_dense_inputs(S, M, K, N, moped_rho, dtype, zero_mu):
    """Seeded x (S, M, K), f32 mu (0 for flipout's perturbation, else MOPED
    weights) and rho, and S seeds, on the card."""
    x, mu, rho, seeds, _ = bayes_linear_inputs(S, M, K, N, moped_rho, S, dtype=dtype)
    return x, torch.zeros_like(mu) if zero_mu else mu, rho, seeds


# #12's gates. bf16, per element: 1e-2 of |ref| + std(ref), since y is rounded
# to bf16 (one ulp is at most 2^-7 of |y|) and flipout's mu = 0 outputs are a
# few 1e-2, so no fixed absolute tolerance fits them; f32 (3xTF32): 2e-5 of
# max |ref|.
Y_GATE = {BF16: "1e-2 of |y| + std(y) per element", F32: "2e-5 of max |y|"}


def y_gate_ratio(y, ref, dtype) -> float:
    """The largest ``|y - ref|`` over #12's gate (:data:`Y_GATE`); at most 1
    passes."""
    r = ref.float()
    d = (y.float() - r).abs()
    if dtype == F32:
        return d.max().item() / (2e-5 * r.abs().max().item())
    return (d / (1e-2 * (r.abs() + r.std()))).max().item()


def sampled_dense_faults(sl, x, mu, rho, seeds, ref, dtype, shape) -> str:
    """Two planted faults of #12 that its gate must fail, made by launching
    the kernel on altered inputs: sigma scaled by 0.9 (rho' =
    softplus^-1(0.9 softplus(rho))) and one K step (the kernel's BK = 32 rows
    of K) dropped (x's first 32 columns zeroed). Returns each fault's reading
    beside what the former absolute bf16 gate (allclose at rtol = atol =
    2e-2, which mu = 0's |y| of a few 1e-2 cannot resolve) said of it."""
    from bayeformers_tpu_torch.core.distributions import sigma_from_rho

    rho_f = torch.log(torch.expm1(0.9 * sigma_from_rho(rho)))
    x_f = x.clone()
    x_f[..., :32] = 0
    out = []
    for what, y_f in (("sigma x 0.9", sl.sampled_dense(x, mu, rho_f, seeds)),
                      ("one K step dropped", sl.sampled_dense(x_f, mu, rho, seeds))):
        ratio = y_gate_ratio(y_f, ref, dtype)
        check(ratio > 1.0, f"sampled_dense ({TAG[dtype]}) gate passes a planted fault "
              f"({what}) at {shape}: {ratio:.3g}x the gate")
        old = torch.allclose(y_f.float(), ref.float(), rtol=2e-2, atol=2e-2)
        out.append(f"{what} {ratio:.3g}x the gate (failed; the absolute gate "
                   f"{'passed' if old else 'failed'} it)")
    return "; ".join(out)


def phase_sampled_dense(sl, fl, moped_rho, dtype, shapes=SERVING_SHAPES,
                        path="serve/flipout") -> list[dict]:
    """Kernel #12 (the no-prior draw pass and ``bft_bmm``) at flipout's
    shapes (S=10, the serving and training shapes of every converted
    layer), mu = 0 (flipout's
    perturbation) and mu != 0: against its plain version at the gates of
    :data:`Y_GATE` (bf16 1e-2 of |y| + std(y), f32 2e-5 of max |y|), against ``x @
    regenerate_weights`` (the same draw, #13's W, by ``torch.bmm``) at the
    same gates, and a bit-equal rerun; at mu = 0 and M = 1024 the gate must
    fail two planted faults (:func:`sampled_dense_faults`). Returns the
    timing rows (mu = 0), each of the launches of ``path``/dtype, at the
    (M, K, N) of ``shapes``."""
    S, tag, isz = 10, TAG[dtype], torch.finfo(dtype).bits // 8
    rows = []
    for M, K, N in shapes:
        for zero_mu in (True, False):
            x, mu, rho, seeds = sampled_dense_inputs(S, M, K, N, moped_rho, dtype, zero_mu)
            y = sl.sampled_dense(x, mu, rho, seeds)
            again = sl.sampled_dense(x, mu, rho, seeds)
            w = sl.regenerate_weights(mu, rho, seeds)
            torch.cuda.synchronize()
            check(torch.equal(y, again), f"sampled_dense ({tag}) reruns differ at {(M, K, N)}")
            yp = sl.naive_sampled_dense(x, mu, rho, seeds)
            yw = torch.bmm(x, w.to(dtype))
            errs, ratios = [], []
            for what, ref in (("plain version", yp), ("x @ regenerate_weights", yw)):
                ratio = y_gate_ratio(y, ref, dtype)
                check(ratio <= 1.0, f"sampled_dense ({tag}) y differs from its {what} at "
                      f"{(M, K, N)}: {ratio:.3g}x the gate ({Y_GATE[dtype]})")
                errs.append(max_dist(y, ref))
                ratios.append(ratio)
            y_max, y_std = yp.float().abs().max().item(), yp.float().std().item()
            mu_tag = "mu = 0" if zero_mu else "mu != 0"
            summary = (f"max|y| {y_max:.4g} (std {y_std:.3g}), y max|d| {errs[0]:.3g} from "
                       f"the plain version "
                       f"({ratios[0]:.3g}x the gate), {errs[1]:.3g} from x @ "
                       f"regenerate_weights ({ratios[1]:.3g}x), reruns equal")
            if zero_mu and M == 1024:
                summary += "; planted faults: " + sampled_dense_faults(
                    sl, x, mu, rho, seeds, yp, dtype, (M, K, N))
            if not zero_mu:
                say(f"sampled_dense ({tag}, {mu_tag}) M={M} K={K} N={N}: {summary}")
                continue
            ms = time_ms(lambda: sl.sampled_dense(x, mu, rho, seeds), 20, windows=WINDOWS)
            plain_ms = time_ms(lambda: sl.naive_sampled_dense(x, mu, rho, seeds), 3, 1)
            wd = w.to(dtype)
            lib_ms = time_ms(lambda: torch.bmm(x, wd), 20, windows=WINDOWS)
            n_bytes = S * M * K * isz + 2 * K * N * 4 + S * M * N * isz + S * 4
            b = bound(n_bytes, 2.0 * S * M * K * N, dtype)
            say(f"sampled_dense ({tag}, {mu_tag}) M={M} K={K} N={N}: {summary}; kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, torch.bmm on W {lib_ms:.4f} ms, "
                f"bound {b[0]:.4f} ms ({b[1]})")
            suffix = "" if dtype == BF16 else f",{tag}"
            rows.append(row(f"sampled_dense[M={M},K={K},N={N}{suffix}]", "sampled_dense",
                            (M, K, N, tag), f"{path}/{tag}",
                            "bayeformers_tpu_torch/csrc/bayes_linear.cu",
                            "bayeformers_tpu/ops/sampled_linear.py:117", errs[0], ms,
                            plain_ms, b, lib_ms))
    return rows


REGEN_SHAPES = ((768, 768), (768, 3072), (3072, 768), (768, 2))
# BERT-base's converted kernels in the order flipout and LRT meet them: per
# layer q, k, v, the attention output, the FFN up and down; the pooler; the
# classifier (the group of one grouped #11 launch, a forward, under the
# mixture)
BERT_LEAVES = (((768, 768),) * 4 + ((768, 3072), (3072, 768))) * 12 + ((768, 768), (768, 2))
# phase 14's BERT-base runs of the estimators at 6 of its 12 layers (every
# width published): the depth cut that keeps the script inside its time
# limit; the grouped #11 and its VJP are timed at that path's group
ESTIMATOR_DEPTH = 6
ESTIMATOR_LEAVES = BERT_LEAVES[:6 * ESTIMATOR_DEPTH] + BERT_LEAVES[-2:]
# the groups the grouped kernels are checked on: BERT-base's leaves and an
# odd shape, the last leaf one with several blocks, whose last block holds
# elements (the forward's planted fault drops it)
CHECK_GROUP = ((300, 130), (768, 2)) + BERT_LEAVES[:-1]


# the sources whose kernels' SASS the bounds of #10, #11 and #13 read (the
# whole library's takes cuobjdump ~37 s: 180 MB of text, mostly attention)
SASS_SOURCES = ("regen", "logprob")


def sass_mufu(obj_dir) -> tuple[dict[str, int], dict[str, int], dict[str, tuple]]:
    """MUFU instructions (the card's special-function unit: exp2, log2,
    rsqrt, reciprocal, sin, cos) and all instructions in each kernel of the
    objects of :data:`SASS_SOURCES` in ``obj_dir``, from ``cuobjdump
    -sass``: two {mangled name: count}; and
    per kernel with a loop, its widest loop (from the target of its widest
    backward branch to the branch; in the draw kernel one draw of its loop
    over draws): (MUFU, all, fast path, before), where the fast path leaves
    out each stretch that a forward branch skips and that holds a loop of
    its own (the precise sin / cos's reduction of large arguments, which
    the stream's angles below 2 pi never take), and ``before`` counts the
    instructions ahead of the loop."""
    import re

    from bayeformers_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = "".join(
        subprocess.run([cuobjdump, "-sass", os.path.join(obj_dir, f"{src}.o")],
                       capture_output=True, text=True, check=True, timeout=600).stdout
        for src in SASS_SOURCES)
    code, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            code[name] = []
        elif name is not None:
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(\S.*)", line)
            if m:
                code[name].append((int(m.group(1), 16), m.group(2)))
    is_mufu = re.compile(r"\bMUFU\.")
    mufu = {n: sum(bool(is_mufu.search(t)) for _, t in c) for n, c in code.items()}
    total = {n: len(c) for n, c in code.items()}
    loop = {}
    for n, c in code.items():
        branches = [(a, int(m.group(1), 16)) for a, t in c
                    for m in [re.search(r"\bBRA(?:\.\S+)?\s+`?\(?(0x[0-9a-f]+)", t)] if m]
        back = [(a, b) for a, b in branches if b < a]
        if not back:
            continue
        hi, lo = max(back, key=lambda ab: ab[0] - ab[1])
        body = [(a, t) for a, t in c if lo <= a <= hi]
        slow = [(a, b) for a, b in branches if lo <= a < b <= hi
                and any(a < x and y < b for x, y in back if (x, y) != (hi, lo))]
        fast = [t for a, t in body if not any(x < a < y for x, y in slow)]
        loop[n] = (sum(bool(is_mufu.search(t)) for _, t in body), len(body), len(fast),
                   sum(1 for a, _ in c if a < lo))
    return mufu, total, loop


def mufu_of(counts: dict, *parts):
    """The entry (a MUFU count, or any other per-kernel entry of
    :func:`sass_mufu`) of the one kernel whose mangled name holds every one
    of ``parts``."""
    hits = [n for n in counts if all(p in n for p in parts)]
    check(len(hits) == 1, f"kernels named with {parts}: {hits}")
    return counts[hits[0]]


def mufu_rate() -> tuple[float, float]:
    """The card's MUFU rate (16 a clock per SM x 132 SMs x the SM clock at
    its maximum, ``nvidia-smi`` ``clocks.max.sm``), and the clock as read
    now (``clocks.sm``), in MHz."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm,clocks.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    mx, now = (float(v) for v in out.split(","))
    return 16 * 132 * mx * 1e6, now


def bound_mufu(n_bytes: float, n_mufu: float, rate: float) -> tuple[float, str]:
    """The least time (ms) for the bytes at the HBM rate and the MUFU
    instructions at the card's MUFU rate; which of the two is larger."""
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_mufu / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def regen_instance(pair: bool, lo: bool) -> str:
    """The part of ``bft_regen``'s draw kernel's mangled name that names its
    instance: pairs (H = 2) or not, with the bf16 copy or not."""
    return f"draw_kernelILi{2 if pair else 1}EfLi3ELb{int(lo)}E"


def regen_threads(shapes) -> int:
    """The draw kernel's threads for ``shapes``: one per (unit row of 128,
    four columns), padded rows included."""
    return sum(-(-K // 256) * 128 * (-(-N // 4)) for K, N in shapes)


def regen_instructions(sass: tuple, pair: bool, lo: bool, shapes, S: int
                       ) -> tuple[float, float]:
    """The MUFU instructions and all instructions that the threads of the
    draw kernel's instance issue for S draws of ``shapes``, from its code
    (:func:`sass_mufu`): per thread the MUFU of the whole kernel with the
    draw loop's taken S times, and the instructions ahead of the loop plus
    S times the loop's fast path. Counted from the code, not traced: a
    branch that skips part of the fast path on some data (a ragged edge)
    is counted as taken."""
    mufu, total, loop = sass
    inst = regen_instance(pair, lo)
    lm, _, fast, before = mufu_of(loop, inst)
    n = regen_threads(shapes)
    return n * (mufu_of(mufu, inst) + (S - 1) * lm), n * (before + S * fast)


def issue_ms(n_instr: float, rate: float) -> float:
    """The least time (ms) for ``n_instr`` thread instructions at one warp
    instruction a clock on each of the 4 schedulers of 132 SMs at the
    card's maximum SM clock: a quarter of the MUFU ``rate``
    (:func:`mufu_rate`, 16 a clock per SM) in warp instructions."""
    return n_instr / 32 / (rate / 4) * 1e3


def group_quads(shapes) -> int:
    """The quads (four elements of one Philox call, padded rows included)
    of a group: the grouped kernels' threads' units of work."""
    return sum(-(-K // 256) * 128 * (-(-N // 2)) for K, N in shapes)


def group_inputs(shapes, S, prior, seed=0):
    """Random-init leaves on the card (mu ~ U(-0.2, 0.2), rho ~ U(-5, -4),
    the reference's uniform init; under the Gaussian, prior_mu = mu + 0.05
    N(0, 1)), and each leaf's S seeds."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    mus, rhos, pms, seeds = [], [], [], []
    for K, N in shapes:
        mus.append(torch.rand(K, N, device="cuda", generator=gen) * 0.4 - 0.2)
        rhos.append(torch.rand(K, N, device="cuda", generator=gen) - 5.0)
        if prior == "gaussian":
            pms.append(mus[-1] + 0.05 * torch.randn(K, N, device="cuda", generator=gen))
        seeds.append(torch.randint(0, 2**31 - 1, (S,), device="cuda", generator=gen,
                                   dtype=torch.int32))
    return mus, rhos, (pms if prior == "gaussian" else None), seeds


def split_regen_rows(sl, moped_rho, sass, rate, shapes, tags, path) -> list[dict]:
    """(1) of :func:`phase_split_regen` at each (K, N) of ``shapes``, timed
    in each of ``tags`` (``"bf16"``: with the bf16 copy) as a row of the
    launches of ``path``/tag. Returns the rows."""
    from bayeformers_tpu_torch.ops import fused_linear as fl

    rows = []
    for K, N in shapes:
        _, mu, rho, seeds = sampled_dense_inputs(10, 8, K, N, moped_rho, F32, True)
        w, lo = sl.regen_cuda(mu, rho, seeds, sl.REGEN_LAUNCHES, lo_dtype=BF16)
        w2, lo2 = sl.regen_cuda(mu, rho, seeds, sl.REGEN_LAUNCHES, lo_dtype=BF16)
        w1 = sl.regenerate_weights(mu, rho, seeds)
        wf = fl.regenerate_weights(mu, rho, seeds)
        torch.cuda.synchronize()
        plain = sl.naive_weights(mu, rho, seeds)
        check(torch.equal(w, w2) and torch.equal(lo, lo2),
              f"split regen reruns differ at {(K, N)}")
        check(torch.equal(w, plain) and torch.equal(w1, plain),
              f"split regen differs from the plain stream at {(K, N)}: "
              f"max {max_dist(w, plain)}")
        check(torch.equal(w, wf), f"split regen differs from fused_linear's at {(K, N)}")
        check(torch.equal(lo, plain.to(BF16)), f"split regen's bf16 W differs from the "
              f"f32 W rounded at {(K, N)}")
        for tag in tags:
            lo_dtype = BF16 if tag == "bf16" else None
            ms = time_ms(lambda: sl.regen_cuda(mu, rho, seeds, sl.REGEN_LAUNCHES, lo_dtype),
                         20, windows=WINDOWS)
            plain_ms = time_ms(lambda: sl.naive_weights(mu, rho, seeds), 3, 1)
            n_mufu, n_all = regen_instructions(sass, False, tag == "bf16", [(K, N)], 10)
            n_bytes = 10 * K * N * (4 + 2 * (tag == "bf16")) + 2 * K * N * 4 + 40
            b = bound_mufu(n_bytes, n_mufu, rate)
            say(f"split regen S=10 (mu = 0, {tag} W{' and f32 W' if tag == 'bf16' else ''}) "
                f"K={K} N={N}: W bit-equal to the plain stream and to "
                f"fused_linear.regenerate_weights, bf16 copy equal, reruns equal; kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b[0]:.4f} ms ({b[1]}; issue "
                f"{issue_ms(n_all, rate):.4f} ms), no library call")
            shape = (10, K, N, "bf16") if tag == "bf16" else (10, K, N)
            rows.append(row(f"sampled_regen[S=10,K={K},N={N},{tag}]", "sampled_regen",
                            shape, f"{path}/{tag}", "bayeformers_tpu_torch/csrc/regen.cu",
                            "bayeformers_tpu/ops/sampled_linear.py:205", 0.0, ms, plain_ms,
                            b, None))
    return rows


def phase_split_regen(sl, lpm, moped_rho, sass, rate) -> list[dict]:
    """Kernel #13. (1) ``bft_regen`` at flipout's S = 10 perturbation draws
    (mu = 0) and every converted layer's (K, N): the f32 W bit-equal to the
    plain stream and to ``fused_linear.regenerate_weights``, the bf16 copy it
    writes in the same pass bit-equal to that W rounded, reruns equal.
    (2) The log-prob VJP that took #13's W (``bft_logprob_vjp``: the draws
    rebuilt in registers) over :data:`CHECK_GROUP` at ``KL_DRAWS`` under
    both priors: dmu and drho within 1e-5 of each one's largest entry
    against the plain VJP a leaf, reruns bit-equal, no (S, K, N) tensor
    allocated (peak memory), and a planted fault (the cotangents of draw S -
    1 zeroed: the VJP without that draw) must fail the gate. (3) Flipout's
    ``sampled_dense`` VJP through #13 and the reduce (bf16: ``bft_reduce_abuv``
    in its bf16 x / f32 W instance; f32) at M = 1024, S = 10: dx, dmu, drho
    against the plain route (1e-4 bf16, 1e-5 f32, of each one's largest
    entry), the reduce launched, no ``torch.bmm`` with an f32 or (S, K, N)
    output in bf16 nor an (S, K, N) one in f32. Returns the timing rows."""
    from bayeformers_tpu_torch.ops import fused_backward as fb

    rows = split_regen_rows(sl, moped_rho, sass, rate, REGEN_SHAPES, ("bf16", "f32"),
                            "train/flipout")
    split_regen_rows(sl, moped_rho, sass, rate, ((300, 130),), (), "train/flipout")
    rows += phase_logprob_vjp(lpm, sass[0], rate)
    for dtype in (BF16, F32):
        phase_flipout_vjp(sl, fb, moped_rho, dtype)
    return rows


def phase_logprob_vjp(lpm, mufu, rate) -> list[dict]:
    """The grouped log-prob VJP (``bft_logprob_vjp``): see
    :func:`phase_split_regen`, (2)."""
    rows = []
    S = KL_DRAWS
    for prior in ("mixture", "gaussian"):
        ptuple = ("mixture",) + MIXTURE if prior == "mixture" else ("gaussian",)
        mus, rhos, pms, seeds = group_inputs(CHECK_GROUP, S, prior, seed=11)
        n = len(mus)
        gen = torch.Generator(device="cuda").manual_seed(12)
        g_q = torch.randn(n, S, device="cuda", generator=gen)
        g_p = torch.randn(n, S, device="cuda", generator=gen)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        dmu, drho = lpm.logprob_vjp_grouped_cuda(mus, rhos, seeds, ptuple, g_q, g_p, pms)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - base
        n_el = sum(K * N for K, N in CHECK_GROUP)
        check(extra <= 2 * n_el * 4 + 2**20, f"logprob_vjp ({prior}) allocated {extra} B, "
              f"its outputs {2 * n_el * 4} B: an (S, K, N) tensor?")
        dmu2, drho2 = lpm.logprob_vjp_grouped_cuda(mus, rhos, seeds, ptuple, g_q, g_p, pms)
        g_q0, g_p0 = g_q.clone(), g_p.clone()
        g_q0[:, -1] = 0
        g_p0[:, -1] = 0
        fmu, frho = lpm.logprob_vjp_grouped_cuda(mus, rhos, seeds, ptuple, g_q0, g_p0, pms)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(dmu + drho, dmu2 + drho2)),
              f"logprob_vjp ({prior}) reruns differ")
        worst, fault, err = 0.0, float("inf"), 0.0
        for i in range(n):
            pm = None if pms is None else pms[i]
            pmu, prho = lpm.logprob_vjp_plain(mus[i], rhos[i], g_q[i], g_p[i], seeds[i],
                                              ptuple, pm)
            for got, bad, want in ((dmu[i], fmu[i], pmu), (drho[i], frho[i], prho)):
                scale = want.abs().max().item()
                d = (got - want).abs().max().item()
                worst = max(worst, d / (1e-5 * scale))
                err = max(err, d)
                fault = min(fault, (bad - want).abs().max().item() / (1e-5 * scale))
        check(worst <= 1.0, f"logprob_vjp ({prior}) differs from the plain VJP by "
              f"{worst:.3g}x its gate (1e-5 of each one's largest entry)")
        check(fault > 1.0, f"logprob_vjp ({prior}): the gate passes a VJP without draw "
              f"S - 1 ({fault:.3g}x the gate)")
        summary = (f"dmu/drho within {worst:.3g}x their gate of the plain VJP over "
                   f"{n} leaves, reruns equal, {extra} B allocated (its outputs "
                   f"{2 * n_el * 4}); planted fault (draw S - 1 dropped): "
                   f"{fault:.3g}x the gate at least (failed)")
        # the time at the path's group: phase 14's BERT leaves, model order
        mus, rhos, pms, seeds = group_inputs(ESTIMATOR_LEAVES, S, prior, seed=13)
        n = len(mus)
        g_q, g_p = g_q[:n].contiguous(), g_p[:n].contiguous()
        ms = time_ms(lambda: lpm.logprob_vjp_grouped_cuda(mus, rhos, seeds, ptuple, g_q, g_p,
                                                          pms), 20, windows=WINDOWS)
        plain_ms = time_ms(lambda: [lpm.logprob_vjp_plain(
            mus[i], rhos[i], g_q[i], g_p[i], seeds[i], ptuple, None if pms is None else pms[i])
            for i in range(n)], 2, 1)
        n_el = sum(K * N for K, N in ESTIMATOR_LEAVES)
        n_bytes = n_el * 4 * (4 + (pms is not None)) + 2 * n * S * 4
        inst = "ILi2ELi4ELi128E" if prior == "mixture" else "ILi1ELi4ELi128E"
        n_mufu = group_quads(ESTIMATOR_LEAVES) * mufu_of(mufu, "logprob_vjp_kernel" + inst)
        b = bound_mufu(n_bytes, n_mufu, rate)
        say(f"logprob_vjp ({prior}) S={S}: {summary}; phase 14's BERT's {n} leaves: kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms (a leaf at a time), bound {b[0]:.4f} ms "
            f"({b[1]}; bytes {n_bytes / H100_BYTES_PER_S * 1e3:.4f}, MUFU {n_mufu:.4g} at "
            f"{rate:.4g}/s {n_mufu / rate * 1e3:.4f}), no library call")
        path = "train/flipout/bf16/mixture" if prior == "mixture" else None
        rows.append(row(f"logprob_vjp[S={S},leaves={n},{prior}]", "logprob_vjp",
                        (n, S, prior), path,
                        "bayeformers_tpu_torch/csrc/logprob.cu",
                        "bayeformers_tpu/ops/sampled_linear.py:205", err, ms, plain_ms, b, None))
        del mus, rhos, pms
        torch.cuda.empty_cache()
    return rows


def bmm_outputs(fn):
    """``fn()`` and the (dtype, shape) of the output of every ``aten.bmm``
    it ran (a ``TorchDispatchMode``)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    calls = []

    class Log(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.overloadpacket is torch.ops.aten.bmm:
                calls.append((out.dtype, tuple(out.shape)))
            return out

    with Log():
        return fn(), calls


def phase_flipout_vjp(sl, fb, moped_rho, dtype, shapes=REGEN_SHAPES[:3], M=1024) -> None:
    """Flipout's ``sampled_dense`` VJP on the card: see
    :func:`phase_split_regen`, (3); at each (K, N) of ``shapes`` and M
    rows."""
    S, tag = 10, TAG[dtype]
    gate = 1e-4 if dtype == BF16 else 1e-5
    for K, N in shapes:
        x, mu, rho, seeds = sampled_dense_inputs(S, M, K, N, moped_rho, dtype, True)
        gen = torch.Generator(device="cuda").manual_seed(K + N)
        g = (torch.randn(S, M, N, device="cuda", generator=gen) * 0.01).to(dtype)
        fb.INDEP_LAUNCHES.reset()
        got, bmms = bmm_outputs(lambda: sl.sampled_dense_vjp(x, mu, rho, seeds, g))
        again = sl.sampled_dense_vjp(x, mu, rho, seeds, g)
        torch.cuda.synchronize()
        check(fb.INDEP_LAUNCHES.count == 2, f"flipout VJP ({tag}) launched the reduce "
              f"{fb.INDEP_LAUNCHES.count} times in two calls")
        # dx's product alone, (S, M, K) in x's dtype: no f32 or (S, K, N)
        # product (where M = K = N the two shapes meet: the dtype and the
        # count still tell dx's apart)
        check(bmms == [(dtype, (S, M, K))], f"flipout VJP ({tag}) ran torch.bmm {bmms}: "
              f"want dx's alone, {(dtype, (S, M, K))}")
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"flipout VJP ({tag}) reruns differ at {(K, N)}")
        want = sl.sampled_dense_vjp(x, mu, rho, seeds, g, plain=True)
        # dx: the same W in x's dtype and the same torch.bmm on both routes
        check(torch.equal(got[0], want[0]), f"flipout VJP ({tag}) dx differs from the plain "
              f"route at {(K, N)}")
        ratios = []
        for name, a, b in zip(("dmu", "drho"), got[1:], want[1:]):
            r = (a - b).abs().max().item() / (gate * b.abs().max().item())
            ratios.append(r)
            check(r <= 1.0, f"flipout VJP ({tag}) {name} differs from the plain route by "
                  f"{r:.3g}x its gate ({gate} of its largest entry) at {(K, N)}")
        ms = time_ms(lambda: sl.sampled_dense_vjp(x, mu, rho, seeds, g), 10, windows=WINDOWS)
        say(f"flipout sampled_dense VJP ({tag}) S={S} M={M} K={K} N={N}: through bft_regen "
            f"and bft_reduce_abuv, torch.bmm {bmms} (dx); dx equal to the plain route's, "
            f"dmu/drho within {ratios[0]:.3g}/{ratios[1]:.3g}x {gate} of its largest entry, "
            f"reruns equal; {ms:.4f} ms")


def plain_logprob_partials(lpm, common, mu, rho, seeds, prior, prior_mu):
    """One leaf's sums before their constants in ``csrc/logprob.cu`` in f64
    from the plain f32 draw, each with its sum of |terms| (the scale of its
    f32 rounding): per draw and block of the leaf, the sums of -eps^2 / 2 and
    of log_p's terms, (S, n_blocks, 2); per block, the sum of log sigma."""
    from bayeformers_tpu_torch.core.distributions import sigma_from_rho
    from bayeformers_tpu_torch.core.prior import MOPED_PRIOR_SIGMA
    from bayeformers_tpu_torch.ops.logprob import mixture_log_pdf

    K, N = mu.shape
    eps = common.unit_eps(seeds, (K, N))
    sig = sigma_from_rho(rho)
    w = mu[None] + sig[None] * eps
    if prior[0] == "mixture":
        p_terms = mixture_log_pdf(w.double(), *prior[1:])
    else:
        p_terms = -0.5 * ((w.double() - prior_mu.double()) / MOPED_PRIOR_SIGMA) ** 2
    block = lpm.logprob_block_of(K, N, mu.device).reshape(-1)
    n_blocks = lpm.logprob_blocks(K, N)

    def sums(t):  # (..., K, N) -> (..., n_blocks)
        flat = t.reshape(-1, K * N)
        out = torch.zeros(flat.shape[0], n_blocks, dtype=torch.float64, device=t.device)
        return out.index_add_(1, block, flat)

    terms = (-0.5 * eps.double() ** 2, p_terms)
    ref = torch.stack([sums(t) for t in terms], -1)
    scale = torch.stack([sums(t.abs()) for t in terms], -1)
    ls = torch.log(sig.double())
    return ref, scale, sums(ls)[0], sums(ls.abs())[0]


def phase_logprob(lpm, common, mufu, rate) -> list[dict]:
    """Kernel #11, grouped (``bft_logprob``: one launch a forward), under
    both priors over :data:`CHECK_GROUP` (BERT-base's 74 leaves and an odd
    shape), ``KL_DRAWS`` seeds a leaf: each leaf's partial sums before the
    constants (its span of the (2 S + 1, blocks) partials) against plain f64
    sums within 1e-5 of their sum of |terms| (per draw and block; the sum of
    log sigma per block), each leaf's ``(log_q, log_p)`` within 1e-5
    relative of the plain version's, a bit-equal rerun, and a planted fault
    (the last leaf's last block dropped) that must fail the log-prob gate;
    then timed at the path's group, the leaves of phase 14's BERT
    (:data:`ESTIMATOR_LEAVES`) in model order,
    its bound counting the 4-draw instance's static MUFU count once a quad
    (its draws unrolled: the count of S = 4, with the one or two MUFU of
    slow paths no input here takes). Returns the timing rows; only the
    mixture instance lies on a main path
    (flipout's and LRT's mixture KL), the Gaussian one is held here."""
    rows = []
    S = KL_DRAWS
    for prior in ("mixture", "gaussian"):
        ptuple = ("mixture",) + MIXTURE if prior == "mixture" else ("gaussian",)
        mus, rhos, pms, seeds = group_inputs(CHECK_GROUP, S, prior)
        lq, lp, part = lpm.logprobs_grouped_cuda(mus, rhos, seeds, ptuple, pms, partials=True)
        again = lpm.logprobs_grouped_cuda(mus, rhos, seeds, ptuple, pms, partials=True)
        spans = lpm.grouped_layout(CHECK_GROUP)
        dropped = spans[:-1] + [spans[-1]._replace(n_blocks=spans[-1].n_blocks - 1)]
        flq, flp = lpm.logprobs_grouped_cuda(mus, rhos, seeds, ptuple, pms, spans=dropped)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip((lq, lp, part), again)),
              f"logprob ({prior}) reruns differ")
        ratio = ls_ratio = err = 0.0
        rel = [0.0, 0.0]
        for i, sp in enumerate(spans):
            pm = None if pms is None else pms[i]
            span = part[:, sp.first_block: sp.first_block + sp.n_blocks]
            got = torch.stack((span[:S], span[S: 2 * S]), -1).double()
            ref, scale, ls_ref, ls_scale = plain_logprob_partials(lpm, common, mus[i], rhos[i],
                                                                  seeds[i], ptuple, pm)
            # blocks past a ragged K hold no element: their sums are 0 on both sides
            ratio = max(ratio, ((got - ref).abs() / (1e-5 * scale).clamp_min(1e-300)).max().item())
            ls_ratio = max(ls_ratio, ((span[2 * S].double() - ls_ref).abs()
                                      / (1e-5 * ls_scale).clamp_min(1e-300)).max().item())
            lqp, lpp = lpm.logprobs_plain(mus[i], rhos[i], seeds[i], ptuple, pm)
            for j, (a, b) in enumerate(((lq[i], lqp), (lp[i], lpp))):
                rel[j] = max(rel[j], ((a - b).abs() / b.abs()).max().item())
                err = max(err, (a - b).abs().max().item())
            if i == len(spans) - 1:
                fault = max(((a - b).abs() / b.abs()).max().item()
                            for a, b in ((flq[i], lqp), (flp[i], lpp)))
        check(max(ratio, ls_ratio) <= 1.0, f"logprob ({prior}) partials differ from the "
              f"plain f64 sums by {ratio:.3g}x / {ls_ratio:.3g}x their gate (1e-5 of the sum "
              "of |terms|)")
        check(max(rel) <= 1e-5, f"logprob ({prior}) log_q/log_p differ from the plain "
              f"version: rel {rel}")
        check(fault > 1e-5, f"logprob ({prior}): the gate passes a forward without the last "
              f"leaf's last block (rel {fault:.3g})")
        summary = (f"{len(spans)} leaves: partials within {ratio:.3g}x (log sigma "
                   f"{ls_ratio:.3g}x) their gate, log_q/log_p rel err {rel[0]:.3g}/"
                   f"{rel[1]:.3g}, reruns equal; planted fault (last leaf's last block "
                   f"dropped) rel {fault:.3g} (failed)")
        mus, rhos, pms, seeds = group_inputs(ESTIMATOR_LEAVES, S, prior, seed=1)
        n = len(mus)
        ms = time_ms(lambda: lpm.logprobs_grouped_cuda(mus, rhos, seeds, ptuple, pms), 20,
                     windows=WINDOWS)
        plain_ms = time_ms(lambda: [lpm.logprobs_plain(
            mus[i], rhos[i], seeds[i], ptuple, None if pms is None else pms[i])
            for i in range(n)], 2, 1)
        n_el = sum(K * N for K, N in ESTIMATOR_LEAVES)
        n_bytes = n_el * 4 * (2 + (pms is not None)) + n * S * 12
        inst = "ILi2ELi4ELi128E" if prior == "mixture" else "ILi1ELi4ELi128E"
        n_mufu = group_quads(ESTIMATOR_LEAVES) * mufu_of(mufu, "logprob_kernel" + inst)
        b = bound_mufu(n_bytes, n_mufu, rate)
        say(f"logprob ({prior}) S={S}: {summary}; phase 14's BERT's {n} leaves: kernel "
            f"{ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms (a leaf at a time), bound {b[0]:.4f} ms ({b[1]}; bytes "
            f"{n_bytes / H100_BYTES_PER_S * 1e3:.4f}, MUFU {n_mufu:.4g} at {rate:.4g}/s "
            f"{n_mufu / rate * 1e3:.4f}), no library call")
        rows.append(row(f"logprob[S={S},leaves={n},{prior}]", "logprob", (n, S, prior),
                        "serve/flipout/bf16/mixture" if prior == "mixture" else None,
                        "bayeformers_tpu_torch/csrc/logprob.cu",
                        "bayeformers_tpu/ops/logprob.py:65", err, ms, plain_ms, b, None))
        del mus, rhos, pms
        torch.cuda.empty_cache()
    return rows


# The new estimators' runs: (estimator, dtype, prior) of phase 14
ESTIMATOR_RUNS = tuple((est, dt, prior) for dt in (BF16, F32)
                       for est, priors in (("flipout", ("on_mu", "mixture")),
                                           ("local", ("on_mu", "mixture")),
                                           ("naive", ("on_mu",)))
                       for prior in priors)


def estimator_counts(fl, fb, at, sl, lpm) -> dict:
    """Every counter's total by name (the Bayesian linear kernels, #11-#13
    and attention's)."""
    return {c.name: c.count for c in (fl.LAUNCHES, fl.INDEP_LAUNCHES, fl.REGEN_LAUNCHES,
                                      fb.LAUNCHES, fb.INDEP_LAUNCHES, sl.LAUNCHES,
                                      sl.REGEN_LAUNCHES, lpm.LAUNCHES, lpm.VJP_LAUNCHES,
                                      at.LAUNCHES, at.BWD_LAUNCHES)}


def want_counts(estimator, prior, n_layers, n_attn, backward: int) -> dict:
    """The launches of one request (``backward=0``) or of ``backward``
    steps: flipout runs #12 on every converted layer a forward and, a
    backward, #13 and the reduce (#9's kernel, ``reduce_abuv``) for its VJP;
    under the mixture flipout and LRT run one grouped #11 launch a forward
    and one grouped log-prob VJP launch a backward; the naive tier and LRT
    run no Bayesian linear kernel; attention runs mha_fwd (and mha_bwd) in
    every layer. Every other counter stays 0."""
    n = max(backward, 1)
    want = {"mha_fwd": n_attn * n, "mha_bwd": n_attn * backward}
    if estimator == "flipout":
        want["sampled_dense"] = n_layers * n
        want["sampled_regen"] = want["reduce_abuv"] = n_layers * backward
    if prior == "mixture" and estimator != "naive":
        want["logprob"] = n
        want["logprob_vjp"] = backward
    return want


def phase_estimator(bt, fl, fb, at, sl, lpm, estimator, dtype, prior, family=BERT,
                    with_step=True):
    """One of the new estimators on BERT-base, cut to
    :data:`ESTIMATOR_DEPTH` layers (or, ``family=GPT2``, GPT-2 base;
    ``LLAMA``: LLaMA base, the request only, ``with_step=False``) at
    S=10 in ``dtype`` under the conversion of ``prior``: the 8x128
    request (the forward and the posterior summaries, under
    ``torch.inference_mode()``) and the ELBO step at B=8, L=128, each
    through the kernels against its ``impl="plain"`` run on the card at the
    existing gates of its dtype (random init's logits through
    :func:`mixture_logits_gate`), bit-equal reruns, launch counts read
    around exactly one request and the 10 timed steps (:func:`want_counts`),
    and the median request and step times. Returns (request launches by
    counter and shape, request ms, step launches, step ms)."""
    from bayeformers_tpu_torch.serving import summarize, summarize_causal_lm

    tag, sfx = TAG[dtype], prior_suffix(prior)
    label = (f"{estimator}{' ' + LM_NAME[family] if family else ''} ({tag}"
             + ("" if prior == "on_mu" else f", {prior}") + ")")
    mc_of = lambda m: bt.training.pick_mc(m, True, estimator)
    counters = (sl.LAUNCHES, sl.REGEN_LAUNCHES, fb.INDEP_LAUNCHES, lpm.LAUNCHES,
                lpm.VJP_LAUNCHES, at.LAUNCHES, at.BWD_LAUNCHES)
    depth = {} if family else {"num_hidden_layers": ESTIMATOR_DEPTH}
    bmodel, named = converted_base(bt, dtype, prior, family, **depth)
    n_layers = len([p for p in bmodel.spec.paths if p.endswith("/kernel")])
    n_attn = 12 if family else ESTIMATOR_DEPTH
    want_layers = sum(LM_LAYERS[family].values()) if family else len(ESTIMATOR_LEAVES)
    check(n_layers == want_layers, f"{label}: {n_layers} converted kernels")
    req = (gpt2_requests(LM_VOCAB[family]) if family else serving_requests(bt))[1]
    dev = bmodel.device
    args = tuple(torch.from_numpy(req[k]).to(dev)
                 for k in ("input_ids", "attention_mask", "token_type_ids") if k in req)
    out_shape = (10, 8, 128, LM_VOCAB[family]) if family else (10, 8, 2)

    def serve(m, seed, impl="kernel"):
        with torch.inference_mode():
            logits, aux = mc_of(m)(seed, 10, *args, impl=impl)
            summ = (summarize_causal_lm(logits, args[1], 50) if family
                    else summarize(logits))
            return logits, aux, summ

    serve(bmodel, 7)
    torch.cuda.synchronize()
    reset_counters(fl, fb, at, sl, lpm)
    lk, auxk, summ = serve(bmodel, 12345)
    torch.cuda.synchronize()
    got = estimator_counts(fl, fb, at, sl, lpm)
    want = want_counts(estimator, prior, n_layers, n_attn, 0)
    check(all(got[k] == want.get(k, 0) for k in got),
          f"{label}: one request launched {got}, want {want} (0 elsewhere)")
    serve_launches = {c.name: dict(c.by_shape) for c in counters}
    again, aux_again, _ = serve(bmodel, 12345)
    other, _, _ = serve(bmodel, 999)
    check(torch.equal(lk, again) and all(torch.equal(auxk[k], aux_again[k]) for k in auxk),
          f"{label}: the same seed gave other logits")
    check(not torch.equal(lk, other), f"{label}: another seed gave the same logits")
    check(bool(torch.isfinite(lk.float()).all()) and tuple(lk.shape) == out_shape,
          f"{label}: logits {tuple(lk.shape)} not finite")
    probs = summ["topk_probs"] if family else summ["probs"]
    total = probs.sum(-1)
    check(bool(torch.allclose(total, torch.ones(8, device=dev), atol=1e-5)) if not family
          else bool((total <= 1 + 1e-5).all() and (probs.diff(dim=-1) <= 1e-7).all()),
          f"{label}: probs do not sum to 1 (top-k: not sorted or above 1)")
    lp_, auxp, _ = serve(bmodel, 12345, "plain")
    err = max_dist(lk, lp_)
    if prior == "mixture":
        note = mixture_logits_gate(bt, fl, bmodel, args, False, dtype, lk, lp_, err,
                                   forward=lambda m, impl: serve(m, 12345, impl)[0],
                                   overrides=depth)
    elif dtype == BF16 and family not in (BERT, GPT2):
        note = f32_logits_gate(bt, family, lambda m: serve(m, 12345, "plain")[0], lk, lp_)
    else:
        limit = 1e-4 if dtype == F32 else 5e-2
        check(err <= limit, f"{label}: logits through the kernels differ from the plain "
              f"path by {err} (gate {limit})")
        note = f"logits kernels vs plain max|d| {err:.4g} (gate {limit})"
    for key in auxk:
        check(torch.allclose(auxk[key], auxp[key], rtol=1e-5, atol=0.0),
              f"{label}: {key} differs from the plain path: {auxk[key]} vs {auxp[key]}")
    kl_note = (f"kl {auxk['kl'].item():.9g} vs plain {auxp['kl'].item():.9g}" if "kl" in auxk
               else f"log_q {auxk['log_variational_posterior'][0].item():.9g} vs "
               f"{auxp['log_variational_posterior'][0].item():.9g}")
    say(f"serving {label}: launches in one request {got}; {note}; {kl_note}; reruns "
        "equal, another seed differs")
    lat = []
    for i in range(TIMED):
        torch.cuda.synchronize()
        t = time.perf_counter()
        serve(bmodel, 200 + i)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t) * 1e3)
    serve_ms = float(np.median(lat))
    say(f"serving {label}: 8x128 request (S=10) median {serve_ms:.3f} ms over {TIMED}: "
        f"{[round(v, 3) for v in lat]}")
    if not with_step:
        del named, bmodel
        torch.cuda.empty_cache()
        return serve_launches, serve_ms, None, None

    # the ELBO step through the kernels against the plain step, same draw
    batch = train_batch(bt, family=family)
    mu_names = [] if prior == "on_mu" else [f"params/{p}" for p in bmodel.spec.paths]
    if dtype == BF16:
        m32, n32 = converted_base(bt, F32, prior, family, **depth)
        _, _, g32 = grads_of(bt, m32, n32, 123, batch, "plain", estimator, family=family)
        del m32, n32
        torch.cuda.empty_cache()
    loss_k, mk, gk = grads_of(bt, bmodel, named, 123, batch, "kernel", estimator,
                              family=family)
    loss_k2, _, gk2 = grads_of(bt, bmodel, named, 123, batch, "kernel", estimator,
                               family=family)
    loss_p, mp, gp = grads_of(bt, bmodel, named, 123, batch, "plain", estimator,
                              family=family)
    check(torch.equal(loss_k, loss_k2) and all(torch.equal(gk[n], gk2[n]) for n in gk),
          f"{label}: the same seed gave another loss or gradient through the kernels")
    step_label = f"train {label}"
    if dtype == BF16:
        check_bf16_step(step_label, loss_k, loss_p, mk, mp, gk, gp, g32, mu_names,
                        prior == "mixture")
        del g32
    else:
        loss_rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
        say(f"{step_label}: loss kernels {loss_k.item():.9g} vs plain {loss_p.item():.9g} "
            f"(rel {loss_rel:.3g}); reruns bit-equal")
        check(loss_rel <= 1e-6, f"{step_label}: loss kernels {loss_k.item()} vs plain "
              f"{loss_p.item()}")
        for group, names in grad_groups(list(gk)).items():
            rel, cos, at_ = worst_agreement(gk, gp, names)
            say(f"{step_label}: {group} gradients ({len(names)} leaves), kernels vs plain "
                f"f32: worst rel L2 {rel:.4g} ({at_}), worst cosine {cos:.9f}")
            check(rel <= 1e-3, f"{step_label}: {group} gradients differ from the plain "
                  f"f32 step: rel L2 {rel} at {at_}")
    if prior == "mixture" and estimator != "naive":
        # the KL part alone (#11's forward and its VJP's #13) against the
        # plain step's, as check_prior_grads holds the fused tier's
        check_prior_grads(bt, fb, bmodel, named, batch, estimator, step_label, mu_names)
    del gk, gk2, gp

    tx = bt.training.adamw_with_decay_groups(
        bt.training.linear_schedule(2e-5, 0.0, 100), 0.0,
        bt.training.default_no_decay, eps=1e-8, clip_norm=1.0)
    opt = tx.init(named)
    step = bt.training.make_elbo_train_step(bmodel, opt, 10, 256, estimator=estimator,
                                            **loss_keywords(family))
    losses = [step(55, batch)["loss"].item() for _ in range(4)]
    say(f"{step_label}: loss over 4 steps at one batch and draw: {losses}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"{step_label}: the ELBO "
          "did not fall")
    torch.cuda.synchronize()
    reset_counters(fl, fb, at, sl, lpm)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(TIMED):
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = step(1000 + i, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        check(bool(torch.isfinite(m["loss"])), f"{step_label}: step {i} loss {m['loss']}")
    got = estimator_counts(fl, fb, at, sl, lpm)
    want = want_counts(estimator, prior, n_layers, n_attn, TIMED)
    check(all(got[k] == want.get(k, 0) for k in got),
          f"{step_label}: {TIMED} steps launched {got}, want {want} (0 elsewhere)")
    step_launches = {c.name: dict(c.by_shape) for c in counters}
    step_ms = float(np.median(times))
    say(f"{step_label}: launches over {TIMED} steps {got}; ELBO step (S=10, B=8, L=128) "
        f"median {step_ms:.3f} ms over {TIMED}: {[round(v, 3) for v in times]}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del opt, step, named, bmodel
    torch.cuda.empty_cache()
    return serve_launches, serve_ms, step_launches, step_ms


def phase_workload_estimator(fl, fb, at, sl, lpm, estimator) -> float:
    """bert_glue phases A-D with ``--estimator`` at S=10 in bf16, three
    batches an epoch (the GLUE recipe: frozen MOPED): flipout must launch
    #12, #13 and the reduce behind its VJP, and nothing else of the fused
    tier or #11; local reparameterization none of #1-#13."""
    from bayeformers_tpu_torch.workloads import bert_glue

    reset_counters(fl, fb, at, sl, lpm)
    with tempfile.TemporaryDirectory() as logs:
        score = bert_glue.train(size="base", limit_batches=3, epochs=1, b_epochs=1,
                                bf16=True, logs=logs, samples=10, estimator=estimator)
    check(np.isfinite(score), f"bert_glue --estimator {estimator} score {score}")
    counts = estimator_counts(fl, fb, at, sl, lpm)
    flip = estimator == "flipout"
    bayes = {k: v for k, v in counts.items() if not k.startswith("mha")}
    ok = all((v > 0) == (flip and k in ("sampled_dense", "sampled_regen", "reduce_abuv"))
             for k, v in bayes.items())
    check(ok and counts["mha_fwd"] > 0 and counts["mha_bwd"] > 0,
          f"bert_glue --estimator {estimator} launched {counts}")
    say(f"workload: bert_glue --estimator {estimator} phases A-D at S=10, bf16, 3 batches "
        f"an epoch: score {score:.4f}; launches {counts}")
    return score


# ---------------------------------------------------------------------------
# Phase 15: GPT-2 base, causal-LM serving and training, through the causal
# instances of #3 (csrc/mha.cu) and #5 (csrc/mha_bwd.cu)
# ---------------------------------------------------------------------------

def causal_inputs(at, N, L, H, seed, dtype):
    """Seeded q, k, v, g (N, L, H) and the key bias: right-padded keys in
    half the rows, one fully masked row (a padded bucket row) and one row
    whose first key is masked (its query 0 sees no live key)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, g = (torch.randn(N, L, H, device=dev, generator=gen).to(dtype)
                  for _ in range(4))
    mask = torch.ones(N, L, device=dev)
    mask[: N // 2, L - L // 3:] = 0
    mask[N - 1] = 0
    mask[N - 2, 0] = 0
    return q, k, v, g, at.mask_to_bias(mask)


def attn_gate_ok(out, ref, dtype, backward=False) -> bool:
    """The attention gates: bf16 forward 2e-2 absolute, bf16 backward 2e-2
    absolute plus 2e-2 relative, f32 1e-4 absolute plus 1e-4 relative."""
    tol = 1e-4 if dtype == F32 else 2e-2
    if dtype == BF16 and not backward:
        return (out.float() - ref.float()).abs().max().item() <= tol
    return torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol)


@contextlib.contextmanager
def shifted_causal_mask(at):
    """While the block runs, the plain versions mask key j > i + 1 instead of
    j > i: the reference of a planted fault, a mask one column off."""
    orig = at.causal_where

    def shifted(s):
        L = s.shape[-1]
        keep = torch.ones(L, L, dtype=torch.bool, device=s.device).tril(1)
        return torch.where(keep, s, torch.full((), at.NEG_BIG, device=s.device))

    at.causal_where = shifted
    try:
        yield
    finally:
        at.causal_where = orig


def causal_sdpa_mask(at, bias, dtype):
    """The combined (N, 1, L, L) float mask that gives SDPA the same
    function: the key bias where key <= query, else the type's minimum."""
    L = bias.shape[1]
    keep = torch.ones(L, L, dtype=torch.bool, device=bias.device).tril()
    full = torch.where(keep[None], bias[:, None, :], torch.full((), at.NEG_BIG,
                                                              device=bias.device))
    return full.clamp_min(torch.finfo(dtype).min).to(dtype)[:, None]


def phase_causal_mha(at, dtype) -> list[dict]:
    """The causal instances of #3 and #5 against their plain versions at the
    GPT-2 serving and training shape (N = S B = 80, L = 128, H = 768) and
    at L = 512: the attention gates, the fully masked row (and the
    first-key-masked row's query 0) finite and uniform over all L keys,
    bit-equal reruns, and two planted faults that must fail the gates (the
    non-causal instance against the causal plain output; the plain mask
    one column off). Returns the timing rows of the L = 128 shape."""
    nh = 12
    tag, isz = TAG[dtype], torch.finfo(dtype).bits // 8
    rows = []
    for N, L, H in ((80, 128, 768), (8, 512, 768)):
        q, k, v, g, bias = causal_inputs(at, N, L, H, L + 1, dtype)
        out = at.mha_cuda(q, k, v, bias, nh, causal=True)
        again = at.mha_cuda(q, k, v, bias, nh, causal=True)
        grads = at.mha_bwd_cuda(q, k, v, bias, g, nh, causal=True)
        grads2 = at.mha_bwd_cuda(q, k, v, bias, g, nh, causal=True)
        torch.cuda.synchronize()
        ref = at.mha_plain(q, k, v, bias, nh, causal=True)
        gref = at.mha_bwd_plain(q, k, v, bias, g, nh, causal=True)
        err = max_dist(out, ref)
        gerrs = [max_dist(a, r) for a, r in zip(grads, gref)]
        check(attn_gate_ok(out, ref, dtype), f"causal mha ({tag}) differs from its plain "
              f"version at {(N, L, H)}: max {err}")
        for name, a, r in zip(("dq", "dk", "dv"), grads, gref):
            check(bool(torch.isfinite(a.float()).all()), f"causal mha_bwd {name} not finite")
            check(attn_gate_ok(a, r, dtype, True), f"causal mha_bwd ({tag}) {name} differs "
                  f"at {(N, L, H)}: max {gerrs}")
        check(torch.equal(out, again) and all(torch.equal(a, b) for a, b in zip(grads, grads2)),
              f"causal mha ({tag}) reruns differ at {(N, L, H)}")
        # the all-masked rows: uniform P over all L keys, so the mean of v
        vbar = v.float().mean(1)
        uni = max(max_dist(out[N - 1], vbar[N - 1].expand(L, H)),
                  max_dist(out[N - 2, 0], vbar[N - 2]))
        check(bool(torch.isfinite(out.float()).all()) and uni <= (1e-4 if dtype == F32
                                                                   else 2e-2),
              f"causal mha ({tag}): the all-masked rows are not uniform over L: {uni}")
        # planted faults: the gates must fail them
        plain_nc = at.mha_cuda(q, k, v, bias, nh)
        with shifted_causal_mask(at):
            ref_shift = at.mha_plain(q, k, v, bias, nh, causal=True)
        nc_bwd = at.mha_bwd_cuda(q, k, v, bias, g, nh)
        faults = {"non-causal instance": max_dist(plain_nc, ref),
                  "mask one column off": max_dist(out, ref_shift),
                  "non-causal backward": max(max_dist(a, r) for a, r in zip(nc_bwd, gref))}
        check(not attn_gate_ok(plain_nc, ref, dtype)
              and not attn_gate_ok(out, ref_shift, dtype)
              and not all(attn_gate_ok(a, r, dtype, True) for a, r in zip(nc_bwd, gref)),
              f"causal mha ({tag}): a planted fault passes the gates: {faults}")
        summary = (f"fwd max|d| {err:.3g}, dq/dk/dv max|d| "
                   + "/".join(f"{e:.3g}" for e in gerrs)
                   + f", all-masked rows uniform within {uni:.3g}, reruns equal; planted "
                   "faults fail the gates: " + ", ".join(f"{k} max|d| {e:.3g}"
                                                        for k, e in faults.items()))
        if L != 128:
            say(f"causal mha ({tag}) N={N} L={L} H={H}: {summary}")
            continue
        ms = time_ms(lambda: at.mha_cuda(q, k, v, bias, nh, causal=True), 50,
                     windows=WINDOWS)
        plain_ms = time_ms(lambda: at.mha_plain(q, k, v, bias, nh, causal=True), 5, 1)
        bms = time_ms(lambda: at.mha_bwd_cuda(q, k, v, bias, g, nh, causal=True), 20,
                      windows=WINDOWS)
        bplain_ms = time_ms(lambda: at.mha_bwd_plain(q, k, v, bias, g, nh, causal=True), 3, 1)
        d = H // nh
        mask4 = causal_sdpa_mask(at, bias, dtype)
        heads = [t.view(N, L, nh, d).transpose(1, 2).detach().requires_grad_()
                 for t in (q, k, v)]

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(*heads, attn_mask=mask4)

        lib_ms = time_ms(sdpa, 50, windows=WINDOWS)
        o = sdpa()
        go = g.view(N, L, nh, d).transpose(1, 2)
        blib_ms = time_ms(lambda: torch.autograd.grad(o, heads, go, retain_graph=True), 20,
                          windows=WINDOWS)
        # the products the causal function needs: key <= query, L (L + 1) / 2 a head
        pairs = N * L * (L + 1) / 2
        b = bound(4 * N * L * H * isz + N * L * 4, 4.0 * pairs * H, dtype)
        bb = bound(7 * N * L * H * isz + N * L * 4, 10.0 * pairs * H, dtype)
        say(f"causal mha ({tag}) N={N} L={L} H={H}: {summary}; forward kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, sdpa (combined mask) {lib_ms:.4f} ms, bound "
            f"{b[0]:.4f} ms ({b[1]}); backward kernel {bms:.4f} ms, plain {bplain_ms:.4f} "
            f"ms, sdpa backward {blib_ms:.4f} ms, bound {bb[0]:.4f} ms ({bb[1]})")
        suffix = ("" if dtype == BF16 else f",{tag}") + ",causal"
        rows.append(row(f"mha_fwd[N={N},L={L},H={H}{suffix}]", "mha_fwd",
                        (N, L, H, tag, True), f"serve/gpt2/anti/{tag}",
                        "bayeformers_tpu_torch/csrc/mha.cu",
                        "bayeformers_tpu/ops/attention.py:119", err, ms, plain_ms, b, lib_ms))
        rows.append(row(f"mha_bwd[N={N},L={L},H={H}{suffix}]", "mha_bwd",
                        (N, L, H, tag, True), f"train/gpt2/anti/{tag}",
                        "bayeformers_tpu_torch/csrc/mha_bwd.cu",
                        "bayeformers_tpu/ops/attention.py:181", max(gerrs), bms, bplain_ms,
                        bb, blib_ms))
    return rows


def gpt2_requests(vocab=LM_VOCAB[GPT2]) -> list[dict]:
    """Three ragged requests (3x77, 8x128, 5x20 token ids) from a seed; the
    second fills the (8, 128) bucket, its last three rows right-padded after
    90 tokens."""
    rng = np.random.default_rng(0)
    out = []
    for n, L in ((3, 77), (8, 128), (5, 20)):
        mask = np.ones((n, L), np.int64)
        if n == 8:
            mask[5:, 90:] = 0
        out.append({"input_ids": rng.integers(0, vocab, (n, L)),
                    "attention_mask": mask})
    return out


def f32_logits_gate(bt, family, forward, lk, lp, size="base", **overrides) -> str:
    """The bf16 logits gate of the paths phase 16 adds: the kernel path's
    logits no farther from the f32 plain run's (the same weights and draws)
    than 1.5x the bf16 plain path's, in max |d| and in relative L2, as the
    bf16 steps' LayerNorm gradients are held. Two bf16 paths each round the
    model (norms, residuals, activations) their own way; at LLaMA base the
    bf16 plain path itself reads ~0.1 from f32 (``probe_bf16_blocks.py``),
    two bf16 steps of its largest logits, so a fixed absolute gate cannot
    tell a kernel fault from that rounding. ``forward(model)`` gives a
    converted model's plain logits at the draw of ``lk`` and ``lp``."""
    m32, _ = converted_base(bt, F32, "on_mu", family, size, **overrides)
    with torch.inference_mode():
        l32 = forward(m32).float()
    del m32

    def dist(a):
        d = a.float() - l32
        return d.abs().max().item(), (d.norm() / l32.norm()).item()

    (kd, kr), (pd, pr) = dist(lk), dist(lp)
    check(kd <= 1.5 * pd and kr <= 1.5 * pr,
          f"{family} bf16 logits: the kernels are farther from the f32 plain run (max|d| "
          f"{kd}, rel L2 {kr}) than 1.5x the bf16 plain path (max|d| {pd}, rel L2 {pr})")
    del l32
    torch.cuda.empty_cache()
    return (f"logits against the f32 plain run: kernels max|d| {kd:.4g} rel L2 {kr:.4g}, "
            f"bf16 plain max|d| {pd:.4g} rel L2 {pr:.4g} (gate 1.5x); kernels vs bf16 plain "
            f"max|d| {max_dist(lk, lp):.4g}; max |logit| {lp.float().abs().max().item():.4g}")


def phase_serving_gpt2(bt, fl, at, antithetic, dtype, family=GPT2) -> tuple[dict, float]:
    """GPT-2 base from seed 0 (zero leaves to 0.01; or, ``family=LLAMA``,
    LLaMA base), MOPED 0.05 frozen, served by ``Predictor(task="causal-lm",
    n_samples=10, seq_lens=(128,))`` antithetic or with independent draws:
    three ragged requests, launch counts read around exactly them (the
    Bayesian linear kernel once a converted layer, :data:`LM_LAYERS`: GPT-2
    48 times a request, 12 at each Conv1D shape, 768 -> 2304 among them;
    LLaMA 85; causal ``mha_fwd`` 12 times a request), the summaries'
    properties, determinism per seed, the 8x128 request's logits against
    the plain path on the card (1e-4 in f32; in bf16, GPT-2's 5e-2, the
    LLaMA families' :func:`f32_logits_gate`), its log-probs (1e-5 relative)
    and its latency. Returns (launches by counter and shape, median latency
    in ms)."""
    t0 = time.perf_counter()
    tag = TAG[dtype]
    name = LM_NAME[family]
    label = f"serving {name} ({'antithetic' if antithetic else 'independent'}, {tag})"
    bmodel, _ = converted_base(bt, dtype, "on_mu", family)
    pred = bt.Predictor(bmodel, n_samples=10, batch_sizes=(8,), seq_lens=(128,),
                        antithetic=antithetic, task="causal-lm")
    fwd, other = ((fl.LAUNCHES, fl.INDEP_LAUNCHES) if antithetic
                  else (fl.INDEP_LAUNCHES, fl.LAUNCHES))
    torch.cuda.synchronize()
    say(f"{label}: {name} base built and converted in {time.perf_counter() - t0:.2f} s "
        f"({len(bmodel.spec.paths)} converted leaves)")
    layers = LM_LAYERS[family]
    n_leaves = sum(layers.values()) * (2 if family == GPT2 else 1)  # GPT-2's biases
    check(len(bmodel.spec.paths) == n_leaves,
          f"{label}: {len(bmodel.spec.paths)} converted leaves, want {n_leaves}")
    requests = gpt2_requests(LM_VOCAB[family])
    pred(requests[0], seed=100)  # the first request pays one-time set-up
    torch.cuda.synchronize()

    reset_counters(fl, at)
    outs = [pred(r, seed=100 + i) for i, r in enumerate(requests)]
    torch.cuda.synchronize()
    launches = {fwd.name: dict(fwd.by_shape), "mha_fwd": dict(at.LAUNCHES.by_shape)}
    want = {(1024, k, n, tag): 3 * c for (k, n), c in layers.items()}
    check(fwd.by_shape == want and other.count == 0,
          f"{label}: Bayesian linear launches {fwd.by_shape} (other {other.count}), "
          f"want {want}")
    check(at.LAUNCHES.by_shape == {(80, 128, 768, tag, True): 36},
          f"{label}: mha_fwd launches {at.LAUNCHES.by_shape}, want 12 causal a request")
    say(f"{label}: launches over 3 requests: {launches}")
    for r, o in zip(requests, outs):
        n = r["input_ids"].shape[0]
        check(o["topk_ids"].shape == (n, 50) and o["entropy"].shape == (n,),
              f"{label}: topk_ids {o['topk_ids'].shape}")
        check(all(np.isfinite(v).all() for v in o.values()), f"{label}: non-finite output")
        check(bool((np.diff(o["topk_probs"], axis=-1) <= 1e-7).all()
                   and (o["topk_probs"].sum(-1) <= 1 + 1e-5).all()),
              f"{label}: top-k probs not sorted or above 1")
        check(np.array_equal(o["pred"], o["topk_ids"][:, 0]), f"{label}: pred")
        check(bool((o["mutual_info"] >= -1e-6).all()
                   and (o["mutual_info"] <= o["entropy"] + 1e-6).all()),
              f"{label}: BALD mutual information outside [0, entropy]")
    again = pred(requests[1], seed=101)
    diff = pred(requests[1], seed=999)
    check(all(np.array_equal(again[k], outs[1][k]) for k in again),
          f"{label}: the same seed gave other outputs")
    check(not np.array_equal(diff["topk_probs"], outs[1]["topk_probs"]),
          f"{label}: another seed gave the same outputs")
    say(f"{label}: request 2's next tokens {outs[1]['pred'].tolist()}, top prob "
        f"{outs[1]['topk_probs'][:, 0].round(5).tolist()}, mutual info "
        f"{outs[1]['mutual_info'].round(6).tolist()}")

    dev = bmodel.device
    args = tuple(torch.from_numpy(requests[1][k]).to(dev)
                 for k in ("input_ids", "attention_mask"))
    with torch.inference_mode():
        lk, auxk = bmodel.mc_apply_fused(12345, 10, *args, antithetic=antithetic)
        lp, auxp = bmodel.mc_apply_fused(12345, 10, *args, antithetic=antithetic,
                                         impl="plain")
    err = max_dist(lk, lp)
    if dtype == BF16 and family != GPT2:
        note = f32_logits_gate(bt, family, lambda m: m.mc_apply_fused(
            12345, 10, *args, antithetic=antithetic, impl="plain")[0], lk, lp)
    else:
        limit = 1e-4 if dtype == F32 else 5e-2
        check(err <= limit, f"{label}: logits through the kernels differ from the plain "
              f"path by {err} (gate {limit})")
        note = (f"logits kernels vs plain max|d| {err:.4g} (gate {limit}; max |logit| "
                f"{lp.float().abs().max().item():.4g})")
    for key in auxk:
        check(torch.allclose(auxk[key], auxp[key], rtol=1e-5, atol=0.0),
              f"{label}: {key} differs from the plain path: {auxk[key]} vs {auxp[key]}")
    say(f"{label}: {note}; log_q {auxk['log_variational_posterior'][0].item():.7g}"
        f" vs {auxp['log_variational_posterior'][0].item():.7g}")
    del lk, lp
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lat = []
    for i in range(TIMED):
        torch.cuda.synchronize()
        t = time.perf_counter()
        pred(requests[1], seed=200 + i)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t) * 1e3)
    latency = float(np.median(lat))
    say(f"{label}: 8x128 request latency (S=10) median {latency:.3f} ms over {TIMED}: "
        f"{[round(v, 3) for v in lat]}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del pred, bmodel
    torch.cuda.empty_cache()
    return launches, latency


def phase_workload_gpt2(fl, fb, at, estimator, bf16, model="gpt2") -> dict:
    """``gpt2_lm.train`` phases 1-4 at GPT-2 base (or ``model``: LLaMA
    base) for 3 batches: the naive estimator in f32 (its default) takes no
    Bayesian linear kernel; the antithetic one in bf16 takes #1/#2 and #6
    and no other estimator's; every attention launch is causal."""
    from bayeformers_tpu_torch.workloads import gpt2_lm

    reset_counters(fl, fb, at)
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as logs:
        res = gpt2_lm.train(model=model, size="base", limit_batches=3, estimator=estimator,
                            bf16=bf16, logs=logs)
    wall = time.perf_counter() - t
    check(all(np.isfinite(v) for v in res.values()), f"gpt2_lm: {res}")
    counts = {c.name: c.count for c in (fl.LAUNCHES, fl.INDEP_LAUNCHES, fb.LAUNCHES,
                                         fb.INDEP_LAUNCHES, fl.REGEN_LAUNCHES)}
    anti = estimator == "antithetic"
    check(all((n > 0) == (anti and "anti" in k) for k, n in counts.items()),
          f"gpt2_lm --estimator {estimator}: {counts}")
    for c in (at.LAUNCHES, at.BWD_LAUNCHES):
        check(c.count > 0 and all(k[4] for k in c.by_shape),
              f"gpt2_lm: {c.name} launches {c.by_shape}, want causal only")
        counts[c.name + " (causal)"] = c.count
    tag = "bf16" if bf16 else "f32"
    say(f"workload: gpt2_lm --model {model} --estimator {estimator} ({tag}) phases 1-4, "
        "3 batches: "
        f"{res}; launches {counts}; {wall:.1f} s")
    return res


# ---------------------------------------------------------------------------
# Phase 16: the LLaMA-architecture families (LLaMA, Mistral, Gemma), through
# the head-width-32 and key-tiled instances of #3 and #5 and the instance
# that serves #4's shapes
# ---------------------------------------------------------------------------

# the attention shapes of phase 16: (N, L, H, heads, causal, the rows' paths)
#  * d = 32, the tiny configurations' heads, at the 8x128 bucket (N = S B);
#  * the key-tiled instances at base width: L = 520 (a tail key tile),
#    L = 1024 (the long-context request and step, B = 1, N = S) and 2048;
#  * #4's shape: H = 128, 4 heads, L = 1024 (the tiny LLaMA at
#    max_position_embeddings=1024, one request, N = S), where the
#    reference finds no head group and takes its per-head forward.
#  * L = 77: one key tile, most of it past L (keys excluded by their index).
ATTN16 = ((80, 128, 128, 4, False, None), (80, 128, 128, 4, True, "llama-tiny"),
          (6, 77, 768, 12, True, None),
          (8, 520, 768, 12, True, None), (10, 1024, 768, 12, True, "llama-long"),
          (2, 2048, 768, 12, True, None),
          (10, 1024, 128, 4, True, "llama-tiny-long"))
# the planted fault of a width's instance: the score scale of the other
# width of its pair
OTHER_WIDTH = {32: 64, 128: 256, 256: 128}


def scaled_plain(at, q, k, v, bias, nh, causal, scale):
    """The plain forward with the scores scaled by ``scale`` instead of 1 /
    sqrt(d): the reference of a planted fault (a kernel that kept 1 /
    sqrt(64) at head width 32)."""
    d = q.shape[-1] // nh
    return at.mha_plain(q * (scale * math.sqrt(d)), k, v, bias, nh, causal=causal)


def mixed_tile_check(at, dtype) -> str:
    """The causal instances at L = 1024 on a query tile that mixes rows whose
    whole causal prefix is masked with normal rows: example 1's first three
    keys are masked, so its queries 0-2 see no live key while queries 3-63
    of the same 64-row tile do. The kernels skip the key tiles above a
    tile's diagonal only where exp(NEG_BIG - m) is 0 on every row, so this
    tile walks all L keys: the forward and backward at the attention gates,
    rows 0-2 uniform over all L keys, and a planted fault, those rows
    uniform over their causal prefix only (what skipping the tile would
    give), must fail the gate."""
    N, L, H, nh = 4, 1024, 768, 12
    tag = TAG[dtype]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1031)
    q, k, v, g = (torch.randn(N, L, H, device=dev, generator=gen).to(dtype)
                  for _ in range(4))
    mask = torch.ones(N, L, device=dev)
    mask[0, L - 300:] = 0
    mask[1, :3] = 0
    bias = at.mask_to_bias(mask)
    out = at.mha_cuda(q, k, v, bias, nh, causal=True)
    grads = at.mha_bwd_cuda(q, k, v, bias, g, nh, causal=True)
    torch.cuda.synchronize()
    ref = at.mha_plain(q, k, v, bias, nh, causal=True)
    gref = at.mha_bwd_plain(q, k, v, bias, g, nh, causal=True)
    what = f"mha ({tag}) mixed query tile, N={N} L={L} H={H} causal"
    err, gerrs = max_dist(out, ref), [max_dist(a, r) for a, r in zip(grads, gref)]
    check(attn_gate_ok(out, ref, dtype), f"{what}: forward differs: max {err}")
    for name, a, r in zip(("dq", "dk", "dv"), grads, gref):
        check(attn_gate_ok(a, r, dtype, True), f"{what}: {name} differs: max {gerrs}")
    vbar = v[1].float().mean(0)
    uni = max_dist(out[1, :3], vbar.expand(3, H))
    check(uni <= (1e-4 if dtype == F32 else 2e-2),
          f"{what}: the rows with a masked prefix are not uniform over L: {uni}")
    fault = ref.clone()
    for i in range(3):
        fault[1, i] = v[1, : i + 1].float().mean(0).to(dtype)
    check(not attn_gate_ok(out, fault, dtype),
          f"{what}: the planted fault (rows uniform over their causal prefix) passes the "
          f"gate: max {max_dist(out, fault)}")
    return (f"{what}: fwd max|d| {err:.3g}, dq/dk/dv max|d| "
            + "/".join(f"{e:.3g}" for e in gerrs) + f", rows 0-2 uniform over L within "
            f"{uni:.3g}; planted fault (uniform over the causal prefix) fails the gate: "
            f"max|d| {max_dist(out, fault):.3g}")


def attention_checks(at, dtype, shapes, trained=None) -> list[dict]:
    """The instances of ``mha_fwd`` and ``mha_bwd`` at ``shapes`` ((N, L, H,
    heads, causal, the rows' paths)) against their plain versions, in
    ``dtype``: the attention gates, the fully masked rows finite and uniform
    over all L keys, bit-equal reruns, and planted faults that must fail
    the gates (the score scale of the other width of a pair, 32 and 64 or
    128 and 256; causal: the non-causal instance and the plain mask one
    column off; beyond the f32 whole rows: the keys past them dropped).
    Each launch counts in #4's counter where the reference would take its
    per-head forward. Returns the timing rows of the shapes a path serves
    (the backward's only where the path is in ``trained``; None: every
    path trains)."""
    tag, isz = TAG[dtype], torch.finfo(dtype).bits // 8
    tol = 1e-4 if dtype == F32 else 2e-2
    rows = []
    for N, L, H, nh, causal, path in shapes:
        d = H // nh
        q, k, v, g, bias = causal_inputs(at, N, L, H, L + H + 1, dtype)
        counter = at.PER_HEAD_LAUNCHES if at.pallas_route(L, H, nh, isz) == "per_head" \
            else at.LAUNCHES
        reset_counters(at)
        at.PER_HEAD_LAUNCHES.reset()
        out = at.mha_cuda(q, k, v, bias, nh, causal=causal)
        again = at.mha_cuda(q, k, v, bias, nh, causal=causal)
        grads = at.mha_bwd_cuda(q, k, v, bias, g, nh, causal=causal)
        grads2 = at.mha_bwd_cuda(q, k, v, bias, g, nh, causal=causal)
        torch.cuda.synchronize()
        check(counter.count == 2, f"mha ({tag}) {(N, L, H)}: {counter.name} counted "
              f"{counter.count} of 2 launches")
        ref = at.mha_plain(q, k, v, bias, nh, causal=causal)
        gref = at.mha_bwd_plain(q, k, v, bias, g, nh, causal=causal)
        err = max_dist(out, ref)
        gerrs = [max_dist(a, r) for a, r in zip(grads, gref)]
        what = f"mha ({tag}) N={N} L={L} H={H} d={d}{' causal' if causal else ''}"
        check(attn_gate_ok(out, ref, dtype), f"{what}: forward differs from its plain "
              f"version: max {err}")
        for name, a, r in zip(("dq", "dk", "dv"), grads, gref):
            check(bool(torch.isfinite(a.float()).all()), f"{what}: {name} not finite")
            check(attn_gate_ok(a, r, dtype, True), f"{what}: {name} differs: max {gerrs}")
        check(torch.equal(out, again) and all(torch.equal(a, b) for a, b in zip(grads, grads2)),
              f"{what}: reruns differ")
        vbar = v.float().mean(1)
        uni = max(max_dist(out[N - 1], vbar[N - 1].expand(L, H)),
                  max_dist(out[N - 2, 0], vbar[N - 2]) if causal else 0.0)
        check(bool(torch.isfinite(out.float()).all()) and uni <= tol,
              f"{what}: the all-masked rows are not uniform over L: {uni}")
        faults = {}
        if d in OTHER_WIDTH:
            faults[f"scale of d = {OTHER_WIDTH[d]}"] = (out, scaled_plain(
                at, q, k, v, bias, nh, causal, 1.0 / math.sqrt(OTHER_WIDTH[d])))
        if causal:
            faults["non-causal instance"] = (at.mha_cuda(q, k, v, bias, nh), ref)
            with shifted_causal_mask(at):
                faults["mask one column off"] = (out, at.mha_plain(q, k, v, bias, nh,
                                                                   causal=True))
        rows_len = at.rows_max_len(d)
        if L > rows_len:
            cut = bias.clone()
            cut[:, rows_len:] = at.NEG_BIG
            faults[f"keys past {rows_len} dropped"] = (out, at.mha_plain(q, k, v, cut, nh,
                                                                         causal=causal))
        check(all(not attn_gate_ok(a, b, dtype) for a, b in faults.values()),
              f"{what}: a planted fault passes the gates: "
              + str({f: max_dist(a, b) for f, (a, b) in faults.items()}))
        summary = (f"fwd max|d| {err:.3g}, dq/dk/dv max|d| "
                   + "/".join(f"{e:.3g}" for e in gerrs)
                   + f", all-masked rows uniform within {uni:.3g}, reruns equal, counted as "
                   f"{counter.name}; planted faults fail the gates: "
                   + ", ".join(f"{f} max|d| {max_dist(a, b):.3g}"
                               for f, (a, b) in faults.items()))
        if path is None:
            say(f"{what}: {summary}")
            continue
        ms = time_ms(lambda: at.mha_cuda(q, k, v, bias, nh, causal=causal), 20,
                     windows=WINDOWS)
        plain_ms = time_ms(lambda: at.mha_plain(q, k, v, bias, nh, causal=causal), 3, 1)
        bms = time_ms(lambda: at.mha_bwd_cuda(q, k, v, bias, g, nh, causal=causal), 10,
                      windows=WINDOWS)
        bplain_ms = time_ms(lambda: at.mha_bwd_plain(q, k, v, bias, g, nh, causal=causal),
                            2, 1)
        mask4 = causal_sdpa_mask(at, bias, dtype) if causal else \
            bias.clamp_min(torch.finfo(dtype).min).to(dtype)[:, None, None, :]
        heads = [t.view(N, L, nh, d).transpose(1, 2).detach().requires_grad_()
                 for t in (q, k, v)]

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(*heads, attn_mask=mask4)

        lib_ms = time_ms(sdpa, 20, windows=WINDOWS)
        o = sdpa()
        go = g.view(N, L, nh, d).transpose(1, 2)
        blib_ms = time_ms(lambda: torch.autograd.grad(o, heads, go, retain_graph=True), 10,
                          windows=WINDOWS)
        del o, heads, mask4
        # the products the function needs: causal, key <= query, L (L + 1) /
        # 2 a head; else L^2
        pairs = N * L * (L + 1) / 2 if causal else N * L * L
        b = bound(4 * N * L * H * isz + N * L * 4, 4.0 * pairs * H, dtype)
        bb = bound(7 * N * L * H * isz + N * L * 4, 10.0 * pairs * H, dtype)
        say(f"{what}: {summary}; forward kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"sdpa ({'combined' if causal else 'key'} mask) {lib_ms:.4f} ms, bound "
            f"{b[0]:.4f} ms ({b[1]}); backward kernel {bms:.4f} ms, plain {bplain_ms:.4f} "
            f"ms, sdpa backward {blib_ms:.4f} ms, bound {bb[0]:.4f} ms ({bb[1]})")
        suffix = ("" if dtype == BF16 else f",{tag}") + f",d={d}" + (",causal" if causal else "")
        per_head = counter is at.PER_HEAD_LAUNCHES
        rows.append(row(f"mha_fwd{'_per_head' if per_head else ''}[N={N},L={L},H={H}{suffix}]",
                        counter.name, (N, L, H, tag, causal), f"serve/{path}/{tag}",
                        "bayeformers_tpu_torch/csrc/mha.cu",
                        "bayeformers_tpu/ops/attention.py:" + ("78" if per_head else "119"),
                        err, ms, plain_ms, b, lib_ms))
        if not per_head:  # #4's shape is a forward-only request
            trains = trained is None or path in trained
            rows.append(row(f"mha_bwd[N={N},L={L},H={H}{suffix}]", "mha_bwd",
                            (N, L, H, tag, causal), f"train/{path}/{tag}" if trains else None,
                            "bayeformers_tpu_torch/csrc/mha_bwd.cu",
                            "bayeformers_tpu/ops/attention.py:181", max(gerrs), bms,
                            bplain_ms, bb, blib_ms))
        del q, k, v, g, out, again, grads, grads2, ref, gref, faults
        torch.cuda.empty_cache()
    return rows


def unported_width_raises(at, dtype) -> None:
    """A head width that no instance takes (96, which the reference takes)
    raises on the card, naming the ported widths."""
    q = torch.zeros(2, 64, 192, device="cuda", dtype=dtype)
    bias = torch.zeros(2, 64, device="cuda")
    msg = ""
    for fn, args in ((at.mha_cuda, (q, q, q, bias, 2)),
                     (at.mha_bwd_cuda, (q, q, q, bias, q, 2))):
        try:
            fn(*args, causal=True)
            check(False, f"{fn.__name__} at head width 96 did not raise")
        except ValueError as e:
            msg = str(e)
            check("128, 256" in msg, f"{fn.__name__} at width 96: {msg}")
    say(f"mha ({TAG[dtype]}) at head width 96 raises: {msg}")


def phase_attention16(at, dtype) -> list[dict]:
    """The head-width-32, key-tiled and #4 instances of ``mha_fwd`` and
    ``mha_bwd`` against their plain versions at :data:`ATTN16`, in
    ``dtype`` (:func:`attention_checks`), the mixed causal tile, and an
    unported head width's refusal. Returns the timing rows of the shapes a
    phase-16 path serves."""
    rows = attention_checks(at, dtype, ATTN16)
    say(mixed_tile_check(at, dtype))
    unported_width_raises(at, dtype)
    return rows


def lm_counts(fl, fb, at) -> dict:
    """Every counter of the Bayesian linear and attention kernels by name and
    shape."""
    return {c.name: dict(c.by_shape) for c in (
        fl.LAUNCHES, fl.INDEP_LAUNCHES, fb.LAUNCHES, fb.INDEP_LAUNCHES, fl.REGEN_LAUNCHES,
        at.LAUNCHES, at.PER_HEAD_LAUNCHES, at.BWD_LAUNCHES) if c.count}


def lm_want(bmodel, B, L, H, layers, tag, n_req=0, n_steps=0, per_head=False) -> dict:
    """The launches of ``n_req`` antithetic requests or ``n_steps`` steps of
    a converted causal LM at (B, L), S = 10, width H, ``layers`` blocks: the
    forward kernel (and the reduce a step) once a converted kernel at M = B
    L, on its (in, out) view, the causal attention forward (and backward a
    step) once a block, under #4's name where the reference would take its
    per-head forward; in an f32 step, #10's pair instance once a layer whose
    K rounds up above 2048 (``fused_linear.takes_regen_vjp``, the
    reference's route)."""
    from bayeformers_tpu_torch.ops import common
    from bayeformers_tpu_torch.ops import fused_linear as fl

    n = n_req + n_steps
    by_kn, regen = {}, {}
    for p in bmodel.spec.paths:
        if p.endswith("/kernel"):
            K, N = bmodel.rho[p].shape
            if "/c_" in p:  # a GPT-2 Conv1D, stored (out, in)
                K, N = N, K
            by_kn[(B * L, K, N, tag)] = by_kn.get((B * L, K, N, tag), 0) + n
            if tag == "f32" and common.round_up(K, common.UNIT_K) > fl.ANTI_F32_SAVED_MAX_KP:
                regen[(5, K, N, "pair")] = regen.get((5, K, N, "pair"), 0) + n_steps
    key = (10 * B, L, H, tag, True)
    want = {"bayes_linear_anti": by_kn,
            "mha_fwd_per_head" if per_head else "mha_fwd": {key: layers * n}}
    if n_steps:
        want["reduce_abuv_anti"] = dict(by_kn)
        want["mha_bwd"] = {key: layers * n_steps}
        if regen:
            want["regen"] = regen
    return want


def phase_lm_once(bt, fl, fb, at, family, dtype, size="base", B=8, L=128,
                  step=True, n_steps=3, **overrides) -> tuple[dict, float, dict, float]:
    """One causal LM of phase 16 at (B, L), S = 10, antithetic, frozen MOPED
    0.05: a ``Predictor(task="causal-lm")`` request (a warm-up, then three,
    launch counts read around exactly them), its logits against the plain
    path on the card (1e-4 in f32, :func:`f32_logits_gate` in bf16) and its
    latency; with
    ``step``, the ELBO step with the LM loss through the kernels against the
    plain step at the same draw (bf16: loss 1e-2 relative, rho gradients 5e-2
    relative L2 and cosine 0.999; f32: loss 1e-6, every group 1e-3 relative
    L2), then ``n_steps`` timed steps with their launch counts; the peak
    memory of the requests and of the steps. Returns (request launches,
    request ms, step launches, step ms)."""
    tag = TAG[dtype]
    name = f"{LM_NAME[family]} {size}" + (f" {overrides}" if overrides else "")
    label = f"{name} at ({B}, {L}) ({tag})"
    bmodel, named = converted_base(bt, dtype, "on_mu", family, size, **overrides)
    isz = torch.finfo(dtype).bits // 8
    cfg = bmodel.model.config
    if family == GPT2:
        H, nh, layers = cfg.n_embd, cfg.n_head, cfg.n_layer
    else:
        nh, layers = cfg.num_attention_heads, cfg.num_hidden_layers
        H = nh * cfg.attn_head_dim
    per_head = at.pallas_route(L, H, nh, isz) == "per_head"
    pred = bt.Predictor(bmodel, n_samples=10, batch_sizes=(B,), seq_lens=(L,),
                        antithetic=True, task="causal-lm")
    rng = np.random.default_rng(L)
    mask = np.ones((B, L), np.int64)
    mask[B // 2:, L - L // 4:] = 0
    req = {"input_ids": rng.integers(0, cfg.vocab_size, (B, L)), "attention_mask": mask}
    pred(req, seed=1)
    torch.cuda.synchronize()
    reset_counters(fl, fb, at)
    at.PER_HEAD_LAUNCHES.reset()
    torch.cuda.reset_peak_memory_stats()
    lat = []
    for i in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = pred(req, seed=10 + i)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t) * 1e3)
    serve = lm_counts(fl, fb, at)
    serve_peak = torch.cuda.max_memory_allocated() / 2**30
    want = lm_want(bmodel, B, L, H, layers, tag, n_req=3, per_head=per_head)
    check(serve == want, f"{label}: launches over 3 requests {serve}, want {want}")
    check(all(np.isfinite(v).all() for v in out.values()), f"{label}: non-finite output")
    dev = bmodel.device
    args = tuple(torch.from_numpy(req[k]).to(dev) for k in ("input_ids", "attention_mask"))
    with torch.inference_mode():
        lk, _ = bmodel.mc_apply_fused(12345, 10, *args, antithetic=True)
        lp, _ = bmodel.mc_apply_fused(12345, 10, *args, antithetic=True, impl="plain")
    if dtype == BF16:
        note = f32_logits_gate(bt, family, lambda m: m.mc_apply_fused(
            12345, 10, *args, antithetic=True, impl="plain")[0], lk, lp, size, **overrides)
    else:
        err = max_dist(lk, lp)
        check(err <= 1e-4, f"{label}: logits through the kernels differ from the plain "
              f"path by {err} (gate 1e-4)")
        note = f"logits kernels vs plain max|d| {err:.4g} (gate 1e-4)"
    del lk, lp
    serve_ms = float(np.median(lat))
    say(f"{label}: request launches {serve}; {note}; request latency (S=10) median "
        f"{serve_ms:.3f} ms of 3: {[round(v, 3) for v in lat]}; peak memory "
        f"{serve_peak:.2f} GiB")
    del pred
    if not step:
        del named, bmodel
        torch.cuda.empty_cache()
        return serve, serve_ms, None, None
    batch = train_batch(bt, B, L, family=family, vocab=cfg.vocab_size)
    loss_k, mk, gk = grads_of(bt, bmodel, named, 123, batch, "kernel", "antithetic",
                              family=family)
    torch.cuda.empty_cache()  # the kernel step's blocks, before the plain step's
    loss_p, mp, gp = grads_of(bt, bmodel, named, 123, batch, "plain", "antithetic",
                              family=family)
    loss_rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    check(bool(torch.isfinite(loss_k)) and loss_rel <= (1e-6 if dtype == F32 else 1e-2),
          f"{label}: loss kernels {loss_k.item()} vs plain {loss_p.item()}")
    notes = []
    for group, names in grad_groups(list(gk)).items():
        rel, cos, at_ = worst_agreement(gk, gp, names)
        notes.append(f"{group} rel L2 {rel:.4g} cosine {cos:.7f}")
        if dtype == F32:
            check(rel <= 1e-3, f"{label}: {group} gradients differ from the plain f32 "
                  f"step: rel L2 {rel} at {at_}")
        elif group == "rho":
            check(rel <= 5e-2 and cos >= 0.999, f"{label}: rho gradients differ from the "
                  f"plain step: rel L2 {rel}, cosine {cos}")
    del gk, gp
    say(f"{label}: ELBO step loss kernels {loss_k.item():.9g} vs plain {loss_p.item():.9g} "
        f"(rel {loss_rel:.3g}); gradients kernels vs plain: " + "; ".join(notes))
    opt = bt.training.adamw_with_decay_groups(
        2e-5, 0.0, bt.training.default_no_decay).init(named)
    stepf = bt.training.make_elbo_train_step(bmodel, opt, 10, 256, estimator="antithetic",
                                             **loss_keywords(family))
    stepf(55, batch)
    torch.cuda.synchronize()
    reset_counters(fl, fb, at)
    at.PER_HEAD_LAUNCHES.reset()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(n_steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = stepf(1000 + i, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        check(bool(torch.isfinite(m["loss"])), f"{label}: step {i} loss {m['loss']}")
    steps = lm_counts(fl, fb, at)
    want = lm_want(bmodel, B, L, H, layers, tag, n_steps=n_steps, per_head=per_head)
    check(steps == want, f"{label}: launches over {n_steps} steps {steps}, want {want}")
    step_ms = float(np.median(times))
    say(f"{label}: step launches {steps}; ELBO step (S=10) median {step_ms:.3f} ms of "
        f"{n_steps}: "
        f"{[round(v, 3) for v in times]}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del opt, stepf, named, bmodel
    torch.cuda.empty_cache()
    return serve, serve_ms, steps, step_ms


# ---------------------------------------------------------------------------
# Phase 17: wide heads. #3, #4's instance and #5 at head widths 128 and 256,
# and the published models at those widths, Gemma-2B and Mistral-7B (two
# layers each), served and trained
# ---------------------------------------------------------------------------

# the published models (``models/llama.py::PUBLISHED``) by their launch
# paths' prefix: (name, family, batch of the f32 runs). Gemma's f32 runs
# take B = 2: its lm_head's ten f32 draws alone are 21 GB, and at B = 8 the
# f32 logits, log-softmax and their gradient another 10 GB each
WIDE = {"gemma-2b-w256/": ("gemma-2b-w256", GEMMA, 2),
        "mistral-7b-w128/": ("mistral-7b-w128", MISTRAL, 8)}
# one layer each (two until the script's time limit had to hold phase 21):
# every kernel instance and shape of the path runs at one layer as at two
WIDE_LAYERS = 1
# the Bayesian linear kernels' new shapes: each model's FFN and lm_head at
# the 8x128 bucket
FAMILY_SHAPES["gemma-2b-w256/"] = ((1024, 2048, 16384), (1024, 16384, 2048),
                                   (1024, 2048, 256000))
FAMILY_SHAPES["mistral-7b-w128/"] = ((1024, 4096, 14336), (1024, 14336, 4096),
                                     (1024, 4096, 32000))
# the attention shapes of phase 17 by dtype: (N, L, H, heads, causal, the
# rows' paths)
#  * the published models' request and step at L = 128, N = S B (Gemma's f32
#    runs at B = 2), causal, and the non-causal instances there;
#  * the key-tiled walk at each width: the long-context request (B = 1, N =
#    S) at L = 1024 (at D = 256 every L walks);
#  * #4's shapes: H = 256 in 2 heads of 128 or 1 of 256 at L = 1024 (tiny
#    models with 1024 positions, one request), where the reference finds no
#    head group and takes its per-head forward (in bf16; in f32 XLA).
ATTN17 = {
    BF16: ((80, 128, 2048, 8, True, "gemma-2b-w256/anti"),
           (80, 128, 4096, 32, True, "mistral-7b-w128/anti"),
           (80, 128, 2048, 8, False, None), (80, 128, 4096, 32, False, None),
           (10, 1024, 2048, 8, True, "gemma-2b-w256-long"),
           (10, 1024, 4096, 32, True, "mistral-7b-w128-long"),
           (10, 1024, 256, 2, True, "w128-tiny-long"), (10, 1024, 256, 1, True, "w256-tiny-long")),
    F32: ((20, 128, 2048, 8, True, "gemma-2b-w256/anti"),
          (80, 128, 4096, 32, True, "mistral-7b-w128/anti"),
          (20, 128, 2048, 8, False, None), (80, 128, 4096, 32, False, None),
          (10, 1024, 2048, 8, True, None), (10, 1024, 4096, 32, True, None),
          (10, 1024, 256, 2, True, None), (10, 1024, 256, 1, True, None)),
}
# the paths of phase 17 that train (the others serve a request only)
TRAINED17 = ("gemma-2b-w256/anti", "mistral-7b-w128/anti")
# the tiny models at #4's shapes: H = 256 in heads of 128 (Mistral's tiny
# preset at hidden 256) and of 256 (Gemma's, one head), 1024 positions
TINY_LONG17 = {"w128-tiny-long": (MISTRAL, dict(hidden_size=256, num_attention_heads=2,
                                                num_key_value_heads=2,
                                                max_position_embeddings=1024,
                                                sliding_window=1024)),
               "w256-tiny-long": (GEMMA, dict(num_attention_heads=1, num_key_value_heads=1,
                                              head_dim=256, max_position_embeddings=1024))}


def published(bt, name) -> dict:
    """A published model's config overrides at :data:`WIDE_LAYERS` layers."""
    return dict(bt.models.llama.PUBLISHED[name][1], num_hidden_layers=WIDE_LAYERS)


def phase_attention17(at, dtype) -> list[dict]:
    """#3, #4's instance and #5 at head widths 128 and 256 against their
    plain versions at :data:`ATTN17` (:func:`attention_checks`: the gates,
    bit-equal reruns, the planted faults, the score scale of the other
    width among them), and width 96's refusal. Returns the timing rows."""
    for N, L, H, nh, causal, path in ATTN17[dtype]:
        if path and "tiny-long" in path:
            check(at.pallas_route(L, H, nh, 2) == "per_head", f"{path}: not #4's shape")
    rows = attention_checks(at, dtype, ATTN17[dtype], TRAINED17)
    unported_width_raises(at, dtype)
    return rows


def phase17(bt, fl, fb, at, moped_rho, paths) -> tuple[list[dict], dict]:
    """Phase 17 (module note): the wide attention instances, the linear
    kernels at the published models' new shapes (bf16, antithetic), and
    the published models served and trained in bf16 (8x128) and f32 (8x128;
    Gemma 2x128, one step), their long-context requests (1x1024, bf16) and
    #4's tiny models. Fills ``paths``; returns the rows and the request and
    step medians."""
    rows, ms = [], {}

    def timed(label, fn, *args, **kwargs):
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        say(f"phase 17 {label}: {time.perf_counter() - t:.2f} s")
        return out

    for dtype in (BF16, F32):
        rows += timed(f"attention ({TAG[dtype]})", phase_attention17, at, dtype)
    for fam, (name, _, _) in WIDE.items():
        rows += timed(f"bayes_linear {name}", phase_bayes_linear, fl, moped_rho, True, BF16,
                      "on_mu", fam)
        rows += timed(f"reduce {name}", phase_reduce, fl, fb, moped_rho, True, "bf16",
                      "on_mu", fam)
    for dtype in (BF16, F32):
        tag = TAG[dtype]
        for fam, (name, family, b32) in WIDE.items():
            B = 8 if dtype == BF16 else b32
            (paths[f"serve/{fam}anti/{tag}"], ms["request", name, tag],
             paths[f"train/{fam}anti/{tag}"], ms["step", name, tag]) = timed(
                f"{name} ({tag}, {B}x128)", phase_lm_once, bt, fl, fb, at, family, dtype,
                "base", B, 128, True, 1 if B == 2 else 3, **published(bt, name))
    for fam, (name, family, _) in WIDE.items():
        paths[f"serve/{name}-long/bf16"], ms["request", name + "-long", "bf16"], _, _ = timed(
            f"{name} (bf16, 1x1024)", phase_lm_once, bt, fl, fb, at, family, BF16, "base", 1,
            1024, False, **published(bt, name))
    for where, (family, kw) in TINY_LONG17.items():
        paths[f"serve/{where}/bf16"], ms["request", where, "bf16"], _, _ = timed(
            f"{where} (bf16)", phase_lm_once, bt, fl, fb, at, family, BF16, "tiny", 1, 1024,
            False, **kw)
    return rows, ms


# ---------------------------------------------------------------------------
# Phase 18: BERT's sibling families (DistilBERT, RoBERTa, Electra, ALBERT)
# and the SQuAD QA path at base width
# ---------------------------------------------------------------------------

# SQuAD's recipe: batch 13 of 384 tokens, S = 10; the f32 step in chunks of 2
SQUAD_B, SQUAD_L, SQUAD_CHUNK = 13, 384, 2
SQUAD_M = SQUAD_B * SQUAD_L
# the linear kernels' new shapes: the QA head (768 -> 2) at SQuAD's M, and
# ALBERT's 128 -> 768 embedding mapping at the 8x128 bucket
FAMILY_SHAPES["squad/"] = ((SQUAD_M, 768, 2),)
FAMILY_SHAPES["albert/"] = ((1024, 128, 768),)
# the encoders of phase 18, served (8x128) and trained at base width and
# 6 layers each (:data:`ENCODER_DEPTH18`): DistilBERT's own depth, ALBERT's
# one layer 6 times, RoBERTa's and Electra's 6 of 12
ENCODERS18 = ("distilbert", "albert", "roberta", "electra")


# phase 18's depth cut (for the script's time limit): every encoder at 6
# layers (DistilBERT's own depth; BERT's QA path, RoBERTa's, Electra's and
# ALBERT's shared layer at 6 of 12), the base widths kept
ENCODER_DEPTH18 = 6


def encoder_base(bt, family, task, dtype):
    """An encoder of ``family`` at its base preset (:data:`ENCODER_DEPTH18`
    layers) from seed 0 for ``task``, frozen MOPED 0.05
    (``to_bayesian(delta=0.05, freeze=True)``), in ``dtype`` activations,
    and its trainable tensors."""
    from bayeformers_tpu_torch.models import families

    model = families.build_family(family, task, size="base", seed=0, dtype=dtype,
                                  device="cuda", num_hidden_layers=ENCODER_DEPTH18)
    bmodel = bt.to_bayesian(model, delta=0.05, freeze=True)
    return bmodel, bmodel.trainable_parameters()


def encoder_inputs(cfg, task, B, L, seed, lengths=None) -> dict:
    """A seeded batch of the encoder's vocabulary: ids past the special ones,
    right padding (``pad_token_id`` ids, mask 0) in half the rows unless
    ``lengths`` gives each row's live length, with labels (classification)
    or start and end positions inside each row's live tokens (qa)."""
    rng = np.random.default_rng(seed)
    if lengths is None:
        lengths = np.where(np.arange(B) < B // 2, L, L - L // 4)
    ids = rng.integers(4, cfg.vocab_size, (B, L))
    mask = (np.arange(L)[None] < np.asarray(lengths)[:, None]).astype(np.int64)
    ids = np.where(mask > 0, ids, cfg.pad_token_id)
    out = {"input_ids": ids, "attention_mask": mask,
           "token_type_ids": np.zeros((B, L), np.int64)}
    if task == "classification":
        out["labels"] = rng.integers(0, 2, (B,))
    else:
        live = np.maximum(np.asarray(lengths), 2)
        start = (rng.random(B) * (live - 1)).astype(np.int64)
        out["start_positions"] = start
        out["end_positions"] = np.minimum(start + rng.integers(0, 8, (B,)), live - 1)
    return out


def encoder_requests(cfg, task) -> list[dict]:
    """Three ragged requests of the encoder's bucket: for classification
    3x77, 8x128 and 5x20 tokens; for qa 13x384 (rows of 384, 300 and 90
    live tokens), 5x250 and 9x384."""
    if task == "classification":
        shapes = ((3, 77, None), (8, 128, None), (5, 20, None))
    else:
        shapes = ((SQUAD_B, SQUAD_L, [384, 300, 90] * 4 + [384]), (5, 250, None),
                  (9, 384, None))
    return [{k: v for k, v in encoder_inputs(cfg, task, B, L, 20 + i, lens).items()
             if k in ("input_ids", "attention_mask", "token_type_ids")}
            for i, (B, L, lens) in enumerate(shapes)]


def encoder_want(bmodel, B, L, tag, anti, n_req=0, n_steps=0, chunk=None) -> dict:
    """The launches of ``n_req`` requests (S = 10) or ``n_steps`` steps (in
    chunks of ``chunk`` samples) of a converted encoder at (B, L): the
    forward kernel (and the reduce a step) once a call of a converted
    kernel, at M = B L, or M = B on the first token (poolers and
    classification heads), ALBERT's shared leaves once a repetition; mha
    once a layer (a repetition) a forward, and its backward a step; #10's
    pair instance in an f32 antithetic step once a call of a layer whose K
    rounds up above 2048 (``fused_linear.takes_regen_vjp``)."""
    from bayeformers_tpu_torch.ops import common
    from bayeformers_tpu_torch.ops import fused_linear as fl

    cfg = bmodel.model.config
    S = 10
    n_chunks, Sc = (1, S) if chunk is None else (S // chunk, chunk)
    n = n_req + n_steps * n_chunks
    fwd, red, regen = {}, {}, {}
    for p in bmodel.spec.paths:
        if not p.endswith("/kernel"):
            continue
        K, N = bmodel.rho[p].shape
        calls = cfg.num_hidden_layers if "albert_layer_groups" in p else 1
        first = p.startswith(("classifier", "pre_classifier")) or "pooler" in p
        key = (B if first else B * L, K, N, tag)
        fwd[key] = fwd.get(key, 0) + calls * n
        if n_steps:
            red[key] = red.get(key, 0) + calls * n_steps * n_chunks
            if tag == "f32" and anti and common.round_up(K, common.UNIT_K) > \
                    fl.ANTI_F32_SAVED_MAX_KP:
                rk = (Sc // 2, K, N, "pair")
                regen[rk] = regen.get(rk, 0) + calls * n_steps * n_chunks
    akey = ((Sc if n_steps else S) * B, L, cfg.hidden_size, tag, False)
    want = {"bayes_linear_anti" if anti else "bayes_linear": fwd,
            "mha_fwd": {akey: cfg.num_hidden_layers * n}}
    if n_steps:
        want["reduce_abuv_anti" if anti else "reduce_abuv"] = red
        want["mha_bwd"] = {akey: cfg.num_hidden_layers * n_steps * n_chunks}
        if regen:
            want["regen"] = regen
    return want


def encoder_forward(bmodel, anti, args, impl="kernel"):
    """The fused forward's outputs at a fixed seed, the start and end logits
    of a span head concatenated."""
    with torch.inference_mode():
        out, _ = bmodel.mc_apply_fused(12345, 10, **args, antithetic=anti, impl=impl)
    return torch.cat(out, dim=-1) if isinstance(out, tuple) else out


def encoder_logits_gate(bt, family, task, anti, args, lk, lp) -> str:
    """bf16 logits through the kernels no farther from the f32 plain run
    (the same weights and draws) than 1.5x the bf16 plain path's, in max
    |d| and in relative L2 (:func:`f32_logits_gate`'s rule)."""
    m32, _ = encoder_base(bt, family, task, F32)
    l32 = encoder_forward(m32, anti, args, "plain").float()
    del m32

    def dist(a):
        d = a.float() - l32
        return d.abs().max().item(), (d.norm() / l32.norm()).item()

    (kd, kr), (pd, pr) = dist(lk), dist(lp)
    check(kd <= 1.5 * pd and kr <= 1.5 * pr,
          f"{family} {task} bf16 logits: the kernels are farther from the f32 plain run "
          f"(max|d| {kd}, rel L2 {kr}) than 1.5x the bf16 plain path (max|d| {pd}, rel L2 "
          f"{pr})")
    torch.cuda.empty_cache()
    return (f"logits against the f32 plain run: kernels max|d| {kd:.4g} rel L2 {kr:.4g}, "
            f"bf16 plain max|d| {pd:.4g} rel L2 {pr:.4g} (gate 1.5x); kernels vs bf16 "
            f"plain max|d| {max_dist(lk, lp):.4g}")


def spans_check(pred, lk, lp, mask, n) -> str:
    """The n-best spans decoded from the kernels' start and end logits
    against the plain path's: each row's best span scores, under the plain
    path's probabilities, within 0.05 nats of the plain path's own best."""
    from bayeformers_tpu_torch.serving import summarize_qa

    L = mask.shape[1]
    res = []
    for logits in (lk, lp):
        out = summarize_qa(logits[..., :L].float(), logits[..., L:].float(), mask)
        out = {k: v.cpu().numpy()[:n] for k, v in out.items()}
        res.append((out, pred._decode_spans(out, n, None, None)))
    (_, sk), (op, sp) = res
    ls = np.log(np.clip(op["start_probs"], 1e-12, None))
    le = np.log(np.clip(op["end_probs"], 1e-12, None))
    worst, same = 0.0, 0
    for i in range(n):
        best_k, best_p = sk[i][0], sp[i][0]
        check(np.isfinite(best_k["score"]), f"row {i}: span score {best_k['score']}")
        got = ls[i, best_k["start"]] + le[i, best_k["end"]]
        worst = max(worst, best_p["score"] - got)
        same += (best_k["start"], best_k["end"]) == (best_p["start"], best_p["end"])
    check(worst <= 0.05, f"a row's best span through the kernels scores {worst} nats "
          "below the plain path's best under the plain probabilities")
    return (f"best spans: {same} of {n} rows the plain path's span, the others within "
            f"{worst:.3g} nats of its score")


def serve_encoder(bt, fl, fb, at, family, task, anti, dtype=BF16):
    """A converted encoder of ``family`` at base width served by
    ``Predictor(task=task)``: a warm-up, then three ragged requests with the
    launch counts read around exactly them (:func:`encoder_want`), the
    summaries finite (qa: each row's n-best spans), the logits through the
    kernels against the plain path's (:func:`encoder_logits_gate`; qa: the
    spans too, :func:`spans_check`), the latency and the peak memory.
    Returns (launches, median ms)."""
    bmodel, named = encoder_base(bt, family, task, dtype)
    del named
    cfg = bmodel.model.config
    B, L = (SQUAD_B, SQUAD_L) if task == "qa" else (8, 128)
    label = f"{family}-base {task} ({'antithetic' if anti else 'independent'}, {TAG[dtype]})"
    pred = bt.Predictor(bmodel, n_samples=10, batch_sizes=(B,), seq_lens=(L,),
                        antithetic=anti, task=task)
    reqs = encoder_requests(cfg, task)
    pred(reqs[0], seed=1)
    torch.cuda.synchronize()
    reset_counters(fl, fb, at)
    torch.cuda.reset_peak_memory_stats()
    lat, outs = [], []
    for i, r in enumerate(reqs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        outs.append(pred(r, seed=10 + i))
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t) * 1e3)
    counts = lm_counts(fl, fb, at)
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = encoder_want(bmodel, B, L, TAG[dtype], anti, n_req=3)
    check(counts == want, f"{label}: launches over 3 requests {counts}, want {want}")
    for r, o in zip(reqs, outs):
        n, Lr = r["input_ids"].shape
        for k, v in o.items():
            if k != "spans":
                check(np.isfinite(v).all(), f"{label}: {k} not finite")
        if task == "qa":
            check(o["start_probs"].shape == (n, Lr) and o["end_logp_draws"].shape ==
                  (n, 10, Lr) and len(o["spans"]) == n, f"{label}: shapes")
            check(all(len(sp) == pred.n_best for sp in o["spans"]), f"{label}: n-best")
    dev = bmodel.device
    keys = pred.input_keys
    req = reqs[0]
    args = {k: torch.from_numpy(np.pad(req[k], ((0, B - req[k].shape[0]),
                                                (0, L - req[k].shape[1])))).to(dev)
            for k in keys}
    lk = encoder_forward(bmodel, anti, args)
    lp = encoder_forward(bmodel, anti, args, "plain")
    note = encoder_logits_gate(bt, family, task, anti, args, lk, lp)
    if task == "qa":
        note += "; " + spans_check(pred, lk, lp, args["attention_mask"],
                                   req["input_ids"].shape[0])
    ms = float(np.median(lat))
    say(f"{label}: launches over 3 requests {counts}; {note}; request latency (S=10, "
        f"{B}x{L}) median {ms:.3f} ms of 3: {[round(v, 3) for v in lat]}; peak memory "
        f"{peak:.2f} GiB")
    del pred, bmodel, lk, lp
    torch.cuda.empty_cache()
    return counts, ms


def vanishing_leaf(bmodel):
    """The trainable leaf whose gradient a span head makes vanish: the last
    layer's output LayerNorm bias shifts every position's start (and end)
    logit alike, and the CE's softmax over positions ignores a shift, so
    its gradient sums terms that cancel to 0. None for a classification
    head, and for ALBERT, whose one LayerNorm serves every repetition."""
    model = bmodel.model
    n = model.config.num_hidden_layers - 1
    fam = model.family
    if model.task != "qa" or fam == "albert":
        return None
    if fam == "distilbert":
        return f"params/distilbert/transformer/layer/{n}/output_layer_norm/bias"
    return f"params/{fam}/encoder/layer/{n}/output/LayerNorm/bias"


def chunked_grads(bt, bmodel, named, seed, batch, impl, estimator, chunk, task, keys):
    """Loss and gradients of the ELBO objective as ``make_elbo_train_step``
    accumulates it in chunks of ``chunk`` samples (None: all S = 10), at
    the draws of ``seed``."""
    from bayeformers_tpu_torch.nn.fused import derive_seed

    loss_fn = (bt.training.qa_span_loss if task == "qa"
               else bt.training.classification_loss)
    n_chunks, Sc = (1, 10) if chunk is None else (10 // chunk, chunk)
    mc = bt.training.pick_mc(bmodel, True, estimator)
    for _, t, _ in named:
        t.grad = None
    total = 0.0
    for c in range(n_chunks):
        loss, _ = bt.training.elbo_objective(
            mc, seed if n_chunks == 1 else derive_seed(seed, c), Sc, batch, 256, loss_fn,
            keys, impl=impl)
        loss.backward()
        total += loss.item()
    return total / n_chunks, {n: t.grad.clone() / n_chunks for n, t, _ in named}


@contextlib.contextmanager
def in_f64(bmodel):
    """``bmodel``'s model, rho and prior means in f64, and ``Tensor.float()``
    a no-op on f64 tensors, so that the plain path's f32 casts keep f64
    (its eps stream stays the f32 one: the same draws); ``float`` is
    restored on exit, the model stays in f64."""
    bmodel.model.double()
    for m in bmodel.model.modules():
        if getattr(m, "dtype", None) == F32:
            m.dtype = torch.float64
    for d in (bmodel.rho, bmodel.prior_mu):
        for t in d.values():
            t.data = t.data.double()
    orig = torch.Tensor.float
    torch.Tensor.float = lambda t, *a, **k: t if t.dtype == torch.float64 else orig(t, *a, **k)
    try:
        yield
    finally:
        torch.Tensor.float = orig


def check_f32_leaves(label, group, gk, gp, exact, names, top, notes) -> list[str]:
    """An f32 step's gradients through the kernels (``gk``) against the
    plain f32 step's (``gp``) and the plain step's in f64 at the same
    draws (``exact``): each leaf within 1e-3 of the f64 gradient's norm
    plus twice the plain f32 step's own distance from it (L2), so a leaf
    whose sum cancels, where f32 rounding on any path is larger, is
    allowed what the plain path's rounding shows and no more. Adds the
    distances of leaves past 5e-4 or with a plain distance past 1e-4 to
    ``notes`` (norms as shares of the group's largest, ``top``); returns
    the failures."""
    failed = []
    for n in names:
        x, y, z = gk[n].double(), gp[n].double(), exact[n]
        norm = z.norm().item()
        ek, ep = (x - z).norm().item(), (y - z).norm().item()
        bound = 1e-3 * norm + 2 * ep
        if ek > 5e-4 * norm or ep > 1e-4 * norm:
            notes.append(f"{n}: norm {norm / top:.3g} of its group's largest; from the f64 "
                         f"step kernels {ek / max(norm, 1e-300):.3g}, plain "
                         f"{ep / max(norm, 1e-300):.3g}, kernels vs plain "
                         f"{(x - y).norm().item() / y.norm().item():.3g}")
        if ek > bound:
            failed.append(f"{label}: {group} gradient of {n} is {ek} from the f64 plain step, "
                          f"over its bound {bound} (1e-3 of its norm {norm} and twice the "
                          f"plain f32 step's {ep})")
    return failed


def train_encoder(bt, fl, fb, at, family, task, dtype, estimator="antithetic", chunk=None,
                  n_steps=2, compare=True):
    """The ELBO step of a converted encoder at base width (qa: S = 10, B =
    13, L = 384 with ``qa_span_loss``; classification: 8x128): with
    ``compare``, its loss and gradients through the kernels against the
    plain step's at the same draws (bf16: loss 1e-2 relative, rho 5e-2
    relative L2 and cosine 0.999; f32: loss 1e-6, each leaf against the
    plain step's in f64 by :func:`check_f32_leaves`), then
    ``n_steps`` timed steps with the launch counts read around exactly them
    and the peak memory. Returns (launches, median ms, peak GiB)."""
    from bayeformers_tpu_torch.models import families

    bmodel, named = encoder_base(bt, family, task, dtype)
    cfg = bmodel.model.config
    anti = estimator == "antithetic"
    tag = TAG[dtype]
    B, L = (SQUAD_B, SQUAD_L) if task == "qa" else (8, 128)
    label = (f"{family}-base {task} step ({estimator}, {tag}"
             + (f", mc_chunk={chunk}" if chunk else "") + ")")
    keys = families.input_keys(bmodel.model)
    batch = {k: torch.from_numpy(v).cuda() for k, v in encoder_inputs(cfg, task, B, L, 7).items()}
    notes = []
    if compare:
        loss_k, gk = chunked_grads(bt, bmodel, named, 123, batch, "kernel", estimator, chunk,
                                   task, keys)
        torch.cuda.empty_cache()
        loss_p, gp = chunked_grads(bt, bmodel, named, 123, batch, "plain", estimator, chunk,
                                   task, keys)
        loss_rel = abs(loss_k - loss_p) / abs(loss_p)
        check(np.isfinite(loss_k) and loss_rel <= (1e-6 if dtype == F32 else 1e-2),
              f"{label}: loss kernels {loss_k} vs plain {loss_p}")
        exact, failed = None, []
        if dtype == F32:
            # the plain step in f64 at the same draws: the sums that both
            # f32 paths round
            torch.cuda.empty_cache()
            b64, _ = encoder_base(bt, family, task, F32)
            with in_f64(b64):
                _, exact = chunked_grads(bt, b64, b64.trainable_parameters(), 123, batch,
                                         "plain", estimator, chunk, task, keys)
            del b64
        for group, names in grad_groups(list(gk)).items():
            # a span head's logits move with the last LayerNorm's bias alike
            # at every position, which the CE's softmax over positions
            # ignores: that gradient is 0 in exact arithmetic, and each step
            # holds only its own roundoff of the cancelling sum (read; in
            # f32 held to twice the plain step's roundoff)
            quiet = [n for n in names if n == vanishing_leaf(bmodel)]
            top = max(gp[m].double().norm().item() for m in names)
            for n in quiet:
                rk, rp, r64 = (g[n].double().norm().item() / top
                               for g in (gk, gp, exact if exact else gp))
                notes.append(f"{n} (0 in exact arithmetic): norm {rk:.3g} (kernels), "
                             f"{rp:.3g} (plain)" + (f", {r64:.3g} (f64)" if exact else "")
                             + " of its group's largest")
            names = [n for n in names if n not in quiet]
            if dtype == F32:
                failed += check_f32_leaves(label, group, gk, gp, exact, quiet, top, [])
                failed += check_f32_leaves(label, group, gk, gp, exact, names, top, notes)
            rel, cos, at_ = worst_agreement(gk, gp, names)
            notes.append(f"{group} rel L2 {rel:.4g} (worst leaf, {at_}), cosine {cos:.7f}")
            if group == "rho" and dtype != F32:
                check(rel <= 5e-2 and cos >= 0.999, f"{label}: rho gradients differ from "
                      f"the plain step: rel L2 {rel}, cosine {cos}")
        say(f"{label}: loss kernels {loss_k:.9g} vs plain {loss_p:.9g} (rel {loss_rel:.3g}); "
            "gradients kernels vs plain: " + "; ".join(notes))
        check(not failed, "; ".join(failed))
        del gk, gp, exact
        torch.cuda.empty_cache()
    opt = bt.training.adamw_with_decay_groups(
        2e-5, 0.0, bt.training.default_no_decay).init(named)
    loss_fn = (bt.training.qa_span_loss if task == "qa"
               else bt.training.classification_loss)
    stepf = bt.training.make_elbo_train_step(bmodel, opt, 10, 256, loss_fn=loss_fn,
                                             input_keys=keys, estimator=estimator,
                                             mc_chunk=chunk)
    stepf(55, batch)
    torch.cuda.synchronize()
    reset_counters(fl, fb, at)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(n_steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = stepf(1000 + i, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        check(bool(torch.isfinite(m["loss"])), f"{label}: step {i} loss {m['loss']}")
    counts = lm_counts(fl, fb, at)
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = encoder_want(bmodel, B, L, tag, anti, n_steps=n_steps, chunk=chunk)
    check(counts == want, f"{label}: launches over {n_steps} steps {counts}, want {want}")
    ms = float(np.median(times))
    say(f"{label}: launches over {n_steps} steps {counts}; ELBO step median {ms:.3f} ms of "
        f"{n_steps}: {[round(v, 3) for v in times]}; peak memory {peak:.2f} GiB")
    del opt, stepf, named, bmodel
    torch.cuda.empty_cache()
    return counts, ms, peak


def ragged_mask(N, L, seed):
    """(N, L) right-padded keep-mask with each row's live length drawn from
    [1, L]: rows of 1, 2 and 3 live keys, one of 100 (two whole 128-key
    tiles masked at L = 384), one fully masked row (a bucket's padded
    row), the last."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, L + 1, N)
    lengths[:4] = (1, 2, 3, 100)
    lengths[N - 1] = 0
    mask = np.arange(L)[None] < lengths[:, None]
    return torch.from_numpy(mask.astype(np.float32)).cuda()


def squad_mask_checks(at, dtype, N=130, L=SQUAD_L, H=768, nh=12) -> str:
    """#3 and #5 at SQuAD's shape under ragged right padding
    (:func:`ragged_mask`) with the key bias of ``mask_to_bias``
    (``finfo.min``) and with DistilBERT's ``-1e30 * (1 - mask)``: the
    attention gates against the plain versions on the same bias, the fully
    masked row finite and uniform over all L keys, bit-equal reruns, and a
    planted fault that must fail the gates (the plain version's mask one
    column off: each row one more live key)."""
    from bayeformers_tpu_torch.models.families import distilbert_bias

    gen = torch.Generator(device="cuda").manual_seed(18)
    q, k, v, g = (torch.randn(N, L, H, device="cuda", generator=gen).to(dtype)
                  for _ in range(4))
    mask = ragged_mask(N, L, 18)
    shifted = mask.clone()
    shifted[:, 1:] = torch.maximum(mask[:, 1:], mask[:, :-1])
    shifted[N - 1] = 0
    tol = 1e-4 if dtype == F32 else 2e-2
    notes = []
    for name, fn in (("finfo.min", at.mask_to_bias), ("-1e30", distilbert_bias)):
        bias = fn(mask).contiguous()
        out = at.mha_cuda(q, k, v, bias, nh)
        again = at.mha_cuda(q, k, v, bias, nh)
        grads = at.mha_bwd_cuda(q, k, v, bias, g, nh)
        grads2 = at.mha_bwd_cuda(q, k, v, bias, g, nh)
        ref = at.mha_plain(q, k, v, bias, nh)
        gref = at.mha_bwd_plain(q, k, v, bias, g, nh)
        what = f"mha ({TAG[dtype]}) N={N} L={L} ragged keys, bias {name}"
        check(attn_gate_ok(out, ref, dtype), f"{what}: forward max|d| {max_dist(out, ref)}")
        for gn, a, r in zip(("dq", "dk", "dv"), grads, gref):
            check(bool(torch.isfinite(a.float()).all()) and attn_gate_ok(a, r, dtype, True),
                  f"{what}: {gn} max|d| {max_dist(a, r)}")
        check(torch.equal(out, again) and all(torch.equal(a, b) for a, b in zip(grads, grads2)),
              f"{what}: reruns differ")
        uni = max_dist(out[N - 1], v.float().mean(1)[N - 1].expand(L, H))
        check(bool(torch.isfinite(out.float()).all()) and uni <= tol,
              f"{what}: the fully masked row is not uniform over L: {uni}")
        fault = at.mha_plain(q, k, v, fn(shifted).contiguous(), nh)
        check(not attn_gate_ok(out, fault, dtype), f"{what}: the plain mask one column off "
              f"passes the gate: max|d| {max_dist(out, fault)}")
        notes.append(f"bias {name}: fwd max|d| {max_dist(out, ref):.3g}, dq/dk/dv max|d| "
                     + "/".join(f"{max_dist(a, r):.3g}" for a, r in zip(grads, gref))
                     + f", masked row uniform within {uni:.3g}, reruns equal, mask one "
                     f"column off max|d| {max_dist(out, fault):.3g} (fails)")
        del out, again, grads, grads2, ref, gref, fault
    torch.cuda.empty_cache()
    return f"mha ({TAG[dtype]}) N={N} L={L} ragged right padding: " + "; ".join(notes)


def phase_workload18(fl, fb, at) -> str:
    """``workloads/bert_squad.train`` (BERT-base QA, synthetic SQuAD, S =
    10, batch 13 of 384) and ``bert_glue --model distilbert-base-uncased``,
    phases A-D for three batches an epoch in bf16: finite scores, and each
    launched the antithetic forward, the reduce and both attention
    kernels."""
    from bayeformers_tpu_torch.workloads import bert_glue, bert_squad

    notes = []
    for name, run in (
            ("bert_squad", lambda logs: bert_squad.train(
                size="base", limit_batches=3, epochs=1, b_epochs=1, bf16=True, logs=logs,
                samples=10)),
            ("bert_glue distilbert-base-uncased", lambda logs: bert_glue.train(
                model_name="distilbert-base-uncased", size="base", limit_batches=3,
                epochs=1, b_epochs=1, bf16=True, logs=logs, samples=10))):
        reset_counters(fl, fb, at)
        t = time.perf_counter()
        with tempfile.TemporaryDirectory() as logs:
            score = run(logs)
        counts = {c.name: c.count for c in (fl.LAUNCHES, fb.LAUNCHES, at.LAUNCHES,
                                             at.BWD_LAUNCHES)}
        check(np.isfinite(score) and all(counts.values()),
              f"{name}: score {score}, launches {counts}")
        notes.append(f"{name}: score {score:.4f}, launches {counts}, "
                     f"{time.perf_counter() - t:.1f} s")
    return "workloads (bf16, S=10, 3 batches an epoch): " + "; ".join(notes)


def phase18(bt, fl, fb, at, moped_rho, paths) -> tuple[list[dict], dict]:
    """Phase 18 (module note): SQuAD's attention, the linear kernels at the
    new shapes, BERT-base QA served and trained, the four sibling families
    at base width, and the two workloads. Fills ``paths``; returns the
    rows and the request and step medians (with peaks)."""
    rows, ms = [], {}

    def timed(label, fn, *args, **kwargs):
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        say(f"phase 18 {label}: {time.perf_counter() - t:.2f} s")
        return out

    rows += timed("attention (bf16)", attention_checks, at, BF16,
                  ((SQUAD_B * 10, SQUAD_L, 768, 12, False, "squad/anti"),))
    rows += timed("attention (f32)", attention_checks, at, F32,
                  ((SQUAD_B * 10, SQUAD_L, 768, 12, False, None),
                   (SQUAD_B * SQUAD_CHUNK, SQUAD_L, 768, 12, False, "squad/chunk2")))
    for dtype in (BF16, F32):
        say(timed(f"ragged masks ({TAG[dtype]})", squad_mask_checks, at, dtype))
    for anti in (True, False):
        rows += timed(f"bayes_linear squad ({anti})", phase_bayes_linear, fl, moped_rho,
                      anti, BF16, "on_mu", "squad/")
        rows += timed(f"reduce squad ({anti})", phase_reduce, fl, fb, moped_rho, anti,
                      "bf16", "on_mu", "squad/")
    rows += timed("bayes_linear albert", phase_bayes_linear, fl, moped_rho, True, BF16,
                  "on_mu", "albert/")
    rows += timed("reduce albert", phase_reduce, fl, fb, moped_rho, True, "bf16", "on_mu",
                  "albert/")
    # BERT-base QA: requests under both estimators, the antithetic bf16 step,
    # the independent one, and the f32 step in chunks of two
    for anti, key in ((True, "anti"), (False, "indep")):
        paths[f"serve/squad/{key}/bf16"], ms["request", "bert-qa", key] = timed(
            f"serve bert qa ({key})", serve_encoder, bt, fl, fb, at, "bert", "qa", anti)
    counts, step_ms, peak = timed("train bert qa (antithetic, bf16)", train_encoder, bt,
                                  fl, fb, at, "bert", "qa", BF16)
    paths["train/squad/anti/bf16"], ms["step", "bert-qa", "anti"] = counts, step_ms
    ms["peak", "bert-qa", "bf16"] = peak
    paths["train/squad/indep/bf16"], ms["step", "bert-qa", "indep"], _ = timed(
        "train bert qa (independent, bf16)", train_encoder, bt, fl, fb, at, "bert", "qa",
        BF16, "fused", None, 1, False)
    counts, step_ms, peak = timed("train bert qa (antithetic, f32, mc_chunk=2)",
                                  train_encoder, bt, fl, fb, at, "bert", "qa", F32,
                                  "antithetic", SQUAD_CHUNK, 1)
    paths["serve/squad/chunk2/f32"] = paths["train/squad/chunk2/f32"] = counts
    ms["step", "bert-qa", "f32-chunk2"], ms["peak", "bert-qa", "f32"] = step_ms, peak
    for fam in ENCODERS18:
        paths[f"serve/{fam}/anti/bf16"], ms["request", fam, "anti"] = timed(
            f"serve {fam}", serve_encoder, bt, fl, fb, at, fam, "classification", True)
        paths[f"train/{fam}/anti/bf16"], ms["step", fam, "anti"], _ = timed(
            f"train {fam}", train_encoder, bt, fl, fb, at, fam, "classification", BF16)
    say(timed("workloads", phase_workload18, fl, fb, at))
    return rows, ms


# ---------------------------------------------------------------------------
# Phase 19: the recipes' file front end (tokenizers, GLUE TSVs, checkpoints,
# predict_texts) and the hand-built BayesLinear MLP
# ---------------------------------------------------------------------------

# the reference MNIST MLP's layers at batch 64 (M = 64 a draw, S = 10), and
# at its evaluation, which takes the whole test set (MNIST's 10000 images)
# in one call
MLP, MLP_EVAL = "mlp/", "mlp-eval/"
MLP_WIDTHS = (784, 512, 512, 10)
MNIST_TEST = 10000
FAMILY_SHAPES[MLP] = tuple((64, k, n) for k, n in zip(MLP_WIDTHS[:-1], MLP_WIDTHS[1:]))
FAMILY_SHAPES[MLP_EVAL] = tuple((MNIST_TEST, k, n) for _, k, n in FAMILY_SHAPES[MLP])
WORDS19 = ("the", "a", "cat", "dog", "sat", "on", "mat", "ran", "fast", "slow", "book",
           "was", "written", "by", "in", "london", "paris", "today", "said", "went",
           "home", "it", "is", "not", ".", ",", "##s", "##ed")


def write_glue_files(root) -> tuple[str, str]:
    """An MRPC-style task directory (``train.tsv``, ``dev.tsv``: quality, two
    ids, two sentences) and a ``vocab.txt`` laid out as BERT's ([PAD] 0,
    [UNK] 100, [CLS] 101, [SEP] 102), from a seed."""
    rng = np.random.default_rng(19)
    vocab = os.path.join(root, "vocab.txt")
    with open(vocab, "w") as fh:
        fh.write("\n".join(["[PAD]"] + [f"[unused{i}]" for i in range(99)]
                           + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"] + list(WORDS19)))
    words = [w for w in WORDS19 if not w.startswith("#")] + ["zebra", "cats", "walked"]
    data = os.path.join(root, "mrpc")
    os.makedirs(data)
    for name, n in (("train.tsv", 64), ("dev.tsv", 16)):
        rows = ["Quality\t#1 ID\t#2 ID\t#1 String\t#2 String"]
        for i in range(n):
            a, b = (" ".join(rng.choice(words, size=rng.integers(4, 30)).tolist())
                    for _ in range(2))
            rows.append(f"{rng.integers(0, 2)}\t{i}\t{i + n}\t{a}\t{b}")
        with open(os.path.join(data, name), "w") as fh:
            fh.write("\n".join(rows) + "\n")
    return data, vocab


def write_mnist_files(root, n_train=256, n_test=MNIST_TEST) -> str:
    """The four MNIST idx files (uint8 images and labels) from a seed."""
    rng = np.random.default_rng(19)
    for stem, n in (("train", n_train), ("t10k", n_test)):
        for kind, arr in (("images-idx3", rng.integers(0, 256, (n, 28, 28))),
                          ("labels-idx1", rng.integers(0, 10, n))):
            arr = arr.astype(np.uint8)
            with open(os.path.join(root, f"{stem}-{kind}-ubyte"), "wb") as fh:
                fh.write(bytes([0, 0, 0x08, arr.ndim]))
                fh.write(np.asarray(arr.shape, ">u4").tobytes())
                fh.write(arr.tobytes())
    return root


def leaves(bmodel) -> dict:
    """A converted model's parameters, rho and prior_mu on the CPU, keyed as
    the checkpoint's files key them."""
    out = {("params", n.replace(".", "/")): p.detach().cpu().clone()
           for n, p in bmodel.model.named_parameters()}
    out.update({("rho", k): v.detach().cpu().clone() for k, v in bmodel.rho.items()})
    out.update({("prior_mu", k): v.detach().cpu().clone()
                for k, v in bmodel.prior_mu.items()})
    return out


def phase_glue_files(bt, fl, fb, at, root) -> dict:
    """(a) ``bert_glue`` at BERT-base from MRPC TSVs and a vocab.txt
    (frozen MOPED 0.05, S=10 antithetic, bf16, 8x128, three batches an
    epoch) with ``--save-dir``, whose file must hold the state the run
    trained, bit for bit; then ``--resume``: the resumed run lands past the
    last epoch, and the leaves it restores must equal the saved ones bit
    for bit. Returns the first run's launches (the slice's main
    path: the antithetic forward, reduce and attention kernels)."""
    from bayeformers_tpu_torch.utils import checkpoint as ckpt
    from bayeformers_tpu_torch.workloads import bert_glue

    data, vocab = write_glue_files(root)
    kw = dict(data=data, vocab=vocab, task="mrpc", size="base", bf16=True, samples=10,
              epochs=1, b_epochs=1, limit_batches=3, logs=os.path.join(root, "logs"),
              save_dir=os.path.join(root, "ckpt"))
    saves, save = [], ckpt.save_checkpoint

    def capture_save(directory, bmodel, **kw):
        saves.append((bmodel, leaves(bmodel)))
        return save(directory, bmodel, **kw)

    ckpt.save_checkpoint = capture_save
    reset_counters(fl, fb, at)
    try:
        score = bert_glue.train(**kw)
    finally:
        ckpt.save_checkpoint = save
    counts = {c.name: dict(c.by_shape) for c in (fl.LAUNCHES, fb.LAUNCHES, at.LAUNCHES,
                                                  at.BWD_LAUNCHES)}
    check(np.isfinite(score) and all(counts.values()),
          f"bert_glue from TSVs: score {score}, launches {counts}")
    check(ckpt.latest_step(kw["save_dir"]) == 1, "bert_glue --save-dir wrote no step_1")
    saved = {(part, k): v for part in ckpt.PARTS for k, v in torch.load(
        os.path.join(kw["save_dir"], "step_1", f"{part}.pt"), weights_only=True).items()}
    # the file holds the state the run handed to the save and ended with
    # (its epoch's steps taken), bit for bit
    check(len(saves) == 1, f"bert_glue --save-dir saved {len(saves)} times, want 1")
    at_save, final = saves[0][1], leaves(saves[0][0])
    check(set(at_save) == set(final) == set(saved)
          and all(torch.equal(at_save[k], v) and torch.equal(final[k], v)
                  for k, v in saved.items()),
          "bert_glue --save-dir: step_1 differs from the state the run trained")
    restored = []
    load = ckpt.load_checkpoint

    def capture(directory, bmodel, step=0):
        out = load(directory, bmodel, step=step)
        restored.append(leaves(bmodel))
        return out

    ckpt.load_checkpoint = capture
    try:
        resumed = bert_glue.train(resume=True, **kw)
    finally:
        ckpt.load_checkpoint = load
    check(len(restored) == 1 and set(restored[0]) == set(saved),
          "bert_glue --resume restored another set of leaves")
    differ = [k for k, v in saved.items() if not torch.equal(restored[0][k], v)]
    check(not differ, f"bert_glue --resume: restored leaves differ from the saved: {differ[:5]}")
    check(np.isfinite(resumed), f"bert_glue --resume score {resumed}")
    n_rows = {"train": 64, "dev": 16}
    say(f"phase 19 (a): bert_glue at BERT-base from MRPC TSVs ({n_rows}) and a vocab.txt, "
        f"S=10 antithetic bf16, 3 batches: score {score:.4f}; step_1 equal to the trained "
        f"state; --resume past the last epoch: "
        f"{len(saved)} leaves restored bit-equal, score {resumed:.4f}; launches "
        f"{ {k: sum(v.values()) for k, v in counts.items()} }")
    return counts


def phase_texts(bt, fl, at, vocab) -> dict:
    """(b) ``Predictor.warmup`` on BERT-base (frozen MOPED, S=10 antithetic,
    bf16, the (8, 128) bucket), then ``predict_texts`` on 8 raw sentence
    pairs through the native WordPiece tokenizer: its probabilities must
    equal ``Predictor.__call__`` on the same features at the same seed, bit
    for bit. Returns the launches of the one ``predict_texts`` request."""
    from bayeformers_tpu_torch.native import WordPieceTokenizer
    from bayeformers_tpu_torch.utils import glue

    pred = build_predictor(bt)
    check(pred.warmup() == 1, "warmup ran another number of buckets")
    tok = WordPieceTokenizer(vocab)
    rng = np.random.default_rng(8)
    words = [w for w in WORDS19 if not w.startswith("#")]
    pairs = [tuple(" ".join(rng.choice(words, size=rng.integers(3, 40)).tolist())
                   for _ in range(2)) for _ in range(8)]
    reset_counters(fl, at)
    out = pred.predict_texts(pairs, tokenizer=tok, seed=7)
    torch.cuda.synchronize()
    counts = {"bayes_linear_anti": dict(fl.LAUNCHES.by_shape),
              "mha_fwd": dict(at.LAUNCHES.by_shape)}
    check(fl.LAUNCHES.count == BERT_BASE_LAYERS and at.LAUNCHES.count == 12,
          f"predict_texts launched {counts}")
    feats = glue.featurize_pairs(pairs, [0] * 8, tok.tokenize, max_seq=128,
                                 cls_id=tok.special_id("cls"), sep_id=tok.special_id("sep"))
    feats.pop("labels")
    want = pred.predict_featurized(feats, seed=7)
    check(set(out) == set(want) and all(np.array_equal(out[k], want[k]) for k in want),
          "predict_texts differs from __call__ on the same features")
    check(np.isfinite(out["probs"]).all() and np.allclose(out["probs"].sum(-1), 1.0),
          f"predict_texts probabilities {out['probs']}")
    say(f"phase 19 (b): warmup 1 bucket; predict_texts on 8 raw pairs (trimmed to "
        f"{int(feats['attention_mask'].sum(-1).max())} tokens) equal to __call__ bit for "
        f"bit; probs[0] {np.round(out['probs'][0], 4).tolist()}; launches "
        f"{ {k: sum(v.values()) for k, v in counts.items()} }")
    return counts


class HandMLP(torch.nn.Module):
    """The reference README's hand-built Bayesian model at the MNIST MLP's
    widths: BayesLinear 784 -> 512 -> 512 -> 10 with ReLU and log-softmax,
    a leading sample axis (S draws in one launch a layer)."""

    def __init__(self, bt):
        super().__init__()
        w = MLP_WIDTHS
        self.layers = torch.nn.ModuleList(
            bt.BayesLinear(k, n, sample_axis=True, generator=i, device="cuda")
            for i, (k, n) in enumerate(zip(w[:-1], w[1:])))

    def forward(self, x, plain=False):
        for i, layer in enumerate(self.layers):
            x = layer(x, plain=plain)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return torch.log_softmax(x.float(), dim=-1)


def mlp_step(bt, model, x, y, seed, plain=False):
    """The ELBO (n_batches 100) of one forward at ``seed`` and its gradients
    by parameter name."""
    from bayeformers_tpu_torch import elbo

    for p in model.parameters():
        p.grad = None
    out, aux = bt.bayes_apply(model, seed, x, plain=plain)
    nll = elbo.nll_sum_from_log_probs(elbo.mc_logits_mean(out), y)
    loss = elbo.elbo_loss(nll, aux["log_prior"], aux["log_variational_posterior"], 100)
    loss.backward()
    return loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}


def phase_bayes_mlp(bt, fl, fb, dtype) -> tuple[dict, dict]:
    """(c) the hand-built BayesLinear MLP on the card at S=10, B=64, in
    ``dtype``: one forward (``bayes_apply``) against the same layers' plain
    run at the same draws (log-probs 1e-5 relative; log-softmax outputs
    within #7's y gates, 2e-2 in bf16, 2e-5 of the largest in f32), and one
    ELBO step whose gradients stand within 1e-3 (f32) or 5e-2 (bf16)
    relative L2 of the plain step's, leaf by leaf. The forward launches #7
    once a layer at its shape (mixture instance), the step #7 and #9 once a
    layer; returns the launches of the forward and of the step, each
    counted from 0 around exactly that run."""
    tag = TAG[dtype]
    model = HandMLP(bt)
    gen = torch.Generator(device="cuda").manual_seed(64)
    x = torch.rand(64, 784, device="cuda", generator=gen).to(dtype)
    x = x[None].expand(10, 64, 784).contiguous()  # one batch, S = 10 draws
    y = torch.randint(0, 10, (64,), device="cuda", generator=gen)

    def launches():
        torch.cuda.synchronize()
        check(fl.LAUNCHES.count == fb.LAUNCHES.count == 0,
              f"the hand-built MLP ({tag}) launched an antithetic kernel")
        return {"bayes_linear": dict(fl.INDEP_LAUNCHES.by_shape),
                "reduce_abuv": dict(fb.INDEP_LAUNCHES.by_shape)}

    reset_counters(fl, fb)
    with torch.no_grad():
        out, aux = bt.bayes_apply(model, 5, x)
    serve = launches()
    reset_counters(fl, fb)
    loss, grads = mlp_step(bt, model, x, y, 6)
    train = launches()
    once = {(64, k, n, f"{tag}/mixture"): 1 for (_, k, n) in FAMILY_SHAPES[MLP]}
    check(serve == {"bayes_linear": once, "reduce_abuv": {}},
          f"the hand-built MLP's forward ({tag}) launched {serve}, want #7 {once}")
    check(train == {"bayes_linear": once, "reduce_abuv": once},
          f"the hand-built MLP's step ({tag}) launched {train}, want #7 and #9 {once}")
    with torch.no_grad():
        ref, raux = bt.bayes_apply(model, 5, x, plain=True)
    err = (out - ref).abs().max().item()
    if dtype == F32:
        check(err <= 2e-5 * ref.abs().max().item(), f"MLP ({tag}) log-probs differ: {err}")
    else:
        check(torch.allclose(out, ref, rtol=2e-2, atol=2e-2), f"MLP ({tag}) differs: {err}")
    for k in aux:
        check(torch.allclose(aux[k], raux[k], rtol=1e-5, atol=0.0),
              f"MLP ({tag}) {k}: {aux[k]} vs plain {raux[k]}")
    ploss, pgrads = mlp_step(bt, model, x, y, 6, plain=True)
    gate = 1e-3 if dtype == F32 else 5e-2
    rel = {n: (grads[n] - pgrads[n]).norm().item() / pgrads[n].norm().clamp_min(1e-30).item()
           for n in grads}
    worst = max(rel, key=rel.get)
    check(all(torch.isfinite(g).all() for g in grads.values()) and rel[worst] <= gate,
          f"MLP ({tag}) step gradients: worst {worst} rel L2 {rel[worst]:.3g} (gate {gate})")
    check(abs(loss.item() - ploss.item()) <= 1e-4 * abs(ploss.item()),
          f"MLP ({tag}) ELBO {loss.item()} vs plain {ploss.item()}")
    say(f"phase 19 (c): hand-built BayesLinear MLP ({tag}, S=10, B=64): log-probs max|d| "
        f"{err:.3g} from plain, log_q {aux['log_variational_posterior'][0].item():.7g} vs "
        f"{raux['log_variational_posterior'][0].item():.7g}; ELBO {loss.item():.6g} vs "
        f"plain {ploss.item():.6g}; step gradients worst rel L2 {rel[worst]:.3g} ({worst}); "
        f"launches: forward {serve}, step {train}")
    del model
    return serve, train


def phase_mlp_mnist(fl, fb, root) -> dict:
    """(d) ``mlp_mnist --estimator fused --limit-batches 3`` on idx files
    (256 train images, MNIST's 10000 test images): the MOPED (trainable mu)
    MLP through the independent-draw kernels, Gaussian instance, and no
    antithetic one: #7 once a layer in each of the two evaluations (M =
    10000) and in each of the three steps (M = 64), #9 once a layer a step.
    The rows of that instance at these shapes hold the kernels against
    their plain versions (:func:`phase19`)."""
    from bayeformers_tpu_torch.workloads import mlp_mnist

    data = write_mnist_files(root)
    reset_counters(fl, fb)
    res = mlp_mnist.train(data_dir=data, logs=os.path.join(root, "logs"), limit_batches=3,
                          estimator="fused")
    torch.cuda.synchronize()
    counts = {"bayes_linear": dict(fl.INDEP_LAUNCHES.by_shape),
              "reduce_abuv": dict(fb.INDEP_LAUNCHES.by_shape)}
    check(all(np.isfinite(v) for v in res.values()), f"mlp_mnist results {res}")
    step = {(64, k, n, "f32/gaussian"): 3 for (_, k, n) in FAMILY_SHAPES[MLP]}
    evals = {(M, k, n, "f32/gaussian"): 2 for (M, k, n) in FAMILY_SHAPES[MLP_EVAL]}
    check(counts == {"bayes_linear": {**step, **evals}, "reduce_abuv": step}
          and fl.LAUNCHES.count == fb.LAUNCHES.count == 0,
          f"mlp_mnist --estimator fused launched {counts}, want #7 {step} and {evals}, "
          f"#9 {step}")
    say(f"phase 19 (d): mlp_mnist --estimator fused, 3 batches on idx files: {res}; "
        f"launches {counts}")
    return counts


def phase19(bt, fl, fb, at, moped_rho, paths) -> list[dict]:
    """Phase 19: the kernels at the MLP's shapes against their plain
    versions (#7 and #9: the hand-built MLP's mixture instance in bf16 and
    f32; ``mlp_mnist``'s Gaussian instance in f32, #7 also at its
    evaluation's M), then (a)-(d), each timed; their launches into
    ``paths``."""
    rows = []
    for dtype in (BF16, F32):
        tag = TAG[dtype]
        t = time.perf_counter()
        rows += phase_bayes_linear(fl, moped_rho, False, dtype, "mixture", MLP)
        rows += phase_reduce(fl, fb, moped_rho, False, tag, "mixture", MLP)
        say(f"phase 19 kernels at the MLP's shapes ({tag}): {time.perf_counter() - t:.2f} s")
        t = time.perf_counter()
        paths[f"serve/{MLP}indep/{tag}/mixture"], paths[f"train/{MLP}indep/{tag}/mixture"] = (
            phase_bayes_mlp(bt, fl, fb, dtype))
        say(f"phase 19 (c) ({tag}): {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    for family in (MLP, MLP_EVAL):
        rows += phase_bayes_linear(fl, moped_rho, False, F32, "gaussian", family,
                                   path="mlp_mnist/fused/f32")
    rows += phase_reduce(fl, fb, moped_rho, False, "f32", "gaussian", MLP,
                         path="mlp_mnist/fused/f32")
    say(f"phase 19 kernels at mlp_mnist's shapes (f32, gaussian): "
        f"{time.perf_counter() - t:.2f} s")
    with tempfile.TemporaryDirectory() as root:
        t = time.perf_counter()
        paths["glue_files/anti/bf16"] = phase_glue_files(bt, fl, fb, at, root)
        say(f"phase 19 (a): {time.perf_counter() - t:.2f} s")
        t = time.perf_counter()
        paths["texts/anti/bf16"] = phase_texts(bt, fl, at, os.path.join(root, "vocab.txt"))
        say(f"phase 19 (b): {time.perf_counter() - t:.2f} s")
        t = time.perf_counter()
        os.makedirs(os.path.join(root, "mnist"))
        paths["mlp_mnist/fused/f32"] = phase_mlp_mnist(fl, fb, os.path.join(root, "mnist"))
        say(f"phase 19 (d): {time.perf_counter() - t:.2f} s")
    return rows


# ---------------------------------------------------------------------------
# Phase 20: the vision families (ViT, CLIP), convolutions (CONV_RULE) and
# embedding tables (EMBEDDING_RULE)
# ---------------------------------------------------------------------------

# the main paths of phase 20 by their launch paths' prefix: ViT-base/16 at
# its published widths (google/vit-base-patch16-224), CLIP at
# openai/clip-vit-base-patch32's widths, the reference's TinyCNN, and
# BERT-base with its embedding tables converted
VIT, CLIP, CNN, EMB = "vit/", "clip/", "cnn/", "bert-emb/"
VIT_B, VIT_L = 8, 197
CLIP_L, CLIP_EOS = 77, 49407
# ViT-base/16 and CLIP B/32 at 6 of their 12 layers (cut, when phase 22
# came, for the script's time limit; their widths are whole)
VISION_DEPTH = 6
CLIP_B32 = dict(
    text_config=dict(vocab_size=49408, hidden_size=512, intermediate_size=2048,
                     num_hidden_layers=VISION_DEPTH, num_attention_heads=8,
                     max_position_embeddings=CLIP_L),
    vision_config=dict(hidden_size=768, intermediate_size=3072,
                       num_hidden_layers=VISION_DEPTH,
                       num_attention_heads=12, image_size=224, patch_size=32),
    projection_dim=512)
# the linear kernels' new shapes (M a draw, B = 8): ViT's patch conv as an
# im2col product (196 patches, K = 3 x 16 x 16 = 768), its encoder at L = 197
# and its 1000-way head; CLIP's bias-free patch conv (49 patches, K = 3 x 32
# x 32 = 3072); TinyCNN's convs, K = 3 x 3 x 3 = 27 and K = 2 x 2 x 4 = 16
# (x rows of 54 and 32 bytes in bf16, which the product copies into 16-byte
# rows)
FAMILY_SHAPES[VIT] = ((VIT_B * 196, 768, 768), (VIT_B * VIT_L, 768, 768),
                      (VIT_B * VIT_L, 768, 3072), (VIT_B * VIT_L, 3072, 768),
                      (VIT_B, 768, 1000))
FAMILY_SHAPES[CLIP] = ((VIT_B * 49, 3072, 768),)
FAMILY_SHAPES[CNN] = ((VIT_B * 16, 27, 4), (VIT_B * 4, 16, 4))
# BERT-base's tables (words, positions, token types), #10's new shapes
EMB_TABLES = ((30522, 768), (512, 768), (2, 768))


class TinyCNN(torch.nn.Module):
    """The JAX package's test net (``tests/test_conv.py:22-35``) from the
    port's ``Conv`` and ``Dense``: (N, 8, 8, 3) images through a strided
    SAME conv, ReLU, a dilated VALID conv, and a 5-way head; weights
    0.3 N(0, 1) from seed 20."""

    input_keys = ("x",)

    def __init__(self, dtype):
        from bayeformers_tpu_torch.nn.conv import Conv
        from bayeformers_tpu_torch.nn.dense import Dense, assign_paths

        super().__init__()
        self.c0 = Conv(3, 4, (3, 3), strides=(2, 2), padding="SAME", device="cuda")
        self.c1 = Conv(4, 4, (2, 2), padding="VALID", kernel_dilation=(2, 2), device="cuda")
        self.head = Dense(16, 5, device="cuda")
        self.dtype = dtype
        assign_paths(self)
        gen = torch.Generator(device="cuda").manual_seed(20)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(0.3 * torch.randn(p.shape, device="cuda", generator=gen))
        self.requires_grad_(False)

    def forward(self, x, mc=None):
        x = self.c1(torch.relu(self.c0(x.to(self.dtype), mc)), mc)
        return self.head(x.reshape(x.shape[0], -1), mc)


def vision_base(bt, which, dtype):
    """The converted model of a phase-20 path in ``dtype`` activations, from
    seed 0, frozen MOPED 0.05: ViT-base/16 (1000 labels), CLIP B/32 and
    TinyCNN under ``(*DEFAULT_RULES, CONV_RULE)``, their zero leaves at 0.01
    first (MOPED would give a zero weight sigma = softplus(0) = 0.69, as for
    GPT-2); BERT-base under ``(*DEFAULT_RULES, EMBEDDING_RULE)``, as the
    other phases build it. Returns it and its trainable tensors."""
    rules = (*bt.DEFAULT_RULES, bt.EMBEDDING_RULE if which == EMB else bt.CONV_RULE)
    if which == VIT:
        model = bt.build_vit(size="base", n_labels=1000, seed=0, dtype=dtype, device="cuda",
                             num_hidden_layers=VISION_DEPTH)
    elif which == CLIP:
        model = bt.build_clip(seed=0, dtype=dtype, device="cuda", **CLIP_B32)
    elif which == CNN:
        model = TinyCNN(dtype)
    else:
        model = bt.build_bert(size="base", n_labels=2, seed=0, dtype=dtype, device="cuda")
    if which != EMB:
        with torch.no_grad():
            for p in model.parameters():
                p.masked_fill_(p == 0, 0.01)
    bmodel = bt.to_bayesian(model, delta=0.05, freeze=True, rules=rules)
    return bmodel, bmodel.trainable_parameters()


def vision_inputs(bt, which, B, seed=7) -> dict:
    """A seeded batch of a phase-20 path on the card: ViT's 224-pixel
    separable images of 1000 classes; CLIP's paired images and 77-id
    captions, EOS-terminated, half of them ending at position 60 with the
    rest padded; TinyCNN's 8x8 images; BERT's 8x128 batch."""
    from bayeformers_tpu_torch.models import clip, vit

    rng = np.random.default_rng(seed)
    if which == VIT:
        d = vit.synthetic_image_batch(rng, B, 224, n_labels=1000)
    elif which == CLIP:
        d = clip.synthetic_clip_batch(rng, B, CLIP_L, 224, 49408, eos_token_id=CLIP_EOS)
        ids, mask = d["input_ids"].astype(np.int64), np.ones((B, CLIP_L), np.int64)
        ids[B // 2:, 60], ids[B // 2:, 61:], mask[B // 2:, 61:] = CLIP_EOS, 0, 0
        d.update(input_ids=ids, attention_mask=mask)
    elif which == CNN:
        d = {"x": rng.normal(size=(B, 8, 8, 3)).astype(np.float32),
             "labels": rng.integers(0, 5, B)}
    else:
        return train_batch(bt, B)
    return {k: torch.from_numpy(np.asarray(v)).cuda() for k, v in d.items()}


def vision_keys(bmodel) -> tuple[str, ...]:
    from bayeformers_tpu_torch.models import families

    return families.input_keys(bmodel.model)


UNTILE = {CLIP: (1,)}


def vision_loss(bt, which):
    """The ELBO objective's task loss: CLIP's summed contrastive loss of the
    S-averaged similarity; classification elsewhere."""
    if which != CLIP:
        return bt.training.classification_loss
    from bayeformers_tpu_torch.models.clip import clip_contrastive_loss

    return lambda out, batch: (clip_contrastive_loss(out.float().mean(0)), {})


def vision_forward(bt, bmodel, which, estimator, inputs, seed=12345, impl="kernel"):
    """One S = 10 forward of the path's model through ``estimator``'s tier
    without gradients (the fused tier writes no W): (outputs, aux)."""
    mc = bt.training.pick_mc(bmodel, True, estimator, save_weights=False)
    args = {k: inputs[k] for k in vision_keys(bmodel) if k in inputs}
    with torch.inference_mode():
        return mc(seed, 10, **args, impl=impl, untile_axes=UNTILE.get(which, ()))


def vision_rows(which, path, B) -> int:
    """M a draw of a converted kernel: its layer's rows at batch B."""
    if which == VIT:
        return (B * 196 if "patch_embeddings" in path
                else B if path.startswith("classifier") else B * VIT_L)
    if which == CLIP:
        if "patch_embedding" in path:
            return B * 49
        return B if "projection" in path else B * (50 if path.startswith("vision") else CLIP_L)
    if which == CNN:
        return {"c0": B * 16, "c1": B * 4, "head": B}[path.split("/")[0]]
    return B if path.startswith("classifier") or "pooler" in path else B * 128


def vision_want(bmodel, which, B, tag, anti, n_req=0, n_steps=0) -> dict:
    """The fused tier's launches over ``n_req`` requests or ``n_steps``
    steps (S = 10) of a phase-20 path: the forward kernel (the reduce a
    step) once a converted kernel, at its (K, N) view (a conv's
    channel-major (cin kh kw, cout)), M its layer's rows; #10 once a
    converted table a forward, its pair instance for antithetic draws; in
    an f32 antithetic step #10's pair instance once a layer whose K rounds
    up above 2048 (the reference's route); attention (ViT, BERT) once a
    layer a forward (its backward a step), none in CLIP, whose attention
    is plain torch as in the reference."""
    from bayeformers_tpu_torch.ops import common
    from bayeformers_tpu_torch.ops import fused_linear as fl

    n = n_req + n_steps
    fwd, red, regen = {}, {}, {}

    def add(d, key, k):
        d[key] = d.get(key, 0) + k

    for p in bmodel.spec.paths:
        shape = tuple(bmodel.rho[p].shape)
        if p.endswith("/embedding"):
            add(regen, (5,) + shape + ("pair",) if anti else (10,) + shape, n)
            continue
        if not p.endswith("/kernel"):
            continue
        K, N = math.prod(shape[:-1]), shape[-1]
        key = (vision_rows(which, p, B), K, N, tag)
        add(fwd, key, n)
        if n_steps:
            add(red, key, n_steps)
            if tag == "f32" and anti and common.round_up(K, common.UNIT_K) > \
                    fl.ANTI_F32_SAVED_MAX_KP:
                add(regen, (5, K, N, "pair"), n_steps)
    want = {"bayes_linear_anti" if anti else "bayes_linear": fwd}
    if n_steps:
        want["reduce_abuv_anti" if anti else "reduce_abuv"] = red
    if regen:
        want["regen"] = regen
    if which in (VIT, EMB):
        akey = (10 * B, VIT_L if which == VIT else 128, 768, tag, False)
        depth = VISION_DEPTH if which == VIT else 12
        want["mha_fwd"] = {akey: depth * n}
        if n_steps:
            want["mha_bwd"] = {akey: depth * n_steps}
    return want


NAMES20 = {VIT: "ViT-base/16", CLIP: "CLIP ViT-B/32", CNN: "TinyCNN", EMB: "BERT-base tables"}


def f32_gate20(bt, which, estimator, inputs, lk, lp) -> str:
    """bf16 outputs through the kernels no farther from the f32 plain run's
    (the same weights and draws) than 1.5x the bf16 plain path's, in max
    |d| and relative L2 (:func:`f32_logits_gate`'s rule)."""
    m32, _ = vision_base(bt, which, F32)
    l32 = vision_forward(bt, m32, which, estimator, inputs, impl="plain")[0].float()
    del m32

    def dist(a):
        d = a.float() - l32
        return d.abs().max().item(), (d.norm() / l32.norm()).item()

    (kd, kr), (pd, pr) = dist(lk), dist(lp)
    check(kd <= 1.5 * pd and kr <= 1.5 * pr,
          f"{NAMES20[which]} {estimator} bf16 outputs: the kernels are farther from the f32 "
          f"plain run (max|d| {kd}, rel L2 {kr}) than 1.5x the bf16 plain path (max|d| "
          f"{pd}, rel L2 {pr})")
    torch.cuda.empty_cache()
    return (f"outputs against the f32 plain run: kernels max|d| {kd:.4g} rel L2 {kr:.4g}, "
            f"bf16 plain max|d| {pd:.4g} rel L2 {pr:.4g} (gate 1.5x); kernels vs bf16 "
            f"plain max|d| {max_dist(lk, lp):.4g}")


def summary20(bt, which, out, inputs) -> str:
    """The posterior summary of a forward: the MC-mean logits' accuracy and
    the per-draw accuracy std (classification), or the contrastive loss of
    the S-averaged similarity (CLIP); finite."""
    if which == CLIP:
        loss = vision_loss(bt, CLIP)(out, inputs)[0].item()
        check(np.isfinite(loss), f"CLIP contrastive loss {loss}")
        return f"contrastive loss of the mean similarity {loss:.6g}"
    mean = bt.elbo.mc_logits_mean(out)
    acc, std = bt.elbo.accuracy_and_std(out, inputs["labels"])
    check(bool(torch.isfinite(mean.float()).all()) and np.isfinite(float(acc))
          and np.isfinite(float(std)), "summary not finite")
    return f"mc_logits_mean accuracy {float(acc):.4f}, per-draw std {float(std):.4f}"


def serve_vision(bt, fl, fb, at, which, anti, dtype=BF16, B=VIT_B) -> tuple[dict, float]:
    """A phase-20 model's fused forward (S = 10) at batch B: a warm-up, then
    :data:`TIMED` requests with the launches read around exactly them
    (:func:`vision_want`), the log-probs against the plain path (1e-5
    relative), the outputs against it (bf16: :func:`f32_gate20`; f32: 1e-4
    absolute), the posterior summary of both, the latency and the peak
    memory. Returns (launches, median ms)."""
    bmodel, named = vision_base(bt, which, dtype)
    del named
    est, tag = ("antithetic" if anti else "fused"), TAG[dtype]
    label = f"{NAMES20[which]} request ({est}, {tag}, {B} a batch)"
    inputs = vision_inputs(bt, which, B)
    vision_forward(bt, bmodel, which, est, inputs, 1)
    torch.cuda.synchronize()
    reset_counters(fl, fb, at)
    at.PER_HEAD_LAUNCHES.reset()
    torch.cuda.reset_peak_memory_stats()
    lat = []
    for i in range(TIMED):
        torch.cuda.synchronize()
        t = time.perf_counter()
        vision_forward(bt, bmodel, which, est, inputs, 10 + i)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t) * 1e3)
    counts = lm_counts(fl, fb, at)
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = vision_want(bmodel, which, B, tag, anti, n_req=TIMED)
    check(counts == want, f"{label}: launches over {TIMED} requests {counts}, want {want}")
    lk, auxk = vision_forward(bt, bmodel, which, est, inputs)
    lp, auxp = vision_forward(bt, bmodel, which, est, inputs, impl="plain")
    check(bool(torch.isfinite(lk.float()).all()), f"{label}: outputs not finite")
    for k in auxk:
        check(torch.allclose(auxk[k], auxp[k], rtol=1e-5, atol=0.0),
              f"{label}: {k} {auxk[k]} vs plain {auxp[k]}")
    if dtype == BF16:
        note = f32_gate20(bt, which, est, inputs, lk, lp)
    else:
        err = max_dist(lk, lp)
        check(err <= 1e-4, f"{label}: outputs differ from the plain path by {err}")
        note = f"outputs kernels vs plain max|d| {err:.4g} (gate 1e-4)"
    note += f"; {summary20(bt, which, lk, inputs)} (plain: {summary20(bt, which, lp, inputs)})"
    ms = float(np.median(lat))
    say(f"{label}: launches over {TIMED} requests {counts}; {note}; log-probs within 1e-5 "
        f"of the plain path; latency median {ms:.3f} ms of {TIMED}: "
        f"{[round(v, 3) for v in lat]}; peak memory {peak:.2f} GiB")
    del bmodel, lk, lp
    torch.cuda.empty_cache()
    return counts, ms


def grads20(bt, bmodel, named, which, batch, impl, estimator):
    """Loss and gradients of one ELBO objective (S = 10, 256 batches) at the
    draws of seed 123."""
    for _, t, _ in named:
        t.grad = None
    mc = bt.training.pick_mc(bmodel, True, estimator)
    loss, _ = bt.training.elbo_objective(
        mc, 123, 10, batch, 256, vision_loss(bt, which), vision_keys(bmodel), impl=impl,
        untile_axes=UNTILE.get(which, ()))
    loss.backward()
    return loss.item(), {n: t.grad.clone() for n, t, _ in named}


def train_vision(bt, fl, fb, at, sl, lpm, which, estimator, dtype=BF16, B=VIT_B, n_steps=2,
                 compare=True) -> tuple[dict, float]:
    """A phase-20 model's ELBO step (S = 10) at batch B: with ``compare``,
    its loss and gradients through the kernels against the plain step at
    the same draws (bf16: loss 1e-2 relative, rho 5e-2 relative L2 and
    cosine 0.999, the other groups read; f32: loss 1e-6, every group 1e-3
    relative L2), then ``n_steps`` timed steps with the launches read
    around exactly them (the fused tier: :func:`vision_want`; flipout,
    LRT: :func:`want_counts`) and the peak memory. Returns (launches,
    median ms)."""
    bmodel, named = vision_base(bt, which, dtype)
    tag = TAG[dtype]
    label = f"{NAMES20[which]} step ({estimator}, {tag}, {B} a batch)"
    batch = vision_inputs(bt, which, B)
    if compare:
        loss_k, gk = grads20(bt, bmodel, named, which, batch, "kernel", estimator)
        torch.cuda.empty_cache()
        loss_p, gp = grads20(bt, bmodel, named, which, batch, "plain", estimator)
        loss_rel = abs(loss_k - loss_p) / abs(loss_p)
        check(np.isfinite(loss_k) and loss_rel <= (1e-6 if dtype == F32 else 1e-2),
              f"{label}: loss kernels {loss_k} vs plain {loss_p}")
        notes = []
        for group, names in grad_groups(list(gk)).items():
            rel, cos, at_ = worst_agreement(gk, gp, names)
            notes.append(f"{group} rel L2 {rel:.4g} (worst leaf, {at_}), cosine {cos:.7f}")
            if dtype == F32:
                check(rel <= 1e-3, f"{label}: {group} gradients differ from the plain f32 "
                      f"step: rel L2 {rel} at {at_}")
            elif group == "rho":
                check(rel <= 5e-2 and cos >= 0.999, f"{label}: rho gradients differ from "
                      f"the plain step: rel L2 {rel}, cosine {cos}")
        say(f"{label}: loss kernels {loss_k:.9g} vs plain {loss_p:.9g} (rel {loss_rel:.3g}); "
            "gradients kernels vs plain: " + "; ".join(notes))
        del gk, gp
        torch.cuda.empty_cache()
    opt = bt.training.adamw_with_decay_groups(2e-5, 0.0, bt.training.default_no_decay).init(
        named)
    stepf = bt.training.make_elbo_train_step(
        bmodel, opt, 10, 256, loss_fn=vision_loss(bt, which), input_keys=vision_keys(bmodel),
        estimator=estimator, untile_axes=UNTILE.get(which, ()))
    stepf(55, batch)
    torch.cuda.synchronize()
    reset_counters(fl, fb, at, sl, lpm)
    at.PER_HEAD_LAUNCHES.reset()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(n_steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = stepf(1000 + i, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        check(bool(torch.isfinite(m["loss"])), f"{label}: step {i} loss {m['loss']}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    if estimator in ("antithetic", "fused"):
        counts = lm_counts(fl, fb, at)
        want = vision_want(bmodel, which, B, tag, estimator == "antithetic", n_steps=n_steps)
        check(counts == want, f"{label}: launches over {n_steps} steps {counts}, want {want}")
    else:
        counts = estimator_counts(fl, fb, at, sl, lpm)
        n_layers = len([p for p in bmodel.spec.paths if p.endswith("/kernel")])
        want = want_counts(estimator, "on_mu", n_layers, VISION_DEPTH if which == VIT else 0,
                           n_steps)
        check(all(counts[k] == want.get(k, 0) for k in counts),
              f"{label}: {n_steps} steps launched {counts}, want {want} (0 elsewhere)")
    ms = float(np.median(times))
    say(f"{label}: launches over {n_steps} steps {counts}; ELBO step median {ms:.3f} ms of "
        f"{n_steps}: {[round(v, 3) for v in times]}; peak memory {peak:.2f} GiB")
    del opt, stepf, named, bmodel
    torch.cuda.empty_cache()
    return counts, ms


def tier_vision(bt, fl, fb, at, sl, lpm, which, estimator, B=VIT_B) -> tuple[dict, float]:
    """A forward of flipout, LRT or the naive tier (bf16, S = 10) at batch
    B: the launches of one request (:func:`want_counts`), the outputs
    against the tier's plain run (5e-2, the gate of phase 14's bf16
    estimators), the KL or log-probs within 1e-5, reruns bit-equal, the
    latency. Returns (launches, ms)."""
    bmodel, named = vision_base(bt, which, BF16)
    del named
    label = f"{NAMES20[which]} request ({estimator}, bf16, {B} a batch)"
    inputs = vision_inputs(bt, which, B)
    vision_forward(bt, bmodel, which, estimator, inputs, 1)
    torch.cuda.synchronize()
    reset_counters(fl, fb, at, sl, lpm)
    t = time.perf_counter()
    lk, auxk = vision_forward(bt, bmodel, which, estimator, inputs)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    counts = estimator_counts(fl, fb, at, sl, lpm)
    n_layers = len([p for p in bmodel.spec.paths if p.endswith("/kernel")])
    want = want_counts(estimator, "on_mu", n_layers,
                       {VIT: VISION_DEPTH, EMB: 12}.get(which, 0), 0)
    check(all(counts[k] == want.get(k, 0) for k in counts),
          f"{label}: one request launched {counts}, want {want} (0 elsewhere)")
    again, _ = vision_forward(bt, bmodel, which, estimator, inputs)
    lp, auxp = vision_forward(bt, bmodel, which, estimator, inputs, impl="plain")
    err = max_dist(lk, lp)
    check(torch.equal(lk, again), f"{label}: reruns differ")
    check(bool(torch.isfinite(lk.float()).all()) and err <= 5e-2,
          f"{label}: outputs differ from the plain path by {err} (gate 5e-2)")
    for k in auxk:
        check(torch.allclose(auxk[k], auxp[k], rtol=1e-5, atol=0.0),
              f"{label}: {k} {auxk[k]} vs plain {auxp[k]}")
    say(f"{label}: launches {counts}; outputs kernels vs plain max|d| {err:.4g} (gate 5e-2); "
        f"KL / log-probs within 1e-5; reruns equal; latency {ms:.3f} ms")
    del bmodel, lk, lp, again
    torch.cuda.empty_cache()
    return counts, ms


def leaky_plain(q, k, v, bias, nh):
    """A planted fault: plain attention in which each sequence's queries
    also see the first key of the next sequence (a key tile that runs past
    the end of its sequence in the flat (N L, H) layout)."""
    N, L, H = q.shape
    d = H // nh
    k2 = torch.cat([k, k.roll(-1, 0)[:, :1]], 1).float().view(N, L + 1, nh, d)
    v2 = torch.cat([v, v.roll(-1, 0)[:, :1]], 1).float().view(N, L + 1, nh, d)
    b2 = torch.cat([bias, bias.roll(-1, 0)[:, :1]], 1)
    s = torch.einsum("nqhd,nkhd->nhqk", q.float().view(N, L, nh, d), k2) / math.sqrt(d)
    p = torch.softmax(s + b2[:, None, None, :], dim=-1)
    return torch.einsum("nhqk,nkhd->nqhd", p, v2).reshape(N, L, H).to(q.dtype)


def attention20(at, dtype) -> list[dict]:
    """#3 and #5 at ViT's shapes (:func:`attention_checks`: ViT-base's N =
    S B = 80, L = 197, H = 768, 12 heads, and in f32 the B = 2 step's N =
    20; ViT-tiny's L = 17, 2 heads of 64), and a planted fault that must
    fail the forward gate: the plain version with each query also seeing
    one key of the next sequence (:func:`leaky_plain`)."""
    shapes = ((80, VIT_L, 768, 12, False, "vit/anti" if dtype == BF16 else None),
              (40, 17, 128, 2, False, None))
    if dtype == F32:
        shapes += ((20, VIT_L, 768, 12, False, "vit/anti"),)
    rows = attention_checks(at, dtype, shapes)
    for N, L, H, nh in ((80, VIT_L, 768, 12), (40, 17, 128, 2)):
        gen = torch.Generator(device="cuda").manual_seed(L)
        q, k, v = (torch.randn(N, L, H, device="cuda", generator=gen).to(dtype)
                   for _ in range(3))
        bias = torch.zeros(N, L, device="cuda")
        out = at.mha_cuda(q, k, v, bias, nh)
        ref, fault = at.mha_plain(q, k, v, bias, nh), leaky_plain(q, k, v, bias, nh)
        check(attn_gate_ok(out, ref, dtype) and not attn_gate_ok(out, fault, dtype),
              f"mha ({TAG[dtype]}) N={N} L={L}: plain max|d| {max_dist(out, ref)}, the "
              f"next-sequence key fault {max_dist(out, fault)} (must fail)")
        say(f"mha ({TAG[dtype]}) N={N} L={L} H={H}, no mask: kernel vs plain max|d| "
            f"{max_dist(out, ref):.3g}; a query seeing one key of the next sequence max|d| "
            f"{max_dist(out, fault):.3g} (fails the gate)")
    return rows


def embed_regen20(fl, sass, rate) -> list[dict]:
    """#10 at BERT-base's tables (30522, 512 and 2 rows of 768), its pair
    (five pairs) and independent (ten draws) instances: W bit-equal to the
    plain stream and a rerun, the ``sampled_weights`` VJP (dmu, drho of a
    random cotangent) bit-equal to the plain one on the same W; each timed
    against its plain version, the bound as :func:`phase_regen` counts it.
    Rows: the pair instance's launches from the antithetic request of
    BERT-base with its tables converted, the independent one's from its
    independent-draw step."""
    from bayeformers_tpu_torch.core.init import moped_rho

    rows = []
    for V, D in EMB_TABLES:
        gen = torch.Generator(device="cuda").manual_seed(V)
        mu = 0.02 * torch.randn(V, D, device="cuda", generator=gen)
        rho = moped_rho(mu, 0.05)
        for pair in (True, False):
            S_ = 5 if pair else 10
            seeds = torch.randint(0, 2**31 - 1, (S_,), device="cuda", generator=gen,
                                  dtype=torch.int32)
            w = fl.regenerate_weights(mu, rho, seeds, antithetic=pair)
            again = fl.regenerate_weights(mu, rho, seeds, antithetic=pair)
            plain = fl.regenerate_weights(mu, rho, seeds, antithetic=pair, plain=True)
            where = f"regen {'pair' if pair else 'independent'} ({S_}, {V}, {D})"
            check(torch.equal(w, again) and torch.equal(w, plain),
                  f"{where}: differs from the plain stream or a rerun: max "
                  f"{max_dist(w, plain)}")
            g = torch.randn(w.shape, device="cuda", generator=gen)
            grads = []
            for plain_ in (False, True):
                m, r = mu.clone().requires_grad_(), rho.clone().requires_grad_()
                out = fl.sampled_weights(m, r, seeds, antithetic=pair, plain=plain_)
                grads.append(torch.autograd.grad(out, (m, r), g))
            check(all(torch.equal(a, b) for a, b in zip(*grads)),
                  f"{where}: the sampled_weights VJP differs from the plain one")
            del w, again, plain, g, grads, out
            ms = time_ms(lambda: fl.regenerate_weights_cuda(mu, rho, seeds, antithetic=pair),
                         10, windows=WINDOWS)
            plain_ms = time_ms(lambda: fl.sample_weights(mu, rho, seeds, antithetic=pair), 2, 1)
            n_mufu, n_all = regen_instructions(sass, pair, False, [(V, D)], S_)
            b = bound_mufu(regen_bytes(S_, V, D, pair, False), n_mufu, rate)
            say(f"{where}: W bit-equal to the plain stream and a rerun, the sampled_weights "
                f"VJP bit-equal to the plain one; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"bound {b[0]:.4f} ms ({b[1]}; issue {issue_ms(n_all, rate):.4f} ms), no "
                "library call")
            rows.append(row(
                f"{'regen_pair' if pair else 'regen'}[S={S_},K={V},N={D}]", "regen",
                (S_, V, D) + (("pair",) if pair else ()),
                f"serve/{EMB}anti/bf16" if pair else f"train/{EMB}indep/bf16",
                "bayeformers_tpu_torch/csrc/regen.cu",
                "bayeformers_tpu/ops/fused_linear.py:1143", 0.0, ms, plain_ms, b, None))
            torch.cuda.empty_cache()
    return rows


def flipout_refuses_tables(bt) -> str:
    """Flipout has no embedding handler, as in the reference: BERT-base with
    its tables converted raises on the card, naming them."""
    bmodel, _ = vision_base(bt, EMB, BF16)
    batch = vision_inputs(bt, EMB, 2)
    try:
        vision_forward(bt, bmodel, EMB, "flipout", batch)
    except NotImplementedError as e:
        check("word_embeddings" in str(e), f"flipout's refusal names no table: {e}")
        return f"flipout with converted tables raises: {str(e)[:120]}..."
    finally:
        del bmodel
        torch.cuda.empty_cache()
    raise RuntimeError("chip_smoke: flipout ran a converted embedding table")


def phase20(bt, fl, fb, at, sl, lpm, moped_rho, paths, sass, rate) -> tuple[list[dict], dict]:
    """Phase 20 (module note): ViT's attention shapes, the linear kernels at
    the conv shapes, #10 at BERT-base's tables, ViT-base/16 served and
    trained under every tier, CLIP B/32, TinyCNN, and BERT-base with its
    tables converted. Fills ``paths``; returns the rows and the request and
    step medians."""
    rows, ms = [], {}

    def timed(label, fn, *args, **kwargs):
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        say(f"phase 20 {label}: {time.perf_counter() - t:.2f} s")
        return out

    for dtype in (BF16, F32):
        rows += timed(f"(a) attention ({TAG[dtype]})", attention20, at, dtype)
    for anti in (True, False):
        for fam in (VIT, CNN) + ((CLIP,) if anti else ()):
            rows += timed(f"(b) bayes_linear {fam} ({anti})", phase_bayes_linear, fl,
                          moped_rho, anti, BF16, "on_mu", fam)
            rows += timed(f"(b) reduce {fam} ({anti})", phase_reduce, fl, fb, moped_rho, anti,
                          "bf16", "on_mu", fam)
    rows += timed("(c) regen at the tables", embed_regen20, fl, sass, rate)
    # (d) ViT-base/16; (e) CLIP; TinyCNN; (f) BERT-base's tables
    for which, ests in ((VIT, ("anti", "indep")), (CNN, ("anti", "indep")), (CLIP, ("anti",)),
                        (EMB, ("anti",))):
        for key in ests:
            paths[f"serve/{which}{key}/bf16"], ms["request", which, key] = timed(
                f"serve {which} ({key})", serve_vision, bt, fl, fb, at, which, key == "anti")
    for which, est, n_steps, compare in ((VIT, "antithetic", 2, True), (VIT, "fused", 1, False),
                                         (CNN, "antithetic", 1, True), (CNN, "fused", 1, True),
                                         (CLIP, "antithetic", 1, True),
                                         (EMB, "fused", 1, True)):
        key = "anti" if est == "antithetic" else "indep"
        paths[f"train/{which}{key}/bf16"], ms["step", which, key] = timed(
            f"train {which} ({est})", train_vision, bt, fl, fb, at, sl, lpm, which, est,
            BF16, VIT_B, n_steps, compare)
    paths[f"serve/{VIT}anti/f32"], ms["request", VIT, "f32"] = timed(
        "serve vit (f32, B=2)", serve_vision, bt, fl, fb, at, VIT, True, F32, 2)
    paths[f"train/{VIT}anti/f32"], ms["step", VIT, "f32"] = timed(
        "train vit (f32, B=2)", train_vision, bt, fl, fb, at, sl, lpm, VIT, "antithetic", F32,
        2, 1)
    for est in ("flipout", "local"):
        _, ms["request", VIT, est] = timed(f"serve vit ({est})", tier_vision, bt, fl, fb, at,
                                           sl, lpm, VIT, est)
        _, ms["step", VIT, est] = timed(f"train vit ({est})", train_vision, bt, fl, fb, at, sl,
                                        lpm, VIT, est, BF16, VIT_B, 1)
    _, ms["request", VIT, "naive"] = timed("serve vit (naive, B=2)", tier_vision, bt, fl, fb,
                                           at, sl, lpm, VIT, "naive", 2)
    _, ms["request", EMB, "local"] = timed("serve bert tables (local)", tier_vision, bt, fl,
                                           fb, at, sl, lpm, EMB, "local")
    say(timed("flipout refuses tables", flipout_refuses_tables, bt))
    return rows, ms


# ---------------------------------------------------------------------------
# Phase 21: the encoder-decoder families (T5, Whisper) and posterior-predictive
# generation (mc_generate with a KV-cache decode)
# ---------------------------------------------------------------------------

# the main paths of phase 21 by their launch paths' prefix: T5-small at its
# published config (t5-small) and Whisper-base at openai/whisper-base's
# widths, both at 3 of their 6 + 6 layers (``SEQ2SEQ_DEPTH``)
T5S, WHB = "t5/", "whisper/"
T5_B, T5_SRC, T5_TGT = 8, 256, 64
WH_B, WH_TGT = 2, 64
NAMES21 = {T5S: "T5-small", WHB: "Whisper-base"}
# the linear kernels' new shapes (M a draw): T5-small's bias-free 512 -> 512
# (q/k/v/o), 512 -> 2048 (wi) and 2048 -> 512 (wo) at the source's 8 x 256
# rows (the encoder, the cross-attention's k and v) and the target's 8 x 64;
# Whisper-base's conv stems as im2col products (K = 3 x 80 at 2 x 3000
# frames, K = 3 x 512 at 2 x 1500), the same three at its 2 x 1500 encoder
# rows and its 2 x 64 decoder rows
FAMILY_SHAPES[T5S] = tuple((m, k, n) for m in (T5_B * T5_SRC, T5_B * T5_TGT)
                           for k, n in ((512, 512), (512, 2048), (2048, 512)))
FAMILY_SHAPES[WHB] = ((WH_B * 3000, 240, 512), (WH_B * 1500, 1536, 512)) + tuple(
    (m, k, n) for m in (WH_B * 1500, WH_B * WH_TGT)
    for k, n in ((512, 512), (512, 2048), (2048, 512)))


# phase 21's depth cut (for the script's time limit): T5-small's and
# Whisper-base's encoder and decoder at 3 of their 6 layers each, the
# published widths kept
SEQ2SEQ_DEPTH = 3
T5_DEPTH = dict(num_layers=SEQ2SEQ_DEPTH)
WHISPER_DEPTH = dict(encoder_layers=SEQ2SEQ_DEPTH, decoder_layers=SEQ2SEQ_DEPTH)


def seq2seq_base(bt, which, dtype):
    """The converted model of a phase-21 path in ``dtype`` activations from
    seed 0, its zero leaves at 0.01 first, frozen MOPED 0.05: T5-small
    (``T5_SMALL_KWARGS``) under the default rules, Whisper-base
    (``WHISPER_BASE_KWARGS``) under ``(*DEFAULT_RULES, CONV_RULE)``, its conv
    stems Bayesian, each at :data:`SEQ2SEQ_DEPTH` layers a stack. Returns it
    and its trainable tensors."""
    if which == T5S:
        model = bt.build_t5("small", seed=0, dtype=dtype, device="cuda", **T5_DEPTH)
        rules = bt.DEFAULT_RULES
    else:
        model = bt.build_whisper(seed=0, dtype=dtype, device="cuda",
                                 **dict(bt.WHISPER_BASE_KWARGS, **WHISPER_DEPTH))
        rules = (*bt.DEFAULT_RULES, bt.CONV_RULE)
    with torch.no_grad():
        for p in model.parameters():
            p.masked_fill_(p == 0, 0.01)
    bmodel = bt.to_bayesian(model, delta=0.05, freeze=True, rules=rules)
    return bmodel, bmodel.trainable_parameters()


def seq2seq_inputs(which, seed=7) -> dict:
    """A seeded batch on the card: T5's copy task (8 sources of 256 ids,
    half of them padded from 200 on; 64 target ids), Whisper's synthetic
    speech (2 x 80 mels x 3000 frames, 64 decoder ids)."""
    from bayeformers_tpu_torch.models import t5, whisper

    rng = np.random.default_rng(seed)
    if which == T5S:
        d = t5.synthetic_seq2seq_batch(rng, T5_B, T5_SRC, T5_TGT, 32128)
        d["attention_mask"][T5_B // 2:, 200:] = 0
    else:
        cfg = whisper.WhisperConfig(**whisper.WHISPER_BASE_KWARGS)
        d = whisper.synthetic_speech_batch(rng, WH_B, cfg)
        d["decoder_input_ids"] = d["decoder_input_ids"][:, :WH_TGT]
    return {k: torch.from_numpy(np.ascontiguousarray(v)).cuda()
            if v.dtype.kind == "f" else torch.from_numpy(v.astype(np.int64)).cuda()
            for k, v in d.items()}


def seq2seq_loss(which):
    """The teacher-forced token CE of the S-averaged logits, sum-reduced:
    T5's against its labels, Whisper's next decoder id."""
    from bayeformers_tpu_torch.models import t5, whisper

    return t5.seq2seq_loss if which == T5S else whisper.teacher_forced_loss


def seq2seq_keys(bmodel, inputs) -> dict:
    return {k: inputs[k] for k in bmodel.model.input_keys if k in inputs}


def forward21(bt, bmodel, inputs, est, seed, impl="kernel"):
    """One S = 10 request through the fused tier without W residuals:
    (outputs (S, B, L, V), aux)."""
    mc = bt.training.pick_mc(bmodel, True, est, save_weights=False)
    with torch.inference_mode():
        return mc(seed, 10, **seq2seq_keys(bmodel, inputs), impl=impl)


def seq2seq_rows(which, path) -> int:
    """M a draw of a converted kernel: the source's rows (T5's encoder and
    cross-attention k/v; Whisper's conv stems, encoder and cross k/v) or the
    target's."""
    if which == T5S:
        src = path.startswith("encoder/") or "EncDecAttention/k/" in path or \
            "EncDecAttention/v/" in path
        return T5_B * (T5_SRC if src else T5_TGT)
    if "conv1" in path:
        return WH_B * 3000
    if path.startswith("model/encoder/") or "encoder_attn/k_proj" in path or \
            "encoder_attn/v_proj" in path:
        return WH_B * 1500
    return WH_B * WH_TGT


def seq2seq_want(bmodel, which, anti, n_req=0, n_steps=0) -> dict:
    """The fused tier's launches over ``n_req`` requests or ``n_steps``
    steps (bf16, S = 10): the forward kernel (the reduce a step) once a
    converted kernel at its (K, N) view (a conv's (cin kw, cout)), M its
    rows; no attention kernel (T5's and Whisper's attention is plain torch,
    as the reference leaves it to XLA) and no #10 (bf16)."""
    fwd, red = {}, {}
    for p in bmodel.spec.paths:
        if not p.endswith("/kernel"):
            continue
        shape = tuple(bmodel.rho[p].shape)
        key = (seq2seq_rows(which, p), math.prod(shape[:-1]), shape[-1], "bf16")
        fwd[key] = fwd.get(key, 0) + n_req + n_steps
        if n_steps:
            red[key] = red.get(key, 0) + n_steps
    want = {"bayes_linear_anti" if anti else "bayes_linear": fwd}
    if n_steps:
        want["reduce_abuv_anti" if anti else "reduce_abuv"] = red
    return want


def summary21(which, out, inputs) -> str:
    """The MC-mean logits' teacher-forced token accuracy, finite."""
    loss, m = seq2seq_loss(which)(out, inputs)
    check(np.isfinite(loss.item()), f"{NAMES21[which]}: loss {loss.item()}")
    return f"token CE of the mean logits {loss.item():.6g}, accuracy {float(m['acc']):.4f}"


def f32_gate21(bt, which, est, inputs, lk, lp, label) -> str:
    """bf16 logits through the kernels no farther from the f32 plain run's
    (the same weights and draws) than 1.5x the bf16 plain path's, in max
    |d| and relative L2 (:func:`f32_logits_gate`'s rule: T5's random logits
    reach ~10, where one bf16 step is 0.0625, so no fixed absolute gate
    fits them)."""
    m32, _ = seq2seq_base(bt, which, F32)
    l32 = forward21(bt, m32, inputs, est, 12345, impl="plain")[0].float()
    del m32

    def dist(a):
        d = a.float() - l32
        return d.abs().max().item(), (d.norm() / l32.norm()).item()

    (kd, kr), (pd, pr) = dist(lk), dist(lp)
    check(kd <= 1.5 * pd and kr <= 1.5 * pr,
          f"{label}: the kernels' logits are farther from the f32 plain run (max|d| {kd}, "
          f"rel L2 {kr}) than 1.5x the bf16 plain path (max|d| {pd}, rel L2 {pr})")
    del l32
    torch.cuda.empty_cache()
    return (f"logits against the f32 plain run: kernels max|d| {kd:.4g} rel L2 {kr:.4g}, "
            f"bf16 plain max|d| {pd:.4g} rel L2 {pr:.4g} (gate 1.5x); kernels vs bf16 plain "
            f"max|d| {max_dist(lk, lp):.4g}")


def serve21(bt, fl, fb, at, which, anti=True) -> tuple[dict, float]:
    """A phase-21 model's request (S = 10, ``mc_apply_fused`` and the mean
    logits): a warm-up, :data:`TIMED` requests with the launches read around
    exactly them (:func:`seq2seq_want`), a rerun bit-equal, the log-probs
    against the plain path (1e-5 relative), the bf16 logits against the f32
    plain run no farther than 1.5x the bf16 plain path
    (:func:`f32_logits_gate`'s rule), the summary of both, latency and peak
    memory. Returns (launches, median ms)."""
    bmodel, named = seq2seq_base(bt, which, BF16)
    del named
    est = "antithetic" if anti else "fused"
    label = f"{NAMES21[which]} request ({est}, bf16)"
    inputs = seq2seq_inputs(which)
    forward21(bt, bmodel, inputs, est, 1)
    torch.cuda.synchronize()
    reset_counters(fl, fb, at)
    at.PER_HEAD_LAUNCHES.reset()
    torch.cuda.reset_peak_memory_stats()
    lat = []
    for i in range(TIMED):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out, _ = forward21(bt, bmodel, inputs, est, 10 + i)
        mean = bt.elbo.mc_logits_mean(out)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t) * 1e3)
        check(bool(torch.isfinite(mean.float()).all()), f"{label}: mean logits not finite")
    counts = lm_counts(fl, fb, at)
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = seq2seq_want(bmodel, which, anti, n_req=TIMED)
    check(counts == want, f"{label}: launches over {TIMED} requests {counts}, want {want}")
    del out, mean
    lk, auxk = forward21(bt, bmodel, inputs, est, 12345)
    again, _ = forward21(bt, bmodel, inputs, est, 12345)
    check(torch.equal(lk, again), f"{label}: reruns differ")
    del again
    lp, auxp = forward21(bt, bmodel, inputs, est, 12345, impl="plain")
    for k in auxk:
        check(torch.allclose(auxk[k], auxp[k], rtol=1e-5, atol=0.0),
              f"{label}: {k} {auxk[k]} vs plain {auxp[k]}")
    note = f"{summary21(which, lk, inputs)} (plain: {summary21(which, lp, inputs)})"
    gate = f32_gate21(bt, which, est, inputs, lk, lp, label)
    ms = float(np.median(lat))
    say(f"{label}: launches over {TIMED} requests {counts}; reruns bit-equal; log-probs "
        f"within 1e-5 of the plain path; {gate}; {note}; latency median {ms:.3f} ms of "
        f"{TIMED}: {[round(v, 3) for v in lat]}; peak memory {peak:.2f} GiB")
    del bmodel, lk, lp
    torch.cuda.empty_cache()
    return counts, ms


def grads21(bt, bmodel, named, which, batch, impl, est):
    """Loss and gradients of one ELBO objective (S = 10, 256 batches) at the
    draws of seed 123."""
    for _, t, _ in named:
        t.grad = None
    mc = bt.training.pick_mc(bmodel, True, est)
    loss, _ = bt.training.elbo_objective(mc, 123, 10, batch, 256, seq2seq_loss(which),
                                         bmodel.model.input_keys, impl=impl)
    loss.backward()
    # Whisper's encoder positions are under stop_gradient: no gradient
    return loss.item(), {n: t.grad.clone() for n, t, _ in named if t.grad is not None}


def against_plain21(bt, bmodel, named, which, batch, est, label, loss_k, gk) -> str:
    """The ELBO objective's loss and gradients through the kernels
    (``loss_k``, ``gk``: :func:`grads21`) against the plain path's at the
    same draws: loss 1e-2 relative, rho 5e-2 relative L2 and cosine 0.999
    (the other groups read). Returns the note."""
    loss_p, gp = grads21(bt, bmodel, named, which, batch, "plain", est)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    check(np.isfinite(loss_k) and loss_rel <= 1e-2,
          f"{label}: loss kernels {loss_k} vs plain {loss_p}")
    notes = []
    for group, names in grad_groups(list(gk)).items():
        rel, cos, at_ = worst_agreement(gk, gp, names)
        notes.append(f"{group} rel L2 {rel:.4g} (worst leaf, {at_}), cosine {cos:.7f}")
        if group == "rho":
            check(rel <= 5e-2 and cos >= 0.999, f"{label}: rho gradients differ from the "
                  f"plain step: rel L2 {rel}, cosine {cos}")
    del gp
    torch.cuda.empty_cache()
    return (f"loss kernels {loss_k:.9g} vs plain {loss_p:.9g} (rel {loss_rel:.3g}); "
            "gradients kernels vs plain: " + "; ".join(notes))


def train21(bt, fl, fb, at, which, anti=True) -> tuple[dict, float]:
    """A phase-21 model's ELBO step (S = 10, bf16, the teacher-forced token
    CE as ``loss_fn``): the loss and gradients through the kernels against
    the plain step at the same draws (loss 1e-2 relative, rho 5e-2 relative
    L2 and cosine 0.999, the other groups read) and a rerun bit-equal; then
    :data:`TIMED` steps on one batch and one draw (seed 55) with the
    launches read around exactly them, the ELBO falling. Returns
    (launches, median ms)."""
    bmodel, named = seq2seq_base(bt, which, BF16)
    est = "antithetic" if anti else "fused"
    label = f"{NAMES21[which]} step ({est}, bf16)"
    batch = seq2seq_inputs(which)
    loss_k, gk = grads21(bt, bmodel, named, which, batch, "kernel", est)
    loss_k2, gk2 = grads21(bt, bmodel, named, which, batch, "kernel", est)
    check(loss_k == loss_k2 and all(torch.equal(gk[n], gk2[n]) for n in gk),
          f"{label}: reruns differ")
    del gk2
    torch.cuda.empty_cache()
    say(f"{label}: reruns bit-equal; "
        + against_plain21(bt, bmodel, named, which, batch, est, label, loss_k, gk))
    del gk
    torch.cuda.empty_cache()
    opt = bt.training.adamw_with_decay_groups(1e-4, 0.0, bt.training.default_no_decay).init(
        named)
    stepf = bt.training.make_elbo_train_step(
        bmodel, opt, 10, 256, loss_fn=seq2seq_loss(which),
        input_keys=bmodel.model.input_keys, estimator=est)
    losses = [stepf(55, batch)["loss"].item()]
    torch.cuda.synchronize()
    reset_counters(fl, fb, at)
    at.PER_HEAD_LAUNCHES.reset()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(TIMED):
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = stepf(55, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        losses.append(m["loss"].item())
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = lm_counts(fl, fb, at)
    want = seq2seq_want(bmodel, which, anti, n_steps=TIMED)
    check(counts == want, f"{label}: launches over {TIMED} steps {counts}, want {want}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"{label}: the ELBO did not fall on one batch and draw: {losses}")
    ms = float(np.median(times))
    say(f"{label}: launches over {TIMED} steps {counts}; loss over {TIMED + 1} steps at one "
        f"batch and draw {losses}; ELBO step median {ms:.3f} ms of {TIMED}: "
        f"{[round(v, 3) for v in times]}; peak memory {peak:.2f} GiB")
    del opt, stepf, named, bmodel
    torch.cuda.empty_cache()
    return counts, ms


def regen21(bt, fl, fb, at) -> str:
    """T5-small's antithetic ELBO objective with ``save_weights=False`` (the
    regenerating backward): #10's pair instance with its bf16 copy once a
    converted kernel and the (bf16 x, f32 W) reduce once a kernel, counted
    around exactly one objective, its gradients against the plain
    regenerating run (rho 5e-2 relative L2, cosine 0.999)."""
    bmodel, named = seq2seq_base(bt, T5S, BF16)
    batch = seq2seq_inputs(T5S)
    n = len(bmodel.spec.paths)

    def grads(impl):
        for _, t, _ in named:
            t.grad = None
        mc = bt.training.pick_mc(bmodel, True, "antithetic", save_weights=False)
        loss, _ = bt.training.elbo_objective(mc, 123, 10, batch, 256, seq2seq_loss(T5S),
                                             bmodel.model.input_keys, impl=impl)
        loss.backward()
        return loss.item(), {m: t.grad.clone() for m, t, _ in named if t.grad is not None}

    torch.cuda.synchronize()
    reset_counters(fl, fb, at)
    loss_k, gk = grads("kernel")
    regen = dict(fl.REGEN_LAUNCHES.by_shape)
    check(fl.REGEN_LAUNCHES.count == n and all(k[3:] == ("pair/bf16",) for k in regen),
          f"T5-small save_weights=False: regen launched {regen}, want the pair/bf16 "
          f"instance once for each of {n} kernels")
    check(sum(v for k, v in fb.LAUNCHES.by_shape.items() if k[3] == "bf16x-f32w") == n,
          f"T5-small save_weights=False: the (bf16 x, f32 W) reduce did not serve every "
          f"kernel: {fb.LAUNCHES.by_shape}")
    loss_p, gp = grads("plain")
    rel, cos, at_ = worst_agreement(gk, gp, [m for m in gk if m.startswith("rho/")])
    check(abs(loss_k - loss_p) <= 1e-2 * abs(loss_p) and rel <= 5e-2 and cos >= 0.999,
          f"T5-small save_weights=False: loss {loss_k} vs plain {loss_p}, rho rel L2 {rel}, "
          f"cosine {cos}")
    del bmodel, named, gk, gp
    torch.cuda.empty_cache()
    return (f"T5-small ELBO objective, save_weights=False (antithetic, bf16): regen {n} "
            f"launches, the pair/bf16 instance; (bf16 x, f32 W) reduce on every kernel; loss "
            f"kernels {loss_k:.9g} vs plain {loss_p:.9g}; rho rel L2 {rel:.4g} (worst leaf, "
            f"{at_}), cosine {cos:.7f}")


def split_shape_counts(sl, fb) -> dict:
    """Flipout's split kernels' launches by name and shape: #12, #13 and
    the reduce of its VJP."""
    return {c.name: dict(c.by_shape) for c in (sl.LAUNCHES, sl.REGEN_LAUNCHES,
                                               fb.INDEP_LAUNCHES) if c.count}


def tier21(bt, fl, fb, at, sl, lpm, estimator) -> tuple[dict, float, dict, float]:
    """T5-small under flipout or LRT (bf16, S = 10): one request and one
    ELBO step, the launches counted around each (:func:`want_counts`: #12
    on every kernel a flipout forward, #13 and the reduce a backward; no
    Bayesian linear kernel in LRT), the bf16 outputs against the tier's f32
    plain run (:func:`f32_gate21`), the KL within 1e-5, reruns bit-equal;
    the ELBO objective's loss and gradients against the plain path's at the
    same draws (:func:`against_plain21`: under flipout #12's forward and
    #13's W through the reduce at T5-small's shapes). Returns the request's
    launches by shape (:func:`split_shape_counts`) and ms, the step's."""
    bmodel, named = seq2seq_base(bt, T5S, BF16)
    batch = seq2seq_inputs(T5S)
    label = f"T5-small {estimator} (bf16)"
    n = len(bmodel.spec.paths)
    forward21(bt, bmodel, batch, estimator, 1)
    torch.cuda.synchronize()
    reset_counters(fl, fb, at, sl, lpm)
    t = time.perf_counter()
    lk, auxk = forward21(bt, bmodel, batch, estimator, 12345)
    torch.cuda.synchronize()
    req_ms = (time.perf_counter() - t) * 1e3
    req_counts = estimator_counts(fl, fb, at, sl, lpm)
    req_shapes = split_shape_counts(sl, fb)
    want = want_counts(estimator, "on_mu", n, 0, 0)
    check(all(req_counts[k] == want.get(k, 0) for k in req_counts),
          f"{label}: one request launched {req_counts}, want {want} (0 elsewhere)")
    again, _ = forward21(bt, bmodel, batch, estimator, 12345)
    lp, auxp = forward21(bt, bmodel, batch, estimator, 12345, impl="plain")
    check(torch.equal(lk, again) and bool(torch.isfinite(lk.float()).all()),
          f"{label}: reruns differ or outputs not finite")
    gate = f32_gate21(bt, T5S, estimator, batch, lk, lp, label)
    for k in auxk:
        check(torch.allclose(auxk[k], auxp[k], rtol=1e-5, atol=0.0),
              f"{label}: {k} {auxk[k]} vs plain {auxp[k]}")
    del lk, lp, again
    loss_k, gk = grads21(bt, bmodel, named, T5S, batch, "kernel", estimator)
    grads = against_plain21(bt, bmodel, named, T5S, batch, estimator, label, loss_k, gk)
    del gk
    opt = bt.training.adamw_with_decay_groups(1e-4, 0.0, bt.training.default_no_decay).init(
        named)
    stepf = bt.training.make_elbo_train_step(
        bmodel, opt, 10, 256, loss_fn=seq2seq_loss(T5S), input_keys=bmodel.model.input_keys,
        estimator=estimator)
    stepf(55, batch)
    torch.cuda.synchronize()
    reset_counters(fl, fb, at, sl, lpm)
    t = time.perf_counter()
    m = stepf(56, batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) * 1e3
    counts = estimator_counts(fl, fb, at, sl, lpm)
    step_shapes = split_shape_counts(sl, fb)
    want = want_counts(estimator, "on_mu", n, 0, 1)
    check(bool(torch.isfinite(m["loss"])) and all(counts[k] == want.get(k, 0) for k in counts),
          f"{label}: one step launched {counts}, want {want} (0 elsewhere); loss {m['loss']}")
    say(f"{label}: request launches {req_counts}, {gate}, KL within 1e-5, reruns equal, "
        f"latency {req_ms:.3f} ms; ELBO objective {grads}; step launches {counts}, "
        f"{step_ms:.3f} ms")
    del bmodel, named, opt, stepf
    torch.cuda.empty_cache()
    return req_shapes, req_ms, step_shapes, step_ms


def flipout21(sl, fl, fb, moped_rho, sass, rate) -> list[dict]:
    """Flipout's split kernels at T5-small's shapes (bf16, S = 10): #12
    (``sampled_dense``) against its plain version and x @ W
    (:func:`phase_sampled_dense`), #13's W and bf16 copy bit-equal to the
    plain stream (:func:`split_regen_rows`), and the VJP through #13 and
    the reduce against the plain route at the source's and the target's
    rows (:func:`phase_flipout_vjp`). Returns the rows, each of the
    launches of T5-small's flipout request or step."""
    kn = ((512, 512), (512, 2048), (2048, 512))
    rows = phase_sampled_dense(sl, fl, moped_rho, BF16, FAMILY_SHAPES[T5S],
                               f"serve/{T5S}flipout")
    rows += split_regen_rows(sl, moped_rho, sass, rate, kn, ("bf16",), f"train/{T5S}flipout")
    for M in (T5_B * T5_SRC, T5_B * T5_TGT):
        phase_flipout_vjp(sl, fb, moped_rho, BF16, kn, M)
    return rows


GEN_REPS = 7  # timed decodes of each kind a model, in turns


def decode_times21(generation, model, bmodel, ids, steps) -> dict:
    """The wall time a step (one token for each of the B rows) of one
    draw's greedy decode (``generation.decode_draw``, no scores, no eos),
    the weights drawn once outside the clock: one warm-up of each, then
    :data:`GEN_REPS` decodes of each in turns (cache, recompute, recompute,
    cache, ...). Returns {use_cache: [ms a step, ...]}."""
    cfg = model.config
    params, _, _ = bmodel.sample(torch.Generator(device="cuda").manual_seed(5))
    ids = torch.as_tensor(ids, device="cuda").long()
    mask = torch.ones_like(ids)
    pad = cfg.pad_token_id or cfg.eos_token_id or 0

    def run(cache):
        torch.cuda.synchronize()
        t = time.perf_counter()
        generation.decode_draw(model, params, ids, mask, ids.shape[1] + 16,
                               lambda z: torch.argmax(z, dim=-1), pad, -1, cache)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / steps

    run(True)
    run(False)
    times = {True: [], False: []}
    for i in range(GEN_REPS):
        for cache in ((True, False) if i % 2 == 0 else (False, True)):
            times[cache].append(run(cache))
    del params
    return times


def generate21(bt, which) -> dict:
    """``mc_generate`` at S = 4, B = 2, ``max_new_tokens=16``, greedy, f32,
    no eos (every step decodes: GPT-2 16 steps, T5-small 31, its decoder
    side running to the prompt's length plus 16): GPT-2 base or T5-small
    (seed 0, zero leaves at 0.01) from a 16-id prompt. The frequentist greedy
    decode (every rho at -200: the draws are mu exactly) reruns bit-equal.
    At delta -> 0 (frozen MOPED 1e-7) each draw's logits stand within 1e-5
    of the largest |logit| of that decode's at every step up to the first
    where its tokens leave it, if any (there the gap of the decode's top
    two logits is at most twice that difference, which is what lets a draw
    leave it). The KV-cache decode's tokens equal the decode that
    recomputes the whole prefix, its logits within 1e-4 of the largest.
    Then :func:`decode_times21`. Returns {use_cache: median ms a step}."""
    from bayeformers_tpu_torch import generation

    if which == GPT2:
        model = bt.build_gpt2("base", seed=0, dtype=F32, device="cuda")
        vocab, name, first = 50257, "GPT-2 base", 16
    else:
        model = bt.build_t5("small", seed=0, dtype=F32, device="cuda", **T5_DEPTH)
        vocab, name, first = 32128, "T5-small", 1
    # MOPED gives an exactly-zero weight rho = 0 (sigma = softplus(0) =
    # 0.69) at every delta, as the reference does; delta -> 0 holds only
    # for the others, so zero leaves go to 0.01 first, as the reference's
    # test has them (GPT-2's zero biases; T5-small's seed-0 init holds a
    # few exact zeros, the card's normal_ drawing 0)
    with torch.no_grad():
        zeros = sum(int((p == 0).sum()) for p in model.parameters())
        for p in model.parameters():
            p.masked_fill_(p == 0, 0.01)
    ids = np.random.default_rng(21).integers(2, vocab, (2, 16))
    kw = dict(max_new_tokens=16, eos_token_id=-1, output_scores=True)
    fixed = bt.to_bayesian(model, delta=0.05, freeze=True)
    for r in fixed.rho.values():
        r.fill_(-200.0)
    ffull = generation.mc_generate(model, fixed, 1, ids, **kw)
    frerun = generation.mc_generate(model, fixed, 1, ids, **kw)
    check(np.array_equal(ffull["sequences"], frerun["sequences"])
          and np.array_equal(ffull["scores"], frerun["scores"]),
          f"{name}: the frequentist decode's rerun differs (logits max|d| "
          f"{np.abs(ffull['scores'] - frerun['scores']).max()})")
    freq, fs = ffull["sequences"][0], ffull["scores"][0]
    steps = fs.shape[1]
    top = float(np.abs(fs).max())
    bmodel = bt.to_bayesian(model, delta=1e-7, freeze=True)
    cached = generation.mc_generate(model, bmodel, 4, ids, **kw)
    out = generation.mc_generate(model, bmodel, 4, ids, use_cache=False, **kw)
    seqs = cached["sequences"]
    worst, flips = 0.0, []
    for s in range(4):
        for b in range(2):
            diff = np.nonzero(seqs[s, b] != freq[b])[0]
            last = int(diff[0]) - first if diff.size else steps - 1
            d = float(np.abs(cached["scores"][s, b, :last + 1] - fs[b, :last + 1]).max())
            worst = max(worst, d)
            if diff.size:
                top2 = np.sort(fs[b, last])[-2:]
                flips.append((s, b, int(diff[0]), float(top2[1] - top2[0]), d))
    check(worst <= 1e-5 * top,
          f"{name}: delta -> 0 draws' logits stand {worst} from the frequentist greedy "
          f"decode's (max |logit| {top}, gate 1e-5 of it) before they leave it; (draw, "
          f"row, position, top-2 gap there, max|d| up to it): {flips}")
    check(np.array_equal(seqs, out["sequences"]),
          f"{name}: the KV cache's tokens differ from the recomputing decode's")
    err = float(np.abs(cached["scores"] - out["scores"]).max())
    top_c = float(np.abs(out["scores"]).max())
    check(err <= 1e-4 * top_c, f"{name}: cache logits differ by {err} (max |logit| {top_c})")
    del fixed, ffull, frerun, cached, out
    times = decode_times21(generation, model, bmodel, ids, steps)
    med = {c: float(np.median(v)) for c, v in times.items()}
    say(f"mc_generate {name} (S=4, B=2, max_new_tokens=16: {steps} steps, greedy, f32; "
        f"{zeros} zero leaves at 0.01): the "
        f"frequentist decode reruns bit-equal; delta -> 0 draws' logits within {worst:.4g} "
        f"of its (max |logit| {top:.4g}, gate 1e-5 relative) up to where they leave it; "
        + (f"{len(flips)} of 8 draw rows leave it, (draw, row, position, top-2 gap there, "
           f"max|d| up to it) {flips}" if flips else "every draw equals it")
        + f"; KV-cache tokens equal the recomputing decode's, logits max|d| {err:.4g} of "
        f"max |logit| {top_c:.4g} (gate 1e-4 relative); one draw's decode (weights drawn "
        f"once, no scores), ms a step (B=2 tokens), median of {GEN_REPS} in turns after a "
        f"warm-up [min, max]: cache {med[True]:.3f} [{min(times[True]):.3f}, "
        f"{max(times[True]):.3f}], recompute {med[False]:.3f} [{min(times[False]):.3f}, "
        f"{max(times[False]):.3f}]; all: {[round(v, 3) for v in times[True]]} / "
        f"{[round(v, 3) for v in times[False]]}")
    del model, bmodel
    torch.cuda.empty_cache()
    return med


def phase21(bt, fl, fb, at, sl, lpm, moped_rho, paths, sass, rate
            ) -> tuple[list[dict], dict]:
    """Phase 21 (module note): the linear kernels at T5-small's and
    Whisper-base's shapes (flipout's #12, #13 and VJP at T5-small's), both
    models served and trained (antithetic; T5 also with independent draws,
    with ``save_weights=False``, and under flipout and LRT), and
    ``mc_generate`` on GPT-2 base and T5-small. Fills ``paths``; returns
    the rows and the request, step and per-token times."""
    rows, ms = [], {}

    def timed(label, fn, *args, **kwargs):
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        say(f"phase 21 {label}: {time.perf_counter() - t:.2f} s")
        return out

    for fam, antis in ((T5S, (True, False)), (WHB, (True,))):
        for anti in antis:
            rows += timed(f"(a) bayes_linear {fam} ({anti})", phase_bayes_linear, fl,
                          moped_rho, anti, BF16, "on_mu", fam)
            rows += timed(f"(a) reduce {fam} ({anti})", phase_reduce, fl, fb, moped_rho, anti,
                          "bf16", "on_mu", fam)
    rows += timed(f"(a) flipout's split kernels {T5S}", flipout21, sl, fl, fb, moped_rho, sass,
                  rate)
    for which, antis in ((T5S, (True, False)), (WHB, (True,))):
        for anti in antis:
            key = "anti" if anti else "indep"
            paths[f"serve/{which}{key}/bf16"], ms["request", which, key] = timed(
                f"serve {which} ({key})", serve21, bt, fl, fb, at, which, anti)
            paths[f"train/{which}{key}/bf16"], ms["step", which, key] = timed(
                f"train {which} ({key})", train21, bt, fl, fb, at, which, anti)
    say(timed("regenerating step t5/", regen21, bt, fl, fb, at))
    for est in ("flipout", "local"):
        (paths[f"serve/{T5S}{est}/bf16"], ms["request", T5S, est],
         paths[f"train/{T5S}{est}/bf16"], ms["step", T5S, est]) = timed(
            f"{est} t5/", tier21, bt, fl, fb, at, sl, lpm, est)
    for which in (GPT2, T5S):
        t = timed(f"mc_generate {which}", generate21, bt, which)
        ms["token", which, "cache"] = t[True] / 2
        ms["token", which, "recompute"] = t[False] / 2
    return rows, ms


# ---------------------------------------------------------------------------
# Phase 22: the hand-built stacked tiers (BlockStack, BayesMoE,
# TransformerStack, stack_lm at pp = ep = 1) and pretrained= for the causal LMs
# ---------------------------------------------------------------------------

# the stacked tiers' main paths by their launch paths' prefix: BlockStack at
# BERT-base's hidden width and depth (768, 12 blocks), stack_lm's defaults
# otherwise (B = 64 in 4 microbatches, S = 2, Adam 1e-3); the transformer LM
# at GPT-2 small's published widths (openai-community/gpt2: d_model 768, 12
# heads, d_ff 3072, vocab 50257, seq_len 128, B = 8: 8 x 127 token rows);
# its MoE FFN at Switch-Base-8's (google/switch-base-8: d_model 768, d_ff
# 3072, 8 experts, vocab 32128, capacity factor 1.25: C = 159 slots). Every
# projection is f32 under the scale mixture, one draw a call (S = 1).
BLOCK, STACK_LM, STACK_MOE = "stack-block/", "stack-lm/", "stack-moe/"
STACK_L, STACK_D, STACK_FF, STACK_HEADS = 12, 768, 3072, 12
STACK_B, STACK_MB, STACK_S = 64, 4, 2
LM_B, LM_T, GPT2_VOCAB, SWITCH_VOCAB, SWITCH_E = 8, 128, 50257, 32128, 8
LM_ROWS = LM_B * (LM_T - 1)
MOE_C = math.ceil(LM_ROWS / SWITCH_E * 1.25)
FAMILY_SHAPES[BLOCK] = ((STACK_B // STACK_MB, STACK_D, STACK_D),)
FAMILY_SHAPES[STACK_LM] = tuple((LM_ROWS, k, n) for k, n in (
    (STACK_D, 3 * STACK_D), (STACK_D, STACK_D), (STACK_D, STACK_FF), (STACK_FF, STACK_D)))
FAMILY_SHAPES[STACK_MOE] = ((MOE_C, STACK_D, STACK_FF), (MOE_C, STACK_FF, STACK_D))
STACK_STEPS = 3  # the full-depth steps of (c) and (d), launches counted around them
# (d)'s one-rank MoE LM at 6 of 12 blocks (for the script's time limit;
# phase 24 (d) runs the 12-block one-process step as its reference)
MOE_BLOCKS22 = 6


class GradSnap:
    """An optimizer for a step factory that keeps the step's gradients and
    updates nothing (the kernels' and the plain step start from the same
    parameters)."""

    def __init__(self, module):
        self.module, self.grads = module, {}

    def zero_grad(self):
        for p in self.module.parameters():
            p.grad = None

    def step(self):
        self.grads = {n: p.grad.detach().clone() for n, p in self.module.named_parameters()}


def stack_counts(fl, fb) -> dict:
    torch.cuda.synchronize()
    check(fl.LAUNCHES.count == fb.LAUNCHES.count == 0,
          "a stacked tier launched an antithetic kernel")
    return {"bayes_linear": dict(fl.INDEP_LAUNCHES.by_shape),
            "reduce_abuv": dict(fb.INDEP_LAUNCHES.by_shape)}


def stack_want(shapes: dict) -> dict:
    """The launches of #7 and of #9 wanted by (M, K, N): each once a call."""
    want = {(M, K, N, "f32/mixture"): n for (M, K, N), n in shapes.items()}
    return {"bayes_linear": want, "reduce_abuv": want}


@contextlib.contextmanager
def module_f64(module):
    """A copy of ``module`` in f64 with ``Tensor.float()`` a no-op on f64
    tensors (as :func:`in_f64`): the plain path in f64 at the same draws
    (the eps stream stays the f32 one); ``float`` restored on exit."""
    import copy

    m64 = copy.deepcopy(module).double()
    orig = torch.Tensor.float
    torch.Tensor.float = lambda t, *a, **k: t if t.dtype == torch.float64 else orig(t, *a, **k)
    try:
        yield m64
    finally:
        torch.Tensor.float = orig


def stack_step22(label, fl, fb, module, make_step, batch, seed, want=None, loss_gate=1e-6):
    """One ELBO step of a stacked tier through the kernels against the plain
    step at the same draws (``make_step(module, optimizer, plain)``): the
    loss within ``loss_gate`` relative (``phase_train``'s f32 1e-6 unless a
    caller says why not) and each leaf's gradient within 1e-3 relative L2
    (``phase_train``'s f32 gate), a bit-equal rerun and (``want``) the
    launches of exactly the first kernel step; both losses are printed
    beside the plain step's in f64 (:func:`module_f64`), the measure of
    which f32 path rounds more. Returns the kernel step's gradients and
    launches."""
    snap = GradSnap(module)
    reset_counters(fl, fb)
    mk = make_step(module, snap, False)(seed, batch)
    counts = stack_counts(fl, fb)
    gk = snap.grads
    if want is not None:
        check(counts == want, f"{label}: one step launched {counts}, want {want}")
    mk2 = make_step(module, snap, False)(seed, batch)
    check(torch.equal(mk["loss"], mk2["loss"]) and all(torch.equal(gk[n], snap.grads[n])
                                                       for n in gk),
          f"{label}: the same seed gave another loss or gradient")
    mp = make_step(module, snap, True)(seed, batch)
    gp = snap.grads
    with module_f64(module) as m64:
        b64 = {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}
        m64_loss = make_step(m64, GradSnap(m64), True)(seed, b64)["loss"].item()
    lk, lp = mk["loss"].item(), mp["loss"].item()
    e_k, e_p = abs(lk - m64_loss), abs(lp - m64_loss)
    loss_rel = abs(lk - lp) / abs(lp)
    rel = {n: ((gk[n] - gp[n]).double().norm() / gp[n].double().norm().clamp_min(1e-300)).item()
           for n in gk}
    worst = max(rel, key=rel.get)
    say(f"{label}: loss kernels {lk:.9g} vs plain {lp:.9g} (rel {loss_rel:.3g}), plain in "
        f"f64 {m64_loss:.12g} (kernels {e_k / abs(m64_loss):.3g}, plain f32 "
        f"{e_p / abs(m64_loss):.3g} of it); gradients worst rel L2 {rel[worst]:.3g} "
        f"({worst}) of {len(rel)} leaves; reruns bit-equal; launches {counts}")
    check(loss_rel <= loss_gate, f"{label}: loss kernels {lk} vs plain {lp} (f64 "
          f"{m64_loss}; gate {loss_gate})")
    check(all(torch.isfinite(g).all() for g in gk.values()) and rel[worst] <= 1e-3,
          f"{label}: {worst} gradient rel L2 {rel[worst]} from the plain step")
    return gk, counts


def block22(fl, fb) -> tuple[dict, float]:
    """(b) BlockStack, 12 blocks of 768, B = 64 in 4 microbatches, S = 2:
    one ELBO step through the kernels against the plain step (#7 and #9 each
    once a block, microbatch and draw: 96), then M = 1 and M = 4 equal (out
    and log-probs 1e-6 relative) and three Adam steps timed. Returns the
    launches of the checked step and the median Adam step (ms)."""
    from bayeformers_tpu_torch.parallel import pipeline as pp
    from bayeformers_tpu_torch.workloads import stack_lm

    stack = pp.BlockStack(STACK_L, STACK_D, generator=0, device="cuda")
    X, y = stack_lm.synthetic_task(0, STACK_B, STACK_D)
    batch = {"x": torch.from_numpy(X).cuda(), "y": torch.from_numpy(y).cuda()}

    def make(module, opt, plain):
        return pp.make_pp_train_step(module, opt, n_samples=STACK_S, n_batches=1024 // STACK_B,
                                     n_microbatches=STACK_MB,
                                     loss_fn=stack_lm.classification_loss, plain=plain)

    want = stack_want({FAMILY_SHAPES[BLOCK][0]: STACK_L * STACK_MB * STACK_S})
    # the loss at 1e-5: the f32 kernels' 3xTF32 products (each within ~2e-7
    # of the exact one) compound through 12 residual GELU blocks that grow
    # the activations block by block, and the loss, the CE of logits in the
    # 1e5s, is linear in them: the kernels' loss stands 2.2e-6 from the
    # plain step in f64, the plain f32 step's 1.7e-8 (PERF.md, §6)
    _, counts = stack_step22("phase 22 (b) BlockStack step", fl, fb, stack, make, batch, 31,
                             want, loss_gate=1e-5)
    with torch.no_grad():
        one = pp.pipeline_apply(stack, 5, batch["x"], n_microbatches=1)
        four = pp.pipeline_apply(stack, 5, batch["x"], n_microbatches=STACK_MB)
    errs = [rel_err(a, b) if a.dim() else abs((a - b).item()) / abs(b.item())
            for a, b in zip(four, one)]
    say(f"phase 22 (b) BlockStack M=4 vs M=1: out, log_q, log_p rel err {errs}; "
        f"max |out| {one[0].abs().max().item():.4g}")
    check(max(errs) <= 1e-6, f"BlockStack M=4 vs M=1 differ: {errs}")
    step = make(stack, torch.optim.Adam(stack.parameters(), 1e-3, eps=1e-8), False)
    times = []
    for i in range(STACK_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = step(100 + i, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        check(math.isfinite(m["loss"].item()), f"BlockStack Adam step loss {m['loss']}")
    say(f"phase 22 (b) BlockStack Adam steps: loss {m['loss'].item():.6g}, acc "
        f"{m['acc'].item():.3f}, ms {[round(t, 3) for t in times]}")
    return counts, float(np.median(times))


def lm_batch22(vocab, seed=0) -> dict:
    from bayeformers_tpu_torch.workloads import stack_lm

    toks, tgts, mask = stack_lm.synthetic_copy_corpus(seed, LM_B, LM_T, vocab)
    return {"tokens": torch.from_numpy(toks).cuda(), "targets": torch.from_numpy(tgts).cuda(),
            "eval_mask": torch.from_numpy(mask).cuda()}


def lm_copy22(fl, fb, moe: bool) -> None:
    """(c)/(d) on a 2-block copy at full width: the logits and log-probs of
    ``lm_logits_single`` against the plain path (logits 1e-4 of the largest,
    log-probs 1e-5 relative), one step's gradients against the plain step
    (:func:`stack_step22`), the dense stack's ``make_pp_lm_train_step`` at
    M = 2 against its single step (loss 1e-6 relative, each leaf's gradient
    1e-5 relative L2), and the MoE routers' gradients non-zero."""
    from bayeformers_tpu_torch.parallel import transformer as tfm

    vocab = SWITCH_VOCAB if moe else GPT2_VOCAB
    moe_kw = dict(n_experts=SWITCH_E, ffn=STACK_FF) if moe else None
    what = "MoE (Switch-Base-8)" if moe else "dense (GPT-2 small)"
    lm = tfm.lm_init(tfm.TransformerStack(2, STACK_D, STACK_HEADS, STACK_FF, moe=moe_kw,
                                          generator=0, device="cuda"), vocab, LM_T, 1)
    batch = lm_batch22(vocab)
    with torch.no_grad():
        lk = tfm.lm_logits_single(lm, 7, batch["tokens"])
        lp = tfm.lm_logits_single(lm, 7, batch["tokens"], plain=True)
    err = rel_err(lk[0], lp[0])
    lq_err = [abs((a - b).item()) / abs(b.item()) for a, b in zip(lk[1:], lp[1:])]
    say(f"phase 22 {what}, 2 blocks: logits max|d| {err:.3g} of max |logits| "
        f"{lp[0].abs().max().item():.4g}; log_q, log_p rel err {lq_err}")
    check(err <= 1e-4 and max(lq_err) <= 1e-5, f"{what} logits or log-probs differ from plain")
    factory = tfm.make_ep_lm_train_step if moe else tfm.make_single_lm_train_step

    def make(module, opt, plain):
        return factory(module, opt, n_samples=STACK_S, n_batches=8, plain=plain)
    gk, _ = stack_step22(f"phase 22 {what} step, 2 blocks", fl, fb, lm, make, batch, 41)
    if moe:
        norms = gk["stack.moe.router"].flatten(1).norm(dim=1).tolist()
        say(f"phase 22 {what}: router gradient norm by block {norms}")
        check(all(n > 0 for n in norms), f"router gradients {norms}")
        return
    snap = GradSnap(lm)
    mpp = tfm.make_pp_lm_train_step(lm, snap, n_samples=STACK_S, n_batches=8,
                                    n_microbatches=2)(41, batch)
    snap1 = GradSnap(lm)
    m1 = make(lm, snap1, False)(41, batch)
    loss_rel = abs(mpp["loss"].item() - m1["loss"].item()) / abs(m1["loss"].item())
    rel = max(((snap.grads[n] - snap1.grads[n]).double().norm()
               / snap1.grads[n].double().norm().clamp_min(1e-300)).item() for n in snap.grads)
    say(f"phase 22 {what}: make_pp_lm_train_step (M=2) vs single step: loss rel "
        f"{loss_rel:.3g}, gradients worst rel L2 {rel:.3g}")
    check(loss_rel <= 1e-6 and rel <= 1e-5, "pp step (M=2) differs from the single step")


def lm_full22(fl, fb, moe: bool) -> tuple[dict, float, float]:
    """(c) ``stack_lm --arch transformer`` at GPT-2 small's widths (12
    blocks, B = 8, 128 positions, 64 examples) for three steps through the
    kernels, or (d) the MoE-FFN LM at Switch-Base-8's (:data:`MOE_BLOCKS22`
    blocks) through ``make_ep_lm_train_step`` at one rank for three steps;
    finite losses, the
    launches of exactly those steps (#7/#9 once a projection a draw), the
    median step time (ms) and the peak memory (GiB); (d) prints each block's
    kept and dropped tokens by expert on the first step's batch."""
    import argparse

    from bayeformers_tpu_torch.parallel import transformer as tfm
    from bayeformers_tpu_torch.workloads import stack_lm

    blocks = MOE_BLOCKS22 if moe else STACK_L
    args = argparse.Namespace(
        arch="transformer", pp=1, ep=1, heads=STACK_HEADS, seq_len=LM_T,
        vocab=SWITCH_VOCAB if moe else GPT2_VOCAB, blocks=blocks, experts=SWITCH_E,
        features=STACK_D, ffn=STACK_FF, microbatches=4, steps=STACK_STEPS,
        samples=STACK_S, batch_size=LM_B, n_examples=64, lr=1e-3, eval_every=1, seed=0,
        logs=tempfile.mkdtemp(), device="cuda")
    n = blocks * STACK_S * STACK_STEPS
    if moe:
        want = {FAMILY_SHAPES[STACK_LM][0]: n, FAMILY_SHAPES[STACK_LM][1]: n}
        want.update({s: n * SWITCH_E for s in FAMILY_SHAPES[STACK_MOE]})
    else:
        want = {s: n for s in FAMILY_SHAPES[STACK_LM]}
    torch.cuda.reset_peak_memory_stats()
    if moe:
        args.n_batches = 8
        lm, step = stack_lm.build_transformer(args, torch.device("cuda"), "ep")
        batch = lm_batch22(args.vocab, 1)
        routing = []
        route = lm.stack.moe.route
        lm.stack.moe.route = lambda r, x: routing.append(route(r, x)) or routing[-1]
        with torch.no_grad():
            tfm.lm_logits_single(lm, 3, batch["tokens"])
        del lm.stack.moe.route
        kept = [torch.bincount(r.expert[r.keep], minlength=SWITCH_E).tolist() for r in routing]
        dropped = [torch.bincount(r.expert[~r.keep], minlength=SWITCH_E).tolist()
                   for r in routing]
        say(f"phase 22 (d) tokens kept by expert, block by block (C = {MOE_C} of "
            f"{LM_ROWS}): {kept}; dropped: {dropped}")
        reset_counters(fl, fb)
        times, losses = [], []
        for i in range(STACK_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            m = step(200 + i, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            losses.append(m["loss"].item())
        counts = stack_counts(fl, fb)
        norms = lm.stack.moe.router.grad.flatten(1).norm(dim=1).tolist()
        say(f"phase 22 (d) router gradient norm by block, last step: {norms}")
        check(all(v > 0 for v in norms), f"MoE router gradients {norms}")
    else:
        reset_counters(fl, fb)
        t = time.perf_counter()
        last = stack_lm.run(args)
        counts = stack_counts(fl, fb)
        with open(os.path.join(args.logs, "stack_lm.jsonl")) as fh:
            lines = [json.loads(s) for s in fh]
        walls = [0.0] + [s["wall_s"] for s in lines]
        times = [(b - a) * 1e3 for a, b in zip(walls[:-1], walls[1:])]
        losses = [s["loss"] for s in lines]
        say(f"phase 22 (c) stack_lm --arch transformer: {last} "
            f"({time.perf_counter() - t:.2f} s with the set-up)")
    peak = torch.cuda.max_memory_allocated() / 2**30
    label = "(d) MoE LM" if moe else "(c) stack_lm"
    check(all(math.isfinite(v) for v in losses), f"{label} losses {losses}")
    check(counts == stack_want(want), f"{label} launched {counts}, want {stack_want(want)}")
    say(f"phase 22 {label}: losses {losses}, step ms {[round(t, 3) for t in times]}, "
        f"peak {peak:.3f} GiB; launches {counts}")
    return counts, float(np.median(times)), peak


def hf_state(model) -> dict:
    """A port model's parameters under HF PyTorch names: a ``kernel``
    transposed to ``weight`` (GPT-2's stored (out, in) to Conv1D's (in,
    out), a Dense's (in, out) to Linear's (out, in)), an ``embedding`` and a
    LayerNorm ``scale`` to ``weight``."""
    out = {}
    for name, p in model.named_parameters():
        head, _, leaf = name.rpartition(".")
        t = p.detach().t() if leaf == "kernel" else p.detach()
        out[f"{head}.weight" if leaf in ("kernel", "embedding", "scale") else name] = t
    return out


def write_safetensors(path, tensors: dict) -> None:
    """The safetensors format: an 8-byte little-endian header length, a JSON
    header of names, dtypes, shapes and byte offsets, then the raw
    little-endian f32 bytes."""
    import struct

    header, blobs, offset = {}, [], 0
    for name, t in tensors.items():
        b = t.float().contiguous().cpu().numpy().astype("<f4").tobytes()
        header[name] = {"dtype": "F32", "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(b)]}
        blobs.append(b)
        offset += len(b)
    h = json.dumps(header).encode()
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(h)))
        fh.write(h)
        for b in blobs:
            fh.write(b)


def pretrained22(bt) -> str:
    """(e) GPT-2 base's and LLaMA base's random state dicts (seed 0) under HF
    names in a safetensors file with their config, built by
    ``build_model(name, pretrained=DIR)`` on the card: one 8 x 128 request's
    f32 logits equal to the source model's, bit for bit."""
    import dataclasses

    from bayeformers_tpu_torch.models.gpt2 import build_gpt2

    out = []
    for name in ("gpt2", "llama"):
        if name == "gpt2":
            model = build_gpt2("base", seed=0, dtype=F32, device="cuda")
        else:
            model = bt.build_llama_family("llama", "base", seed=0, dtype=F32, device="cuda")
        cfg = {k: v for k, v in dataclasses.asdict(model.config).items() if k != "family"}
        vocab = cfg["vocab_size"]
        with tempfile.TemporaryDirectory() as d:
            with open(os.path.join(d, "config.json"), "w") as fh:
                json.dump(dict(cfg, model_type=name), fh)
            t = time.perf_counter()
            write_safetensors(os.path.join(d, "model.safetensors"), hf_state(model))
            mb = os.path.getsize(os.path.join(d, "model.safetensors")) / 2**20
            loaded = bt.build_model(name, task="causal-lm", pretrained=d, dtype=F32,
                                    device="cuda")
            load_s = time.perf_counter() - t
        gen = torch.Generator(device="cuda").manual_seed(8)
        ids = torch.randint(0, vocab, (8, 128), device="cuda", generator=gen)
        with torch.no_grad():
            want, got = model(ids), loaded(ids)
        check(torch.equal(want, got), f"{name} pretrained= logits differ: "
              f"{(want - got).abs().max().item()}")
        out.append(f"{name} base ({mb:.1f} MiB written and loaded in {load_s:.2f} s): "
                   f"8x128 logits equal to the source model's")
        del model, loaded
    return "; ".join(out)


def phase22(bt, fl, fb, moped_rho, paths) -> tuple[list[dict], dict]:
    """Phase 22 (module note): (a) #7 and #9 at the stacked tiers' new
    shapes against their plain versions (f32, mixture, S = 1); (b) BlockStack;
    (c) the dense transformer LM; (d) its MoE FFN; (e) ``pretrained=`` for
    GPT-2 and LLaMA base. Fills ``paths``; returns the rows and the step
    times (ms) and peak memories (GiB)."""
    rows, ms = [], {}

    def timed(label, fn, *args, **kwargs):
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        say(f"phase 22 {label}: {time.perf_counter() - t:.2f} s")
        return out

    for fam, path in ((BLOCK, "stack/block"), (STACK_LM, "stack/lm"), (STACK_MOE, "stack/moe")):
        rows += timed(f"(a) bayes_linear {fam}", phase_bayes_linear, fl, moped_rho, False, F32,
                      "mixture", fam, path, 1)
        rows += timed(f"(a) reduce {fam}", phase_reduce, fl, fb, moped_rho, False, "f32",
                      "mixture", fam, path, 1)
    paths["stack/block"], ms["step", "BlockStack"] = timed("(b) BlockStack", block22, fl, fb)
    for moe in (False, True):
        timed(f"({'d' if moe else 'c'}) 2 blocks", lm_copy22, fl, fb, moe)
        key, what = ("stack/moe", "MoE LM") if moe else ("stack/lm", "transformer LM")
        paths[key], ms["step", what], ms["peak GiB", what] = timed(
            f"({'d' if moe else 'c'}) 12 blocks", lm_full22, fl, fb, moe)
    say(timed("(e) pretrained=", pretrained22, bt))
    return rows, ms


# ---------------------------------------------------------------------------
# Phase 23: the data- and tensor-parallel tier (``parallel/``), two ranks
# sharing the one card over gloo (NCCL refuses two ranks on one device).
# ---------------------------------------------------------------------------
TP23 = "tp23/"      # BERT-base's shard shapes at tp = 2, M = S/2 x 8 x 128 rows
DP23 = "dp23/"      # #2 in the dp = 2 f32 step: each rank's 4 x 128 rows
LARGE23 = "large23/"  # #2 at BERT-large's widths, tp = 2 (k0 = 2048)
FAMILY_SHAPES[TP23] = ((1024, 768, 384), (1024, 768, 1536), (1024, 384, 768),
                       (1024, 1536, 768))
FAMILY_SHAPES[DP23] = ((512, 3072, 768),)
FAMILY_SHAPES[LARGE23] = ((1024, 2048, 1024),)
BERT_LARGE23 = dict(hidden_size=1024, num_attention_heads=16, intermediate_size=4096,
                    num_hidden_layers=2)
# a column (q), a row (the attention output) and a replicated (the
# classifier) leaf
LEAVES23 = ("bert/encoder/layer/0/attention/self/query/kernel",
            "bert/encoder/layer/0/attention/output/dense/kernel", "classifier/kernel")
RANKS23 = 2
# phase 23's depth cut (for the script's time limit): (a) and (b) run
# BERT-base at 6 of its 12 layers, the widths kept
DEPTH23 = dict(num_hidden_layers=6)


def rel_l2(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()


def grads23(bt, ptrain, bmodel, named, mesh, seed, batch, impl, family=BERT):
    """Loss, metrics and the rank's gradients of one ELBO objective (S=10,
    antithetic) through the rank's forward (its tp plan); gradients of the
    rank's shards."""
    for _, t, _ in named:
        t.grad = None
    mc = ptrain.make_mc(bmodel, mesh, True, "antithetic")
    loss, m = bt.training.elbo_objective(mc, seed, 10, batch, 256, impl=impl,
                                         **loss_keywords(family))
    loss.backward()
    return loss.detach(), m, {n: t.grad.clone() for n, t, _ in named}


def step_ms23(step, batch, seeds) -> float:
    """Median wall time (ms) of the given steps."""
    times = []
    for s in seeds:
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = step(s, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        check(bool(torch.isfinite(m["loss"])), f"step {s}: loss {m['loss']}")
    return float(np.median(times))


def adamw23(bt, named, clip=1.0):
    tx = bt.training.adamw_with_decay_groups(
        bt.training.linear_schedule(2e-5, 0.0, 100), 0.0, bt.training.default_no_decay,
        eps=1e-8, clip_norm=clip)
    return tx.init(named)


def dp23(bt, ptrain, coll, mesh_lib, fl, fb, at, mesh, out) -> None:
    """(a) dp = 2, f32: rank 0's loss (1e-6 relative), the gradients (1e-3
    relative L2: phase_train's f32 gates) and the updated rho (1e-4
    relative, 1e-6 absolute: the reference's dp test) of a column, a row and
    a replicated leaf against the one-process step on the whole batch at
    the same seed (rank 0 runs it first)."""
    batch = train_batch(bt)
    if mesh.rank == 0:
        one, named1 = converted_base(bt, F32, **DEPTH23)
        rho0 = {p: one.rho[p].detach().clone() for p in LEAVES23}
        step1 = bt.training.make_elbo_train_step(one, adamw23(bt, named1), 10, 256,
                                                 estimator="antithetic")
        m1 = step1(55, batch)
        ref = {p: (one.rho[p].grad.clone(), one.rho[p].detach().clone()) for p in LEAVES23}
        out["one_ms"] = step_ms23(step1, batch, (1000, 1001, 1002))
        del one, named1, step1
        torch.cuda.empty_cache()
    bmodel, named = converted_base(bt, F32, **DEPTH23)
    opt = adamw23(bt, named)
    step = ptrain.make_train_step(bmodel, opt, 10, 256, mesh, estimator="antithetic")
    local = mesh_lib.shard_batch(batch, mesh)
    reset_counters(fl, fb, at)
    m = step(55, local)
    out["paths"][DP23 + "f32"] = {fl.LAUNCHES.name: dict(fl.LAUNCHES.by_shape)}
    if mesh.rank == 0:
        rel = abs(m["loss"].item() - m1["loss"].item()) / abs(m1["loss"].item())
        check(rel <= 1e-6, f"dp=2 f32: loss {m['loss'].item()} vs one process "
              f"{m1['loss'].item()}")
        notes = [f"loss {m['loss'].item():.9g} vs one process {m1['loss'].item():.9g} "
                 f"(rel {rel:.3g})"]
        for p in LEAVES23:
            g, rho = bmodel.rho[p].grad, bmodel.rho[p].detach()
            rg = rel_l2(g, ref[p][0])
            ok = torch.allclose(rho, ref[p][1], rtol=1e-4, atol=1e-6)
            check(rg <= 1e-3 and ok, f"dp=2 f32 {p}: gradient rel L2 {rg}, updated rho max "
                  f"|d| {(rho - ref[p][1]).abs().max().item()} from the one-process step")
            notes.append(f"{p}: grad rel L2 {rg:.3g}, updated rho max |d| "
                         f"{(rho - ref[p][1]).abs().max().item():.3g}")
        say("phase 23 (a) dp=2 f32 against the one-process step: " + "; ".join(notes))
    out["dp_ms"] = step_ms23(step, local, (1000, 1001, 1002))
    grads = opt.grads()

    def reduce_once():
        coll.all_reduce_coalesced_(grads, mesh.dp_group)

    reduce_once()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        reduce_once()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    out["allreduce_ms"] = float(np.median(times))
    out["allreduce_mb"] = sum(g.numel() * g.element_size() for g in grads) / 2**20
    del bmodel, named, opt, step, grads
    torch.cuda.empty_cache()


def tp23(bt, ptrain, mesh_lib, fl, fb, at, mesh, out) -> None:
    """(b) tp = 2 on BERT-base, f32 then bf16: each rank's objective
    through the kernels against the same tp = 2 objective with
    ``impl="plain"`` at the same draws (phase_train's gates; bf16's
    LayerNorm and embedding groups against the f32 plain tp step), launch
    counts around the kernel objective, then the step timed."""
    batch = train_batch(bt)
    g32 = None
    for dtype in (F32, BF16):
        tag = TAG[dtype]
        label = f"phase 23 (b) tp=2 {tag} rank {mesh.rank}"
        bmodel, _ = converted_base(bt, dtype, **DEPTH23)
        ptrain.prepare_bayes_params(bmodel, mesh)
        named = bmodel.trainable_parameters()
        reset_counters(fl, fb, at)
        loss_k, mk, gk = grads23(bt, ptrain, bmodel, named, mesh, 123, batch, "kernel")
        out["paths"][TP23 + tag] = {c.name: dict(c.by_shape) for c in (
            fl.LAUNCHES, fb.LAUNCHES, at.LAUNCHES, at.BWD_LAUNCHES)}
        loss_k2, _, gk2 = grads23(bt, ptrain, bmodel, named, mesh, 123, batch, "kernel")
        check(torch.equal(loss_k, loss_k2) and all(torch.equal(gk[n], gk2[n]) for n in gk),
              f"{label}: the same seed gave another loss or gradient")
        loss_p, mp, gp = grads23(bt, ptrain, bmodel, named, mesh, 123, batch, "plain")
        if dtype == F32:
            rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
            check(rel <= 1e-6, f"{label}: loss {loss_k.item()} vs plain {loss_p.item()}")
            notes = [f"loss rel {rel:.3g}"]
            for group, names in grad_groups(list(gk)).items():
                r, _, at_ = worst_agreement(gk, gp, names)
                check(r <= 1e-3, f"{label}: {group} gradients rel L2 {r} at {at_}")
                notes.append(f"{group} worst rel L2 {r:.3g}")
            say(f"{label}: kernels vs plain at the same draws: " + "; ".join(notes))
            g32 = gp
        else:
            check_bf16_step(label, loss_k, loss_p, mk, mp, gk, gp, g32)
        del gk, gk2, gp
        opt = adamw23(bt, named, clip=None)
        step = ptrain.make_train_step(bmodel, opt, 10, 256, mesh, estimator="antithetic",
                                      clip_norm=1.0)
        out[f"tp_ms_{tag}"] = step_ms23(step, batch, (1000, 1001, 1002))
        del bmodel, named, opt, step
        torch.cuda.empty_cache()


def large23(bt, ptrain, mesh_lib, fl, fb, at, mesh, out) -> None:
    """(c) tp = 2 at BERT-large's widths (2 layers), f32: every shard on the
    unit grid, so the tp objective through the kernels equals the
    one-process objective through the kernels at the same seed; each
    rank's gradients against its block of the one-process gradients."""
    batch = train_batch(bt)

    def build():
        model = bt.build_model("bert-base-uncased", size="base", seed=0, dtype=F32,
                               device="cuda", **BERT_LARGE23)
        bm = bt.to_bayesian(model, delta=0.05, freeze=True)
        return bm, bm.trainable_parameters()

    one, named1 = build()
    loss1, _, g1 = grads23(bt, ptrain, one, named1, None, 77, batch, "kernel")
    del one, named1
    bmodel, _ = build()
    ptrain.prepare_bayes_params(bmodel, mesh)
    named = bmodel.trainable_parameters()
    reset_counters(fl, fb, at)
    loss, _, g = grads23(bt, ptrain, bmodel, named, mesh, 77, batch, "kernel")
    out["paths"][LARGE23 + "f32"] = {fl.LAUNCHES.name: dict(fl.LAUNCHES.by_shape)}
    specs = mesh_lib.bayes_param_specs(bmodel)
    rel = abs(loss.item() - loss1.item()) / abs(loss1.item())
    label = f"phase 23 (c) tp=2 BERT-large widths f32 rank {mesh.rank}"
    check(rel <= 1e-6, f"{label}: loss {loss.item()} vs one process {loss1.item()}")
    worst, at_ = 0.0, ""
    for name, t in g.items():
        part, path = name.split("/", 1)
        dim = mesh_lib.sharded_dim(specs[part][path])
        want = g1[name] if dim is None else mesh_lib._block(g1[name], dim, 2, mesh.tp_rank)
        r = rel_l2(t, want)
        if r > worst:
            worst, at_ = r, name
    check(worst <= 1e-3, f"{label}: gradients rel L2 {worst} at {at_}")
    say(f"{label}: loss {loss.item():.9g} vs one process {loss1.item():.9g} (rel {rel:.3g}); "
        f"gradients against the one-process blocks worst rel L2 {worst:.3g} ({at_})")
    del bmodel, named, g, g1
    torch.cuda.empty_cache()


def gpt2_23(bt, ptrain, mesh_lib, fl, fb, at, mesh, out) -> None:
    """(d) GPT-2 base, tp = 2, bf16: c_attn permuted and sharded; the
    objective through the kernels against plain at the same draws (loss 1e-2
    relative, rho gradients 5e-2 relative L2 and cosine 0.999)."""
    batch = train_batch(bt, family=GPT2)
    bmodel, _ = converted_base(bt, BF16, family=GPT2)
    ptrain.prepare_bayes_params(bmodel, mesh)
    named = bmodel.trainable_parameters()
    c_attn = "transformer/h/0/attn/c_attn/kernel"
    check(bmodel.rho[c_attn].shape == (1152, 768), f"c_attn shard {bmodel.rho[c_attn].shape}")
    loss_k, _, gk = grads23(bt, ptrain, bmodel, named, mesh, 123, batch, "kernel", GPT2)
    loss_p, _, gp = grads23(bt, ptrain, bmodel, named, mesh, 123, batch, "plain", GPT2)
    rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    r, cos, at_ = worst_agreement(gk, gp, [n for n in gk if n.startswith("rho/")])
    label = f"phase 23 (d) GPT-2 base tp=2 bf16 rank {mesh.rank}"
    check(rel <= 1e-2 and r <= 5e-2 and cos >= 0.999,
          f"{label}: loss rel {rel}, rho gradients rel L2 {r} cosine {cos} at {at_}")
    say(f"{label}: kernels vs plain: loss rel {rel:.3g}; rho gradients worst rel L2 "
        f"{r:.4g} ({at_}), worst cosine {cos:.7f}")
    del bmodel, named, gk, gp
    torch.cuda.empty_cache()


def rank23(rank: int, store_path: str, out_dir: str) -> None:
    """One rank of phase 23 (``torch.multiprocessing.spawn``): (a)-(d) over
    gloo groups on a ``FileStore``; its launch counts and times to
    ``out_dir/rank{rank}.pt``. Raises on any failed gate."""
    import torch.distributed as dist

    import bayeformers_tpu_torch as bt
    from bayeformers_tpu_torch.ops import _build
    from bayeformers_tpu_torch.ops import attention as at
    from bayeformers_tpu_torch.ops import fused_backward as fb
    from bayeformers_tpu_torch.ops import fused_linear as fl
    from bayeformers_tpu_torch.parallel import collectives as coll
    from bayeformers_tpu_torch.parallel import mesh as mesh_lib
    from bayeformers_tpu_torch.parallel import train as ptrain

    torch.cuda.set_device(0)
    require_f32_matmuls()
    _build.library()  # built by the parent before the spawn: loaded here
    store = dist.FileStore(store_path, RANKS23)

    def mesh_of(dp, tp, tag):
        return mesh_lib.make_mesh(dp, tp, backend="gloo", store=dist.PrefixStore(tag, store),
                                  rank=rank, world_size=RANKS23)

    out = {"paths": {}}
    t = time.perf_counter()
    dp23(bt, ptrain, coll, mesh_lib, fl, fb, at, mesh_of(2, 1, "a/"), out)
    out["a_s"] = time.perf_counter() - t
    tp_mesh = mesh_of(1, 2, "b/")
    for part, fn in (("b", tp23), ("c", large23), ("d", gpt2_23)):
        t = time.perf_counter()
        fn(bt, ptrain, mesh_lib, fl, fb, at, tp_mesh, out)
        out[f"{part}_s"] = time.perf_counter() - t
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def plain_logits23(bt, bmodel) -> torch.Tensor:
    """The plain forward's logits (S=10, antithetic, seed 99) of a fixed
    8 x 128 batch: the yardstick of a checkpoint's reload."""
    batch = train_batch(bt, seed=99)
    with torch.inference_mode():
        out, _ = bmodel.mc_apply_fused(99, 10, batch["input_ids"], batch["attention_mask"],
                                       batch["token_type_ids"], antithetic=True,
                                       impl="plain")
    return out.float().cpu()


def glue23(out_dir: str) -> int:
    """(e), one rank of ``bert_glue --dp 2 --backend gloo`` under
    ``torch.distributed.run`` (``chip_smoke.py --glue23 DIR``): phases A-D
    at BERT-base for two batches, the checkpoint written by rank 0, whose
    score and plain logits of the trained state go to ``DIR/glue.pt``."""
    import bayeformers_tpu_torch as bt
    from bayeformers_tpu_torch.parallel import train as ptrain
    from bayeformers_tpu_torch.workloads import bert_glue

    keep = {}
    score = bert_glue.train(limit_batches=2, epochs=1, b_epochs=1, dp=2, backend="gloo",
                            logs=os.path.join(out_dir, "logs"),
                            save_dir=os.path.join(out_dir, "ckpt"), keep=keep)
    if keep["mesh"].rank == 0:
        torch.save({"score": score, "logits": plain_logits23(bt, keep["bmodel"])},
                   os.path.join(out_dir, "glue.pt"))
    ptrain.finish()
    return 0


def phase23(bt, fl, fb, at, moped_rho, paths) -> tuple[list[dict], dict]:
    """Phase 23: the kernels at the tier's new shapes against their plain
    versions (timed; launches from the ranks' runs), then two ranks on the
    card (:func:`rank23`: (a)-(d)), then (e) the workload under
    ``torch.distributed.run`` and its checkpoint reloaded in one process."""
    import torch.multiprocessing as mp

    from bayeformers_tpu_torch.utils import checkpoint as ckpt

    rows = []
    for dtype in (BF16, F32):
        tag = TAG[dtype]
        rows += phase_bayes_linear(fl, moped_rho, True, dtype, "on_mu", TP23,
                                   path=TP23 + tag)
        rows += phase_reduce(fl, fb, moped_rho, True, tag, "on_mu", TP23, path=TP23 + tag)
        rows.append(phase_mha(at, dtype, (80, 128, 384, 6), path=TP23 + tag))
        rows.append(phase_mha_bwd(at, dtype, ((80, 128, 384),), 6, path=TP23 + tag))
    for fam in (DP23, LARGE23):
        rows += phase_bayes_linear(fl, moped_rho, True, F32, "on_mu", fam, path=fam + "f32")
    torch.cuda.empty_cache()
    ms = {}
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        mp.spawn(rank23, args=(os.path.join(tmp, "store"), tmp), nprocs=RANKS23, join=True,
                 start_method="spawn")
        ms["ranks_s"] = time.perf_counter() - t
        res = torch.load(os.path.join(tmp, "rank0.pt"), weights_only=False)
        paths.update(res["paths"])
        ms.update({k: v for k, v in res.items() if k != "paths"})
        t = time.perf_counter()
        env = dict(os.environ, OMP_NUM_THREADS="4")
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", str(RANKS23), os.path.abspath(__file__), "--glue23", tmp],
            capture_output=True, text=True, timeout=600, env=env,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        check(proc.returncode == 0, "bert_glue --dp 2 failed:\n" + proc.stdout[-4000:]
              + proc.stderr[-4000:])
        got = torch.load(os.path.join(tmp, "glue.pt"), weights_only=False)
        check(math.isfinite(got["score"]), f"bert_glue --dp 2 score {got['score']}")
        bmodel, _ = converted_base(bt, F32)
        ckpt.load_checkpoint(os.path.join(tmp, "ckpt"), bmodel, step=1)
        again = plain_logits23(bt, bmodel)
        check(torch.equal(again, got["logits"]), "the dp=2 run's checkpoint, reloaded in one "
              f"process, gives other plain logits: max |d| "
              f"{(again - got['logits']).abs().max().item()}")
        ms["glue_s"] = time.perf_counter() - t
        say(f"phase 23 (e) bert_glue --dp 2 --backend gloo (BERT-base, 2 batches, f32): score "
            f"{got['score']:.4f}; rank 0's checkpoint reloaded in one process gives its plain "
            f"logits bit for bit; {ms['glue_s']:.1f} s with the launch")
        del bmodel
    torch.cuda.empty_cache()
    return rows, ms


# ---------------------------------------------------------------------------
# Phase 24: pp and ep across ranks (the pipeline's tick schedule over the
# point-to-point shift, the expert shards, the stacked step factories and
# stack_lm --pp 2 / --ep 2), two ranks sharing the one card over gloo
# ---------------------------------------------------------------------------
# the LM's microbatch at phase 22's widths: 8 x 127 token rows in 4
# microbatches, M = 254 a projection call of a stage
PP24 = "stack-pp24/"
FAMILY_SHAPES[PP24] = tuple((LM_ROWS // STACK_MB, k, n) for _, k, n in FAMILY_SHAPES[STACK_LM])
RANKS24 = 2


def gathered24(tensors: dict, specs: dict, ranks) -> dict:
    """Each of ``tensors`` whole: those named in ``specs`` gathered over the
    ranks along their dim there (every rank calls it), the others as they
    are."""
    from bayeformers_tpu_torch.parallel import collectives as coll

    return {n: coll.gather_rows(t, ranks.group, ranks.rank, specs[n]) if n in specs else t
            for n, t in tensors.items()}


def equal_on_ranks24(t: torch.Tensor, ranks) -> bool:
    """Whether ``t`` is bit-equal on every rank (the ranks' copies side by
    side, then compared)."""
    from bayeformers_tpu_torch.parallel import collectives as coll

    both = coll.gather_rows(t[None], ranks.group, ranks.rank, 0)
    return all(torch.equal(both[0], both[i]) for i in range(1, both.shape[0]))


def steps24(step, batch, seeds) -> tuple[list[float], list[float]]:
    """Each step's wall time (ms) and loss."""
    times, losses = [], []
    for s in seeds:
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = step(s, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        losses.append(m["loss"].item())
    check(all(math.isfinite(v) for v in losses), f"losses {losses}")
    return times, losses


def against24(label, loss, ref_loss, grads, ref_grads, loss_gate=1e-6, grad_gate=1e-5) -> str:
    """Rank 0's loss (relative) and every gathered gradient (relative L2)
    against the one-process step's."""
    loss_rel = abs(loss - ref_loss) / abs(ref_loss)
    check(set(grads) == set(ref_grads), f"{label}: leaves {set(grads) ^ set(ref_grads)}")
    rel = {n: rel_l2(grads[n], ref_grads[n]) for n in grads}
    worst = max(rel, key=rel.get)
    check(loss_rel <= loss_gate, f"{label}: loss {loss} vs one process {ref_loss}")
    check(rel[worst] <= grad_gate, f"{label}: {worst} gradient rel L2 {rel[worst]} from the "
          "one-process step")
    return (f"loss {loss:.9g} vs one process {ref_loss:.9g} (rel {loss_rel:.3g}); gathered "
            f"gradients worst rel L2 {rel[worst]:.3g} ({worst}) of {len(rel)} leaves")


def block24(ranks, fl, fb, out) -> None:
    """(b) BlockStack 12 x 768 at pp = 2 (6 blocks a stage), B = 64 in 4
    microbatches, S = 2: one step's loss (1e-6 relative) and gathered
    gradients, then three Adam steps' losses (1e-6) and the gathered leaves
    after them (1e-5 relative L2), against the one-process pp = 1 steps at
    the same seeds (rank 0 runs them first); the Adam steps timed, the
    launches of #7/#9 counted around exactly them."""
    from bayeformers_tpu_torch.parallel import pipeline as pp
    from bayeformers_tpu_torch.workloads import stack_lm

    X, y = stack_lm.synthetic_task(0, STACK_B, STACK_D)
    batch = {"x": torch.from_numpy(X).cuda(), "y": torch.from_numpy(y).cuda()}
    seeds = [100 + i for i in range(STACK_STEPS)]

    def make(module, opt, group):
        return pp.make_pp_train_step(module, opt, n_samples=STACK_S, n_batches=1024 // STACK_B,
                                     n_microbatches=STACK_MB,
                                     loss_fn=stack_lm.classification_loss, group=group)

    def adam(module):
        return torch.optim.Adam(module.parameters(), 1e-3, eps=1e-8)

    if ranks.rank == 0:
        one = pp.BlockStack(STACK_L, STACK_D, generator=0, device="cuda")
        snap = GradSnap(one)
        ref_loss = make(one, snap, None)(31, batch)["loss"].item()
        _, ref_losses = steps24(make(one, adam(one), None), batch, seeds)
        ref_leaves = {n: p.detach().clone() for n, p in one.named_parameters()}
        ref_grads = snap.grads
        del one
    stack = pp.shard_stack(pp.BlockStack(STACK_L, STACK_D, generator=0, device="cuda"), ranks)
    specs = pp.stack_specs(stack)
    snap = GradSnap(stack)
    loss = make(stack, snap, ranks)(31, batch)["loss"].item()
    grads = gathered24(snap.grads, specs, ranks)
    step = make(stack, adam(stack), ranks)
    reset_counters(fl, fb)
    times, losses = steps24(step, batch, seeds)
    counts = stack_counts(fl, fb)
    n_local = STACK_L // ranks.world_size
    want = stack_want({FAMILY_SHAPES[BLOCK][0]: n_local * STACK_MB * STACK_S * STACK_STEPS})
    check(counts == want, f"pp=2 BlockStack launched {counts}, want {want}")
    leaves = gathered24({n: p.detach() for n, p in stack.named_parameters()}, specs, ranks)
    if ranks.rank == 0:
        note = against24("phase 24 (b) BlockStack pp=2", loss, ref_loss, grads, ref_grads)
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
        leaf_rel = {n: rel_l2(leaves[n], ref_leaves[n]) for n in leaves}
        check(max(rel) <= 1e-6, f"pp=2 BlockStack Adam losses {losses} vs {ref_losses}")
        check(max(leaf_rel.values()) <= 1e-5, f"pp=2 BlockStack leaves {leaf_rel}")
        say(f"phase 24 (b) BlockStack 12 x 768 at pp=2 against one process: {note}; Adam "
            f"losses rel {[f'{v:.3g}' for v in rel]}; gathered leaves after them worst rel "
            f"L2 {max(leaf_rel.values()):.3g}; step ms {[round(t, 3) for t in times]}; "
            f"launches (rank 0, the timed steps) {counts}")
    out["block_ms"] = float(np.median(times))


def lm24(ranks, fl, fb, out) -> None:
    """(c) the transformer LM at GPT-2 small's widths at pp = 2 (12 blocks,
    6 a stage; 8 x 128, 4 microbatches, S = 2): one step's loss and gathered
    gradients against the one-process ``make_pp_lm_train_step`` at the same
    microbatches (rank 0 first), the embed and pos gradients equal on both
    ranks, then three Adam steps timed with the launches of #7/#9 (at M =
    254) counted around exactly them."""
    from bayeformers_tpu_torch.parallel import pipeline as pp
    from bayeformers_tpu_torch.parallel import transformer as tfm

    def build():
        stack = tfm.TransformerStack(STACK_L, STACK_D, STACK_HEADS, STACK_FF, generator=0,
                                     device="cuda")
        return tfm.lm_init(stack, GPT2_VOCAB, LM_T, 1)

    def make(module, opt, group):
        return tfm.make_pp_lm_train_step(module, opt, n_samples=STACK_S, n_batches=8,
                                         n_microbatches=STACK_MB, group=group)

    batch = lm_batch22(GPT2_VOCAB)
    lm = build()
    if ranks.rank == 0:  # the one-process step updates nothing: its model is then cut
        snap = GradSnap(lm)
        ref_loss = make(lm, snap, None)(41, batch)["loss"].item()
        ref_grads = snap.grads
        del snap
    lm = pp.shard_stack(lm, ranks)
    snap = GradSnap(lm)
    loss = make(lm, snap, ranks)(41, batch)["loss"].item()
    tables = {n: equal_on_ranks24(snap.grads[n], ranks) for n in ("embed", "pos")}
    check(all(tables.values()), f"pp=2 LM: embed/pos gradients differ between the ranks "
          f"{tables}")
    grads = gathered24(snap.grads, pp.stack_specs(lm), ranks)
    step = make(lm, torch.optim.Adam(lm.parameters(), 1e-3, eps=1e-8), ranks)
    reset_counters(fl, fb)
    times, losses = steps24(step, batch, [200 + i for i in range(STACK_STEPS)])
    counts = stack_counts(fl, fb)
    n = (STACK_L // ranks.world_size) * STACK_MB * STACK_S * STACK_STEPS
    want = stack_want({s: n for s in FAMILY_SHAPES[PP24]})
    check(counts == want, f"pp=2 LM launched {counts}, want {want}")
    out["paths"]["stack/pp24"] = counts
    if ranks.rank == 0:
        note = against24("phase 24 (c) LM pp=2", loss, ref_loss, grads, ref_grads)
        say(f"phase 24 (c) LM at GPT-2 small's widths, pp=2 (M=4) against one process: "
            f"{note}; embed and pos gradients bit-equal on both ranks; Adam losses "
            f"{losses}, step ms {[round(t, 3) for t in times]}; launches (rank 0) {counts}")
    out["lm_ms"] = float(np.median(times))
    del lm, snap, grads, step
    torch.cuda.empty_cache()


def moe24(ranks, fl, fb, out) -> None:
    """(d) the LM with Switch-Base-8's MoE FFN at ep = 2 (8 experts, 4 a
    rank; 12 blocks, 8 x 128, S = 2): one step's loss, the routers'
    gradients (bit-equal on both ranks, 1e-5 relative L2 from one process)
    and each rank's expert gradients as slices of the one-process ones
    (gathered, 1e-5), the kept and dropped tokens by expert (equal on both
    ranks and to one process's on the same batch and draw), then three Adam
    steps timed with the launches of #7/#9 counted around exactly them."""
    from bayeformers_tpu_torch.parallel import moe as moe_lib
    from bayeformers_tpu_torch.parallel import transformer as tfm

    def build():
        stack = tfm.TransformerStack(STACK_L, STACK_D, STACK_HEADS, STACK_FF, generator=0,
                                     moe=dict(n_experts=SWITCH_E, ffn=STACK_FF),
                                     device="cuda")
        return tfm.lm_init(stack, SWITCH_VOCAB, LM_T, 1)

    def make(module, opt, group):
        return tfm.make_ep_lm_train_step(module, opt, n_samples=STACK_S, n_batches=8,
                                         group=group)

    def tokens_by_expert(module, group):
        """(L, 2, E): each block's kept and dropped tokens by expert in one
        forward of ``batch`` at draw seed 3."""
        routing = []
        route = module.stack.moe.route
        module.stack.moe.route = lambda r, x: routing.append(route(r, x)) or routing[-1]
        with torch.no_grad():
            tfm.lm_logits_single(module, 3, batch["tokens"], group=group)
        del module.stack.moe.route
        return torch.stack([torch.stack([torch.bincount(r.expert[r.keep], minlength=SWITCH_E),
                                         torch.bincount(r.expert[~r.keep],
                                                        minlength=SWITCH_E)])
                            for r in routing])

    batch = lm_batch22(SWITCH_VOCAB, 1)
    lm = build()
    if ranks.rank == 0:  # the one-process step updates nothing: its model is then cut
        ref_tokens = tokens_by_expert(lm, None)
        snap = GradSnap(lm)
        ref_loss = make(lm, snap, None)(43, batch)["loss"].item()
        ref_grads = snap.grads
        del snap
    lm = moe_lib.shard_experts(lm, ranks)
    torch.cuda.empty_cache()
    specs = moe_lib.expert_specs(lm)
    tokens = tokens_by_expert(lm, ranks)
    check(equal_on_ranks24(tokens.float(), ranks),
          "ep=2 MoE LM: the kept and dropped tokens by expert differ between the ranks")
    snap = GradSnap(lm)
    loss = make(lm, snap, ranks)(43, batch)["loss"].item()
    router_equal = equal_on_ranks24(snap.grads["stack.moe.router"], ranks)
    check(router_equal, "ep=2 MoE LM: the routers' gradients differ between the ranks")
    grads = gathered24(snap.grads, specs, ranks)
    step = make(lm, torch.optim.Adam(lm.parameters(), 1e-3, eps=1e-8), ranks)
    reset_counters(fl, fb)
    times, losses = steps24(step, batch, [300 + i for i in range(STACK_STEPS)])
    counts = stack_counts(fl, fb)
    n = STACK_L * STACK_S * STACK_STEPS
    e_local = SWITCH_E // ranks.world_size
    want = {FAMILY_SHAPES[STACK_LM][0]: n, FAMILY_SHAPES[STACK_LM][1]: n}
    want.update({s: n * e_local for s in FAMILY_SHAPES[STACK_MOE]})
    check(counts == stack_want(want), f"ep=2 MoE LM launched {counts}, want "
          f"{stack_want(want)}")
    if ranks.rank == 0:
        check(torch.equal(tokens, ref_tokens), "ep=2 MoE LM: the kept and dropped tokens by "
              f"expert {tokens.tolist()} differ from one process's {ref_tokens.tolist()}")
        note = against24("phase 24 (d) MoE LM ep=2", loss, ref_loss, grads, ref_grads)
        r_rel = rel_l2(grads["stack.moe.router"], ref_grads["stack.moe.router"])
        say(f"phase 24 (d) tokens kept by expert, block by block (C = {MOE_C} of "
            f"{LM_ROWS}), the same on both ranks and in one process: "
            f"{tokens[:, 0].tolist()}; dropped: {tokens[:, 1].tolist()}")
        say(f"phase 24 (d) MoE LM (Switch-Base-8 widths) at ep=2 against one process: {note}; "
            f"routers' gradients bit-equal on both ranks, rel L2 {r_rel:.3g} from one "
            f"process; Adam losses {losses}, step ms {[round(t, 3) for t in times]}; "
            f"launches (rank 0) {counts}")
    out["moe_ms"] = float(np.median(times))
    del lm, snap, grads, step
    torch.cuda.empty_cache()


def rank24(rank: int, store_path: str, out_dir: str) -> None:
    """One rank of phase 24 (``torch.multiprocessing.spawn``): (b)-(d) over
    gloo groups on a ``FileStore``; its launch counts and times to
    ``out_dir/rank{rank}.pt``. Raises on any failed gate."""
    import torch.distributed as dist

    from bayeformers_tpu_torch.ops import _build
    from bayeformers_tpu_torch.ops import fused_backward as fb
    from bayeformers_tpu_torch.ops import fused_linear as fl
    from bayeformers_tpu_torch.parallel import moe as moe_lib
    from bayeformers_tpu_torch.parallel import pipeline as pp

    torch.cuda.set_device(0)
    require_f32_matmuls()
    _build.library()  # built by the parent before the spawn: loaded here
    # torch.optim's first step imports torch._dynamo (seconds): not in a
    # timed step
    warm = torch.nn.Parameter(torch.zeros(1, device="cuda"))
    warm.grad = torch.zeros(1, device="cuda")
    torch.optim.Adam([warm]).step()
    store = dist.FileStore(store_path, RANKS24)
    kw = dict(backend="gloo", rank=rank, world_size=RANKS24)
    pp_ranks = pp.make_pp_mesh(RANKS24, store=dist.PrefixStore("pp/", store), **kw)
    ep_ranks = moe_lib.make_ep_mesh(RANKS24, store=dist.PrefixStore("ep/", store), **kw)
    out = {"paths": {}}
    for part, fn, ranks in (("b", block24, pp_ranks), ("c", lm24, pp_ranks),
                            ("d", moe24, ep_ranks)):
        t = time.perf_counter()
        fn(ranks, fl, fb, out)
        out[f"{part}_s"] = time.perf_counter() - t
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def flags24() -> list[str]:
    """``stack_lm``'s flags of (e): BlockStack 12 x 768 (B = 64 in 4
    microbatches) and the BayesMoE at Switch-Base-8's widths, S = 2, three
    steps, each logged."""
    flags = dict(blocks=STACK_L, features=STACK_D, experts=SWITCH_E, ffn=STACK_FF,
                 microbatches=STACK_MB, steps=STACK_STEPS, samples=STACK_S,
                 batch_size=STACK_B, eval_every=1)
    return [f"--{k.replace('_', '-')}={v}" for k, v in flags.items()]


def stack24(out_dir: str) -> int:
    """(e), one rank of ``stack_lm --pp 2`` then ``--ep 2`` with ``--backend
    gloo`` under ``torch.distributed.run`` (``chip_smoke.py --stack24
    DIR``): ``stack_lm.run`` on its parsed flags, as its CLI runs it, each
    log under DIR."""
    from bayeformers_tpu_torch.parallel import train as ptrain
    from bayeformers_tpu_torch.workloads import stack_lm

    for axis in ("pp", "ep"):
        stack_lm.run(stack_lm.parser().parse_args(
            [*flags24(), f"--{axis}", str(RANKS24), "--backend", "gloo",
             "--logs", os.path.join(out_dir, axis + "2")]))
    ptrain.finish()
    return 0


def stack_lm24(tmp: str) -> dict:
    """(e) ``stack_lm --pp 2`` and ``--ep 2`` (:func:`stack24`) under
    ``torch.distributed.run``, three steps each; the ``--pp 2`` losses
    within 1e-5 relative of ``--pp 1``'s, run here in one process. Returns
    the seconds of each."""
    from bayeformers_tpu_torch.workloads import stack_lm

    secs = {}
    t = time.perf_counter()
    one = os.path.join(tmp, "pp1")
    stack_lm.run(stack_lm.parser().parse_args([*flags24(), "--logs", one]))
    secs["pp1_s"] = time.perf_counter() - t
    t = time.perf_counter()
    env = dict(os.environ, OMP_NUM_THREADS="4")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(RANKS24), os.path.abspath(__file__), "--stack24", tmp],
        capture_output=True, text=True, timeout=600, env=env,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    check(proc.returncode == 0, "stack_lm --pp 2 / --ep 2 failed:\n" + proc.stdout[-4000:]
          + proc.stderr[-4000:])
    secs["launch_s"] = time.perf_counter() - t
    lines = {}
    for key in ("pp1", "pp2", "ep2"):
        with open(os.path.join(tmp, key, "stack_lm.jsonl")) as fh:
            lines[key] = [json.loads(s) for s in fh]
    l1, l2, le = ([s["loss"] for s in lines[k]] for k in ("pp1", "pp2", "ep2"))
    rel = [abs(a - b) / abs(b) for a, b in zip(l2, l1)]
    check(len(l2) == len(l1) == STACK_STEPS and max(rel) <= 1e-5,
          f"stack_lm --pp 2 losses {l2} vs --pp 1 {l1}")
    check(all(s["n_dev"] == RANKS24 and s["mode"] == "pp" for s in lines["pp2"]),
          f"stack_lm --pp 2 log {lines['pp2']}")
    check(len(le) == STACK_STEPS and all(math.isfinite(v) for v in le)
          and all(s["n_dev"] == RANKS24 and s["mode"] == "ep" for s in lines["ep2"]),
          f"stack_lm --ep 2 log {lines['ep2']}")
    say(f"phase 24 (e) stack_lm (BlockStack 12 x 768) --pp 2 --backend gloo losses {l2} vs "
        f"--pp 1 {l1} (rel {[f'{v:.3g}' for v in rel]}); --ep 2 (BayesMoE, 8 experts, "
        f"768 -> 3072) losses {le}; seconds {secs} (the launch runs both)")
    return secs


def phase24(bt, fl, fb, moped_rho, paths) -> tuple[list[dict], dict]:
    """Phase 24: (a) #7 and #9 at the pipeline's LM microbatch (M = 254)
    against their plain versions (f32, mixture, S = 1; launches from the
    ranks' (c)), then two ranks on the card (:func:`rank24`: (b)-(d)), then
    (e) ``stack_lm --pp 2 / --ep 2`` under ``torch.distributed.run``."""
    import torch.multiprocessing as mp

    rows = phase_bayes_linear(fl, moped_rho, False, F32, "mixture", PP24, "stack/pp24", 1)
    rows += phase_reduce(fl, fb, moped_rho, False, "f32", "mixture", PP24, "stack/pp24", 1)
    torch.cuda.empty_cache()
    ms = {}
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        mp.spawn(rank24, args=(os.path.join(tmp, "store"), tmp), nprocs=RANKS24, join=True,
                 start_method="spawn")
        ms["ranks_s"] = time.perf_counter() - t
        res = torch.load(os.path.join(tmp, "rank0.pt"), weights_only=False)
        paths.update(res["paths"])
        ms.update({k: v for k, v in res.items() if k != "paths"})
        t = time.perf_counter()
        ms.update(stack_lm24(tmp))
        ms["e_s"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    return rows, ms


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU", file=sys.stderr)
        return 2
    if "--glue23" in sys.argv:  # a rank of phase 23's (e), under torch.distributed.run
        return glue23(sys.argv[sys.argv.index("--glue23") + 1])
    if "--stack24" in sys.argv:  # a rank of phase 24's (e), under torch.distributed.run
        return stack24(sys.argv[sys.argv.index("--stack24") + 1])
    t_all = time.perf_counter()
    # ``--from 16`` (or 17) runs only the phases from there on, after the
    # build and the eps stream (a quicker check of a later slice); no
    # arguments run all
    first = int(sys.argv[sys.argv.index("--from") + 1]) if "--from" in sys.argv else 0
    import bayeformers_tpu_torch as bt
    from bayeformers_tpu_torch.core.init import moped_rho
    from bayeformers_tpu_torch.ops import _build, common
    from bayeformers_tpu_torch.ops import attention as at
    from bayeformers_tpu_torch.ops import fused_backward as fb
    from bayeformers_tpu_torch.ops import fused_linear as fl
    from bayeformers_tpu_torch.ops import logprob as lpm
    from bayeformers_tpu_torch.ops import sampled_linear as sl

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    say(smi)
    say(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    # before any f32 work: the plain versions' f32 matmuls are true f32
    require_f32_matmuls()
    say("f32 matmuls: precision 'highest', TF32 off")

    def timed(label, fn, *args, **kwargs):
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        say(f"phase {label}: {time.perf_counter() - t:.2f} s")
        return out

    t = time.perf_counter()
    lib = _build.library()
    say(f"phase build: {time.perf_counter() - t:.2f} s (nvcc {_build.last_build_seconds:.2f} s)")
    timed("eps", phase_eps, lib, common, _build)
    _build.build()
    t = time.perf_counter()
    sass = sass_mufu(_build.objects_dir())
    say(f"SASS of {SASS_SOURCES}: {time.perf_counter() - t:.2f} s")
    mufu, n_sass, loops = sass
    rate, clock = mufu_rate()
    say(f"MUFU / all instructions (cuobjdump -sass) of the draw and split ops' kernels "
        "(and of the draw kernels' loop over draws, one draw): "
        + ", ".join(f"{k} {v} / {n_sass[k]}"
                    + (" (draw loop: {} / {}, fast path {}; {} ahead of it)".format(*loops[k])
                       if "draw_kernel" in k and k in loops else "")
                    for k, v in mufu.items() if "logprob" in k or "draw_kernelIL" in k)
        + f"; MUFU rate {rate:.4g}/s (16 a clock per SM, 132 SMs, clocks.max.sm; "
        f"clocks.sm now {clock:.0f} MHz)")

    # rows: one per kernel, instance and shape; paths: the launch counts of
    # each main-path run, by counter and shape
    rows, paths, serve_ms, step_ms = [], {}, {}, {}
    est_ms, gpt2_ms, llama_ms = {}, {}, {}
    ests = ((True, "anti", "antithetic"), (False, "indep", "fused"))
    if first <= 13:
        for dtype in (BF16, F32):
            tag = TAG[dtype]
            if dtype == F32:
                rows += timed("regen (f32)", phase_regen, fl, moped_rho, sass, rate)
            for prior in PRIORS:
                for anti, key, est in ests:
                    rows += timed(f"bayes_linear ({est}, {tag}, {prior})", phase_bayes_linear,
                                  fl, moped_rho, anti, dtype, prior)
            rows.append(timed(f"mha ({tag})", phase_mha, at, dtype))
            for prior in PRIORS:
                for anti, key, est in ests:
                    paths[f"serve/{key}/{tag}{prior_suffix(prior)}"], serve_ms[key, tag, prior] = (
                        timed(f"serving ({est}, {tag}, {prior})", phase_serving, bt, fl, at,
                              anti, dtype, prior))
            for prior in PRIORS:
                for anti, key, est in ests:
                    for inst in ((tag, "bf16x-f32w") if dtype == BF16 else (tag,)):
                        rows += timed(f"reduce ({est}, {inst}, {prior})", phase_reduce, fl, fb,
                                      moped_rho, anti, inst, prior)
            rows.append(timed(f"mha_bwd ({tag})", phase_mha_bwd, at, dtype))
            for prior in PRIORS:
                for anti, key, est in ests:
                    sfx = prior_suffix(prior)
                    paths[f"train/{key}/{tag}{sfx}"], step_ms[key, tag, prior], regen = timed(
                        f"train ({est}, {tag}, {prior})", phase_train, bt, fl, at, fb, est,
                        dtype, prior)
                    if regen:
                        paths[f"regen/{key}/{tag}{sfx}"] = regen
            for samples in ((10, 3) if dtype == BF16 else (10,)):
                timed(f"workload (S={samples}, {tag})", phase_workload, fl, fb, samples,
                      dtype == BF16)

    if first <= 14:
        # phase 14: the split ops' kernels (#11-#13), then flipout, local
        # reparameterization and the naive tier
        rows += timed("logprob", phase_logprob, lpm, common, mufu, rate)
        rows += timed("split regen", phase_split_regen, sl, lpm, moped_rho, sass, rate)
        for dtype in (BF16, F32):
            rows += timed(f"sampled_dense ({TAG[dtype]})", phase_sampled_dense, sl, fl,
                          moped_rho, dtype)
        for est, dtype, prior in ESTIMATOR_RUNS:
            key = f"{est}/{TAG[dtype]}{prior_suffix(prior)}"
            (paths[f"serve/{key}"], serve_ms_, paths[f"train/{key}"], step_ms_) = timed(
                f"estimator ({est}, {TAG[dtype]}, {prior})", phase_estimator, bt, fl, fb, at,
                sl, lpm, est, dtype, prior)
            est_ms[est, TAG[dtype], prior] = (serve_ms_, step_ms_)
        for est in ("flipout", "local"):
            timed(f"workload (--estimator {est})", phase_workload_estimator, fl, fb, at, sl,
                  lpm, est)

    if first <= 15:
        # phase 15: GPT-2 base, causal LM, through the causal instances of #3/#5
        for dtype in (BF16, F32):
            tag = TAG[dtype]
            rows += timed(f"causal mha ({tag})", phase_causal_mha, at, dtype)
            for anti, key, est in ests:
                rows += timed(f"bayes_linear GPT-2 ({est}, {tag})", phase_bayes_linear, fl,
                              moped_rho, anti, dtype, "on_mu", GPT2)
                rows += timed(f"reduce GPT-2 ({est}, {tag})", phase_reduce, fl, fb, moped_rho,
                              anti, tag, "on_mu", GPT2)
            for anti, key, est in ests:
                paths[f"serve/gpt2/{key}/{tag}"], gpt2_ms["request", est, tag] = timed(
                    f"serving GPT-2 ({est}, {tag})", phase_serving_gpt2, bt, fl, at, anti,
                    dtype)
            for anti, key, est in ests:
                paths[f"train/gpt2/{key}/{tag}"], gpt2_ms["step", est, tag], _ = timed(
                    f"train GPT-2 ({est}, {tag})", phase_train, bt, fl, at, fb, est, dtype,
                    "on_mu", GPT2)
        for est, bf16 in (("naive", False), ("antithetic", True)):
            timed(f"workload gpt2_lm ({est}, {'bf16' if bf16 else 'f32'})",
                  phase_workload_gpt2, fl, fb, at, est, bf16)
        for est in ("flipout", "local"):
            (paths[f"serve/gpt2/{est}/bf16"], gpt2_ms["request", est, "bf16"],
             paths[f"train/gpt2/{est}/bf16"], gpt2_ms["step", est, "bf16"]) = timed(
                f"estimator GPT-2 ({est}, bf16)", phase_estimator, bt, fl, fb, at, sl, lpm, est,
                BF16, "on_mu", GPT2)

    if first <= 16:
        # phase 16: the LLaMA-architecture families, through the head-width-32,
        # key-tiled and #4 instances of the attention kernels
        for dtype in (BF16, F32):
            tag = TAG[dtype]
            rows += timed(f"attention 16 ({tag})", phase_attention16, at, dtype)
            for anti, key, est in ests:
                rows += timed(f"bayes_linear LLaMA ({est}, {tag})", phase_bayes_linear, fl,
                              moped_rho, anti, dtype, "on_mu", LLAMA)
            rows += timed(f"reduce LLaMA (antithetic, {tag})", phase_reduce, fl, fb, moped_rho,
                          True, tag, "on_mu", LLAMA)
            for anti, key, est in ests:
                paths[f"serve/llama/{key}/{tag}"], llama_ms["request", est, tag] = timed(
                    f"serving LLaMA ({est}, {tag})", phase_serving_gpt2, bt, fl, at, anti, dtype,
                    LLAMA)
            paths[f"train/llama/anti/{tag}"], llama_ms["step", "antithetic", tag], _ = timed(
                f"train LLaMA (antithetic, {tag})", phase_train, bt, fl, at, fb, "antithetic",
                dtype, "on_mu", LLAMA)
            for where, size, B, L, kw in (("llama-tiny", "tiny", 8, 128, {}),
                                          ("llama-long", "base", 1, 1024, {}),
                                          ("llama-tiny-long", "tiny", 1, 1024,
                                           {"max_position_embeddings": 1024})):
                step = where != "llama-tiny-long"
                (paths[f"serve/{where}/{tag}"], llama_ms["request", where, tag],
                 paths[f"train/{where}/{tag}"], llama_ms["step", where, tag]) = timed(
                    f"{where} ({tag})", phase_lm_once, bt, fl, fb, at, LLAMA, dtype, size, B, L,
                    step, **kw)
        _, llama_ms["request", "gpt2-long", "bf16"], _, _ = timed(
            "GPT-2 long (bf16)", phase_lm_once, bt, fl, fb, at, GPT2, BF16, "base", 1, 1024, False)
        for fam in (MISTRAL, GEMMA):
            _, llama_ms["request", fam[:-1], "bf16"], _, llama_ms["step", fam[:-1], "bf16"] = timed(
                f"{LM_NAME[fam]} (bf16)", phase_lm_once, bt, fl, fb, at, fam, BF16)
        for est, bf16 in (("naive", False), ("antithetic", True)):
            timed(f"workload gpt2_lm --model llama ({est}, {'bf16' if bf16 else 'f32'})",
                  phase_workload_gpt2, fl, fb, at, est, bf16, "llama")
        for est in ("flipout", "local"):
            _, llama_ms["request", est, "bf16"], _, _ = timed(
                f"estimator LLaMA ({est}, bf16)", phase_estimator, bt, fl, fb, at, sl, lpm, est,
                BF16, "on_mu", LLAMA, False)

    wide_ms = {}
    if first <= 17:
        # phase 17: the attention kernels' head widths 128 and 256, and
        # Gemma-2B and Mistral-7B at their published widths
        t17 = time.perf_counter()
        rows17, wide_ms = phase17(bt, fl, fb, at, moped_rho, paths)
        rows += rows17
        say(f"phase 17 (wide heads): {time.perf_counter() - t17:.2f} s")

    enc_ms = {}
    if first <= 18:
        # phase 18: BERT's sibling families and the SQuAD QA path
        t18 = time.perf_counter()
        rows18, enc_ms = phase18(bt, fl, fb, at, moped_rho, paths)
        rows += rows18
        say(f"phase 18 (encoder families, SQuAD): {time.perf_counter() - t18:.2f} s")

    if first <= 19:
        # phase 19: the recipes' file front end and the hand-built BayesLinear MLP
        t19 = time.perf_counter()
        rows += phase19(bt, fl, fb, at, moped_rho, paths)
        say(f"phase 19 (file front end, BayesLinear MLP): {time.perf_counter() - t19:.2f} s")

    vis_ms = {}
    if first <= 20:
        # phase 20: the vision families, convolutions and embedding tables
        t20 = time.perf_counter()
        rows20, vis_ms = phase20(bt, fl, fb, at, sl, lpm, moped_rho, paths, sass, rate)
        rows += rows20
        say(f"phase 20 (ViT, CLIP, convs, tables): {time.perf_counter() - t20:.2f} s")

    s2s_ms = {}
    if first <= 21:
        # phase 21: T5, Whisper and mc_generate
        t21 = time.perf_counter()
        rows21, s2s_ms = phase21(bt, fl, fb, at, sl, lpm, moped_rho, paths, sass, rate)
        rows += rows21
        say(f"phase 21 (T5, Whisper, mc_generate): {time.perf_counter() - t21:.2f} s")

    stack_ms = {}
    if first <= 22:
        # phase 22: the stacked tiers and pretrained= for the causal LMs
        t22 = time.perf_counter()
        rows22, stack_ms = phase22(bt, fl, fb, moped_rho, paths)
        rows += rows22
        t22 = time.perf_counter() - t22
        say(f"phase 22 (stacked tiers, pretrained= causal LMs): {t22:.2f} s")

    if first <= 23:
        # phase 23: the dp x tp tier, two ranks sharing the card over gloo
        t23 = time.perf_counter()
        rows23, ms23 = phase23(bt, fl, fb, at, moped_rho, paths)
        rows += rows23
        t23 = time.perf_counter() - t23
        say(f"phase 23 (dp x tp over gloo, two ranks on one card): {t23:.2f} s")

    # phase 24: pp and ep across ranks, two ranks sharing the card over gloo
    t24 = time.perf_counter()
    rows24, ms24 = phase24(bt, fl, fb, moped_rho, paths)
    rows += rows24
    t24 = time.perf_counter() - t24
    say(f"phase 24 (pp and ep over gloo, two ranks on one card): {t24:.2f} s")

    # each kernel's launches are those of the main-path run it serves: the
    # forward kernels' and mha_fwd's the requests', the backward kernels'
    # and regen's the train steps', each estimator's and dtype's its own,
    # the (bf16 x, f32 W) reduce's the bf16 step with save_weights=False
    # (the Gaussian instance of #11 serves no main path: its launches are 0)
    kernels = []
    for r in rows:
        n = 0 if r["path"] is None else paths[r["path"]][r["counter"]].get(r["shape"], 0)
        check(n > 0 or r["path"] is None,
              f"{r['name']} was not launched on the path it serves ({r['path']})")
        kernels.append({"name": r["name"], "route": r["route"], "source": r["source"],
                        "replaces": r["replaces"], "launches": n,
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    def medians(d):
        return "; ".join(
            f"{prior} " + ", ".join(f"{'antithetic' if k == 'anti' else 'independent'} "
                                    f"{d[k, t, prior]:.3f} ms ({t})"
                                    for t in ("bf16", "f32") for k in ("anti", "indep"))
            for prior in PRIORS)

    if first <= 13:
        say(f"{smi}; request latency 8x128 S=10: {medians(serve_ms)}")
        say(f"{smi}; ELBO step S=10 B=8 L=128: {medians(step_ms)}")
    if first <= 14:
        say(f"{smi}; request / ELBO step (S=10) by estimator: " + "; ".join(
            f"{est} ({tag}, {prior}) {a:.3f} / {b:.3f} ms"
            for (est, tag, prior), (a, b) in est_ms.items()))
    if first <= 15:
        say(f"{smi}; GPT-2 base (frozen MOPED), request 8x128 / ELBO step B=8 L=128, S=10: "
            + "; ".join(f"{est} ({tag}) {gpt2_ms['request', est, tag]:.3f} / "
                        f"{gpt2_ms['step', est, tag]:.3f} ms"
                        for (what, est, tag) in gpt2_ms if what == "request"))
    if first <= 16:
        say(f"{smi}; phase 16 (frozen MOPED, antithetic unless named), request / ELBO "
            "step, S=10: " + "; ".join(f"{what} {est} ({tag}) {v:.3f} ms"
                                       for (what, est, tag), v in llama_ms.items()
                                       if v is not None))
    if first <= 17:
        say(f"{smi}; phase 17 (frozen MOPED, antithetic, {WIDE_LAYERS} layers), request / "
            "ELBO step, S=10: " + "; ".join(f"{what} {name} ({tag}) {v:.3f} ms"
                                            for (what, name, tag), v in wide_ms.items()
                                            if v is not None))
    if first <= 18:
        say(f"{smi}; phase 18 (frozen MOPED, base width, S=10; QA 13x384, classification "
            "8x128), request / ELBO step (ms) and peak (GiB): "
            + "; ".join(f"{what} {name} ({key}) {v:.3f}"
                        for (what, name, key), v in enc_ms.items()))
    if first <= 20:
        say(f"{smi}; phase 20 (frozen MOPED, S=10, B=8 unless named), request / ELBO step "
            "(ms): " + "; ".join(f"{what} {NAMES20[which]} ({key}) {v:.3f}"
                                 for (what, which, key), v in vis_ms.items()))
    if first <= 21:
        names = dict(NAMES21, **{"gpt2/": "GPT-2 base"})
        say(f"{smi}; phase 21 (frozen MOPED 0.05, S=10, bf16; T5-small 8 x 256 -> 64, "
            f"Whisper-base 2 x 3000 frames -> 64, {SEQ2SEQ_DEPTH} + {SEQ2SEQ_DEPTH} layers), "
            "request / ELBO step (ms), mc_generate "
            "(S=4, B=2, f32) ms a generated token: "
            + "; ".join(f"{what} {names[which]} ({key}) {v:.3f}"
                        for (what, which, key), v in s2s_ms.items()))
    if first <= 22:
        say(f"{smi}; phase 22 (random init, scale mixture, f32, S=2; BlockStack 12 x 768, "
            "B=64 in 4 microbatches; LM 12 blocks at GPT-2 small's widths and "
            f"{MOE_BLOCKS22} at Switch-Base-8's, 8 x 128): "
            + "; ".join(f"{what} {name} {v:.3f}" for (what, name), v in stack_ms.items())
            + f"; phase 22 {t22:.1f} s")
    if first <= 23:
        say(f"{smi}; phase 23, two ranks sharing one card over gloo (not a scaling figure; "
            "BERT-base at 6 layers, frozen MOPED 0.05, S=10 antithetic, B=8, L=128): dp=2 "
            "f32 step "
            f"{ms23['dp_ms']:.3f} ms (the one-process f32 step on the whole batch "
            f"{ms23['one_ms']:.3f} ms); tp=2 step bf16 {ms23['tp_ms_bf16']:.3f} ms, f32 "
            f"{ms23['tp_ms_f32']:.3f} ms (medians of 3); gloo all-reduce of the dp step's "
            f"gradients ({ms23['allreduce_mb']:.1f} MiB f32, CUDA tensors) "
            f"{ms23['allreduce_ms']:.3f} ms; ranks {ms23['ranks_s']:.1f} s ((a) "
            f"{ms23['a_s']:.1f}, (b) {ms23['b_s']:.1f}, (c) {ms23['c_s']:.1f}, (d) "
            f"{ms23['d_s']:.1f} s of rank 0), (e) {ms23['glue_s']:.1f} s; phase 23 {t23:.1f} s; "
            f"total {time.perf_counter() - t_all:.1f} s")
    say(f"{smi}; phase 24, two ranks sharing one card over gloo (not a scaling figure; "
        "random init, scale mixture, f32, S=2), median of 3 steps: BlockStack 12 x 768 at "
        f"pp=2 (B=64 in 4 microbatches) {ms24['block_ms']:.3f} ms; LM at GPT-2 small's widths "
        f"at pp=2 (8 x 128, 4 microbatches) {ms24['lm_ms']:.3f} ms; with Switch-Base-8's MoE "
        f"FFN at ep=2 {ms24['moe_ms']:.3f} ms; ranks {ms24['ranks_s']:.1f} s ((b) "
        f"{ms24['b_s']:.1f}, (c) {ms24['c_s']:.1f}, (d) {ms24['d_s']:.1f} s of rank 0), (e) "
        f"{ms24['e_s']:.1f} s; phase 24 {t24:.1f} s; total {time.perf_counter() - t_all:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
