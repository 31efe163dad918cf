"""BayeFormers on PyTorch and CUDA: the port of ``bayeformers_tpu`` to one
NVIDIA H100.

Bayes-by-Backprop over the port's own encoders (BERT and its sibling
families DistilBERT, RoBERTa/CamemBERT, Electra and ALBERT, with
classification or span heads: ``build_model``), LLaMA-architecture
and GPT-2 causal LMs (LLaMA, Mistral, Gemma), the ViT image classifier
(``build_vit``) and the CLIP dual encoder (``build_clip``):
``to_bayesian`` converts every Linear (GPT-2's Conv1D among them) into a
Gaussian variational pair, and with ``rules=(*DEFAULT_RULES, CONV_RULE,
EMBEDDING_RULE)`` the convolutions and embedding tables too;
``training.make_elbo_train_step`` fine-tunes it by the
Monte-Carlo ELBO (``workloads/bert_glue.py`` runs the four-phase GLUE
recipe, ``workloads/bert_squad.py`` the SQuAD one, ``workloads/gpt2_lm.py``
the causal-LM one), and ``Predictor`` serves posterior-predictive
summaries (classification, span ``task="qa"`` with n-best answers, or
next-token ``task="causal-lm"``; raw strings through ``predict_texts`` and
the native tokenizers of ``native/``). The recipes read their own files:
GLUE TSVs, SQuAD JSON, MNIST idx files and text corpora (``utils/``),
local Hugging Face checkpoints (``pretrained.py``) and their own
checkpoints (``utils/checkpoint.py``). Hand-built Bayesian models compose
``nn.BayesLinear`` (``nn.bayes_apply``, ``nn.collect_kl``);
``workloads/mlp_mnist.py`` converts the reference MLP (``models/mlp.py``)
instead. The stacked hand-built tiers (``parallel/``: ``BlockStack`` and its
microbatch schedule, ``BayesMoE``, ``TransformerStack`` and its causal LM)
run on one device, and ``workloads/stack_lm.py`` trains them; the data- and
tensor-parallel tier (``parallel/mesh.py``, ``train.py``) runs the fused
step over ``torch.distributed`` ranks. The fused S-sample
forward and its backward run the Bayesian linear layers, their dmu/drho
reduce and attention on hand-written Hopper kernels (``csrc/``, built with
``nvcc`` at first use). Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; on the CPU every kernel
wrapper takes its plain-torch version.

This package imports torch, numpy and the standard library only.
"""
from bayeformers_tpu_torch import training
from bayeformers_tpu_torch.convert import from_jax_params, from_jax_stack
from bayeformers_tpu_torch.core.prior import MOPED_PRIOR_SIGMA, ScaleMixturePrior
from bayeformers_tpu_torch.models.bert import (
    BERT_BASE_KWARGS,
    BERT_TINY_KWARGS,
    build_bert,
)
from bayeformers_tpu_torch.models.clip import CLIP_TINY_KWARGS, build_clip
from bayeformers_tpu_torch.models.families import build_model
from bayeformers_tpu_torch.models.gpt2 import (
    GPT2_BASE_KWARGS,
    GPT2_TINY_KWARGS,
    build_gpt2,
)
from bayeformers_tpu_torch.models.llama import LlamaConfig, build_llama_family
from bayeformers_tpu_torch.models.mlp import build_mlp
from bayeformers_tpu_torch.models.t5 import T5_SMALL_KWARGS, T5_TINY_KWARGS, build_t5
from bayeformers_tpu_torch.models.vit import VIT_BASE_KWARGS, VIT_TINY_KWARGS, build_vit
from bayeformers_tpu_torch.models.whisper import (
    WHISPER_BASE_KWARGS,
    WHISPER_TINY_KWARGS,
    build_whisper,
)
from bayeformers_tpu_torch.nn.layers import BayesLinear, bayes_apply, collect_kl
from bayeformers_tpu_torch.nn.surgery import (
    CONV_RULE,
    DEFAULT_RULES,
    EMBEDDING_RULE,
    LINEAR_RULE,
    BayesianModel,
    ConversionRule,
    find_convertible_paths,
    to_bayesian,
)
from bayeformers_tpu_torch.pretrained import load_pretrained
from bayeformers_tpu_torch.serving import Predictor
from bayeformers_tpu_torch.training import make_elbo_train_step

__all__ = [
    "BERT_BASE_KWARGS",
    "BERT_TINY_KWARGS",
    "BayesLinear",
    "BayesianModel",
    "CLIP_TINY_KWARGS",
    "CONV_RULE",
    "ConversionRule",
    "DEFAULT_RULES",
    "EMBEDDING_RULE",
    "GPT2_BASE_KWARGS",
    "GPT2_TINY_KWARGS",
    "LINEAR_RULE",
    "LlamaConfig",
    "MOPED_PRIOR_SIGMA",
    "Predictor",
    "T5_SMALL_KWARGS",
    "T5_TINY_KWARGS",
    "VIT_BASE_KWARGS",
    "VIT_TINY_KWARGS",
    "WHISPER_BASE_KWARGS",
    "WHISPER_TINY_KWARGS",
    "ScaleMixturePrior",
    "bayes_apply",
    "build_bert",
    "build_clip",
    "build_gpt2",
    "build_llama_family",
    "build_model",
    "build_mlp",
    "build_t5",
    "build_vit",
    "build_whisper",
    "collect_kl",
    "find_convertible_paths",
    "from_jax_params",
    "from_jax_stack",
    "load_pretrained",
    "make_elbo_train_step",
    "to_bayesian",
    "training",
]
