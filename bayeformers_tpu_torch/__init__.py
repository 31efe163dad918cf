"""BayeFormers on PyTorch and CUDA: the port of ``bayeformers_tpu`` to one
NVIDIA H100.

Bayes-by-Backprop over the port's own BERT: ``to_bayesian`` converts every
Linear into a Gaussian variational pair with MOPED init,
``training.make_elbo_train_step`` fine-tunes it by the Monte-Carlo ELBO
(``workloads/bert_glue.py`` runs the four-phase GLUE recipe), and
``Predictor`` serves posterior-predictive summaries. The fused S-sample
forward and its backward run the Bayesian linear layers, their dmu/drho
reduce and attention on hand-written Hopper kernels (``csrc/``, built with
``nvcc`` at first use). Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; on the CPU every kernel
wrapper takes its plain-torch version.

This package imports torch, numpy and the standard library only.
"""
from bayeformers_tpu_torch import training
from bayeformers_tpu_torch.convert import from_jax_params
from bayeformers_tpu_torch.core.prior import MOPED_PRIOR_SIGMA, ScaleMixturePrior
from bayeformers_tpu_torch.models.bert import (
    BERT_BASE_KWARGS,
    BERT_TINY_KWARGS,
    build_bert,
)
from bayeformers_tpu_torch.nn.surgery import BayesianModel, to_bayesian
from bayeformers_tpu_torch.serving import Predictor
from bayeformers_tpu_torch.training import make_elbo_train_step

__all__ = [
    "BERT_BASE_KWARGS",
    "BERT_TINY_KWARGS",
    "BayesianModel",
    "MOPED_PRIOR_SIGMA",
    "Predictor",
    "ScaleMixturePrior",
    "build_bert",
    "from_jax_params",
    "make_elbo_train_step",
    "to_bayesian",
    "training",
]
