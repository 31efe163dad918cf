"""BayeFormers on PyTorch and CUDA: the port of ``bayeformers_tpu`` to one
NVIDIA H100.

Bayes-by-Backprop over the port's own BERT: ``to_bayesian`` converts every
Linear into a Gaussian variational pair with MOPED init, and ``Predictor``
serves posterior-predictive summaries through the fused S-sample forward,
whose Bayesian linear layers and attention run on hand-written Hopper
kernels (``csrc/``, built with ``nvcc`` at first use). Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; on the CPU every kernel
wrapper takes its plain-torch version.

This package imports torch, numpy and the standard library only.
"""
from bayeformers_tpu_torch.convert import from_jax_params
from bayeformers_tpu_torch.core.prior import MOPED_PRIOR_SIGMA, ScaleMixturePrior
from bayeformers_tpu_torch.models.bert import (
    BERT_BASE_KWARGS,
    BERT_TINY_KWARGS,
    build_bert,
)
from bayeformers_tpu_torch.nn.surgery import BayesianModel, to_bayesian
from bayeformers_tpu_torch.serving import Predictor

__all__ = [
    "BERT_BASE_KWARGS",
    "BERT_TINY_KWARGS",
    "BayesianModel",
    "MOPED_PRIOR_SIGMA",
    "Predictor",
    "ScaleMixturePrior",
    "build_bert",
    "from_jax_params",
    "to_bayesian",
]
