"""The port's Bayesian layers and S-sample tiers; the hand-built layers are
exported here as the JAX package exports its own (``bayeformers_tpu.nn``)."""
from bayeformers_tpu_torch.nn.layers import BayesLinear, bayes_apply, collect_kl

__all__ = ["BayesLinear", "bayes_apply", "collect_kl"]
