"""Local reparameterization and the naive tier against the JAX package, on
the CPU in f32: the BERT-level parity of ``tests/test_torch_estimators.py``
(a one-layer tiny Flax BERT under frozen MOPED, MOPED with a trainable mu
and random init, the JAX package's draws injected) for ``mc_apply_lrt``
and the naive tier's ``mc_apply``; and a CPU run of the GLUE workload
under flipout.
"""
from test_torch_estimators import check_against_jax, conversion  # noqa: F401 (a fixture)

from bayeformers_tpu_torch import training
from bayeformers_tpu_torch.parallel import train as ptrain
from bayeformers_tpu_torch.workloads import bert_glue
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)


def test_lrt_matches_jax(conversion):
    """Local reparameterization under each conversion against the JAX
    package (``check_against_jax``); under the mixture its KL runs through
    ``sampled_logprobs``."""
    check_against_jax(conversion, "local")


def test_naive_tier_matches_jax(conversion):
    """The naive tier (per-sample weights, one S-major super-batch) against
    the JAX package's vmap of ``apply`` over S keys (``check_against_jax``):
    logits, both log-probs and the gradients."""
    check_against_jax(conversion, "naive")


def test_bert_glue_runs_flipout_on_cpu(tmp_path, monkeypatch):
    """``bert_glue.train(estimator="flipout")`` runs phases A-D on the CPU
    at tiny size, phases C and D under flipout."""
    picked = []
    # the workloads' step factory; their eval step is make_elbo_eval_step's
    make_eval, make_step = training.make_elbo_eval_step, ptrain.make_train_step

    def spy(make):
        def run(*args, **kwargs):
            picked.append(kwargs["estimator"])
            return make(*args, **kwargs)
        return run

    monkeypatch.setattr(training, "make_elbo_eval_step", spy(make_eval))
    monkeypatch.setattr(ptrain, "make_train_step", spy(make_step))
    score = bert_glue.train(size="tiny", limit_batches=1, epochs=1, b_epochs=1, samples=2,
                            batch_size=64, estimator="flipout", device="cpu",
                            logs=str(tmp_path))
    assert 0.0 <= score <= 1.0
    assert picked == ["flipout", "flipout"]
