"""One ELBO objective of tiny T5 in the port against ``jax.grad`` of the
reference test's loss (``tests/test_models.py:296-305``: the summed
teacher-forced CE of the S-averaged logits plus the KL over 10
minibatches), on the CPU in f32: S = 2 independent draws of the fused tier
at the JAX package's draws (``tests/test_torch_estimators.py::_hook``),
the loss within 2e-5 relative and every trained leaf's gradient within
1e-4 of its largest entry (``tests/test_torch_t5.py`` has the conversion).
"""
import jax
import jax.numpy as jnp
import numpy as np

import bayeformers_tpu as bf
from bayeformers_tpu_torch import training
from bayeformers_tpu_torch.models import t5 as tt5
from test_torch_estimators import _hook, _jax_grad, _port_grads
from test_torch_t5 import batch, pair, tensors
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)


def test_t5_elbo_grads_match_jax_grad():
    """One ELBO objective (S = 2 independent draws, 10 minibatches) at the
    JAX package's draws: the loss and every trained leaf's gradient against
    ``jax.grad`` of the reference test's loss."""
    _, bmodel, bp, port = pair()
    b = batch(2)
    key = jax.random.key(1)

    def loss_fn(p):
        out, aux = bmodel.mc_apply_fused(p, key, 2, **b)
        lp = jax.nn.log_softmax(bf.elbo.mc_logits_mean(out).astype(jnp.float32), -1)
        nll = -jnp.sum(jnp.take_along_axis(lp, jnp.asarray(b["labels"])[..., None], axis=-1))
        return bf.elbo.elbo_loss(nll, aux["log_prior"], aux["log_variational_posterior"], 10)

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(bp)
    named = port.trainable_parameters()
    mc = training.pick_mc(port, True, "fused")
    loss, _ = training.elbo_objective(mc, 0, 2, tensors(b), 10, tt5.seq2seq_loss,
                                      tt5.T5ForConditionalGeneration.input_keys,
                                      eps_hook=_hook(bmodel, key, "fused", 2))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=2e-5)
    got = _port_grads(port, named, loss)
    top = max(np.abs(_jax_grad(jgrads, n)).max() for n, _, _ in named)
    for n, _, _ in named:
        want = _jax_grad(jgrads, n)
        g = got[n].numpy() if n in got else np.zeros_like(want)
        scale = max(np.abs(want).max(), 1e-6 * top)
        assert np.abs(g - want).max() <= 1e-4 * scale, (n, np.abs(g - want).max(), scale)
