"""The port's data-parallel step against the JAX package's, on the CPU: two
ranks as threads over gloo (``tests/torch_ranks.py``) run
``parallel/train.py::make_train_step`` on their halves of the batch, fed the
JAX package's own draws (``tests/test_torch_training.py::_hook``), and the
JAX package's ``make_dp_train_step`` runs the same step over a dp = 2 mesh
of the host's virtual devices. Its optimizer keeps the gradients it is
given, after the dp sum: the port's gradients are held against them, each
leaf within 1e-4 of its largest entry, and the metrics within 2e-5, the
bounds of ``test_torch_parallel_tp_jax.py``. (Parameters after AdamW are
no fit here: a gradient at f32 rounding level, ~1e-9 against a leaf's
~1e-2, is one that Adam's normalisation turns into an update of ~lr/10,
whose rounding then shows at 1e-6.) ``mc_chunk`` under dp is held against
the port's one-process chunked step (``test_torch_parallel_dp.py``), which
``test_torch_training.py`` holds against the JAX package's; the file stays
under a minute without a third compile of the JAX step."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from flax.traverse_util import flatten_dict

import bayeformers_tpu as bf
from bayeformers_tpu.models import bert as jbert
from bayeformers_tpu.parallel import train as jptrain
from bayeformers_tpu_torch.parallel import mesh as mesh_lib
from bayeformers_tpu_torch.parallel import train as ptrain
from test_torch_training import N_BATCHES, _hook, _port
from torch_ranks import copy_model, optimizer, run_ranks, text_batch, whole_grads
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

S, B, L = 4, 8, 16
SEED = 21


@pytest.fixture(scope="module")
def jax_model():
    bundle = jbert.build_bert(task="classification", n_labels=2, size="tiny", seed=0,
                              num_hidden_layers=1)
    return bf.to_bayesian(bundle.apply_fn, bundle.params, delta=0.05, freeze=True)


def _keep_grads():
    """An optax transformation that updates nothing and keeps the gradients
    it is given as its state."""
    return optax.GradientTransformation(
        init=lambda params: jax.tree.map(jnp.zeros_like, params),
        update=lambda grads, state, params=None: (jax.tree.map(jnp.zeros_like, grads),
                                                  grads))


def _jax_dp_step(bmodel, bp, estimator, mc_chunk, batch):
    """The JAX package's dp = 2 step: ``(metrics, gradients)``."""
    tx = _keep_grads()
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:2]), ("dp",))
    step = jptrain.make_dp_train_step(bmodel, tx, S, N_BATCHES, mesh, estimator=estimator,
                                      mc_chunk=mc_chunk)
    sharding = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("dp"))
    jbp = jptrain.replicate(bp, mesh)
    jbatch = {k: jax.device_put(jnp.asarray(v.numpy().astype(np.int32)), sharding)
              for k, v in batch.items()}
    _, grads, m = step(jbp, tx.init(jbp), jax.random.key(SEED), jbatch)
    return {k: float(v) for k, v in m.items()}, grads


@pytest.mark.parametrize("estimator,mc_chunk", [("fused", None), ("antithetic", None)])
def test_dp2_matches_the_jax_dp_step(jax_model, estimator, mc_chunk):
    bmodel, bp = jax_model
    port = _port(bp)
    batch = text_batch(B, L, seed=SEED)
    jm, jgrads = _jax_dp_step(bmodel, bp, estimator, mc_chunk, batch)
    key = jax.random.key(SEED)
    hook = _hook(bmodel, [jax.random.split(key, S // mc_chunk) if mc_chunk else [key]])

    def rank(r, mesh):
        bm = copy_model(port)
        ptrain.prepare_bayes_params(bm, mesh)
        step = ptrain.make_train_step(bm, optimizer(bm, clip_norm=None), S, N_BATCHES,
                                      mesh, estimator=estimator, mc_chunk=mc_chunk,
                                      eps_hook=hook)
        m = step(100, mesh_lib.shard_batch(batch, mesh))
        return {k: float(v) for k, v in m.items()}, whole_grads(bm, mesh)

    jflat = flatten_dict(jgrads.params, sep="/")
    for m, grads in run_ranks(2, 1, rank):
        assert set(m) == set(jm)
        for k in ("loss", "nll", "log_prior", "log_variational_posterior"):
            np.testing.assert_allclose(m[k], jm[k], rtol=2e-5, err_msg=k)
        for k in ("acc", "acc_std"):
            np.testing.assert_allclose(m[k], jm[k], atol=1e-6, err_msg=k)
        assert len([n for n in grads if n.startswith("rho/")]) == len(bmodel.spec.paths)
        for name, g in grads.items():
            part, path = name.split("/", 1)
            w = np.asarray(jgrads.rho[path] if part == "rho" else jflat[path])
            scale = max(float(np.abs(w).max()), 1e-12)
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4 * scale,
                                       err_msg=name)
