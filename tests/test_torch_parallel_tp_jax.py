"""The port's tensor-parallel step against the JAX package's one-device
step, on the CPU: two ranks as threads over gloo (``tests/torch_ranks.py``)
run the aligned tiny BERT's tp = 2 step fed the JAX package's own draws
(``eps_hook`` gives the whole layer's draw, of which each rank takes its
block), and every gradient, gathered from the shards, is the JAX
gradient."""
import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax.traverse_util import flatten_dict

import bayeformers_tpu as bf
import bayeformers_tpu_torch as bt
from bayeformers_tpu import elbo as jelbo
from bayeformers_tpu import training as jtraining
from bayeformers_tpu.models import bert as jbert
from bayeformers_tpu.nn import fused as jfused
from bayeformers_tpu.ops import common as jcommon
from bayeformers_tpu.ops import sampled_linear as jsl
from test_torch_parallel_tp import B, L, N_BATCHES, S, _tp_step
from torch_ranks import ALIGNED, text_batch
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)


def test_aligned_tp2_matches_the_jax_single_device_step():
    """The JAX package's one-device objective and its gradients, against
    the port's tp = 2 step fed the JAX draws, at the aligned preset's 4
    heads of 128 (2 a rank). The JAX tree holds no head count: the port is
    told it (``from_jax_params`` would take 64-wide heads)."""
    bundle = jbert.build_bert(task="classification", n_labels=2, size="tiny", seed=0,
                              **ALIGNED)
    bmodel, bp = bf.to_bayesian(bundle.apply_fn, bundle.params, delta=0.05, freeze=True)
    port = bt.from_jax_params(flatten_dict(bp.params, sep="/"),
                              {p: np.asarray(r) for p, r in bp.rho.items()},
                              prior_mu={p: np.asarray(m) for p, m in bp.prior_mu.items()},
                              num_attention_heads=ALIGNED["num_attention_heads"],
                              device="cpu")
    batch = text_batch(B, L)
    jbatch = {k: jnp.asarray(v.numpy().astype(np.int32)) for k, v in batch.items()}
    key = jax.random.key(11)

    def objective(bparams):
        out, aux = bmodel.mc_apply_fused(
            bparams, key, S, input_ids=jbatch["input_ids"],
            attention_mask=jbatch["attention_mask"],
            token_type_ids=jbatch["token_type_ids"], antithetic=True)
        nll, _ = jtraining.classification_loss(out, {"labels": jbatch["labels"]})
        return jelbo.elbo_loss(nll, aux["log_prior"], aux["log_variational_posterior"],
                               N_BATCHES)

    jloss, jgrads = jax.jit(jax.value_and_grad(objective))(bp)
    index = {p: i for i, p in enumerate(bmodel.spec.paths)}
    draws = {}
    for path in bmodel.spec.paths:
        lkey = jax.random.fold_in(key, index[path])
        shape = np.asarray(bp.rho[path]).shape
        if path.endswith("/kernel"):
            eps = jsl.naive_eps(jcommon.seed_from_key(jax.random.split(lkey, S // 2)), shape)
        else:
            eps = jfused._unit_bias_eps(lkey, S // 2, shape[0], None)
        draws[path] = torch.from_numpy(np.array(eps))

    def hook(chunk, path, n_draws, shape):
        assert tuple(draws[path].shape) == (n_draws,) + tuple(shape), path
        return draws[path]

    jflat = flatten_dict(jgrads.params, sep="/")
    want = {f"rho/{p}": torch.from_numpy(np.array(g)) for p, g in jgrads.rho.items()}
    for m2, g2, _ in _tp_step(port, batch, 1, 2, "antithetic", eps_hook=hook):
        np.testing.assert_allclose(m2["loss"], float(jloss), rtol=2e-5)
        for name, g in g2.items():
            part, path = name.split("/", 1)
            w = want[name] if part == "rho" else torch.from_numpy(np.array(jflat[path]))
            scale = max(float(w.abs().max()), 1e-12)
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4, atol=1e-4 * scale,
                                       err_msg=name)
        assert len([n for n in g2 if n.startswith("rho/")]) == len(bmodel.spec.paths)
