"""GPT-2 at tp = 2 against the JAX package's one-device step, on the CPU:
two ranks as threads over gloo (``tests/torch_ranks.py``) run the tiny
GPT-2's tp = 2 step, its packed c_attn permuted to the head-aligned layout
(``parallel/mesh.py::permute_gpt2_qkv``), fed the JAX package's own draws
(each leaf's whole draw, the c_attn draw permuted as its weight is, of
which each rank takes its block). The loss is the JAX objective's and
every gradient, gathered from the shards and un-permuted, the JAX
gradient: loss 2e-5 relative, each leaf within 1e-4 of its largest entry,
the bounds of ``test_torch_parallel_tp_jax.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import bayeformers_tpu as bf
import bayeformers_tpu_torch as bt
from bayeformers_tpu import elbo as jelbo
from bayeformers_tpu.models import gpt2 as jgpt2
from bayeformers_tpu.workloads import gpt2_lm as jgpt2_lm
from bayeformers_tpu_torch.parallel import mesh as mesh_lib
from bayeformers_tpu_torch.parallel import train as ptrain
from bayeformers_tpu_torch.workloads.gpt2_lm import lm_loss
from test_torch_bert import _jax_hook
from torch_ranks import copy_model, optimizer, run_ranks, whole_grads
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

S, B, L, N_BATCHES = 4, 4, 16, 10
TP = 2


@pytest.fixture(scope="module")
def jax_model():
    bundle = jgpt2.build_gpt2(size="tiny", seed=0, n_layer=1)
    # zero leaves (the biases) at 0.01, so that MOPED gives them a sigma
    params = jax.tree.map(lambda a: jnp.where(a == 0, jnp.full_like(a, 0.01), a),
                          bundle.params)
    bmodel, bp = bf.to_bayesian(bundle.apply_fn, params, delta=0.05, freeze=True)
    return bundle, bmodel, bp


@pytest.mark.parametrize("estimator", ["antithetic", "fused"])
def test_gpt2_tp2_matches_the_jax_single_device_step(jax_model, estimator):
    bundle, bmodel, bp = jax_model
    port = bt.from_jax_params(flatten_dict(bp.params, sep="/"),
                              {p: np.asarray(r) for p, r in bp.rho.items()},
                              prior_mu={p: np.asarray(m) for p, m in bp.prior_mu.items()},
                              num_attention_heads=bundle.config.n_head, device="cpu")
    ids = np.random.default_rng(0).integers(0, bundle.config.vocab_size, (B, L))
    key = jax.random.key(5)

    def objective(bparams):
        out, aux = bmodel.mc_apply_fused(bparams, key, S, input_ids=jnp.asarray(ids),
                                         antithetic=estimator == "antithetic")
        nll, _ = jgpt2_lm.lm_loss(out, {"input_ids": jnp.asarray(ids)})
        return jelbo.elbo_loss(nll, aux["log_prior"], aux["log_variational_posterior"],
                               N_BATCHES)

    jloss, jgrads = jax.jit(jax.value_and_grad(objective))(bp)
    jax_draw = _jax_hook(bmodel, key)

    def hook(chunk, path, n_draws, shape):
        eps = jax_draw(path, n_draws, shape)
        if "c_attn" in path:
            eps = eps[..., torch.from_numpy(mesh_lib._qkv_perm(eps.shape[-1] // 3, TP))]
        return eps

    def rank(r, mesh):
        bm = copy_model(port)
        ptrain.prepare_bayes_params(bm, mesh)
        assert mesh_lib.needs_qkv_perm(bm.spec.paths, mesh.tp)
        step = ptrain.make_train_step(bm, optimizer(bm, clip_norm=None), S, N_BATCHES, mesh,
                                      loss_fn=lm_loss, input_keys=("input_ids",),
                                      estimator=estimator, eps_hook=hook)
        m = step(5, {"input_ids": torch.from_numpy(ids)})
        grads = {n: (mesh_lib._permuted(g, mesh.tp, inverse=True) if "c_attn" in n else g)
                 for n, g in whole_grads(bm, mesh).items()}
        return {k: float(v) for k, v in m.items()}, grads

    jflat = flatten_dict(jgrads.params, sep="/")
    for m, grads in run_ranks(1, TP, rank):
        np.testing.assert_allclose(m["loss"], float(jloss), rtol=2e-5)
        assert len([n for n in grads if n.startswith("rho/")]) == len(bmodel.spec.paths)
        for name, g in grads.items():
            part, path = name.split("/", 1)
            w = np.asarray(jgrads.rho[path] if part == "rho" else jflat[path])
            scale = max(float(np.abs(w).max()), 1e-12)
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4 * scale,
                                       err_msg=name)
