"""The dense ``TransformerStack`` under the port's microbatch schedule
(``pipeline_apply``, ``make_pp_lm_train_step``) against the JAX package's
at pp = 1 (a one-device mesh), sizes and tolerances as in
``test_torch_stack_transformer.py``: the pipeline's outputs equal the
port's own ``apply_stack`` and the JAX pipeline's, the log-probs are
counted once per draw, and the parameters after one and two steps (Adam
and SGD, M = 2) match."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from stack_draws import close, jax_hook
from test_torch_stack_pipeline import OPTIMIZERS
from test_torch_stack_transformer import D, FF, H, T, V, check_steps, lm_batch, port_lm
from torch_threads import one_torch_thread  # noqa: F401

from bayeformers_tpu.parallel import pipeline as jpp
from bayeformers_tpu.parallel import transformer as jtfm
from bayeformers_tpu_torch.parallel import pipeline as tpp
from bayeformers_tpu_torch.parallel import sampling
from bayeformers_tpu_torch.parallel import transformer as ttfm

jax.config.update("jax_platforms", "cpu")


@pytest.fixture(scope="module")
def dense_setup():
    stack = jtfm.TransformerStack(n_blocks=4, d_model=D, n_heads=H, d_ff=FF)
    return stack, jtfm.lm_init(stack, V, T, jax.random.key(0))


def test_pipeline_matches_apply_stack_and_jax(dense_setup):
    stack, params = dense_setup
    key = jax.random.key(7)
    h = np.random.default_rng(0).normal(size=(8, T - 1, D)).astype(np.float32)
    fn = jax.shard_map(
        lambda p, k, xx: jpp.pipeline_apply(stack, p, k, xx, pp=1, n_microbatches=2),
        mesh=jpp.make_pp_mesh(1),
        in_specs=(jax.tree.map(lambda _: P("pp"), params["stack"]), P(), P()),
        out_specs=(P(), P(), P()), check_vma=False)
    want = jax.jit(fn)(params["stack"], key, jnp.asarray(h))
    port = port_lm(params, 4)
    with sampling.eps_hook(jax_hook({7: key})):
        got = tpp.pipeline_apply(port.stack, 7, torch.from_numpy(h), n_microbatches=2)
        whole = port.stack.apply_stack(7, torch.from_numpy(h))
    np.testing.assert_allclose(got[0].detach().numpy(), np.asarray(want[0]), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got[0].detach().numpy(), whole[0].detach().numpy(),
                               rtol=1e-6, atol=1e-6)
    for i in (1, 2):
        close(got[i], want[i], 2e-5)
        close(got[i], whole[i].detach(), 1e-6)


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_pp_lm_step_matches_jax(dense_setup, opt):
    stack, params = dense_setup
    jtx, ttx = OPTIMIZERS[opt]
    tx = jtx()
    jstep = jtfm.make_pp_lm_train_step(stack, tx, mesh=jpp.make_pp_mesh(1), n_samples=2,
                                       n_batches=10, n_microbatches=2)
    port = port_lm(params, 4)
    tstep = ttfm.make_pp_lm_train_step(port, ttx(port.parameters()), n_samples=2,
                                       n_batches=10, n_microbatches=2)
    check_steps(jstep, tx, params, port, tstep, lm_batch(1, 8), (400, 401))
