"""The port's ``BlockStack`` pipeline over two ranks
(``parallel/pipeline.py``; ranks as threads on gloo,
``torch_ranks.run_axis``) against the JAX package's shard_map
pipeline on a two-device mesh (``make_pp_mesh(2)``), at the JAX package's
own draws (``stack_draws.jax_hook``) and the sizes of
``test_torch_stack_pipeline.py``: outputs at 1e-5, log-probs at 2e-5
relative, each step's loss and nll at 2e-5 on every rank, and the
parameters after each of two steps (Adam and SGD), the stages' blocks
gathered, at 1e-5. The LM's steps are in ``test_torch_parallel_pp_lm_jax.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from stack_draws import assert_tree_close, close, jax_hook, numpy_tree, step_keys
from test_torch_stack_pipeline import B, D, L, OPTIMIZERS, mse_jax, mse_torch
from torch_ranks import run_axis
from torch_threads import one_torch_thread  # noqa: F401

from bayeformers_tpu.parallel import pipeline as jpp
from bayeformers_tpu_torch.convert import from_jax_stack
from bayeformers_tpu_torch.parallel import pipeline as tpp
from bayeformers_tpu_torch.parallel import sampling

jax.config.update("jax_platforms", "cpu")
PP = 2


@pytest.fixture(scope="module")
def setup():
    stack = jpp.BlockStack(n_blocks=L, features=D)
    params = stack.init_stack(jax.random.key(0))
    x = np.random.default_rng(0).normal(size=(B, D)).astype(np.float32)
    return stack, params, x


def stage_stack(params, ranks):
    """The rank's stage of the JAX tree's stack (converted whole, then
    sharded)."""
    whole = from_jax_stack(numpy_tree(params), tpp.BlockStack(L, D, device="cpu"),
                           device="cpu")
    return tpp.shard_stack(whole, ranks)


@pytest.mark.parametrize("m", [1, 2, 4])
def test_pipeline_apply_matches_jax(setup, m):
    """Every rank's output and log-probs against the JAX pipeline at pp = 2
    (M + 1 ticks)."""
    stack, params, x = setup
    key = jax.random.key(7)
    fn = jax.shard_map(
        lambda p, k, xx: jpp.pipeline_apply(stack, p, k, xx, pp=PP, n_microbatches=m),
        mesh=jpp.make_pp_mesh(PP), in_specs=(jpp.stack_specs(), P(), P()),
        out_specs=(P(), P(), P()), check_vma=False)
    want = jax.jit(fn)(params, key, jnp.asarray(x))

    def rank(r, ranks):
        port = stage_stack(params, ranks)
        with torch.no_grad():
            return tpp.pipeline_apply(port, 5, torch.from_numpy(x), n_microbatches=m,
                                      group=ranks)

    with sampling.eps_hook(jax_hook({5: key})):
        got = run_axis(PP, "pp", rank)
    for h, lq, lp in got:
        np.testing.assert_allclose(h.numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-6)
        close(lq, want[1], 2e-5)
        close(lp, want[2], 2e-5)


def _steps_in_ranks(make_port, make_step, batch, seeds, keys_of):
    """Each rank's metrics of the steps and the whole module gathered after
    each step."""
    def rank(r, ranks):
        port = make_port(ranks)
        step = make_step(port, ranks)
        out = []
        for seed in seeds:
            m = step(seed, batch)
            out.append((m, tpp.unshard_stack(port, ranks)))
        return out

    hooks = {}
    for seed in seeds:
        hooks.update(keys_of(seed))
    with sampling.eps_hook(jax_hook(hooks)):
        return run_axis(PP, "pp", rank)


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_pp2_train_step_matches_jax(setup, opt):
    """Two steps (S = 2, M = 2) on two stages against
    ``make_pp_train_step(mesh=make_pp_mesh(2))``."""
    stack, params, x = setup
    y = np.random.default_rng(1).normal(size=(B, D)).astype(np.float32)
    jtx, ttx = OPTIMIZERS[opt]
    tx = jtx()
    jstep = jpp.make_pp_train_step(stack, tx, mesh=jpp.make_pp_mesh(PP), n_samples=2,
                                   n_batches=10, n_microbatches=2, loss_fn=mse_jax)
    jbatch = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    jparams, state, want = params, tx.init(params), []
    seeds = (100, 101)
    for seed in seeds:
        jparams, state, jm = jstep(jparams, state, jax.random.key(seed), jbatch)
        want.append((jm, jparams))

    got = _steps_in_ranks(
        lambda ranks: stage_stack(params, ranks),
        lambda port, ranks: tpp.make_pp_train_step(
            port, ttx(port.parameters()), n_samples=2, n_batches=10, n_microbatches=2,
            loss_fn=mse_torch, group=ranks),
        {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}, seeds,
        lambda seed: step_keys(seed, jax.random.key(seed), 2))
    for per_rank in got:
        for (tm, whole), (jm, jp) in zip(per_rank, want):
            close(tm["loss"], jm["loss"], 2e-5)
            close(tm["nll"], jm["nll"], 2e-5)
            assert set(tm) == set(jm)
            assert_tree_close(whole, jp)
