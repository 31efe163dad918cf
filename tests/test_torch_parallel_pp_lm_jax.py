"""The dense transformer LM's ``make_pp_lm_train_step`` over two ranks
(threads on gloo, ``torch_ranks.run_axis``) against the JAX package's on a
two-device mesh (``make_pp_mesh(2)``), at the JAX package's own draws and
the sizes of ``test_torch_stack_transformer.py`` (4 blocks, d_model 16, 2
heads, V = 17, T = 8): each step's loss and nll at 2e-5 on every rank, and
the whole LM (the stages gathered, the tables) after each of two steps
(Adam and SGD) at 1e-5."""
import jax
import jax.numpy as jnp
import pytest
from stack_draws import assert_tree_close, close, step_keys
from test_torch_parallel_pp_jax import PP, _steps_in_ranks
from test_torch_stack_pipeline import OPTIMIZERS
from test_torch_stack_transformer import D, FF, H, T, V, lm_batch, port_lm, torch_batch
from torch_threads import one_torch_thread  # noqa: F401

from bayeformers_tpu.parallel import pipeline as jpp
from bayeformers_tpu.parallel import transformer as jtfm
from bayeformers_tpu_torch.parallel import pipeline as tpp
from bayeformers_tpu_torch.parallel import transformer as ttfm

jax.config.update("jax_platforms", "cpu")


@pytest.fixture(scope="module")
def lm_setup():
    stack = jtfm.TransformerStack(n_blocks=4, d_model=D, n_heads=H, d_ff=FF)
    return stack, jtfm.lm_init(stack, V, T, jax.random.key(0))


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_pp2_lm_step_matches_jax(lm_setup, opt):
    """The dense LM's ``make_pp_lm_train_step`` on two stages (M = 2)
    against the JAX step on ``make_pp_mesh(2)``: the loss and nll, and the
    whole LM (stages gathered, the tables) after each of two steps."""
    stack, params = lm_setup
    jtx, ttx = OPTIMIZERS[opt]
    tx = jtx()
    jstep = jtfm.make_pp_lm_train_step(stack, tx, mesh=jpp.make_pp_mesh(PP), n_samples=2,
                                       n_batches=10, n_microbatches=2)
    batch = lm_batch(1, 8)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jparams, state, want = params, tx.init(params), []
    seeds = (400, 401)
    for seed in seeds:
        jparams, state, jm = jstep(jparams, state, jax.random.key(seed), jb)
        want.append((jm, jparams))

    got = _steps_in_ranks(
        lambda ranks: tpp.shard_stack(port_lm(params, 4), ranks),
        lambda lm, ranks: ttfm.make_pp_lm_train_step(
            lm, ttx(lm.parameters()), n_samples=2, n_batches=10, n_microbatches=2,
            group=ranks),
        torch_batch(batch), seeds, lambda seed: step_keys(seed, jax.random.key(seed), 2))
    for per_rank in got:
        for (tm, whole), (jm, jp) in zip(per_rank, want):
            close(tm["loss"], jm["loss"], 2e-5)
            close(tm["nll"], jm["nll"], 2e-5)
            assert set(tm) == set(jm)
            assert_tree_close(whole, jp)
