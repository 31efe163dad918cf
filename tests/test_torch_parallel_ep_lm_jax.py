"""The MoE-FFN transformer LM's ``make_ep_lm_train_step`` over two expert
ranks (threads on gloo, ``torch_ranks.run_axis``) against the JAX
package's on a two-device mesh (``make_ep_mesh(2)``), at the JAX package's
own draws and the sizes of ``test_torch_stack_transformer_moe.py`` (2
blocks, 4 experts of ffn 32, d_model 16, 2 heads, V = 17, T = 8): each
step's loss and nll at 2e-5 on every rank, and the whole LM (every block's
experts gathered, the routers, attention, LayerNorms and tables) after
each of two steps (Adam and SGD) at 1e-5."""
import jax
import jax.numpy as jnp
import pytest
from stack_draws import assert_tree_close, close, jax_hook, step_keys
from test_torch_stack_pipeline import OPTIMIZERS
from test_torch_stack_transformer import D, FF, H, T, V, lm_batch, port_lm, torch_batch
from test_torch_stack_transformer_moe import MOE
from torch_ranks import run_axis
from torch_threads import one_torch_thread  # noqa: F401

from bayeformers_tpu.parallel import moe as jmoe
from bayeformers_tpu.parallel import transformer as jtfm
from bayeformers_tpu_torch.parallel import moe as tmoe
from bayeformers_tpu_torch.parallel import sampling
from bayeformers_tpu_torch.parallel import transformer as ttfm

jax.config.update("jax_platforms", "cpu")
EP = 2


@pytest.fixture(scope="module")
def moe_setup():
    moe = jmoe.BayesMoE(n_experts=4, features=D, ffn=32)
    stack = jtfm.TransformerStack(n_blocks=2, d_model=D, n_heads=H, d_ff=FF, moe=moe)
    return stack, jtfm.lm_init(stack, V, T, jax.random.key(1))


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_ep2_lm_step_matches_jax(moe_setup, opt):
    stack, params = moe_setup
    jtx, ttx = OPTIMIZERS[opt]
    tx = jtx()
    jstep = jtfm.make_ep_lm_train_step(stack, tx, mesh=jmoe.make_ep_mesh(EP), n_samples=2,
                                       n_batches=10)
    batch = lm_batch(1, 8)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jparams, state, want, keys = params, tx.init(params), [], {}
    seeds = (500, 501)
    for seed in seeds:
        jparams, state, jm = jstep(jparams, state, jax.random.key(seed), jb)
        want.append((jm, jparams))
        keys.update(step_keys(seed, jax.random.key(seed), 2))
    tb = torch_batch(batch)

    def rank(r, ranks):
        lm = tmoe.shard_experts(port_lm(params, 2, MOE), ranks)
        step = ttfm.make_ep_lm_train_step(lm, ttx(lm.parameters()), n_samples=2,
                                          n_batches=10, group=ranks)
        return [(step(seed, tb), tmoe.unshard_experts(lm, ranks)) for seed in seeds]

    with sampling.eps_hook(jax_hook(keys)):
        got = run_axis(EP, "ep", rank)
    for per_rank in got:
        for (tm, whole), (jm, jp) in zip(per_rank, want):
            close(tm["loss"], jm["loss"], 2e-5)
            close(tm["nll"], jm["nll"], 2e-5)
            assert set(tm) == set(jm)
            assert_tree_close(whole, jp)
