"""The port's ``BayesMoE`` over two expert ranks (``parallel/moe.py``; ranks
as threads on gloo, ``torch_ranks.run_axis``) against the JAX package's
shard_map layer on a two-device mesh (``make_ep_mesh(2)``), at the JAX
package's own draws (``stack_draws.jax_hook``) and the sizes of
``test_torch_stack_moe.py`` (E = 4 experts, D = 16, ffn 32, T = 24 tokens,
C = 8): outputs at 1e-5, log-probs at 2e-5 relative, the router's gradient
(whole and equal on both ranks), each step's loss at 2e-5 on every rank
and the parameters after each of two steps (Adam and SGD), the experts
gathered, at 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from stack_draws import assert_tree_close, close, jax_hook, numpy_tree, step_keys
from test_torch_stack_moe import D, E, F, T
from test_torch_stack_pipeline import OPTIMIZERS, mse_jax, mse_torch
from torch_ranks import run_axis
from torch_threads import one_torch_thread  # noqa: F401

from bayeformers_tpu.parallel import moe as jmoe
from bayeformers_tpu_torch.convert import from_jax_stack
from bayeformers_tpu_torch.parallel import moe as tmoe
from bayeformers_tpu_torch.parallel import sampling

jax.config.update("jax_platforms", "cpu")
EP = 2


@pytest.fixture(scope="module")
def setup():
    moe = jmoe.BayesMoE(n_experts=E, features=D, ffn=F)
    params = moe.init_params(jax.random.key(0))
    x = np.random.default_rng(0).normal(size=(T, D)).astype(np.float32)
    return moe, params, x


def shard_moe(params, ranks):
    """The rank's experts of the JAX tree's layer (converted whole, then
    sharded)."""
    whole = from_jax_stack(numpy_tree(params), tmoe.BayesMoE(E, D, F, device="cpu"),
                           device="cpu")
    return tmoe.shard_experts(whole, ranks)


def test_apply_local_and_router_grad_match_jax(setup):
    """Every rank's output and log-probs against the JAX layer at ep = 2,
    and the router's gradient of ``sum(out^2) + (log_q - log_p) / 10``
    against the JAX package's (the reference's own test holds its ep = 4
    gradient to its one-device one)."""
    moe, params, x = setup
    key = jax.random.key(5)
    fn = jax.shard_map(
        lambda p, k, xx: moe.apply_local(p, k, xx, ep=EP, axis="ep"),
        mesh=jmoe.make_ep_mesh(EP), in_specs=(jmoe.expert_specs(), P(), P()),
        out_specs=(P(), P(), P()), check_vma=False)
    want = jax.jit(fn)(params, key, jnp.asarray(x))

    def loss(p):
        out, lq, lp = moe.apply_local(p, key, jnp.asarray(x))
        return jnp.sum(out * out) + (lq - lp) / 10.0

    want_g = np.asarray(jax.grad(loss)(params)["router"])

    def rank(r, ranks):
        port = shard_moe(params, ranks)
        out, lq, lp = port.apply_local(None, 5, torch.from_numpy(x), group=ranks)
        (torch.sum(out * out) + (lq - lp) / 10.0).backward()
        return out.detach(), lq.detach(), lp.detach(), port.router.grad.clone()

    with sampling.eps_hook(jax_hook({5: key})):
        got = run_axis(EP, "ep", rank)
    for out, lq, lp, g in got:
        np.testing.assert_allclose(out.numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-6)
        close(lq, want[1], 2e-5)
        close(lp, want[2], 2e-5)
        np.testing.assert_allclose(g.numpy(), want_g, rtol=1e-5,
                                   atol=1e-5 * np.abs(want_g).max())
    assert torch.equal(got[0][3], got[1][3])


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_ep2_train_step_matches_jax(setup, opt):
    """Two steps (S = 2) on two expert ranks against
    ``make_ep_train_step(mesh=make_ep_mesh(2))``: each step's loss, and the
    parameters (experts gathered, the router) after the first and the
    second."""
    moe, params, x = setup
    y = np.random.default_rng(1).normal(size=(T, D)).astype(np.float32)
    jtx, ttx = OPTIMIZERS[opt]
    tx = jtx()
    jstep = jmoe.make_ep_train_step(moe, tx, mesh=jmoe.make_ep_mesh(EP), n_samples=2,
                                    n_batches=10, loss_fn=mse_jax)
    jbatch = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    jparams, state, want, keys = params, tx.init(params), [], {}
    seeds = (200, 201)
    for seed in seeds:
        jparams, state, jm = jstep(jparams, state, jax.random.key(seed), jbatch)
        want.append((jm, jparams))
        keys.update(step_keys(seed, jax.random.key(seed), 2))
    tbatch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}

    def rank(r, ranks):
        port = shard_moe(params, ranks)
        step = tmoe.make_ep_train_step(port, ttx(port.parameters()), n_samples=2,
                                       n_batches=10, loss_fn=mse_torch, group=ranks)
        return [(step(seed, tbatch), tmoe.unshard_experts(port, ranks)) for seed in seeds]

    with sampling.eps_hook(jax_hook(keys)):
        got = run_axis(EP, "ep", rank)
    for per_rank in got:
        for (tm, whole), (jm, jp) in zip(per_rank, want):
            close(tm["loss"], jm["loss"], 2e-5)
            assert set(tm) == set(jm)
            assert_tree_close(whole, jp)
