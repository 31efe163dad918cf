"""The port's ``BayesMoE`` and ``make_ep_train_step``
(``bayeformers_tpu_torch/parallel/moe.py``) against the JAX package's at
ep = 1, at the JAX tests' sizes (E = 4 experts, D = 16, ffn 32, T = 24
tokens), at the JAX package's own draws (``stack_draws.jax_hook``): the
routing (the reference's one-hot dispatch and gated combine rebuilt from the
port's expert, slot, keep and gate), capacity overflow, outputs at 1e-5,
log-probs at 2e-5 relative, the router's gradient, and parameters after one
and two steps (Adam and SGD) at 1e-5; the same layer on two expert ranks
(threads), and a group of another size than its shards raising. The steps
over ranks are in ``test_torch_parallel_ep*.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from stack_draws import assert_tree_close, close, jax_hook, numpy_tree, step_keys
from test_torch_stack_pipeline import OPTIMIZERS, mse_jax, mse_torch
from torch_ranks import run_axis
from torch_threads import one_torch_thread  # noqa: F401

from bayeformers_tpu.parallel import moe as jmoe
from bayeformers_tpu_torch.convert import from_jax_stack
from bayeformers_tpu_torch.parallel import moe as tmoe
from bayeformers_tpu_torch.parallel import sampling

jax.config.update("jax_platforms", "cpu")
E, D, F, T = 4, 16, 32, 24


@pytest.fixture(scope="module")
def setup():
    moe = jmoe.BayesMoE(n_experts=E, features=D, ffn=F)
    params = moe.init_params(jax.random.key(0))
    x = np.random.default_rng(0).normal(size=(T, D)).astype(np.float32)
    return moe, params, x


def port_moe(params):
    return from_jax_stack(numpy_tree(params), tmoe.BayesMoE(E, D, F, device="cpu"),
                          device="cpu")


def dispatch_combine(r, E, C):
    """The reference's (T, E, C) one-hot dispatch and gated combine from the
    port's routing."""
    disp = torch.zeros(r.expert.shape[0], E, C)
    rows = torch.nonzero(r.keep)[:, 0]
    disp[rows, r.expert[rows], r.slot[rows]] = 1.0
    return disp, disp * r.gate.detach()[:, None, None]


@pytest.mark.parametrize("overflow", [False, True])
def test_route_matches_jax(setup, overflow):
    """Top-1 routing with capacity C = ceil(T / E * 1.25): the reference's
    dispatch and combine; with ``overflow`` a router that sends every token
    to expert 2, so that all but C tokens are dropped, in token order."""
    moe, params, x = setup
    router = np.array(params["router"])
    if overflow:
        router = np.zeros_like(router)
        router[:, 2] = 1.0
        x = np.abs(x)
    port = port_moe(params)
    r = port.route(torch.from_numpy(router), torch.from_numpy(x))
    C = moe.capacity(T)
    assert port.capacity(T) == C == 8
    want_d, want_c = moe.route(jnp.asarray(router), jnp.asarray(x))
    got_d, got_c = dispatch_combine(r, E, C)
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=1e-6)
    if overflow:
        assert r.keep.tolist() == [True] * C + [False] * (T - C)
        with sampling.eps_hook(jax_hook({3: jax.random.key(3)})):
            out, _, _ = port.apply_local({**port.params(), "router": torch.from_numpy(router)},
                                         3, torch.from_numpy(x))
        assert torch.count_nonzero(out[C:]) == 0 and torch.count_nonzero(out[:C]) > 0


def test_apply_local_matches_jax(setup):
    moe, params, x = setup
    key = jax.random.key(5)
    want = moe.apply_local(params, key, jnp.asarray(x))
    port = port_moe(params)
    with sampling.eps_hook(jax_hook({5: key})):
        got = port.apply_local(None, 5, torch.from_numpy(x))
    np.testing.assert_allclose(got[0].detach().numpy(), np.asarray(want[0]), rtol=1e-5,
                               atol=1e-6)
    close(got[1], want[1], 2e-5)
    close(got[2], want[2], 2e-5)


def test_router_gradient_matches_jax(setup):
    """The raw gradient of ``sum(out^2) + (log_q - log_p) / 10`` with respect
    to the router (the reference's ``test_moe_router_grad_not_optimizer_masked``
    loss): through the gates only, as the reference's."""
    moe, params, x = setup
    key = jax.random.key(4)

    def loss(p):
        out, lq, lp = moe.apply_local(p, key, jnp.asarray(x))
        return jnp.sum(out * out) + (lq - lp) / 10.0

    want = np.asarray(jax.grad(loss)(params)["router"])
    port = port_moe(params)
    with sampling.eps_hook(jax_hook({4: key})):
        out, lq, lp = port.apply_local(None, 4, torch.from_numpy(x))
    (torch.sum(out * out) + (lq - lp) / 10.0).backward()
    got = port.router.grad.numpy()
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_draws_ignore_routing(setup):
    """Every expert is sampled and counted each draw, whatever the routing:
    the same draws (and log-probs) for another input that routes otherwise."""
    _, params, x = setup
    port = port_moe(params)
    asked, lqs = [], []
    for xs in (x, x[::-1].copy() * 3.0):
        hook = jax_hook({7: jax.random.key(7)})
        with sampling.eps_hook(hook), torch.no_grad():
            r = port.route(port.router, torch.from_numpy(xs))
            _, lq, lp = port.apply_local(None, 7, torch.from_numpy(xs))
        asked.append(sorted(set(hook.asked)))
        lqs.append((lq, lp, r.expert))
    assert asked[0] == asked[1] == sorted((7, (e, j), w) for e in range(E) for j in (0, 1)
                                          for w in ("kernel", "bias"))
    assert not torch.equal(lqs[0][2], lqs[1][2])
    assert torch.equal(lqs[0][0], lqs[1][0]) and torch.equal(lqs[0][1], lqs[1][1])


def test_group_of_two_ranks_runs(setup):
    """The same call on two expert ranks (ranks as threads, the layer cut
    by ``shard_experts``) gives every rank the JAX layer's output and
    log-probs."""
    moe, params, x = setup
    key = jax.random.key(5)
    want = moe.apply_local(params, key, jnp.asarray(x))

    def rank(r, ranks):
        with torch.no_grad():
            return tmoe.shard_experts(port_moe(params), ranks).apply_local(
                None, 5, torch.from_numpy(x), group=ranks)

    with sampling.eps_hook(jax_hook({5: key})):
        got = run_axis(2, "ep", rank)
    for out, lq, lp in got:
        np.testing.assert_allclose(out.numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-6)
        close(lq, want[1], 2e-5)
        close(lp, want[2], 2e-5)


def test_group_of_another_size_raises(setup):
    """A whole layer on a group of two raises, naming the mismatch."""
    _, params, x = setup
    with pytest.raises(ValueError, match="a group of 2 ranks, but the module is cut into 1"):
        run_axis(2, "ep", lambda r, ranks: port_moe(params).apply_local(
            None, 1, torch.from_numpy(x), group=ranks))


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_ep_train_step_matches_jax(setup, opt):
    """Two steps (S = 2): each step's loss and the parameters, router
    included, after the first and the second."""
    moe, params, x = setup
    y = np.random.default_rng(1).normal(size=(T, D)).astype(np.float32)
    jtx, ttx = OPTIMIZERS[opt]
    tx = jtx()
    jstep = jmoe.make_ep_train_step(moe, tx, mesh=jmoe.make_ep_mesh(1), n_samples=2,
                                    n_batches=10, loss_fn=mse_jax)
    port = port_moe(params)
    tstep = tmoe.make_ep_train_step(port, ttx(port.parameters()), n_samples=2,
                                    n_batches=10, loss_fn=mse_torch)
    jbatch = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    tbatch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    jparams, state = params, tx.init(params)
    for seed in (200, 201):
        key = jax.random.key(seed)
        jparams, state, jm = jstep(jparams, state, key, jbatch)
        with sampling.eps_hook(jax_hook(step_keys(seed, key, 2))):
            tm = tstep(seed, tbatch)
        close(tm["loss"], jm["loss"], 2e-5)
        assert set(tm) == set(jm)
        assert_tree_close(port, jparams)
