"""The port's ``BlockStack``, ``pipeline_apply`` and ``make_pp_train_step``
(``bayeformers_tpu_torch/parallel/pipeline.py``) against the JAX package's
at pp = 1 (a one-device mesh), at the JAX tests' sizes (4 blocks of 32), at
the JAX package's own draws (``stack_draws.jax_hook``): outputs at 1e-5,
log-probs at 2e-5 relative (XLA's CPU sums), parameters after one and two
steps (Adam and SGD) at 1e-5; the same pipeline on two stages (ranks as
threads), and a group of another size than the stack's shards raising.
The steps over ranks are in ``test_torch_parallel_pp*.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P
from stack_draws import assert_tree_close, close, jax_hook, numpy_tree, step_keys
from torch_ranks import run_axis
from torch_threads import one_torch_thread  # noqa: F401

from bayeformers_tpu.parallel import pipeline as jpp
from bayeformers_tpu_torch.convert import from_jax_stack
from bayeformers_tpu_torch.parallel import pipeline as tpp
from bayeformers_tpu_torch.parallel import sampling

jax.config.update("jax_platforms", "cpu")
L, D, B = 4, 32, 8


@pytest.fixture(scope="module")
def setup():
    stack = jpp.BlockStack(n_blocks=L, features=D)
    params = stack.init_stack(jax.random.key(0))
    x = np.random.default_rng(0).normal(size=(B, D)).astype(np.float32)
    return stack, params, x


def port_stack(params):
    return from_jax_stack(numpy_tree(params), tpp.BlockStack(L, D, device="cpu"),
                          device="cpu")


def jax_pipeline(stack, params, key, x, m):
    fn = jax.shard_map(
        lambda p, k, xx: jpp.pipeline_apply(stack, p, k, xx, pp=1, n_microbatches=m),
        mesh=jpp.make_pp_mesh(1), in_specs=(jpp.stack_specs(), P(), P()),
        out_specs=(P(), P(), P()), check_vma=False)
    return jax.jit(fn)(params, key, jnp.asarray(x))


def test_block_apply_matches_jax(setup):
    stack, params, x = setup
    key = jax.random.key(3)
    leaf = {k: v[2] for k, v in params.items()}
    want = stack.block_apply(leaf, key, jnp.int32(2), jnp.asarray(x))
    port = port_stack(params)
    with sampling.eps_hook(jax_hook({11: key})):
        got = port.block_apply(port.leaves()[2], 11, 2, torch.from_numpy(x))
    close(got[0], want[0], 1e-5)
    close(got[1], want[1], 2e-5)
    close(got[2], want[2], 2e-5)


@pytest.mark.parametrize("m", [1, 2, 8])
def test_pipeline_apply_matches_jax(setup, m):
    """M = 1, 2 and 8 microbatches (mb = 8, 4, 1): the reference's outputs
    and its probe's log-probs (once per draw)."""
    stack, params, x = setup
    key = jax.random.key(7)
    want_h, want_lq, want_lp = jax_pipeline(stack, params, key, x, m)
    port = port_stack(params)
    with sampling.eps_hook(jax_hook({5: key})):
        h, lq, lp = tpp.pipeline_apply(port, 5, torch.from_numpy(x), n_microbatches=m)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(want_h), rtol=1e-5, atol=1e-6)
    close(lq, want_lq, 2e-5)
    close(lp, want_lp, 2e-5)


def test_draws_ignore_input_and_microbatches(setup):
    """A block's draw is a function of (seed, block) only: the port's own
    stream gives the same log-probs for another input and another
    microbatch count, the reference's probe on ``dummy_input()`` gives the
    first microbatch's, and the hook is asked for the same draws."""
    _, params, x = setup
    port = port_stack(params)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        h1, lq1, lp1 = tpp.pipeline_apply(port, 9, xt, n_microbatches=1)
        h4, lq4, lp4 = tpp.pipeline_apply(port, 9, xt * 2.0 + 1.0, n_microbatches=4)
        h1b, _, _ = tpp.pipeline_apply(port, 9, xt, n_microbatches=4)
        probe = [port.block_apply(leaf, 9, l, port.dummy_input())
                 for l, leaf in enumerate(port.leaves())]
        other = tpp.pipeline_apply(port, 10, xt, n_microbatches=1)
    assert torch.equal(lq1, lq4) and torch.equal(lp1, lp4)
    assert torch.equal(h1, h1b)
    np.testing.assert_allclose(float(sum(q for _, q, _ in probe)), float(lq1), rtol=1e-6)
    np.testing.assert_allclose(float(sum(p for _, _, p in probe)), float(lp1), rtol=1e-6)
    assert not torch.equal(other[0], h1)
    hooks = []
    for m, scale in ((1, 1.0), (4, 3.0)):
        hook = jax_hook({9: jax.random.key(9)})
        with sampling.eps_hook(hook):
            tpp.pipeline_apply(port, 9, xt * scale, n_microbatches=m)
        hooks.append(sorted(set(hook.asked)))
    assert hooks[0] == hooks[1] == sorted((9, (l,), w) for l in range(L)
                                          for w in ("kernel", "bias"))


def test_batch_not_divisible_raises(setup):
    _, params, x = setup
    with pytest.raises(ValueError, match="microbatches"):
        tpp.pipeline_apply(port_stack(params), 1, torch.from_numpy(x), n_microbatches=3)


def test_group_of_two_ranks_runs(setup):
    """The same call on two stages (ranks as threads, the stack sharded by
    ``shard_stack``) gives every rank the one-rank pipeline's output and
    log-probs, and the JAX package's."""
    stack, params, x = setup
    key = jax.random.key(7)
    want = jax_pipeline(stack, params, key, x, 2)

    def rank(r, ranks):
        with torch.no_grad():
            return tpp.pipeline_apply(tpp.shard_stack(port_stack(params), ranks), 5,
                                      torch.from_numpy(x), n_microbatches=2, group=ranks)

    with sampling.eps_hook(jax_hook({5: key})):
        got = run_axis(2, "pp", rank)
    for h, lq, lp in got:
        np.testing.assert_allclose(h.numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-6)
        close(lq, want[1], 2e-5)
        close(lp, want[2], 2e-5)


def test_group_of_another_size_raises(setup):
    """A stack cut for two stages on no group, and a whole one on a group of
    two, raise naming the mismatch."""
    _, params, x = setup

    def rank(r, ranks):
        return tpp.shard_stack(port_stack(params), ranks)

    cut = run_axis(2, "pp", rank)[0]
    with pytest.raises(ValueError, match="a group of 1 ranks, but the module is cut into 2"):
        tpp.pipeline_apply(cut, 1, torch.from_numpy(x), n_microbatches=2)
    with pytest.raises(ValueError, match="a group of 2 ranks, but the module is cut into 1"):
        run_axis(2, "pp", lambda r, ranks: tpp.make_pp_train_step(
            port_stack(params), None, n_samples=1, n_batches=1, n_microbatches=2,
            loss_fn=mse_torch, group=ranks))


def mse_jax(out, batch):
    err = out - batch["y"]
    return jnp.sum(err * err), {"mse": jnp.mean(err * err)}


def mse_torch(out, batch):
    err = out - batch["y"]
    return torch.sum(err * err), {"mse": torch.mean(err * err)}


OPTIMIZERS = {
    "adam": (lambda: optax.adam(1e-3),
             lambda p: torch.optim.Adam(p, 1e-3, betas=(0.9, 0.999), eps=1e-8)),
    "sgd": (lambda: optax.sgd(1e-3), lambda p: torch.optim.SGD(p, 1e-3)),
}


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_pp_train_step_matches_jax(setup, opt):
    """Two steps (S = 2, M = 2): each step's loss, and the parameters after
    the first and the second."""
    stack, params, x = setup
    y = np.random.default_rng(1).normal(size=(B, D)).astype(np.float32)
    jtx, ttx = OPTIMIZERS[opt]
    tx = jtx()
    jstep = jpp.make_pp_train_step(stack, tx, mesh=jpp.make_pp_mesh(1), n_samples=2,
                                   n_batches=10, n_microbatches=2, loss_fn=mse_jax)
    port = port_stack(params)
    tstep = tpp.make_pp_train_step(port, ttx(port.parameters()), n_samples=2, n_batches=10,
                                   n_microbatches=2, loss_fn=mse_torch)
    jbatch = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    tbatch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    jparams, state = params, tx.init(params)
    for seed in (100, 101):
        key = jax.random.key(seed)
        jparams, state, jm = jstep(jparams, state, key, jbatch)
        with sampling.eps_hook(jax_hook(step_keys(seed, key, 2))):
            tm = tstep(seed, tbatch)
        close(tm["loss"], jm["loss"], 2e-5)
        close(tm["nll"], jm["nll"], 2e-5)
        assert set(tm) == set(jm)
        assert_tree_close(port, jparams)


@pytest.mark.parametrize("fault,match", [
    ("missing", r"missing \['bias_rho'\]"),
    ("unexpected", r"unexpected \['extra'\]"),
    ("misshaped", r"rho has shape \(4, 32, 31\)"),
])
def test_from_jax_stack_raises(setup, fault, match):
    """A tree that does not match the port's stack raises, naming the leaf."""
    _, params, _ = setup
    tree = dict(numpy_tree(params))
    if fault == "missing":
        del tree["bias_rho"]
    elif fault == "unexpected":
        tree["extra"] = np.zeros(3, np.float32)
    else:
        tree["rho"] = tree["rho"][..., :-1]
    with pytest.raises(ValueError, match=match):
        from_jax_stack(tree, tpp.BlockStack(L, D, device="cpu"), device="cpu")
