"""The port's ``TransformerStack`` with its dense FFN, ``lm_logits_single``
and ``make_single_lm_train_step`` (``bayeformers_tpu_torch/parallel/
transformer.py``) against the JAX package's, at the JAX tests' sizes (4
blocks, d_model 16, 2 heads, d_ff 32, V = 17, T = 8), at the JAX package's
own draws (``stack_draws.jax_hook``): outputs and logits at 1e-5, log-probs
at 2e-5 relative, parameters after one and two steps (Adam and SGD) at
1e-5. The pipeline and MoE steps are in ``test_torch_stack_transformer_pp.py``
and ``test_torch_stack_transformer_moe.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from stack_draws import assert_tree_close, close, jax_hook, numpy_tree, step_keys
from test_torch_stack_pipeline import OPTIMIZERS
from torch_threads import one_torch_thread  # noqa: F401

from bayeformers_tpu.parallel import transformer as jtfm
from bayeformers_tpu_torch.convert import from_jax_stack
from bayeformers_tpu_torch.parallel import sampling
from bayeformers_tpu_torch.parallel import transformer as ttfm

jax.config.update("jax_platforms", "cpu")
V, T, D, H, FF = 17, 8, 16, 2, 32


def lm_batch(seed, B):
    """The JAX tests' repeated-half copy batch, as numpy arrays."""
    rng = np.random.default_rng(seed)
    half = T // 2
    seq = rng.integers(0, V, size=(B, half)).astype(np.int32)
    seq = np.concatenate([seq, seq], axis=1)
    mask = np.zeros((B, T - 1), np.int32)
    mask[:, half - 1:] = 1
    return {"tokens": seq[:, :-1], "targets": seq[:, 1:], "eval_mask": mask}


def port_lm(params, n_blocks, moe=None):
    stack = ttfm.TransformerStack(n_blocks, D, H, FF, moe=moe, device="cpu")
    return from_jax_stack(numpy_tree(params), ttfm.lm_init(stack, V, T), device="cpu")


def torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def check_steps(jstep, tx, params, port, tstep, batch, seeds, n_samples=2):
    """Steps of both packages from the same parameters and draws: each step's
    loss and the parameters after it."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = torch_batch(batch)
    jparams, state = params, tx.init(params)
    for seed in seeds:
        key = jax.random.key(seed)
        jparams, state, jm = jstep(jparams, state, key, jb)
        with sampling.eps_hook(jax_hook(step_keys(seed, key, n_samples))):
            tm = tstep(seed, tb)
        close(tm["loss"], jm["loss"], 2e-5)
        close(tm["nll"], jm["nll"], 2e-5)
        assert set(tm) == set(jm)
        assert_tree_close(port, jparams)
    return jparams


@pytest.fixture(scope="module")
def dense_setup():
    stack = jtfm.TransformerStack(n_blocks=4, d_model=D, n_heads=H, d_ff=FF)
    return stack, jtfm.lm_init(stack, V, T, jax.random.key(0))


def test_apply_stack_matches_jax(dense_setup):
    stack, params = dense_setup
    key = jax.random.key(7)
    h = np.random.default_rng(0).normal(size=(8, T - 1, D)).astype(np.float32)
    want = stack.apply_stack(params["stack"], key, jnp.asarray(h))
    port = port_lm(params, 4)
    with sampling.eps_hook(jax_hook({7: key})):
        got = port.stack.apply_stack(7, torch.from_numpy(h))
    np.testing.assert_allclose(got[0].detach().numpy(), np.asarray(want[0]), rtol=1e-5,
                               atol=1e-5)
    close(got[1], want[1], 2e-5)
    close(got[2], want[2], 2e-5)


def test_lm_logits_single_matches_jax(dense_setup):
    stack, params = dense_setup
    key = jax.random.key(8)
    tokens = lm_batch(3, 4)["tokens"]
    want = jtfm.lm_logits_single(stack, params, key, jnp.asarray(tokens))
    port = port_lm(params, 4)
    with sampling.eps_hook(jax_hook({8: key})):
        got = ttfm.lm_logits_single(port, 8, torch.from_numpy(tokens))
    assert got[0].shape == (4, T - 1, V)
    np.testing.assert_allclose(got[0].detach().numpy(), np.asarray(want[0]), rtol=1e-5,
                               atol=1e-5)
    close(got[1], want[1], 2e-5)
    close(got[2], want[2], 2e-5)


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_single_lm_step_matches_jax(dense_setup, opt):
    stack, params = dense_setup
    jtx, ttx = OPTIMIZERS[opt]
    tx = jtx()
    jstep = jtfm.make_single_lm_train_step(stack, tx, n_samples=2, n_batches=10)
    port = port_lm(params, 4)
    tstep = ttfm.make_single_lm_train_step(port, ttx(port.parameters()), n_samples=2,
                                           n_batches=10)
    check_steps(jstep, tx, params, port, tstep, lm_batch(1, 8), (300, 301))


def test_stack_validation():
    with pytest.raises(ValueError, match="n_heads"):
        ttfm.TransformerStack(1, 16, 3, 32, device="cpu")
    dense = ttfm.lm_init(ttfm.TransformerStack(1, 16, 2, 32, device="cpu"), V, T)
    opt = torch.optim.SGD(dense.parameters(), 1e-3)
    with pytest.raises(ValueError, match="MoE"):
        ttfm.make_ep_lm_train_step(dense, opt, n_samples=1, n_batches=1)
    moe = ttfm.lm_init(ttfm.TransformerStack(1, 16, 2, 32, moe=dict(n_experts=2, ffn=8),
                                             device="cpu"), V, T)
    with pytest.raises(NotImplementedError, match="MoE"):
        ttfm.make_pp_lm_train_step(moe, opt, n_samples=1, n_batches=1, n_microbatches=1)
