"""The ``TransformerStack`` with the MoE FFN and ``make_ep_lm_train_step``
(``bayeformers_tpu_torch/parallel/transformer.py``) against the JAX
package's at ep = 1 (a one-device mesh), at the JAX tests' sizes (2 blocks,
4 experts of ffn 32, d_model 16, 2 heads, V = 17, T = 8), at the JAX
package's own draws: outputs at 1e-5, log-probs at 2e-5 relative, the
routers' gradients (non-zero, each block's), and the parameters after one
and two steps (Adam and SGD) at 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from stack_draws import close, jax_hook
from test_torch_stack_pipeline import OPTIMIZERS
from test_torch_stack_transformer import D, FF, H, T, V, check_steps, lm_batch, port_lm
from torch_threads import one_torch_thread  # noqa: F401

from bayeformers_tpu.parallel import moe as jmoe
from bayeformers_tpu.parallel import transformer as jtfm
from bayeformers_tpu_torch.parallel import sampling
from bayeformers_tpu_torch.parallel import transformer as ttfm

jax.config.update("jax_platforms", "cpu")
MOE = dict(n_experts=4, ffn=32)


@pytest.fixture(scope="module")
def moe_setup():
    moe = jmoe.BayesMoE(n_experts=4, features=D, ffn=32)
    stack = jtfm.TransformerStack(n_blocks=2, d_model=D, n_heads=H, d_ff=FF, moe=moe)
    return stack, jtfm.lm_init(stack, V, T, jax.random.key(1))


def test_moe_lm_forward_and_router_grad_match_jax(moe_setup):
    """Logits and log-probs of ``lm_logits_single``, and the gradient of a
    loss of them with respect to every block's router."""
    stack, params = moe_setup
    key = jax.random.key(9)
    tokens = lm_batch(2, 8)["tokens"]

    def loss(p):
        logits, lq, lp = jtfm.lm_logits_single(stack, p, key, jnp.asarray(tokens))
        return jnp.sum(logits * logits) + (lq - lp) / 10.0, (logits, lq, lp)

    (_, want), grads = jax.value_and_grad(loss, has_aux=True)(params)
    port = port_lm(params, 2, MOE)
    with sampling.eps_hook(jax_hook({9: key})):
        logits, lq, lp = ttfm.lm_logits_single(port, 9, torch.from_numpy(tokens))
    (torch.sum(logits * logits) + (lq - lp) / 10.0).backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want[0]), rtol=1e-5,
                               atol=1e-5)
    close(lq, want[1], 2e-5)
    close(lp, want[2], 2e-5)
    g = port.stack.moe.router.grad.numpy()
    want_g = np.asarray(grads["stack"]["moe"]["router"])
    assert g.shape == (2, D, 4) and all(np.abs(g[l]).max() > 0 for l in range(2))
    np.testing.assert_allclose(g, want_g, rtol=1e-5, atol=1e-5 * np.abs(want_g).max())


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_ep_lm_step_matches_jax(moe_setup, opt):
    stack, params = moe_setup
    jtx, ttx = OPTIMIZERS[opt]
    tx = jtx()
    jstep = jtfm.make_ep_lm_train_step(stack, tx, mesh=jmoe.make_ep_mesh(1), n_samples=2,
                                       n_batches=10)
    port = port_lm(params, 2, MOE)
    tstep = ttfm.make_ep_lm_train_step(port, ttx(port.parameters()), n_samples=2,
                                       n_batches=10)
    check_steps(jstep, tx, params, port, tstep, lm_batch(1, 8), (500, 501))
