"""Shared pieces of the stacked tiers' parity tests (``tests/test_torch_stack_*.py``).

The JAX package draws inside ``lax.scan``, so its kernel seeds are tracers
and cannot be captured as ``tests/test_torch_layers.py`` captures them.
Each of its draws is rebuilt from the key path instead: a draw's key
(``jax.random.split(key, S)[s]`` in a step), folded with the projection's
path (``fold_in(key, global_idx)``, then ``fold_in(bkey, j)``), gives the
weight's eps through ``seed_from_key`` and ``naive_eps`` (the JAX op's CPU
stream) and the bias's eps as ``normal(fold_in(skey, 1))``. :func:`jax_hook`
serves them to the port's ``parallel.sampling.eps_hook``, which passes the
port's draw seed and the same path.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from bayeformers_tpu.ops import common as jcommon
from bayeformers_tpu.ops import sampled_linear as jsl
from bayeformers_tpu_torch.parallel import sampling


@functools.lru_cache(maxsize=None)
def _draw(what: str, shape: tuple):
    """The JAX package's draw of a projection's ``what`` from its key, jitted
    once a shape (eagerly, ``naive_eps`` takes ~0.16 s a call)."""
    if what == "kernel":
        return jax.jit(lambda k: jsl.naive_eps(jcommon.seed_from_key(k[None]), shape)[0])
    return jax.jit(lambda k: jax.random.normal(jax.random.fold_in(k, 1), shape, jnp.float32))


def jax_hook(keys: dict):
    """``hook(seed, path, what, shape)`` drawing from ``keys[seed]`` (a JAX
    key per port draw seed) as the JAX package draws that path; draws are
    cached, and every (seed, path, what) asked for is recorded in
    ``hook.asked``."""
    cache = {}

    def hook(seed, path, what, shape):
        hook.asked.append((seed, tuple(path), what))
        k = (seed, tuple(path), what, tuple(shape))
        if k not in cache:
            skey = keys[seed]
            for p in path:
                skey = jax.random.fold_in(skey, p)
            cache[k] = torch.from_numpy(np.array(_draw(what, tuple(shape))(skey)))
        return cache[k]

    hook.asked = []
    return hook


def step_keys(seed: int, key, n_samples: int) -> dict:
    """The port step's draw seeds for step ``seed`` mapped to the JAX step's
    draw keys (``jax.random.split(key, S)``)."""
    return {s: k for s, k in zip(sampling.draw_seeds(seed, n_samples),
                                  jax.random.split(key, n_samples))}


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def assert_tree_close(port: torch.nn.Module, tree, tol=1e-5):
    """Each of ``port``'s parameters against the JAX tree's leaf of the same
    path (``.`` for ``/``) at ``tol``: relative, and absolute of the leaf's
    largest entry (an entry near 0 takes a step summed in another order)."""
    from bayeformers_tpu_torch.convert import flatten

    flat = flatten(numpy_tree(tree))
    names = dict(port.named_parameters())
    assert set(n.replace(".", "/") for n in names) == set(flat)
    for n, p in names.items():
        want = flat[n.replace(".", "/")]
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=tol,
                                   atol=tol * np.abs(want).max(), err_msg=n)


def close(got, want, rtol):
    np.testing.assert_allclose(np.asarray(got.detach() if hasattr(got, "detach") else got),
                               np.asarray(want), rtol=rtol)
