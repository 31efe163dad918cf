"""The reference's other two conversions through the port's BERT, on the
CPU in f32, against the JAX package.

A tiny Flax BERT converted by ``bayeformers_tpu.to_bayesian`` with the
reference's defaults (``rng=``: random init under the scale-mixture prior)
and with ``delta=0.05`` (MOPED with a trainable mu and its own
``prior_mu``) is carried over with ``from_jax_params``; the JAX package's
own per-leaf draws are injected into the port through the eps hook, as in
``tests/test_torch_bert.py``. Compared: logits and both log-probs of
``mc_apply_fused`` under both estimators, and two AdamW steps of the
antithetic ELBO step, in which mu trains and ``prior_mu`` stays put. Also:
``to_bayesian``'s signature and defaults against the reference's, and
``UniformInit``'s ranges and determinism.
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict

import bayeformers_tpu as bf
import bayeformers_tpu_torch as bt
from bayeformers_tpu import training as jtraining
from bayeformers_tpu.models import bert as jbert
from bayeformers_tpu.nn import fused as jfused
from bayeformers_tpu.ops import common as jcommon
from bayeformers_tpu.ops import sampled_linear as jsl
from bayeformers_tpu.utils.optim import masked_optimizer as jmasked_optimizer
from bayeformers_tpu_torch import training
from bayeformers_tpu_torch.core.init import DEFAULT_UNIFORM, UniformInit
from bayeformers_tpu_torch.nn.surgery import leaf
from bayeformers_tpu_torch.utils import optim
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

S, B, L = 4, 3, 16
N_BATCHES = 7
LR, WD = 1e-3, 0.01
# AdamW's eps: 1e-6, not the recipe's 1e-8. A trained mu includes leaves
# whose gradient is zero up to roundoff (a key bias: softmax ignores a
# shift of all scores), and AdamW's first step normalises each gradient by
# its own size plus eps, so at 1e-8 the two packages' roundoff of ~1e-11
# becomes updates of ~1e-6; at 1e-6 it stays ~1e-8, and real gradients
# (~1e-4 and up) still take steps of about lr.
ADAM_EPS = 1e-6
CONVERSIONS = {"random-init": {"rng": jax.random.key(5)}, "moped-trainable": {"delta": 0.05}}


def _batch(seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 1024, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[1, 10:] = 0
    tok = np.zeros((B, L), np.int32)
    tok[:, L // 2:] = 1
    labels = rng.integers(0, 2, (B,)).astype(np.int32)
    return {"input_ids": ids, "attention_mask": mask, "token_type_ids": tok,
            "labels": labels}


def _convert(**kw):
    """The JAX package's ``to_bayesian`` of the tiny BERT, traced once under
    ``jit`` (the same values as eager, without compiling each leaf's draw on
    its own)."""
    bundle = jbert.build_bert(size="tiny", seed=0)
    held = {}

    def convert(params):
        held["bmodel"], bp = bf.to_bayesian(bundle.apply_fn, params, **kw)
        return bp

    bp = jax.jit(convert)(bundle.params)
    return held["bmodel"], bp


@pytest.fixture(scope="module", params=list(CONVERSIONS))
def conversion(request):
    return (request.param,) + _convert(**CONVERSIONS[request.param])


def _port(bmodel, bp):
    spec = bmodel.spec
    return bt.from_jax_params(
        flatten_dict(bp.params, sep="/"),
        {p: np.asarray(r) for p, r in bp.rho.items()},
        prior_mu={p: np.asarray(m) for p, m in bp.prior_mu.items()},
        prior=(spec.prior.pi, spec.prior.sigma1, spec.prior.sigma2),
        moped=spec.moped, frozen=spec.frozen, device="cpu")


def _hook(bmodel, keys):
    """The JAX package's own draw of each leaf (nn/fused.py) for the chunk
    key ``keys[0]``."""
    index = {p: i for i, p in enumerate(bmodel.spec.paths)}

    def hook(path, n_draws, shape):
        lkey = jax.random.fold_in(keys[0], index[path])
        if path.endswith("/kernel"):
            eps = jsl.naive_eps(jcommon.seed_from_key(jax.random.split(lkey, n_draws)),
                                shape)
        else:
            eps = jfused._unit_bias_eps(lkey, n_draws, shape[0], None)
        return torch.from_numpy(np.array(eps))

    return hook


def test_fused_forward_matches_jax(conversion):
    """Logits to 1e-4 and both log-probs to 2e-5 relative (XLA's CPU sums),
    under the prior the conversion chose: the mixture (antithetic pairs),
    or the Gaussian on ``prior_mu`` (independent draws; the op-level tests
    take every prior under both estimators)."""
    name, bmodel, bp = conversion
    antithetic = name == "random-init"
    port = _port(bmodel, bp)
    assert port.spec.moped == (name == "moped-trainable") and not port.spec.frozen
    key = jax.random.key(9 + antithetic)
    batch = _batch(0)
    out, aux = bmodel.mc_apply_fused(
        bp, key, S, **{k: jnp.asarray(batch[k]) for k in
                       ("input_ids", "attention_mask", "token_type_ids")},
        save_weights=False, antithetic=antithetic)
    t = lambda a: torch.from_numpy(a).long()
    logits, taux = port.mc_apply_fused(
        0, S, t(batch["input_ids"]), t(batch["attention_mask"]),
        t(batch["token_type_ids"]), antithetic=antithetic,
        eps_hook=_hook(bmodel, [key]))
    np.testing.assert_allclose(logits.numpy(), np.asarray(out), atol=1e-4)
    for k in ("log_variational_posterior", "log_prior"):
        np.testing.assert_allclose(taux[k].numpy(), np.asarray(aux[k]), rtol=2e-5)


def test_two_steps_train_mu_and_keep_prior_mu():
    """MOPED with a trainable mu (``delta=0.05``): two antithetic AdamW
    steps against the JAX package's step. Losses and log-probs 2e-5
    relative; every trained tensor, converted mu among them, within 1e-6
    after each step (AdamW moves it by about lr); mu has moved and
    ``prior_mu`` is bit-identical on both sides."""
    bmodel, bp = _convert(delta=0.05)
    name = "moped-trainable"
    port = _port(bmodel, bp)
    mu0 = {p: leaf(port.model, p).detach().clone() for p in port.spec.paths}
    pmu0 = {p: t.clone() for p, t in port.prior_mu.items()}
    jtx = jmasked_optimizer(
        jtraining.adamw_with_decay_groups(optax.linear_schedule(LR, 0.0, 10), WD,
                                          jtraining.default_no_decay, eps=ADAM_EPS,
                                          clip_norm=1.0),
        bmodel.trainable_mask(bp))
    jstep = jtraining.make_elbo_train_step(bmodel, jtx, S, N_BATCHES,
                                           estimator="antithetic")
    tx = training.adamw_with_decay_groups(
        training.linear_schedule(LR, 0.0, 10), WD, training.default_no_decay,
        eps=ADAM_EPS, clip_norm=1.0)
    opt = optim.masked_optimizer(tx, port)
    mask = port.trainable_mask()
    assert mask["prior_mu"] == {p: False for p in bp.prior_mu}
    assert all(mask["params"][p] for p in port.spec.paths)
    keys = [None]
    hook = _hook(bmodel, keys)
    step = training.make_elbo_train_step(port, opt, S, N_BATCHES, estimator="antithetic",
                                         eps_hook=lambda c, *a: hook(*a))
    jbp, jstate = bp, jtx.init(bp)
    for i, key in enumerate((jax.random.key(21), jax.random.key(22))):
        batch = _batch(i)
        jbp, jstate, jm = jstep(jbp, jstate, key, {k: jnp.asarray(v) for k, v in batch.items()})
        keys[0] = key
        m = step(100 + i, {k: torch.from_numpy(v).long() for k, v in batch.items()})
        for k in ("loss", "nll", "log_prior", "log_variational_posterior"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=2e-5,
                                       err_msg=f"{name} step {i} {k}")
        for path, want in flatten_dict(jbp.params, sep="/").items():
            np.testing.assert_allclose(leaf(port.model, path).detach().numpy(),
                                       np.asarray(want), rtol=0, atol=1e-6,
                                       err_msg=f"{name} step {i} {path}")
        for path, want in jbp.rho.items():
            np.testing.assert_allclose(port.rho[path].detach().numpy(), np.asarray(want),
                                       rtol=0, atol=1e-6, err_msg=f"{name} step {i} {path}")
    for p in port.spec.paths:
        assert not torch.equal(leaf(port.model, p).detach(), mu0[p]), p
    assert set(pmu0) == set(jbp.prior_mu) == set(port.spec.paths)
    for p, t in port.prior_mu.items():
        assert torch.equal(t, pmu0[p]) and not t.requires_grad, p
        np.testing.assert_array_equal(np.asarray(jbp.prior_mu[p]), pmu0[p].numpy())


def test_to_bayesian_signature_matches_reference():
    """The reference's keywords, order and defaults (``initialization``,
    ``prior``, ``delta``, ``freeze``, ``rules``); the JAX package's ``rng``
    is the port's ``generator``, and ``rules`` defaults to the linear rule
    alone, as there."""
    ref = inspect.signature(bf.to_bayesian).parameters
    got = inspect.signature(bt.to_bayesian).parameters
    shared = ["initialization", "prior", "delta", "freeze", "rules"]
    assert [n for n in ref if n in shared] == [n for n in got if n in shared] == shared
    assert list(got) == ["model"] + shared[:-1] + ["generator", "rules"]
    assert [r.name for r in got["rules"].default] == [r.name for r in ref["rules"].default]
    for n in ("delta", "freeze"):
        assert got[n].default == ref[n].default, n
    ji, pi = ref["initialization"].default, got["initialization"].default
    assert (pi.mu_range, pi.rho_range) == (ji.mu_range, ji.rho_range)
    jp, pp = ref["prior"].default, got["prior"].default
    assert (pp.pi, pp.sigma1, pp.sigma2) == (jp.pi, jp.sigma1, jp.sigma2)
    assert got["generator"].default is None and ref["rng"].default is None
    for n in list(got)[1:]:
        assert got[n].kind == inspect.Parameter.KEYWORD_ONLY, n


def test_uniform_init_ranges_and_determinism():
    """``UniformInit`` draws mu in (-0.2, 0.2) and rho in (-5, -4) from one
    generator, in a fixed order: the same seed gives the same conversion,
    another seed another one; the model's mu becomes the draw."""
    mu, rho = DEFAULT_UNIFORM(torch.Generator().manual_seed(0), (256, 64))
    assert mu.dtype == rho.dtype == torch.float32 and mu.shape == (256, 64)
    assert -0.2 <= mu.min() < -0.19 and 0.19 < mu.max() < 0.2
    assert -5.0 <= rho.min() < -4.99 and -4.01 < rho.max() < -4.0
    assert abs(mu.mean().item()) < 0.01 and abs(rho.mean().item() + 4.5) < 0.01
    a, b, c = (bt.to_bayesian(bt.build_bert(size="tiny", device="cpu", dtype=torch.float32),
                              generator=torch.Generator().manual_seed(s))
               for s in (7, 7, 8))
    for p in a.spec.paths:
        assert torch.equal(a.rho[p], b.rho[p]) and not torch.equal(a.rho[p], c.rho[p])
        assert torch.equal(leaf(a.model, p), leaf(b.model, p))
    assert a.spec.prior == bt.ScaleMixturePrior() and not a.spec.moped
    assert a.prior_mu == {} and a.trainable_mask()["prior_mu"] == {}
    narrow = UniformInit((-0.01, 0.01), (-3.0, -2.0))
    m2, r2 = narrow(torch.Generator().manual_seed(0), (4, 4))
    assert m2.abs().max() <= 0.01 and (r2 >= -3.0).all() and (r2 <= -2.0).all()
