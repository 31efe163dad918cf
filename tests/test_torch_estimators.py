"""The estimators slice against the JAX package, on the CPU in f32:
flipout, and what the other tiers' parity tests share.

A one-layer tiny Flax BERT is converted by ``bayeformers_tpu.to_bayesian``
three ways (frozen MOPED, the GLUE recipe; MOPED with a trainable mu; the
reference's default, random init under the scale mixture) and carried
over with ``from_jax_params``. An estimator then runs on both sides at the
JAX package's own draws, derived in the test from the keys the JAX
functions fold (``nn/flipout.py``, ``nn/lrt.py``, ``nn/surgery.py``) and
injected into the port through its eps hooks (:func:`check_against_jax`:
logits 1e-4, the KL or log-probs 2e-5 relative, the gradients of the
logits' part and of the KL part each leaf within 1e-4 of its largest
entry); here flipout, and local reparameterization and the naive tier in
``tests/test_torch_estimators_lrt_naive.py``. Also: each estimator's law
against the naive tier's at S=300 on a small net, the decorrelation of
examples, ``pick_mc``'s table, and the naive tier's ``sample`` / ``apply``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import bayeformers_tpu as bf
import bayeformers_tpu_torch as bt
from bayeformers_tpu.models import bert as jbert
from bayeformers_tpu.nn import fused as jfused
from bayeformers_tpu.ops import common as jcommon
from bayeformers_tpu.ops import sampled_linear as jsl
from bayeformers_tpu_torch import training
from bayeformers_tpu_torch.core import distributions as dist
from bayeformers_tpu_torch.nn.dense import Dense, assign_paths
from bayeformers_tpu_torch.nn.surgery import leaf
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

S, B, L = 3, 2, 12
CONVERSIONS = {"frozen-moped": {"delta": 0.05, "freeze": True},
               "moped-trainable": {"delta": 0.05},
               "random-init": {"rng": jax.random.key(5)}}


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 1024, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[1, 8:] = 0
    tok = np.zeros((B, L), np.int32)
    tok[:, L // 2:] = 1
    return {"input_ids": ids, "attention_mask": mask, "token_type_ids": tok}


@pytest.fixture(scope="module", params=list(CONVERSIONS))
def conversion(request):
    """(name, the JAX BayesianModel, its BayesParams, the port's model)."""
    bundle = jbert.build_bert(size="tiny", seed=0, num_hidden_layers=1)
    held = {}

    def convert(params):
        held["bmodel"], bp = bf.to_bayesian(bundle.apply_fn, params,
                                            **CONVERSIONS[request.param])
        return bp

    bp = jax.jit(convert)(bundle.params)
    bmodel = held["bmodel"]
    spec = bmodel.spec
    port = bt.from_jax_params(
        flatten_dict(bp.params, sep="/"), {p: np.asarray(r) for p, r in bp.rho.items()},
        prior_mu={p: np.asarray(m) for p, m in bp.prior_mu.items()},
        prior=(spec.prior.pi, spec.prior.sigma1, spec.prior.sigma2),
        moped=spec.moped, frozen=spec.frozen, device="cpu")
    return request.param, bmodel, bp, port


def _np(a):
    return torch.from_numpy(np.array(a, np.float32))


def _normals(key, n, shape):
    return jax.vmap(lambda k: jax.random.normal(k, shape, jnp.float32))(
        jax.random.split(key, n))


def _hook(bmodel, key, estimator, n_samples=S):
    """The JAX package's draws of ``estimator`` under ``key``, in the port's
    hook signature: the naive tier's ``(path, shape)`` (each sample's key
    folded with the leaf's index), flipout's and LRT's ``(path, what,
    shape)`` (the kernel or embedding leaf's layer key ``fold_in(key, i)``
    folded with 0-7 as ``nn/flipout.py`` and ``nn/lrt.py`` fold it, a
    bias's its kernel's), the fused tier's ``(path, n_draws, shape)``
    (``nn/fused.py``'s ``layer_seeds``: ``naive_eps`` for a kernel or
    table, ``_unit_bias_eps`` for a bias)."""
    index = {p: i for i, p in enumerate(bmodel.spec.paths)}
    if estimator in ("fused", "antithetic"):
        def fused(path, n_draws, shape):
            lkey = jax.random.fold_in(key, index[path])
            if path.endswith("/bias"):
                return _np(jfused._unit_bias_eps(lkey, n_draws, shape[0], None))
            seeds = jcommon.seed_from_key(jax.random.split(lkey, n_draws))
            return _np(jsl.naive_eps(seeds, shape))
        return fused
    if estimator == "naive":
        keys = jax.random.split(key, n_samples)

        def naive(path, shape):
            return _np(jnp.stack([jax.random.normal(jax.random.fold_in(k, index[path]),
                                                    shape, jnp.float32) for k in keys]))
        return naive

    def hook(path, what, shape):
        owner = path.rsplit("/", 1)[0] + "/kernel" if path.endswith("/bias") else path
        k = jax.random.fold_in(key, index[owner])
        fold = lambda n: jax.random.fold_in(k, n)
        if what in ("r", "s", "bias_s"):
            n = {"r": 2, "s": 3, "bias_s": 5}[what]
            return _np(jax.random.rademacher(fold(n), shape, jnp.float32))
        if what == "eps" and estimator == "flipout":
            seeds = jcommon.seed_from_key(jax.random.split(fold(0), shape[0]))
            return _np(jsl.naive_eps(seeds, shape[1:]))
        if what == "eps":  # LRT's activation noise
            return _np(jax.random.normal(fold(7), shape, jnp.float32))
        if what == "bias_eps":
            return _np(jax.random.normal(fold(4), shape, jnp.float32))
        if what == "kl":
            return _np(_normals(jax.random.fold_in(k, 1), shape[0], shape[1:]))
        assert what == "bias_kl", what
        return _np(_normals(jax.random.fold_in(fold(6), 1), shape[0], shape[1:]))

    return hook


def _jax_run(bmodel, bp, key, estimator, batch, weights, n_samples=S, **mc_kwargs):
    """Logits, aux and the gradients of ``sum(logits * weights)`` and of the
    KL part (flipout and LRT: ``aux["kl"]``; naive: ``mean(log_q -
    log_p)``), from one jitted forward and two VJPs."""
    fn = {"flipout": bmodel.mc_apply_flipout, "local": bmodel.mc_apply_lrt,
          "naive": bmodel.mc_apply,
          "fused": functools.partial(bmodel.mc_apply_fused, antithetic=False),
          "antithetic": functools.partial(bmodel.mc_apply_fused, antithetic=True)}[estimator]
    inputs = {k: jnp.asarray(v) for k, v in batch.items()}

    def parts(p):
        out, aux = fn(p, key, n_samples, **inputs, **mc_kwargs)
        kl = aux.get("kl", jnp.mean(aux["log_variational_posterior"] - aux["log_prior"]))
        return (jnp.sum(out * weights), kl), (out, aux)

    @jax.jit
    def run(p):
        _, vjp, (out, aux) = jax.vjp(parts, p, has_aux=True)
        one, zero = jnp.ones(()), jnp.zeros(())
        return out, aux, vjp((one, zero))[0], vjp((zero, one))[0]

    return run(bp)


def _port_grads(port, named, loss):
    for _, t, _ in named:
        t.grad = None
    loss.backward(retain_graph=True)
    return {n: t.grad.clone() for n, t, _ in named if t.grad is not None}


def _jax_grad(grads, name):
    kind, path = name.split("/", 1)
    if kind == "rho":
        return np.asarray(grads.rho[path])
    return np.asarray(flatten_dict(grads.params, sep="/")[path])


def check_against_jax(conversion, estimator, batch=None, out_shape=(B, 2), small=None,
                      n_samples=S, untile_axes=()):
    """Logits within 1e-4, the KL (flipout, LRT) or both log-probs (naive,
    and the fused tier: ``"fused"``, ``"antithetic"``) within 2e-5 relative, and the gradients of the logits' part and of the
    KL part, each trained leaf (rho; mu where it trains; LayerNorm and
    embeddings) within 1e-4 of its largest entry. Under the mixture the
    port's flipout and LRT score each kernel leaf's KL through
    ``sampled_logprobs`` and its closed-form VJP. ``batch`` (default: this
    module's BERT batch) holds the model's inputs, ``out_shape`` the shape
    of one sample's output. ``small``, a pair ``(share, bound)``: a leaf
    whose largest entry is below ``share`` of the part's largest is held
    within ``bound`` of its own largest entry instead (a caller states
    the readings it takes the pair from). ``n_samples``: S (even for
    ``"antithetic"``). ``untile_axes``: the output's other tiled axes
    (CLIP's ``(1,)``), for the port's tiers and the JAX package's tiled
    ones (its naive tier vmaps and needs none)."""
    name, bmodel, bp, port = conversion
    Sn = n_samples
    key = jax.random.key(11)
    batch = _batch() if batch is None else batch
    weights = np.random.default_rng(3).normal(size=(Sn,) + tuple(out_shape)).astype(np.float32)
    jkw = {"untile_axes": untile_axes} if untile_axes and estimator != "naive" else {}
    jout, jaux, jg_out, jg_kl = _jax_run(bmodel, bp, key, estimator, batch,
                                         jnp.asarray(weights), Sn, **jkw)
    named = port.trainable_parameters()
    t = {k: torch.from_numpy(v).long() if np.issubdtype(v.dtype, np.integer)
         else torch.from_numpy(v) for k, v in batch.items()}
    out, aux = training.pick_mc(port, True, estimator)(
        0, Sn, **t, eps_hook=_hook(bmodel, key, estimator, Sn), untile_axes=untile_axes)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=0, atol=1e-4)
    if estimator in ("naive", "fused", "antithetic"):
        for k in ("log_prior", "log_variational_posterior"):
            np.testing.assert_allclose(aux[k].detach().numpy(), np.asarray(jaux[k]),
                                       rtol=2e-5, err_msg=k)
        kl = torch.mean(aux["log_variational_posterior"] - aux["log_prior"])
    else:
        kl = aux["kl"]
        np.testing.assert_allclose(kl.item(), float(jaux["kl"]), rtol=2e-5)
        np.testing.assert_allclose(aux["log_prior"].detach().numpy(),
                                   -np.full(Sn, float(jaux["kl"])), rtol=2e-5)
        assert torch.equal(aux["log_variational_posterior"], torch.zeros(Sn))
    g_out = _port_grads(port, named, torch.sum(out * torch.from_numpy(weights)))
    g_kl = _port_grads(port, named, kl)
    trained = [n for n, _, _ in named]
    assert any(n.startswith("rho/") for n in trained)
    if name != "frozen-moped":
        assert all(f"params/{p}" in trained for p in port.spec.paths)
    hook = _hook(bmodel, key, estimator, Sn)
    for part, got, want in (("logits", g_out, jg_out), ("kl", g_kl, jg_kl)):
        grads = {n: (got[n].numpy() if n in got else np.zeros_like(_jax_grad(want, n)),
                     _jax_grad(want, n)) for n in trained}
        top = max(np.abs(w).max() for _, w in grads.values())
        for n, (g, w) in grads.items():
            what = f"{name} {estimator} {part} part: {n}"
            noise = 0.0
            path = n.split("/", 1)[1]
            if (part == "kl" and n.startswith("params/") and path in port.rho
                    and (estimator == "naive" or path.endswith("/embedding")
                         and estimator in ("fused", "antithetic"))):
                # the naive tier's log_q, sum(log N(w; mu, sigma)) at w = mu +
                # sigma eps, has a mu-gradient that cancels exactly, -(w - mu)
                # / sigma^2 through w against +(w - mu) / sigma^2 through mu;
                # in f32 both sides keep the rounding of w in each of the
                # two, 2^-23 |w| / sigma^2 apiece, averaged over the samples
                # (so has the fused tier's, for a table it scores at its
                # sampled w)
                mu = leaf(port.model, path).detach().numpy()
                sig = dist.sigma_from_rho(port.rho[path].detach()).numpy()
                if estimator == "naive":
                    eps = hook(path, mu.shape).numpy()
                else:
                    eps = hook(path, Sn // 2 if estimator == "antithetic" else Sn,
                               mu.shape).numpy()
                    if estimator == "antithetic":
                        eps = np.concatenate([eps, -eps])
                w_s = np.abs(mu[None] + sig[None] * eps)
                noise = 2.0 ** -22 * w_s.mean(0) / sig ** 2
            if np.abs(w).max() <= 1e-6 * top:
                # a gradient that vanishes (the key biases' where every
                # sample shifts all scores alike: a softmax ignores the
                # shift) holds only the backward's f32 roundoff on both
                # sides: each within 1e-6 of the part's largest gradient
                assert np.abs(g).max() <= 1e-6 * top, what
                continue
            rel = 1e-4
            if small is not None and np.abs(w).max() < small[0] * top:
                rel = small[1]
            tol = rel * max(np.abs(w).max(), 1e-30) + noise
            assert np.all(np.abs(g - w) <= tol), (
                f"{what}: max |d| {np.abs(g - w).max()}, worst over its bound "
                f"{(np.abs(g - w) / tol).max()}")


def test_flipout_matches_jax(conversion):
    """Flipout under each conversion against the JAX package
    (:func:`check_against_jax`); under the mixture its KL runs through
    ``sampled_logprobs`` and its closed-form VJP."""
    check_against_jax(conversion, "flipout")


class _Net(torch.nn.Module):
    """A small net of two converted ``Dense`` layers (12 -> 32 -> 5), taking
    float features where BERT takes ids."""

    def __init__(self, seed=0):
        super().__init__()
        self.fc1, self.fc2 = Dense(12, 32), Dense(32, 5)
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for d in (self.fc1, self.fc2):
                d.kernel.normal_(0.0, 0.3, generator=gen)
                d.bias.normal_(0.0, 0.1, generator=gen)
        assign_paths(self)

    def forward(self, x, attention_mask=None, token_type_ids=None, mc=None):
        return self.fc2(torch.relu(self.fc1(x, mc)), mc)


@pytest.mark.parametrize("estimator", ["flipout", "local", "naive"])
def test_estimator_law_matches_naive_tier(estimator):
    """Each estimator draws outputs of the law the weight draws give: the
    mean and the per-example std over S=300 samples against the naive
    tier's (the fused tier's independent draws for the naive tier itself),
    as ``tests/test_flipout.py`` holds the JAX package's flipout."""
    bmodel = bt.to_bayesian(_Net(), delta=0.3)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(16, 12)).astype(np.float32))
    n = 300
    with torch.no_grad():
        out, aux = training.pick_mc(bmodel, True, estimator)(1, n, x)
        ref, _ = (bmodel.mc_apply_fused(2, n, x) if estimator == "naive"
                  else bmodel.mc_apply(2, n, x))
    std_ref = ref.std(0)
    np.testing.assert_allclose(out.mean(0).numpy(), ref.mean(0).numpy(), rtol=0,
                               atol=4 * std_ref.max().item() / np.sqrt(n))
    ratio = (out.std(0) / std_ref.clamp_min(1e-3)).median().item()
    assert 0.7 < ratio < 1.3, ratio
    assert torch.isfinite(aux["log_prior"]).all()
    if estimator != "naive":
        assert aux["kl"] > 0


def test_flipout_decorrelates_examples():
    """With S=1 the naive tier gives every example one weight draw (equal
    outputs for equal inputs); flipout and LRT decorrelate them."""
    bmodel = bt.to_bayesian(_Net(), delta=0.3)
    x = torch.ones(8, 12)
    with torch.no_grad():
        naive, _ = bmodel.mc_apply(3, 1, x)
        assert torch.allclose(naive[0, 0], naive[0, 1])
        for fn in (bmodel.mc_apply_flipout, bmodel.mc_apply_lrt):
            out, _ = fn(3, 1, x)
            assert not torch.allclose(out[0, 0], out[0, 1])


def test_pick_mc_table_matches_reference():
    """The reference's six names; an unknown one raises."""
    bmodel = bt.to_bayesian(_Net(), delta=0.05, freeze=True)
    assert training.pick_mc(bmodel, True, "naive") == bmodel.mc_apply
    assert training.pick_mc(bmodel, True, "flipout") == bmodel.mc_apply_flipout
    assert training.pick_mc(bmodel, True, "local") == bmodel.mc_apply_lrt
    assert training.pick_mc(bmodel, True, "lrt") == bmodel.mc_apply_lrt
    for est, anti in (("fused", False), ("antithetic", True)):
        for save in (True, False):
            fn = training.pick_mc(bmodel, True, est, save_weights=save)
            assert fn.func == bmodel.mc_apply_fused
            assert fn.keywords == {"antithetic": anti, "save_weights": save}
    assert training.pick_mc(bmodel, True, "fused").keywords["save_weights"] is True
    assert training.pick_mc(bmodel, True, "naive", save_weights=False) == bmodel.mc_apply
    with pytest.raises(ValueError, match="unknown estimator"):
        training.pick_mc(bmodel, True, "bbb")


def test_step_factories_take_reference_defaults():
    """``pick_mc``, ``make_elbo_train_step`` and ``make_elbo_eval_step`` take
    the reference's parameters in its order (its optax ``tx`` is the port's
    optimizer) with its defaults: ``estimator=None`` is the fused tier's
    independent draws, or the naive tier with ``fused=False``; both train
    and evaluate at an odd S, where antithetic pairs would raise."""
    import inspect

    from bayeformers_tpu import training as jtraining
    from bayeformers_tpu_torch.utils import optim

    for ours, ref in ((training.pick_mc, jtraining.pick_mc),
                      (training.make_elbo_train_step, jtraining.make_elbo_train_step),
                      (training.make_elbo_eval_step, jtraining.make_elbo_eval_step)):
        ours = list(inspect.signature(ours).parameters.values())
        ref = list(inspect.signature(ref).parameters.values())
        assert ([p.name for p in ours[:len(ref)]]
                == [{"tx": "optimizer"}.get(p.name, p.name) for p in ref])
        for p, r in zip(ours, ref):
            if r.name in ("fused", "estimator"):
                assert p.default == r.default, (p, r)
    bmodel = bt.to_bayesian(_Net(), delta=0.3)
    fn = training.pick_mc(bmodel, True)
    assert fn.func == bmodel.mc_apply_fused
    assert fn.keywords == {"antithetic": False, "save_weights": True}
    assert training.pick_mc(bmodel, False) == bmodel.mc_apply
    assert training.pick_mc(bmodel, False, "antithetic").keywords["antithetic"]
    rng = np.random.default_rng(3)
    batch = {"input_ids": torch.from_numpy(rng.normal(size=(4, 12)).astype(np.float32)),
             "labels": torch.from_numpy(rng.integers(0, 5, 4))}
    tx = training.adamw_with_decay_groups(1e-3, 0.0, training.default_no_decay)
    for fused in (True, False):
        step = training.make_elbo_train_step(bmodel, optim.masked_optimizer(tx, bmodel), 3,
                                             10, fused=fused, input_keys=("input_ids",))
        m = step(7, batch)
        assert torch.isfinite(m["loss"])
        out, metrics = training.make_elbo_eval_step(
            bmodel, 3, fused=fused, input_keys=("input_ids",))(8, batch)
        assert out.shape == (3, 4, 5) and torch.isfinite(metrics["nll"])
    with pytest.raises(ValueError):
        training.make_elbo_train_step(bmodel, optim.masked_optimizer(tx, bmodel), 3, 10,
                                      estimator="antithetic",
                                      input_keys=("input_ids",))(7, batch)


def test_naive_tier_sample_and_apply():
    """``sample`` draws every converted leaf with ``sample_gaussian`` in
    path order and scores it; ``apply`` runs the model on those leaves,
    which is the naive tier's per-sample arithmetic."""
    bmodel = bt.to_bayesian(_Net(), generator=torch.Generator().manual_seed(0))
    x = torch.randn(4, 12)
    params, log_p, log_q = bmodel.sample(torch.Generator().manual_seed(9))
    gen = torch.Generator().manual_seed(9)
    want_q = want_p = 0.0
    for path in bmodel.spec.paths:
        mu, rho = leaf(bmodel.model, path), bmodel.rho[path]
        eps = torch.randn(mu.shape, generator=gen)
        w = mu + dist.sigma_from_rho(rho) * eps
        assert torch.equal(params[path], w), path
        want_q += dist.gaussian_log_prob(w, mu, dist.sigma_from_rho(rho)).item()
        want_p += bmodel.spec.prior.log_prob(w).item()
    np.testing.assert_allclose([log_q.item(), log_p.item()], [want_q, want_p], rtol=1e-6)
    out, aux = bmodel.apply(torch.Generator().manual_seed(9), x)
    with torch.no_grad():
        h = torch.relu(x @ params["fc1/kernel"] + params["fc1/bias"])
        ref = h @ params["fc2/kernel"] + params["fc2/bias"]
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-6)
    assert torch.equal(aux["log_prior"], log_p)
