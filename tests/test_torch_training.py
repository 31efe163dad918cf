"""The port's training slice against the JAX package, on the CPU in f32.

A tiny Flax BERT converted by ``bayeformers_tpu.to_bayesian(delta=0.05,
freeze=True)`` is carried over with ``from_jax_params``. Both packages run
``make_elbo_train_step(estimator="antithetic")`` with AdamW in decay groups
behind the trainable mask and a global-norm clip; the JAX package's own
per-leaf draws for each step key are injected into the port through the
eps hook, as in ``tests/test_torch_bert.py``. Also: the losses, metrics,
schedule and clip against their JAX/optax counterparts, the workload's
synthetic data against the JAX workload's, and a CPU run of the workload.
"""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict

import bayeformers_tpu as bf
import bayeformers_tpu_torch as bt
from bayeformers_tpu import elbo as jelbo
from bayeformers_tpu import training as jtraining
from bayeformers_tpu.models import bert as jbert
from bayeformers_tpu.nn import fused as jfused
from bayeformers_tpu.ops import common as jcommon
from bayeformers_tpu.ops import sampled_linear as jsl
from bayeformers_tpu.utils import metrics as jmetrics
from bayeformers_tpu.utils.optim import masked_optimizer as jmasked_optimizer
from bayeformers_tpu.workloads import bert_glue as jglue
from bayeformers_tpu_torch import elbo, training
from bayeformers_tpu_torch.nn.surgery import leaf
from bayeformers_tpu_torch.utils import metrics, optim
from bayeformers_tpu_torch.workloads import bert_glue
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

S, B, L = 4, 3, 16
N_BATCHES = 7
LR, WD = 1e-3, 0.01


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


def _port_batch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def _hook(bmodel, keys_of_step):
    """The JAX package's own draw of each leaf (nn/fused.py) for the chunk
    keys of the current step: ``keys_of_step[0]`` holds them."""
    index = {p: i for i, p in enumerate(bmodel.spec.paths)}

    def hook(chunk, path, n_draws, shape):
        lkey = jax.random.fold_in(keys_of_step[0][chunk], index[path])
        if path.endswith("/kernel"):
            seeds = jcommon.seed_from_key(jax.random.split(lkey, n_draws))
            eps = jsl.naive_eps(seeds, shape)
        else:
            eps = jfused._unit_bias_eps(lkey, n_draws, shape[0], None)
        return torch.from_numpy(np.array(eps))

    return hook


@pytest.fixture(scope="module")
def jax_model():
    bundle = jbert.build_bert(size="tiny", seed=0)
    bmodel, bp = bf.to_bayesian(bundle.apply_fn, bundle.params, delta=0.05,
                                freeze=True)
    return bmodel, bp


def _port(bp):
    return bt.from_jax_params(
        flatten_dict(bp.params, sep="/"),
        {p: np.asarray(r) for p, r in bp.rho.items()},
        prior_mu={p: np.asarray(m) for p, m in bp.prior_mu.items()},
        device="cpu",
    )


def test_gradients_match_jax(jax_model):
    bmodel, bp = jax_model
    port = _port(bp)
    key = jax.random.key(11)
    batch = _batch(0)

    def objective(bparams):
        out, aux = bmodel.mc_apply_fused(
            bparams, key, S, input_ids=jnp.asarray(batch["input_ids"]),
            attention_mask=jnp.asarray(batch["attention_mask"]),
            token_type_ids=jnp.asarray(batch["token_type_ids"]), antithetic=True)
        nll, _ = jtraining.classification_loss(
            out, {"labels": jnp.asarray(batch["labels"])})
        return jelbo.elbo_loss(nll, aux["log_prior"],
                               aux["log_variational_posterior"], N_BATCHES)

    jloss, jgrads = jax.jit(jax.value_and_grad(objective))(bp)
    named = port.trainable_parameters()
    hook = _hook(bmodel, [[key]])
    loss, _ = training.elbo_objective(
        training.pick_mc(port, True, "antithetic"), 0, S, _port_batch(batch), N_BATCHES,
        eps_hook=lambda *a: hook(0, *a))
    loss.backward()
    # the loss is dominated by the KL term (~1e5 summed over ~3e5 weights);
    # both sides sum it in f32 in other orders (rtol 2e-5, see
    # test_torch_bert.py)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=2e-5)
    jflat = flatten_dict(jgrads.params, sep="/")
    n_rho = n_other = 0
    for name, t, _ in named:
        kind, path = name.split("/", 1)
        want = np.asarray(jgrads.rho[path] if kind == "rho" else jflat[path])
        got = t.grad.numpy()
        # f32 forward and backward in another summation order: each leaf's
        # gradient within 1e-4 of its largest entry
        scale = max(np.abs(want).max(), 1e-12)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=name)
        n_rho += kind == "rho"
        n_other += kind == "params"
    assert n_rho == len(bmodel.spec.paths)
    # unconverted leaves: 3 embedding tables + 5 LayerNorms x (scale, bias)
    assert n_other == 3 + 2 * 5
    # frozen mu got no gradient
    for p in port.spec.paths:
        assert leaf(port.model, p).grad is None
        assert not leaf(port.model, p).requires_grad


@pytest.mark.parametrize("mc_chunk", [None, 2])
def test_two_steps_match_jax(jax_model, mc_chunk):
    bmodel, bp = jax_model
    port = _port(bp)
    schedule = optax.linear_schedule(LR, 0.0, 10)
    jtx = jmasked_optimizer(
        jtraining.adamw_with_decay_groups(schedule, WD, jtraining.default_no_decay,
                                          eps=1e-8, clip_norm=1.0),
        bmodel.trainable_mask(bp))
    jstep = jtraining.make_elbo_train_step(bmodel, jtx, S, N_BATCHES,
                                           estimator="antithetic",
                                           mc_chunk=mc_chunk)
    tx = training.adamw_with_decay_groups(
        training.linear_schedule(LR, 0.0, 10), WD, training.default_no_decay,
        eps=1e-8, clip_norm=1.0)
    opt = optim.masked_optimizer(tx, port)
    keys_of_step = [None]
    step = training.make_elbo_train_step(port, opt, S, N_BATCHES, estimator="antithetic",
                                         mc_chunk=mc_chunk, eps_hook=_hook(bmodel, keys_of_step))
    jbp, jstate = bp, jtx.init(bp)
    n_chunks = S // mc_chunk if mc_chunk else 1
    for i, key in enumerate((jax.random.key(21), jax.random.key(22))):
        batch = _batch(i)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        jbp, jstate, jm = jstep(jbp, jstate, key, jbatch)
        keys_of_step[0] = (jax.random.split(key, n_chunks) if mc_chunk else [key])
        m = step(100 + i, _port_batch(batch))
        for k in ("loss", "nll", "log_prior", "log_variational_posterior"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=2e-5,
                                       err_msg=f"step {i} {k}")
        for k in ("acc", "acc_std"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), atol=1e-6)
        # every parameter after the step: trained ones moved by AdamW from
        # gradients equal to ~1e-4 (an update of at most lr per step, so
        # 1e-6 absolute is ~1e-3 of it); frozen ones bit-equal
        jflat = flatten_dict(jbp.params, sep="/")
        for path, want in jflat.items():
            got = leaf(port.model, path).detach().numpy()
            if path in port.spec.paths:
                np.testing.assert_array_equal(got, np.asarray(want), err_msg=path)
            else:
                np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                           atol=1e-6, err_msg=path)
        for path, want in jbp.rho.items():
            np.testing.assert_allclose(port.rho[path].detach().numpy(),
                                       np.asarray(want), rtol=0, atol=1e-6,
                                       err_msg=path)
    assert opt.count == 2


def test_trainable_mask_matches_jax(jax_model):
    bmodel, bp = jax_model
    port = _port(bp)
    jmask = bmodel.trainable_mask(bp)
    mask = port.trainable_mask()
    assert mask["params"] == flatten_dict(jmask.params, sep="/")
    assert mask["rho"] == jmask.rho
    decays = {n: d for n, _, d in port.trainable_parameters()}
    assert not any(d for n, d in decays.items() if n.startswith("rho/"))
    assert decays["params/bert/embeddings/word_embeddings/embedding"]
    assert not decays["params/bert/embeddings/LayerNorm/scale"]


def test_losses_and_metrics_match_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((S, 16, 3)).astype(np.float32)
    labels = rng.integers(0, 3, 16).astype(np.int32)
    t = torch.from_numpy
    np.testing.assert_allclose(
        float(elbo.cross_entropy_sum(t(logits[0]), t(labels))),
        float(jelbo.cross_entropy_sum(jnp.asarray(logits[0]), jnp.asarray(labels))),
        rtol=1e-6)
    for got, want in zip(elbo.accuracy_and_std(t(logits), t(labels)),
                         jelbo.accuracy_and_std(jnp.asarray(logits), jnp.asarray(labels))):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(
        float(elbo.elbo_loss(torch.tensor(3.0), t(logits[0, :, 0]), t(logits[1, :, 0]), 5)),
        float(jelbo.elbo_loss(3.0, logits[0, :, 0], logits[1, :, 0], 5)), rtol=1e-6)
    for i, m in ((0, 10), (3, 10), (5, 200), (9999, 100000)):
        np.testing.assert_allclose(float(elbo.blundell_weight(i, m)),
                                   float(jelbo.blundell_weight(i, m)), rtol=1e-6)
    reg = rng.standard_normal((S, 16, 1)).astype(np.float32)
    y = rng.uniform(0, 5, 16).astype(np.float32)
    nll, m = training.regression_loss(t(reg), {"labels": t(y)})
    jnll, jm = jtraining.regression_loss(jnp.asarray(reg), {"labels": jnp.asarray(y)})
    np.testing.assert_allclose(float(nll), float(jnll), rtol=1e-6)
    np.testing.assert_allclose(float(m["mse_std"]), float(jm["mse_std"]), rtol=1e-5)
    probs = rng.dirichlet(np.ones(3), 64)
    lab = rng.integers(0, 3, 64)
    assert metrics.expected_calibration_error(probs, lab) == \
        jmetrics.expected_calibration_error(probs, lab)
    for name in ("acc", "acc_f1", "mcc", "pearson_spearman"):
        p = rng.integers(0, 2, 40) if name != "pearson_spearman" else rng.random(40)
        q = rng.integers(0, 2, 40) if name != "pearson_spearman" else rng.random(40)
        assert metrics.glue_metrics(name, p, q) == jmetrics.glue_metrics(name, p, q)


def test_schedule_and_clip_match_optax():
    for init, end, steps in ((2e-5, 0.0, 7), (1e-3, 1e-4, 3)):
        sched = training.linear_schedule(init, end, steps)
        want = optax.linear_schedule(init, end, steps)
        for c in range(steps + 3):
            assert sched(c) == float(want(c))
    joined = training.join_schedules([training.linear_schedule(0.0, 1.0, 2),
                                      training.linear_schedule(1.0, 0.0, 4)], [2])
    jjoined = optax.join_schedules([optax.linear_schedule(0.0, 1.0, 2),
                                    optax.linear_schedule(1.0, 0.0, 4)], [2])
    for c in range(8):
        assert joined(c) == pytest.approx(float(jjoined(c)), rel=1e-7)
    rng = np.random.default_rng(4)
    for scale in (0.1, 10.0):
        gs = [rng.standard_normal(s).astype(np.float32) * scale for s in ((5, 3), (7,))]
        want, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(g) for g in gs], None)
        got = [torch.from_numpy(g.copy()) for g in gs]
        optim.clip_by_global_norm_(got, 1.0)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_default_no_decay_matches_jax():
    for path in ("bert/embeddings/LayerNorm/scale", "classifier/bias",
                 "bert/encoder/layer/0/attention/self/query/kernel",
                 "bert/embeddings/word_embeddings/embedding", "x/layer_norm/w"):
        assert training.default_no_decay(path) == jtraining.default_no_decay(path)


def test_other_estimators_raise(jax_model):
    port = _port(jax_model[1])
    # every estimator of the reference's table now resolves; only an
    # unknown name raises
    assert training.pick_mc(port, True, "naive") == port.mc_apply
    assert training.pick_mc(port, True, "flipout") == port.mc_apply_flipout
    assert (training.pick_mc(port, True, "local") == training.pick_mc(port, True, "lrt")
            == port.mc_apply_lrt)
    with pytest.raises(ValueError):
        training.pick_mc(port, True, "nope")
    # a forward without W residuals now has a backward: it regenerates W
    named = port.trainable_parameters()
    ids = torch.ones((2, 8), dtype=torch.long)
    out, aux = port.mc_apply_fused(0, 2, ids, save_weights=False)
    (out.float().sum() + aux["log_prior"].sum()).backward()
    rho_grads = [t.grad for n, t, _ in named if n.startswith("rho/")]
    assert rho_grads and all(g is not None and bool(torch.isfinite(g).all())
                             for g in rho_grads)


@pytest.mark.parametrize("regression", [False, True])
def test_synthetic_glue_matches_jax(regression):
    n_labels = 1 if regression else 3
    got = bert_glue.load_glue(None, 1024, seed=5, n_labels=n_labels,
                              regression=regression)
    want = jglue.load_glue(None, 1024, seed=5, n_labels=n_labels,
                           regression=regression)
    assert got[2] and want[2]
    for split_got, split_want in zip(got[:2], want[:2]):
        assert split_got.keys() == split_want.keys()
        for k in split_got:
            assert split_got[k].dtype == np.asarray(split_want[k]).dtype
            np.testing.assert_array_equal(split_got[k], np.asarray(split_want[k]))
    batches = list(bert_glue.batch_iter(got[0], 8, seed=3))
    jbatches = list(jglue.batch_iter(want[0], 8, seed=3))
    assert len(batches) == len(jbatches) == 256
    np.testing.assert_array_equal(batches[7]["labels"], np.asarray(jbatches[7]["labels"]))


def test_npz_glue_matches_jax(tmp_path):
    rng = np.random.default_rng(8)
    arrays = {}
    for split, n in (("train", 24), ("dev", 8)):
        arrays[f"{split}_input_ids"] = rng.integers(0, 1024, (n, 16))
        arrays[f"{split}_attention_mask"] = np.ones((n, 16), np.int64)
        arrays[f"{split}_token_type_ids"] = np.zeros((n, 16), np.int64)
        arrays[f"{split}_labels"] = rng.integers(0, 2, n)
    path = tmp_path / "glue.npz"
    np.savez(path, **arrays)
    got = bert_glue.load_glue(str(path), 1024)
    want = jglue.load_glue(str(path), 1024)
    assert not got[2] and not want[2]
    for split_got, split_want in zip(got[:2], want[:2]):
        for k in split_got:
            assert split_got[k].dtype == np.asarray(split_want[k]).dtype
            np.testing.assert_array_equal(split_got[k], np.asarray(split_want[k]))
    # a directory without train.tsv and a vocab.txt: the synthetic stand-in,
    # as in the JAX package
    assert bert_glue.load_glue(str(tmp_path), 1024)[2]
    assert jglue.load_glue(str(tmp_path), 1024)[2]


def test_bert_glue_runs_on_cpu(tmp_path):
    score = bert_glue.train(size="tiny", limit_batches=2, epochs=1, b_epochs=1,
                            samples=2, batch_size=32, device="cpu",
                            logs=str(tmp_path), save_dir=str(tmp_path / "ckpt"))
    assert 0.0 <= score <= 1.0
    lines = (tmp_path / "bert_glue.DELTA_0.05.WEIGHT_DECAY_0.0.jsonl").read_text()
    assert "bayesian_test/ece" in lines
    assert (tmp_path / "ckpt" / "step_1" / "rho.pt").exists()
    # dp = 2 in one process (no launcher's WORLD_SIZE): the world does not
    # match the mesh
    with pytest.raises(ValueError, match="needs 2 ranks; the world has 1"):
        bert_glue.train(size="tiny", dp=2, device="cpu", logs=str(tmp_path))


def test_training_imports_and_runs_without_jax():
    """Every module of the port imports, and a train step runs, with jax,
    flax, optax, transformers and the JAX package blocked."""
    code = textwrap.dedent("""
        import pkgutil, sys
        for name in ("jax", "jaxlib", "flax", "optax", "transformers",
                     "bayeformers_tpu"):
            sys.modules[name] = None
        import torch
        import bayeformers_tpu_torch as bt
        for m in pkgutil.walk_packages(bt.__path__, "bayeformers_tpu_torch."):
            __import__(m.name)
        from bayeformers_tpu_torch.utils.optim import masked_optimizer
        bmodel = bt.to_bayesian(bt.build_bert(size="tiny", device="cpu"),
                                delta=0.05, freeze=True)
        tx = bt.training.adamw_with_decay_groups(1e-3, 0.0, bt.training.default_no_decay)
        step = bt.make_elbo_train_step(bmodel, masked_optimizer(tx, bmodel), 2, 10,
                                       estimator="antithetic")
        ids = torch.arange(1, 13).reshape(2, 6)
        m = step(0, {"input_ids": ids, "labels": torch.tensor([0, 1])})
        assert torch.isfinite(m["loss"])
        # independent draws at an odd S, trained and evaluated
        step = bt.make_elbo_train_step(bmodel, masked_optimizer(tx, bmodel), 3, 10,
                                       estimator="fused")
        m = step(1, {"input_ids": ids, "labels": torch.tensor([0, 1])})
        assert torch.isfinite(m["loss"])
        out, _ = bt.training.make_elbo_eval_step(bmodel, 3, estimator="fused")(
            2, {"input_ids": ids, "labels": torch.tensor([0, 1])})
        assert out.shape == (3, 2, 2)
        bad = [n for n in sys.modules if n.split(".")[0] in (
            "jax", "flax", "optax", "transformers", "bayeformers_tpu")
            and sys.modules[n] is not None]
        assert not bad, bad
        print("trained", float(m["loss"]))
    """)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "trained" in proc.stdout
