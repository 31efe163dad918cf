"""BERT's sibling families in the port against the JAX package, on the CPU
in f32: DistilBERT, RoBERTa, CamemBERT (RoBERTa's builder), Electra (with
the tiny preset's 64 -> 128 embedding projection) and ALBERT (one layer
called twice).

Each tiny family (one layer; ALBERT's one layer twice) is built by the JAX
package's ``build_model``, converted by its ``to_bayesian`` under frozen
MOPED and under random init (the scale mixture), and carried over with
``from_jax_params``. Both then run the fused forward under each
conversion with antithetic pairs and with independent draws (frozen
MOPED with antithetic pairs and random init with independent draws in
the family's file; the two crossed pairings in its ``_cross.py`` file), with
the JAX package's own per-leaf draws injected
through the port's eps hook (``tests/test_torch_bert.py::_jax_hook``): the
logits within 1e-4, the log-probs within 2e-5 relative, and one ELBO
objective's gradients, each trained leaf within 1e-4 of its largest entry.
Here Electra, the family dispatch and input pruning, and the ALBERT
leaves' one draw and one KL term; the other families in
``tests/test_torch_families_*.py``, one test process each.
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
from bayeformers_tpu import elbo as jelbo
from bayeformers_tpu import training as jtraining
from bayeformers_tpu.models import bert as jbert
from bayeformers_tpu_torch import elbo, training
from bayeformers_tpu_torch.models import families
from bayeformers_tpu_torch.models.bert import BertConfig
from bayeformers_tpu_torch.nn import fused as tfused
from bayeformers_tpu_torch.ops import fused_linear as ops_fused
from test_torch_bert import _jax_hook
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

S, B, L = 4, 3, 16
N_BATCHES = 7
NAMES = ("distilbert-base-uncased", "roberta-base", "camembert-base", "electra-base",
         "albert-base-v2")
CONVERSIONS = {"frozen-moped": {"delta": 0.05, "freeze": True},
               "random-init": {"rng": jax.random.key(5)}}


def depth(family):
    """One layer (ALBERT's one layer twice, so that its leaves are shared)."""
    if family == "distilbert":
        return {"n_layers": 1}
    return {"num_hidden_layers": 2 if family == "albert" else 1}


def convert_pair(name, task="classification", conversion="frozen-moped", layers=None):
    """(the JAX bundle, its BayesianModel, its BayesParams, the port's
    BayesianModel) for a tiny model of ``name``."""
    family = families.family_of(name)
    kw = depth(family) if layers is None else layers
    bundle = jbert.build_model(name, task=task, size="tiny", seed=0, **kw)
    held = {}

    def convert(params):
        held["bmodel"], bp = bf.to_bayesian(bundle.apply_fn, params,
                                            **CONVERSIONS[conversion])
        return bp

    bp = jax.jit(convert)(bundle.params)
    bmodel = held["bmodel"]
    spec = bmodel.spec
    port = bt.from_jax_params(
        flatten_dict(bp.params, sep="/"), {p: np.asarray(r) for p, r in bp.rho.items()},
        prior_mu={p: np.asarray(m) for p, m in bp.prior_mu.items()},
        prior=(spec.prior.pi, spec.prior.sigma1, spec.prior.sigma2),
        moped=spec.moped, frozen=spec.frozen, device="cpu",
        config=BertConfig.from_hf(family, bundle.config.to_dict()))
    return bundle, bmodel, bp, port


def family_batch(bundle, seed=0, Bn=B, Ln=L):
    """Inputs pruned for the family, right padding in row 1 (RoBERTa's pad
    ids there), token types where the family takes them, and labels."""
    rng = np.random.default_rng(seed)
    pad = getattr(bundle.config, "pad_token_id", 0)
    ids = rng.integers(2, 1024, (Bn, Ln)).astype(np.int32)
    mask = np.ones((Bn, Ln), np.int32)
    mask[1, 10:] = 0
    ids[1, 10:] = pad
    tok = np.zeros((Bn, Ln), np.int32)
    if bundle.uses_token_type_ids:
        tok[:, Ln // 2:] = 1
    batch = jbert.prune_inputs(bundle, {"input_ids": ids, "attention_mask": mask,
                                        "token_type_ids": tok})
    batch["labels"] = rng.integers(0, 2, (Bn,)).astype(np.int32)
    return batch


def inputs_of(batch):
    return {k: v for k, v in batch.items() if k != "labels"}


def check_fused_step(bmodel, bp, port, batch, antithetic, key):
    """The fused forward's logits and log-probs and the ELBO objective's
    gradients, port against the JAX package at the JAX package's draws."""
    inputs = {k: jnp.asarray(v) for k, v in inputs_of(batch).items()}
    labels = {"labels": jnp.asarray(batch["labels"])}

    def objective(p):
        out, aux = bmodel.mc_apply_fused(p, key, S, antithetic=antithetic, **inputs)
        nll, _ = jtraining.classification_loss(out, labels)
        loss = jelbo.elbo_loss(nll, aux["log_prior"], aux["log_variational_posterior"],
                               N_BATCHES)
        return loss, (out, aux)

    (jloss, (jout, jaux)), jgrads = jax.jit(jax.value_and_grad(objective, has_aux=True))(bp)
    named = port.trainable_parameters()
    for _, tensor, _ in named:
        tensor.grad = None
    t = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    drawn = []
    out, aux = port.mc_apply_fused(0, S, **inputs_of(t), antithetic=antithetic,
                                   eps_hook=_jax_hook(bmodel, key, drawn))
    assert {p for p, _ in drawn} == set(bmodel.spec.paths)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=0, atol=1e-4)
    for k in ("log_prior", "log_variational_posterior"):
        np.testing.assert_allclose(aux[k].detach().numpy(), np.asarray(jaux[k]), rtol=2e-5,
                                   err_msg=k)
    nll, _ = training.classification_loss(out, {"labels": t["labels"]})
    loss = elbo.elbo_loss(nll, aux["log_prior"], aux["log_variational_posterior"],
                          N_BATCHES)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=2e-5)
    loss.backward()
    jflat = flatten_dict(jgrads.params, sep="/")
    for name, tensor, _ in named:
        kind, path = name.split("/", 1)
        want = np.asarray(jgrads.rho[path] if kind == "rho" else jflat[path])
        scale = max(np.abs(want).max(), 1e-12)
        np.testing.assert_allclose(tensor.grad.numpy(), want, rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=name)
    return named


@functools.lru_cache(maxsize=None)
def cached_pair(name, conversion):
    """:func:`convert_pair` once a test process."""
    return convert_pair(name, conversion=conversion)


def check_family(name, conversion, antithetic):
    """One family's fused step (:func:`check_fused_step`): logits 1e-4,
    log-probs 2e-5 relative, and each trained leaf's gradient of the ELBO
    objective within 1e-4 of its largest entry (rho always, mu under
    random init, the embeddings and LayerNorms)."""
    bundle, bmodel, bp, port = cached_pair(name, conversion)
    named = check_fused_step(bmodel, bp, port, family_batch(bundle), antithetic,
                             jax.random.key(7 if antithetic else 8))
    mu = {n for n, _, _ in named if n.startswith("params/") and n.split("/", 1)[1] in port.rho}
    assert bool(mu) == (conversion == "random-init")
    assert any(n.startswith("rho/") for n, _, _ in named)


# Electra here (its tiny preset's 64 -> 128 projection); DistilBERT, RoBERTa
# with CamemBERT, and ALBERT in test_torch_families_*.py, one test process
# each: frozen MOPED with antithetic pairs and random init with independent
# draws, the crossed pairings in each family's _cross.py file.
CASES = (("electra-base", "frozen-moped", True), ("electra-base", "random-init", False))


@pytest.mark.parametrize("name,conversion,antithetic", CASES)
def test_family_matches_jax(name, conversion, antithetic):
    check_family(name, conversion, antithetic)


def test_family_dispatch_and_pruning():
    """The reference's dispatch and pruning (``tests/test_models.py:20-33``):
    the port's ``build_model`` picks the same family, ``uses_token_type_ids``
    and ``prune_inputs`` agree with the JAX package's."""
    for name, expect_tt, cls in (
            ("bert-base-uncased", True, families.BertForSequenceClassification),
            ("distilbert-base-uncased", False, families.DistilBertForSequenceClassification),
            ("roberta-base", False, families.RobertaForSequenceClassification),
            ("camembert-base", False, families.RobertaForSequenceClassification),
            ("electra-base", True, families.ElectraForSequenceClassification),
            ("albert-base-v2", True, families.AlbertForSequenceClassification)):
        model = families.build_model(name, size="tiny", seed=0, device="cpu",
                                     dtype=torch.float32)
        assert type(model) is cls, name
        assert families.uses_token_type_ids(model) is expect_tt, name
        inputs = {"input_ids": 0, "attention_mask": 0, "token_type_ids": 0}
        pruned = families.prune_inputs(model, inputs)
        assert ("token_type_ids" in pruned) is expect_tt, name
        assert families.input_keys(model) == tuple(pruned), name
    t5 = families.build_model("t5-small", size="tiny", device="cpu", dtype=torch.float32)
    assert t5.family == "t5" and "decoder_input_ids" in families.input_keys(t5)
    assert not families.uses_token_type_ids(t5)
    vit = families.build_model("google/vit-base-patch16-224", size="tiny", device="cpu",
                               dtype=torch.float32)
    assert families.input_keys(vit) == ("pixel_values",)
    with pytest.raises(ValueError, match="causal-lm"):
        families.build_model("gpt2", task="classification", device="cpu")


def test_synthetic_batch_matches_jax():
    """``synthetic_batch`` draws the JAX package's batch from the same
    generator, for classification and for the span task."""
    for task in ("classification", "qa"):
        want = jbert.synthetic_batch(np.random.default_rng(3), 4, 24, 1024, 3, task=task)
        got = families.synthetic_batch(np.random.default_rng(3), 4, 24, 1024, 3, task=task)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


def test_albert_shared_leaves_draw_once_and_count_once(monkeypatch):
    """ALBERT's one layer, called three times a forward: each call of a
    shared leaf gets the same seeds (the same W), each leaf's log-probs
    count once, and its gradient sums the three calls' (against the JAX
    package's in :func:`test_fused_step_matches_jax`)."""
    model = families.build_family("albert", size="tiny", seed=0, device="cpu",
                                  dtype=torch.float32, num_hidden_layers=3)
    bmodel = bt.to_bayesian(model, delta=0.05, freeze=True)
    calls = {}
    orig = ops_fused.bayes_linear

    def spy(x, mu, rho, seeds, **kw):
        calls.setdefault(mu.data_ptr(), []).append(seeds.clone())
        return orig(x, mu, rho, seeds, **kw)

    monkeypatch.setattr(ops_fused, "bayes_linear", spy)
    named = bmodel.trainable_parameters()
    mc = tfused.FusedMC(bmodel, 3, 2, antithetic=True, save_weights=True, impl="plain",
                        eps_hook=None)
    ids = torch.randint(2, 1000, (2, 8))
    out, aux = tfused.run_mc(mc, 2, ids)
    kernels = [p for p in bmodel.spec.paths if p.endswith("/kernel")]
    shared = [p for p in kernels if "albert_layer_groups" in p]
    assert len(shared) == 6
    by_path = {p: calls[bmodel.model.get_parameter(p.replace("/", ".")).data_ptr()]
               for p in kernels}
    for p in kernels:
        n = 3 if p in shared else 1
        assert len(by_path[p]) == n, p
        assert all(torch.equal(s, by_path[p][0]) for s in by_path[p]), p
    # one (log_q, log_p) term a converted leaf, kernels and biases
    assert len(mc.collected) == len(bmodel.spec.paths)
    (out.sum() + aux["log_variational_posterior"].sum()).backward()
    grads = {n: t.grad for n, t, _ in named}
    assert all(grads[f"rho/{p}"] is not None and torch.isfinite(grads[f"rho/{p}"]).all()
               for p in shared)
