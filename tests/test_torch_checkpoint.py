"""Checkpoints, the hypersearch and TensorBoard event files of the port.

``utils/checkpoint.py``: the JAX package's layout (``step_N`` and
``step_N.meta.json``) holding the model's parameters, ``rho`` and
``prior_mu``, restored bit for bit, and ``--save-dir`` / ``--resume`` in
``bert_glue`` and ``bert_squad`` (a resume past the last epoch evaluates the
restored state), where the file holds the state the run ended with.
``utils/hypersearch.py`` draws the JAX package's trials
bit for bit; ``utils/tb.py`` writes the JAX package's event bytes at a
fixed wall time."""
import json
import time

import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from bayeformers_tpu.utils import checkpoint as jckpt
from bayeformers_tpu.utils import hypersearch as jhs
from bayeformers_tpu.utils import tb as jtb
from bayeformers_tpu_torch.models import families
from bayeformers_tpu_torch.nn.surgery import to_bayesian
from bayeformers_tpu_torch.utils import checkpoint as ckpt
from bayeformers_tpu_torch.utils import hypersearch as hs
from bayeformers_tpu_torch.utils import metrics, tb
from bayeformers_tpu_torch.workloads import bert_glue, bert_squad

CONVERSIONS = {"frozen-moped": {"delta": 0.05, "freeze": True},
               "moped-trainable": {"delta": 0.05},
               "random-init": {"generator": 5}}


def _converted(kind):
    model = families.build_model("bert", size="tiny", device="cpu", num_hidden_layers=1)
    kw = dict(CONVERSIONS[kind])
    if "generator" in kw:
        kw["generator"] = torch.Generator().manual_seed(kw["generator"])
    return to_bayesian(model, **kw)


def _state(bmodel):
    out = {f"params/{n.replace('.', '/')}": p.detach().clone()
           for n, p in bmodel.model.named_parameters()}
    out.update({f"rho/{k}": v.detach().clone() for k, v in bmodel.rho.items()})
    out.update({f"prior_mu/{k}": v.detach().clone() for k, v in bmodel.prior_mu.items()})
    return out


@pytest.mark.parametrize("kind", sorted(CONVERSIONS))
def test_round_trip_is_bit_equal(tmp_path, kind):
    bmodel = _converted(kind)
    with torch.no_grad():  # move every leaf off its start
        for i, t in enumerate(_live(bmodel)):
            t.add_(torch.randn(t.shape, generator=torch.Generator().manual_seed(i)) * 1e-3)
    saved = _state(bmodel)
    path = ckpt.save_checkpoint(str(tmp_path), bmodel, step=3, metadata={"acc": 0.5})
    assert path.endswith("step_3") and (tmp_path / "step_3.meta.json").exists()
    assert ckpt.latest_step(str(tmp_path)) == jckpt.latest_step(str(tmp_path)) == 3
    fresh = _converted(kind)
    restored, meta = ckpt.load_checkpoint(str(tmp_path), fresh, step=3)
    assert restored is fresh and meta == {"acc": 0.5}
    got = _state(fresh)
    assert set(got) == set(saved)
    for k in saved:
        assert torch.equal(got[k], saved[k]), k
    if kind == "frozen-moped":  # the prior still sits on mu itself
        p = fresh.spec.paths[0]
        assert fresh.prior_mu[p].data_ptr() == fresh.model.get_parameter(
            p.replace("/", ".")).data_ptr()


def _live(bmodel):
    seen, out = set(), []
    for t in list(bmodel.model.parameters()) + list(bmodel.rho.values()) + list(
            bmodel.prior_mu.values()):
        if t.data_ptr() not in seen:
            seen.add(t.data_ptr())
            out.append(t)
    return out


def test_load_refuses_another_model(tmp_path):
    ckpt.save_checkpoint(str(tmp_path), _converted("frozen-moped"), step=1)
    other = to_bayesian(families.build_model("bert", size="tiny", device="cpu",
                                             num_hidden_layers=2), delta=0.05, freeze=True)
    with pytest.raises(ValueError, match="missing .*layer/1"):
        ckpt.load_checkpoint(str(tmp_path), other, step=1)
    assert ckpt.latest_step(str(tmp_path / "absent")) is None


def _capture_loads(monkeypatch):
    loaded = []
    orig = ckpt.load_checkpoint

    def load(directory, bmodel, step=0):
        out = orig(directory, bmodel, step=step)
        loaded.append(_state(bmodel))
        return out

    monkeypatch.setattr(ckpt, "load_checkpoint", load)
    return loaded


def _capture_saves(monkeypatch):
    """The models that ``save_checkpoint`` is handed, and the state each held
    at the call."""
    saves = []
    orig = ckpt.save_checkpoint

    def save(directory, bmodel, **kw):
        saves.append((bmodel, _state(bmodel)))
        return orig(directory, bmodel, **kw)

    monkeypatch.setattr(ckpt, "save_checkpoint", save)
    return saves


def _check_saved_is_trained(saves, saved):
    """One save, of the state the run ended with (the steps of its epoch
    taken), and the file equal to it bit for bit."""
    assert len(saves) == 1
    bmodel, at_save = saves[0]
    final = _state(bmodel)
    assert set(saved) == set(at_save) == set(final)
    for k, v in saved.items():
        assert torch.equal(at_save[k], v) and torch.equal(final[k], v), k


def _saved_files(directory, step):
    return {f"{part}/{k}": v for part in ckpt.PARTS for k, v in torch.load(
        f"{directory}/step_{step}/{part}.pt", weights_only=True).items()}


def test_bert_glue_save_and_resume_past_the_end(tmp_path, monkeypatch):
    kw = dict(size="tiny", epochs=1, b_epochs=1, samples=2, batch_size=16,
              limit_batches=2, device="cpu", logs=str(tmp_path / "logs"),
              save_dir=str(tmp_path / "ckpt"))
    saves = _capture_saves(monkeypatch)
    bert_glue.train(**kw)
    assert ckpt.latest_step(kw["save_dir"]) == 1
    meta = json.loads((tmp_path / "ckpt" / "step_1.meta.json").read_text())
    assert meta["delta"] == 0.05 and "acc" in meta
    saved = _saved_files(kw["save_dir"], 1)
    _check_saved_is_trained(saves, saved)
    loaded = _capture_loads(monkeypatch)
    score = bert_glue.train(resume=True, **kw)
    assert 0.0 <= score <= 1.0 and len(loaded) == 1
    for k, v in saved.items():
        assert torch.equal(loaded[0][k], v), k
    lines = [json.loads(x) for x in (tmp_path / "logs").glob("*.jsonl").__next__()
             .read_text().splitlines()]
    # the resumed run trains no Bayesian epoch and evaluates at step 1
    assert any(x["tag"] == "bayesian_test/score" and x["step"] == 1 for x in lines)
    assert ckpt.latest_step(kw["save_dir"]) == 1


def test_bert_squad_save_and_resume(tmp_path, monkeypatch):
    kw = dict(size="tiny", device="cpu", epochs=1, b_epochs=1, samples=2, batch_size=2,
              max_seq=48, limit_batches=2, data_dir=str(tmp_path / "none"),
              logs=str(tmp_path / "logs"), save_dir=str(tmp_path / "ckpt"))
    saves = _capture_saves(monkeypatch)
    bert_squad.train(**kw)
    saved = _saved_files(kw["save_dir"], 1)
    _check_saved_is_trained(saves, saved)
    loaded = _capture_loads(monkeypatch)
    bert_squad.train(resume=True, **kw)
    assert len(loaded) == 1
    for k, v in saved.items():
        assert torch.equal(loaded[0][k], v), k


def test_hypersearch_draws_the_jax_trials():
    def trial(delta, weight_decay, offset=0.0):
        if delta > 0.08:
            raise RuntimeError("a failing trial")
        return -abs(delta - 0.03) - weight_decay + offset

    for seed in (0, 7):
        got, want = hs.HyperSearch(seed=seed), jhs.HyperSearch(seed=seed)
        for h in (got, want):
            h["delta"] = (1e-2, 1e-1), h.LOG_SCALE
            h["weight_decay"] = (0.0, 1e-3), h.LINEAR_SCALE
        a = got.search(trial, iterations=12, offset=1.0)
        b = want.search(trial, iterations=12, offset=1.0)
        assert a.value == b.value and a.hyperparameters == b.hyperparameters
        c = hs.search_delta_weight_decay(trial, 12, seed, offset=1.0)
        assert c.value == a.value and c.hyperparameters == a.hyperparameters
    with pytest.raises(RuntimeError, match="failing"):
        s = hs.HyperSearch(seed=1)
        s["delta"] = (0.09, 0.1), s.LINEAR_SCALE
        s.search(lambda delta: trial(delta, 0.0), iterations=2, on_error="raise")
    best = hs.Score()
    assert best.update(1.0, {"x": 1}) and not best.update(0.5, {"x": 2})


def test_tensorboard_bytes_equal_the_jax_writer(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1700000000.25)
    files = []
    for mod, d in ((tb, "port"), (jtb, "jax")):
        w = mod.EventWriter(str(tmp_path / d), "run")
        w.scalar("loss", 1.5, 3)
        w.scalars("eval", {"acc": 0.75, "nll": 0.25, "note": "skipped"}, 4)
        w.close()
        files.append(w.path)
    port, ref = (open(f, "rb").read() for f in files)
    assert port == ref and files[0].rsplit("/", 1)[1] == files[1].rsplit("/", 1)[1]
    assert list(tb.read_events(files[0]))[1:] == [(3, {"loss": 1.5}),
                                                  (4, {"eval/acc": 0.75, "eval/nll": 0.25})]
    assert tb.crc32c(b"123456789") == 0xE3069283


def test_metrics_writer_tensorboard(tmp_path):
    w = metrics.MetricsWriter(str(tmp_path), "run", tensorboard=True)
    w.scalars("phase", {"acc": 0.5}, 2)
    w.close()
    (event,) = (tmp_path / "run").glob("events.out.tfevents.*")
    assert list(tb.read_events(str(event)))[1:] == [(2, {"phase/acc": 0.5})]
    assert json.loads((tmp_path / "run.jsonl").read_text())["tag"] == "phase/acc"
    plain = metrics.MetricsWriter(str(tmp_path), "plain")
    plain.close()
    assert not (tmp_path / "plain").exists()



def test_resume_policy(tmp_path):
    bmodel = _converted("moped-trainable")
    d = str(tmp_path / "ckpt")
    assert ckpt.resume_epoch(d, bmodel, True, "test") == 0  # nothing saved yet
    ckpt.save_epoch(None, bmodel, 0, {"acc": 0.5})
    assert ckpt.latest_step(d) is None
    ckpt.save_epoch(d, bmodel, 2, {"acc": 0.5})
    assert ckpt.latest_step(d) == 3
    want = _state(bmodel)
    with torch.no_grad():
        for t in _live(bmodel):
            t.add_(1.0)
    moved = _state(bmodel)
    assert ckpt.resume_epoch(d, bmodel, False, "test") == 0
    assert ckpt.resume_epoch(None, bmodel, True, "test") == 0
    assert all(torch.equal(bmodel_v, moved[k]) for k, bmodel_v in _state(bmodel).items())
    assert ckpt.resume_epoch(d, bmodel, True, "test") == 3
    got = _state(bmodel)
    assert all(torch.equal(got[k], v) for k, v in want.items())
