"""``bayeformers_tpu_torch/workloads/stack_lm.py`` against the JAX package's
workload: the numpy data bit-equal, the flags and defaults the same, ``run``
for ``--arch dense`` and ``--arch transformer`` at one device (the same
metric keys and mode, one JSONL line an eval interval, the dense task and
the copy task learning), and ``--pp 2`` / ``--ep 2`` outside a launcher of
two ranks raising with the world size. Their runs under ``python -m
torch.distributed.run`` are in ``test_torch_parallel_stack_lm.py``."""
import argparse
import json

import jax
import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401

from bayeformers_tpu.workloads import stack_lm as jlm
from bayeformers_tpu_torch.workloads import stack_lm as tlm

jax.config.update("jax_platforms", "cpu")


def test_data_matches_jax_workload():
    X, y = tlm.synthetic_task(3, 50, 12)
    jX, jy = jlm.synthetic_task(3, 50, 12)
    np.testing.assert_array_equal(X, np.asarray(jX))
    np.testing.assert_array_equal(y, np.asarray(jy))
    for got, want in zip(tlm.synthetic_copy_corpus(4, 20, 8, 17),
                         jlm.synthetic_copy_corpus(4, 20, 8, 17)):
        np.testing.assert_array_equal(got, np.asarray(want))


def test_flags_and_defaults_match_jax():
    """Every flag of the reference's CLI with its default (the port adds
    ``--device``, default cuda, and ``--backend`` of the ranks, default
    None: the device's)."""
    port = vars(tlm.parser().parse_args([]))
    assert port.pop("device") == "cuda"
    assert port.pop("backend") is None
    want = dict(arch="dense", pp=1, ep=1, heads=4, seq_len=16, vocab=64, blocks=8,
                experts=8, features=128, ffn=256, microbatches=4, steps=100, samples=2,
                batch_size=64, n_examples=1024, lr=1e-3, eval_every=10, seed=0,
                logs="logs")
    assert port == want


def _args(tmp_path, sub, **kw):
    base = dict(arch="dense", pp=1, ep=1, blocks=2, experts=4, features=16, heads=2,
                ffn=32, seq_len=8, vocab=17, microbatches=2, steps=6, samples=1,
                batch_size=16, n_examples=64, lr=5e-3, eval_every=2, seed=0,
                logs=str(tmp_path / sub))
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.mark.parametrize("arch", ["dense", "transformer"])
def test_run_matches_jax_workload(tmp_path, arch):
    """The same mode, metric keys and JSONL lines as the JAX workload's run."""
    want = jlm.run(_args(tmp_path, "jax", arch=arch))
    got = tlm.run(_args(tmp_path, "port", arch=arch, device="cpu"))
    assert set(got) == set(want)
    assert (got["mode"], got["arch"], got["n_dev"]) == (want["mode"], want["arch"], 1)
    assert got["mode"] == ("pp" if arch == "dense" else "single")
    lines = [json.loads(s) for s in (tmp_path / "port" / "stack_lm.jsonl").read_text()
             .splitlines()]
    jlines = (tmp_path / "jax" / "stack_lm.jsonl").read_text().splitlines()
    assert [s["step"] for s in lines] == [0, 2, 4, 5] and len(jlines) == len(lines)
    assert all(np.isfinite(s["loss"]) for s in lines)


def test_dense_task_learns(tmp_path):
    """The separable task through the pipeline schedule: the loss falls and
    the accuracy climbs well above chance, as the reference's test asks."""
    last = tlm.run(_args(tmp_path, "learn", blocks=4, features=32, microbatches=4,
                         steps=40, samples=2, batch_size=64, n_examples=256,
                         eval_every=5, device="cpu"))
    lines = [json.loads(s) for s in (tmp_path / "learn" / "stack_lm.jsonl").read_text()
             .splitlines()]
    assert lines[-1]["loss"] < lines[0]["loss"]
    assert last["acc"] > 0.7


@pytest.mark.parametrize("arch", ["dense", "transformer"])
@pytest.mark.parametrize("axis", ["pp", "ep"])
def test_world_size_other_than_n_raises(tmp_path, monkeypatch, arch, axis):
    """``--pp 2`` / ``--ep 2`` in a world of one rank (no launcher) or of
    three raise before any group is built, naming the launch."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match=f"--{axis} 2 needs 2 ranks; the world has 1"):
        tlm.run(_args(tmp_path, "x", arch=arch, device="cpu", **{axis: 2}))
    monkeypatch.setenv("WORLD_SIZE", "3")
    with pytest.raises(ValueError, match="nproc-per-node 2"):
        tlm.run(_args(tmp_path, "x", arch=arch, device="cpu", **{axis: 2}))


def test_both_axes_raise(tmp_path):
    with pytest.raises(ValueError, match="separate modes"):
        tlm.run(_args(tmp_path, "x", pp=2, ep=2, device="cpu"))
