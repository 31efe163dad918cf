"""``stack_lm --pp 2`` and ``--ep 2`` on the CPU under ``python -m
torch.distributed.run`` (two processes over gloo on localhost): the ``--pp
2`` log's losses equal those of ``--pp 1`` in one process (the same
kernels' plain versions at the same shapes; the KL summed in another
order), ``--arch dense --ep 2`` trains the ``BayesMoE`` (the reference's
mode rule) and ``--arch transformer --ep 2`` the MoE LM, rank 0 alone
writing the log, with ``n_dev`` 2, and printing the last metrics."""
import argparse
import json
import os
import subprocess
import sys

import numpy as np
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

from bayeformers_tpu_torch.workloads import stack_lm as tlm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(blocks=2, experts=4, features=16, heads=2, ffn=32, seq_len=8, vocab=17,
             microbatches=2, steps=3, samples=2, batch_size=16, n_examples=64, lr=5e-3,
             eval_every=1, seed=0)


def _flags(**kw) -> list[str]:
    return [a for k, v in kw.items() for a in (f"--{k.replace('_', '-')}", str(v))]


def _launch(cwd, **kw) -> list[dict]:
    """The ranks' log lines of a launch run in ``cwd`` (the log under its
    default ``logs/``: some launchers take a ``--logs`` after the module
    for a prefix of their own ``--logs-specs``)."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", "bayeformers_tpu_torch.workloads.stack_lm",
           "--device", "cpu", "--backend", "gloo", *_flags(**dict(SMALL, **kw))]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=240, env=env,
                          cwd=cwd)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    printed = [s for s in proc.stdout.splitlines() if s.startswith("{")]
    assert len(printed) == 1, proc.stdout
    lines = [json.loads(s) for s in (cwd / "logs" / "stack_lm.jsonl").read_text()
             .splitlines()]
    assert [s["step"] for s in lines] == [0, 1, 2]
    assert json.loads(printed[0]) == lines[-1]
    return lines


def test_pp2_losses_equal_pp1(tmp_path):
    one = tlm.run(argparse.Namespace(**SMALL, arch="dense", pp=1, ep=1, device="cpu",
                                     logs=str(tmp_path / "one")))
    want = [json.loads(s) for s in (tmp_path / "one" / "stack_lm.jsonl").read_text()
            .splitlines()]
    (tmp_path / "pp2").mkdir()
    got = _launch(tmp_path / "pp2", pp=2)
    assert (got[-1]["mode"], got[-1]["n_dev"], one["n_dev"]) == ("pp", 2, 1)
    np.testing.assert_allclose([s["loss"] for s in got], [s["loss"] for s in want],
                               rtol=1e-6)
    np.testing.assert_allclose([s["acc"] for s in got], [s["acc"] for s in want])


def test_ep2_dense_trains_the_moe(tmp_path):
    lines = _launch(tmp_path, ep=2)
    assert all((s["mode"], s["arch"], s["n_dev"]) == ("ep", "dense", 2) for s in lines)
    assert all(np.isfinite(s["loss"]) for s in lines)


def test_ep2_transformer_trains_the_moe_lm(tmp_path):
    lines = _launch(tmp_path, ep=2, arch="transformer")
    assert all((s["mode"], s["arch"], s["n_dev"]) == ("ep", "transformer", 2) for s in lines)
    assert all(np.isfinite(s["loss"]) and "copy_acc" in s for s in lines)
