"""The workloads' ``--dp`` / ``--tp`` on the CPU under ``python -m
torch.distributed.run`` (two processes over gloo on localhost): ``bert_glue
--dp 2`` with ``--save-dir`` (rank 0 alone prints and writes; the
checkpoint reloads in one process; each dp rank its own draws,
``--independent-draws``) and ``gpt2_lm --tp 2`` (GPT-2's c_attn permuted
and sharded)."""
import os
import subprocess
import sys

import torch

import bayeformers_tpu_torch as bt
from bayeformers_tpu_torch.utils import checkpoint as ckpt
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _launch(module, *args, timeout=240):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", module, *args]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, env=env,
                          cwd=ROOT)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def test_bert_glue_dp2_writes_one_checkpoint(tmp_path):
    out = _launch("bayeformers_tpu_torch.workloads.bert_glue", "--size", "tiny",
                  "--device", "cpu", "--dp", "2", "--independent-draws",
                  "--limit-batches", "2", "--epochs", "1", "--b-epochs", "1",
                  "--samples", "2", "--batch-size", "16",
                  "--logs", str(tmp_path / "logs"), "--save-dir", str(tmp_path / "ckpt"))
    assert out.count("final score=") == 1, out
    assert (tmp_path / "ckpt" / "step_1" / "rho.pt").exists()
    bmodel = bt.to_bayesian(bt.build_model("bert-base-uncased", size="tiny", device="cpu",
                                           dtype=torch.float32), delta=0.05, freeze=True)
    ckpt.load_checkpoint(str(tmp_path / "ckpt"), bmodel, step=1)
    assert all(bool(torch.isfinite(r).all()) for r in bmodel.rho.values())


def test_gpt2_lm_tp2_runs(tmp_path):
    out = _launch("bayeformers_tpu_torch.workloads.gpt2_lm", "--size", "tiny", "--device",
                  "cpu", "--tp", "2", "--estimator", "antithetic", "--seq", "32",
                  "--n-train", "16", "--n-test", "8", "--batch-size", "4",
                  "--limit-batches", "2", "--samples", "2", "--logs", str(tmp_path))
    assert out.count("done in") == 1, out
    assert "bayesian_acc" in out
