"""The MNIST slice against the JAX package: ``utils/data.py`` (idx files,
plain and gzipped, and the synthetic stand-in, bit for bit; the batch
iterator), the reference MLP (``models/mlp.py``) frequentist and MOPED-
converted under every estimator at the JAX package's own draws (outputs
rtol 1e-5, log-probs and KL rtol 2e-5), and ``workloads/mlp_mnist.py`` on
the CPU from idx files."""
import gzip
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from test_torch_bert import _jax_hook
from test_torch_estimators import S, _hook  # the hook draws S samples
from torch_threads import one_torch_thread  # noqa: F401

import bayeformers_tpu as bf
import bayeformers_tpu_torch as bt
from bayeformers_tpu.models import mlp as jmlp
from bayeformers_tpu.utils import data as jdata
from bayeformers_tpu_torch import training
from bayeformers_tpu_torch.models import mlp as mlp_lib
from bayeformers_tpu_torch.utils import data as data_lib
from bayeformers_tpu_torch.workloads import mlp_mnist

jax.config.update("jax_platforms", "cpu")
B = 6
NARROW = (96, 64)  # the converted MLP's input and hidden widths


def write_idx(path, arr: np.ndarray) -> None:
    """An idx file (``.gz`` compressed when the name says so)."""
    code = {np.dtype(np.uint8): 0x08, np.dtype(np.int32): 0x0C,
            np.dtype(np.float32): 0x0D}[arr.dtype]
    big = arr.astype(arr.dtype.newbyteorder(">"))
    raw = struct.pack(">HBB", 0, code, arr.ndim) + struct.pack(
        ">" + "I" * arr.ndim, *arr.shape) + big.tobytes()
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wb") as fh:
        fh.write(raw)


def write_mnist(root, n_train=192, n_test=64, seed=0, gz=False):
    """Seeded digits in the four MNIST idx files under ``root``."""
    rng = np.random.default_rng(seed)
    sfx = ".gz" if gz else ""
    for stem, n in (("train", n_train), ("t10k", n_test)):
        write_idx(root / f"{stem}-images-idx3-ubyte{sfx}",
                  rng.integers(0, 256, (n, 28, 28)).astype(np.uint8))
        write_idx(root / f"{stem}-labels-idx1-ubyte{sfx}",
                  rng.integers(0, 10, n).astype(np.uint8))


@pytest.mark.parametrize("source", ["idx", "gz", "synthetic"])
def test_load_mnist_bit_equal(tmp_path, source):
    if source != "synthetic":
        write_mnist(tmp_path, gz=source == "gz")
    for seed in (0, 3):
        got = data_lib.load_mnist(str(tmp_path), seed=seed)
        want = jdata.load_mnist(str(tmp_path), seed=seed)
        assert got[4] == want[4] == (source == "synthetic")
        for a, b in zip(got[:4], want[:4]):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    with pytest.raises(FileNotFoundError):
        data_lib.load_mnist(str(tmp_path / "absent"), synthetic_ok=False)


def test_batches_match():
    x = np.arange(70 * 3, dtype=np.float32).reshape(70, 3)
    y = np.arange(70, dtype=np.int32)
    for kw in ({"seed": 5}, {"seed": None, "drop_remainder": False}):
        got = list(data_lib.batches(x, y, 16, **kw))
        want = list(jdata.batches(x, y, 16, **kw))
        assert len(got) == len(want)
        for (a, b), (c, d) in zip(got, want):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)
    assert data_lib.num_batches(70, 16) == jdata.num_batches(70, 16) == 4
    assert data_lib.num_batches(70, 16, False) == jdata.num_batches(70, 16, False) == 5


def _images(seed=1, dim=784):
    return np.random.default_rng(seed).uniform(0, 1, (B, dim)).astype(np.float32)


def test_mlp_forward_matches_jax():
    apply_fn, params = jmlp.make_mlp(jax.random.key(0))
    port = mlp_lib.MLP(device="cpu")
    with torch.no_grad():
        for path, arr in flatten_dict(params, sep="/").items():
            port.get_parameter(path.replace("/", ".")).copy_(torch.from_numpy(np.array(arr)))
    x = _images()
    want = np.asarray(apply_fn(params, jnp.asarray(x)))
    got = port(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert [n for n, _ in port.named_parameters()] == [
        "fc1.kernel", "fc1.bias", "fc2.kernel", "fc2.bias", "head.kernel", "head.bias"]
    built = mlp_lib.build_mlp(0, device="cpu")
    assert float(built.fc1.kernel.abs().max()) <= 2 * (1 / 784) ** 0.5 / 0.8796 + 1e-6


@pytest.fixture(scope="module")
def converted():
    """The JAX MLP, narrowed to 96 -> 64 -> 64 -> 10, converted by
    ``to_bayesian(delta=0.05)`` (the workload's MOPED, mu trained) and the
    port's ``from_jax_params`` of it."""
    apply_fn, params = jmlp.make_mlp(jax.random.key(0), input_dim=NARROW[0],
                                     hidden=NARROW[1])
    bmodel, bp = bf.to_bayesian(apply_fn, params, delta=0.05)
    port = bt.from_jax_params(
        flatten_dict(bp.params, sep="/"), {p: np.asarray(r) for p, r in bp.rho.items()},
        prior_mu={p: np.asarray(m) for p, m in bp.prior_mu.items()},
        moped=True, frozen=False, device="cpu")
    assert isinstance(port.model, mlp_lib.MLP)
    assert port.spec.paths == tuple(sorted(bp.rho))
    return bmodel, bp, port


@pytest.mark.parametrize("estimator", ["fused", "antithetic", "naive", "flipout", "local"])
def test_converted_mlp_matches_jax(converted, estimator):
    bmodel, bp, port = converted
    key = jax.random.key(7)
    x = _images(2, NARROW[0])
    if estimator in ("fused", "antithetic"):
        n = 4  # even, for the pairs
        out, aux = bmodel.mc_apply_fused(bp, key, n, jnp.asarray(x), save_weights=False,
                                         antithetic=estimator == "antithetic")
        hook = _jax_hook(bmodel, key)
    else:
        n = S
        fn = {"naive": bmodel.mc_apply, "flipout": bmodel.mc_apply_flipout,
              "local": bmodel.mc_apply_lrt}[estimator]
        out, aux = fn(bp, key, n, jnp.asarray(x))
        hook = _hook(bmodel, key, estimator)
    with torch.no_grad():
        got, gaux = training.pick_mc(port, True, estimator)(
            0, n, torch.from_numpy(x), eps_hook=hook)
    assert got.shape == (n, B, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(out), rtol=1e-5, atol=1e-5)
    keys = ("kl",) if "kl" in aux else ("log_prior", "log_variational_posterior")
    for k in keys:
        np.testing.assert_allclose(gaux[k].numpy(), np.asarray(aux[k]), rtol=2e-5, err_msg=k)


def test_workload_runs_on_cpu_from_idx(tmp_path):
    data = tmp_path / "mnist"
    data.mkdir()
    write_mnist(data, n_train=256, n_test=64)
    logs = tmp_path / "logs"
    res = mlp_mnist.train(data_dir=str(data), logs=str(logs), limit_batches=2,
                          samples=2, estimator="fused", device="cpu")
    assert set(res) == {"freq_acc", "moped_acc", "bayesian_acc", "acc_std"}
    assert all(np.isfinite(v) for v in res.values())
    text = (logs / "mlp_mnist.DELTA_0.05.jsonl").read_text()
    assert "bayesian_eval/log_prior" in text and "bayesian/acc_std" in text
    assert "bayesian_train" in (logs / "mlp_mnist.DELTA_0.05.results.json").read_text()
    with pytest.raises(ValueError, match="estimator"):
        mlp_mnist.train(data_dir=str(data), logs=str(logs), estimator="mystery",
                        device="cpu")
