"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Every source is compiled for Hopper by its own ``nvcc`` process, all
started together, and one more call links the objects into a plain shared
library with a C interface, which is loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -c -o _build/<name>.o csrc/<name>.cu   (each)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared
         -o _build/libbft_<hash>.so _build/*.o

The library's name carries a hash of the sources and flags, so a changed
source rebuilds and an unchanged one loads what is there. The build runs at
the first call of :func:`library` (never at import), into
``bayeformers_tpu_torch/_build/``, which git ignores. There is no fallback:
a missing ``nvcc`` or a failed build raises.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double
# C entry points and their argument types (pointers and the stream as
# c_void_p, ints as c_int, floats as c_float, doubles as c_double); every
# one returns cudaGetLastError().
SIGNATURES = {
    "bft_bayes_linear": [_P] * 12 + [_I] * 14 + [_F] * 7 + [_P],
    "bft_mha_fwd": [_P] * 5 + [_I] * 6 + [_P],
    "bft_mha_bwd": [_P] * 9 + [_I] * 6 + [_P],
    "bft_reduce_abuv": [_P] * 10 + [_I] * 12 + [_F] * 4 + [_P],
    "bft_reduce_abuv_anti": [_P] * 10 + [_I] * 12 + [_F] * 4 + [_P],
    "bft_logprob": [_P] + [_I] * 4 + [_P] * 3 + [_F, _D] + [_F] * 4 + [_P],
    "bft_logprob_vjp": [_P] + [_I] * 4 + [_P] * 4 + [_F] * 5 + [_P],
    "bft_regen": [_P] * 5 + [_I] * 6 + [_P],
    "bft_unit_eps": [_P] + [_I] * 5 + [_P] * 3,
    "bft_stream_parts": [_P] * 5,
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
last_build_seconds: float | None = None


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cand = Path(home) / "bin" / "nvcc" if home else Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the port's CUDA kernels are "
            "built from csrc/ at first use"
        )
    return found


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _run(cmd: list[str]) -> subprocess.CompletedProcess:
    """``cmd``'s completed process, with its wall seconds as ``.seconds``."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    proc.seconds = time.perf_counter() - t0
    return proc


def objects_dir() -> Path:
    """Where :func:`build` keeps each source's object (``<name>.o``) beside
    the library, for reading one source's device code (``cuobjdump -sass
    regen.o``) without the whole library's."""
    return BUILD_DIR / f"obj_{source_hash()}"


def build() -> Path:
    """Compile ``csrc/*.cu`` into ``_build/libbft_<hash>.so`` unless that
    file exists; returns its path. The sources compile in parallel, one
    ``nvcc`` each, and their objects stay in :func:`objects_dir`; the
    compiler's ``-Xptxas -v`` report (registers, shared memory, spills of
    every kernel) goes to ``_build/nvcc.log``, each command with its
    seconds."""
    global last_build_seconds
    out = BUILD_DIR / f"libbft_{source_hash()}.so"
    if out.exists() and objects_dir().exists():
        last_build_seconds = 0.0
        return out
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in sources()]
        cmds = [[nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(obj), str(src)]
                for src, obj in zip(sources(), objs)]
        with concurrent.futures.ThreadPoolExecutor(len(cmds)) as pool:
            procs = list(pool.map(_run, cmds))
        so_tmp = Path(tmp) / out.name
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(so_tmp), *map(str, objs)]
        if all(p.returncode == 0 for p in procs):
            procs.append(_run(link))
            cmds.append(link)
        log = "".join(f"$ {' '.join(c)}  # {p.seconds:.1f} s\n{p.stdout}{p.stderr}"
                      for c, p in zip(cmds, procs))
        (BUILD_DIR / "nvcc.log").write_text(log)
        if any(p.returncode != 0 for p in procs):
            raise RuntimeError(f"nvcc failed:\n{log}")
        obj_dir = objects_dir()
        obj_dir.mkdir(exist_ok=True)
        for obj in objs:
            os.replace(obj, obj_dir / obj.name)
        os.replace(so_tmp, out)
    last_build_seconds = time.perf_counter() - t0
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use), with argtypes set."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.bft_error_string.argtypes = [ctypes.c_int]
            lib.bft_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = library().bft_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
