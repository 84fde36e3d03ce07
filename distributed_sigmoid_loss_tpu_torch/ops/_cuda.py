"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). Libraries go to ``build/`` at the root of
the checkout, named by a hash of their source and of the shared headers
(``csrc/*.cuh``), so an edited source or header never loads a stale
library. Nothing here runs at import time: the CPU tests import every module
of the package on a host without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack as _dispatch_modes

__all__ = ["SOURCES", "build", "build_other", "load", "library_path", "take_op"]

_PACKAGE = Path(__file__).resolve().parents[1]
CSRC = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE.parent / "build"

# Kernel library name -> source under csrc/.
SOURCES = {
    "short_attention": "short_attention.cu",
    "short_attention_bwd": "short_attention_bwd.cu",
    "short_attention_bwd_batched": "short_attention_bwd_batched.cu",
    "sigmoid_loss": "sigmoid_loss.cu",
    "flash_attention": "flash_attention.cu",
    "flash_attention_bwd": "flash_attention_bwd.cu",
    "attention_f32": "attention_f32.cu",
}

_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def take_op(t) -> bool:
    """Whether a kernel's wrapper takes its custom op for tensor ``t`` rather
    than the launch (or the plain version): while ``torch.export`` traces,
    so the artifact records the op; for a tensor without storage
    (``FakeTensor``: ``obs/attribution.py``'s static attribution), whose
    op's fake version runs and launches nothing; and while a step trace
    records (``obs.attribution.trace_ops``, a dispatch mode that says
    ``takes_ops``), so that the trace sees the op on any device."""
    return (isinstance(t, FakeTensor) or torch.compiler.is_exporting()
            or any(getattr(m, "takes_ops", False) for m in _dispatch_modes()))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=None) -> dict[str, dict]:
    """Compile every missing library in ``names`` (default: all), one ``nvcc``
    per source, all started together. Returns ``{name: {"seconds", "log"}}``
    for the libraries built; raises with the compiler's output on failure."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.monotonic()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *_NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    built = {}
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {SOURCES[name]}:\n{log}")
        os.replace(tmp, out)
        built[name] = {"seconds": time.monotonic() - t0, "log": log}
    return built


def build_other(path, name: str) -> tuple[ctypes.CDLL, str]:
    """Another version of source ``name`` (``path``: a copy of an earlier
    commit's ``csrc/<name>.cu`` beside that commit's headers), built with
    the same flags into ``build/lib<name>_other.so`` and loaded, with the
    compiler's log, for side-by-side timing; raises with the log on
    failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"lib{name}_other.so"
    proc = subprocess.run([_nvcc(), *_NVCC_FLAGS, "-o", str(out), str(path)],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {path}:\n{log}")
    return ctypes.CDLL(str(out)), log


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if it is missing."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            lib = _loaded[name] = ctypes.CDLL(str(path))
        return lib
