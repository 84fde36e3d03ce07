"""ctypes binding for the native (C++) synthetic input engine, the port's
copy of the JAX package's ``data/native_loader.py``.

``native/dataloader.cc``: a worker pool generates batches into a bounded
ring of reusable buffers off the GIL; Python drains them in strict batch
order. Batches are a pure function of (seed, batch index), so the stream
does not depend on the thread count, and it is the JAX package's stream.
The library is built from that source with ``g++`` at first use into the
checkout's git-ignored ``build/`` (named by a hash of the source and the
flags, so an edited source never loads a stale library); nothing is written
into ``native/``. :class:`NativeSyntheticImageText` is a drop-in for
``data.synthetic.SyntheticImageText``: the same dict of CPU tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Iterator

import numpy as np
import torch

from distributed_sigmoid_loss_tpu_torch.data.workers import default_data_workers
from distributed_sigmoid_loss_tpu_torch.utils.config import SigLIPConfig
from distributed_sigmoid_loss_tpu_torch.obs.lockwatch import named_lock

__all__ = ["build_shared_lib", "native_available", "NativeSyntheticImageText", "load_library"]

_REPO = Path(__file__).resolve().parents[2]
NATIVE_DIR = _REPO / "native"
# Where the native libraries are built (tests point it at a temporary
# directory).
BUILD_DIR = _REPO / "build"
_SRC = NATIVE_DIR / "dataloader.cc"
# The JAX package's flags (``native/Makefile``).
_CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread")

_build_lock = named_lock("data.native_loader._build_lock")
_libs: dict[str, ctypes.CDLL] = {}


def _cxx() -> str:
    return os.environ.get("CXX", "g++")


def library_path(src: Path, name: str, ldflags: tuple[str, ...] = ()) -> Path:
    """``BUILD_DIR/lib<name>-<hash>.so``, the hash over the source, the
    compiler and its flags."""
    key = src.read_bytes() + " ".join((_cxx(), *_CXXFLAGS, *ldflags)).encode()
    return BUILD_DIR / f"lib{name}-{hashlib.sha256(key).hexdigest()[:12]}.so"


def build_shared_lib(src: str, lib: str, ldflags: tuple[str, ...] = ()) -> str:
    """Compile ``src`` into the shared library ``lib`` unless it exists;
    returns ``lib``. The compiler writes a temporary file that is renamed
    into place, so concurrent builders never load a half-written library.
    Raises ``RuntimeError`` with the compiler's output when the build
    fails."""
    if os.path.exists(lib):
        return lib
    os.makedirs(os.path.dirname(lib) or ".", exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [_cxx(), *_CXXFLAGS, "-shared", "-o", tmp, src, *ldflags]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:  # no compiler at all
        raise RuntimeError(f"native build failed ({' '.join(cmd)}): {e}") from e
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"native build failed ({' '.join(cmd)}): exit "
                           f"{proc.returncode}:\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def load_built(src: Path, name: str, ldflags: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Build (if needed) and load ``src``'s library; one load per path."""
    path = str(library_path(src, name, ldflags))
    with _build_lock:
        if path not in _libs:
            _libs[path] = ctypes.CDLL(build_shared_lib(str(src), path, ldflags))
        return _libs[path]


def load_library() -> ctypes.CDLL:
    """Build if needed and load the engine; raises where no toolchain
    exists."""
    lib = load_built(_SRC, "dsl_data")
    lib.dsl_pipeline_create.restype = ctypes.c_void_p
    lib.dsl_pipeline_create.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
    ]
    lib.dsl_pipeline_next.restype = ctypes.c_int64
    lib.dsl_pipeline_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                                      ctypes.POINTER(ctypes.c_int32)]
    lib.dsl_pipeline_acquire.restype = ctypes.c_int64
    lib.dsl_pipeline_acquire.argtypes = [ctypes.c_void_p,
                                         ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                                         ctypes.POINTER(ctypes.POINTER(ctypes.c_int32))]
    lib.dsl_pipeline_release.restype = None
    lib.dsl_pipeline_release.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.dsl_pipeline_stop.restype = None
    lib.dsl_pipeline_stop.argtypes = [ctypes.c_void_p]
    lib.dsl_pipeline_destroy.restype = None
    lib.dsl_pipeline_destroy.argtypes = [ctypes.c_void_p]
    return lib


def native_available() -> bool:
    """True when the engine can be built: its source and a working
    compiler."""
    if not _SRC.exists():
        return False
    try:
        subprocess.run([_cxx(), "--version"], capture_output=True, check=True)
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


def _cuda_call(name: str, *args) -> None:
    cudart = torch.cuda.cudart()
    err = getattr(cudart, name)(*args)
    if err != cudart.cudaError.success:
        raise RuntimeError(f"{name}: {cudart.cudaGetErrorString(err)}")


class NativeSyntheticImageText:
    """Drop-in for ``SyntheticImageText`` backed by the C++ engine.

    Yields ``{"images": (B, H, W, 3) f32, "tokens": (B, L) i32}`` CPU
    tensors; batches ``n+1 .. n+queue_depth`` are generated on C++ threads
    while the caller consumes batch ``n``.
    """

    def __init__(self, cfg: SigLIPConfig, global_batch: int, image_seed: int = 42,
                 text_seed: int = 40, num_threads: int | None = None, queue_depth: int = 4):
        self.cfg = cfg
        self.global_batch = global_batch
        # None = auto: cpu_count minus the prefetch/main threads.
        self.num_threads = num_threads if num_threads else default_data_workers()
        self._lib = load_library()
        self._handle = self._lib.dsl_pipeline_create(
            global_batch, cfg.vision.image_size, cfg.text.context_length, cfg.text.vocab_size,
            image_seed, text_seed, self.num_threads, queue_depth)
        if not self._handle:
            raise ValueError("dsl_pipeline_create rejected the config (all sizes/threads/"
                             "depth must be positive)")
        v = cfg.vision
        self._image_shape = (global_batch, v.image_size, v.image_size, 3)
        self._token_shape = (global_batch, cfg.text.context_length)
        self._closed = False
        # The ring slots' image buffers registered with CUDA (page-locked)
        # by the zero-copy stream: address -> bytes, under _pin_lock (a
        # consumer registers a slot while close() may unregister them all).
        self._registered: dict[int, int] = {}
        self._pin_lock = named_lock("data.native_loader.NativeSyntheticImageText._pin_lock")
        # Serializes the native calls against close(): close() first wakes a
        # consumer blocked inside one (dsl_pipeline_stop, taken without this
        # lock), then frees the engine under it, so destroy never races a
        # thread (e.g. the prefetch worker) inside a call.
        self._iter_lock = named_lock("data.native_loader.NativeSyntheticImageText._iter_lock")
        self._close_lock = named_lock("data.native_loader.NativeSyntheticImageText._close_lock")  # serializes concurrent close()rs

    def __iter__(self) -> Iterator[dict]:
        while True:
            images = np.empty(self._image_shape, np.float32)
            tokens = np.empty(self._token_shape, np.int32)
            with self._iter_lock:
                if self._closed:
                    return
                n = self._lib.dsl_pipeline_next(
                    self._handle, images.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    tokens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
            if n < 0:  # stopped under our feet
                return
            yield {"images": torch.from_numpy(images), "tokens": torch.from_numpy(tokens)}

    def _pin(self, images: torch.Tensor) -> None:
        """Register a ring slot's image buffer with CUDA once, so a copy
        from it to the card is a DMA straight out of the ring."""
        ptr = images.data_ptr()
        with self._pin_lock:
            # After close() took the registry, a slot is no longer pinned.
            if not self._closed and ptr not in self._registered:
                nbytes = images.numel() * images.element_size()
                _cuda_call("cudaHostRegister", ptr, nbytes, 0)
                self._registered[ptr] = nbytes

    def batches(self, zero_copy: bool = False) -> Iterator[dict]:
        """Batch stream; ``zero_copy=True`` hands out tensors over the C++
        ring slots instead of copies.

        The tensors are valid only until the next iteration (or generator
        close): the slot goes back to the worker pool then. Where CUDA is
        available the images are a pinned host tensor over the slot (its
        buffer registered with CUDA on first use), so the consumer's
        ``.to("cuda", non_blocking=True)`` reads the ring directly; before
        the slot is handed back, the stream that is current in the consuming
        thread is synchronised, so a copy issued on it has finished
        (``data.loader.prefetch`` pulls with its copy stream current). The
        tokens, a few KB, are a plain view. A consumer that keeps a batch
        past one iteration copies it (``data.loader.put_batch`` always
        does)."""
        if not zero_copy:
            yield from self
            return
        pin = torch.cuda.is_available()
        img_p = ctypes.POINTER(ctypes.c_float)()
        tok_p = ctypes.POINTER(ctypes.c_int32)()
        while True:
            with self._iter_lock:
                if self._closed:
                    return
                handle = self._handle
                n = self._lib.dsl_pipeline_acquire(handle, ctypes.byref(img_p),
                                                   ctypes.byref(tok_p))
            if n < 0:  # stopped under our feet
                return
            try:
                images = torch.from_numpy(np.ctypeslib.as_array(img_p, shape=self._image_shape))
                tokens = torch.from_numpy(np.ctypeslib.as_array(tok_p, shape=self._token_shape))
                if pin:
                    self._pin(images)
                yield {"images": images, "tokens": tokens}
            finally:
                if pin:
                    torch.cuda.current_stream().synchronize()
                # Not under _iter_lock: a concurrent close() may be blocked
                # inside dsl_pipeline_destroy (holding it) waiting for exactly
                # this release. destroy waits for consumers_inside == 0, so
                # the engine is alive here.
                self._lib.dsl_pipeline_release(handle, n)

    def close(self):
        with self._close_lock:
            if self._closed or not self._handle:
                return
            # Wake a blocked consumer first: it holds _iter_lock while inside
            # the native call, so a locked stop would deadlock.
            self._lib.dsl_pipeline_stop(self._handle)
            with self._iter_lock:
                self._closed = True
                with self._pin_lock:
                    registered, self._registered = self._registered, {}
                if registered:
                    # No copy may still read a slot when it is unpinned.
                    torch.cuda.synchronize()
                    for ptr in registered:
                        _cuda_call("cudaHostUnregister", ptr)
                self._lib.dsl_pipeline_destroy(self._handle)
                self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
