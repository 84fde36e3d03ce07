"""ctypes binding for the native JPEG decode engine, the port's copy of the
JAX package's ``data/native_decode.py``.

:func:`decode_batch` decodes a list of image blobs to the training layout
((S, S, 3) float32 in [-1, 1], shorter-side resize + center crop, the
geometry of ``files.decode_and_resize``) with libjpeg fanned over threads,
off the GIL. The library is ``native/jpeg_decode.cc`` built with ``g++ ...
-ljpeg`` into the checkout's ``build/`` at first use (see
``data/native_loader.py``). Blobs it rejects (other formats, corrupt data)
are retried one by one through ``files.decode_and_resize``, so the function
takes anything that does, and a blob neither decodes raises.

:func:`native_decode_available` is False where libjpeg or a compiler is
missing. libjpeg's IDCT and the engine's resampling differ from PIL's by a
few least-significant bits a pixel: each engine is deterministic, the two
are not interchangeable bit for bit.
"""

from __future__ import annotations

import ctypes
import os
import warnings

import numpy as np

from distributed_sigmoid_loss_tpu_torch.data import native_loader
from distributed_sigmoid_loss_tpu_torch.data.workers import default_data_workers
from distributed_sigmoid_loss_tpu_torch.obs.lockwatch import named_lock

__all__ = ["native_decode_available", "decode_batch", "default_decode_threads"]

_SRC = native_loader.NATIVE_DIR / "jpeg_decode.cc"
_LDFLAGS = ("-ljpeg",)

_build_lock = named_lock("data.native_decode._build_lock")
# Library paths whose build or load failed: not tried again.
_failed: set[str] = set()


def default_decode_threads() -> int:
    """Per-flush thread cap when the caller passes no ``threads``:
    ``DSL_DECODE_THREADS``, else the host-worker resolver
    (``data/workers.py``)."""
    env = os.environ.get("DSL_DECODE_THREADS")
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            warnings.warn(f"DSL_DECODE_THREADS={env!r} is not an int; ignoring")
    return default_data_workers()


def _load():
    """The engine, or None (with one warning) where it cannot be built."""
    path = str(native_loader.library_path(_SRC, "dsl_jpeg", _LDFLAGS))
    with _build_lock:
        if path in _failed:
            return None
        try:
            lib = native_loader.load_built(_SRC, "dsl_jpeg", _LDFLAGS)
        except (RuntimeError, OSError) as e:
            _failed.add(path)
            warnings.warn(f"native JPEG decode unavailable ({e}); using decode_and_resize")
            return None
    lib.dsl_jpeg_decode_batch.restype = ctypes.c_int64
    lib.dsl_jpeg_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_uint8),
    ]
    return lib


def native_decode_available() -> bool:
    return _load() is not None


def decode_batch(blobs: list[bytes], image_size: int, threads: int | None = None) -> np.ndarray:
    """Decode image blobs → ``(len(blobs), S, S, 3)`` float32 in [-1, 1].

    JPEGs go through the native threaded path; anything it rejects is
    retried with ``files.decode_and_resize``, which raises on undecodable
    input."""
    from distributed_sigmoid_loss_tpu_torch.data.files import decode_and_resize

    n = len(blobs)
    out = np.zeros((n, image_size, image_size, 3), np.float32)
    lib = _load()
    todo = range(n)
    if lib is not None and n:
        datas = (ctypes.c_char_p * n)(*blobs)
        lens = (ctypes.c_int64 * n)(*[len(b) for b in blobs])
        fail = (ctypes.c_uint8 * n)()
        if threads is None:
            threads = min(n, default_decode_threads())
        lib.dsl_jpeg_decode_batch(ctypes.cast(datas, ctypes.POINTER(ctypes.c_char_p)), lens, n,
                                  image_size, max(1, threads),
                                  out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), fail)
        todo = [i for i in range(n) if fail[i]]
    for i in todo:
        out[i] = decode_and_resize(blobs[i], image_size)
    return out
