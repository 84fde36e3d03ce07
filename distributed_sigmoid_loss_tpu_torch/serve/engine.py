"""Bucketed inference engine: every call is padded up to a fixed
(batch_bucket, len_bucket) grid point, run through the tower, and sliced
back down.

PyTorch runs eagerly, so there is no compile per shape here; the bucket grid
is kept anyway because it bounds the set of shapes the device sees (what a
later CUDA-graph capture needs), and ``compile_count`` counts the distinct
(kind, padded shape) programs run. After :meth:`warmup` it equals
``bucket_space`` and never grows.

Rows are independent through both towers (attention mixes within a row
only), so batch padding never perturbs real rows. Text length padding uses
token id 0 up to the bucket, as the training tokenizer pads to
``context_length``.

Calls run under ``torch.inference_mode()``, one at a time (the model's
parameters are swapped in per call by ``torch.func.functional_call``, which
is not safe to run concurrently on one module), and return host numpy f32.
The chaos points ``engine.latency`` and ``engine.exception``
(``serve/siege.py``) sit where JAX's do, before the call. The JAX package's
``mesh=`` split of a batch over devices is not ported yet (ROADMAP queue A
item 9).
"""

from __future__ import annotations

from collections import Counter
from typing import Any, Callable, Sequence

import numpy as np
import torch

from distributed_sigmoid_loss_tpu_torch.serve.siege import maybe_inject
from distributed_sigmoid_loss_tpu_torch.utils.device import resolve_device
from distributed_sigmoid_loss_tpu_torch.obs.lockwatch import named_lock

__all__ = ["InferenceEngine"]


def _validated_buckets(buckets: Sequence[int], what: str) -> tuple[int, ...]:
    out = tuple(sorted(set(int(b) for b in buckets)))
    if not out or out[0] < 1:
        raise ValueError(f"{what} must be positive, got {buckets!r}")
    return out


class InferenceEngine:
    """Bucketed two-tower encoder: ``encode_image`` / ``encode_text``.

    ``encode_image_fn(params, images)`` / ``encode_text_fn(params, tokens)``
    take a parameter dict and a device tensor and return L2-normalized
    embedding rows; :meth:`from_model` builds them over a ``models.SigLIP``.
    """

    def __init__(
        self,
        encode_image_fn: Callable,
        encode_text_fn: Callable,
        params: dict[str, Any],
        *,
        batch_buckets: Sequence[int] = (1, 8, 32, 128),
        text_len_buckets: Sequence[int] = (64,),
        image_shape: tuple[int, int, int] = (224, 224, 3),
        token_dtype=np.int32,
        device=None,
    ):
        self.batch_buckets = _validated_buckets(batch_buckets, "batch_buckets")
        self.text_len_buckets = _validated_buckets(text_len_buckets, "text_len_buckets")
        self.image_shape = tuple(image_shape)
        self.token_dtype = np.dtype(token_dtype)
        self.device = resolve_device(device)
        self.params = params
        self._fns = {"image": encode_image_fn, "text": encode_text_fn}
        self._compiled: set[tuple] = set()
        self.calls: Counter[str] = Counter()  # tower calls by kind
        self._lock = named_lock("serve.engine.InferenceEngine._lock")  # guards _compiled and calls
        self._call_lock = named_lock("serve.engine.InferenceEngine._call_lock")  # one tower call at a time

    @classmethod
    def from_model(cls, model, params=None, **kw):
        """Engine over a live ``models.SigLIP`` on its own device. Buckets
        default from its config (text len bucket = context_length)."""
        cfg = model.cfg
        kw.setdefault("text_len_buckets", (cfg.text.context_length,))
        kw.setdefault("image_shape", (cfg.vision.image_size, cfg.vision.image_size, 3))
        kw.setdefault("device", next(model.parameters()).device)
        if params is None:
            params = dict(model.state_dict())

        def img_fn(p, images):
            return torch.func.functional_call(model, p, (), {"images": images})[0]

        def txt_fn(p, tokens):
            return torch.func.functional_call(model, p, (), {"token_ids": tokens})[1]

        return cls(img_fn, txt_fn, params, **kw)

    # -- live refresh --------------------------------------------------------

    def swap_params(self, new_params: dict[str, Any]) -> None:
        """Replace the parameter dict. The same names with the same shapes
        and dtypes are required: a changed structure is a new engine, not a
        swap, and is refused. Tensors move to the serving params' devices,
        and where that copies onto a CUDA device the swapping thread's
        stream is synchronized before the new dict is published, so no call
        can read a tensor whose copy has not landed. Publication is one
        attribute assignment; a call already in flight finishes on the
        params it read at its start (and holds them until it returns)."""
        old = self.params
        if set(new_params) != set(old):
            raise ValueError(
                "swap_params: new param names differ from the serving dict — a "
                "structural change is a new engine, not a hot swap"
            )
        for name, o in old.items():
            n = new_params[name]
            if (tuple(n.shape), n.dtype) != (tuple(o.shape), o.dtype):
                raise ValueError(
                    f"swap_params: {name} spec {(tuple(n.shape), n.dtype)} != serving "
                    f"spec {(tuple(o.shape), o.dtype)}"
                )
        moved = {name: new_params[name].to(o.device) for name, o in old.items()}
        copied = {t.device for name, t in moved.items()
                  if t.is_cuda and t is not new_params[name]}
        for device in copied:
            torch.cuda.current_stream(device).synchronize()
        self.params = moved

    # -- introspection -------------------------------------------------------

    @property
    def compile_count(self) -> int:
        """Distinct (kind, padded shape) programs run so far. Steady state:
        the warmed bucket count, never the request count."""
        with self._lock:
            return len(self._compiled)

    @property
    def bucket_space(self) -> int:
        """Total grid points: image batch buckets + text (batch × len) buckets."""
        return len(self.batch_buckets) * (1 + len(self.text_len_buckets))

    # -- encode paths --------------------------------------------------------

    def _bucket_for(self, n: int, buckets: tuple[int, ...], what: str) -> int:
        for b in buckets:
            if n <= b:
                return b
        raise ValueError(
            f"{what} {n} exceeds the largest bucket {buckets[-1]}; "
            "split the request or extend the bucket grid"
        )

    def _run(self, kind: str, padded: np.ndarray) -> np.ndarray:
        # Chaos points (serve/siege.py): a slow or faulting device step. Dead
        # unless DSL_CHAOS=1 AND a fault is armed; a raise here fans out
        # typed through the batcher's futures, never a hang.
        maybe_inject("engine.latency")
        maybe_inject("engine.exception")
        with self._lock:
            self._compiled.add((kind, padded.shape))
            self.calls[kind] += 1
        with self._call_lock, torch.inference_mode():
            params = self.params
            x = torch.from_numpy(padded).to(self.device)
            return self._fns[kind](params, x).float().cpu().numpy()

    def encode_text(self, tokens) -> np.ndarray:
        """(n, s) or (s,) int token ids → (n, embed_dim) float32 rows.

        Pads n up to a batch bucket and s up to a len bucket (id 0), then
        slices the real rows back out.
        """
        arr = np.asarray(tokens, dtype=self.token_dtype)
        if arr.ndim == 1:
            arr = arr[None, :]
        n, s = arr.shape
        nb = self._bucket_for(n, self.batch_buckets, "batch size")
        sb = self._bucket_for(s, self.text_len_buckets, "text length")
        padded = np.zeros((nb, sb), dtype=self.token_dtype)
        padded[:n, :s] = arr
        return self._run("text", padded)[:n]

    def encode_image(self, images) -> np.ndarray:
        """(n, h, w, 3) or (h, w, 3) float pixels → (n, embed_dim) rows."""
        arr = np.asarray(images, dtype=np.float32)
        if arr.ndim == 3:
            arr = arr[None]
        if arr.shape[1:] != self.image_shape:
            raise ValueError(
                f"image shape {arr.shape[1:]} != engine's {self.image_shape}; "
                "resize upstream (the towers are shape-fixed)"
            )
        n = arr.shape[0]
        nb = self._bucket_for(n, self.batch_buckets, "batch size")
        padded = np.zeros((nb, *self.image_shape), dtype=np.float32)
        padded[:n] = arr
        return self._run("image", padded)[:n]

    def warmup(self) -> int:
        """Run every bucket combination once (zeros input) so the first real
        request meets no first-call cost (kernel build, allocator growth).
        Returns the compile count — after this, equal to :attr:`bucket_space`."""
        for nb in self.batch_buckets:
            self.encode_image(np.zeros((nb, *self.image_shape), np.float32))
            for sb in self.text_len_buckets:
                self.encode_text(np.zeros((nb, sb), self.token_dtype))
        return self.compile_count
