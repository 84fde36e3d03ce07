"""Real image-text datasets, the port's copy of the JAX package's
``data/files.py``: folders of pairs and webdataset-style tar shards.

- :class:`ImageTextFolder`: a directory of ``name.{jpg,png,bmp,...}`` +
  ``name.txt`` caption pairs.
- :class:`ImageTextShards`: ``.tar`` shards whose members are those same
  pairs grouped by basename, read sequentially one shard at a time.

Both yield training-ready numpy batches: images decoded, resized to the
tower's ``image_size`` by the shorter-side resize + center crop, scaled to
[-1, 1]; captions tokenized by any ``(texts, length) -> ids`` callable. The
command line moves them to the device with ``data.loader.prefetch``.

The decode needs no PIL where it can do without: :func:`decode_and_resize`
decodes uncompressed BMP (24- and 32-bit, either row order) itself and
resizes every image with :func:`resize_bilinear`, which gives the same
integers as ``PIL.Image.resize(..., Image.BILINEAR)`` for 8-bit images. PNG,
JPEG and WebP go through PIL for the decode only; without PIL they raise an
``ImportError`` that names the PIL-free routes (JPEG through
``--native-decode``'s libjpeg engine, and BMP).
"""

from __future__ import annotations

import io
import math
import os
import struct
import tarfile
from typing import Callable, Iterator, Sequence

import numpy as np

__all__ = ["ImageTextFolder", "ImageTextShards", "decode_and_resize", "resize_bilinear"]

_IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")

# PIL's fixed point for 8-bit resampling (Resample.c PRECISION_BITS).
_PRECISION_BITS = 32 - 8 - 2


def _bilinear_coeffs(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray]:
    """PIL's ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for the
    triangle filter over the whole input: per output pixel, the input
    indices of its band and their fixed-point weights, ``(out, widest
    band)`` each (weights past a pixel's band are 0). The double arithmetic
    is PIL's, op for op, so the integers are PIL's."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale  # the triangle filter's support is 1
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    # C's (int) truncates; below 0 it is clamped to 0 either way.
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - xmin
    x = np.arange(ksize)
    t = np.abs(((x[None, :] + xmin[:, None]).astype(np.float64) - center[:, None] + 0.5)
               * (1.0 / filterscale))
    w = np.where((t < 1.0) & (x[None, :] < xmax[:, None]), 1.0 - t, 0.0)
    total = np.zeros(out_size)
    for j in range(ksize):  # PIL's sequential sum (numpy's would pair terms)
        total = total + w[:, j]
    w = np.where(total[:, None] != 0.0, w / np.where(total == 0.0, 1.0, total)[:, None], w)
    fixed = np.floor(0.5 + w * (1 << _PRECISION_BITS)).astype(np.int32)
    # Only the widest band's columns; clamped indices keep every gather
    # inside the image (their weights are 0).
    width = int(xmax.max())
    return np.minimum(xmin[:, None] + x[None, :width], in_size - 1), fixed[:, :width]


def _resample(img: np.ndarray, index: np.ndarray, weights: np.ndarray, axis: int) -> np.ndarray:
    """One 8-bit pass along ``axis`` (0 rows, 1 columns) of ``img`` (h, w, c)
    uint8: ``clip8((1 << 21) + sum(pixel * weight))``, PIL's rounding."""
    acc = np.full((index.shape[0], img.shape[1], img.shape[2]) if axis == 0 else
                  (img.shape[0], index.shape[0], img.shape[2]),
                  1 << (_PRECISION_BITS - 1), np.int32)
    # int32 as in PIL: 255 times weights that sum to ~2**22 stays below 2**31.
    for j in range(index.shape[1]):
        if axis == 0:
            acc += img[index[:, j]] * weights[:, j, None, None]
        else:
            acc += img[:, index[:, j]] * weights[None, :, j, None]
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def _resize_window(img: np.ndarray, size: tuple[int, int], box: tuple[int, int, int, int]):
    """Pixels ``box = (left, top, right, bottom)`` of ``img`` resized to
    ``size = (width, height)``. Each output pixel depends only on its own
    band, so computing the window alone gives the whole resize's values
    there. A pass whose size does not change is skipped, as PIL skips it."""
    h, w = img.shape[:2]
    nw, nh = size
    left, top, right, bottom = box
    if nh != h:
        row_index, row_weights = _bilinear_coeffs(h, nh)
        row_index, row_weights = row_index[top:bottom], row_weights[top:bottom]
        first = row_index.min()
        img, row_index = img[first:row_index.max() + 1], row_index - first
    else:
        img = img[top:bottom]
    # The horizontal pass first, on the rows the vertical pass reads, as PIL.
    if nw != w:
        index, weights = _bilinear_coeffs(w, nw)
        img = _resample(img, index[left:right], weights[left:right], 1)
    else:
        img = img[:, left:right]
    if nh != h:
        img = _resample(img, row_index, row_weights, 0)
    return img


def resize_bilinear(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """``(h, w, c)`` uint8 → ``(height, width, c)`` uint8 for ``size =
    (width, height)``: the same integers as ``PIL.Image.resize(size,
    Image.BILINEAR)`` on an 8-bit image (the triangle filter widened by the
    downscale factor, 22-bit fixed-point weights, the horizontal pass then
    the vertical, each rounded and clamped to uint8). Separable banded
    gathers, no dense matrix."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3:
        raise ValueError(f"resize_bilinear takes (h, w, c) uint8, got shape {img.shape}")
    return _resize_window(img, size, (0, 0, *size))


def _decode_bmp(data: bytes) -> np.ndarray | None:
    """An uncompressed 24- or 32-bit BMP (BI_RGB, or BI_BITFIELDS with the
    standard masks; bottom-up or top-down rows) as (h, w, 3) uint8 RGB, what
    PIL's ``convert("RGB")`` gives (a 32-bit pixel's fourth byte is
    dropped). None for any other BMP variant."""
    if len(data) < 54:
        raise ValueError(f"BMP of {len(data)} bytes is truncated")
    (offset,) = struct.unpack_from("<I", data, 10)
    header, width, height, planes, bits, compression = struct.unpack_from("<IiiHHI", data, 14)
    if header < 40 or planes != 1 or bits not in (24, 32) or width <= 0 or height == 0:
        return None
    if compression == 3:  # BI_BITFIELDS: the R, G, B masks follow the 40-byte header
        if bits != 32 or struct.unpack_from("<III", data, 54) != (0xFF0000, 0xFF00, 0xFF):
            return None
    elif compression != 0:
        return None
    rows, bpp = abs(height), bits // 8
    stride = (bits * width + 31) // 32 * 4
    if offset + stride * rows > len(data):
        raise ValueError(f"BMP pixel data truncated: {len(data)} bytes, need "
                         f"{offset + stride * rows}")
    pixels = np.frombuffer(data, np.uint8, stride * rows, offset).reshape(rows, stride)
    rgb = pixels[:, :width * bpp].reshape(rows, width, bpp)[:, :, 2::-1]
    return np.ascontiguousarray(rgb[::-1] if height > 0 else rgb)


def _decode_rgb(data: bytes) -> np.ndarray:
    """Image bytes → (h, w, 3) uint8 RGB: BMP by :func:`_decode_bmp`, every
    other format through PIL's ``convert("RGB")``."""
    if data[:2] == b"BM":
        rgb = _decode_bmp(data)
        if rgb is not None:
            return rgb
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "decoding this image needs PIL, which is not installed: decode JPEG with "
            "--native-decode (the libjpeg engine), or store uncompressed BMP (24- or "
            "32-bit), which decodes without PIL") from e
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def decode_and_resize(data: bytes, image_size: int) -> np.ndarray:
    """bytes → (image_size, image_size, 3) float32 in [-1, 1].

    Shorter-side resize then center crop (the open_clip/SigLIP eval
    transform), bilinear, as the JAX package's: the same integers before the
    scaling (:func:`resize_bilinear` is PIL's BILINEAR). Grayscale, RGBA and
    palette inputs are converted to RGB."""
    rgb = _decode_rgb(data)
    h, w = rgb.shape[:2]
    scale = image_size / min(w, h)
    nw, nh = max(image_size, round(w * scale)), max(image_size, round(h * scale))
    left, top = (nw - image_size) // 2, (nh - image_size) // 2
    arr = _resize_window(rgb, (nw, nh), (left, top, left + image_size, top + image_size))
    return arr.astype(np.float32) / 127.5 - 1.0


def _pair_key(name: str) -> tuple[str, str] | None:
    base, ext = os.path.splitext(name)
    ext = ext.lower()
    if ext in _IMAGE_EXTS:
        return base, "image"
    if ext == ".txt":
        return base, "text"
    return None


class _PairBatcher:
    """Accumulate (image_bytes, caption) pairs into static-shape batches.

    Decode + tokenize happen at flush time (:meth:`assemble`), a full batch
    at once: with ``native_decode=True`` the libjpeg engine
    (``data/native_decode.py``) fans the batch over ``data_workers`` threads
    off the GIL; otherwise each image goes through :func:`decode_and_resize`.
    :meth:`stage` / :meth:`assemble` are split so the pipelined shard reader
    can run ``assemble`` on a worker thread while the tar stream stages the
    next batch's blobs.
    """

    def __init__(self, cfg, batch_size: int, tokenize: Callable, native_decode: bool = False,
                 keep_captions: bool = False, data_workers: int | None = None):
        self.cfg = cfg
        self.batch_size = batch_size
        self.tokenize = tokenize
        self.native_decode = native_decode
        self.data_workers = data_workers
        # keep_captions adds the raw caption strings to each batch (a host
        # list, not a tensor): eval uses them as zero-shot class names and
        # pops the key before placing the batch.
        self.keep_captions = keep_captions
        self._blobs: list[bytes] = []
        self._texts: list[str] = []

    def stage(self, image_bytes: bytes, caption: str) -> tuple[list, list] | None:
        """Buffer one pair; on a full batch, hand back (blobs, texts) for
        :meth:`assemble` and reset the buffers."""
        self._blobs.append(image_bytes)
        self._texts.append(caption)
        if len(self._blobs) < self.batch_size:
            return None
        blobs, texts = self._blobs, self._texts
        self._blobs, self._texts = [], []
        return blobs, texts

    def assemble(self, blobs: list, texts: list) -> dict:
        """(blobs, texts) → the training batch dict: decode + tokenize."""
        size = self.cfg.vision.image_size
        if self.native_decode:
            from distributed_sigmoid_loss_tpu_torch.data.native_decode import decode_batch

            images = decode_batch(blobs, size, threads=self.data_workers)
        else:
            images = np.stack([decode_and_resize(b, size) for b in blobs])
        tokens = np.asarray(self.tokenize(texts, self.cfg.text.context_length), np.int32)
        if tokens.min() < 0 or tokens.max() >= self.cfg.text.vocab_size:
            # An out-of-range id would index past the embedding table: fail
            # here. ByteTokenizer needs vocab_size >= 259; fold ids (tokens %
            # vocab_size) to use a smaller test vocab deliberately.
            raise ValueError(f"tokenizer produced ids in [{tokens.min()}, {tokens.max()}] "
                             f"outside vocab_size {self.cfg.text.vocab_size}")
        batch = {"images": images, "tokens": tokens}
        if self.keep_captions:
            batch["captions"] = list(texts)
        return batch

    def add(self, image_bytes: bytes, caption: str) -> dict | None:
        job = self.stage(image_bytes, caption)
        if job is None:
            return None
        return self.assemble(*job)


class ImageTextFolder:
    """Directory of ``name.jpg`` + ``name.txt`` pairs → global batches.

    Deterministic order (sorted basenames, shuffled per epoch by ``seed``
    when set, with the JAX package's generator, so the same pairs in the same
    order); incomplete pairs are skipped; the final partial batch is dropped
    (static shapes). Iterating cycles epochs forever.
    """

    def __init__(self, root: str, cfg, batch_size: int, tokenize: Callable,
                 seed: int | None = 0, native_decode: bool = False,
                 keep_captions: bool = False, data_workers: int | None = None):
        self.root = root
        self.keep_captions = keep_captions
        self.cfg = cfg
        self.batch_size = batch_size
        self.tokenize = tokenize
        self.seed = seed
        self.native_decode = native_decode
        self.data_workers = data_workers
        pairs: dict[str, dict] = {}
        for name in sorted(os.listdir(root)):
            key = _pair_key(name)
            if key is None:
                continue
            base, kind = key
            pairs.setdefault(base, {})[kind] = os.path.join(root, name)
        self.items: list[dict] = [p for _, p in sorted(pairs.items())
                                  if "image" in p and "text" in p]
        if len(self.items) < batch_size:
            raise ValueError(f"{root} holds {len(self.items)} complete pairs; "
                             f"need at least one batch of {batch_size}")

    def __len__(self) -> int:
        return len(self.items)

    def __iter__(self) -> Iterator[dict]:
        rng = np.random.default_rng(self.seed) if self.seed is not None else None
        while True:
            order = np.arange(len(self.items))
            if rng is not None:
                rng.shuffle(order)
            batcher = _PairBatcher(self.cfg, self.batch_size, self.tokenize, self.native_decode,
                                   keep_captions=self.keep_captions,
                                   data_workers=self.data_workers)
            for i in order:
                item = self.items[i]
                with open(item["image"], "rb") as f:
                    image_bytes = f.read()
                with open(item["text"], "r", encoding="utf-8") as f:
                    caption = f.read().strip()
                batch = batcher.add(image_bytes, caption)
                if batch is not None:
                    yield batch


class ImageTextShards:
    """Webdataset-style tar shards of ``name.jpg`` + ``name.txt`` members.

    ``shards`` is a list of tar paths; ``shard_index / num_shards`` stripes
    the sorted list (process i reads shards i, i+N, ...). Members pair by
    basename within a shard; pairs stream in tar order (shards shuffled per
    epoch by ``seed``) with an optional bounded ``shuffle_buffer`` (a
    reservoir of that many pairs; emit a random one as each new pair streams
    in). The generator and its draws are the JAX package's, so the stream is
    the same pairs in the same order.

    Overlap, both on by default (the emitted stream is identical either way):

    - ``read_ahead``: the next shard's members are fetched by a background
      reader while the current shard's pairs decode;
    - ``pipelined``: each full batch's decode + tokenize runs on a worker
      thread (one batch in flight) while the tar stream stages the next.
    """

    def __init__(self, shards: Sequence[str], cfg, batch_size: int, tokenize: Callable,
                 seed: int | None = 0, shard_index: int = 0, num_shards: int = 1,
                 native_decode: bool = False, shuffle_buffer: int = 0,
                 keep_captions: bool = False, data_workers: int | None = None,
                 read_ahead: bool = True, pipelined: bool = True):
        self.keep_captions = keep_captions
        if not shards:
            raise ValueError("no shards given")
        if not (0 <= shard_index < num_shards):
            raise ValueError(f"shard_index {shard_index} not in [0, {num_shards})")
        self.shards = sorted(shards)[shard_index::num_shards]
        if not self.shards:
            raise ValueError(f"host {shard_index}/{num_shards} received no shards "
                             f"({len(shards)} total) — use at least num_shards tar files")
        self.cfg = cfg
        self.batch_size = batch_size
        self.tokenize = tokenize
        self.seed = seed
        self.native_decode = native_decode
        self.data_workers = data_workers
        self.read_ahead = read_ahead
        self.pipelined = pipelined
        if shuffle_buffer < 0:
            raise ValueError(f"shuffle_buffer must be >= 0, got {shuffle_buffer}")
        if shuffle_buffer and seed is None:
            raise ValueError("shuffle_buffer requires a seed")
        self.shuffle_buffer = shuffle_buffer

    def _shard_pairs(self, path: str) -> Iterator[tuple[bytes, str]]:
        """(image_bytes, caption) pairs of one shard, tar order."""
        with tarfile.open(path, "r") as tf:
            pending: dict[str, dict] = {}
            for member in tf:
                if not member.isfile():
                    continue
                key = _pair_key(os.path.basename(member.name))
                if key is None:
                    continue
                base, kind = key
                buf = tf.extractfile(member)
                if buf is None:
                    continue
                entry = pending.setdefault(base, {})
                entry[kind] = buf.read()
                if "image" in entry and "text" in entry:
                    del pending[base]
                    yield entry["image"], entry["text"].decode("utf-8").strip()

    def _pairs(self, order) -> Iterator[tuple[bytes, str]]:
        """(image_bytes, caption) pairs across the epoch's shards, tar order;
        with ``read_ahead`` one background reader fetches shard k+1 while
        shard k's pairs are consumed."""
        if not self.read_ahead or len(order) <= 1:
            for si in order:
                yield from self._shard_pairs(self.shards[si])
            return
        from concurrent.futures import ThreadPoolExecutor

        def read(si) -> list[tuple[bytes, str]]:
            return list(self._shard_pairs(self.shards[si]))

        # One shard in flight; leaving the executor joins the reader, so an
        # abandoned epoch never leaks the thread.
        with ThreadPoolExecutor(1, thread_name_prefix="dsl-shard-read") as ex:
            fut = ex.submit(read, order[0])
            for k in range(len(order)):
                pairs = fut.result()
                if k + 1 < len(order):
                    fut = ex.submit(read, order[k + 1])
                yield from pairs

    def _shuffled(self, pairs, rng) -> Iterator[tuple[bytes, str]]:
        """Bounded reservoir shuffle: hold ``shuffle_buffer`` pairs, emit a
        uniformly random held one per incoming pair, drain at epoch end in
        random order."""
        held: list = []
        for pair in pairs:
            if len(held) < self.shuffle_buffer:
                held.append(pair)
                continue
            i = int(rng.integers(len(held)))
            held[i], pair = pair, held[i]
            yield pair
        while held:
            i = int(rng.integers(len(held)))
            held[i], last = held[-1], held[i]
            held.pop()
            yield last

    def _epoch_batches(self, pairs, batcher) -> Iterator[dict]:
        """Batches of one epoch: serial mode flushes inline; pipelined mode
        keeps one batch's decode + tokenize in flight on a worker thread."""
        if not self.pipelined:
            for image_bytes, caption in pairs:
                batch = batcher.add(image_bytes, caption)
                if batch is not None:
                    yield batch
            return
        from concurrent.futures import ThreadPoolExecutor

        pending = None
        # Leaving the executor joins the in-flight flush, so an abandoned
        # stream never leaks the assembly thread.
        with ThreadPoolExecutor(1, thread_name_prefix="dsl-batch") as ex:
            for image_bytes, caption in pairs:
                job = batcher.stage(image_bytes, caption)
                if job is None:
                    continue
                fut = ex.submit(batcher.assemble, *job)
                if pending is not None:
                    yield pending.result()
                pending = fut
            if pending is not None:
                yield pending.result()

    def __iter__(self) -> Iterator[dict]:
        rng = np.random.default_rng(self.seed) if self.seed is not None else None
        while True:
            yielded = False
            order = np.arange(len(self.shards))
            if rng is not None:
                rng.shuffle(order)
            batcher = _PairBatcher(self.cfg, self.batch_size, self.tokenize, self.native_decode,
                                   keep_captions=self.keep_captions,
                                   data_workers=self.data_workers)
            pairs = self._pairs(order)
            if self.shuffle_buffer:
                pairs = self._shuffled(pairs, rng)
            for batch in self._epoch_batches(pairs, batcher):
                yielded = True
                yield batch
            if not yielded:
                # Pair counts are known only after a full pass; spinning on
                # the tars forever would hang next().
                raise ValueError(f"shards {self.shards} hold fewer complete (image, txt) "
                                 f"pairs than one batch of {self.batch_size}")
