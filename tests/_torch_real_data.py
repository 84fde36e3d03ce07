"""Shared helpers of the port's real-data tests
(``tests/test_torch_data_files.py``, ``tests/test_torch_native_data.py``):
image encoders, and the real-data convergence oracle of
``tests/test_convergence_real_data.py`` run through the port's ``train``
command in process."""

import contextlib
import io
import json
import os
import struct
import sys

import numpy as np
from PIL import Image

from distributed_sigmoid_loss_tpu_torch import cli

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from conftest import write_tar_shard  # noqa: E402


def bmp(arr: np.ndarray, bits: int = 24, top_down: bool = False) -> bytes:
    """An uncompressed BMP (BI_RGB) of (h, w, 3) uint8, written here; a
    32-bit pixel's fourth byte is noise, which readers drop."""
    h, w, _ = arr.shape
    bpp = bits // 8
    stride = (bits * w + 31) // 32 * 4
    px = np.zeros((h, stride), np.uint8)
    body = np.empty((h, w, bpp), np.uint8)
    body[..., :3] = arr[..., ::-1]
    if bpp == 4:
        body[..., 3] = np.random.default_rng(h * w).integers(0, 256, (h, w))
    px[:, :w * bpp] = body.reshape(h, w * bpp)
    if not top_down:
        px = px[::-1]
    data = px.tobytes()
    header = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1, bits, 0, len(data),
                         2835, 2835, 0, 0)
    return struct.pack("<2sIHHI", b"BM", 14 + 40 + len(data), 0, 0, 54) + header + data


def pil_bytes(arr: np.ndarray, fmt: str, mode: str = "RGB") -> bytes:
    im = Image.fromarray(arr)
    if mode != "RGB":
        im = im.convert(mode)
    buf = io.BytesIO()
    im.save(buf, fmt, **({"quality": 90} if fmt == "JPEG" else {}))
    return buf.getvalue()


def noise(h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


NAMES = ["red", "green", "blue", "cyan", "magenta", "yellow", "white", "gray",
         "crimson", "lime", "navy", "teal", "purple", "olive", "silver", "black"]
COLORS = [(220, 30, 30), (30, 200, 30), (30, 30, 220), (30, 200, 200),
          (200, 30, 200), (220, 220, 30), (240, 240, 240), (128, 128, 128),
          (150, 20, 60), (120, 255, 60), (20, 20, 120), (20, 120, 120),
          (120, 20, 160), (120, 120, 30), (190, 190, 190), (15, 15, 15)]


def write_oracle_dataset(root, fmt):
    """``tests/test_convergence_real_data.py``'s dataset: 96 noisy training
    pairs over 16 colour classes in two shards, a clean 16-pair holdout."""
    rng = np.random.default_rng(7)
    items, idx = [], 0
    for _ in range(6):
        for name, color in zip(NAMES, COLORS):
            arr = np.clip(np.asarray(color)[None, None, :] + rng.integers(-12, 13, (16, 16, 3)),
                          0, 255).astype(np.uint8)
            items.append((f"t{idx:04d}", arr, f"a {name} square"))
            idx += 1
    quality = 95 if fmt == "JPEG" else None
    write_tar_shard(os.path.join(root, "train0.tar"), items[:48], fmt=fmt, quality=quality)
    write_tar_shard(os.path.join(root, "train1.tar"), items[48:], fmt=fmt, quality=quality)
    write_tar_shard(os.path.join(root, "eval.tar"),
                    [(f"e{i:02d}", np.full((16, 16, 3), c, np.uint8), f"a {n} square")
                     for i, (n, c) in enumerate(zip(NAMES, COLORS))], fmt=fmt, quality=quality)


def train_oracle(root, *extra):
    """The oracle's run through ``cli.main`` in process: (exit code, the
    last eval line, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    argv = ["train", "--cpu-devices", "1", "--tiny", "--steps", "80", "--batch", "16",
            "--data-shards", os.path.join(root, "train*.tar"), "--shuffle-buffer", "64",
            "--eval-every", "40", "--eval-data", os.path.join(root, "eval.tar"),
            "--lr", "3e-3", "--log-every", "40", *extra]
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    evals = [json.loads(x) for x in out.getvalue().splitlines()
             if x.startswith("{") and "eval/i2t_recall@1" in x]
    return rc, evals[-1] if evals else None, err.getvalue()
