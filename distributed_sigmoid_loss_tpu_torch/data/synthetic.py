"""Synthetic image-text stream, ported from the JAX package's
``data/synthetic.py``.

The reference has no data layer: its tests make the full global batch on
every rank under fixed seeds and slice per rank
(test_distributed_sigmoid_loss.py:57-68). This module keeps that recipe
(deterministic, full batch, then each rank's slice) with (image, token)
pairs shaped for the real towers: the same numpy streams from the same
seeds as JAX, yielded as CPU tensors.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from distributed_sigmoid_loss_tpu_torch.parallel.mesh import batch_index, batch_size
from distributed_sigmoid_loss_tpu_torch.utils.config import SigLIPConfig

__all__ = ["SyntheticImageText", "shard_batch"]


def shard_batch(batch: dict, rank: int | None = None, world: int | None = None) -> dict:
    """This rank's rows of a global batch: rows ``[r·B/W, (r+1)·B/W)`` of
    every entry (default: this rank's part over the ambient grid's batch
    axes, ``parallel.mesh.batch_index`` / ``batch_size``; the world's rank
    and size without a grid; one process without ``torch.distributed``).
    JAX places the whole batch on its mesh instead; a process here holds
    only its own rows."""
    rank = batch_index() if rank is None else rank
    world = batch_size() if world is None else world
    out = {}
    for k, v in batch.items():
        if v.shape[0] % world:
            raise ValueError(f"batch {v.shape[0]} must divide by the world size {world}")
        n = v.shape[0] // world
        out[k] = v[rank * n:(rank + 1) * n]
    return out


class SyntheticImageText:
    """Deterministic synthetic (image, tokens) stream for benchmarks and
    tests: one numpy generator for images and one for texts, seeded like the
    reference partition recipe (42 / 40), advancing per batch. Images are
    f32 (B, H, W, 3), tokens int32 (B, L), on the CPU."""

    def __init__(self, cfg: SigLIPConfig, global_batch: int, image_seed: int = 42,
                 text_seed: int = 40):
        self.cfg = cfg
        self.global_batch = global_batch
        self.image_rng = np.random.default_rng(image_seed)
        self.text_rng = np.random.default_rng(text_seed)

    def __iter__(self) -> Iterator[dict]:
        v, t = self.cfg.vision, self.cfg.text
        while True:
            images = self.image_rng.standard_normal(
                (self.global_batch, v.image_size, v.image_size, 3)).astype(np.float32)
            tokens = self.text_rng.integers(
                0, t.vocab_size, (self.global_batch, t.context_length)).astype(np.int32)
            yield {"images": torch.from_numpy(images), "tokens": torch.from_numpy(tokens)}
