"""Carry the JAX package's SigLIP parameters into the port's state dict.

The only path from one package's weights to the other's. Input is the JAX
``params`` tree, unboxed, as nested dicts of numpy arrays; both depth layouts
are read:

- ``scan_layers=True``: ``encoder/blocks/block/...`` with a leading depth
  axis (e.g. ``visual/encoder/blocks/block/attn/q/kernel`` is (12, 768, 768)
  at B/16);
- ``scan_layers=False``: ``encoder/block{i}/...``.

Renames: a Dense ``kernel`` (in, out) becomes ``weight`` (out, in); a
LayerNorm ``scale`` becomes ``weight``; the token table ``embedding`` becomes
the ``token_embed`` parameter itself. The patch kernel keeps its HWIO shape.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

from distributed_sigmoid_loss_tpu_torch.utils.config import SigLIPConfig

__all__ = ["params_from_jax"]

_BLOCK = re.compile(r"block(\d+)")


def _flatten(node, path=()):
    if isinstance(node, Mapping):
        for key, child in node.items():
            yield from _flatten(child, path + (str(key),))
    else:
        yield path, np.asarray(node)


def _port_name(path: tuple[str, ...], arr: np.ndarray) -> tuple[str, np.ndarray]:
    *mods, leaf = path
    if leaf == "kernel" and arr.ndim == 2:
        leaf, arr = "weight", arr.T
    elif leaf == "scale":
        leaf = "weight"
    elif leaf == "embedding":
        return ".".join(mods), arr
    return ".".join((*mods, leaf)), arr


def params_from_jax(params, cfg: SigLIPConfig) -> dict[str, torch.Tensor]:
    """JAX ``SigLIP`` params → the port's ``SigLIP(cfg)`` state dict (f32 CPU
    tensors). Raises if a name or shape does not match the port's model."""
    out: dict[str, torch.Tensor] = {}

    def put(path, arr):
        name, arr = _port_name(path, arr)
        if name in out:
            raise ValueError(f"params_from_jax: {name} given twice")
        out[name] = torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))

    for path, arr in _flatten(params):
        if "blocks" in path and path[path.index("blocks") + 1] == "block":
            i = path.index("blocks")
            for depth in range(arr.shape[0]):
                put(path[:i] + ("blocks", str(depth)) + path[i + 2:], arr[depth])
            continue
        renamed = []
        for part in path:
            m = _BLOCK.fullmatch(part)
            renamed += ["blocks", m.group(1)] if m else [part]
        put(tuple(renamed), arr)

    from distributed_sigmoid_loss_tpu_torch.models.siglip import SigLIP

    expected = {k: tuple(v.shape) for k, v in SigLIP(cfg, device="meta").state_dict().items()}
    got = {k: tuple(v.shape) for k, v in out.items()}
    if got != expected:
        missing = sorted(set(expected) - set(got))
        extra = sorted(set(got) - set(expected))
        shapes = sorted(k for k in set(got) & set(expected) if got[k] != expected[k])
        raise ValueError(
            f"params_from_jax: tree does not match SigLIP(cfg): missing {missing[:5]}, "
            f"unexpected {extra[:5]}, shape mismatches "
            f"{[(k, got[k], expected[k]) for k in shapes[:5]]}"
        )
    return out
