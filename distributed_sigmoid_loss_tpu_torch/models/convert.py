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
the ``token_embed`` parameter itself. The patch kernel keeps its HWIO shape,
and an MoE layer's ``moe/router`` (d, E), ``moe/wi`` (E, d, h) and
``moe/wo`` (E, h, d), plain parameters rather than Dense kernels, keep
theirs.

The same mapping, run the other way, is :func:`jax_leaves`: which of the
port's tensors make up each leaf of the JAX tree. Adafactor's factoring and
block-RMS clipping are per leaf, and under ``scan_layers=True`` one leaf
stacks every layer of a tower, so the port's Adafactor works on the leaves
that list describes. Trees shaped like ``params`` (the EMA, Lion's moment)
come over through :func:`params_from_jax`; Adafactor's statistics, held by
the port in the JAX leaf layout, through :func:`adafactor_stats_from_jax`.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Mapping

import numpy as np
import torch

from distributed_sigmoid_loss_tpu_torch.utils.config import SigLIPConfig

__all__ = ["params_from_jax", "param_list_from_jax", "JaxLeaf", "jax_leaves",
           "adafactor_stats_from_jax", "check_state_dict"]

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

    check_state_dict(out, cfg, "params_from_jax")
    return out


def check_state_dict(state: Mapping[str, torch.Tensor], cfg: SigLIPConfig, who: str) -> None:
    """Raise ``ValueError`` (prefixed ``who``) unless ``state`` has exactly
    the names and shapes of ``SigLIP(cfg)``'s state dict."""
    from distributed_sigmoid_loss_tpu_torch.models.siglip import SigLIP

    expected = {k: tuple(v.shape) for k, v in SigLIP(cfg, device="meta").state_dict().items()}
    got = {k: tuple(v.shape) for k, v in state.items()}
    if got != expected:
        missing = sorted(set(expected) - set(got))
        extra = sorted(set(got) - set(expected))
        shapes = sorted(k for k in set(got) & set(expected) if got[k] != expected[k])
        raise ValueError(
            f"{who}: tree does not match SigLIP(cfg): missing {missing[:5]}, "
            f"unexpected {extra[:5]}, shape mismatches "
            f"{[(k, got[k], expected[k]) for k in shapes[:5]]}"
        )


def param_list_from_jax(tree, model) -> list[torch.Tensor]:
    """A tree shaped like the JAX params (the EMA, Lion's moment)
    as f32 CPU tensors in ``model.parameters()`` order, through
    :func:`params_from_jax`."""
    state = params_from_jax(tree, model.cfg)
    return [state[name] for name, _ in model.named_parameters()]


@dataclasses.dataclass(frozen=True)
class JaxLeaf:
    """One leaf of the JAX params tree as port tensors: ``members`` index
    ``model.parameters()``; with ``stacked`` they are the leaf's layers, in
    depth order, along a new leading axis; with ``transposed`` each is the
    transpose of the JAX layout (a Dense ``weight`` of a ``kernel``)."""

    path: str
    members: tuple[int, ...]
    stacked: bool
    transposed: bool

    def gather(self, tensors) -> torch.Tensor:
        """The leaf in the JAX layout from the port's ``tensors`` (a list in
        ``model.parameters()`` order); a copy when stacked, else a view."""
        parts = [tensors[i].T if self.transposed else tensors[i] for i in self.members]
        return torch.stack(parts) if self.stacked else parts[0]

    def parts(self, leaf: torch.Tensor) -> list[torch.Tensor]:
        """``leaf`` (JAX layout) as the port's tensors of :attr:`members`
        (views)."""
        parts = [leaf[depth] for depth in range(len(self.members))] if self.stacked else [leaf]
        return [part.T if self.transposed else part for part in parts]

    def scatter_(self, tensors, leaf: torch.Tensor) -> None:
        """Copy ``leaf`` (JAX layout) back into the port's ``tensors``."""
        for i, part in zip(self.members, self.parts(leaf)):
            tensors[i].copy_(part)


def _jax_path(parts: list[str], ndim: int, scanned: bool) -> tuple[str, int | None]:
    """The JAX path of one port parameter and its depth in a stacked leaf."""
    *mods, leaf = parts
    if leaf == "weight":
        leaf = "kernel" if ndim == 2 else "scale"
    elif leaf == "token_embed":
        mods, leaf = parts, "embedding"
    depth = None
    if "blocks" in mods:
        j = mods.index("blocks")
        depth = int(mods[j + 1])
        mods = mods[:j] + (["blocks", "block"] if scanned else [f"block{depth}"]) + mods[j + 2:]
    return "/".join((*mods, leaf)), (depth if scanned else None)


def jax_leaves(model) -> list[JaxLeaf]:
    """The leaves of the JAX params tree of ``model`` (a port ``SigLIP``),
    in the order of their first member: a tower's blocks form one stacked
    leaf per parameter name when its config has ``scan_layers=True``, one
    leaf per layer otherwise."""
    scan = {"visual": model.cfg.vision.scan_layers, "textual": model.cfg.text.scan_layers}
    groups: dict[str, list[tuple[int | None, int, bool]]] = {}
    for i, (name, p) in enumerate(model.named_parameters()):
        parts = name.split(".")
        path, depth = _jax_path(parts, p.ndim, scan.get(parts[0], False))
        groups.setdefault(path, []).append((depth, i, parts[-1] == "weight" and p.ndim == 2))
    leaves = []
    for path, entries in groups.items():
        entries.sort(key=lambda e: -1 if e[0] is None else e[0])
        leaves.append(JaxLeaf(path=path, members=tuple(i for _, i, _ in entries),
                              stacked=entries[0][0] is not None, transposed=entries[0][2]))
    return leaves


def adafactor_stats_from_jax(factored_state, leaves) -> dict[str, list[torch.Tensor]]:
    """optax's ``FactoredState`` trees (``v_row``, ``v_col``, ``v``) as f32
    CPU tensors per leaf of ``leaves`` (:func:`jax_leaves`), in the JAX
    layout the port's Adafactor keeps them in."""
    out = {}
    for field in ("v_row", "v_col", "v"):
        flat = {"/".join(path): arr for path, arr in _flatten(getattr(factored_state, field))}
        out[field] = [torch.from_numpy(np.array(flat[leaf.path], dtype=np.float32, order="C"))
                      for leaf in leaves]
    return out
