"""Ahead-of-time export of a step: save the traced program, not the Python.

The port of the JAX package's ``train/export.py`` (``jax.export``), on
``torch.export``:

- :func:`export_step` traces a function at example arguments (non-strict,
  to ATen ops) and returns an :class:`ExportedStep`;
- :func:`save_exported` / :func:`load_exported` write and read the artifact,
  a ``torch.export`` archive (``.pt2``);
- :func:`load_forward` wraps a ``--what forward`` artifact as
  ``fn(params, images, tokens) -> (zimg, ztxt)`` for the serving engine.

**The hand-written kernels are in the artifact.** Every kernel launch of the
port is a custom op with a fake version (``ops/short_attention.py``,
``ops/flash_attention.py``, ``ops/streaming_sigmoid_loss.py``,
``ops/quant.py``), so the trace records the op, and the replay calls it: on
CUDA tensors it launches the kernel (and counts the launch, as eager calls
do), on CPU tensors it runs the plain version. A kernel the trace cannot
record is an error, never a quiet switch to the plain version. Loading needs
those ops registered: :func:`load_exported` imports
``distributed_sigmoid_loss_tpu_torch.ops`` (the ops alone, no model code).

**Calling convention is flat**, as JAX's: the artifact takes the leaves of
its arguments positionally and returns the leaves of its result as a tuple.
The leaf order is the JAX package's tree order: ``torch.utils._pytree``'s
over the arguments with every dict's keys sorted (:func:`tree_leaves`), so a
params dict flattens in sorted-name order whatever order it was built in.
In the exporting process :meth:`ExportedStep.call` keeps the structured
signature; a consumer of the file calls ``load_exported(path).call(
*tree_leaves(args))`` and interprets the output positions itself.

**What differs from JAX.** ``torch.export`` traces for the device its
example tensors lie on: an artifact for the card is traced on the card, and
``platforms`` only checks that. A train step is exported through
:func:`train.train_step.make_functional_train_step`, which returns the new
state as leaves where the eager step updates its tensors in place, and whose
towers run without ``torch.utils.checkpoint`` under the trace (ROADMAP.md
queue C). A step over more than one process cannot be held in one artifact
and is refused there.
"""

from __future__ import annotations

import dataclasses
import io
from typing import Any, Callable, Sequence

import torch
from torch.utils import _pytree as pytree

__all__ = [
    "ExportedStep",
    "FlatProgram",
    "export_step",
    "load_exported",
    "load_forward",
    "save_exported",
    "tree_leaves",
]


def _canonical(tree):
    """``tree`` with every dict rebuilt in sorted key order (JAX's order)."""
    if isinstance(tree, dict):
        return {k: _canonical(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_canonical(x) for x in tree)
    return tree


def _flatten(tree):
    return pytree.tree_flatten(_canonical(tree))


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in the artifacts' order: ``torch.utils._pytree``
    order with dict keys sorted."""
    return _flatten(tree)[0]


class _Flat(torch.nn.Module):
    """``fn`` with the flat calling convention, as the module that
    ``torch.export`` traces; records the result's tree spec."""

    def __init__(self, fn: Callable, in_spec):
        super().__init__()
        self.fn, self.in_spec, self.out_spec = fn, in_spec, None

    def forward(self, *leaves):
        out_leaves, self.out_spec = _flatten(self.fn(*pytree.tree_unflatten(list(leaves),
                                                                           self.in_spec)))
        return tuple(out_leaves)


class FlatProgram:
    """A loaded artifact: ``program`` is the ``torch.export.ExportedProgram``;
    :meth:`call` takes the argument leaves and returns the result leaves.
    ``call`` is traceable, so a loaded program can be embedded in a larger
    exported function."""

    def __init__(self, program: torch.export.ExportedProgram):
        self.program = program
        self._module = program.module()

    def call(self, *leaves) -> tuple:
        return tuple(self._module(*leaves))

    def serialize(self) -> bytes:
        return _serialize(self.program)


@dataclasses.dataclass(frozen=True)
class ExportedStep:
    """A traced step plus the tree structure of its boundary.

    ``program`` (a :class:`FlatProgram`) is the serializable part, with the
    flat calling convention; ``in_tree`` / ``out_tree`` recover the
    structured signature in the exporting process through :meth:`call`.
    Only ``program`` survives :func:`save_exported`.
    """

    program: FlatProgram
    in_tree: Any
    out_tree: Any

    @property
    def exported(self) -> torch.export.ExportedProgram:
        return self.program.program

    def call(self, *args):
        """Structured call: the same signature as the traced function."""
        leaves, spec = _flatten(tuple(args))
        if spec != self.in_tree:
            raise ValueError(f"arguments' structure {spec} != the exported step's {self.in_tree}")
        return pytree.tree_unflatten(list(self.program.call(*leaves)), self.out_tree)

    def serialize(self) -> bytes:
        return self.program.serialize()


def _serialize(program: torch.export.ExportedProgram) -> bytes:
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def export_step(fn: Callable, example_args: Sequence[Any], *,
                platforms: Sequence[str] | None = None) -> ExportedStep:
    """Trace ``fn`` at ``example_args`` and return the serializable artifact.

    The trace is non-strict and at the ATen level, below autograd
    (``torch.export._trace._export`` with ``pre_dispatch=False``, the trace
    ``torch.export.export`` ran before its training IR): a train step's
    ``torch.autograd.grad`` becomes the backward's ATen ops and the kernels'
    custom ops. ``torch.export.export`` traces above autograd and cannot
    hold a backward (its trace of ``rsqrt``'s or LayerNorm's gradient leaves
    a fake tensor among the program's constants); ``make_fx`` then
    ``torch.export.export`` of its graph can, at three times the time. The
    trace runs with gradients off: a function that differentiates enables
    them itself, as :func:`train.train_step.make_functional_train_step`
    does.

    ``fn``'s arguments and result may be any trees of dicts, lists and tuples
    whose leaves are tensors; the artifact's boundary is their leaves (see
    the module docstring for the order). Only the example tensors' shapes,
    dtypes and devices matter, not their values. ``platforms`` names the
    device types the artifact is for (``"cuda"``, ``"cpu"``): every example
    tensor must lie on one of them, since the trace is for the devices its
    inputs are on. Raises whatever the trace raises: a kernel it cannot
    record is an error.
    """
    leaves, in_spec = _flatten(tuple(example_args))
    if platforms:
        wrong = sorted({t.device.type for t in leaves if torch.is_tensor(t)} - set(platforms))
        if wrong:
            raise ValueError(
                f"example tensors lie on {wrong}, not on the platforms {list(platforms)}: "
                "torch.export traces for the devices its inputs are on"
            )
    from torch.export._trace import _export

    flat = _Flat(fn, in_spec)
    program = _export(flat, tuple(leaves), strict=False, pre_dispatch=False)
    # The example tensors would be saved with the program: a B/16 artifact
    # carried its weights (0.8 GB) and a train step its whole state (2.4 GB).
    program.example_inputs = None
    return ExportedStep(FlatProgram(program), in_spec, flat.out_spec)


def save_exported(path, exported: ExportedStep | FlatProgram | torch.export.ExportedProgram
                  ) -> None:
    """Write the artifact (a ``torch.export`` archive) to ``path``."""
    if isinstance(exported, ExportedStep):
        exported = exported.program
    if isinstance(exported, FlatProgram):
        exported = exported.program
    torch.export.save(exported, path)


def load_exported(path) -> FlatProgram:
    """Read an artifact written by :func:`save_exported` as a
    :class:`FlatProgram` (flat calling convention: ``.call(*leaves)``).

    Registers the port's kernel ops first (``import
    distributed_sigmoid_loss_tpu_torch.ops``); no model code is needed. Call
    it with tensors on the devices it was traced on and of the example
    shapes and dtypes.
    """
    import distributed_sigmoid_loss_tpu_torch.ops  # noqa: F401  (the custom ops)

    return FlatProgram(torch.export.load(path))


def load_forward(path) -> Callable:
    """Load a ``--what forward`` artifact as ``fn(params, images, tokens) ->
    (zimg, ztxt)``: ``params`` is the state dict (any key order: it is
    flattened in sorted-name order, as the export did), ``images`` and
    ``tokens`` device tensors of the exported batch. The artifact was traced
    at one batch shape, so an engine over it serves exactly that bucket.
    Raises ``ValueError`` on an artifact that does not return two leaves."""
    loaded = load_exported(path)

    def fn(params, images, tokens):
        out = loaded.call(*tree_leaves((params, images, tokens)))
        if len(out) != 2:
            raise ValueError(
                f"artifact at {path!r} returned {len(out)} leaves, expected "
                "(zimg, ztxt) — was it exported with `--what forward`?"
            )
        return tuple(out)

    return fn
