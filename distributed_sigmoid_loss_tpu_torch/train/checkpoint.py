"""Checkpoints of the train state, ported from the JAX package's
``train/checkpoint.py`` (which writes with orbax; the port cannot: orbax
imports JAX).

A checkpoint is one directory:

- ``tensors.pt``: one ``torch.save`` of a flat ``{name: tensor}`` dict, read
  back with ``torch.load(weights_only=True)``. A train state's names are
  ``model.<state_dict key>``; the optimizer state's tensors by parameter
  name, ``opt.mu.<name>`` and ``opt.nu.<name>`` (AdamW; Lion has ``mu``
  only) or by leaf of the JAX tree, ``opt.v_row.<leaf>``, ``opt.v_col.<leaf>``
  and ``opt.v.<leaf>`` (Adafactor); and ``ema.<name>`` when the EMA is on.
  A dict of tensors (nested dicts allowed) is written under its own keys,
  joined with ``/``.
- ``meta.json``: the format, the step, the optimizer's kind and update
  count, and the dtypes of each group of tensors.

Writes are atomic: the directory is written under a temporary name that
``resilience.latest_step``'s ``^step_(\\d{8})$`` does not match, then moved
into place with ``os.replace``; a ``step_NNNNNNNN`` directory that exists is
complete. Two ways to save:

- :func:`save_checkpoint`: synchronous; the step loop stalls for the write.
- :class:`AsyncSaver`: the tensors are copied to host memory, then written
  by a thread while training goes on.

Derived state is never written: the error-feedback residual ``ef`` of the
compressed step and the adaptive compression's carry ``comp`` (JAX
``_strip_ef``) are one step's carry, and writing them would make compressed
runs' checkpoints unreadable by eval and by uncompressed resume. They stay
out of :func:`state_tensors`. A restore resets them (:func:`reset_derived`):
the port's step updates its state in place, so after a poisoned step they
hold that step's values, where JAX's restore keeps the pre-step ones.

Checkpoints are portable across update shardings: a state whose moments
are sharded over the data axis (``TrainState.layout``) writes them gathered
to their whole shape, and a restore takes the target's rows of each. With
more than one process every rank takes part in the gather and rank 0
writes. So are they across the parts a rank holds (``TrainState.part_axes``):
experts sharded over ep are written whole (a restore takes the target's
experts), and a pipeline stage's blocks are written with every other
stage's under their names in the whole model (a restore takes the target's
stage). A checkpoint written at ep = 2 or pp = 2 restores at 1.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
import threading
import time
from typing import Any, Mapping

import torch
import torch.distributed as dist

from distributed_sigmoid_loss_tpu_torch.parallel.mesh import (
    axis_group,
    axis_index,
    axis_size,
    is_distributed,
)
from distributed_sigmoid_loss_tpu_torch.train.train_step import (
    AdafactorState,
    AdamWState,
    LionState,
    TrainState,
)

__all__ = ["save_checkpoint", "restore_checkpoint", "AsyncSaver", "HostCopy", "state_tensors",
           "checkpoint_tensors", "reset_derived"]

FORMAT = "dsl-torch-ckpt-v1"
TENSORS_FILE = "tensors.pt"
META_FILE = "meta.json"
_OPTIMIZERS = {AdamWState: "adamw", LionState: "lion", AdafactorState: "adafactor"}


def _flatten_dict(tree: Mapping, prefix: str = "") -> dict[str, torch.Tensor]:
    out = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.update(_flatten_dict(value, name + "/"))
        elif isinstance(value, torch.Tensor):
            out[name] = value
        else:
            raise TypeError(f"{name}: a checkpoint holds tensors, got {type(value).__name__}")
    return out


def state_tensors(state: Any) -> dict[str, torch.Tensor]:
    """The tensors a checkpoint of ``state`` holds, by name (see the module
    docstring), sharing storage with ``state``: copying into them restores
    it. ``state`` is a ``TrainState`` or a (nested) dict of tensors."""
    if isinstance(state, Mapping):
        return _flatten_dict(state)
    if not isinstance(state, TrainState):
        raise TypeError(f"cannot checkpoint a {type(state).__name__}")
    names = [n for n, _ in state.model.named_parameters()]
    out = {f"model.{k}": v for k, v in state.model.state_dict(keep_vars=True).items()}
    opt = state.opt_state
    if isinstance(opt, (AdamWState, LionState)):
        out.update({f"opt.mu.{n}": t for n, t in zip(names, opt.mu)})
    if isinstance(opt, AdamWState):
        out.update({f"opt.nu.{n}": t for n, t in zip(names, opt.nu)})
    if isinstance(opt, AdafactorState):
        for field in ("v_row", "v_col", "v"):
            out.update({f"opt.{field}.{leaf.path}": t
                        for leaf, t in zip(opt.leaves, getattr(opt, field))})
    if state.ema is not None:
        out.update({f"ema.{n}": t for n, t in zip(names, state.ema)})
    return out


# The adaptive carry's step-written stats; its scheme table and codec are
# the host's decisions and stay.
_COMP_STATS = ("gnorm", "gvar", "ef_ratio", "blockmoment", "codec_recon_err")


@torch.no_grad()
def reset_derived(state: Any) -> Any:
    """Zero a ``TrainState``'s derived state in place: the residuals
    ``ef`` and the stats of the adaptive carry ``comp`` (JAX's zeroed trees
    after a restore). The carry's scheme table and codec weights stay, so
    the next step runs as staged."""
    if not isinstance(state, TrainState):
        return state
    for e in state.ef or ():
        e.zero_()
    for k in _COMP_STATS:
        if state.comp is not None and k in state.comp:
            state.comp[k].zero_()
    return state


def _sharded_moments(state: Any) -> dict[str, int]:
    """Names of a sharded state's moments held as this rank's rows, with
    their parameter's index in the layout."""
    layout = getattr(state, "layout", None)
    if not isinstance(state, TrainState) or layout is None:
        return {}
    names = [n for n, _ in state.model.named_parameters()]
    fields = [f for f in ("mu", "nu") if getattr(state.opt_state, f, None) is not None]
    return {f"opt.{f}.{n}": i for f in fields for i, n in enumerate(names)
            if layout.sharded[i]}


_PREFIXES = ("model.", "opt.mu.", "opt.nu.", "ema.")
_BLOCK = re.compile(r"^(.*\.encoder\.blocks\.)(\d+)(\..*)$")


def _parts(state: Any, axis: str) -> list[str]:
    """The names of ``state``'s tensors held in parts over ``axis``, in
    :func:`state_tensors` order."""
    part_axes = getattr(state, "part_axes", None)
    if not isinstance(state, TrainState) or part_axes is None:
        return []
    names = {f"{pre}{n}" for n, a in zip((n for n, _ in state.model.named_parameters()),
                                         part_axes) if a == axis for pre in _PREFIXES}
    return [k for k in state_tensors(state) if k in names]


def _stat_parts(state: Any) -> dict[str, tuple[str, int]]:
    """Adafactor's statistics of leaves held in parts: name → (axis, the
    dimension the parts join along: a stage's layers along the stack, a
    rank's experts along the expert axis, after the stack when stacked)."""
    part_axes = getattr(state, "part_axes", None)
    if not isinstance(state, TrainState) or part_axes is None or \
            not isinstance(state.opt_state, AdafactorState):
        return {}
    opt, out = state.opt_state, {}
    for i, leaf in enumerate(opt.leaves):
        axis = part_axes[leaf.members[0]]
        if axis is None:
            continue
        dim = 1 if axis == "ep" and leaf.stacked else 0
        for field in ("v_row", "v_col", "v"):
            if getattr(opt, field)[i].shape != (1,):  # (1,): the slot a leaf does not use
                out[f"opt.{field}.{leaf.path}"] = (axis, dim)
    return out


def _joins(state: Any) -> dict[str, tuple[str, int]]:
    """The tensors a checkpoint joins from their parts: name → (axis, the
    dimension the parts join along): the experts held over ep and their
    moments and EMA, and Adafactor's statistics of such leaves."""
    out = dict.fromkeys(_parts(state, "ep"), ("ep", 0))
    out.update(_stat_parts(state))
    return out


def _flat_gather(tensors: list[torch.Tensor], group) -> list[list[torch.Tensor]]:
    """Every rank's ``tensors`` (the same shapes and dtypes on each), by
    rank: one all-gather per dtype."""
    w = axis_size(group)
    out = [[None] * len(tensors) for _ in range(w)]
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx]).contiguous()
        ranks = [torch.empty_like(flat) for _ in range(w)]
        dist.all_gather(ranks, flat, group=group)
        for r in range(w):
            off = 0
            for i in idx:
                n = tensors[i].numel()
                out[r][i] = ranks[r][off:off + n].view(tensors[i].shape)
                off += n
    return out


def _stage_name(model, name: str, stage: int, to: int, stages: int) -> str:
    """``name`` of a block of stage ``stage`` as the same block of stage
    ``to``: moved on by ``to - stage`` times its own tower's layers a
    stage."""
    m = _BLOCK.match(name)
    tower = m.group(1).split(".")[-4]  # "visual" or "textual"
    per = getattr(model, tower).encoder.depth // stages
    return f"{m.group(1)}{int(m.group(2)) + (to - stage) * per}{m.group(3)}"


def _gather_parts(state: Any, tensors: dict) -> dict:
    """``tensors`` with the parts held over ep and pp made whole: the
    :func:`_joins` joined along their dimension, every stage's blocks
    added under their names."""
    joins = _joins(state)
    for axis in ("ep", "pp"):
        names = [k for k, (a, _) in joins.items() if a == axis]
        group = axis_group(axis) if names else None
        if names and axis_size(group) > 1:
            got = _flat_gather([tensors[k] for k in names], group)
            for i, k in enumerate(names):
                tensors[k] = torch.cat([got[r][i] for r in range(len(got))], dim=joins[k][1])
    pp = _parts(state, "pp")
    if pp:
        group = axis_group("pp")
        stages, stage = axis_size(group), axis_index(group)
        if stages > 1:
            got = _flat_gather([tensors[k] for k in pp], group)
            for s in range(stages):
                if s != stage:
                    for i, k in enumerate(pp):
                        tensors[_stage_name(state.model, k, stage, s, stages)] = got[s][i]
    return tensors


def checkpoint_tensors(state: Any) -> dict[str, torch.Tensor]:
    """:func:`state_tensors` with a sharded state's moments gathered to
    their whole shape, and the parts of parameters held over ep or pp
    joined (collectives over the data, ep and pp axes: every rank calls
    it)."""
    tensors = state_tensors(state)
    sharded = _sharded_moments(state)
    for field in ("mu", "nu"):
        keys = [n for n in sharded if n.startswith(f"opt.{field}.")]
        if not keys:
            continue
        parts = [torch.empty(0)] * len(state.layout.shapes)
        for n in keys:
            parts[sharded[n]] = tensors[n]
        gathered = state.layout.gather(parts)
        for n in keys:
            tensors[n] = gathered[sharded[n]]
    return _gather_parts(state, tensors)


def _writer() -> bool:
    return not is_distributed() or dist.get_rank() == 0


def checkpoint_meta(state: Any, tensors: Mapping[str, torch.Tensor]) -> dict:
    """``meta.json``'s content: the format, the step, the optimizer's kind
    and update count (a train state), and each group's dtypes."""
    groups: dict[str, set] = {}
    for name, t in tensors.items():
        group = ".".join(name.split(".")[:2]) if name.startswith("opt.") else name.split(".")[0]
        groups.setdefault(group, set()).add(str(t.dtype).removeprefix("torch."))
    meta = {"format": FORMAT, "dtypes": {g: sorted(d) for g, d in sorted(groups.items())}}
    if isinstance(state, TrainState):
        meta.update(step=state.step, optimizer=_OPTIMIZERS[type(state.opt_state)],
                    count=state.opt_state.count, ema=state.ema is not None)
    return meta


def _write(path: str, host: Mapping[str, torch.Tensor], meta: dict) -> None:
    """Write ``host`` (CPU tensors) and ``meta`` as the checkpoint ``path``,
    atomically, replacing a checkpoint already there."""
    parent, base = os.path.split(path)
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f".{base}.tmp-", dir=parent)
    try:
        torch.save(dict(host), os.path.join(tmp, TENSORS_FILE))
        with open(os.path.join(tmp, META_FILE), "w") as f:
            json.dump(meta, f)
        if os.path.exists(path):
            old = tmp + ".old"
            os.replace(path, old)
            os.replace(tmp, path)
            shutil.rmtree(old)
        else:
            os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def save_checkpoint(path: str, state: Any) -> None:
    """Save a train state (or a dict of tensors) to the directory ``path``,
    synchronously, replacing a checkpoint already there."""
    tensors = checkpoint_tensors(state)
    if _writer():
        host = {k: t.detach().to("cpu", copy=True) for k, t in tensors.items()}
        _write(os.path.abspath(path), host, checkpoint_meta(state, tensors))
    if is_distributed():
        dist.barrier()  # the checkpoint is complete on every rank's return


class HostCopy:
    """Host copies of a state's tensors, in buffers kept from one copy to
    the next: pinned where the tensor is on a GPU, so the copies run
    without blocking the caller (a fresh pinned allocation of B/16's train
    state costs seconds; a reused buffer nothing). ``take`` queues the
    copies on each device's current stream and returns the host tensors by
    name; ``wait`` blocks until they have landed. A ``take`` reuses the
    buffers of the one before, so the caller is done with those first."""

    def __init__(self):
        self._host: dict[str, torch.Tensor] = {}
        self._done: list[torch.cuda.Event] = []

    def take(self, tensors: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        host, devices = {}, set()
        for name, t in tensors.items():
            buf = self._host.get(name)
            if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
            buf.copy_(t.detach(), non_blocking=t.is_cuda)
            if t.is_cuda:
                devices.add(t.device)
            host[name] = buf
        self._host = host
        self._done = []
        for device in devices:
            with torch.cuda.device(device):
                done = torch.cuda.Event()
                done.record()
                self._done.append(done)
        return host

    def wait(self) -> None:
        for done in self._done:
            done.synchronize()
        self._done = []


class AsyncSaver:
    """Non-blocking checkpoint writes; use as a context manager.

    ``save`` copies the state's tensors into host buffers (a
    :class:`HostCopy`: pinned, reused from save to save), waits for those
    copies, starts the
    writer thread and returns: the write overlaps the following steps. A
    second ``save`` waits for the first's write. ``wait`` blocks until every
    write is durable and raises a writer's error; call it before reading
    ``latest_step`` on the same directory (``__exit__`` waits too). With
    several processes only rank 0 writes, every rank calls ``save`` and
    ``wait`` at the same points, and ``wait`` returns on each once rank 0's
    write is durable.
    ``timings`` lists each save's ``snapshot_s`` (the caller's stall),
    ``write_s`` (the thread's) and ``bytes``.
    """

    def __init__(self):
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._copy = HostCopy()
        self.timings: list[dict] = []

    def save(self, path: str, state: Any) -> None:
        self.wait()
        t0 = time.perf_counter()
        tensors = checkpoint_tensors(state)
        if not _writer():
            return
        host = self._copy.take(tensors)
        self._copy.wait()
        timing = {"path": os.path.abspath(path), "snapshot_s": time.perf_counter() - t0,
                  "bytes": sum(t.numel() * t.element_size() for t in host.values())}
        self.timings.append(timing)
        self._thread = threading.Thread(
            target=self._run, args=(timing, host, checkpoint_meta(state, tensors)),
            name="dsl-checkpoint-writer")
        self._thread.start()

    def _run(self, timing, host, meta) -> None:
        t0 = time.perf_counter()
        try:
            _write(timing["path"], host, meta)
        except BaseException as e:  # noqa: BLE001 — raised again by wait()
            self._error = e
        timing["write_s"] = time.perf_counter() - t0

    @property
    def pending(self) -> bool:
        """True while a write is in flight."""
        return self._thread is not None and self._thread.is_alive()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if is_distributed():
            dist.barrier()  # rank 0 writes: the others wait for its write too
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        """Wait for the pending write, then free the host buffers."""
        try:
            self.wait()
        finally:
            self._copy = HostCopy()

    def __enter__(self) -> "AsyncSaver":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def restore_checkpoint(path: str, target: Any) -> Any:
    """Restore the checkpoint ``path`` into ``target`` (a train state or a
    dict of tensors of the same structure), in place, and return it. Each
    tensor lands on the device of the target's, so a checkpoint written on
    ``cuda`` restores on the CPU. Raises ``ValueError`` naming every tensor
    that is missing, extra, or of another shape or dtype, and an optimizer
    of another kind, before anything is copied."""
    path = os.path.abspath(path)
    with open(os.path.join(path, META_FILE)) as f:
        meta = json.load(f)
    if meta.get("format") != FORMAT:
        raise ValueError(f"{path} is not a {FORMAT} checkpoint (format={meta.get('format')!r})")
    stored = torch.load(os.path.join(path, TENSORS_FILE), map_location="cpu",
                        weights_only=True, mmap=True)
    want = state_tensors(target)
    sharded = _sharded_moments(target)
    shapes = {n: torch.Size(target.layout.shapes[i]) for n, i in sharded.items()}
    # Tensors held in parts (experts, their Adafactor statistics): the
    # checkpoint has them whole.
    joins = _joins(target)
    for n, (axis, dim) in joins.items():
        shape = list(shapes.get(n, want[n].shape))
        shape[dim] *= axis_size(axis_group(axis))
        shapes[n] = torch.Size(shape)
    # A pipeline stage's target: the other stages' blocks are not its own.
    other_stages = set()
    if _parts(target, "pp"):
        other_stages = {k for k in stored.keys() - want.keys() if _BLOCK.match(k)}
    problems = []
    if isinstance(target, TrainState):
        kind = _OPTIMIZERS[type(target.opt_state)]
        if meta.get("optimizer") != kind:
            problems.append(f"  optimizer: checkpoint has {meta.get('optimizer')}, "
                            f"target expects {kind}")
    for name in sorted(want.keys() - stored.keys()):
        t = want[name]
        problems.append(f"  {name}: missing from the checkpoint, target expects "
                        f"{tuple(t.shape)}/{t.dtype}")
    for name in sorted(stored.keys() - want.keys() - other_stages):
        t = stored[name]
        problems.append(f"  {name}: in the checkpoint ({tuple(t.shape)}/{t.dtype}), "
                        "not in the target")
    for name in sorted(want.keys() & stored.keys()):
        w, s = want[name], stored[name]
        shape = shapes.get(name, w.shape)
        if (shape, w.dtype) != (s.shape, s.dtype):
            problems.append(f"  {name}: checkpoint has {tuple(s.shape)}/{s.dtype}, target "
                            f"expects {tuple(shape)}/{w.dtype}")
    if problems:
        raise ValueError(f"checkpoint at {path} does not match the target train state:\n"
                         + "\n".join(problems))
    with torch.no_grad():
        for name, t in want.items():
            src = stored[name]
            if name in joins:  # the target's experts (or their statistics)
                axis, dim = joins[name]
                group = axis_group(axis)
                n = shapes[name][dim] // axis_size(group)
                src = src.narrow(dim, axis_index(group) * n, n)
            if name in sharded:  # the target's rows of the whole moment
                src = target.layout.shard(sharded[name], src)
            t.copy_(src)
    if isinstance(target, TrainState):
        target.step = meta["step"]
        target.opt_state.count = meta["count"]
        reset_derived(target)
    return target
