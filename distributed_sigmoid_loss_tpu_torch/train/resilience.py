"""Failure detection and preemption-safe training, ported from the JAX
package's ``train/resilience.py``.

- **Preemption** (:class:`PreemptionGuard`): SIGTERM becomes a cooperative
  "checkpoint now" flag, agreed by every rank at the same step (an
  ``all_reduce(MAX)`` of the flag), so a multi-process job checkpoints one
  consistent state.
- **Divergence**: a non-finite loss. :func:`train_resilient` detects it,
  restores the last good checkpoint, and either halts (default) or skips
  the batch.
- **Resume** (:func:`latest_step` / :func:`restore_latest`): checkpoints are
  step-numbered directories; a restarted job picks up from the newest.

The port's step updates the state in place, where JAX's returns a new one;
what that changes for a rollback is in :func:`train_resilient`.
"""

from __future__ import annotations

import contextlib
import os
import re
import signal
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch
import torch.distributed as dist

from distributed_sigmoid_loss_tpu_torch.parallel.mesh import axis_size, is_distributed
from distributed_sigmoid_loss_tpu_torch.train.checkpoint import (
    HostCopy,
    reset_derived,
    restore_checkpoint,
    save_checkpoint,
    state_tensors,
)
from distributed_sigmoid_loss_tpu_torch.train.train_step import TrainState

__all__ = [
    "PreemptionGuard",
    "ResilienceReport",
    "RestoreRequiredError",
    "TrainingDiverged",
    "latest_step",
    "restore_latest",
    "save_step",
    "train_resilient",
]


class RestoreRequiredError(FileNotFoundError):
    """``train_resilient(require_restore=True)`` found nothing to restore.

    A type of its own, so callers catch the restore failure, not every
    missing file of the data loader or the checkpoint writer.
    """


_STEP_DIR_RE = re.compile(r"^step_(\d{8})$")


class TrainingDiverged(RuntimeError):
    """Raised when the loss goes non-finite and ``on_divergence="halt"``.

    ``restored_state`` is the state restored from the last checkpoint (None
    when no checkpoint existed yet) and ``restored_step`` its step.
    """

    def __init__(self, step: int, loss: float, restored_step: int | None,
                 restored_state: Any = None):
        self.step = step
        self.loss = loss
        self.restored_step = restored_step
        self.restored_state = restored_state
        msg = f"non-finite loss {loss} at step {step}"
        if restored_step is not None:
            msg += f"; last good state (checkpoint step {restored_step}) is on "
            msg += "this exception's .restored_state"
        super().__init__(msg)


class PreemptionGuard:
    """Cooperative preemption flag agreed by every rank.

    As a context manager it installs a SIGTERM handler;
    ``reached_sync_point(step)`` returns True on EVERY rank, at the same
    step, once any rank has been signalled. The handler only sets a flag;
    the train loop decides when to act (between steps, never inside a
    collective). With more than one rank the agreement is an
    ``all_reduce(MAX)`` of the flags over the world at every step; every
    rank must call it at the same steps. (JAX's guard also takes other
    signals and a sync interval; no caller sets them.)
    """

    def __init__(self):
        self._flag = threading.Event()
        self._previous = None
        self._agreed = False

    def __enter__(self) -> "PreemptionGuard":
        self._previous = signal.signal(signal.SIGTERM, self._on_signal)
        return self

    def __exit__(self, *exc) -> None:
        signal.signal(signal.SIGTERM, self._previous)
        self._previous = None

    def _on_signal(self, signum, frame) -> None:
        self._flag.set()

    @property
    def preempted_locally(self) -> bool:
        return self._flag.is_set()

    def reached_sync_point(self, step: int) -> bool:
        """True once ANY rank has the flag; every rank returns True at the
        same step."""
        if self._agreed:
            return True
        local = int(self._flag.is_set())
        if is_distributed() and axis_size() > 1:
            device = "cuda" if dist.get_backend() == "nccl" else "cpu"
            flag = torch.tensor([local], dtype=torch.int32, device=device)
            dist.all_reduce(flag, op=dist.ReduceOp.MAX)
            self._agreed = bool(flag.item())
        else:
            self._agreed = bool(local)
        return self._agreed


# -- step-numbered checkpoint layout -------------------------------------------


def _step_dir(root: str, step: int) -> str:
    return os.path.join(os.path.abspath(root), f"step_{step:08d}")


def latest_step(root: str) -> int | None:
    """Newest COMPLETE checkpoint step under ``root``, or None. Writes are
    atomic (a temporary name, then ``os.replace``), so a matching directory
    is complete and a temporary one does not match."""
    if not os.path.isdir(root):
        return None
    steps = []
    for name in os.listdir(root):
        m = _STEP_DIR_RE.match(name)
        if m and os.path.isdir(os.path.join(root, name)):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def save_step(root: str, step: int, state: Any, saver=None) -> str:
    """Save ``state`` as checkpoint ``step`` under ``root``; returns the path.
    ``saver`` (a ``checkpoint.AsyncSaver``) makes the write non-blocking; its
    owner must ``wait()`` before trusting ``latest_step`` on the same root."""
    path = _step_dir(root, step)
    if saver is not None:
        saver.save(path, state)
    else:
        save_checkpoint(path, state)
    return path


def restore_latest(root: str, target: Any) -> tuple[Any, int] | None:
    """Restore the newest checkpoint under ``root`` into ``target`` (in
    place, on the target's devices). Returns ``(state, step)``, or None when
    no checkpoint exists."""
    step = latest_step(root)
    if step is None:
        return None
    return restore_checkpoint(_step_dir(root, step), target), step


# -- the resilient loop --------------------------------------------------------


@dataclass
class ResilienceReport:
    """What happened during a train_resilient run (for logs/tests)."""

    start_step: int = 0
    final_step: int = 0
    checkpoints: list[int] = field(default_factory=list)
    preempted: bool = False
    divergences: int = 0


def _counters(state: Any) -> tuple[int, int] | None:
    """A ``TrainState``'s plain-integer counters, which its step advances in
    place beside the tensors (a restore sets them from ``meta.json``)."""
    if isinstance(state, TrainState):
        return state.step, state.opt_state.count
    return None


def _span(spans, name):
    return contextlib.nullcontext() if spans is None else spans.span(name)


def train_resilient(
    state: Any,
    step_fn: Callable[[Any, Any], tuple[Any, dict]],
    batches: Iterable[Any],
    *,
    total_steps: int,
    ckpt_dir: str,
    ckpt_every: int = 100,
    guard: PreemptionGuard | None = None,
    on_divergence: str = "halt",  # "halt" | "skip"
    on_metrics: Callable[[int, dict], None] | None = None,
    check_finite_every: int = 1,
    require_restore: bool = False,
    saver=None,
    eval_every: int = 0,
    on_eval: Callable[[int, Any], None] | None = None,
    spans=None,
    flight=None,
) -> tuple[Any, ResilienceReport]:
    """Run ``step_fn`` to ``total_steps`` with checkpoint/resume, preemption
    checkpointing and divergence detection, as the JAX package's loop does.

    Resumes from the newest checkpoint in ``ckpt_dir`` (restored into
    ``state`` in place). Saves every ``ckpt_every`` steps, at preemption
    (then stops with ``report.preempted``), and when the loop ends
    (``total_steps`` reached or the data exhausted). On a non-finite loss the
    last good checkpoint is restored; ``on_divergence="halt"`` raises
    :class:`TrainingDiverged` with it, ``"skip"`` goes on from it with the
    next batch.

    ``step_fn(state, batch) -> (state, metrics)`` may update ``state`` in
    place (the port's train step does). A poisoned update is then undone by
    the restore; before the first checkpoint, when JAX's "skip" keeps the
    pre-step state, this loop keeps a host copy of the state's tensors
    (``checkpoint.state_tensors``, into the reused pinned buffers of a
    ``checkpoint.HostCopy``) and of a ``TrainState``'s counters (``step``
    and the optimizer's ``count``), taken before each step that is checked,
    and puts both back. The copy is taken only under ``"skip"`` and only
    while no checkpoint exists; its cost is one device-to-host copy of the
    state a checked step. Either rollback zeroes the compressed step's
    derived state (``checkpoint.reset_derived``: the residuals and the
    adaptive carry's stats), which the poisoned step overwrote.

    ``check_finite_every``: the check reads the loss on the host, which
    waits for the device; 1 checks every step, k every k-th (a divergence is
    then caught within k steps, and the rollback still lands on the last
    good checkpoint). ``on_metrics(step, metrics)`` gets the raw metrics
    every step.

    ``batches``: on resume, it should start at the resumed step's data
    position. ``require_restore``: raise :class:`RestoreRequiredError` before
    any step if nothing restores. ``saver`` (a ``checkpoint.AsyncSaver``):
    the loop ``wait()``s before a rollback and before returning, so the
    report's checkpoints are durable by then. ``eval_every`` + ``on_eval``:
    ``on_eval(step, state)`` every that many steps, between the update and
    the checkpoint decision.

    ``spans`` (anything with a ``span(name)`` context manager) sees the
    stages ``fetch``, ``step``, ``eval`` and ``checkpoint``; ``flight``
    (anything with ``dump(reason)``) is dumped when control leaves the loop
    abnormally: the divergence raise, the preemption stop, or a crash out of
    a step or the data. None costs nothing.
    """
    report = ResilienceReport()
    resumed = restore_latest(ckpt_dir, state)
    if resumed is None and require_restore:
        raise RestoreRequiredError(
            f"require_restore=True but no checkpoint restores from {ckpt_dir!r} "
            "(did the checkpoint directory change since resume detection?)"
        )
    if resumed is not None:
        state, report.start_step = resumed[0], resumed[1]
        report.checkpoints.append(resumed[1])
    step = report.start_step

    it: Iterator[Any] = iter(batches)
    last_good = latest_step(ckpt_dir)
    # "skip" before the first checkpoint: the pre-step state's host copy.
    pre_step = HostCopy() if on_divergence == "skip" and last_good is None else None

    def save(s, st):
        nonlocal last_good, pre_step
        if last_good != s:
            with _span(spans, "checkpoint"):
                save_step(ckpt_dir, s, st, saver=saver)
            report.checkpoints.append(s)
            last_good, pre_step = s, None

    try:
        while step < total_steps:
            try:
                with _span(spans, "fetch"):
                    batch = next(it)
            except StopIteration:
                # Data exhausted early: still save, so a restart resumes here.
                save(step, state)
                break
            check_now = (step + 1) % max(1, check_finite_every) == 0
            if check_now and pre_step is not None:
                pre_tensors = pre_step.take(state_tensors(state))
                pre_counters = _counters(state)
            with _span(spans, "step"):
                new_state, metrics = step_fn(state, batch)

            if check_now and not np.isfinite(loss := float(metrics["loss"])):
                report.divergences += 1
                if saver is not None:
                    saver.wait()  # the rollback target may still be writing
                restored = restore_latest(ckpt_dir, state)
                restored_state, restored_step = (None, None)
                if restored is not None:
                    restored_state, restored_step = restored
                    state = restored_state
                if on_divergence == "halt":
                    report.final_step = step
                    if flight is not None:
                        flight.dump(f"divergence: non-finite loss at step {step}")
                    raise TrainingDiverged(step, loss, restored_step, restored_state)
                if restored is None:
                    # No checkpoint yet: back to the pre-step state, as JAX
                    # keeps it.
                    pre_step.wait()
                    with torch.no_grad():
                        for k, t in state_tensors(state).items():
                            t.copy_(pre_tensors[k])
                    if pre_counters is not None:
                        state.step, state.opt_state.count = pre_counters
                    reset_derived(state)
                # "skip": drop the poisoned update, go on with the next batch.
                step += 1
                continue

            state = new_state
            step += 1
            if on_metrics is not None:
                on_metrics(step, metrics)
            if on_eval is not None and eval_every and step % eval_every == 0:
                with _span(spans, "eval"):
                    on_eval(step, state)

            preempted = guard is not None and guard.reached_sync_point(step)
            if preempted or step % ckpt_every == 0 or step == total_steps:
                save(step, state)
            if preempted:
                report.preempted = True
                if flight is not None:
                    flight.dump(f"preemption (SIGTERM) at step {step}")
                break
    except TrainingDiverged:
        raise  # already dumped above
    except BaseException as e:
        if flight is not None:
            flight.dump(f"crash at step {step}: {type(e).__name__}: {e}")
        raise

    report.final_step = step
    if saver is not None:
        saver.wait()  # report.checkpoints are durable from here
    return state, report
