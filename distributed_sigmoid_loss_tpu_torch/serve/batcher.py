"""Thread-safe dynamic micro-batcher: coalesce concurrent requests into one
engine call.

Online traffic arrives one request at a time, but the engine's throughput
comes from batched matrix products — the classic serving trade (batch for
throughput, deadline for latency). This batcher is the piece in between: a
bounded queue of single-item requests, a worker that drains it into batches of
at most ``max_batch_size``, waiting at most ``max_wait_ms`` past the FIRST
queued item's arrival before flushing a partial batch, and futures fanning the
results back to the callers.

Backpressure is explicit: when the queue is full, ``submit`` raises
:class:`QueueFullError` immediately instead of growing without bound — the
caller (or its load balancer) sheds the request while the tail latency of
queued work stays bounded by ``max_queue / throughput``.

The batch function runs on the worker thread only, one call at a time, so a
non-thread-safe engine path is safe behind a batcher.

Per-stage latencies: every request's life splits into queue-wait (enqueue
→ assembly done), batch-assembly (deadline coalescing after the first item),
device (the ``run_batch`` engine call) and reply (future fan-out). Each stage
feeds a bounded :class:`~distributed_sigmoid_loss_tpu_torch.utils.logging.
LatencyWindow`, surfaced as ``stage_latency_ms`` in
``EmbeddingService.stats()``, so a p99 regression names its stage.

The port of the JAX package's ``serve/batcher.py``, with its chaos point
(``batcher.stall``, ``serve/siege.py``); its host spans (``obs/spans.py``)
are not ported yet.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import Counter
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

from distributed_sigmoid_loss_tpu_torch.serve.siege import maybe_inject
from distributed_sigmoid_loss_tpu_torch.utils.logging import LatencyWindow

BATCH_STAGES = ("queue_wait", "assembly", "device", "reply")

__all__ = [
    "MicroBatcher",
    "QueueFullError",
    "BatcherClosedError",
    "ShutdownError",
    "BATCH_STAGES",
]


class QueueFullError(RuntimeError):
    """The batcher's bounded queue is full — request rejected (backpressure)."""


class BatcherClosedError(RuntimeError):
    """submit() after close(): the worker is draining/stopped."""


class ShutdownError(RuntimeError):
    """The batcher shut down with this request still queued: a typed
    rejection, never a hung future — the close() drain guarantee."""


@dataclass
class _Request:
    item: Any
    future: Future = field(default_factory=Future)
    enqueued_at: float = field(default_factory=time.monotonic)


_SENTINEL = object()


def _resolve(req: "_Request", result) -> None:
    """Set a result, tolerating a future already failed by the close-side
    drain sweep (the worker and the sweep may race; exactly one wins)."""
    if req.future.cancelled():
        return
    try:
        req.future.set_result(result)
    except InvalidStateError:
        pass


def _fail(req: "_Request", exc: BaseException) -> None:
    if req.future.cancelled():
        return
    try:
        req.future.set_exception(exc)
    except InvalidStateError:
        pass


class MicroBatcher:
    """Coalesce single-item submissions into batched ``run_batch`` calls.

    ``run_batch(items) -> results`` receives a list of 1..max_batch_size items
    and must return one result per item, in order. A raised exception fails
    every future of that batch (callers see the error; the worker keeps
    serving subsequent batches).
    """

    def __init__(
        self,
        run_batch: Callable[[list], Sequence],
        *,
        max_batch_size: int = 32,
        max_wait_ms: float = 5.0,
        max_queue: int = 1024,
        name: str = "batcher",
    ):
        if max_batch_size < 1:
            raise ValueError(f"max_batch_size must be >= 1, got {max_batch_size}")
        if max_wait_ms < 0:
            raise ValueError(f"max_wait_ms must be >= 0, got {max_wait_ms}")
        self._run_batch = run_batch
        self.max_batch_size = max_batch_size
        self.max_wait = max_wait_ms / 1000.0
        self.name = name
        self._queue: queue.Queue = queue.Queue(maxsize=max_queue)
        self._closed = False
        self._hist_lock = threading.Lock()
        self._batch_sizes: Counter[int] = Counter()
        # Small windows: a batcher's stage stats cover recent traffic, and
        # four windows per batcher must stay cheap.
        self._stage_windows = {s: LatencyWindow(2048) for s in BATCH_STAGES}
        self._worker = threading.Thread(
            target=self._loop, name=f"{name}-worker", daemon=True
        )
        self._worker.start()

    # -- client side ---------------------------------------------------------

    def submit(self, item) -> Future:
        """Enqueue one item; returns the Future of its result.

        Raises :class:`QueueFullError` when the bounded queue is full and
        :class:`BatcherClosedError` after :meth:`close`.
        """
        if self._closed:
            raise BatcherClosedError("submit() on a closed MicroBatcher")
        req = _Request(item)
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            raise QueueFullError(
                f"batcher queue full ({self._queue.maxsize} pending); "
                "retry later or raise max_queue"
            ) from None
        if self._closed:
            # close() raced our enqueue: the worker may already be past its
            # final drain, which would leave this future hung forever. Fail
            # it typed; if the worker DOES still serve it, the safe setters
            # let exactly one side win.
            _fail(req, ShutdownError("batcher shut down while request queued"))
        return req.future

    def close(self, *, wait: bool = True) -> None:
        """Stop accepting work; the worker drains what is already queued.

        Drain guarantee: every request that made it into the queue is either
        answered by the worker or failed with :class:`ShutdownError` — a
        ``fut.result()`` can never hang on a closed batcher.
        """
        if self._closed:
            return
        self._closed = True
        # The sentinel is the wake-up/stop signal; put() (blocking) because a
        # full queue still needs the worker stopped after it drains.
        self._queue.put(_SENTINEL)
        if wait:
            self._worker.join()
            # Final sweep: anything enqueued after the worker's own drain
            # (submit racing close) gets the typed rejection here.
            self._drain_reject()

    def _drain_reject(self) -> None:
        """Fail everything still queued with ShutdownError (sentinels skipped)."""
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                return
            if req is _SENTINEL:
                continue
            _fail(req, ShutdownError("batcher shut down while request queued"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def batch_size_histogram(self) -> dict[int, int]:
        """{batch_size: count of engine calls at that size}."""
        with self._hist_lock:
            return dict(sorted(self._batch_sizes.items()))

    def stage_latency_ms(self) -> dict[str, dict[str, float]]:
        """{stage: {p50_ms, p95_ms, p99_ms}} per batching stage — queue_wait
        and reply are per REQUEST, assembly and device per engine CALL."""
        return {
            stage: w.percentiles_ms((50, 95, 99))
            for stage, w in self._stage_windows.items()
        }

    def _stage(self, stage: str, t0: float, t1: float) -> None:
        self._stage_windows[stage].record(t1 - t0)

    # -- worker side ---------------------------------------------------------

    def _collect(self) -> tuple[list[_Request], float] | None:
        """Block for the first request, then fill the batch until size or the
        first request's deadline; past the deadline, still take what is
        already queued without waiting (a backlog flushes as full batches,
        not singletons). None = sentinel seen with nothing pending.
        Returns ``(batch, t_assembly_start)`` — assembly starts when the
        worker picks the first item up (queue wait before that belongs to the
        queue_wait stage, not assembly)."""
        first = self._queue.get()
        if first is _SENTINEL:
            return None
        t_assembly = time.monotonic()
        batch = [first]
        deadline = first.enqueued_at + self.max_wait
        while len(batch) < self.max_batch_size:
            remaining = deadline - time.monotonic()
            try:
                if remaining > 0:
                    nxt = self._queue.get(timeout=remaining)
                else:
                    nxt = self._queue.get_nowait()
            except queue.Empty:
                break
            if nxt is _SENTINEL:
                # Re-queue so the outer loop terminates after this batch.
                self._queue.put(_SENTINEL)
                break
            batch.append(nxt)
        return batch, t_assembly

    def _loop(self) -> None:
        while True:
            collected = self._collect()
            if collected is None:
                # Sentinel: reject anything that slipped in behind it before
                # the worker exits (the drain guarantee's worker-side half).
                self._drain_reject()
                return
            batch, t_assembly = collected
            t_run = time.monotonic()
            # Per-request queue wait: enqueue → assembly done (the moment its
            # engine call starts); per-call assembly: the coalescing window.
            for r in batch:
                self._stage("queue_wait", r.enqueued_at, t_run)
            self._stage("assembly", t_assembly, t_run)
            with self._hist_lock:
                self._batch_sizes[len(batch)] += 1
            try:
                # Chaos point: a wedged worker (stall) or a pre-engine fault;
                # dead unless DSL_CHAOS=1 AND a fault is armed (serve/siege).
                maybe_inject("batcher.stall")
                results = self._run_batch([r.item for r in batch])
            except Exception as e:  # noqa: BLE001 — fan the failure out
                self._stage("device", t_run, time.monotonic())
                for r in batch:
                    _fail(r, e)
                continue
            t_reply = time.monotonic()
            self._stage("device", t_run, t_reply)
            if len(results) != len(batch):
                err = RuntimeError(
                    f"run_batch returned {len(results)} results for "
                    f"{len(batch)} items"
                )
                for r in batch:
                    _fail(r, err)
                continue
            for r, res in zip(batch, results):
                _resolve(r, res)
            self._stage("reply", t_reply, time.monotonic())
