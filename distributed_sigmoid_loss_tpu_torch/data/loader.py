"""Input pipeline utilities, ported from the JAX package's
``data/loader.py``: device placement of a batch and a prefetch thread that
keeps batches in flight ahead of the step.

- :func:`put_batch`: a host batch onto this rank's device, always as a copy
  (a source may reuse its host memory for the next batch).
- :func:`prefetch`: a daemon thread keeps ``size`` batches ahead; on a CUDA
  device it copies them from pinned host memory on a side stream, so the
  transfers overlap the step's compute.

JAX's ``batch_shardings`` (a ``NamedSharding`` per leaf over the mesh's data
axis) and ``global_batch_from_local`` (a global array from each host's rows,
for multi-host input) have no counterpart: each rank, on whichever host,
places its own rows (``parallel/multihost.py`` joins the processes).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Iterable, Iterator

import torch

__all__ = ["put_batch", "prefetch", "PrefetchStats"]


class PrefetchStats:
    """Starvation counters for one :func:`prefetch` stream.

    - ``consumer_wait_s``: time the consumer spent blocked in ``get`` with
      the queue empty (the step loop had nothing to run);
    - ``producer_wait_s``: time the worker spent blocked in ``put`` with the
      queue full (the healthy direction: the host is ahead);
    - ``produced`` / ``consumed``: batch counters;
    - ``queue_depth``: queue occupancy at the last consumer get.

    ``input_wait_frac`` is consumer wait over wall time since the first
    consumer request: ~0 means prefetch keeps the device fed. Each field has
    one writer (producer fields the worker, consumer fields the consumer), so
    reads need no lock and are off by one batch at worst.
    """

    def __init__(self):
        self.produced = 0
        self.consumed = 0
        self.producer_wait_s = 0.0
        self.consumer_wait_s = 0.0
        self.queue_depth = 0
        self._t_first_get: float | None = None

    def input_wait_frac(self) -> float:
        """Fraction of consumer wall time spent starved (0.0 before the
        first get)."""
        if self._t_first_get is None:
            return 0.0
        elapsed = time.perf_counter() - self._t_first_get
        if elapsed <= 0.0:
            return 0.0
        return min(1.0, self.consumer_wait_s / elapsed)

    def snapshot(self) -> dict:
        return {
            "produced": self.produced,
            "consumed": self.consumed,
            "producer_wait_s": round(self.producer_wait_s, 4),
            "consumer_wait_s": round(self.consumer_wait_s, 4),
            "queue_depth": self.queue_depth,
            "input_wait_frac": round(self.input_wait_frac(), 4),
        }


def put_batch(batch: dict, device) -> dict:
    """Each tensor (or array) of ``batch`` on ``device``, as a copy. To a
    CUDA device the copies come from pinned host memory (pinned by a copy
    unless the tensor already is) and are issued without blocking, on the
    current stream: the caller orders its use after them (see
    :func:`prefetch`). On the CPU they are copies too, so a placed batch
    never shares memory with a source's reusable buffer (the native loader's
    ring)."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        if device.type == "cuda":
            if t.device.type == "cpu" and not t.is_pinned():
                t = t.pin_memory()
            out[k] = t.to(device, non_blocking=True)
        else:
            out[k] = t.to(device, copy=True)
    return out


def _tensors(batch) -> list[torch.Tensor]:
    if isinstance(batch, torch.Tensor):
        return [batch]
    if isinstance(batch, dict):
        return [t for v in batch.values() for t in _tensors(v)]
    if isinstance(batch, (list, tuple)):
        return [t for v in batch for t in _tensors(v)]
    return []


def prefetch(
    it: Iterable[Any],
    device,
    size: int = 2,
    put: Callable[[Any, torch.device], Any] | None = None,
    stats: PrefetchStats | None = None,
) -> Iterator[Any]:
    """Iterate ``it``, keeping ``size`` device batches in flight.

    A daemon thread pulls host batches and places them with ``put(batch,
    device)`` (default :func:`put_batch`). On a CUDA device it does so on a
    side stream and records an event; the consumer's current stream waits on
    that event before the batch is yielded, and each tensor is marked as used
    by the consumer's stream (``record_stream``), so the allocator does not
    hand its memory to the side stream again before the step has read it.

    Exceptions from the source iterator reach the consumer at the matching
    position. Abandoning the iterator early (``break``, an exception,
    garbage collection) closes it: the worker is woken and JOINED (bounded),
    and the queued batches are dropped, so afterwards the source iterator has
    no concurrent reader and the caller may use it again. ``stats`` (a
    :class:`PrefetchStats`) records queue depth, both sides' blocked time and
    the ``input_wait_frac`` the train loop logs.
    """
    device = torch.device(device)
    cuda = device.type == "cuda"
    put = put_batch if put is None else put
    q: queue.Queue = queue.Queue(maxsize=size)
    _END = object()
    stop = threading.Event()

    def enqueue(item) -> bool:
        t0 = time.perf_counter() if stats is not None else 0.0
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                if stats is not None:
                    stats.producer_wait_s += time.perf_counter() - t0
                return True
            except queue.Full:
                continue
        return False

    def produce():
        for batch in it:
            if cuda:
                placed = put(batch, device)
                ready = torch.cuda.Event()
                ready.record(side)
                item = (placed, ready)
            else:
                item = (put(batch, device), None)
            if not enqueue(item):
                return
            if stats is not None:
                stats.produced += 1
        enqueue(_END)

    def worker():
        try:
            if cuda:
                # The side stream stays current while the source is pulled
                # too: a source that recycles host memory (the native
                # loader's zero-copy ring) waits there for the last copy.
                with torch.cuda.device(device), torch.cuda.stream(side):
                    produce()
            else:
                produce()
        except BaseException as e:  # noqa: BLE001 — relayed to the consumer
            enqueue(e)

    side = torch.cuda.Stream(device) if cuda else None
    thread = threading.Thread(target=worker, daemon=True, name="dsl-prefetch")
    thread.start()
    try:
        while True:
            if stats is not None:
                now = time.perf_counter()
                if stats._t_first_get is None:
                    stats._t_first_get = now
                stats.queue_depth = q.qsize()
                item = q.get()
                stats.consumer_wait_s += time.perf_counter() - now
            else:
                item = q.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            batch, ready = item
            if ready is not None:
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(ready)
                for t in _tensors(batch):
                    if t.device.type == "cuda":
                        t.record_stream(consumer)
            if stats is not None:
                stats.consumed += 1
            yield batch
    finally:
        # Wake the worker, then JOIN it before draining: a worker still
        # blocked in ``q.put`` could otherwise deliver one more batch into
        # the drained queue. Its put loop polls ``stop`` every 0.1 s, so the
        # bounded join only expires if the source iterator itself is stuck.
        stop.set()
        thread.join(timeout=5.0)
        while not q.empty():
            try:
                q.get_nowait()
            except queue.Empty:
                break
