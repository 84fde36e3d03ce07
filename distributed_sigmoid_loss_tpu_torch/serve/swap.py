"""Zero-downtime hot swap: versioned weight + index-segment publication.

A training job keeps producing better checkpoints while the serving stack is
under live traffic; this module is the piece that moves them into production
without a restart, a dropped request, or a shape off the warmed bucket grid:

- **weights** — the bucketed engine's encoders take the parameter dict as an
  ARGUMENT, so ``InferenceEngine.swap_params`` replaces the dict (same
  names/shapes/dtypes, validated; copies onto the card complete before the
  dict is published) and every warmed bucket keeps serving:
  ``compile_count`` stays where warmup left it. New params typically come
  from ``train.restore_checkpoint``.
- **index segments** — ``RetrievalRouter.build`` constructs the new tier
  indexes DOUBLE-BUFFERED (the old version keeps answering during the
  build, which is the expensive part), then ``publish_built`` swaps one
  reference atomically. A search reads the current version once at entry
  and keeps it: in-flight requests finish on the version they started on,
  and the version each response observes is monotonically non-decreasing.

Ordering: segments are built first (old traffic unaffected), then params
and the version reference flip back-to-back — the window where new params
serve the old segments is two attribute assignments wide. Cross-request
consistency (an encode followed by a search landing on different versions)
is inherently eventual in any rolling deploy; PER-SEARCH consistency is
what the version object guarantees. The port of the JAX package's
``serve/swap.py``.
"""

from __future__ import annotations

import threading
import time

from distributed_sigmoid_loss_tpu_torch.serve.engine import InferenceEngine
from distributed_sigmoid_loss_tpu_torch.serve.service import RetrievalRouter
from distributed_sigmoid_loss_tpu_torch.serve.siege import maybe_inject
from distributed_sigmoid_loss_tpu_torch.obs.lockwatch import named_lock

__all__ = ["SwapController"]


class SwapController:
    """Orchestrates one hot swap: build segments → swap params → publish.

    Swaps serialize on an internal lock (a second swap waits, never
    interleaves); the search path takes no lock at all. ``swap_count`` and
    swap-latency percentiles land in the router's :meth:`stats` (and from
    there in ``serve-bench`` records).
    """

    def __init__(self, engine: InferenceEngine, router: RetrievalRouter):
        self.engine = engine
        self.router = router
        self._lock = named_lock("serve.swap.SwapController._lock")

    def swap(self, *, params=None, embeddings=None, ids=None) -> int:
        """Publish a new serving version; returns its version number.

        ``params`` — new parameter dict for the engine (None keeps the
        current weights). ``embeddings``/``ids`` — new corpus for fresh
        index segments (None re-publishes the current segments, a
        params-only swap). At least one of the two must be given.
        """
        if params is None and embeddings is None:
            raise ValueError("swap() needs params and/or embeddings")
        t0 = time.perf_counter()
        with self._lock:
            # Mark the swap mid-flight for the whole build+publish window:
            # /healthz reports degraded until end_swap (the swapstorm drill
            # asserts the window is visible, and that it always closes).
            self.router.begin_swap()
            try:
                # Chaos point: stretch/fault the swap window under load
                # (dead unless DSL_CHAOS=1 — serve/siege.py).
                maybe_inject("swap.storm")
                # Double-buffered build: the expensive half happens while the
                # old version keeps serving every request.
                built = (
                    self.router.build(embeddings, ids)
                    if embeddings is not None
                    else None
                )
                if params is not None:
                    self.engine.swap_params(params)  # the same bucket grid
                version = self.router.publish_built(built)
            finally:
                self.router.end_swap()
        t1 = time.perf_counter()
        self.router.record_swap(t1 - t0)
        if self.router.spans is not None:
            self.router.spans.record("serve/swap", t0, t1)
        return version
