"""Chip-free perf regression gates: proxy metrics against a committed
baseline (the port's ``obs regress``, the counterpart of the JAX package's
``obs/regress.py``, with its metrics, tolerances, contracts and exit codes).

The perf contracts the loss paths ship (the chunked scan and the streaming
kernel far below the fused block's memory; ring and ring-overlap moving the
same bytes) are program properties, visible without a card:

- **Step-config lattice**: every config of the sampled step-config product
  (``analysis/trace_audit.step_config_traces``: the real builders, one
  step traced in a fake world of 8) gets its attribution proxies
  (``obs/attribution.py``): FLOPs, per-kind collective wire bytes and the
  roofline ``mfu_est`` on the H100, compared with the baseline within
  :data:`PROXY_METRICS`' tolerances (counts: 1%; ``mfu_est``: ±0.02).
- **Loss islands**: the fused / chunked / streaming-fused /
  streaming-chunked all-gather losses and their gradients at a fixed shape
  (:data:`ISLAND_CONFIGS`, W = 8, local_b 512, d 128), at rank 0 of a fake
  world. On the CPU the measure is the peak of the bytes live in storages
  the call allocates, counted on tensors without storage (each result's
  storage added when an operation makes it, dropped when it is freed):
  deterministic, and what the baseline pins at :data:`ISLAND_TOLERANCE`. On
  a card the islands run on real tensors (the streaming ones launch K4-K6)
  and the measure is the caching allocator's peak above what was allocated
  before the call (``utils.profiling.compiled_memory_stats``). The two
  measures carry different ``_meta`` and are never compared with each
  other; the ratio contracts hold for both.
- **Structural contracts** (no baseline needed): chunked and
  streaming-fused temp below 0.5× fused; streaming-chunked at most 1.1×
  chunked; ring and ring-overlap wire bytes equal per kind.

The baseline is written by ``obs regress --update`` on the CPU and committed
as ``obs/regress_baseline.json``. A torch version other than the
baseline's downgrades the absolute island comparisons to warnings; the
closed-form proxies and the ratio contracts stay enforced.
"""

from __future__ import annotations

import json
import os
import sys

from distributed_sigmoid_loss_tpu_torch.analysis.findings import Finding

__all__ = [
    "BASELINE_PATH",
    "PROXY_METRICS",
    "ISLAND_CONFIGS",
    "collect_step_proxies",
    "collect_island_bytes",
    "collect_proxies",
    "compare_proxies",
    "contract_findings",
    "run_regress",
]

BASELINE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "regress_baseline.json")

# The per-config proxies the lattice gate compares, with their tolerance:
# ("rel", f) a relative bound, ("abs", f) an absolute one. The counts are
# deterministic; the 1% is slack for benign reshuffles, not noise.
PROXY_METRICS = {
    "flops_est": ("rel", 0.01),
    "comm_bytes_total": ("rel", 0.01),
    "comm_bytes_all_gather": ("rel", 0.01),
    "comm_bytes_ppermute": ("rel", 0.01),
    "comm_bytes_psum": ("rel", 0.01),
    "comm_bytes_psum_scatter": ("rel", 0.01),
    "comm_bytes_all_to_all": ("rel", 0.01),
    "mfu_est": ("abs", 0.02),
}

# The islands' bytes against the baseline: JAX's band.
ISLAND_TOLERANCE = 0.10

# JAX's island shape: d = 128 keeps the streaming kernel engaged (its rows
# and width contract), local_b = 512 makes the blocks, not fixed buffers,
# dominate the bytes, so the chunked and streamed ratios show.
ISLAND_WORLD = 8
ISLAND_LOCAL_B = 512
ISLAND_D = 128

ISLAND_CONFIGS = {
    "fused": {},
    "chunked": {"loss_impl": "chunked"},
    "streaming_fused": {"use_pallas": True},
    "streaming_chunked": {"loss_impl": "chunked", "use_pallas": True},
}


def collect_step_proxies(n_devices: int | None = None, device: str = "cpu") -> dict:
    """label -> proxy dict for the sampled step-config lattice (traces on
    ``device``: real zero-valued tensors on the CPU, tensors without storage
    on a card)."""
    from distributed_sigmoid_loss_tpu_torch.obs.attribution import step_config_attribution

    out = {}
    for label, costs in step_config_attribution(n_devices, device=device).items():
        proxies = {k: round(float(costs[k]), 1) for k in costs if k in PROXY_METRICS}
        proxies["mfu_est"] = costs["mfu_est"]
        out[label] = proxies
    return out


def _live_bytes_mode():
    """A dispatch mode that tracks the bytes of the storages the operations
    it sees allocate: each result's new storage is added when made and
    dropped when freed (a finalizer on the storage); ``peak`` is the most
    live at once. Storages it is told of (:meth:`known`) count nothing."""
    import weakref

    from torch.utils._python_dispatch import TorchDispatchMode

    class _LiveBytes(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.live = 0
            self.peak = 0
            self._seen: set = set()

        def known(self, *tensors) -> None:
            for t in tensors:
                self._seen.add(t.untyped_storage()._cdata)

        def _drop(self, key, nbytes) -> None:
            self._seen.discard(key)
            self.live -= nbytes

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            from distributed_sigmoid_loss_tpu_torch.obs.attribution import _tensors

            for t in _tensors(out):
                storage = t.untyped_storage()
                key = storage._cdata
                if key in self._seen:
                    continue
                self._seen.add(key)
                nbytes = storage.nbytes()
                self.live += nbytes
                self.peak = max(self.peak, self.live)
                weakref.finalize(storage, self._drop, key, nbytes)
            return out

    return _LiveBytes()


def _island_inputs(device: str):
    import numpy as np
    import torch

    from distributed_sigmoid_loss_tpu_torch.ops.sigmoid_loss import init_loss_params, l2_normalize

    rng = np.random.default_rng(0)
    zi, zt = (l2_normalize(torch.from_numpy(
        rng.standard_normal((ISLAND_LOCAL_B, ISLAND_D)).astype(np.float32))).to(device)
        for _ in range(2))
    params = {k: v.to(device) for k, v in init_loss_params().items()}
    for t in (zi, zt, *params.values()):
        t.requires_grad_(True)
    return params, zi, zt


def _island_value_and_grads(fn, params, zi, zt):
    loss = fn(params, zi, zt)
    loss.backward()
    return loss


def collect_island_bytes(device: str = "cpu") -> dict:
    """label -> {temp_bytes, peak_bytes} of the four loss islands (value and
    gradients of rank 0's loss in a fake world of :data:`ISLAND_WORLD`), and
    ``_meta``. On the CPU, the live-bytes peak of a trace on tensors without
    storage (``peak_bytes`` = the arguments' bytes plus ``temp_bytes``); on
    a card, ``compiled_memory_stats`` of the call on real tensors (the
    streaming islands launch K4-K6)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from distributed_sigmoid_loss_tpu_torch.analysis.trace_audit import (
        fake_process_group,
        one_thread,
    )
    from distributed_sigmoid_loss_tpu_torch.parallel.api import make_sharded_loss_fn
    from distributed_sigmoid_loss_tpu_torch.utils.profiling import compiled_memory_stats

    on_card = torch.device(device).type == "cuda"
    out: dict = {}
    with one_thread(), fake_process_group(ISLAND_WORLD, 0):
        for label, kw in ISLAND_CONFIGS.items():
            fn = make_sharded_loss_fn(variant="all_gather", **kw)
            if on_card:
                params, zi, zt = _island_inputs(device)
                m = compiled_memory_stats(_island_value_and_grads, fn, params, zi, zt)
                out[label] = {"temp_bytes": int(m["temp_size_in_bytes"]),
                              "peak_bytes": int(m["peak_bytes"])}
                continue
            with FakeTensorMode(allow_non_fake_inputs=True):
                params, zi, zt = _island_inputs(device)
                args = [zi, zt, *params.values()]
                mode = _live_bytes_mode()
                mode.known(*args)
                with mode:
                    _island_value_and_grads(fn, params, zi, zt)
                arg_bytes = sum(t.untyped_storage().nbytes() for t in args)
            out[label] = {"temp_bytes": int(mode.peak), "peak_bytes": int(arg_bytes + mode.peak)}
    out["_meta"] = {"w": ISLAND_WORLD, "local_b": ISLAND_LOCAL_B, "d": ISLAND_D,
                    "measure": "allocator" if on_card else "live_bytes"}
    return out


def collect_proxies(n_devices: int | None = None, device: str = "cpu") -> dict:
    """The current tree's proxy snapshot: the step-config lattice, the loss
    islands' bytes, and the environment."""
    import torch

    from distributed_sigmoid_loss_tpu_torch.analysis.trace_audit import TRACE_WORLD
    from distributed_sigmoid_loss_tpu_torch.obs.ledger import environment_fingerprint

    n = n_devices or TRACE_WORLD
    snap: dict = {
        "meta": {
            "torch": torch.__version__.split("+")[0],
            "n_devices": n,
            "device": torch.device(device).type,
            **{k: v for k, v in environment_fingerprint().items() if k in ("git_sha",)},
        }
    }
    snap["step_configs"] = collect_step_proxies(n, device=device)
    snap["loss_islands"] = collect_island_bytes(device=device)
    return snap


def contract_findings(current: dict) -> list[Finding]:
    """The self-relative structural contracts, enforced with no baseline."""
    findings: list[Finding] = []
    islands = current.get("loss_islands") or {}
    meta = islands.get("_meta") or {}

    def temp(label):
        return islands.get(label, {}).get("temp_bytes")

    # Ratio contracts at W = 8 only: the savings scale with W.
    if meta.get("w", 0) >= 8 and temp("fused"):
        fused = temp("fused")
        for label, bound in (("chunked", 0.5), ("streaming_fused", 0.5)):
            t = temp(label)
            if t is None:
                continue
            ratio = t / fused
            if ratio >= bound:
                findings.append(Finding(
                    "regress-contract",
                    f"loss_islands::{label}",
                    f"temp_bytes ratio vs fused is {ratio:.3f} (contract < {bound}): {t} vs "
                    f"{fused} — the streamed/chunked memory contract regressed; a dropped "
                    "checkpoint or a materialized logits block looks exactly like this",
                ))
        if temp("streaming_chunked") and temp("chunked"):
            ratio = temp("streaming_chunked") / temp("chunked")
            if ratio > 1.1:
                findings.append(Finding(
                    "regress-contract",
                    "loss_islands::streaming_chunked",
                    f"temp_bytes is {ratio:.3f}x the chunked scan (contract <= 1.1x): the "
                    "kernel's tile recompute stopped paying for itself",
                ))
    steps = current.get("step_configs") or {}
    # The ring pair must move the same bytes per kind: the overlap reorders
    # hops, never traffic.
    ring_kinds = ("comm_bytes_all_gather", "comm_bytes_ppermute", "comm_bytes_psum",
                  "comm_bytes_psum_scatter")
    for a, b in (("ring", "ring_overlap"), ("pallas_ring", "pallas_ring_overlap")):
        if a in steps and b in steps:
            for kind in ring_kinds:
                va, vb = steps[a].get(kind), steps[b].get(kind)
                if va != vb:
                    findings.append(Finding(
                        "regress-contract",
                        f"step_configs::{b}::{kind}",
                        f"{kind} differs from {a}: {vb} vs {va} — the overlap must reorder "
                        "hops, never change what goes over the wire",
                    ))
    return findings


def compare_proxies(current: dict, baseline: dict) -> tuple[list, list]:
    """(failures, warnings) of the current tree against the baseline:
    failures name the config and metric with both values; warnings are
    strings (version downgrades, configs the baseline does not know)."""
    failures: list[Finding] = []
    warnings: list[str] = []
    cur_torch = current.get("meta", {}).get("torch")
    base_torch = baseline.get("meta", {}).get("torch")
    torch_mismatch = cur_torch != base_torch
    if torch_mismatch:
        warnings.append(
            f"torch version differs from the baseline's ({cur_torch} vs {base_torch}): "
            "absolute island comparisons downgraded to warnings; the closed-form proxies "
            "and the ratio contracts stay enforced"
        )

    cur_steps = current.get("step_configs")
    base_steps = baseline.get("step_configs") or {}
    if cur_steps is not None:
        for label in sorted(base_steps):
            if label not in cur_steps:
                failures.append(Finding(
                    "regress-proxy", f"step_configs::{label}",
                    "config present in the committed baseline but missing from the current "
                    "lattice — a step config was removed (or renamed) without `obs regress "
                    "--update`",
                ))
                continue
            for metric, (mode, tol) in PROXY_METRICS.items():
                if metric not in base_steps[label]:
                    continue
                b = float(base_steps[label][metric])
                c = float(cur_steps[label].get(metric, float("nan")))
                if mode == "abs":
                    drift = abs(c - b)
                else:
                    drift = abs(c - b) / b if b else abs(c - b)
                if not drift <= tol:  # NaN fails
                    failures.append(Finding(
                        "regress-proxy",
                        f"step_configs::{label}::{metric}",
                        f"{metric} drifted {drift:.4f} ({mode} tolerance {tol}): baseline "
                        f"{b} -> current {c}",
                    ))
        for label in sorted(set(cur_steps) - set(base_steps)):
            warnings.append(f"step config {label!r} has no committed baseline — run "
                            "`obs regress --update` to pin it")

    cur_isl = current.get("loss_islands") or {}
    base_isl = baseline.get("loss_islands") or {}
    shape_match = cur_isl.get("_meta") == base_isl.get("_meta") and cur_isl.get("_meta")
    if not shape_match and base_isl and cur_isl:
        warnings.append(
            "island shape or measure differs from the baseline's "
            f"({cur_isl.get('_meta')} vs {base_isl.get('_meta')}): absolute comparison "
            "skipped (ratio contracts still apply)"
        )
    elif shape_match:
        for label in sorted(set(base_isl) - {"_meta"}):
            if label not in cur_isl:
                failures.append(Finding(
                    "regress-proxy", f"loss_islands::{label}",
                    "island present in the baseline but missing from the current tree",
                ))
                continue
            b = float(base_isl[label]["temp_bytes"])
            c = float(cur_isl[label]["temp_bytes"])
            drift = abs(c - b) / b if b else abs(c - b)
            if drift > ISLAND_TOLERANCE:
                msg = (f"temp_bytes drifted {drift:.3f} (tolerance {ISLAND_TOLERANCE}): "
                       f"baseline {int(b)} -> current {int(c)}")
                if torch_mismatch:
                    warnings.append(f"loss_islands::{label}: {msg} (downgraded: torch "
                                    "version mismatch)")
                elif c > b:
                    failures.append(Finding(
                        "regress-proxy", f"loss_islands::{label}",
                        msg + " — a peak-bytes regression of the memory contract the "
                        "chunked/streaming paths exist for",
                    ))
                else:
                    # An improvement outside the band is pinned, not failed.
                    warnings.append(f"loss_islands::{label}: {msg} (improvement — refresh "
                                    "the baseline with `obs regress --update`)")
    return failures, warnings


def load_baseline(path: str | None = None) -> dict | None:
    p = path or BASELINE_PATH
    if not os.path.exists(p):
        return None
    with open(p, encoding="utf-8") as f:
        return json.load(f)


def write_baseline(current: dict, path: str | None = None) -> str:
    p = path or BASELINE_PATH
    with open(p, "w", encoding="utf-8") as f:
        json.dump(current, f, indent=1, sort_keys=True)
        f.write("\n")
    return p


def run_regress(
    *,
    baseline_path: str | None = None,
    update: bool = False,
    n_devices: int | None = None,
    stream=None,
    current: dict | None = None,
    device: str = "cpu",
) -> int:
    """The ``obs regress`` entry point: collect the current tree's proxies
    (on ``device``), check the structural contracts, compare with the
    baseline, print a summary. Exit 0 = green, 1 = regression (each failure
    names its config and metric), 2 = usage or environment error.
    ``update=True`` rewrites the baseline instead of comparing; ``current``
    injects a snapshot (tests)."""
    out = stream or sys.stdout
    if current is None:
        current = collect_proxies(n_devices=n_devices, device=device)
    meta = current.get("meta", {})
    isl = {k: v for k, v in (current.get("loss_islands") or {}).items() if k != "_meta"}
    print(f"obs regress: {len(current.get('step_configs') or {})} step configs traced, "
          f"{len(isl)} loss islands measured (torch {meta.get('torch')}, "
          f"{meta.get('n_devices')} ranks, {meta.get('device')})", file=out)
    for label in sorted(isl):
        print(f"  island {label:<18} temp_bytes={isl[label]['temp_bytes']}", file=out)

    if update:
        path = write_baseline(current, baseline_path)
        print(f"obs regress: baseline written -> {path}", file=out)
        return 0

    failures = contract_findings(current)
    baseline = load_baseline(baseline_path)
    if baseline is None:
        print(f"obs regress: no committed baseline ({baseline_path or BASELINE_PATH}); run "
              "`obs regress --update` to write it — only the structural contracts were "
              "checked", file=out)
    else:
        cmp_failures, warnings = compare_proxies(current, baseline)
        failures.extend(cmp_failures)
        for w in warnings:
            print(f"obs regress: WARNING: {w}", file=out)
    for f in failures:
        print(f"obs regress: FAIL {f}", file=out)
    verdict = "green" if not failures else f"{len(failures)} regression(s)"
    print(f"obs regress: {verdict}", file=out)
    return 1 if failures else 0
