"""Profiling and timing utilities on ``torch.profiler`` (the port of the JAX
package's ``utils/profiling.py``).

``trace(logdir)`` writes a Chrome trace (``*.trace.json.gz``) of the
enclosed region; ``summarize_trace`` and ``summarize_device_ops`` turn a
directory of such traces into the where-the-time-goes tables offline:
``python -m distributed_sigmoid_loss_tpu_torch.utils.profiling DIR``.

:func:`device_events` sums a finished profile's device events from the
profiler's raw events: ``key_averages()`` first builds the host's event tree
in Python, which takes tens of seconds for a step of 10^5 kernels.
"""

from __future__ import annotations

import contextlib
import glob as _glob
import gzip
import json
import os
import re
import socket
import time
from collections import defaultdict
from typing import Callable

import torch

__all__ = [
    "KERNEL_GROUPS",
    "trace",
    "time_step",
    "throughput",
    "compiled_memory_stats",
    "device_events",
    "kernel_group",
    "read_trace_files",
    "summarize_trace",
    "summarize_device_ops",
]

# Substring of a device kernel's name -> its group: the attention kernels by
# role. First match wins (K3's name holds K2's, K2's holds K1's).
KERNEL_GROUPS = (
    ("flash_attention", "flash_attention"),  # K7: fwd, di, dkv and dq
    ("short_attention_bwd_batched", "short_attention_bwd_batched"),
    ("short_attention_bwd", "short_attention_bwd"),
    ("short_attention", "short_attention_fwd"),
)
_MATMUL_MARKS = ("gemm", "nvjet", "cutlass", "xmma")

# Chrome-trace categories of the events that occupy the device.
_DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def kernel_group(name: str) -> str:
    """The group of device kernel ``name``: an attention kernel's role
    (:data:`KERNEL_GROUPS`), ``"matmul"`` for a library's matrix product,
    else ``"other"`` (the loss kernels K4-K6 among them)."""
    low = name.lower()
    for key, group in KERNEL_GROUPS:
        if key in low:
            return group
    return "matmul" if any(t in low for t in _MATMUL_MARKS) else "other"


def _sync(out) -> None:
    """Wait for the device of the first tensor in ``out`` (CUDA only)."""
    stack = [out]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                torch.cuda.synchronize(x.device)
            return
        if isinstance(x, dict):
            stack.extend(reversed(list(x.values())))
        elif isinstance(x, (list, tuple)):
            stack.extend(reversed(x))


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a ``torch.profiler`` trace of the enclosed region (host
    operators, and the device's kernels where CUDA is available) into
    ``logdir`` as ``<host>.<pid>.<ns>.trace.json.gz``, which ui.perfetto.dev
    opens. Yields the profile."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if cuda:
                torch.cuda.synchronize()
    name = f"{socket.gethostname()}.{os.getpid()}.{time.time_ns()}.trace.json.gz"
    prof.export_chrome_trace(os.path.join(logdir, name))


def time_step(fn: Callable, *args, warmup: int = 3, iters: int = 10) -> float:
    """Wall-clock seconds per call of ``fn(*args)``, warmup excluded, the
    device's work waited for (``torch.cuda.synchronize`` on the outputs'
    device)."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _sync(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _sync(out)
    return (time.perf_counter() - t0) / iters


def throughput(fn: Callable, *args, items_per_call: int, **kw) -> float:
    """Items a second of ``fn`` (e.g. image-text pairs a second of a train
    step)."""
    return items_per_call / time_step(fn, *args, **kw)


def compiled_memory_stats(fn, *args) -> dict | None:
    """The device memory of one call of ``fn(*args)``: eager PyTorch has no
    compiled executable to analyse, so this is the caching allocator's peak
    during the call (``reset_peak_memory_stats`` / ``max_memory_allocated``).
    ``peak_bytes`` is the peak, ``temp_size_in_bytes`` the peak above what
    was allocated before the call, ``output_size_in_bytes`` what the call
    left allocated. None when no argument lies on a CUDA device."""
    device = next((a.device for a in args if isinstance(a, torch.Tensor) and a.is_cuda), None)
    if device is None:
        return None
    torch.cuda.synchronize(device)
    before = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    out = fn(*args)
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device)
    after = torch.cuda.memory_allocated(device)
    del out
    return {
        "argument_size_in_bytes": before,
        "output_size_in_bytes": after - before,
        "temp_size_in_bytes": peak - before,
        "peak_bytes": peak,
    }


def device_events(prof) -> dict[str, list]:
    """``{name: [calls, device us]}`` of the device events ``prof`` (a
    finished ``torch.profiler.profile``) recorded, summed as
    ``key_averages()`` sums its device rows (an event on the device counts its
    span, an asynchronous one nothing), from the profiler's raw events."""
    from torch.autograd import DeviceType

    rows: dict[str, list] = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.is_async() \
                or e.start_thread_id() != e.end_thread_id() \
                or getattr(e, "is_hidden_event", lambda: False)():
            continue
        row = rows.setdefault(e.name(), [0, 0.0])
        row[0] += 1
        row[1] += (e.end_ns() - e.start_ns()) / 1e3
    return rows


# -- offline trace summarization ----------------------------------------------

# "aten::mm" stays; "ProfilerStep#3", "fusion.12" -> their family.
_OP_ID_RE = re.compile(r"^%?([A-Za-z0-9_:\-]+?)(?:[._#]\d+)*$")


def _op_family(name: str) -> str:
    m = _OP_ID_RE.match(name)
    return m.group(1) if m else name


def read_trace_files(logdir: str):
    """Yield each ``*.trace.json.gz`` file's events under ``logdir``, one
    file at a time (a whole-step capture is hundreds of MB of JSON)."""
    paths = sorted(
        _glob.glob(os.path.join(logdir, "**", "*.trace.json.gz"), recursive=True)
    )
    if not paths:
        raise FileNotFoundError(f"no *.trace.json.gz under {logdir!r}")
    for path in paths:
        with gzip.open(path, "rt") as f:
            yield json.load(f).get("traceEvents", [])


def summarize_trace(logdir: str, top: int = 15) -> dict:
    """Per-track operation time of the :func:`trace` captures under
    ``logdir``: ``{"process/thread": [(op_family, total_ms, share), ...]}``,
    up to ``top`` rows a track, shares of that track's total. Tracks are
    (pid, tid): a device's streams and the host's threads apart. Host
    operators nest (``aten::linear`` holds its ``aten::addmm``), so treat a
    host track's totals as upper bounds."""
    acc = _TrackAccum()
    for events in read_trace_files(logdir):
        acc.add(events)
    return acc.finalize(top)


class _TrackAccum:
    """Streaming accumulator behind :func:`summarize_trace`."""

    def __init__(self):
        self.pid_names: dict = {}
        self.tid_names: dict = {}
        self.totals: dict = defaultdict(lambda: defaultdict(float))

    def add(self, events) -> None:
        for ev in events:
            if ev.get("ph") == "M" and ev.get("name") == "process_name":
                self.pid_names[ev.get("pid")] = ev.get("args", {}).get("name", "?")
            elif ev.get("ph") == "M" and ev.get("name") == "thread_name":
                self.tid_names[(ev.get("pid"), ev.get("tid"))] = ev.get(
                    "args", {}
                ).get("name", "?")
        for ev in events:
            if ev.get("ph") == "X" and "dur" in ev and ev.get("name"):
                key = (ev.get("pid"), ev.get("tid"))
                track = (
                    f"{self.pid_names.get(ev.get('pid'), ev.get('pid'))}/"
                    f"{self.tid_names.get(key, ev.get('tid'))}"
                )
                self.totals[track][_op_family(ev["name"])] += ev["dur"] / 1000.0

    def finalize(self, top: int) -> dict:
        out = {}
        for track, fams in self.totals.items():
            track_total = sum(fams.values())
            rows = sorted(fams.items(), key=lambda kv: -kv[1])[:top]
            out[track] = [
                (fam, round(ms, 3),
                 round(ms / track_total, 3) if track_total else 0.0)
                for fam, ms in rows
            ]
        return out


def summarize_device_ops(logdir: str, top: int = 12) -> dict:
    """The device's time in the :func:`trace` captures under ``logdir``, by
    kernel group and by kernel.

    Returns ``{"categories": [(group, ms, share, launches), ...], "top_ops":
    [(name, ms, launches), ...], "device_ms": total}``: the groups of
    :func:`kernel_group` (K1, K2, K3, K7, library matrix products, the
    rest), and the ``top`` kernels by time.
    Device events are the kernels, copies and fills (``cat`` ``kernel``,
    ``gpu_memcpy``, ``gpu_memset``), as :func:`device_events` counts them.
    """
    acc = _DeviceOpAccum()
    for events in read_trace_files(logdir):
        acc.add(events)
    return acc.finalize(top)


class _DeviceOpAccum:
    """Streaming accumulator behind :func:`summarize_device_ops`."""

    def __init__(self):
        self.cat = defaultdict(lambda: [0.0, 0])  # ms, launches
        self.ops = defaultdict(lambda: [0.0, 0])

    def add(self, events) -> None:
        for ev in events:
            if ev.get("ph") != "X" or "dur" not in ev \
                    or ev.get("cat") not in _DEVICE_CATEGORIES:
                continue
            ms = ev["dur"] / 1000.0
            name = ev.get("name", "?")
            group = kernel_group(name) if ev["cat"] == "kernel" else ev["cat"]
            for row in (self.cat[group], self.ops[name]):
                row[0] += ms
                row[1] += 1

    def finalize(self, top: int) -> dict:
        total = sum(ms for ms, _ in self.cat.values())
        categories = [
            (name, round(ms, 6), round(ms / total, 3) if total else 0.0, n)
            for name, (ms, n) in sorted(self.cat.items(), key=lambda kv: -kv[1][0])
        ]
        top_ops = [
            (name, round(ms, 6), n)
            for name, (ms, n) in sorted(self.ops.items(), key=lambda kv: -kv[1][0])[:top]
        ]
        return {"categories": categories, "top_ops": top_ops, "device_ms": total}


def print_device_ops(dev: dict) -> None:
    """Print :func:`summarize_device_ops`'s tables (``obs summarize`` and
    this module's command)."""
    print(f"\n== device time by kernel group ({dev['device_ms']:.3f} ms)")
    print(f"  {'group':<30}{'ms':>12}{'share':>8}{'launches':>10}")
    for name, ms, share, n in dev["categories"]:
        print(f"  {name:<30}{ms:>12.3f}{share:>8.1%}{n:>10}")
    print("\n== top device kernels")
    for name, ms, n in dev["top_ops"]:
        print(f"  {name[:60]:<62}{ms:>10.3f} ms  n={n}")


def _main() -> int:
    import sys

    if len(sys.argv) < 2:
        print("usage: python -m distributed_sigmoid_loss_tpu_torch.utils.profiling "
              "TRACE_DIR [TOP_N]", file=sys.stderr)
        return 2
    top = int(sys.argv[2]) if len(sys.argv) > 2 else 15
    # One pass: each file is parsed once and fed to both accumulators.
    tracks, device = _TrackAccum(), _DeviceOpAccum()
    try:
        for events in read_trace_files(sys.argv[1]):
            tracks.add(events)
            device.add(events)
    except FileNotFoundError as e:
        print(e, file=sys.stderr)
        return 2
    for track, rows in tracks.finalize(top).items():
        print(f"\n== {track}")
        for fam, ms, share in rows:
            print(f"  {fam[:40]:<40} {ms:>10.3f} ms  {share:>6.1%}")
    dev = device.finalize(top)
    if dev["categories"]:
        print_device_ops(dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
