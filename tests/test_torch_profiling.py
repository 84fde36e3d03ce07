"""The port's ``utils/profiling.py`` on ``torch.profiler``, on the CPU: a
trace of a region lands as ``*.trace.json.gz`` and the summaries read it
back; device events are summed and grouped from synthetic Chrome traces as
the card's profiler writes them; the timers and the memory readout; the
module's command."""

import gzip
import json
import os
import subprocess
import sys

import pytest
import torch

from distributed_sigmoid_loss_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_trace_writes_a_chrome_trace_the_summary_reads(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path / "cap")) as prof:
        for _ in range(3):
            x = torch.mm(x, x).relu_()
    files = [f for f in os.listdir(tmp_path / "cap") if f.endswith(".trace.json.gz")]
    assert len(files) == 1
    assert profiling.device_events(prof) == {}  # no device here
    tracks = profiling.summarize_trace(str(tmp_path / "cap"))
    rows = [row for rows in tracks.values() for row in rows]
    assert any(fam == "aten::mm" for fam, _, _ in rows)
    assert all(0.0 <= share <= 1.0 for _, _, share in rows)
    dev = profiling.summarize_device_ops(str(tmp_path / "cap"))
    assert dev == {"categories": [], "top_ops": [], "device_ms": 0}


def _device_trace(path, kernels):
    events = [{"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "GPU 0"}},
              {"ph": "M", "name": "thread_name", "pid": 0, "tid": 7,
               "args": {"name": "stream 7"}},
              # Host-side and flow events never count as device time.
              {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1,
               "tid": 1, "ts": 0.0, "dur": 50.0},
              {"ph": "s", "cat": "ac2g", "name": "flow", "pid": 0, "tid": 7, "ts": 0.0}]
    ts = 0.0
    for cat, name, dur in kernels:
        events.append({"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7, "ts": ts,
                       "dur": dur})
        ts += dur
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)


KERNELS = [("kernel", "void short_attention_fwd_kernel<64>(...)", 10.0)] * 12 + [
    ("kernel", "void short_attention_bwd_wgmma_kernel<1>(...)", 20.0),
    ("kernel", "void short_attention_bwd_batched_wgmma_kernel<64>(...)", 30.0),
    ("kernel", "flash_attention_fwd_kernel", 5.0),
    ("kernel", "nvjet_tst_192x192_64x4_2x1_v_bz_coopB_bias_TNN", 40.0),
    ("kernel", "sigmoid_loss_fwd_kernel<0>", 4.0),
    ("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 2.5),
    ("gpu_memset", "Memset (Device)", 0.5),
]


def test_device_ops_group_the_kernels_by_role(tmp_path):
    _device_trace(tmp_path / "a.trace.json.gz", KERNELS)
    dev = profiling.summarize_device_ops(str(tmp_path), top=3)
    groups = {name: (ms, n) for name, ms, _, n in dev["categories"]}
    assert groups == {
        "short_attention_fwd": (0.12, 12), "short_attention_bwd": (0.02, 1),
        "short_attention_bwd_batched": (0.03, 1), "flash_attention": (0.005, 1),
        "matmul": (0.04, 1), "other": (0.004, 1), "gpu_memcpy": (0.0025, 1),
        "gpu_memset": (0.0005, 1)}
    assert dev["device_ms"] == pytest.approx(0.222)
    assert sum(share for _, _, share, _ in dev["categories"]) == pytest.approx(1.0, abs=0.01)
    assert [name for name, _, _ in dev["top_ops"]] == [
        "void short_attention_fwd_kernel<64>(...)",
        "nvjet_tst_192x192_64x4_2x1_v_bz_coopB_bias_TNN",
        "void short_attention_bwd_batched_wgmma_kernel<64>(...)"]


def test_summaries_accumulate_across_files(tmp_path):
    _device_trace(tmp_path / "a.trace.json.gz", KERNELS[:6])
    os.makedirs(tmp_path / "sub")
    _device_trace(tmp_path / "sub" / "b.trace.json.gz", KERNELS[6:12])
    dev = profiling.summarize_device_ops(str(tmp_path))
    assert dev["categories"] == [("short_attention_fwd", 0.12, 1.0, 12)]
    tracks = profiling.summarize_trace(str(tmp_path))
    assert tracks["GPU 0/stream 7"] == [("void short_attention_fwd_kernel<64>(...)", 0.12, 1.0)]


@pytest.mark.parametrize("name,group", [
    ("void short_attention_fwd_kernel<64, true>", "short_attention_fwd"),
    ("short_attention_bwd_dq_wgmma_kernel", "short_attention_bwd"),
    ("short_attention_bwd_batched_in_place_kernel", "short_attention_bwd_batched"),
    ("flash_attention_bwd_dkv_kernel", "flash_attention"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32", "matmul"),
    ("cutlass_80_tensorop_s1688gemm", "matmul"),
    ("void at::native::vectorized_elementwise_kernel<4>", "other"),
])
def test_kernel_group(name, group):
    assert profiling.kernel_group(name) == group


def test_read_trace_files_refuses_an_empty_directory(tmp_path):
    with pytest.raises(FileNotFoundError, match="trace.json.gz"):
        list(profiling.read_trace_files(str(tmp_path)))


def test_time_step_and_throughput():
    calls = []

    def fn(x):
        calls.append(1)
        return {"out": [x * 2]}

    x = torch.ones(4)
    seconds = profiling.time_step(fn, x, warmup=2, iters=5)
    assert len(calls) == 7 and seconds >= 0.0
    assert profiling.throughput(fn, x, items_per_call=8, warmup=1, iters=2) > 0


def test_memory_stats_need_a_cuda_argument():
    assert profiling.compiled_memory_stats(lambda x: x * 2, torch.ones(3)) is None


def test_the_module_summarizes_a_directory(tmp_path):
    _device_trace(tmp_path / "a.trace.json.gz", KERNELS)
    cmd = [sys.executable, "-m", "distributed_sigmoid_loss_tpu_torch.utils.profiling",
           str(tmp_path), "4"]
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "== device time by kernel group (0.222 ms)" in out.stdout
    assert "short_attention_fwd" in out.stdout and "n=12" in out.stdout
    empty = subprocess.run(cmd[:-2] + [str(tmp_path / "none")], cwd=REPO, capture_output=True,
                           text=True, timeout=120)
    assert empty.returncode == 2
