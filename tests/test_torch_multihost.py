"""Multi-process start-up (``parallel/multihost.py``, ``train
--coordinator/--num-processes/--process-id``) on the CPU.

- ``initialize_multihost()`` in a process with no launcher variables is
  the one-process no-op, and a partial launcher environment refuses to
  degrade to one process (JAX's rule).
- ``make_hybrid_mesh`` and ``global_batch_for`` on one process.
- Two CPU processes started through ``cli.main(["train", "--coordinator",
  "127.0.0.1:<free port>", ...])`` (gloo, a TCP rendezvous) print the same
  losses as the same command on two gloo ranks joined beforehand.
- ``--coordinator``'s refusals exit as JAX's do.
"""

import contextlib
import io
import socket

import numpy as np
import pytest

import _torch_compression_workers as cw
import _torch_dist_worker as worker
import _torch_pp_ep_workers as ppw
from distributed_sigmoid_loss_tpu import cli as jax_cli
from distributed_sigmoid_loss_tpu_torch import cli
from distributed_sigmoid_loss_tpu_torch.parallel import multihost
from distributed_sigmoid_loss_tpu_torch.parallel.mesh import is_distributed

TRAIN = ["train", "--tiny", "--cpu-devices", "1", "--batch", "8", "--steps", "3",
         "--log-every", "1"]


def test_single_process_call_is_a_noop(monkeypatch):
    for var in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize_multihost(device="cpu") == (0, 1)
    assert not is_distributed()
    grid = multihost.make_hybrid_mesh()
    assert grid.shape == {"dcn": 1, "dp": 1}
    assert multihost.global_batch_for(16, grid) == 16
    assert multihost.global_batch_for(16) == 16
    assert multihost.backend_for("cpu") == "gloo" and multihost.backend_for("cuda") == "nccl"


def test_partial_launcher_environment_refuses_to_train_alone(monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(RuntimeError, match="would train alone"):
        multihost.initialize_multihost(device="cpu")
    with pytest.raises(ValueError, match="needs num_processes"):
        multihost.initialize_multihost("127.0.0.1:1", device="cpu")
    assert not is_distributed()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_coordinator_run_matches_the_joined_gloo_run(tmp_path):
    for sub in ("coordinator", "joined"):
        (tmp_path / sub).mkdir()
    coordinated = worker.spawn(ppw.coordinator_worker, 2,
                               (TRAIN + ["--coordinator", f"127.0.0.1:{_free_port()}"],),
                               tmp_path / "coordinator", timeout_s=180)
    joined = worker.spawn(cw.cli_worker, 2, ([("train", TRAIN)],), tmp_path / "joined",
                          timeout_s=180)
    for a, b in zip(coordinated, joined):
        assert a["rc"] == 0, a["stderr"]
        assert b["train"]["rc"] == 0, b["train"]["stderr"]
        losses = [line["loss"] for line in a["lines"]]
        assert len(losses) == 3 and all(np.isfinite(losses))
        assert losses == [line["loss"] for line in b["train"]["lines"]]


COORDINATOR_REFUSED = [
    ["--coordinator", "127.0.0.1:1"],
    ["--coordinator", "127.0.0.1:1", "--num-processes", "2"],
    ["--coordinator", "127.0.0.1:1", "--num-processes", "3", "--process-id", "0"],
]


@pytest.mark.parametrize("flags", COORDINATOR_REFUSED,
                         ids=[" ".join(f) for f in COORDINATOR_REFUSED])
def test_coordinator_refusals_exit_like_jax(flags):
    err = io.StringIO()
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(err):
        want_rc = jax_cli.main(["train", "--tiny", "--batch", "8", *flags])
    got_err = io.StringIO()
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(got_err):
        rc = cli.main(["train", "--tiny", "--cpu-devices", "1", "--batch", "8", *flags])
    assert rc == want_rc == 2
    assert (got_err.getvalue().strip().splitlines()[-1]
            == err.getvalue().strip().splitlines()[-1])


def test_train_command_runs_pp_ep_and_compressed_pp_on_gloo_ranks(tmp_path):
    """The train command on four gloo ranks with ``--pp 2`` (a (dp, pp) =
    (2, 2) grid; ``--tiny``'s towers made scanned, as JAX's command does),
    ``--ep 2 --moe-experts 4`` ((dp, ep) = (2, 2)) and ``--dcn-slices 2
    --grad-compression int8 --pp 2`` ((dcn, dp, pp) = (2, 1, 2)): every rank
    exits 0 with the same finite metrics lines, and the first step's loss
    (before any update) is the same in the pp run and the plain run."""
    base = ["train", "--tiny", "--cpu-devices", "1", "--batch", "8", "--steps", "2",
            "--log-every", "1"]
    runs = [("plain", base), ("pp", base + ["--pp", "2"]),
            ("ep", base + ["--ep", "2", "--moe-experts", "4"]),
            ("pp_int8", base + ["--dcn-slices", "2", "--grad-compression", "int8",
                                "--pp", "2"])]
    ranks = worker.spawn(cw.cli_worker, 4, (runs,), tmp_path, timeout_s=240)
    timing = ("input_wait_frac", "steps_per_sec")
    for name, _ in runs:
        assert all(rec[name]["rc"] == 0 for rec in ranks), ranks[0][name]["stderr"]
        lines = [[{k: v for k, v in line.items() if k not in timing}
                  for line in rec[name]["lines"]] for rec in ranks]
        assert all(len(ls) == 2 and ls == lines[0] for ls in lines), name
        assert all(np.isfinite(line["loss"]) and np.isfinite(line["grad_norm"])
                   for line in lines[0])
    # --tiny is unrolled in the plain run, scanned under --pp: the same
    # weights either way (the layout is JAX's, not the port's), so the same
    # loss before the first update, over dp = 4 and over dp = 2 alike.
    np.testing.assert_allclose(ranks[0]["pp"]["lines"][0]["loss"],
                               ranks[0]["plain"]["lines"][0]["loss"], rtol=1e-5)
    assert ranks[0]["pp_int8"]["lines"][0]["dcn_wire_bytes"] > 0
