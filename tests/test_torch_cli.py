"""The port's command line (``cli.py``: ``train``, ``eval``, ``tokenizer``)
on the CPU (``--cpu-devices 1``), in process, beside the JAX package's CLI.

- ``train --tiny`` exits 0 and its JSON lines carry the JAX CLI's keys, the
  static attribution's (``OBS_ONLY``) among them.
- ``--ckpt-dir``: a run stopped at step 2 resumes to 4 and ends where an
  uninterrupted run does, bit for bit; ``eval`` restores it with and without
  ``--ema`` (the EMA weights are the ones evaluated), and refuses ``--ema``
  on a checkpoint without them.
- ``obs regress`` and ``obs ledger --backfill`` exit 2 saying why; the
  adaptive compression and MoE flags refuse incoherent sets with JAX's
  messages and run on gloo ranks, every rank printing the same lines;
  without ``--cpu-devices 1`` and without CUDA the commands exit non-zero.
- ``tokenizer`` writes the JAX command's vocab JSON byte for byte.

The JAX CLI runs twice in this file (one train, one tokenizer), each in a
module-scoped fixture.
"""

import ast
import contextlib
import io
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from distributed_sigmoid_loss_tpu import cli as jax_cli
from distributed_sigmoid_loss_tpu_torch import cli
from distributed_sigmoid_loss_tpu_torch import eval as port_eval
from distributed_sigmoid_loss_tpu_torch.data import BpeTokenizer, SyntheticImageText
from distributed_sigmoid_loss_tpu_torch.models import SigLIP
from distributed_sigmoid_loss_tpu_torch.utils.config import SigLIPConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OBS_ONLY = {"mfu_est", "comm_bytes_total"}
TINY = ["--tiny", "--cpu-devices", "1", "--batch", "8"]
CORPUS = ["a photo of a cat", "a photo of a dog", "the cat and the dog", "a cat photo",
          "dog photo of a dog", "ünïcödé caption"]


def run(argv):
    """``cli.main(argv)`` in process: (exit code, stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = cli.main(argv)
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue(), err.getvalue()


def json_lines(stdout):
    return [json.loads(line) for line in stdout.splitlines() if line.startswith("{\"step\"")]


@pytest.fixture(scope="module")
def jax_train_lines():
    """The JAX CLI's train lines (on this process's CPU mesh)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        rc = jax_cli.main(["train", "--tiny", "--steps", "2", "--batch", "8", "--eval-every", "2",
                           "--watchdog", "off"])
    assert rc == 0
    return json_lines(out.getvalue())


def test_train_exits_0_with_the_jax_clis_keys(jax_train_lines):
    rc, out, err = run(["train", *TINY, "--steps", "2", "--eval-every", "2"])
    assert rc == 0, err
    lines = json_lines(out)
    want = [set(line) for line in jax_train_lines]
    assert [set(line) for line in lines] == want
    assert OBS_ONLY <= set(lines[0])
    assert all(np.isfinite(v) for line in lines for v in line.values())
    assert {"i2t_recall@1", "t2i_recall@5"} <= set(ast.literal_eval(err.strip().splitlines()[-1]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A run stopped at step 2 and resumed to 4 (EMA on, asynchronous
    saves), an uninterrupted 4-step run, and a 2-step run without EMA."""
    root = tmp_path_factory.mktemp("cli")
    common = ["train", *TINY, "--ema-decay", "0.9", "--eval-every", "2", "--accum", "2",
              "--accum-bf16"]
    out = {"split": str(root / "split"), "whole": str(root / "whole"), "bare": str(root / "bare")}
    out["first"] = run([*common, "--steps", "2", "--ckpt-every", "2", "--ckpt-dir", out["split"],
                        "--async-checkpoint"])
    out["rest"] = run([*common, "--steps", "4", "--ckpt-every", "2", "--ckpt-dir", out["split"],
                       "--async-checkpoint"])
    out["uninterrupted"] = run([*common, "--steps", "4", "--ckpt-every", "4", "--ckpt-dir",
                                out["whole"]])
    out["no_ema"] = run(["train", *TINY, "--steps", "2", "--ckpt-every", "2", "--ckpt-dir",
                         out["bare"]])
    return out


def _report(stderr):
    return re.search(r"resilient loop: steps (\d+)->(\d+), checkpoints at (\[.*\])",
                     stderr).groups()


def test_resume_through_ckpt_dir_equals_an_uninterrupted_run(runs):
    for name in ("first", "rest", "uninterrupted", "no_ema"):
        assert runs[name][0] == 0, runs[name][2]
    assert _report(runs["first"][2]) == ("0", "2", "[2]")
    assert _report(runs["rest"][2]) == ("2", "4", "[2, 4]")
    assert _report(runs["uninterrupted"][2]) == ("0", "4", "[4]")
    split = json_lines(runs["first"][1]) + json_lines(runs["rest"][1])
    whole = json_lines(runs["uninterrupted"][1])
    for a, b in zip(split, whole):
        assert a["step"] == b["step"]
        for k in a.keys() - {"steps_per_sec", "input_wait_frac"}:
            assert a[k] == b[k], (a["step"], k)
    got = torch.load(os.path.join(runs["split"], "step_00000004", "tensors.pt"))
    want = torch.load(os.path.join(runs["whole"], "step_00000004", "tensors.pt"))
    assert got.keys() == want.keys() and any(k.startswith("ema.") for k in got)
    assert all(torch.equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("ema", [False, True])
def test_eval_restores_the_checkpoint(runs, monkeypatch, ema):
    seen = []
    metrics = port_eval.retrieval_metrics
    monkeypatch.setattr(port_eval, "retrieval_metrics",
                        lambda zi, zt, **kw: seen.append(zi) or metrics(zi, zt, **kw))
    rc, out, err = run(["eval", "--tiny", "--cpu-devices", "1", "--batch", "8", "--ckpt-dir",
                        runs["split"], *(["--ema"] if ema else [])])
    assert rc == 0, err
    assert f"restored step 4 ({'ema' if ema else 'params'})" in err
    result = ast.literal_eval(out.strip().splitlines()[-1])
    assert set(result) == {"i2t_recall@1", "t2i_recall@1", "i2t_recall@5", "t2i_recall@5",
                           "zeroshot_top@1", "zeroshot_top@5"}
    assert all(0.0 <= v <= 1.0 for v in result.values())
    # The evaluated image embeddings are those of the checkpoint's weights.
    stored = torch.load(os.path.join(runs["split"], "step_00000004", "tensors.pt"))
    cfg = SigLIPConfig.tiny_test()
    model = SigLIP(cfg, device="cpu")
    prefix = "ema." if ema else "model."
    model.load_state_dict({k[len(prefix):]: v for k, v in stored.items() if k.startswith(prefix)})
    batch = next(iter(SyntheticImageText(cfg, 8, image_seed=7, text_seed=9)))
    with torch.no_grad():
        assert torch.equal(seen[0], model.encode_image(batch["images"]))


def test_eval_refuses_ema_on_a_checkpoint_without_it(runs):
    rc, _, err = run(["eval", "--tiny", "--cpu-devices", "1", "--batch", "8", "--ckpt-dir",
                      runs["bare"], "--ema"])
    assert rc == 2 and "has no EMA weights" in err
    rc, _, err = run(["eval", "--tiny", "--cpu-devices", "1", "--ema"])
    assert rc == 2 and "--ema requires --ckpt-dir" in err
    rc, _, err = run(["eval", "--tiny", "--cpu-devices", "1", "--ckpt-dir", runs["bare"] + "x"])
    assert rc == 2 and "no checkpoint found" in err


# ``obs regress`` runs since ROADMAP.md queue A item 6.5 part 2
# (tests/test_torch_regress.py): here, its refusal of a fake world it cannot
# trace the step configs in.
REFUSED = [
    (["obs", "regress", "--cpu-devices", "3"],
     "the step configs are traced in an even world of >= 4 ranks"),
    (["obs", "ledger", "--backfill"], "the port's ledger has no backfill"),
]


@pytest.mark.parametrize("argv,why", REFUSED, ids=[" ".join(a[:2 + (a[1] == "ledger")])
                                                   for a, _ in REFUSED])
def test_obs_refuses_what_the_port_has_not(argv, why):
    rc, out, err = run(argv)
    assert rc == 2 and why in err
    assert out == ""


# The gradient-sync flags that run since ID 6.3 part 1, on one process: the
# incoherent sets exit 2 with JAX's messages.
SYNC_REFUSED = [
    (["--grad-compression", "int8"], "--grad-compression requires: --dcn-slices >= 2"),
    (["--grad-compression", "topk", "--dcn-slices", "2", "--topk-frac", "1.5"],
     "--topk-frac in (0, 1], got 1.5"),
    (["--grad-compression", "int8", "--dcn-slices", "2", "--variant", "ring"],
     "--variant all_gather or unset"),
    (["--grad-compression", "int8", "--dcn-slices", "2", "--ema-decay", "0.9"],
     "no --ema-decay"),
    (["--topk-frac", "0.1"], "--topk-frac without --grad-compression topk"),
    (["--topk-exact"], "--topk-exact without --grad-compression topk"),
    (["--dcn-slices", "2"], "--dcn-slices without --grad-compression is a silent no-op"),
    (["--zero1", "--update-sharding", "full"], "--zero1 is the deprecated alias"),
    (["--update-sharding", "full"], "update_sharding='full' requires a dp axis of size > 1"),
    (["--dcn-slices", "3", "--grad-compression", "int8"], "--dcn-slices 3 x --pp 1 must divide"),
]


@pytest.mark.parametrize("flags,match", SYNC_REFUSED, ids=[" ".join(f) for f, _ in SYNC_REFUSED])
def test_train_sync_flags_refuse_like_jax(flags, match):
    rc, out, err = run(["train", *TINY, *flags])
    assert rc == 2 and match in err, err
    assert out == ""


@pytest.mark.parametrize("flags", [f for f, _ in SYNC_REFUSED[:-2]],
                         ids=[" ".join(f) for f, _ in SYNC_REFUSED[:-2]])
def test_sync_refusals_are_jax_messages(flags):
    """JAX's train exits 2 with the same last line for the same flags (the
    last two refusals are the port's: its grid is the run's processes)."""
    err = io.StringIO()
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(err):
        want_rc = jax_cli.main(["train", "--tiny", "--batch", "8", *flags])
    rc, _, got = run(["train", *TINY, *flags])
    assert want_rc == rc == 2
    assert got.strip().splitlines()[-1] == err.getvalue().strip().splitlines()[-1]


@pytest.mark.parametrize("flags", [["--zero1"], ["--update-sharding", "zero1"],
                                   ["--force-dcn-emulation"]])
def test_train_sync_flags_run_on_one_process(flags):
    """zero1 on a dp axis of one rank shards nothing; --force-dcn-emulation
    alone is JAX's no-op. The metrics lines of a sharded update carry its
    mode and the optimizer's bytes."""
    rc, out, err = run(["train", *TINY, "--steps", "2", *flags])
    assert rc == 0, err
    lines = json_lines(out)
    assert len(lines) == 2 and all(np.isfinite(line["loss"]) for line in lines)
    if "--force-dcn-emulation" not in flags:
        assert {line["update_sharding"] for line in lines} == {"zero1"}
        assert all(line["opt_mem_bytes_per_replica"] > 0 for line in lines)


def test_train_compressed_and_sharded_on_gloo_ranks(tmp_path):
    """``train --dcn-slices 2 --grad-compression int8|topk`` on four gloo
    ranks (a (dcn, dp) = (2, 2) grid), and ``--update-sharding full`` on two
    (dp = 2; with int8 compression on four): every rank exits 0 with the
    same finite metrics lines; the compressed ones carry the dcn wire
    bytes, the sharded ones the mode and the optimizer's bytes."""
    import _torch_compression_workers as cw
    import _torch_dist_worker as worker

    base = ["train", *TINY, "--steps", "2", "--log-every", "1"]
    runs = [("int8", base + ["--dcn-slices", "2", "--grad-compression", "int8"]),
            ("topk", base + ["--dcn-slices", "2", "--grad-compression", "topk",
                             "--topk-frac", "0.05", "--topk-exact"]),
            ("int8_full", base + ["--dcn-slices", "2", "--grad-compression", "int8",
                                  "--update-sharding", "full"]),
            ("full4", base + ["--update-sharding", "full", "--variant", "all_gather"])]
    ranks = worker.spawn(cw.cli_worker, 4, (runs,), tmp_path, timeout_s=240)
    for name, _ in runs:
        assert all(rec[name]["rc"] == 0 for rec in ranks), ranks[0][name]["stderr"]
        # Each rank's own timing aside, every rank prints the same lines.
        timing = ("input_wait_frac", "steps_per_sec")
        lines = [[{k: v for k, v in line.items() if k not in timing}
                  for line in rec[name]["lines"]] for rec in ranks]
        assert all(len(ls) == 2 and ls == lines[0] for ls in lines), name
        for line in lines[0]:
            assert np.isfinite(line["loss"]) and np.isfinite(line["grad_norm"])
            if name != "full4":
                assert line["dcn_wire_bytes"] > 0 and line["ef_norm"] >= 0
            if "full" in name:
                assert line["update_sharding"] == "full"
    assert (ranks[0]["topk"]["lines"][0]["dcn_wire_bytes"]
            < ranks[0]["int8"]["lines"][0]["dcn_wire_bytes"])


def test_train_adaptive_and_moe_on_gloo_ranks(tmp_path):
    """``train --dcn-slices 2 --grad-compression adaptive|learned`` (with
    ``--dcn-budget-mbps``, ``--controller budgeted``, ``--emu-dcn-mbps``)
    and ``train --moe-experts 4`` on four gloo ranks: every rank exits 0
    with the same lines but for its own timing (``steps_per_sec``,
    ``input_wait_frac``, ``dcn_bw_est_mbps``, ``dcn_measured_mbps``,
    ``wire_savings_wallclock_ratio``); the adaptive lines carry JAX's wire
    accounting and controller fields, and a starved budget narrows the
    wire by the second step."""
    import _torch_compression_workers as cw
    import _torch_dist_worker as worker

    base = ["train", *TINY, "--steps", "3", "--log-every", "1", "--dcn-slices", "2"]
    runs = [("adaptive", base + ["--grad-compression", "adaptive", "--dcn-budget-mbps", "0.05"]),
            ("learned", base + ["--grad-compression", "learned", "--controller", "budgeted",
                                "--dcn-budget-mbps", "0.05"]),
            ("emu", base + ["--grad-compression", "adaptive", "--emu-dcn-mbps", "50"]),
            ("moe", ["train", *TINY, "--steps", "2", "--moe-experts", "4",
                     "--moe-group-size", "8"])]
    ranks = worker.spawn(cw.cli_worker, 4, (runs,), tmp_path, timeout_s=240)
    timing = ("input_wait_frac", "steps_per_sec", "dcn_bw_est_mbps", "dcn_measured_mbps",
              "wire_savings_wallclock_ratio")
    for name, _ in runs:
        assert all(rec[name]["rc"] == 0 for rec in ranks), ranks[0][name]["stderr"]
        lines = [[{k: v for k, v in line.items() if k not in timing}
                  for line in rec[name]["lines"]] for rec in ranks]
        assert all(ls == lines[0] for ls in lines), name
        assert len(lines[0]) == (2 if name == "moe" else 3)
    for name in ("adaptive", "learned", "emu"):
        recs = ranks[0][name]["lines"]
        for line in recs:
            assert len(line["compression_scheme_hist"]) == 6
            for field in ("dcn_wire_bytes", "bits_per_param", "ef_residual_norm",
                          "dcn_bw_est_mbps", "controller_mode", "error_budget"):
                assert field in line, (name, field)
        if name != "emu":
            assert recs[1]["bits_per_param"] < recs[0]["bits_per_param"], name
    assert {line["controller_mode"] for line in ranks[0]["learned"]["lines"]} == {"budgeted"}
    assert all("codec_recon_err" in line for line in ranks[0]["learned"]["lines"])
    for line in ranks[0]["emu"]["lines"]:
        assert line["dcn_measured_mbps"] > 0 and line["wire_savings_wallclock_ratio"] > 0
    for line in ranks[0]["moe"]["lines"]:
        assert np.isfinite(line["loss"]) and line["moe_aux"] > 0


@pytest.mark.parametrize("flags", [["--moe-experts", "4"]])
def test_eval_runs_the_moe_towers(flags):
    """``eval --moe-experts`` (ported since) scores MoE towers, JAX's keys."""
    rc, out, err = run(["eval", "--tiny", "--cpu-devices", "1", "--batch", "8", *flags])
    assert rc == 0, err
    rec = ast.literal_eval(out.strip().splitlines()[-1])
    assert {"i2t_recall@1", "t2i_recall@1", "zeroshot_top@1"} <= rec.keys()


# The adaptive compression and MoE flags (ported since) on one process: the
# The pipeline, expert-parallel and multi-process flags (ID 6.4 part 2): the
# incoherent sets exit 2 as JAX's do, with JAX's last line where the
# refusal does not depend on the device count (JAX's CLI sees 8 virtual
# devices here, the port's grid the run's one process).
PP_EP_REFUSED = [
    (["--ep", "0"], True),
    (["--pp", "2", "--moe-experts", "4"], True),
    (["--pp", "2", "--ep", "2", "--moe-experts", "4"], True),
    (["--pp", "2", "--update-sharding", "zero1"], True),
    (["--pp", "2", "--zero1"], True),
    (["--pp-microbatches", "4"], True),
    (["--pp", "2", "--pp-microbatches", "-1"], True),
    (["--pp", "2", "--accum", "2", "--accum-negatives", "global"], True),
    (["--grad-compression", "int8", "--dcn-slices", "2", "--ep", "2"], True),
    (["--grad-compression", "adaptive", "--dcn-slices", "2", "--pp", "2"], True),
    (["--ep", "2"], True),
    (["--ep", "3", "--moe-experts", "4"], False),
    (["--ep", "3", "--moe-experts", "6"], False),
    (["--pp", "3"], False),
]


@pytest.mark.parametrize("flags,same_words", PP_EP_REFUSED,
                         ids=[" ".join(f) for f, _ in PP_EP_REFUSED])
def test_pp_ep_flags_refuse_like_jax(flags, same_words):
    err = io.StringIO()
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(err):
        want_rc = jax_cli.main(["train", "--tiny", "--batch", "8", *flags])
    rc, out, got = run(["train", *TINY, *flags])
    assert want_rc == rc == 2 and out == ""
    assert "6.4" not in got
    if same_words:
        assert got.strip().splitlines()[-1] == err.getvalue().strip().splitlines()[-1]


# incoherent sets exit with JAX's messages and codes.
LADDER_REFUSED = [
    ["--grad-compression", "adaptive"], ["--grad-compression", "learned"],
    ["--dcn-budget-mbps", "100"], ["--controller", "greedy"], ["--emu-dcn-mbps", "100"],
    ["--moe-aux-weight", "0.01"], ["--moe-group-size", "64"], ["--moe-experts", "1"],
    ["--grad-compression", "adaptive", "--dcn-slices", "2", "--topk-frac", "1.5"],
]


@pytest.mark.parametrize("flags", LADDER_REFUSED, ids=[" ".join(f) for f in LADDER_REFUSED])
def test_ladder_and_moe_flags_refuse_like_jax(flags):
    err = io.StringIO()
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(err):
        try:
            want_rc = jax_cli.main(["train", "--tiny", "--batch", "8", *flags])
        except SystemExit as e:  # _model_config's refusals
            want_rc = e.code
    rc, out, got = run(["train", *TINY, *flags])
    assert rc == want_rc and out == ""
    if isinstance(want_rc, str):
        return
    assert want_rc == 2
    assert got.strip().splitlines()[-1] == err.getvalue().strip().splitlines()[-1]


@pytest.mark.parametrize("flags,match", [
    (["--accum-bf16"], "--accum-bf16 requires --accum > 1"),
    (["--watchdog", "skip"], "--watchdog skip requires --ckpt-dir"),
    (["--async-checkpoint"], "--async-checkpoint without --ckpt-dir"),
    (["--loss-impl", "chunked", "--variant", "ring"], "--loss-impl chunked applies"),
    (["--use-pallas", "--loss-family", "softmax"], "--use-pallas applies"),
    (["--cpu-devices", "2"], "--cpu-devices 2"),
])
def test_train_refuses_incoherent_flags(flags, match):
    rc, _, err = run(["train", "--tiny", "--cpu-devices", "1", *flags])
    assert rc == 2 and match in err


# The real-data flags' refusals, JAX's exits: (command, flags); "{d}" is a
# directory that exists.
DATA_EXITS = [
    ("train", ["--data-dir", "{d}", "--data-shards", "{d}/*.tar"]),
    ("train", ["--data-dir", "{d}", "--native-data"]),
    ("train", ["--data-shards", "{d}/*.tar", "--native-data"]),
    ("train", ["--shuffle-buffer", "8"]),
    ("train", ["--data-dir", "{d}", "--shuffle-buffer", "8"]),
    ("train", ["--native-decode"]),
    ("train", ["--native-decode", "--native-data"]),
    ("train", ["--data-shards", "{d}/none-*.tar"]),
    ("train", ["--data-workers", "-2"]),
    ("train", ["--eval-data", "{d}"]),
    ("train", ["--eval-data", "{d}/none-*.tar", "--eval-every", "2"]),
    ("eval", ["--data-dir", "{d}", "--data-shards", "{d}/*.tar"]),
    ("eval", ["--data-shards", "{d}/none-*.tar"]),
]


@pytest.mark.parametrize("command,flags", DATA_EXITS,
                         ids=[f"{c} {' '.join(f)}" for c, f in DATA_EXITS])
def test_real_data_flags_exit_2_with_jaxs_message(tmp_path, command, flags):
    flags = [f.format(d=tmp_path) for f in flags]
    err = io.StringIO()
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(err):
        want_rc = jax_cli.main([command, "--tiny", "--batch", "8", *flags])
    want = err.getvalue().strip().splitlines()[-1]
    rc, out, got = run([command, "--tiny", "--cpu-devices", "1", "--batch", "8", *flags])
    assert want_rc == rc == 2 and out == ""
    assert got.strip().splitlines()[-1] == want


@pytest.mark.parametrize("command", ["train", "eval", "data-bench"])
def test_cpu_devices_above_1_exits_2(command):
    rc, out, err = run([command, "--cpu-devices", "2"])
    assert rc == 2 and out == ""
    assert ("--cpu-devices 2: the port emulates no multi-device mesh; pass --cpu-devices 1 "
            "(one process on the CPU)") in err


@pytest.mark.parametrize("command", [["train", "--tiny"], ["eval", "--tiny"]])
def test_commands_without_cuda_exit_nonzero(monkeypatch, command):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, err = run(command)
    assert rc != 0 and "CUDA is not available" in err and out == ""


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    (root / "captions.txt").write_text("\n".join(CORPUS + ["", "  "]) + "\n", encoding="utf-8")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert jax_cli.main(["tokenizer", str(root / "jax.json"), "--text-file",
                             str(root / "captions.txt"), "--vocab-size", "300"]) == 0
    return root


def test_tokenizer_writes_the_jax_commands_vocab(corpus):
    rc, out, err = run(["tokenizer", str(corpus / "port.json"), "--text-file",
                        str(corpus / "captions.txt"), "--vocab-size", "300"])
    assert rc == 0, err
    assert (corpus / "port.json").read_bytes() == (corpus / "jax.json").read_bytes()
    assert "merges" in out
    rc, _, err = run(["tokenizer", str(corpus / "x.json")])
    assert rc == 2 and "exactly one of" in err


def test_tokenizer_reads_a_caption_directory_and_train_stashes_it(corpus, tmp_path):
    for i, text in enumerate(CORPUS):
        (tmp_path / f"{i}.txt").write_text(text, encoding="utf-8")
    proc = subprocess.run([sys.executable, "-m", "distributed_sigmoid_loss_tpu_torch",
                           "tokenizer", str(tmp_path / "vocab.json"), "--data-dir",
                           str(tmp_path), "--vocab-size", "280"],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    ckpt_dir = tmp_path / "ck"
    rc, _, err = run(["train", *TINY, "--steps", "1", "--ckpt-every", "1", "--ckpt-dir",
                      str(ckpt_dir), "--tokenizer", str(tmp_path / "vocab.json")])
    assert rc == 0, err
    stash = ckpt_dir / "tokenizer.json"
    assert stash.read_bytes() == (tmp_path / "vocab.json").read_bytes()
    rc, _, err = run(["eval", "--tiny", "--cpu-devices", "1", "--batch", "8", "--ckpt-dir",
                      str(ckpt_dir)])
    assert rc == 0 and f"using checkpoint tokenizer {stash}" in err
    BpeTokenizer([(100, 101)]).save(str(tmp_path / "other.json"))
    rc, _, err = run(["eval", "--tiny", "--cpu-devices", "1", "--batch", "8", "--ckpt-dir",
                      str(ckpt_dir), "--tokenizer", str(tmp_path / "other.json")])
    assert rc == 0 and "differs from the checkpoint's stashed vocab" in err
