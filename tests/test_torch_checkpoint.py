"""The port's checkpoints (``train/checkpoint.py``): bitwise round trips of
train states (AdamW with a bf16 first moment and the EMA, Lion, Adafactor)
and of a dict of tensors, through the synchronous writer and through
``AsyncSaver``; the refusal of a mismatched target, naming every tensor;
atomic writes that ``latest_step`` never reads half-written; and
``AsyncSaver``'s contract: ``save`` returns once the host snapshot is taken,
``wait`` makes the write durable, and a second ``save`` queues behind the
first. On the CPU, with the tiny SigLIP configuration.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from distributed_sigmoid_loss_tpu_torch.models import SigLIP
from distributed_sigmoid_loss_tpu_torch.train import checkpoint as ckpt
from distributed_sigmoid_loss_tpu_torch.train import train_step as pts
from distributed_sigmoid_loss_tpu_torch.train.resilience import latest_step, save_step
from distributed_sigmoid_loss_tpu_torch.utils.config import LossConfig, SigLIPConfig, TrainConfig

OPTIMIZERS = {
    "adamw_bf16_mu_ema": (TrainConfig(warmup_steps=0, adam_mu_dtype="bfloat16"), True),
    "lion": (TrainConfig(warmup_steps=0, optimizer="lion", learning_rate=1e-4), False),
    "adafactor": (TrainConfig(warmup_steps=0, optimizer="adafactor"), False),
}


def batch(seed, n=4):
    cfg = SigLIPConfig.tiny_test()
    rng = np.random.default_rng(seed)
    hw, ctx = cfg.vision.image_size, cfg.text.context_length
    return {"images": torch.from_numpy(rng.standard_normal((n, hw, hw, 3)).astype(np.float32)),
            "tokens": torch.from_numpy(rng.integers(0, cfg.text.vocab_size, (n, ctx))
                                       .astype(np.int32))}


def trained_state(name, steps=2, seed=0):
    """A tiny model's train state after ``steps`` steps, and its step."""
    train_cfg, ema = OPTIMIZERS[name]
    cfg = SigLIPConfig.tiny_test()
    model = SigLIP(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    state = pts.create_train_state(model, pts.make_optimizer(train_cfg), ema=ema)
    step = pts.make_train_step(model, LossConfig(), ema_decay=0.9 if ema else None)
    for i in range(steps):
        state, _ = step(state, batch(i))
    return state, step


def snapshot(state):
    return {k: t.detach().clone() for k, t in ckpt.state_tensors(state).items()}


def assert_bitwise(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("writer", ["sync", "async"])
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_train_state_round_trip_is_bitwise(tmp_path, name, writer):
    state, step = trained_state(name)
    want, want_step, want_count = snapshot(state), state.step, state.opt_state.count
    path = str(tmp_path / "step_00000002")
    if writer == "sync":
        ckpt.save_checkpoint(path, state)
    else:
        with ckpt.AsyncSaver() as saver:
            saver.save(path, state)
    state, _ = step(state, batch(9))  # move every tensor on
    assert state.step == want_step + 1
    restored = ckpt.restore_checkpoint(path, state)
    assert restored is state
    assert state.step == want_step and state.opt_state.count == want_count
    assert_bitwise(snapshot(state), want)
    if name == "adamw_bf16_mu_ema":
        assert state.opt_state.mu[0].dtype == torch.bfloat16 and state.ema is not None
        assert any(k.startswith("ema.") for k in want)
    with open(os.path.join(path, ckpt.META_FILE)) as f:
        meta = json.load(f)
    assert meta["format"] == ckpt.FORMAT and meta["step"] == want_step
    assert meta["optimizer"] == name.split("_")[0]


def test_restored_state_trains_on_like_the_original(tmp_path):
    """A fresh model restored from a checkpoint takes the same next step."""
    state, step = trained_state("adamw_bf16_mu_ema")
    ckpt.save_checkpoint(str(tmp_path / "c"), state)
    state, m = step(state, batch(5))
    other, other_step = trained_state("adamw_bf16_mu_ema", steps=0, seed=7)
    ckpt.restore_checkpoint(str(tmp_path / "c"), other)
    other, m2 = other_step(other, batch(5))
    assert_bitwise(snapshot(other), snapshot(state))
    assert torch.equal(m["loss"], m2["loss"])


def test_dict_of_tensors_round_trip_is_bitwise(tmp_path):
    g = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn(3, 4, generator=g),
            "inner": {"b": torch.randn(5, generator=g).bfloat16(),
                      "ids": torch.arange(6, dtype=torch.int32).reshape(2, 3),
                      "s": torch.tensor(2.5, dtype=torch.float64)}}
    want = {"w": tree["w"].clone(), "inner": {k: v.clone() for k, v in tree["inner"].items()}}
    ckpt.save_checkpoint(str(tmp_path / "c"), tree)
    for t in (tree["w"], *tree["inner"].values()):
        t.zero_()
    assert ckpt.restore_checkpoint(str(tmp_path / "c"), tree) is tree
    assert_bitwise(ckpt.state_tensors(tree), ckpt.state_tensors(want))
    assert set(ckpt.state_tensors(tree)) == {"w", "inner/b", "inner/ids", "inner/s"}
    with pytest.raises(TypeError, match="tensors"):
        ckpt.save_checkpoint(str(tmp_path / "d"), {"w": 1.0})


def test_mismatch_raises_and_names_every_tensor(tmp_path):
    ckpt.save_checkpoint(str(tmp_path / "c"), {
        "a": torch.zeros(2, 3), "b": torch.zeros(4), "c": torch.zeros(1), "gone": torch.zeros(2)})
    target = {"a": torch.ones(3, 2), "b": torch.ones(4, dtype=torch.bfloat16),
              "c": torch.ones(1), "new": torch.ones(7)}
    with pytest.raises(ValueError) as e:
        ckpt.restore_checkpoint(str(tmp_path / "c"), target)
    msg = str(e.value)
    for line in ("a: checkpoint has (2, 3)/torch.float32, target expects (3, 2)/torch.float32",
                 "b: checkpoint has (4,)/torch.float32, target expects (4,)/torch.bfloat16",
                 "gone: in the checkpoint ((2,)/torch.float32), not in the target",
                 "new: missing from the checkpoint, target expects (7,)/torch.float32"):
        assert line in msg, msg
    assert "  c:" not in msg
    # Nothing was copied before the refusal.
    assert torch.equal(target["c"], torch.ones(1))


def test_other_optimizer_or_ema_shape_is_refused(tmp_path):
    state, _ = trained_state("lion", steps=1)
    ckpt.save_checkpoint(str(tmp_path / "c"), state)
    adamw, _ = trained_state("adamw_bf16_mu_ema", steps=0)
    with pytest.raises(ValueError) as e:
        ckpt.restore_checkpoint(str(tmp_path / "c"), adamw)
    msg = str(e.value)
    assert "optimizer: checkpoint has lion, target expects adamw" in msg
    assert "opt.nu.bias: missing from the checkpoint" in msg
    assert "ema.t_prime: missing from the checkpoint" in msg


def test_latest_step_ignores_temporary_and_foreign_names(tmp_path, monkeypatch):
    root = str(tmp_path)
    assert latest_step(root) is None
    save_step(root, 3, {"w": torch.ones(2)})
    for name in (".step_00000009.tmp-abc", "step_00000009.tmp", "step_9", "step_000000010"):
        os.makedirs(os.path.join(root, name))
    open(os.path.join(root, "step_00000008"), "w").close()  # a file, not a directory
    assert latest_step(root) == 3

    # A write that fails leaves no step directory and no temporary one.
    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt.torch, "save", boom)
    before = sorted(os.listdir(root))
    with pytest.raises(OSError, match="disk full"):
        save_step(root, 5, {"w": torch.ones(2)})
    assert sorted(os.listdir(root)) == before and latest_step(root) == 3


def test_save_replaces_an_existing_checkpoint(tmp_path):
    path = str(tmp_path / "step_00000001")
    ckpt.save_checkpoint(path, {"w": torch.zeros(2)})
    ckpt.save_checkpoint(path, {"w": torch.ones(2)})
    out = {"w": torch.full((2,), 7.0)}
    ckpt.restore_checkpoint(path, out)
    assert torch.equal(out["w"], torch.ones(2))
    assert sorted(os.listdir(tmp_path)) == ["step_00000001"]


def test_async_saver_returns_first_and_queues_a_second_save(tmp_path, monkeypatch):
    gate, started = threading.Event(), []
    write = ckpt._write

    def gated_write(path, host, meta):
        started.append(os.path.basename(path))
        assert gate.wait(10)
        write(path, host, meta)

    monkeypatch.setattr(ckpt, "_write", gated_write)
    root = str(tmp_path)
    state = {"w": torch.arange(4, dtype=torch.float32)}
    saver = ckpt.AsyncSaver()
    save_step(root, 1, state, saver=saver)  # returns with the write held at the gate
    assert started == ["step_00000001"] and latest_step(root) is None
    state["w"].add_(10.0)  # after save returns: the snapshot is already taken
    second = threading.Thread(target=save_step, args=(root, 2, state), kwargs={"saver": saver})
    second.start()
    time.sleep(0.3)
    assert second.is_alive() and started == ["step_00000001"]  # queued behind the first
    gate.set()
    second.join(10)
    assert not second.is_alive()
    saver.wait()
    assert latest_step(root) == 2 and started == ["step_00000001", "step_00000002"]
    for step, want in ((1, torch.arange(4.0)), (2, torch.arange(4.0) + 10)):
        out = {"w": torch.zeros(4)}
        ckpt.restore_checkpoint(os.path.join(root, f"step_{step:08d}"), out)
        assert torch.equal(out["w"], want), step
    assert [t["bytes"] for t in saver.timings] == [16, 16]
    assert all(t["write_s"] >= 0 and t["snapshot_s"] >= 0 for t in saver.timings)
    saver.close()


def test_async_saver_raises_a_write_error_on_wait(tmp_path, monkeypatch):
    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "_write", boom)
    saver = ckpt.AsyncSaver()
    saver.save(str(tmp_path / "step_00000001"), {"w": torch.ones(2)})
    with pytest.raises(OSError, match="disk full"):
        saver.wait()
    saver.wait()  # raised once
    saver.close()
