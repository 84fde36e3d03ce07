"""The port's resilient loop (``train/resilience.py``) against the JAX
package's, and the train-loop slice as a whole.

- One scenario table runs through both packages' ``train_resilient`` with
  the same toy step (``w ← w + 0.1·x``, the loss ``Σw²``, NaN on a poisoned
  batch): a fresh run, resume, SIGTERM raised from ``on_metrics``, NaN
  under halt and under skip (with and without a checkpoint, the latter
  where the port's in-place step needs its pre-step copy),
  ``check_finite_every=2``, the data running out, ``require_restore`` on an
  empty directory, ``eval_every``, and the asynchronous savers. The reports,
  the ``on_metrics`` / ``on_eval`` call sequences, the final states and the
  divergence exceptions are equal.
- The preemption guard's agreement at W = 2 over gloo.
- The tiny SigLIP with JAX's weights (``params_from_jax``) on the same
  synthetic stream: JAX's ``make_train_step`` + ``train_resilient`` to 4
  steps with ``ckpt_every=2`` against the port's (losses within rtol 1e-4,
  the same checkpoints, parameters within the tolerance of
  ``tests/test_torch_train_step.py::test_whole_step_f32_matches_jax``); the
  same with a NaN batch at step 2 under "skip" before any checkpoint (the
  rollback of the port's in-place step, its counters included: the same
  step, AdamW count and report as JAX's); and on the port alone, a run stopped at step 2 and resumed to 4 equal to an
  uninterrupted run bit for bit.

The loss runs at precision "highest" in both packages here: XLA's CPU dot
ignores "default", which the port emulates as the TPU's one bf16 pass.
"""

import dataclasses
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_worker as dist_worker
import _torch_slice_workers as workers
from distributed_sigmoid_loss_tpu.data import SyntheticImageText as JaxSynthetic
from distributed_sigmoid_loss_tpu.models.siglip import SigLIP as JaxSigLIP
from distributed_sigmoid_loss_tpu.parallel.mesh import make_mesh
from distributed_sigmoid_loss_tpu.train import checkpoint as jax_ckpt
from distributed_sigmoid_loss_tpu.train import resilience as jres
from distributed_sigmoid_loss_tpu.train import train_step as jts
from distributed_sigmoid_loss_tpu.utils import config as jc
from distributed_sigmoid_loss_tpu_torch.data import SyntheticImageText
from distributed_sigmoid_loss_tpu_torch.models import SigLIP, params_from_jax
from distributed_sigmoid_loss_tpu_torch.train import checkpoint as pckpt
from distributed_sigmoid_loss_tpu_torch.train import resilience as pres
from distributed_sigmoid_loss_tpu_torch.train import train_step as pts
from distributed_sigmoid_loss_tpu_torch.utils import config as pc

# --- the scenario table -------------------------------------------------------

X = np.array([[1.0, -2.0, 0.5], [0.25, 1.0, -1.0], [2.0, 0.5, 0.0], [-1.5, 0.75, 1.25],
              [0.5, 0.5, -0.5], [1.0, 1.0, 1.0]], np.float32)
W0 = np.array([0.5, -0.25, 1.0], np.float32)


@dataclasses.dataclass(frozen=True)
class Scenario:
    total: int
    ckpt_every: int = 2
    poison: tuple = ()  # 0-based batch positions whose loss is NaN
    n_batches: int = 6
    on_divergence: str = "halt"
    check_finite_every: int = 1
    sigterm_at: int = 0  # on_metrics raises SIGTERM at this step
    eval_every: int = 0
    require_restore: bool = False
    pre_steps: int = 0  # an earlier run to this step first (resume)
    saver: bool = False


SCENARIOS = {
    "fresh": Scenario(total=5),
    "resume": Scenario(total=5, pre_steps=3),
    "sigterm_at_2": Scenario(total=5, sigterm_at=2),
    "nan_at_3_halt": Scenario(total=5, poison=(2,)),
    "nan_at_3_halt_no_checkpoint": Scenario(total=5, ckpt_every=10, poison=(2,)),
    "nan_at_3_skip": Scenario(total=5, poison=(2,), on_divergence="skip"),
    "nan_at_3_skip_no_checkpoint": Scenario(total=5, ckpt_every=10, poison=(2,),
                                            on_divergence="skip"),
    # Step 3's NaN goes unchecked (to on_metrics), step 4's is caught.
    "check_finite_every_2": Scenario(total=5, poison=(2, 3), check_finite_every=2,
                                     on_divergence="skip"),
    "data_runs_out_at_3": Scenario(total=5, n_batches=3),
    "require_restore_empty": Scenario(total=3, require_restore=True),
    "eval_every_2": Scenario(total=5, eval_every=2, ckpt_every=3),
    "async_skip": Scenario(total=5, poison=(3,), on_divergence="skip", saver=True),
}


def _batches(sc, start=0):
    return [{"x": X[i], "poison": i in sc.poison} for i in range(start, sc.n_batches)]


def _jax_step(state, batch):
    w = state["w"] + 0.1 * jnp.asarray(batch["x"])
    loss = jnp.sum(w * w) * (jnp.nan if batch["poison"] else 1.0)
    return {"w": w}, {"loss": loss}


def _port_step(state, batch):
    state["w"].add_(0.1 * torch.from_numpy(batch["x"]))  # in place, as the port's step
    loss = torch.sum(state["w"] * state["w"]) * (float("nan") if batch["poison"] else 1.0)
    return state, {"loss": loss}


PACKAGES = {
    "jax": dict(res=jres, step=_jax_step, state=lambda: {"w": jnp.asarray(W0)},
                w=lambda st: np.asarray(st["w"]), saver=lambda: jax_ckpt.AsyncSaver()),
    "port": dict(res=pres, step=_port_step, state=lambda: {"w": torch.from_numpy(W0.copy())},
                 w=lambda st: st["w"].numpy().copy(), saver=lambda: pckpt.AsyncSaver()),
}


def run_scenario(pkg, sc, root):
    """Everything the run showed: the report (or the exception), the
    callbacks' calls and the final state."""
    p = PACKAGES[pkg]
    res, calls = p["res"], []
    if sc.pre_steps:
        res.train_resilient(p["state"](), p["step"], _batches(sc), total_steps=sc.pre_steps,
                            ckpt_dir=root, ckpt_every=sc.ckpt_every)

    def on_metrics(step, m):
        calls.append(("metrics", step, float(m["loss"])))
        if step == sc.sigterm_at:
            signal.raise_signal(signal.SIGTERM)

    def on_eval(step, st):
        calls.append(("eval", step, p["w"](st).tolist()))

    out = {"calls": calls}
    start = res.latest_step(root) or 0
    with res.PreemptionGuard() as guard:
        saver = p["saver"]() if sc.saver else None
        try:
            state, report = res.train_resilient(
                p["state"](), p["step"], _batches(sc, start), total_steps=sc.total,
                ckpt_dir=root, ckpt_every=sc.ckpt_every, guard=guard,
                on_divergence=sc.on_divergence, on_metrics=on_metrics,
                check_finite_every=sc.check_finite_every, require_restore=sc.require_restore,
                saver=saver, eval_every=sc.eval_every, on_eval=on_eval if sc.eval_every else None)
            out.update(report=dataclasses.asdict(report), w=p["w"](state))
        except res.TrainingDiverged as e:
            out.update(diverged=(e.step, np.isnan(e.loss), e.restored_step),
                       restored_w=None if e.restored_state is None else p["w"](e.restored_state))
        except res.RestoreRequiredError as e:
            out.update(restore_required=str(e).replace(root, "<root>"))
        finally:
            if saver is not None:
                saver.wait()
                saver.close()
    out["checkpoints_on_disk"] = res.latest_step(root)
    return out


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_port_loop_matches_jax_loop(tmp_path, name):
    sc = SCENARIOS[name]
    ref = run_scenario("jax", sc, str(tmp_path / "jax"))
    got = run_scenario("port", sc, str(tmp_path / "port"))
    assert got.keys() == ref.keys()
    np.testing.assert_equal(got["calls"], ref["calls"])
    for k in ref:
        if k == "calls":
            continue
        if k in ("w", "restored_w") and ref[k] is not None:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, err_msg=k)
        else:
            assert got[k] == ref[k], k


def test_scenarios_cover_what_they_claim(tmp_path):
    """The table's scenarios reach the paths they are named for (a guard
    against a scenario that silently runs the plain path)."""
    out = {n: run_scenario("port", sc, str(tmp_path / n)) for n, sc in SCENARIOS.items()
           if n in ("sigterm_at_2", "nan_at_3_skip_no_checkpoint", "check_finite_every_2",
                    "resume", "nan_at_3_halt_no_checkpoint")}
    assert out["sigterm_at_2"]["report"]["preempted"] and \
        out["sigterm_at_2"]["report"]["checkpoints"] == [2]
    skip = out["nan_at_3_skip_no_checkpoint"]
    assert skip["report"]["divergences"] == 1 and skip["report"]["checkpoints"] == [5]
    expect = W0 + 0.1 * (X[0] + X[1] + X[3] + X[4])  # batch 2's update dropped
    np.testing.assert_allclose(skip["w"], expect, rtol=1e-6)
    every2 = out["check_finite_every_2"]
    assert every2["report"]["divergences"] == 1
    assert [c[1] for c in every2["calls"]] == [1, 2, 3, 5]
    assert np.isnan(every2["calls"][2][2])
    assert out["resume"]["report"]["start_step"] == 3
    assert out["nan_at_3_halt_no_checkpoint"]["diverged"] == (2, True, None)


@pytest.fixture(scope="module")
def guard_ranks(tmp_path_factory):
    return dist_worker.spawn(workers.guard_worker, 2, (1, 2, 4),
                             tmp_path_factory.mktemp("guard"))


@pytest.mark.parametrize("rank", [0, 1])
def test_guard_agrees_on_the_step_over_gloo(guard_ranks, rank):
    got = guard_ranks[rank]
    assert got["seen"] == [False, True, True, True]
    assert got["local"] == (rank == 1)


# --- the slice as a whole -----------------------------------------------------

STEPS, BATCH = 4, 8
TRAIN = dict(learning_rate=1e-3, warmup_steps=5, total_steps=10)  # the train command's


def _port_config(jcfg):
    return pc.SigLIPConfig(vision=pc.ViTConfig(**dataclasses.asdict(jcfg.vision)),
                           text=pc.TextConfig(**dataclasses.asdict(jcfg.text)),
                           loss=pc.LossConfig(**dataclasses.asdict(jcfg.loss)))


def _poisoned(batch, poison):
    """``batch`` with NaN images when ``poison``: the step's loss, gradients
    and update all go non-finite."""
    return {**batch, "images": batch["images"] * float("nan")} if poison else batch


def _jax_train(ckpt_dir, poison=(), on_divergence="halt", ckpt_every=2):
    """JAX's tiny model trained 4 steps (AdamW, EMA) through its resilient
    loop, the batches at positions ``poison`` made NaN: its initial
    parameters, the losses, the report, the final parameters in the port's
    layout, its step and its optimizer's update count."""
    jcfg = jc.SigLIPConfig.tiny_test()
    model = JaxSigLIP(jcfg)
    mesh = make_mesh(1)
    stream = iter(JaxSynthetic(jcfg, BATCH))
    batches = [next(stream) for _ in range(STEPS)]
    state = jts.create_train_state(jax.random.key(0), model,
                                   jts.make_optimizer(jc.TrainConfig(**TRAIN)), batches[0],
                                   mesh, ema=True)
    params0 = jax.tree.map(np.asarray, state.params)
    step, shardings = jts.make_train_step(model, mesh, jc.LossConfig(variant="ring"),
                                          ema_decay=0.999)
    if on_divergence == "skip":
        # The jitted step donates its state, so the state JAX's "skip" keeps
        # before the first checkpoint would be a deleted buffer; a copy keeps
        # it alive, as the loop's "keep the current params" means.
        donating = step
        step = lambda st, b: donating(jax.tree.map(jnp.copy, st), b)  # noqa: E731
    losses = []
    state, report = jres.train_resilient(
        state, step, (jax.device_put(_poisoned(b, i in poison), shardings)
                      for i, b in enumerate(batches)),
        total_steps=STEPS, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
        on_divergence=on_divergence, on_metrics=lambda s, m: losses.append(float(m["loss"])))
    counts = {int(leaf) for path, leaf in jax.tree_util.tree_leaves_with_path(state.opt_state)
              if getattr(path[-1], "name", None) == "count"}
    assert len(counts) == 1, counts
    return {"params0": params0, "losses": losses, "report": dataclasses.asdict(report),
            "params": params_from_jax(jax.tree.map(np.asarray, state.params),
                                      _port_config(jcfg)),
            "step": int(state.step), "count": counts.pop()}


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    return _jax_train(str(tmp_path_factory.mktemp("jax_slice")))


def _port_run(params0, ckpt_dir, total, seed=0, poison=(), on_divergence="halt",
              ckpt_every=2):
    """The port's tiny model from ``params0`` through its resilient loop to
    ``total`` steps, resuming from ``ckpt_dir``'s checkpoint if one is there,
    the batches at positions ``poison`` made NaN; returns (losses, report,
    state)."""
    cfg = _port_config(jc.SigLIPConfig.tiny_test())
    skip = pres.latest_step(ckpt_dir) or 0
    model = SigLIP(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    if not skip:  # a resumed run's weights come from the checkpoint
        model.load_state_dict(params_from_jax(params0, cfg), strict=True)
    state = pts.create_train_state(model, pts.make_optimizer(pc.TrainConfig(**TRAIN)), ema=True)
    step = pts.make_train_step(model, pc.LossConfig(variant="ring"), ema_decay=0.999)
    stream = iter(SyntheticImageText(cfg, BATCH))
    batches = [_poisoned(next(stream), i in poison) for i in range(total)][skip:]
    losses = []
    state, report = pres.train_resilient(
        state, step, batches, total_steps=total, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
        on_divergence=on_divergence, require_restore=skip > 0,
        on_metrics=lambda s, m: losses.append(m["loss"].item()))
    return losses, dataclasses.asdict(report), state


def _assert_params_like_jax(got_params, want_params, updates):
    """The parameters as test_torch_train_step.py holds the whole step:
    every entry within 2·lr per non-zero update, all but 0.5% at rtol 1e-4."""
    lr, outside, total = TRAIN["learning_rate"], 0, 0
    for k, want in want_params.items():
        got, ref = got_params[k].numpy(), want.numpy()
        np.testing.assert_allclose(got, ref, atol=2 * lr * updates, err_msg=k)
        outside += int((np.abs(got - ref) > 1e-6 + 1e-4 * np.abs(ref)).sum())
        total += ref.size
    assert outside <= 0.005 * total, (outside, total)


def test_slice_trains_like_jax(jax_run, tmp_path):
    losses, report, state = _port_run(jax_run["params0"], str(tmp_path), STEPS)
    assert report == jax_run["report"] == {"start_step": 0, "final_step": 4,
                                           "checkpoints": [2, 4], "preempted": False,
                                           "divergences": 0}
    np.testing.assert_allclose(losses, jax_run["losses"], rtol=1e-4)
    # The first update is the zero warmup rate's.
    _assert_params_like_jax(state.model.state_dict(), jax_run["params"], STEPS - 1)


@pytest.fixture(scope="module")
def jax_skip_run(tmp_path_factory):
    return _jax_train(str(tmp_path_factory.mktemp("jax_skip")), poison=(1,),
                      on_divergence="skip", ckpt_every=10)


def test_skip_before_any_checkpoint_rolls_back_like_jax(jax_skip_run, tmp_path):
    """A NaN at step 2, before the first checkpoint, under "skip": the port's
    in-place step has advanced the parameters, the AdamW moments and count,
    the EMA and the step when the loss is read; the rollback puts all of
    them back, so the schedule, the bias correction and the EMA go on as
    JAX's, which never left the pre-step state."""
    ref = jax_skip_run
    losses, report, state = _port_run(ref["params0"], str(tmp_path), STEPS, poison=(1,),
                                      on_divergence="skip", ckpt_every=10)
    assert report == ref["report"] == {"start_step": 0, "final_step": 4, "checkpoints": [4],
                                       "preempted": False, "divergences": 1}
    assert (state.step, state.opt_state.count) == (ref["step"], ref["count"]) == (3, 3)
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-4)
    assert len(losses) == 3
    _assert_params_like_jax(state.model.state_dict(), ref["params"], 2)
    for t in pckpt.state_tensors(state).values():
        assert torch.isfinite(t).all()


def test_resumed_run_equals_uninterrupted_run_bitwise(jax_run, tmp_path):
    params0 = jax_run["params0"]
    whole_losses, whole_report, whole = _port_run(params0, str(tmp_path / "whole"), STEPS)
    first_losses, first_report, _ = _port_run(params0, str(tmp_path / "split"), 2)
    # A fresh model of other weights, which the restore overwrites.
    rest_losses, rest_report, resumed = _port_run(params0, str(tmp_path / "split"), STEPS,
                                                  seed=3)
    assert first_report["checkpoints"] == [2]
    assert rest_report["start_step"] == 2 and rest_report["checkpoints"] == [2, 4]
    assert first_losses + rest_losses == whole_losses
    assert resumed.step == whole.step == STEPS
    got, want = pckpt.state_tensors(resumed), pckpt.state_tensors(whole)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
