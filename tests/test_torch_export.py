"""The port's AOT export (``train/export.py``, the ``export`` command) on the
CPU: the counterparts of ``tests/test_export.py``, the JAX package's
artifact against the port's on the same weights, the serving engine over a
``load_forward`` artifact, the command's refusals, and every kernel op
under ``torch.library.opcheck``.

The kernels' ops run their plain versions on CPU tensors, so an artifact
traced here records the same ops a card's artifact does; the tests that
need them on the towers claim the fused path (bf16, ``flash_attention_
available`` patched true), as ``test_torch_towers.py`` does. Replays are
held to the direct or live call at JAX's tolerances: rtol 1e-6 for the
forward, rtol 1e-5 / atol 1e-6 for the train step and ``--check``; the
JAX artifact against the port's at rtol 1e-4 / atol 1e-5 (two packages'
f32 towers, as ``test_torch_towers.py`` holds them).
"""

import dataclasses
import io

import flax.linen as nn
import jax
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from distributed_sigmoid_loss_tpu.models.siglip import SigLIP as JaxSigLIP
from distributed_sigmoid_loss_tpu.train import export_step as jax_export_step
from distributed_sigmoid_loss_tpu.utils.config import SigLIPConfig as JaxSigLIPConfig
from distributed_sigmoid_loss_tpu_torch import cli
from distributed_sigmoid_loss_tpu_torch.data import SyntheticImageText
from distributed_sigmoid_loss_tpu_torch.models import SigLIP, params_from_jax
from distributed_sigmoid_loss_tpu_torch.ops import (
    flash_attention,
    short_attention,
    streaming_sigmoid_loss,
)
from distributed_sigmoid_loss_tpu_torch.serve import InferenceEngine
from distributed_sigmoid_loss_tpu_torch.train import (
    create_train_state,
    export_step,
    load_exported,
    load_forward,
    make_functional_train_step,
    make_optimizer,
    make_train_step,
    save_exported,
    train_state_tree,
    tree_leaves,
)
from distributed_sigmoid_loss_tpu_torch.train import train_step as train_step_module
from distributed_sigmoid_loss_tpu_torch.utils.config import LossConfig, SigLIPConfig, TrainConfig

from test_torch_towers import K7_IMAGE_SIZE, port_config


def tiny_batch(cfg, b, seed=0):
    rng = np.random.default_rng(seed)
    hw = cfg.vision.image_size
    return {"images": torch.from_numpy(rng.standard_normal((b, hw, hw, 3)).astype(np.float32)),
            "tokens": torch.from_numpy(rng.integers(0, cfg.text.vocab_size,
                                                    (b, cfg.text.context_length)).astype(np.int32))}


def towers(cfg, **kw):
    return dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, **kw),
                               text=dataclasses.replace(cfg.text, **kw))


def assert_leaves_close(got, want, **tol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().float().numpy(), w.detach().float().numpy(), **tol)


def graph_ops(exported) -> set[str]:
    program = getattr(exported, "exported", None) or exported.program
    return {str(n.target) for n in program.graph.nodes if n.op == "call_function"}


def test_export_forward_roundtrip_matches_direct_call(tmp_path):
    cfg = SigLIPConfig.tiny_test()
    model = SigLIP(cfg, device="cpu")
    batch = tiny_batch(cfg, 4)
    params = dict(model.state_dict())

    def fwd(params, images, tokens):
        zimg, ztxt, lp = torch.func.functional_call(model, params, (images, tokens))
        return zimg, ztxt, lp["t_prime"]

    args = (params, batch["images"], batch["tokens"])
    exported = export_step(fwd, args)

    # Structured call in the exporting process.
    want = fwd(*args)
    got = exported.call(*args)
    assert_leaves_close(pytree.tree_leaves(got), pytree.tree_leaves(want), rtol=1e-6)

    # File roundtrip: the loaded artifact takes and returns flat leaves.
    path = tmp_path / "fwd.pt2"
    save_exported(path, exported)
    assert path.stat().st_size > 0
    loaded = load_exported(path)
    assert_leaves_close(loaded.call(*tree_leaves(args)), pytree.tree_leaves(want), rtol=1e-6)
    # The leaf order is the sorted-key tree order: a dict built in another
    # order flattens the same.
    shuffled = dict(reversed(list(params.items())))
    assert [id(t) for t in tree_leaves((shuffled,))] == [id(t) for t in tree_leaves((params,))]


def test_export_train_step_replays_through_the_kernel_ops(tmp_path, monkeypatch):
    """The W = 1 train step exported, saved, loaded and replayed on copies:
    the returned state and metrics equal the live eager step's. The towers
    run bf16 on the kernels' ops (K1 forward, K3 backward under
    ``batch_heads``; one layer each) and the loss on K4-K6 (``use_pallas`` at a block that
    passes ``pallas_compatible``: 8 rows, d = 128); the graph holds each
    op, and the returned tree counts one step."""
    monkeypatch.setattr(flash_attention, "flash_attention_available", lambda x: True)
    # The record is process-wide: only this test's backwards count.
    short_attention.reset_traced_bwd_batch_heads()
    short_attention.set_bwd_batch_heads(True)
    try:
        cfg = towers(SigLIPConfig.tiny_test(), dtype="bfloat16", embed_dim=128, depth=1)
        model = SigLIP(cfg, device="cpu")
        tx = make_optimizer(TrainConfig(warmup_steps=1, total_steps=100))
        state = create_train_state(model, tx, ema=True)
        loss_cfg = LossConfig(variant="ring", use_pallas=True)
        batch = tiny_batch(cfg, 8)
        fn = make_functional_train_step(model, tx, loss_cfg, ema_decay=0.9)
        exported = export_step(fn, (train_state_tree(state), batch))
        ops = graph_ops(exported)
        for op in ("short_attention_fwd", "short_attention_bwd", "streaming_loss_fwd",
                   "streaming_loss_bwd"):
            assert f"dsl_torch_port.{op}.default" in ops, (op, sorted(ops))
        path = tmp_path / "train_step.pt2"
        save_exported(path, exported)
        loaded = load_exported(path)

        args = pytree.tree_map(torch.clone, (train_state_tree(state), batch))
        got = loaded.call(*tree_leaves(args))
        live = make_train_step(model, loss_cfg, ema_decay=0.9)
        new_state, metrics = live(state, batch)
        want = tree_leaves((train_state_tree(new_state), metrics))
        assert_leaves_close(got, want, rtol=1e-5, atol=1e-6)
        assert short_attention.traced_bwd_batch_heads() == (True,)
        replayed, _ = pytree.tree_unflatten(list(got), exported.out_tree)
        assert int(replayed["step"]) == 1 and int(replayed["opt_state"]["count"]) == 1

        # At count 0 the warmup's rate is 0 and no parameter moves. The
        # replayed state fed back in takes the step at count 1 (rate > 0):
        # AdamW's bias corrections, the schedule on the device and the EMA
        # of moved parameters, against the live step's second call.
        got2 = loaded.call(*tree_leaves((replayed, batch)))
        new_state, metrics = live(new_state, batch)
        assert_leaves_close(got2, tree_leaves((train_state_tree(new_state), metrics)),
                            rtol=1e-5, atol=1e-6)
        replayed2, metrics2 = pytree.tree_unflatten(list(got2), exported.out_tree)
        assert int(replayed2["step"]) == 2 and int(replayed2["opt_state"]["count"]) == 2
        moved = max(float((a - b).abs().max()) for a, b in
                    zip(tree_leaves(replayed2["params"]), tree_leaves(replayed["params"])))
        assert moved > 1e-4 and float(metrics2["update_ratio"]) > 0, moved
    finally:
        short_attention.set_bwd_batch_heads(False)
        short_attention.reset_traced_bwd_batch_heads()


@pytest.mark.parametrize("optimizer", ["adamw", "lion", "adafactor"])
def test_functional_update_equals_eager_apply(optimizer):
    """Each optimizer's traced update (:meth:`update`) against its in-place
    ``apply`` on the same gradients, two steps (the count's schedule and
    Adafactor's factored statistics both advance), clipped (gradients of
    norm ~40) and not."""
    model = SigLIP(towers(SigLIPConfig.tiny_test(), scan_layers=True), device="cpu")
    tx = make_optimizer(TrainConfig(optimizer=optimizer, warmup_steps=1, total_steps=100))
    state = create_train_state(model, tx)
    tree = train_state_tree(state)
    params, opt = list(tree["params"].values()), pytree.tree_map(torch.clone, tree["opt_state"])
    params = [p.clone() for p in params]
    extra = {"leaves": state.opt_state.leaves} if optimizer == "adafactor" else {}
    rng = np.random.default_rng(0)
    for scale in (1.0, 1e-3):
        grads = [torch.from_numpy(np.asarray(scale * rng.standard_normal(tuple(p.shape)),
                                             np.float32)) for p in params]
        params, opt, g_norm, u_norm = tx.update(params, grads, opt, **extra)
        want_g, want_u = tx.apply(list(model.parameters()), grads, state.opt_state)
        torch.testing.assert_close(g_norm, want_g, rtol=0, atol=0)
        torch.testing.assert_close(u_norm, want_u, rtol=1e-6, atol=0)
    assert_leaves_close(params, [p.detach() for p in model.parameters()], rtol=1e-6, atol=1e-7)
    assert_leaves_close(tree_leaves(opt), tree_leaves(tx.tree(state.opt_state, "cpu")),
                        rtol=1e-6, atol=1e-7)


def test_cli_export_writes_and_checks_artifact(tmp_path, capsys):
    """``export OUT --check`` in process: the default train step."""
    out = tmp_path / "step.pt2"
    assert cli.main(["export", str(out), "--tiny", "--cpu-devices", "1", "--batch", "8",
                     "--check"]) == 0
    assert "check ok" in capsys.readouterr().out
    assert out.stat().st_size > 0


def test_loaded_artifact_composes_under_export():
    """``.call`` of a deserialized artifact is traceable: it can be embedded
    in a larger exported program."""

    def double_sum(x):
        return (x * 2.0).sum()

    x = torch.arange(8.0)
    blob = export_step(double_sum, (x,)).serialize()
    loaded = load_exported(io.BytesIO(blob))

    def outer(x):
        return loaded.call(x)[0] + 1.0

    composed = export_step(outer, (x,))
    assert float(composed.call(x)) == float(double_sum(x)) + 1.0


def test_cli_export_quant_forward_artifact(tmp_path, capsys):
    """``export --quant int8 --what forward`` writes a checkable artifact:
    the int8 projections' op is in it."""
    out = tmp_path / "fwd_int8.pt2"
    assert cli.main(["export", str(out), "--tiny", "--cpu-devices", "1", "--batch", "4",
                     "--what", "forward", "--quant", "int8", "--check"]) == 0
    assert "check ok" in capsys.readouterr().out
    assert "dsl_torch_port.int8_linear.default" in graph_ops(load_exported(out))


@pytest.mark.parametrize("argv, code, words", [
    (["--quant", "int8"], 2, "inference-only"),
    (["--moe-experts", "4", "--ep", "3"], 2, "--ep 3 must divide process count 1"),
    (["--ep", "2"], 2, "--ep > 1 without --moe-experts"),
    (["--what", "forward", "--moe-experts", "4", "--ep", "2"], 2, "--what train_step only"),
    (["--moe-experts", "4", "--ep", "2"], 2, "--ep 2 must divide process count 1"),
    (["--cpu-devices", "2"], 2, "--cpu-devices 2"),
    (["--platform", "tpu"], 2, "'cuda' or 'cpu'"),
    (["--platform", "cuda", "--cpu-devices", "1"], 2, "conflicts"),
], ids=["quant_train_step", "moe_experts_ep3", "ep_without_moe", "forward_ep",
        "moe_experts_ep2",
        "cpu_devices_2", "platform_tpu", "platform_cuda_on_cpu"])
def test_cli_export_refusals(tmp_path, capsys, argv, code, words):
    argv = ["export", str(tmp_path / "x.pt2"), "--tiny"] + argv
    if "--cpu-devices" not in argv and "--platform" not in argv:
        argv += ["--cpu-devices", "1"]
    assert cli.main(argv) == code
    assert words in capsys.readouterr().err
    assert not (tmp_path / "x.pt2").exists()


def test_cli_export_without_cuda_exits_1(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["export", str(tmp_path / "x.pt2"), "--tiny"]) == 1
    assert "--cpu-devices 1" in capsys.readouterr().err


def test_functional_step_refuses_more_than_one_process(monkeypatch):
    monkeypatch.setattr(train_step_module, "axis_size", lambda *a: 2)
    model = SigLIP(SigLIPConfig.tiny_test(), device="cpu")
    with pytest.raises(NotImplementedError, match="cannot be held in one process's artifact"):
        make_functional_train_step(model, make_optimizer(TrainConfig()))


def test_load_forward_refuses_an_artifact_without_two_leaves(tmp_path):
    x = torch.ones(3)
    save_exported(tmp_path / "three.pt2", export_step(lambda p, i, t: (i, t, i + t),
                                                      ({"w": x}, x, x)))
    fwd = load_forward(tmp_path / "three.pt2")
    with pytest.raises(ValueError, match="returned 3 leaves"):
        fwd({"w": x}, x, x)


def test_platforms_must_hold_the_example_tensors():
    with pytest.raises(ValueError, match="not on the platforms"):
        export_step(lambda x: x + 1, (torch.ones(2),), platforms=("cuda",))
    assert float(export_step(lambda x: x + 1, (torch.ones(2),),
                             platforms=("cpu",)).call(torch.ones(2))[0]) == 2.0


def test_forward_artifact_matches_jax_artifact():
    """JAX's forward artifact and the port's, traced from the same weights
    (``params_from_jax``), replayed on the same seeded inputs."""
    jcfg = JaxSigLIPConfig.tiny_test()
    jmodel = JaxSigLIP(jcfg)
    batch = tiny_batch(jcfg, 4, seed=3)
    images, tokens = batch["images"].numpy(), batch["tokens"].numpy()
    jparams = nn.meta.unbox(jmodel.init(jax.random.key(0), images, tokens)["params"])

    def jfwd(params, images, tokens):
        zimg, ztxt, _ = jmodel.apply({"params": params}, images, tokens)
        return zimg, ztxt

    jexp = jax_export_step(jfwd, (jparams, images, tokens))
    jloaded = jax.export.deserialize(jexp.serialize())
    want = jloaded.call(*jax.tree.leaves((jparams, images, tokens)))

    cfg = port_config(jcfg)
    model = SigLIP(cfg, device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg)

    def fwd(params, images, tokens):
        zimg, ztxt, _ = torch.func.functional_call(model, params, (images, tokens))
        return zimg, ztxt

    blob = export_step(fwd, (params, batch["images"], batch["tokens"])).serialize()
    got = load_exported(io.BytesIO(blob)).call(*tree_leaves((params, batch["images"],
                                                             batch["tokens"])))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)


def test_forward_artifact_at_a_k7_shape(monkeypatch):
    """A bf16 forward artifact whose vision tower takes K7 (its fit moved
    below the vision length, as ``test_torch_towers.force_vision_onto_k7``)
    and the text tower K1: both forward ops recorded, the replay equal to
    the direct call."""
    cfg = towers(SigLIPConfig.tiny_test(), dtype="bfloat16")
    cfg = dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision,
                                                              image_size=K7_IMAGE_SIZE))
    text_len = cfg.text.context_length
    monkeypatch.setattr(flash_attention, "flash_attention_available", lambda *a: True)
    monkeypatch.setattr(short_attention, "short_attention_fits", lambda s, *a: s <= text_len)
    model = SigLIP(cfg, device="cpu")
    batch = tiny_batch(cfg, 4)
    params = dict(model.state_dict())

    def fwd(params, images, tokens):
        zimg, ztxt, _ = torch.func.functional_call(model, params, (images, tokens))
        return zimg, ztxt

    args = (params, batch["images"], batch["tokens"])
    exported = export_step(fwd, args)
    ops = graph_ops(exported)
    assert {"dsl_torch_port.flash_attention_fwd.default",
            "dsl_torch_port.short_attention_fwd.default"} <= ops
    assert_leaves_close(exported.program.call(*tree_leaves(args)), list(fwd(*args)),
                        rtol=1e-6, atol=0)


def _perturbed(params, eps, seed):
    """A same-spec weight dict that changes the embeddings (additive noise:
    a pure rescale would normalize away)."""
    rng = np.random.default_rng(seed)
    return {k: v + eps * torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(np.float32))
            for k, v in params.items()}


def test_swap_through_load_forward_artifact_engine(tmp_path):
    """New weights through the exported-forward serving path: the engine
    built from a ``load_forward`` artifact accepts a hot swap with zero new
    programs, and the swapped weights change the embeddings."""
    b = 4
    art = str(tmp_path / "fwd.pt2")
    assert cli.main(["export", art, "--what", "forward", "--tiny", "--cpu-devices", "1",
                     "--batch", str(b)]) == 0

    cfg = SigLIPConfig.tiny_test()
    ctx, hw = cfg.text.context_length, cfg.vision.image_size
    batch = next(iter(SyntheticImageText(cfg, b)))
    params = dict(SigLIP(cfg, device="cpu").state_dict())
    fwd = load_forward(art)
    zero_imgs = torch.zeros((b, hw, hw, 3))
    zero_toks = torch.zeros((b, ctx), dtype=torch.int32)
    eng = InferenceEngine(
        lambda p, im: fwd(p, im, zero_toks)[0],
        lambda p, tk: fwd(p, zero_imgs, tk)[1],
        params,
        batch_buckets=(b,),
        text_len_buckets=(ctx,),
        image_shape=(hw, hw, 3),
        device="cpu",
    )
    warmed = eng.warmup()
    toks = np.asarray(batch["tokens"], np.int32)
    before = eng.encode_text(toks)
    with torch.inference_mode():
        live = torch.func.functional_call(
            SigLIP(cfg, device="cpu"), params, (), {"token_ids": torch.from_numpy(toks)})[1]
    np.testing.assert_allclose(before, live.numpy(), rtol=1e-6)
    eng.swap_params(_perturbed(params, 0.05, 30))
    after = eng.encode_text(toks)
    assert eng.compile_count == warmed == eng.bucket_space
    assert not np.allclose(before, after)


def _grads_of(attention):
    """``(q, k, v) -> d sum(attention(q, k, v)²) / d(q, k, v)``, with the
    gradients enabled inside (``export_step`` traces with them off)."""
    def call(q, k, v):
        with torch.enable_grad():
            q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
            return torch.autograd.grad(attention(q, k, v).float().square().sum(), (q, k, v))
    return call


def _no_grad(attention):
    def call(q, k, v):
        with torch.no_grad():
            return attention(q, k, v)
    return call


def _loss_grads(zi, zt, tp, bias):
    with torch.enable_grad():
        args = [t.detach().requires_grad_() for t in (zi, zt, tp, bias)]
        return torch.autograd.grad(streaming_sigmoid_loss.streaming_block_loss_sum(*args, 2),
                                   args)


_QKV = tuple(torch.randn(2, 16, 2, 8, generator=torch.Generator().manual_seed(i))
             .to(torch.bfloat16) for i in range(3))
_LOSS_ARGS = (torch.randn(8, 16, generator=torch.Generator().manual_seed(3)),
              torch.randn(12, 16, generator=torch.Generator().manual_seed(4)),
              torch.tensor(2.3), torch.tensor(-10.0))
# (module, the op wrappers an eager call must not reach, the call, its
# arguments, the ops an export of the same call records)
_EAGER_CASES = {
    "short_forward_no_grad": (short_attention, ["_short_attention_fwd_op"],
                              _no_grad(short_attention.short_self_attention), _QKV,
                              {"short_attention_fwd"}),
    "short_backward": (short_attention, ["_short_attention_bwd_op"],
                       _grads_of(short_attention.short_self_attention), _QKV,
                       {"short_attention_fwd", "short_attention_bwd"}),
    "flash_forward_no_grad": (flash_attention, ["_flash_attention_fwd_op"],
                              _no_grad(flash_attention.flash_self_attention), _QKV,
                              {"flash_attention_fwd"}),
    "flash_backward": (flash_attention, ["_flash_attention_bwd_op"],
                       _grads_of(flash_attention.flash_self_attention), _QKV,
                       {"flash_attention_fwd", "flash_attention_bwd"}),
    "streaming_loss": (streaming_sigmoid_loss, ["_streaming_loss_fwd_op",
                                                "_streaming_loss_bwd_op"],
                       _loss_grads, _LOSS_ARGS, {"streaming_loss_fwd", "streaming_loss_bwd"}),
}


@pytest.mark.parametrize("case", sorted(_EAGER_CASES))
def test_eager_calls_skip_the_op_dispatch_and_exports_record_it(case, monkeypatch):
    """Outside a trace the wrappers call their launchers directly: the
    serving path's no-grad forward, the attention backwards and the loss's
    forward and backward skip the custom ops' dispatch (each op wrapper is
    made to raise, and the eager call still runs). ``export_step`` of the
    same call goes through the ops, and its graph records them."""
    module, wrappers, call, args, recorded = _EAGER_CASES[case]

    def refuse(*a, **kw):
        raise AssertionError("an eager call went through the custom op's dispatch")

    for name in wrappers:
        monkeypatch.setattr(module, name, refuse)
    eager = call(*args)
    monkeypatch.undo()
    ops = graph_ops(export_step(call, args))
    assert {f"dsl_torch_port.{op}.default" for op in recorded} <= ops, sorted(ops)
    assert_leaves_close(pytree.tree_leaves(call(*args)), pytree.tree_leaves(eager), rtol=0, atol=0)


def _op_cases():
    """(name, op, args) of every kernel op on small CPU tensors."""
    g = torch.Generator().manual_seed(0)

    def r(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(dtype)

    q, k, v = (r(2, 16, 2, 8, dtype=torch.bfloat16) for _ in range(3))
    q32, k32, v32 = (r(2, 16, 2, 8) for _ in range(3))
    do = r(2, 16, 2, 8, dtype=torch.bfloat16)
    out, stats = flash_attention._forward(q, k, v, False, 0.35)
    zi, zt = r(8, 16), r(12, 16)
    tp, bias = torch.tensor(2.3), torch.tensor(-10.0)
    ops = torch.ops.dsl_torch_port
    return [
        ("short_attention_fwd_bf16", ops.short_attention_fwd, (q, k, v, False, 0.35)),
        ("short_attention_fwd_f32_causal", ops.short_attention_fwd, (q32, k32, v32, True, 0.35)),
        ("short_attention_bwd_k2", ops.short_attention_bwd, (q, k, v, do, False, 0.35, False)),
        ("short_attention_bwd_k3", ops.short_attention_bwd, (q, k, v, do, True, 0.35, True)),
        ("flash_attention_fwd", ops.flash_attention_fwd, (q, k, v, False, 0.35)),
        ("flash_attention_bwd", ops.flash_attention_bwd, (q, k, v, out, do, stats, False, 0.35)),
        ("streaming_loss_fwd", ops.streaming_loss_fwd, (zi, zt, tp, bias, 2, "")),
        ("streaming_loss_fwd_int8", ops.streaming_loss_fwd, (zi, zt, tp, bias, 0, "int8")),
        ("streaming_loss_bwd", ops.streaming_loss_bwd,
         (zi, zt, tp, bias, streaming_sigmoid_loss.NEGATIVE_ONLY_OFFSET, torch.tensor(0.5), "")),
        ("streaming_loss_bwd_int8", ops.streaming_loss_bwd,
         (zi, zt, tp, bias, 0, torch.tensor(1.0), "int8")),
        ("int8_linear", ops.int8_linear, (r(3, 17, 16), r(8, 16), r(8))),
    ]


@pytest.mark.parametrize("case", range(len(_op_cases())),
                         ids=[c[0] for c in _op_cases()])
def test_kernel_op_passes_opcheck(case):
    """Schema, fake version, autograd registration and AOT dispatch of each
    kernel op (its plain version on CPU tensors). The ops' gradients come
    from the autograd nodes that call the backward ops, which are op-checked
    here as ops of their own."""
    _, op, args = _op_cases()[case]
    torch.library.opcheck(op, args)
