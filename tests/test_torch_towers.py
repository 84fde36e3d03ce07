"""The port's towers vs the JAX package's on the CPU, weights carried across
with ``params_from_jax``; plus the port's config refusals and its isolation
from JAX.

Inputs come from numpy seeds and go through both packages. f32 towers match
at rtol 1e-4 / atol 1e-5 in both depth layouts and in the HF layout. The
bf16 case forces the port's dispatch onto ``short_self_attention`` (its
plain version on the CPU) while JAX on the CPU runs dense attention.
"""

import ast
import dataclasses
import math
import pathlib
import subprocess
import sys
from functools import partial

import flax.linen as nn
import jax
import numpy as np
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from distributed_sigmoid_loss_tpu.models.siglip import SigLIP as JaxSigLIP
from distributed_sigmoid_loss_tpu.ops import flash_attention as jax_flash_module
from distributed_sigmoid_loss_tpu.ops import pallas_short_attention as jax_short_module
from distributed_sigmoid_loss_tpu.ops.sigmoid_loss import init_loss_params
from distributed_sigmoid_loss_tpu.utils.config import SigLIPConfig as JaxSigLIPConfig
from distributed_sigmoid_loss_tpu_torch.models import SigLIP, params_from_jax
from distributed_sigmoid_loss_tpu_torch.models import transformer
from distributed_sigmoid_loss_tpu_torch.ops import flash_attention, short_attention
from distributed_sigmoid_loss_tpu_torch.utils import config as pc

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "distributed_sigmoid_loss_tpu_torch"


def port_config(jcfg) -> pc.SigLIPConfig:
    return pc.SigLIPConfig(
        vision=pc.ViTConfig(**dataclasses.asdict(jcfg.vision)),
        text=pc.TextConfig(**dataclasses.asdict(jcfg.text)),
        loss=pc.LossConfig(**dataclasses.asdict(jcfg.loss)),
    )


def tiny(**tower_kw):
    """tiny_test with the same overrides on both towers (vision/text keys
    prefixed ``v_``/``t_`` apply to one tower only)."""
    cfg = JaxSigLIPConfig.tiny_test()
    both = {k: v for k, v in tower_kw.items() if not k.startswith(("v_", "t_"))}
    vis = {k[2:]: v for k, v in tower_kw.items() if k.startswith("v_")}
    txt = {k[2:]: v for k, v in tower_kw.items() if k.startswith("t_")}
    return dataclasses.replace(
        cfg,
        vision=dataclasses.replace(cfg.vision, **both, **vis),
        text=dataclasses.replace(cfg.text, **both, **txt),
    )


def inputs(jcfg, n=3, seed=0):
    rng = np.random.default_rng(seed)
    hw = jcfg.vision.image_size
    images = rng.standard_normal((n, hw, hw, 3)).astype(np.float32)
    tokens = rng.integers(0, jcfg.text.vocab_size, (n, jcfg.text.context_length)).astype(np.int32)
    return images, tokens


def both_towers(jcfg, seed=0):
    """(jax embeddings, port model) for one config and its carried weights."""
    model = JaxSigLIP(jcfg)
    images, tokens = inputs(jcfg, seed=seed)
    params = jax.jit(model.init)(jax.random.PRNGKey(seed), images, tokens)
    params = jax.tree.map(np.asarray, nn.meta.unbox(params["params"]))
    zimg = jax.jit(partial(model.apply, method=JaxSigLIP.encode_image))({"params": params}, images)
    ztxt = jax.jit(partial(model.apply, method=JaxSigLIP.encode_text))({"params": params}, tokens)
    port = SigLIP(port_config(jcfg), device="cpu")
    port.load_state_dict(params_from_jax(params, port_config(jcfg)), strict=True)
    return (np.asarray(zimg), np.asarray(ztxt)), port, (images, tokens)


def port_embed(port, images, tokens):
    with torch.inference_mode():
        zi = port.encode_image(torch.from_numpy(images))
        zt = port.encode_text(torch.from_numpy(tokens))
    return zi.numpy(), zt.numpy()


@pytest.mark.parametrize(
    "overrides",
    [
        {"scan_layers": False},
        {"scan_layers": True},
        # HF layout: no vision projection (embed_dim == width), last-token text pooling.
        {"v_use_proj": False, "v_embed_dim": 32, "t_pool": "last"},
    ],
    ids=["unrolled", "scanned", "hf_layout"],
)
def test_f32_towers_match_jax(overrides):
    (zimg, ztxt), port, (images, tokens) = both_towers(tiny(**overrides))
    pimg, ptxt = port_embed(port, images, tokens)
    assert pimg.dtype == np.float32 and pimg.shape == zimg.shape
    np.testing.assert_allclose(pimg, zimg, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ptxt, ztxt, rtol=1e-4, atol=1e-5)


def test_bf16_towers_take_short_attention_and_match_jax(monkeypatch):
    jcfg = tiny(dtype="bfloat16")
    (zimg, ztxt), port, (images, tokens) = both_towers(jcfg)
    calls = []
    real = short_attention.short_self_attention

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    # On the CPU the dispatch would take dense attention; claim the device so
    # it takes the fused path, which runs the plain version on CPU tensors.
    monkeypatch.setattr(flash_attention, "flash_attention_available", lambda x: True)
    monkeypatch.setattr(short_attention, "short_self_attention", counted)
    pimg, ptxt = port_embed(port, images, tokens)
    # 2 layers per tower; the MAP heads' cross-attention stays dense.
    assert len(calls) == 4
    # The towers run in bf16 (8 mantissa bits) on both sides but round at
    # different points (dense bf16 logits in JAX, f32 logits in the kernel;
    # fused vs unfused GELU and bias adds). Entries of these 16-dim unit
    # embeddings are ~0.25, where a bf16 ulp is ~1e-3; 1.5e-2 allows the
    # rounding differences of two blocks and a head to add up (observed 6e-3).
    np.testing.assert_allclose(pimg, zimg, atol=1.5e-2)
    np.testing.assert_allclose(ptxt, ztxt, atol=1.5e-2)
    np.testing.assert_allclose(np.linalg.norm(pimg, axis=-1), 1.0, atol=1e-5)


def test_loss_scalar_inits_match_jax():
    ref = init_loss_params()
    model = SigLIP(port_config(tiny()), device="cpu")
    assert model.t_prime.detach().numpy() == np.asarray(ref["t_prime"])
    assert model.bias.detach().numpy() == np.asarray(ref["bias"])
    jcfg = tiny()
    softmax = dataclasses.replace(jcfg, loss=dataclasses.replace(jcfg.loss, family="softmax"))
    model = SigLIP(port_config(softmax), device="cpu")
    assert model.t_prime.item() == pytest.approx(math.log(1 / 0.07))


def test_b16_parameter_count():
    model = SigLIP(pc.SigLIPConfig.b16(), device="meta")
    assert sum(p.numel() for p in model.parameters()) == 210_439_938


def test_params_from_jax_layouts_agree():
    """The scanned and unrolled trees of the same weights convert to the
    same state dict."""
    jcfg = tiny(scan_layers=True)
    model = JaxSigLIP(jcfg)
    images, tokens = inputs(jcfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), images, tokens)
    params = jax.tree.map(np.asarray, nn.meta.unbox(params["params"]))

    def unroll(tower):
        enc = dict(tower["encoder"])
        stacked = enc.pop("blocks")["block"]
        for i in range(jcfg.vision.depth):
            enc[f"block{i}"] = jax.tree.map(lambda a, i=i: a[i], stacked)
        return {**tower, "encoder": enc}

    unrolled = {**params, "visual": unroll(params["visual"]), "textual": unroll(params["textual"])}
    a = params_from_jax(params, port_config(jcfg))
    b = params_from_jax(unrolled, port_config(jcfg))
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["visual.encoder.blocks.1.attn.q.weight"].shape == (32, 32)
    with pytest.raises(ValueError, match="does not match"):
        params_from_jax(params, port_config(tiny(t_pool="last")))


@pytest.mark.parametrize(
    "overrides,match",
    [
        ({"sequence_parallel_axis": "sp"}, "sequence_parallel_axis"),
        ({"moe_experts": 2}, "moe_experts"),
        ({"quant": "int8"}, "quant"),
        ({"quant_train": "int8"}, "quant"),
    ],
)
def test_unsupported_configs_raise(overrides, match):
    """Tower fields whose paths are not ported raise ``NotImplementedError``
    naming the field. ``quant`` and ``quant_train`` (the int8 projections,
    ported since) now build and run: finite unit embeddings, with the
    projections' dot swapped for the int8 one."""
    if match != "quant":
        with pytest.raises(NotImplementedError, match=match):
            SigLIP(port_config(tiny(**overrides)), device="cpu")
        return
    jcfg = tiny(**overrides)
    model = SigLIP(port_config(jcfg), device="cpu", generator=torch.Generator().manual_seed(0))
    mode = "int8_ste" if "quant_train" in overrides else "int8"
    assert model.visual.encoder.blocks[0].mlp.wi.quant == mode
    assert model.visual.proj.quant == "" and model.textual.map_head.attn.q.quant == ""
    images, tokens = inputs(jcfg)
    zi, zt = port_embed(model, images, tokens)
    assert np.isfinite(zi).all() and np.isfinite(zt).all()
    np.testing.assert_allclose(np.linalg.norm(zi, axis=-1), 1.0, atol=1e-5)


def test_flash_impl_at_a_long_sequence_builds_and_runs_k7(monkeypatch):
    """``attn_impl="flash"`` beyond the short kernel's fit (1,024 patches at
    dh=64, bf16) builds and runs the flash kernel, K7 (its plain version on
    CPU tensors), in every vision layer."""
    cfg = port_config(tiny(v_attn_impl="flash", v_image_size=256, v_patch_size=8, v_width=128,
                           v_num_heads=2, dtype="bfloat16"))
    model = SigLIP(cfg, device="cpu")
    assert not short_attention.short_attention_fits(1024, 128, 2, 2)
    monkeypatch.setattr(flash_attention, "flash_attention_available", lambda x: True)
    calls = []
    real = flash_attention.flash_self_attention

    def counted(q, *a, **kw):
        calls.append(tuple(q.shape))
        return real(q, *a, **kw)

    monkeypatch.setattr(flash_attention, "flash_self_attention", counted)
    images = np.random.default_rng(0).standard_normal((1, 256, 256, 3)).astype(np.float32)
    with torch.inference_mode():
        z = model.encode_image(torch.from_numpy(images))
    assert calls == [(1, 1024, 2, 64)] * cfg.vision.depth
    assert torch.isfinite(z).all() and abs(float(z.norm()) - 1) < 1e-5


def test_params_from_jax_takes_a_longer_patch_sequence():
    """A vision tower at a larger image size (256 patches of a tiny width):
    the position embedding carries over at its length and the towers agree."""
    jcfg = tiny(v_image_size=128)
    (zimg, ztxt), port, (images, tokens) = both_towers(jcfg)
    assert port.visual.pos_embed.shape == (1, 256, 32)
    pimg, ptxt = port_embed(port, images, tokens)
    np.testing.assert_allclose(pimg, zimg, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ptxt, ztxt, rtol=1e-4, atol=1e-5)


# 19² = 361 patches: JAX's flash kernel takes three 128-key blocks, the last ragged.
K7_IMAGE_SIZE = 152


def force_vision_onto_k7(monkeypatch, text_len: int) -> None:
    """In both packages: the fused kernels available on the CPU, and the
    short kernel's fit true only for the text tower's length, so the vision
    tower takes the flash kernel (JAX's in the Pallas interpreter under
    ``pltpu.force_tpu_interpret_mode``, the port's plain version)."""
    def fits_text_only(s, *args):
        return s <= text_len

    for module in (jax_flash_module, flash_attention):
        monkeypatch.setattr(module, "flash_attention_available", lambda *a: True)
    monkeypatch.setattr(jax_short_module, "short_attention_fits", fits_text_only)
    monkeypatch.setattr(short_attention, "short_attention_fits", fits_text_only)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_towers_on_k7_match_jax(monkeypatch, dtype):
    """The slice at a tiny width: the vision tower's self-attention on K7 in
    both packages (f32 through ``attn_impl="flash"``, bf16 through
    ``"auto"``); the text tower on dense (f32) or K1 (bf16)."""
    jcfg = tiny(v_image_size=K7_IMAGE_SIZE, dtype=dtype,
                v_attn_impl="flash" if dtype == "float32" else "auto")
    force_vision_onto_k7(monkeypatch, jcfg.text.context_length)
    calls = []
    real = flash_attention.flash_self_attention

    def counted(q, *a, **kw):
        calls.append(q.shape[1])
        return real(q, *a, **kw)

    monkeypatch.setattr(flash_attention, "flash_self_attention", counted)
    with pltpu.force_tpu_interpret_mode():
        (zimg, ztxt), port, (images, tokens) = both_towers(jcfg)
    pimg, ptxt = port_embed(port, images, tokens)
    assert calls == [361] * jcfg.vision.depth
    if dtype == "float32":
        # Observed: 3e-7.
        np.testing.assert_allclose(pimg, zimg, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(ptxt, ztxt, rtol=1e-4, atol=1e-5)
    else:
        # The bf16 towers' grade (test_bf16_towers_take_short_attention_and_match_jax):
        # the attention cores round alike, the unfused bias adds and GELU
        # do not (observed 6e-3).
        np.testing.assert_allclose(pimg, zimg, atol=1.5e-2)
        np.testing.assert_allclose(ptxt, ztxt, atol=1.5e-2)


def test_flash_impl_refuses_cpu_tensor_and_cross_attention():
    attn = transformer.Attention(8, 2, torch.float32, attn_impl="flash", device="cpu",
                                 generator=torch.Generator().manual_seed(0))
    x = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError, match="self-attention"):
        attn(x, x)
    with pytest.raises(ValueError, match="CUDA"):
        attn(x)


def test_entry_points_raise_without_cuda_when_no_device_given(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SigLIP(port_config(tiny()))


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(name: str) -> bool:
    return any(
        name == root or name.startswith(root + ".")
        for root in ("jax", "jaxlib", "flax", "distributed_sigmoid_loss_tpu")
    )


def test_port_imports_nothing_of_jax():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    bad = [(f.relative_to(REPO).as_posix(), n) for f in files for n in _imports(f) if _forbidden(n)]
    assert bad == []
    code = (
        "import sys, importlib, pkgutil\n"
        "import distributed_sigmoid_loss_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'distributed_sigmoid_loss_tpu')]\n"
        "assert not bad, bad\n"
        "need = ['obs.metrics_schema', 'obs.telemetry', 'serve.admission', 'serve.siege', "
        "'serve.shard_index', 'serve.ann', 'serve.swap', 'serve.fleet.leases', "
        "'serve.fleet.router', 'serve.fleet.waves', 'serve.fleet.scenarios']\n"
        "missing = [m for m in need if p.__name__ + '.' + m not in sys.modules]\n"
        "assert not missing, missing\n"
        "print(len([m for m in sys.modules if m.startswith(p.__name__)]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) > 20
