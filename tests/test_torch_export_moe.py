"""The MoE export at ep = 1 (``train/export.py`` over the MoE towers, the
``export --moe-*`` flags) on the CPU.

- The forward artifacts of MoE towers (top-1 and top-2, a capacity that
  drops tokens) replay bitwise equal to the traced function called live,
  and the expert product of int8 towers is in the forward's graph as its
  op.
- The train step: ``test_torch_export_moe_step.py``.
- ``export --moe-experts --moe-group-size`` writes a checkable forward.
"""

import dataclasses

import flax.linen as nn
import jax
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from distributed_sigmoid_loss_tpu.models.siglip import SigLIP as JaxSigLIP
from distributed_sigmoid_loss_tpu.utils import config as jc
from distributed_sigmoid_loss_tpu_torch import cli
from distributed_sigmoid_loss_tpu_torch.models import SigLIP, params_from_jax
from distributed_sigmoid_loss_tpu_torch.train import (
    export_step,
    load_exported,
    save_exported,
    tree_leaves,
)
from distributed_sigmoid_loss_tpu_torch.utils import config as pc



def jax_config(k=1, cf=1.25, **extra) -> jc.SigLIPConfig:
    """tiny_test at depth 1 (the traces dominate the file's time), four
    experts, routing groups of 8, top-2 in the text tower."""
    cfg = jc.SigLIPConfig.tiny_test()
    moe = dict(depth=1, moe_experts=4, moe_group_size=8, moe_capacity_factor=cf, **extra)
    return dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, moe_num_selected=k, **moe),
        text=dataclasses.replace(cfg.text, moe_num_selected=2, **moe))


def port_config(jcfg) -> pc.SigLIPConfig:
    return pc.SigLIPConfig(vision=pc.ViTConfig(**dataclasses.asdict(jcfg.vision)),
                           text=pc.TextConfig(**dataclasses.asdict(jcfg.text)),
                           loss=pc.LossConfig(**dataclasses.asdict(jcfg.loss)))


def data(n=8, seed=1):
    rng = np.random.default_rng(seed)
    return {"images": rng.standard_normal((n, 16, 16, 3)).astype(np.float32),
            "tokens": rng.integers(0, 64, (n, 8)).astype(np.int32)}


def jax_params(jcfg):
    b = data(2)
    params = JaxSigLIP(jcfg).init(jax.random.key(0), b["images"], b["tokens"])["params"]
    return jax.tree.map(np.asarray, nn.meta.unbox(params))


def assert_bitwise(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g.detach(), w.detach())


@pytest.mark.parametrize("k,cf,quant", [(1, 0.5, ""), (2, 1.25, ""), (1, 1.25, "int8")])
def test_moe_forward_artifact_replays_bitwise(tmp_path, k, cf, quant):
    jcfg = jax_config(k, cf, **({"quant": quant} if quant else {}))
    pcfg = port_config(jcfg)
    model = SigLIP(pcfg, device="cpu")
    model.load_state_dict(params_from_jax(jax_params(jax_config(k, cf)), pcfg))
    b = {key: torch.from_numpy(v) for key, v in data().items()}

    def fn(params, images, tokens):
        zimg, ztxt, _ = torch.func.functional_call(model, params, (images, tokens))
        return zimg, ztxt

    example = (dict(model.state_dict()), b["images"], b["tokens"])
    exported = export_step(fn, example)
    save_exported(tmp_path / "fwd.pt2", exported)
    loaded = load_exported(tmp_path / "fwd.pt2")
    if quant:
        program = getattr(loaded, "exported", None) or loaded.program
        ops = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
        assert "dsl_torch_port.int8_expert_matmul.default" in ops
    got = loaded.call(*tree_leaves(pytree.tree_map(torch.clone, example)))
    with torch.no_grad():
        assert_bitwise(got, tree_leaves(fn(*example)))


def test_cli_exports_the_moe_forward(tmp_path, capsys):
    """The flags reach the towers (the train step's artifact is the one
    above; ``chip_smoke.py``'s ``[export_moe]`` drives both through the
    command on the card)."""
    out = tmp_path / "forward.pt2"
    argv = ["export", str(out), "--tiny", "--cpu-devices", "1", "--batch", "8", "--what",
            "forward", "--moe-experts", "4", "--moe-group-size", "8", "--check"]
    assert cli.main(argv) == 0
    assert "check ok" in capsys.readouterr().out
    assert out.exists()


EXPORT_REFUSED = [
    ["--what", "forward", "--moe-experts", "4", "--ep", "2"],
    ["--ep", "2"],
    ["--moe-experts", "4", "--ep", "3"],
]


@pytest.mark.parametrize("flags", EXPORT_REFUSED, ids=[" ".join(f) for f in EXPORT_REFUSED])
def test_export_ep_refusals_exit_like_jax(tmp_path, flags):
    """JAX's export and the port's exit 2 on the same flags: ``--ep`` with a
    forward, ``--ep`` without experts (the same last line), and an ``--ep``
    that divides neither JAX's 8 virtual devices nor the port's one
    process."""
    import contextlib
    import io

    from distributed_sigmoid_loss_tpu import cli as jax_cli

    err = io.StringIO()
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(err):
        want_rc = jax_cli.main(["export", str(tmp_path / "jax.bin"), "--tiny", *flags])
    got = io.StringIO()
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(got):
        rc = cli.main(["export", str(tmp_path / "port.pt2"), "--tiny", "--cpu-devices", "1",
                       *flags])
    assert rc == want_rc == 2
    if "--what" in flags or "--moe-experts" not in flags:
        assert (got.getvalue().strip().splitlines()[-1]
                == err.getvalue().strip().splitlines()[-1])
    assert not (tmp_path / "port.pt2").exists()
