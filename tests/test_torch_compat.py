"""The port's reference loss classes (``compat.py``: ``DDPSigmoidLoss``,
``SigLipLoss``) against the JAX package's ``compat.py`` at the reference's
configurations (W=3, bz=3, d=2; W=2, bz=4, d ∈ {2, 128, 512}), and the
port's copy of the reference's data recipe (``utils/parity_data.py``)
against the JAX package's.

The port's classes run over gloo, one process per rank on its own rows
(``tests/_torch_slice_workers.py``), the gradients averaged over the ranks
afterwards; JAX's run on a W-device CPU mesh with the global arrays. The
loss, the loss scalars' gradients and the toy encoders' gradients agree at
rtol 1e-4, the encoders' gradients with an absolute floor of 1e-5 of their
largest magnitude: their entries are f32 sums of terms up to ~12 that
cancel near zero (at d = 512 an f32 run of the whole pipeline sits up to
8.6e-6 from an f64 one, with gradients up to 12.6).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_worker as dist_worker
import _torch_slice_workers as workers
from distributed_sigmoid_loss_tpu.compat import DDPSigmoidLoss as JaxDDPSigmoidLoss
from distributed_sigmoid_loss_tpu.compat import SigLipLoss as JaxSigLipLoss
from distributed_sigmoid_loss_tpu.ops.sigmoid_loss import l2_normalize
from distributed_sigmoid_loss_tpu.parallel import make_mesh
from distributed_sigmoid_loss_tpu.utils import parity_data as jax_parity
from distributed_sigmoid_loss_tpu_torch.compat import DDPSigmoidLoss, SigLipLoss
from distributed_sigmoid_loss_tpu_torch.parallel.api import make_sharded_loss_fn
from distributed_sigmoid_loss_tpu_torch.utils import parity_data as port_parity

CONFIGS = {3: [(3, 2)], 2: [(4, 2), (4, 128), (4, 512)]}
CASES = [(w, bz, d) for w, cfgs in CONFIGS.items() for bz, d in cfgs]
RTOL, TOWER_ATOL_OF_MAX = 1e-4, 1e-5


@functools.cache
def jax_result(world, bz, d, cls):
    img, txt = jax_parity.reference_partition(world, bz, d)
    wi, wt = jax_parity.reference_encoder_weights(d)
    mesh = make_mesh(world)
    if cls == "ddp":
        mod = JaxDDPSigmoidLoss(gpu_batch_size=bz, mesh=mesh)
        names = ("t_prime", "bias")
    else:
        mod = JaxSigLipLoss(world_size=world, mesh=mesh)
        names = ("logit_scale", "logit_bias")

    def objective(p):
        zimg = l2_normalize(jnp.asarray(img) @ p["wi"].T)
        ztxt = l2_normalize(jnp.asarray(txt) @ p["wt"].T)
        return mod.apply(p["loss"], zimg, ztxt)

    params = {"loss": mod.init_params(), "wi": jnp.asarray(wi), "wt": jnp.asarray(wt)}
    loss, g = jax.value_and_grad(objective)(params)
    return {"loss": float(loss), "wi": np.asarray(g["wi"]), "wt": np.asarray(g["wt"]),
            "t_prime": float(g["loss"][names[0]]), "bias": float(g["loss"][names[1]])}


@pytest.fixture(scope="module")
def port_results(tmp_path_factory):
    """Each rank's results per world size, one spawn per W."""
    cache = {}

    def get(world):
        if world not in cache:
            cache[world] = dist_worker.spawn(workers.compat_worker, world, (CONFIGS[world],),
                                             tmp_path_factory.mktemp(f"compat_w{world}"))
        return cache[world]

    return get


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("cls", ["ddp", "siglip"])
@pytest.mark.parametrize("world,bz,d", CASES)
def test_class_matches_jax_compat(port_results, world, bz, d, cls, use_pallas):
    # At these shapes the streaming kernel's dispatch refuses the blocks
    # (d % 128 or local_b % 8), in both packages: use_pallas takes the plain
    # block, and JAX's result without it is the reference for both.
    ref = jax_result(world, bz, d, cls)
    for r, res in enumerate(port_results(world)):
        got = res[f"{bz}/{d}/{cls}/{int(use_pallas)}"]
        np.testing.assert_allclose(got["loss"].item(), ref["loss"], rtol=RTOL,
                                   err_msg=f"rank {r}")
        for k in ("wi", "wt"):
            np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=RTOL,
                                       atol=TOWER_ATOL_OF_MAX * np.abs(ref[k]).max(),
                                       err_msg=f"rank {r} {k}")
        for k in ("t_prime", "bias"):
            np.testing.assert_allclose(got[k].item(), ref[k], rtol=RTOL, err_msg=f"rank {r} {k}")


@pytest.mark.parametrize("world,bz,d", CASES)
def test_ddp_class_matches_siglip_class(port_results, world, bz, d):
    """The reference's variant oracle (all-gather ≡ ring) on the classes:
    one package, two orders of the same f32 sums; rtol 1e-5, each gradient
    with a floor of 1e-6 of its largest magnitude."""
    for res in port_results(world):
        for up in (0, 1):
            a, b = res[f"{bz}/{d}/ddp/{up}"], res[f"{bz}/{d}/siglip/{up}"]
            for k in ("loss", "wi", "wt", "t_prime", "bias"):
                want = b[k].numpy()
                np.testing.assert_allclose(a[k].numpy(), want, rtol=1e-5,
                                           atol=1e-6 * np.abs(want).max(), err_msg=k)


@pytest.mark.parametrize("world", sorted(CONFIGS))
def test_classes_refuse_mismatched_ranks_and_rows(port_results, world):
    for res in port_results(world):
        refusals = res["refusals"]
        assert f"world_size={world + 1}" in refusals["world_size"]
        assert "rank=" in refusals["rank"]
        assert "gpu_batch_size" in refusals["gpu_batch_size"]


def _unit(rng, n, d):
    return torch.from_numpy(workers.unit_rows(rng, n, d))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_classes_equal_the_function_bitwise(use_pallas):
    rng = np.random.default_rng(0)
    zimg, ztxt = _unit(rng, 16, 128), _unit(rng, 16, 128)
    ddp = DDPSigmoidLoss(gpu_batch_size=16, use_pallas=use_pallas, device="cpu")
    p = SigLipLoss.init_params(device="cpu")
    for variant, got in (
        ("all_gather", ddp(zimg, ztxt)),
        ("ring", SigLipLoss(use_pallas=use_pallas)(zimg, ztxt, p["logit_scale"],
                                                   p["logit_bias"])),
    ):
        fn = make_sharded_loss_fn(variant=variant, use_pallas=use_pallas)
        want = fn({"t_prime": torch.tensor(np.log(10.0), dtype=torch.float32),
                   "bias": torch.tensor(-10.0)}, zimg, ztxt)
        assert torch.equal(got, want), variant


def test_output_dict_and_single_process_refusals():
    rng = np.random.default_rng(1)
    zimg, ztxt = _unit(rng, 8, 4), _unit(rng, 8, 4)
    mod = SigLipLoss(cache_labels=True, rank=0, world_size=1)
    p = SigLipLoss.init_params(device="cpu")
    out = mod(zimg, ztxt, p["logit_scale"], p["logit_bias"], output_dict=True)
    assert set(out) == {"contrastive_loss"}
    assert torch.equal(out["contrastive_loss"],
                       mod(zimg, ztxt, p["logit_scale"], p["logit_bias"]))
    with pytest.raises(NotImplementedError, match="horovod"):
        SigLipLoss(use_horovod=True)
    with pytest.raises(ValueError, match="world_size=2"):
        SigLipLoss(world_size=2)
    with pytest.raises(ValueError, match="gpu_batch_size"):
        DDPSigmoidLoss(gpu_batch_size=4, device="cpu")(zimg, ztxt)
    ddp = DDPSigmoidLoss(device="cpu")
    assert {n for n, _ in ddp.named_parameters()} == {"t_prime", "bias"}
    ddp(zimg, ztxt).backward()
    assert ddp.bias.grad is not None and ddp.bias.grad.item() != 0.0


def test_loss_classes_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DDPSigmoidLoss()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SigLipLoss.init_params()


@pytest.mark.parametrize("world,bz,d", CASES + [(1, 8, 16), (4, 8, 16)])
def test_parity_data_is_jaxs_bitwise(world, bz, d):
    for got, want in zip(port_parity.reference_partition(world, bz, d),
                         jax_parity.reference_partition(world, bz, d)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    for got, want in zip(port_parity.reference_encoder_weights(d),
                         jax_parity.reference_encoder_weights(d)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
