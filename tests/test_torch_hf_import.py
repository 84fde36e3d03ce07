"""The port's HF-format SigLIP import (``models/hf_import.py``) on the CPU:
the counterparts of ``tests/test_hf_import.py`` at the same tolerances, plus
the port's conversion against the JAX package's carried through
``params_from_jax``, and ``config_from_hf`` from a plain namespace.

A randomly initialized ``transformers.SiglipModel`` (tiny dims, built from a
config in code, nothing downloaded) is converted and must give the same
unnormalized image and text embeddings, covering every mapped tensor.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from distributed_sigmoid_loss_tpu.models.hf_import import (  # noqa: E402
    config_from_hf as jax_config_from_hf,
)
from distributed_sigmoid_loss_tpu.models.hf_import import (  # noqa: E402
    params_from_hf as jax_params_from_hf,
)
from distributed_sigmoid_loss_tpu_torch.models import (  # noqa: E402
    SigLIP,
    config_from_hf,
    params_from_hf,
    params_from_jax,
)
from distributed_sigmoid_loss_tpu_torch.models.convert import jax_leaves  # noqa: E402
from distributed_sigmoid_loss_tpu_torch.train import make_train_step  # noqa: E402
from distributed_sigmoid_loss_tpu_torch.train.train_step import (  # noqa: E402
    AdamW,
    create_train_state,
)
from distributed_sigmoid_loss_tpu_torch.utils.config import LossConfig  # noqa: E402

TEXT = {"hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 2,
        "intermediate_size": 64, "vocab_size": 64, "max_position_embeddings": 8,
        "projection_size": 32}
VISION = {"hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 2,
          "intermediate_size": 64, "image_size": 16, "patch_size": 8}


def _hf_model(seed=0, **intermediate):
    from transformers import SiglipConfig, SiglipModel

    cfg = SiglipConfig(text_config={**TEXT, **intermediate},
                       vision_config={**VISION, **intermediate})
    torch.manual_seed(seed)
    return SiglipModel(cfg).eval(), cfg


def _port_model(cfg, state):
    model = SigLIP(cfg, device="cpu")
    model.load_state_dict(state, strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def converted():
    hf_model, hf_cfg = _hf_model()
    cfg = config_from_hf(hf_cfg, dtype="float32")
    state = params_from_hf(hf_model.state_dict(), cfg)
    return hf_model, cfg, state


def _inputs(image_size=16, ctx=8, b=3):
    rng = np.random.default_rng(0)
    images = rng.standard_normal((b, image_size, image_size, 3)).astype(np.float32)
    tokens = rng.integers(0, 64, (b, ctx)).astype(np.int64)
    return images, tokens


def _image_features(hf_model, images):
    with torch.no_grad():
        out = hf_model.get_image_features(pixel_values=torch.from_numpy(images).permute(0, 3, 1, 2))
    return getattr(out, "pooler_output", out).numpy()


def test_image_embeddings_match(converted):
    hf_model, cfg, state = converted
    images, _ = _inputs()
    with torch.no_grad():
        got = _port_model(cfg, state).encode_image(torch.from_numpy(images), normalize=False)
    np.testing.assert_allclose(got.numpy(), _image_features(hf_model, images),
                               rtol=2e-4, atol=2e-5)


def test_text_embeddings_match(converted):
    hf_model, cfg, state = converted
    _, tokens = _inputs()
    with torch.no_grad():
        want = hf_model.get_text_features(input_ids=torch.from_numpy(tokens))
        got = _port_model(cfg, state).encode_text(torch.from_numpy(tokens), normalize=False)
    np.testing.assert_allclose(got.numpy(), getattr(want, "pooler_output", want).numpy(),
                               rtol=2e-4, atol=2e-5)


def test_loss_scalars_and_logits_match(converted):
    hf_model, cfg, state = converted
    assert float(state["t_prime"]) == float(hf_model.logit_scale.detach())
    assert float(state["bias"]) == float(hf_model.logit_bias.detach())
    images, tokens = _inputs()
    with torch.no_grad():
        out = hf_model(pixel_values=torch.from_numpy(images).permute(0, 3, 1, 2),
                       input_ids=torch.from_numpy(tokens))
        zimg, ztxt, lp = _port_model(cfg, state)(torch.from_numpy(images),
                                                 torch.from_numpy(tokens))
        logits_per_text = ztxt @ zimg.T * torch.exp(lp["t_prime"]) + lp["bias"]
    np.testing.assert_allclose(logits_per_text.numpy(), out.logits_per_text.numpy(),
                               rtol=2e-4, atol=2e-4)


def test_stack_for_scan_equivalent(converted):
    """JAX's ``stack_for_scan`` restacks the blocks for ``scan_layers=True``;
    the port keeps one tensor per layer under either layout, so the same
    state dict loads into the scanned config and gives the same embeddings.
    The scanned config does change the JAX leaves (one stacked leaf per
    block parameter), which is all ``scan_layers`` means in the port."""
    _, cfg, state = converted
    images, _ = _inputs()
    scan_cfg = dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, scan_layers=True))
    with torch.no_grad():
        unscanned = _port_model(cfg, state).encode_image(torch.from_numpy(images),
                                                         normalize=False)
        scan_model = _port_model(scan_cfg, state)
        scanned = scan_model.encode_image(torch.from_numpy(images), normalize=False)
    np.testing.assert_allclose(scanned.numpy(), unscanned.numpy(), rtol=1e-5, atol=1e-6)
    stacked = [leaf for leaf in jax_leaves(scan_model) if leaf.stacked]
    assert stacked and all(len(leaf.members) == cfg.vision.depth for leaf in stacked)


def test_fractional_mlp_ratio_so400m_shape():
    """so400m-class checkpoints have an intermediate_size that is not an
    integer multiple of hidden_size (4304/1152); a tiny analogue (52/32)
    converts and matches."""
    hf_model, hf_cfg = _hf_model(seed=1, intermediate_size=52)
    cfg = config_from_hf(hf_cfg, dtype="float32")
    state = params_from_hf(hf_model.state_dict(), cfg)
    assert tuple(state["visual.encoder.blocks.0.mlp.wi.weight"].shape) == (52, 32)
    images, _ = _inputs()
    with torch.no_grad():
        got = _port_model(cfg, state).encode_image(torch.from_numpy(images), normalize=False)
    np.testing.assert_allclose(got.numpy(), _image_features(hf_model, images),
                               rtol=2e-4, atol=2e-5)


def test_hf_shaped_model_trains(converted):
    """The HF-shaped architecture (last-token pooling, no vision projection)
    runs the train step from the converted weights: a finite loss, nonzero
    gradients, and the loss scalars moved."""
    _, cfg, state = converted
    model = _port_model(cfg, state).train()
    tx = AdamW(lambda count: 1e-3, b1=0.9, b2=0.999, weight_decay=0.0)
    train_state = create_train_state(model, tx)
    step = make_train_step(model, LossConfig(precision="highest"))
    images, tokens = _inputs(b=8)
    t_prime_before = float(model.t_prime.detach())
    _, metrics = step(train_state, {"images": torch.from_numpy(images),
                                    "tokens": torch.from_numpy(tokens.astype(np.int32))})
    assert np.isfinite(float(metrics["loss"]))
    assert float(metrics["grad_norm"]) > 0
    assert float(model.t_prime.detach()) != t_prime_before


def test_params_from_hf_rejects_wrong_shape_cfg(converted):
    hf_model, cfg, _ = converted
    bad = dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, use_proj=True))
    with pytest.raises(ValueError, match="HF-shaped"):
        params_from_hf(hf_model.state_dict(), bad)


def test_params_from_hf_equals_jax_conversion_tensor_for_tensor(converted):
    """The port's conversion equals the JAX package's ``params_from_hf``
    carried into the port's layout by ``params_from_jax``, bitwise."""
    hf_model, cfg, state = converted
    jcfg = jax_config_from_hf(hf_model.config, dtype="float32")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    carried = params_from_jax(jax_params_from_hf(hf_model.state_dict(), jcfg), cfg)
    assert set(carried) == set(state)
    for name, t in state.items():
        assert t.dtype == torch.float32 and t.is_contiguous(), name
        torch.testing.assert_close(t, carried[name], rtol=0, atol=0, msg=name)


def _namespace(vision=None, text=None):
    return types.SimpleNamespace(vision_config=types.SimpleNamespace(**{**VISION, **(vision or {})}),
                                 text_config=types.SimpleNamespace(**{**TEXT, **(text or {})}))


def test_config_from_hf_from_a_namespace(converted):
    """``config_from_hf`` reads attributes only: a namespace of the HF fields
    gives the config a ``SiglipConfig`` does (how weights are imported where
    ``transformers`` is not installed), with JAX's refusals."""
    hf_model, cfg, _ = converted
    assert config_from_hf(_namespace(), dtype="float32") == cfg
    assert config_from_hf(_namespace()).vision.dtype == "bfloat16"
    with pytest.raises(ValueError, match="must divide hidden_size"):
        config_from_hf(_namespace(vision={"num_attention_heads": 3}))
    with pytest.raises(ValueError, match="shared embedding space"):
        config_from_hf(_namespace(text={"projection_size": 16}))
