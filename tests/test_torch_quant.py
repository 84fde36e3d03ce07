"""The port's int8 path (``ops/quant.py``, the towers' int8 projections) vs
the JAX package's ``ops/quant.py`` and int8 towers, on the CPU.

Inputs come from numpy seeds and go through both packages. The quantization
itself is held bitwise (codes and scales); the int8 product bitwise given
JAX's own quantized operands; the straight-through backward exactly to
``F.linear``'s gradient; the towers with ``quant="int8"`` and
``quant_train="int8"`` at the tolerances of the full-precision tower tests.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_towers import both_towers, inputs, port_config, port_embed, tiny

from distributed_sigmoid_loss_tpu.models.siglip import SigLIP as JaxSigLIP
from distributed_sigmoid_loss_tpu.ops import quant as jq
from distributed_sigmoid_loss_tpu_torch.models import SigLIP, transformer
from distributed_sigmoid_loss_tpu_torch.ops import flash_attention, quant


def _x(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("axis", [0, 1, -1])
def test_quantize_int8_codes_and_scales_equal_jax(axis, dtype):
    # Rows of several magnitudes, an all-zero row (the 1e-12 floor) and
    # exact halves of a step (round half to even on both sides).
    x = _x((6, 40), 0, 3.0)
    x[2] = 0.0
    x[3, :4] = [127.0, 63.5, -0.5, 1.5]
    jx = jnp.asarray(x, dtype)
    px = torch.from_numpy(x).to(getattr(torch, dtype))
    jqv, jsv = jq.quantize_int8(jx, axis)
    pqv, psv = quant.quantize_int8(px, axis)
    assert pqv.dtype == torch.int8 and psv.dtype == torch.float32
    assert pqv.shape == jqv.shape and psv.shape == jsv.shape
    # Codes equal; scales bitwise equal (the same f32 division by 127).
    np.testing.assert_array_equal(pqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(psv.numpy(), np.asarray(jsv))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_product_is_bitwise_jax_on_jax_operands(dtype):
    """Given JAX's own (q, scale) of both operands, the port's dequantized
    product is bitwise JAX's ``int8_dot_general`` (the int32 sum is exact,
    then the same two f32 multiplies in the same order)."""
    x, w = _x((3, 5, 64), 1), _x((24, 64), 2, 0.2)
    jx, jw = jnp.asarray(x, dtype), jnp.asarray(w, dtype)
    # flax's Dense pattern: x (..., K) against a kernel (K, out).
    ref = jq.int8_dot_general(jx, jw.T, (((2,), (0,)), ((), ())))
    xq, xs = jq.quantize_int8(jx, 2)
    wq, ws = jq.quantize_int8(jw, 1)
    got = quant.int8_product(*(torch.from_numpy(np.array(a)) for a in (xq, xs, wq, ws)),
                             getattr(torch, dtype))
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))
    # And from the unquantized operands, the port quantizing them itself.
    mine = quant.int8_dot_general(torch.from_numpy(x).to(getattr(torch, dtype)),
                                  torch.from_numpy(w).to(getattr(torch, dtype)))
    np.testing.assert_array_equal(mine.float().numpy(), np.asarray(ref, np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ste_forward_is_the_int8_dense_and_backward_is_linears_gradient(dtype):
    x = torch.from_numpy(_x((2, 7, 32), 3)).to(dtype)
    w = torch.from_numpy(_x((16, 32), 4, 0.2)).to(dtype)
    b = torch.from_numpy(_x((16,), 5, 0.1)).to(dtype)
    g = torch.from_numpy(_x((2, 7, 16), 6)).to(dtype)
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    y = quant.Int8DenseSTE.apply(*leaves)
    assert torch.equal(y, quant.int8_linear(x, w, b))
    assert torch.equal(y, quant.int8_dot_general(x, w, dtype) + b)
    got = torch.autograd.grad(y, leaves, g)
    ref_leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    ref = torch.autograd.grad(F.linear(*ref_leaves), ref_leaves, g)
    for a, r in zip(got, ref):
        assert a.dtype == r.dtype and torch.equal(a, r)


@pytest.mark.parametrize("frozen", [0, 1, 2])
def test_ste_backward_gives_only_the_gradients_asked_for(frozen):
    """With one of x, weight and bias frozen, the STE returns no gradient for
    it and F.linear's exact gradient for the others; a 2-D x as well."""
    x = torch.from_numpy(_x((9, 24), 7))
    w = torch.from_numpy(_x((8, 24), 8, 0.2))
    b = torch.from_numpy(_x((8,), 9, 0.1))
    g = torch.from_numpy(_x((9, 8), 10))
    leaves = [t.clone().requires_grad_(i != frozen) for i, t in enumerate((x, w, b))]
    quant.Int8DenseSTE.apply(*leaves).backward(g)
    ref_leaves = [t.clone().requires_grad_(i != frozen) for i, t in enumerate((x, w, b))]
    F.linear(*ref_leaves).backward(g)
    for i, (a, r) in enumerate(zip(leaves, ref_leaves)):
        if i == frozen:
            assert a.grad is None
        else:
            assert torch.equal(a.grad, r.grad)


def test_int8_product_counts_its_calls_and_takes_any_cpu_shape():
    quant.reset_int_mm_calls()
    out = quant.int8_matmul(torch.ones(1, 3, dtype=torch.int8), torch.ones(2, 3, dtype=torch.int8))
    assert out.dtype == torch.int32 and out.tolist() == [[3, 3]]
    assert quant.int_mm_calls() == 1


def test_dense_quant_modes():
    d = transformer.Dense(8, 4, torch.float32, quant="int8_ste", device="cpu",
                          generator=torch.Generator().manual_seed(0))
    x = torch.randn(3, 8, generator=torch.Generator().manual_seed(1))
    y = d(x)
    assert torch.equal(y, quant.int8_linear(x, d.weight, d.bias))
    with pytest.raises(ValueError, match="unknown quant mode"):
        transformer.Dense(8, 4, torch.float32, quant="int4", device="cpu")


@pytest.mark.parametrize("field", ["quant", "quant_train"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_towers_match_jax(monkeypatch, field, dtype):
    """The tiny towers with int8 projections (inference ``quant`` or the
    STE's ``quant_train``, whose forward is the same) against JAX's from the
    same weights: f32 at rtol 1e-4, bf16 at the bf16 tower tests' 1.5e-2
    (the port's bf16 attention is the fused path's plain version)."""
    if dtype == "bfloat16":
        monkeypatch.setattr(flash_attention, "flash_attention_available", lambda x: True)
    (zimg, ztxt), port, (images, tokens) = both_towers(tiny(dtype=dtype, **{field: "int8"}))
    blocks = port.visual.encoder.blocks[0]
    assert blocks.attn.q.quant == blocks.mlp.wo.quant == ("int8_ste" if field == "quant_train"
                                                          else "int8")
    pimg, ptxt = port_embed(port, images, tokens)
    if dtype == "float32":
        np.testing.assert_allclose(pimg, zimg, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(ptxt, ztxt, rtol=1e-4, atol=1e-5)
    else:
        np.testing.assert_allclose(pimg, zimg, atol=1.5e-2)
        np.testing.assert_allclose(ptxt, ztxt, atol=1.5e-2)
    # The int8 towers are not the full-precision ones: the projections did
    # change the embeddings, by the int8 grade.
    full = SigLIP(port_config(tiny(dtype=dtype)), device="cpu")
    full.load_state_dict(port.state_dict())
    fimg, _ = port_embed(full, images, tokens)
    assert 0 < np.abs(fimg - pimg).max() < 0.1


def test_quant_and_quant_train_together_raise_as_jax():
    jcfg = tiny(quant="int8", quant_train="int8")
    with pytest.raises(ValueError, match="mutually exclusive"):
        SigLIP(port_config(jcfg), device="cpu")


def test_int8_ste_tower_gradient_is_the_full_precision_vjp_at_the_int8_point():
    """Through a whole tower: the STE tower's parameter gradients equal those
    of the full-precision tower whose every block projection is replaced by
    a layer with the int8 forward value and the full-precision gradient."""
    jcfg = tiny(quant_train="int8")
    model = SigLIP(port_config(jcfg), device="cpu", generator=torch.Generator().manual_seed(0))
    images, _ = inputs(jcfg)
    z = model.encode_image(torch.from_numpy(images), normalize=False)
    z.square().sum().backward()
    got = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}

    class Straight(torch.autograd.Function):
        @staticmethod
        def forward(ctx, y_full, y_int8):
            return y_int8

        @staticmethod
        def backward(ctx, g):
            return g, None

    ref_model = SigLIP(port_config(dataclasses.replace(
        jcfg, vision=dataclasses.replace(jcfg.vision, quant_train=""))), device="cpu")
    ref_model.load_state_dict(model.state_dict())
    for dense in (m for m in ref_model.visual.encoder.modules() if isinstance(m, transformer.Dense)):
        def forward(x, d=dense):
            x, w, b = x.to(d.dtype), d.weight.to(d.dtype), d.bias.to(d.dtype)
            return Straight.apply(F.linear(x, w, b), quant.int8_linear(x.detach(), w.detach(),
                                                                       b.detach()))
        dense.forward = forward
    ref_model.encode_image(torch.from_numpy(images), normalize=False).square().sum().backward()
    for n, p in ref_model.named_parameters():
        if n in got:
            torch.testing.assert_close(got[n], p.grad, rtol=1e-5, atol=1e-7, msg=n)


def _int8_dot_generals(jaxpr) -> int:
    """The ``dot_general``s with int8 operands in a closed jaxpr, nested
    jaxprs (remat, scan bodies, custom rules) included."""
    n = 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general" and all(
                v.aval.dtype == jnp.int8 for v in eqn.invars):
            n += 1
        for value in eqn.params.values():
            for sub in value if isinstance(value, (list, tuple)) else (value,):
                if hasattr(sub, "eqns"):
                    n += _int8_dot_generals(sub)
                elif hasattr(sub, "jaxpr") and hasattr(sub.jaxpr, "eqns"):
                    n += _int8_dot_generals(sub.jaxpr)
    return n


@pytest.mark.parametrize("scan_layers", [False, True])
def test_save_hot_recomputes_the_int8_products_jax_recomputes(monkeypatch, scan_layers):
    """Under ``remat_policy="save_hot"`` with both towers training in int8,
    the port runs as many int8 products a layer as JAX's jaxpr holds: six
    in the forward (q, k, v, out, wi, wo) and four again in the backward's
    recompute (q, k, v and out; nothing reads wo's product there, and wi's
    is kept). The gradients stay bitwise those without remat."""
    jcfg = tiny(quant_train="int8", dtype="bfloat16", remat=True, remat_policy="save_hot",
                scan_layers=scan_layers)
    images, tokens = inputs(jcfg)
    jmodel = JaxSigLIP(jcfg)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), images, tokens)["params"]

    def jloss(p):
        zi, zt, _ = jmodel.apply({"params": p}, images, tokens)
        return jnp.sum(zi.astype(jnp.float32)) + jnp.sum(zt.astype(jnp.float32))

    jfwd = _int8_dot_generals(jax.make_jaxpr(jloss)(params).jaxpr)
    jgrad = _int8_dot_generals(jax.make_jaxpr(jax.value_and_grad(jloss))(params).jaxpr)
    # A scanned tower's jaxpr holds its layer body once.
    layers = 2 if scan_layers else jcfg.vision.depth + jcfg.text.depth
    assert (jfwd / layers, (jgrad - jfwd) / layers) == (6, 4)

    monkeypatch.setattr(flash_attention, "flash_attention_available", lambda x: True)
    depth = jcfg.vision.depth + jcfg.text.depth
    grads = {}
    for remat in (True, False):
        cfg = port_config(tiny(quant_train="int8", dtype="bfloat16", remat=remat,
                               remat_policy="save_hot"))
        model = SigLIP(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
        quant.reset_int_mm_calls()
        zi, zt, _ = model(torch.from_numpy(images), torch.from_numpy(tokens))
        fwd = quant.int_mm_calls()
        (zi.float().sum() + zt.float().sum()).backward()
        if remat:
            assert (fwd / depth, (quant.int_mm_calls() - fwd) / depth) == (6, 4)
        grads[remat] = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    for n, g in grads[False].items():
        assert torch.equal(grads[True][n], g), n
