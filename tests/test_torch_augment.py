"""The port's augmentation (``data/augment.py``, torch) against the JAX
package's (``jax.image`` on the CPU).

The draws and the transforms are apart in the port, so JAX's draws for a
key go into the port's transforms: the crop-resize (down- and upscaling
boxes) equals ``jax.image.scale_and_translate`` with JAX's arguments, the
flip and the color jitter equal JAX's, ``normalize`` and the eval
``augment_batch`` (``jax.image.resize``) too, all within 1e-5 in f32. With
a fixed ``torch.Generator`` the train transform repeats bitwise, and the
drawn boxes keep to the ``scale`` and ``ratio`` ranges.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_sigmoid_loss_tpu.data import augment as ja
from distributed_sigmoid_loss_tpu_torch.data import augment as pa

TOL = 1e-5
SCALE, RATIO = (0.08, 1.0), (3 / 4, 4 / 3)


def images(b, h, w, seed=0):
    return np.random.default_rng(seed).random((b, h, w, 3)).astype(np.float32)


def jax_boxes(key, b, h, w):
    """JAX's crop draws for ``key``: one box per sample from its split key,
    as ``random_resized_crop`` draws them."""
    boxes = jax.vmap(lambda k: ja._sample_crop_box(k, h, w, SCALE, RATIO))(
        jax.random.split(key, b))
    return [np.asarray(x) for x in boxes]


def jax_crop(x, boxes, out):
    """JAX's crop-resize of ``random_resized_crop`` on given boxes: the same
    ``jax.image.scale_and_translate`` call."""

    def one(img, crop_h, crop_w, top, left):
        scale_hw = jnp.stack([out / crop_h, out / crop_w])
        translation = jnp.stack([-top * out / crop_h, -left * out / crop_w])
        return jax.image.scale_and_translate(
            img, (out, out, img.shape[-1]), (0, 1, 2), jnp.concatenate([scale_hw, jnp.ones(1)]),
            jnp.concatenate([translation, jnp.zeros(1)]), method="bilinear")

    return np.asarray(jax.jit(jax.vmap(one))(jnp.asarray(x), *map(jnp.asarray, boxes)))


# (h, w, out): boxes smaller and larger than the output, both directions.
CROPS = [(240, 320, 224), (224, 224, 224), (40, 56, 16), (12, 10, 24), (300, 97, 64)]


@pytest.mark.parametrize("h,w,out", CROPS, ids=[f"{h}x{w}->{o}" for h, w, o in CROPS])
def test_crop_resize_on_jaxs_draws_is_jaxs(h, w, out):
    b = 6
    x = images(b, h, w, seed=h)
    for seed in range(2):
        boxes = jax_boxes(jax.random.key(seed), b, h, w)
        want = jax_crop(x, boxes, out)
        got = pa.crop_and_resize(torch.from_numpy(x), *map(torch.tensor, boxes), out)
        assert got.shape == want.shape == (b, out, out, 3)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_flip_on_jaxs_draws_is_jaxs():
    x = images(8, 5, 7)
    key = jax.random.key(1)
    flips = np.asarray(jax.random.bernoulli(key, 0.5, (8,)))
    want = np.asarray(ja.random_flip(key, jnp.asarray(x)))
    got = pa.flip(torch.from_numpy(x), torch.tensor(flips))
    assert 0 < flips.sum() < 8
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("amount", [0.0, 0.4, 0.9])
def test_color_jitter_on_jaxs_draws_is_jaxs(amount):
    b = 6
    x = images(b, 9, 11, seed=2)
    key = jax.random.key(4)
    factors = [np.asarray(jax.random.uniform(k, (b, 1, 1, 1), minval=1.0 - amount,
                                             maxval=1.0 + amount))
               for k in jax.random.split(key, 3)]
    want = np.asarray(ja.color_jitter(key, jnp.asarray(x), amount, amount, amount))
    got = pa.jitter(torch.from_numpy(x), *map(torch.from_numpy, factors))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    assert got.min() >= 0.0 and got.max() <= 1.0


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_normalize_is_jaxs(dtype):
    x = images(2, 4, 4) if dtype == np.float32 else \
        np.random.default_rng(0).integers(0, 256, (2, 4, 4, 3), dtype=np.uint8)
    for mean, std in (((0.5, 0.5, 0.5), (0.5, 0.5, 0.5)), ((0.48, 0.46, 0.41), (0.27, 0.26, 0.28))):
        want = np.asarray(ja.normalize(jnp.asarray(x), mean, std))
        got = pa.normalize(torch.from_numpy(x), mean, std)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


EVALS = [(240, 320, 224), (16, 16, 224), (97, 300, 64), (224, 224, 224), (12, 10, 24)]


@pytest.mark.parametrize("h,w,out", EVALS, ids=[f"{h}x{w}->{o}" for h, w, o in EVALS])
def test_eval_transform_is_jax_image_resize(h, w, out):
    x = images(3, h, w, seed=w)
    key = jax.random.key(0)
    want = np.asarray(ja.augment_batch(key, jnp.asarray(x), out, train=False))
    got = pa.augment_batch(torch.Generator().manual_seed(0), torch.from_numpy(x), out,
                           train=False)
    assert got.shape == want.shape == (3, out, out, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    pixels = (x * 255).astype(np.uint8)  # integer input: [0, 255] pixels
    want = np.asarray(ja.augment_batch(key, jnp.asarray(pixels), out, train=False))
    got = pa.augment_batch(None, torch.from_numpy(pixels), out, train=False)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("jitter", [0.0, 0.4])
def test_train_transform_repeats_bitwise_with_a_fixed_generator(jitter):
    x = torch.from_numpy(images(4, 30, 40))
    runs = [pa.augment_batch(torch.Generator().manual_seed(11), x, 16, jitter=jitter)
            for _ in range(2)]
    other = pa.augment_batch(torch.Generator().manual_seed(12), x, 16, jitter=jitter)
    assert runs[0].shape == (4, 16, 16, 3)
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], other)
    assert runs[0].min() >= -1.0 and runs[0].max() <= 1.0


def test_random_transforms_are_their_draws_then_their_transforms():
    x = torch.from_numpy(images(5, 20, 30))
    gen = torch.Generator().manual_seed(3)
    state = gen.get_state()
    got = pa.random_resized_crop(gen, x, 16)
    gen.set_state(state)
    box = pa._sample_crop_box(gen, 5, 20, 30, SCALE, RATIO)
    assert torch.equal(got, pa.crop_and_resize(x, *box, 16))
    gen.set_state(state)
    got = pa.random_flip(gen, x)
    gen.set_state(state)
    assert torch.equal(got, pa.flip(x, pa._flip_draws(gen, 5)))


@pytest.mark.parametrize("h,w", [(240, 320), (32, 32), (10, 100)])
def test_drawn_boxes_keep_to_scale_and_ratio(h, w):
    b = 4096
    crop_h, crop_w, top, left = pa._sample_crop_box(torch.Generator().manual_seed(h), b, h, w,
                                                    SCALE, RATIO)
    eps = 1e-4
    ratio = crop_w / crop_h
    assert ratio.min() >= RATIO[0] * (1 - eps) and ratio.max() <= RATIO[1] * (1 + eps)
    area = crop_h * crop_w / (h * w)
    assert area.max() <= SCALE[1] * (1 + eps)
    # A draw larger than the image shrinks to the largest box of its aspect
    # that fits: then it touches two sides, else its area is in range.
    shrunk = (crop_h >= h * (1 - eps)) | (crop_w >= w * (1 - eps))
    assert (area[~shrunk] >= SCALE[0] * (1 - eps)).all()
    # Inside the image, up to rounding (a box clamped to the image's height
    # may exceed it by an ulp, so h - crop_h, and the offset, by -ulp).
    assert (top >= -eps * h).all() and (left >= -eps * w).all()
    assert (top + crop_h <= h * (1 + eps)).all() and (left + crop_w <= w * (1 + eps)).all()
    # Both ends of the log-ratio range are reached.
    assert math.isclose(float(ratio.min()), RATIO[0], rel_tol=0.05)
    assert math.isclose(float(ratio.max()), RATIO[1], rel_tol=0.05)
