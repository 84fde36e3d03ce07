"""Image augmentation for contrastive pre-training, the port's copy of the
JAX package's ``data/augment.py``, in torch on the tensors' device.

Inception-style random resized crop + horizontal flip, optional color
jitter, then SigLIP's normalisation. Every function takes an explicit
``torch.Generator`` on the images' device: the same generator state gives
the same batch bit for bit. The draws (``_sample_crop_box``,
``_flip_draws``, ``_jitter_draws``) are apart from the transforms
(``crop_and_resize``, ``flip``, ``jitter``), which take the draws as
tensors, so JAX's draws for a key can be fed to the port's transforms.

The crop-resize computes what ``jax.image.scale_and_translate(...,
method="bilinear")`` computes, antialiasing included (when downscaling, the
triangle kernel is widened by 1/scale), as two per-sample weight matrices
applied with ``einsum``; the eval resize is ``jax.image.resize(...,
"bilinear")``'s. Output shapes are fixed whatever the draws.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

__all__ = ["random_flip", "random_resized_crop", "color_jitter", "normalize",
           "augment_batch", "crop_and_resize", "flip", "jitter"]

# jax.image's threshold below which a weight column is treated as empty.
_EMPTY_WEIGHT_SUM = 1000.0 * torch.finfo(torch.float32).eps


def _flip_draws(generator: torch.Generator, b: int) -> torch.Tensor:
    """(b,) bool: flip each sample with probability 0.5."""
    return torch.rand(b, generator=generator, device=generator.device) < 0.5


def flip(images: torch.Tensor, flips: torch.Tensor) -> torch.Tensor:
    """Horizontal flip of the samples where ``flips``. images: (b, h, w, c)."""
    return torch.where(flips[:, None, None, None], images.flip(2), images)


def random_flip(generator: torch.Generator, images: torch.Tensor) -> torch.Tensor:
    """Per-sample horizontal flip with probability 0.5. images: (b, h, w, c)."""
    return flip(images, _flip_draws(generator, images.shape[0]))


def _sample_crop_box(generator: torch.Generator, b: int, h: int, w: int,
                     scale: tuple[float, float], ratio: tuple[float, float]):
    """Inception crops for b samples: area fraction ~ U(scale), log-aspect ~
    U(log(ratio)). Returns (crop_h, crop_w, top, left), (b,) f32 each
    (continuous coordinates: the resize interpolates). A draw larger than the
    image is scaled down to the largest box of its aspect that fits, the
    torchvision-style fallback JAX keeps."""
    u = torch.rand(b, 4, generator=generator, device=generator.device)
    area = h * w * (scale[0] + (scale[1] - scale[0]) * u[:, 0])
    lo, hi = math.log(ratio[0]), math.log(ratio[1])
    r = torch.exp(lo + (hi - lo) * u[:, 1])
    crop_w = torch.sqrt(area * r)
    crop_h = torch.sqrt(area / r)
    clamp = torch.clamp(torch.minimum(h / crop_h, w / crop_w), max=1.0)
    crop_h = crop_h * clamp
    crop_w = crop_w * clamp
    return crop_h, crop_w, u[:, 2] * (h - crop_h), u[:, 3] * (w - crop_w)


def _triangle(sample_f: torch.Tensor, in_size: int, inv_kernel_scale: torch.Tensor):
    """The antialiased triangle kernel's raw weights, (b, in_size, out)."""
    pos = torch.arange(in_size, dtype=torch.float32, device=sample_f.device)
    x = (sample_f[:, None, :] - pos[None, :, None]).abs() * inv_kernel_scale[:, None, None]
    return torch.clamp(1.0 - x.abs(), min=0.0)


def _normalised(weights: torch.Tensor, total: torch.Tensor, sample_f: torch.Tensor,
                in_size: int) -> torch.Tensor:
    """``compute_weight_mat``'s tail: each column over its sum (0 where the
    sum is ~0), and 0 where the sample falls outside the input."""
    weights = torch.where(total.abs() > _EMPTY_WEIGHT_SUM,
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[:, None, :], weights, torch.zeros_like(weights))


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` in f32 rounded once, as a fused multiply-add."""
    return (a.double() * b.double() + c.double()).float()


def _weights(in_size: int, out_size: int, inv_scale: torch.Tensor, translation: torch.Tensor):
    """``jax.image``'s ``compute_weight_mat`` for the triangle kernel with
    antialiasing, one per sample: (b, in_size, out_size) f32 from (b,) f32
    ``inv_scale`` (1 / scale) and ``translation`` (input = (output -
    translation) / scale). The sample position ``(o + 0.5) * inv_scale -
    translation * inv_scale`` is rounded once, as XLA evaluates it: near
    coordinate 224 one rounding more moves a weight by 1.5e-5."""
    out = torch.arange(out_size, dtype=torch.float32, device=inv_scale.device) + 0.5
    sample_f = _fma(out[None, :], inv_scale[:, None], -(translation * inv_scale)[:, None]) - 0.5
    weights = _triangle(sample_f, in_size, 1.0 / torch.clamp(inv_scale, min=1.0))
    return _normalised(weights, weights.sum(dim=1, keepdim=True), sample_f, in_size)


def _resize_axes(images: torch.Tensor, wh: torch.Tensor | None,
                 ww: torch.Tensor | None) -> torch.Tensor:
    """(b, h, w, c) images through per-sample row and column weight matrices
    (None: the axis is kept)."""
    if wh is not None:
        images = torch.einsum("bhwc,bho->bowc", images, wh)
    if ww is not None:
        images = torch.einsum("bowc,bwp->bopc", images, ww)
    return images


def crop_and_resize(images: torch.Tensor, crop_h: torch.Tensor, crop_w: torch.Tensor,
                    top: torch.Tensor, left: torch.Tensor, out_size: int) -> torch.Tensor:
    """Each sample's box resized to (out_size, out_size), as JAX's crop:
    output pixel o maps to input pixel ``top + o * crop_h / out_size``."""
    _, h, w, _ = images.shape
    # XLA's f32 arithmetic: 1 / (out_size / crop) folded into crop * (1 / out_size).
    wh = _weights(h, out_size, crop_h * (1.0 / out_size), -top * out_size / crop_h)
    ww = _weights(w, out_size, crop_w * (1.0 / out_size), -left * out_size / crop_w)
    return _resize_axes(images, wh, ww)


def random_resized_crop(generator: torch.Generator, images: torch.Tensor, out_size: int,
                        scale: tuple[float, float] = (0.08, 1.0),
                        ratio: tuple[float, float] = (3 / 4, 4 / 3),
                        method: str = "bilinear") -> torch.Tensor:
    """Per-sample Inception crop + resize to (out_size, out_size), fixed
    shapes. images: (b, h, w, c) → (b, out_size, out_size, c)."""
    if method != "bilinear":
        raise ValueError(f"method {method!r}: the port resizes bilinear only")
    b, h, w, _ = images.shape
    box = _sample_crop_box(generator, b, h, w, scale, ratio)
    return crop_and_resize(images, *box, out_size)


def _jitter_draws(generator: torch.Generator, b: int, brightness: float, contrast: float,
                  saturation: float) -> tuple[torch.Tensor, ...]:
    """Per-sample factors ~ U(1 ± amount), (b, 1, 1, 1) each."""
    u = torch.rand(3, b, 1, 1, 1, generator=generator, device=generator.device)
    return tuple(1.0 - a + 2.0 * a * u[i]
                 for i, a in enumerate((brightness, contrast, saturation)))


def jitter(images: torch.Tensor, fb: torch.Tensor, fc: torch.Tensor,
           fs: torch.Tensor) -> torch.Tensor:
    """Brightness, contrast and saturation by the given factors, clamped to
    [0, 1] after each (torchvision ColorJitter semantics on [0, 1] floats)."""
    out = torch.clamp(images * fb, 0.0, 1.0)
    mean = out.mean(dim=(1, 2, 3), keepdim=True)
    out = torch.clamp((out - mean) * fc + mean, 0.0, 1.0)
    gray = out.mean(dim=-1, keepdim=True)
    return torch.clamp((out - gray) * fs + gray, 0.0, 1.0)


def color_jitter(generator: torch.Generator, images: torch.Tensor, brightness: float = 0.4,
                 contrast: float = 0.4, saturation: float = 0.4) -> torch.Tensor:
    """Per-sample brightness/contrast/saturation jitter (factors ~ U(1±x)),
    clamped back to [0, 1] after each op."""
    return jitter(images, *_jitter_draws(generator, images.shape[0], brightness, contrast,
                                         saturation))


def _to_unit(images: torch.Tensor) -> torch.Tensor:
    """Integer input is [0, 255] pixels: as [0, 1] floats."""
    if not images.is_floating_point():
        return images.to(torch.float32) / 255.0
    return images


def normalize(images: torch.Tensor, mean: Sequence[float] = (0.5, 0.5, 0.5),
              std: Sequence[float] = (0.5, 0.5, 0.5)) -> torch.Tensor:
    """Channel normalisation; SigLIP's (0.5, 0.5) maps [0, 1] floats to
    [-1, 1]. Integer input is [0, 255] pixels, scaled to [0, 1] first."""
    images = _to_unit(images)
    mean = torch.tensor(mean, dtype=images.dtype, device=images.device)
    std = torch.tensor(std, dtype=images.dtype, device=images.device)
    return (images - mean) / std


def _resize(images: torch.Tensor, out_size: int) -> torch.Tensor:
    """``jax.image.resize(images, (b, out_size, out_size, c), "bilinear")``
    on (b, h, w, c) floats: an axis whose size does not change is left as it
    is, as JAX leaves it."""
    b = images.shape[0]

    def weights(in_size):
        if in_size == out_size:
            return None
        # JAX's scale is a Python float, so 1 / scale is a constant: XLA
        # rounds the sample position once for the weights (o * inv - 0.5 as
        # a fused multiply-add) but twice for their column sums.
        inv = torch.full((1, 1), 1.0 / (out_size / in_size), dtype=torch.float32,
                         device=images.device)
        out = torch.arange(out_size, dtype=torch.float32, device=images.device)[None] + 0.5
        inv_kernel = 1.0 / torch.clamp(inv[0], min=1.0)
        sample_f = _fma(out, inv, torch.full_like(inv, -0.5))
        total = _triangle(out * inv - 0.5, in_size, inv_kernel).sum(dim=1, keepdim=True)
        w = _normalised(_triangle(sample_f, in_size, inv_kernel), total, sample_f, in_size)
        return w.expand(b, -1, -1)

    return _resize_axes(images, weights(images.shape[1]), weights(images.shape[2]))


def augment_batch(generator: torch.Generator, images: torch.Tensor, out_size: int,
                  train: bool = True, jitter: float = 0.0) -> torch.Tensor:
    """The contrastive train transform: random resized crop + flip (+
    optional color jitter), then SigLIP normalisation. ``train=False`` is
    the eval transform: plain resize + normalise. Integer input is [0, 255]
    pixels, converted to [0, 1] floats first."""
    images = _to_unit(images)
    if not train:
        return normalize(_resize(images, out_size))
    out = random_resized_crop(generator, images, out_size)
    out = random_flip(generator, out)
    if jitter:
        out = color_jitter(generator, out, jitter, jitter, jitter)
    return normalize(out)
