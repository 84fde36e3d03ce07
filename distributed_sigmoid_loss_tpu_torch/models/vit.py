"""ViT image tower. Input is NHWC pixels, as in the JAX package."""

from __future__ import annotations

import torch
from torch import nn

from distributed_sigmoid_loss_tpu_torch.models.transformer import (
    Dense,
    Encoder,
    MapHead,
    dtype_of,
    lecun_normal_,
)
from distributed_sigmoid_loss_tpu_torch.utils.config import (
    ViTConfig,
    check_supported,
    moe_config,
    tower_quant_mode,
)
from distributed_sigmoid_loss_tpu_torch.utils.device import resolve_device

__all__ = ["PatchEmbed", "ViT"]


class PatchEmbed(nn.Module):
    """Non-overlapping patchify as reshape + one matmul.

    ``kernel`` keeps the (p, p, c, width) HWIO layout of a strided conv; each
    patch is flattened in (ph, pw, c) order to match it. A remainder that
    does not fill a patch is cropped, as a VALID conv would.
    """

    def __init__(self, width: int, patch_size: int, dtype, *, channels: int = 3, device=None,
                 generator=None):
        super().__init__()
        self.width, self.patch_size, self.dtype = width, patch_size, dtype
        p = patch_size
        self.kernel = nn.Parameter(torch.empty(p, p, channels, width, device=device))
        self.bias = nn.Parameter(torch.zeros(width, device=device))
        if generator is not None:
            lecun_normal_(self.kernel.data, p * p * channels, generator)

    def forward(self, images):
        b, hh, ww, c = images.shape
        p = self.patch_size
        x = images.to(self.dtype)[:, : hh // p * p, : ww // p * p, :]
        x = x.reshape(b, hh // p, p, ww // p, p, c)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, (hh // p) * (ww // p), p * p * c)
        w = self.kernel.reshape(p * p * c, self.width).to(self.dtype)
        return x @ w + self.bias.to(self.dtype)


class ViT(nn.Module):
    """images (b, H, W, 3) → (b, embed_dim) unnormalized f32 embeddings."""

    def __init__(self, cfg: ViTConfig, *, device=None, generator=None):
        super().__init__()
        check_supported(cfg)
        device = resolve_device(device)
        self.cfg = cfg
        dtype = self.dtype = dtype_of(cfg.dtype)
        n = (cfg.image_size // cfg.patch_size) ** 2
        if not cfg.use_proj and cfg.embed_dim != cfg.width:
            raise ValueError(
                f"use_proj=False (HF-format) requires embed_dim == width, got "
                f"{cfg.embed_dim} != {cfg.width}"
            )
        kw = dict(device=device, generator=generator)
        self.patch_embed = PatchEmbed(cfg.width, cfg.patch_size, dtype, **kw)
        self.pos_embed = nn.Parameter(torch.empty(1, n, cfg.width, device=device))
        if generator is not None:
            self.pos_embed.data.normal_(0.0, 0.02, generator=generator)
        self.encoder = Encoder(cfg.width, cfg.depth, cfg.num_heads, cfg.mlp_ratio, dtype,
                               attn_impl=cfg.attn_impl, remat=cfg.remat,
                               remat_policy=cfg.remat_policy, quant=tower_quant_mode(cfg),
                               sp_axis=cfg.sequence_parallel_axis,
                               sp_impl=cfg.sequence_parallel_impl, moe=moe_config(cfg), **kw)
        if cfg.pool == "map":
            self.map_head = MapHead(cfg.width, cfg.num_heads, cfg.mlp_ratio, dtype, **kw)
        if cfg.use_proj:
            self.proj = Dense(cfg.width, cfg.embed_dim, dtype, init="lecun", **kw)

    def forward(self, images):
        x = self.patch_embed(images)
        if x.shape[1] != self.pos_embed.shape[1]:
            raise ValueError(
                f"{x.shape[1]} patches != the {self.pos_embed.shape[1]} position "
                f"embeddings of image_size={self.cfg.image_size}"
            )
        x = x + self.pos_embed.to(self.dtype)
        x = self.encoder(x)
        x = self.map_head(x) if self.cfg.pool == "map" else x.mean(dim=1)
        if self.cfg.use_proj:
            x = self.proj(x)
        return x.float()
