"""Text tower: a transformer over token ids with MAP ("map") or last-token
("last", HF-format) pooling and a projection into the shared space."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from distributed_sigmoid_loss_tpu_torch.models.transformer import (
    Dense,
    Encoder,
    MapHead,
    dtype_of,
)
from distributed_sigmoid_loss_tpu_torch.utils.config import (
    TextConfig,
    check_supported,
    moe_config,
    tower_quant_mode,
)
from distributed_sigmoid_loss_tpu_torch.utils.device import resolve_device

__all__ = ["TextTransformer"]


class TextTransformer(nn.Module):
    """token_ids (b, context_length) int → (b, embed_dim) f32 embeddings."""

    def __init__(self, cfg: TextConfig, *, device=None, generator=None):
        super().__init__()
        check_supported(cfg)
        device = resolve_device(device)
        self.cfg = cfg
        dtype = self.dtype = dtype_of(cfg.dtype)
        kw = dict(device=device, generator=generator)
        # f32 table, cast to the activation dtype after the lookup.
        self.token_embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.width, device=device))
        self.pos_embed = nn.Parameter(torch.empty(1, cfg.context_length, cfg.width, device=device))
        if generator is not None:
            self.token_embed.data.normal_(0.0, 0.02, generator=generator)
            self.pos_embed.data.normal_(0.0, 0.02, generator=generator)
        self.encoder = Encoder(cfg.width, cfg.depth, cfg.num_heads, cfg.mlp_ratio, dtype,
                               attn_impl=cfg.attn_impl, causal=cfg.causal, remat=cfg.remat,
                               remat_policy=cfg.remat_policy, quant=tower_quant_mode(cfg),
                               sp_axis=cfg.sequence_parallel_axis,
                               sp_impl=cfg.sequence_parallel_impl, moe=moe_config(cfg), **kw)
        if cfg.pool == "map":
            self.map_head = MapHead(cfg.width, cfg.num_heads, cfg.mlp_ratio, dtype, **kw)
        self.proj = Dense(cfg.width, cfg.embed_dim, dtype, init="lecun", **kw)

    def forward(self, token_ids):
        emb = F.embedding(token_ids.long(), self.token_embed)
        x = emb.to(self.dtype) + self.pos_embed.to(self.dtype)
        x = self.encoder(x)
        # HF-format SigLIP pools the LAST token's hidden state.
        x = self.map_head(x) if self.cfg.pool == "map" else x[:, -1]
        return self.proj(x).float()
