"""SigLIP: ViT image tower + text transformer producing the L2-normalized
embedding pair, with the learnable loss scalars ``t_prime`` and ``bias``."""

from __future__ import annotations

import contextlib
import math

import torch
from torch import nn

from distributed_sigmoid_loss_tpu_torch.models.moe import collect_aux
from distributed_sigmoid_loss_tpu_torch.models.text import TextTransformer
from distributed_sigmoid_loss_tpu_torch.models.vit import ViT
from distributed_sigmoid_loss_tpu_torch.ops.sigmoid_loss import (
    BIAS_INIT,
    T_PRIME_INIT,
    l2_normalize,
)
from distributed_sigmoid_loss_tpu_torch.utils.config import SigLIPConfig
from distributed_sigmoid_loss_tpu_torch.utils.device import resolve_device

__all__ = ["SigLIP"]


class SigLIP(nn.Module):
    """``SigLIP(cfg, device=None, generator=None)``.

    ``device`` defaults to ``cuda`` (raises without CUDA). Parameters are
    initialized from ``generator`` (a ``torch.Generator`` on ``device``;
    default: seed 0) with the JAX package's initializer families; a model on
    the ``meta`` device is left uninitialized. Weights from the JAX package
    arrive through ``models.convert.params_from_jax`` + ``load_state_dict``.
    """

    def __init__(self, cfg: SigLIPConfig, *, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        if generator is None and device.type != "meta":
            generator = torch.Generator(device=device).manual_seed(0)
        self.cfg = cfg
        self.visual = ViT(cfg.vision, device=device, generator=generator)
        self.textual = TextTransformer(cfg.text, device=device, generator=generator)
        # Softmax (CLIP) family: the open_clip logit-scale init log(1/0.07).
        t0 = math.log(1.0 / 0.07) if cfg.loss.family == "softmax" else T_PRIME_INIT
        self.t_prime = nn.Parameter(torch.tensor(t0, device=device))
        self.bias = nn.Parameter(torch.tensor(BIAS_INIT, device=device))

    def forward(self, images=None, token_ids=None):
        """→ (zimg, ztxt, loss_params): L2-normalized embeddings (None for a
        tower given no input) and the loss scalars. With MoE towers
        ``loss_params["moe_aux"]`` is the mean of every MoE layer's router
        aux loss in this call (JAX's ``_mean_moe_aux``)."""
        moe = self.cfg.vision.moe_experts > 0 or self.cfg.text.moe_experts > 0
        with collect_aux() if moe else contextlib.nullcontext() as auxes:
            zimg = None if images is None else self.encode_image(images)
            ztxt = None if token_ids is None else self.encode_text(token_ids)
        lp = {"t_prime": self.t_prime, "bias": self.bias}
        if auxes:
            lp["moe_aux"] = torch.stack(auxes).mean()
        return zimg, ztxt, lp

    def encode_image(self, images, normalize: bool = True):
        z = self.visual(images)
        return l2_normalize(z) if normalize else z

    def encode_text(self, token_ids, normalize: bool = True):
        z = self.textual(token_ids)
        return l2_normalize(z) if normalize else z
