"""Softmax (InfoNCE / CLIP) contrastive loss, the second loss family, ported
from the JAX package's ``ops/softmax_loss.py``: the single-device symmetric
cross-entropy over the (b, b) similarity matrix,
``loss = (CE_rows + CE_cols) / 2``, with the CLIP learnable temperature
``t_prime`` (init ``log(1/0.07)``) and no bias. The distributed variants are
``parallel/contrastive.py``.

``precision`` is the sigmoid loss's (``ops/sigmoid_loss.py``): ``"highest"``
an IEEE f32 product, ``"default"`` one bf16 pass.
"""

from __future__ import annotations

import math

import torch

from distributed_sigmoid_loss_tpu_torch.ops.sigmoid_loss import scaled_products

__all__ = ["init_clip_loss_params", "softmax_contrastive_loss"]


def init_clip_loss_params(dtype=torch.float32, device=None) -> dict:
    """CLIP's learnable temperature ``{"t_prime": log(1/0.07)}`` (logit
    scale ``exp(t_prime) ≈ 14.3``), no bias: the open_clip ``ClipLoss``
    contract."""
    return {"t_prime": torch.tensor(math.log(1.0 / 0.07), dtype=dtype, device=device)}


def softmax_contrastive_loss(zimg, ztxt, t_prime, *, precision: str = "highest"):
    """Symmetric InfoNCE over L2-normalized embeddings (single device):
    ``logits = exp(t_prime) * zimg @ ztxt.T``, positives on the diagonal,
    ``loss = (mean CE(rows) + mean CE(columns)) / 2``."""
    logits = scaled_products(zimg, ztxt, t_prime, precision=precision)
    diag = torch.diagonal(logits)
    i2t = torch.logsumexp(logits, dim=1) - diag
    t2i = torch.logsumexp(logits, dim=0) - diag
    return (i2t.mean() + t2i.mean()) / 2
