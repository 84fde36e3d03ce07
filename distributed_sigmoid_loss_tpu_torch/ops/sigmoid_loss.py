"""Core SigLIP sigmoid loss as plain PyTorch functions (single-device
Algorithm 1), ported from the JAX package's ``ops/sigmoid_loss.py``.

- loss parameters: learnable ``t_prime`` (init ``log 10``) and ``bias``
  (init ``-10``);
- per block: ``logits = exp(t_prime) · zimg @ ztxtᵀ + bias``; labels ``+1``
  on the positive diagonal and ``-1`` elsewhere; per element
  ``-log_sigmoid(labels · logits)``;
- the summed loss is divided by the *local* batch size.

``precision`` names the block product's arithmetic, as the JAX package's
``LossConfig.precision`` does:

- ``"highest"``: an IEEE f32 product. On a CUDA device this needs TF32 off
  for f32 matrix products (``torch.get_float32_matmul_precision() ==
  "highest"``, PyTorch's default); the loss raises otherwise.
- ``"default"`` (the headline train step's setting): the TPU's DEFAULT pass,
  one bf16 product. The embeddings are rounded to bf16 and their products
  summed in f32 to an f32 result, computed as an f32 product of the rounded
  operands (the products of two bf16 values are exact in f32). The same
  numbers on the CPU and the card; the product is (b, d) × (d, n) with
  b = n = 128 at the headline, too small for its speed to matter.

The streaming loss kernel (``use_pallas``, K4-K6,
``ops/streaming_sigmoid_loss.py``) ignores ``precision``, as the JAX kernel
does: its product is IEEE f32 on the f32-cast embeddings.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from distributed_sigmoid_loss_tpu_torch.ops.streaming_sigmoid_loss import (
    NEGATIVE_ONLY_OFFSET,
    streaming_block_loss_or_none,
)

__all__ = [
    "init_loss_params",
    "pairwise_logits",
    "scaled_products",
    "sigmoid_xent",
    "sigmoid_loss_block",
    "sigmoid_loss_chunk_scan",
    "sigmoid_loss",
    "l2_normalize",
    "T_PRIME_INIT",
    "BIAS_INIT",
    "PRECISIONS",
]

# The JAX package's init_loss_params values (the SigLIP paper's Algorithm 1):
# t_prime = log 10, bias = -10.
T_PRIME_INIT = math.log(10.0)
BIAS_INIT = -10.0

PRECISIONS = ("highest", "default")


def init_loss_params(dtype=torch.float32, device=None) -> dict:
    """``{"t_prime": log 10, "bias": -10}`` as 0-d tensors."""
    return {
        "t_prime": torch.tensor(T_PRIME_INIT, dtype=dtype, device=device),
        "bias": torch.tensor(BIAS_INIT, dtype=dtype, device=device),
    }


def _matmul(a, b, precision: str):
    if precision == "default":
        return a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float()
    if precision != "highest":
        raise ValueError(f"unknown precision: {precision!r} (expected one of {PRECISIONS})")
    if a.is_cuda and torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "precision='highest' needs IEEE f32 products, but TF32 is on "
            f"(float32 matmul precision {torch.get_float32_matmul_precision()!r}); "
            "set torch.backends.cuda.matmul.allow_tf32 = False"
        )
    return a @ b


def scaled_products(zimg, ztxt, t_prime, *, precision: str = "highest"):
    """``exp(t_prime) * zimg @ ztxt.T`` as the jitted JAX step computes it:
    bf16 embeddings are multiplied in f32 (their products are exact in f32)
    and the f32 sums are not rounded back to bf16, because XLA keeps the dot's
    f32 result under jit (excess precision) before the f32 ``exp(t_prime)``
    scales it. The result is f32 for f32 or bf16 embeddings."""
    acc = torch.promote_types(zimg.dtype, t_prime.dtype)
    return torch.exp(t_prime) * _matmul(zimg.to(acc), ztxt.to(acc).T, precision)


def pairwise_logits(zimg, ztxt, t_prime, bias, *, precision: str = "highest"):
    """``exp(t_prime) * zimg @ ztxt.T + bias``: the (n_img, n_txt) logit
    block, f32 for bf16 embeddings as in the jitted JAX step
    (:func:`scaled_products`)."""
    return scaled_products(zimg, ztxt, t_prime, precision=precision) + bias


def sigmoid_xent(logits, labels):
    """Per-element sigmoid cross-entropy ``-log_sigmoid(labels * logits)``."""
    return -F.logsigmoid(labels * logits)


def _block_labels(n_img: int, n_txt: int, positive_diagonal: bool, dtype, device=None):
    """All ``-1``; ``+1`` on the diagonal when this is the positive block."""
    labels = torch.full((n_img, n_txt), -1.0, dtype=dtype, device=device)
    if positive_diagonal:
        labels = labels + 2.0 * torch.eye(n_img, n_txt, dtype=dtype, device=device)
    return labels


def sigmoid_loss_block(zimg, ztxt, t_prime, bias, *, negative_only: bool = False,
                       precision: str = "highest"):
    """Summed loss over one (local_imgs × txt_chunk) block, divided by the
    local batch. ``negative_only=True``: every label is ``-1`` (an off-shard
    negatives block); otherwise the diagonal carries the positive pairs."""
    logits = pairwise_logits(zimg, ztxt, t_prime, bias, precision=precision)
    labels = _block_labels(zimg.shape[0], ztxt.shape[0], not negative_only, logits.dtype,
                           logits.device)
    return sigmoid_xent(logits, labels).sum() / zimg.shape[0]


def sigmoid_loss_chunk_scan(zimg, txt_chunks, t_prime, bias, *, positive_chunk,
                            precision: str = "highest", use_pallas: bool = False,
                            quant: str = ""):
    """Streamed-negatives loss over stacked text chunk-blocks
    ``txt_chunks`` (num_chunks, chunk_b, d), the positive diagonal on chunk
    ``positive_chunk``: :func:`sigmoid_loss_block` summed over the chunks.

    One ``(n_img, chunk_b)`` logits block is live at a time: each chunk's
    body runs under ``torch.utils.checkpoint``, so the backward recomputes its
    logits from the embeddings instead of keeping them. The chunk sums
    accumulate in f32 whatever the embedding dtype. Returns the sum divided
    by ``n_img``.

    ``use_pallas=True`` makes the streaming loss kernel the chunk body, at
    offset 0 on ``positive_chunk`` and ``NEGATIVE_ONLY_OFFSET`` elsewhere, in
    f32 or (``quant="int8"``) the int8 mode. It holds no logits and its
    backward recomputes them, so the body is not checkpointed: one K4, K5 and
    K6 call per chunk. A chunk the kernel's dispatch refuses
    (``pallas_compatible``) takes the plain checkpointed body at
    ``precision``, as in JAX.
    """
    n_img = zimg.shape[0]
    positive_chunk = int(positive_chunk)

    def body(chunk, k: int):
        logits = pairwise_logits(zimg, chunk, t_prime, bias, precision=precision)
        rows = torch.arange(logits.shape[0], device=logits.device)[:, None]
        cols = torch.arange(logits.shape[1], device=logits.device)[None, :]
        positive = (k == positive_chunk) & (rows == cols)
        labels = torch.where(positive, 1.0, -1.0).to(logits.dtype)
        return sigmoid_xent(logits, labels).sum().float()

    acc = torch.zeros((), dtype=torch.float32, device=zimg.device)
    for k in range(txt_chunks.shape[0]):
        if use_pallas:
            off = 0 if k == positive_chunk else NEGATIVE_ONLY_OFFSET
            total = streaming_block_loss_or_none(zimg, txt_chunks[k], t_prime, bias, off,
                                                 quant=quant, normalize=False)
            if total is not None:
                acc = acc + total.float()
                continue
        acc = acc + checkpoint(body, txt_chunks[k], k, use_reentrant=False)
    return acc / n_img


def sigmoid_loss(zimg, ztxt, t_prime, bias, *, precision: str = "highest"):
    """Single-device SigLIP sigmoid loss, the paper's Algorithm 1: the
    positive block alone. Inputs are assumed L2-normalized."""
    return sigmoid_loss_block(zimg, ztxt, t_prime, bias, negative_only=False,
                              precision=precision)


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize along ``dim`` with the norm clamped at ``eps``
    (``torch.nn.functional.normalize`` defaults)."""
    norm = torch.linalg.vector_norm(x, ord=2, dim=dim, keepdim=True)
    return x / torch.clamp(norm, min=eps)
