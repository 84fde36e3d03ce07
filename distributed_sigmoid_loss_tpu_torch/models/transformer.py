"""Shared transformer core for both towers: ``Mlp``, ``Attention``, ``Block``,
``Encoder`` and ``MapHead``, with the JAX package's numerics.

- Parameters are f32 and are cast to the activation dtype (with the bias) at
  each projection, as flax's ``Dense(dtype=...)`` does.
- ``LayerNorm`` takes its statistics in f32 with eps 1e-6 and flax's fast
  variance ``E[x²] − E[x]²``, then casts back to the activation dtype.
- The MLP uses the tanh approximation of GELU. With ``moe_experts > 0`` a
  block's MLP is the mixture-of-experts layer of ``models/moe.py``.
- ``quant`` (from ``utils.config.tower_quant_mode``) swaps the dot of the
  blocks' projections (attention q, k, v, out and MLP wi, wo; not the MAP
  head's nor the towers' ``proj``, as in JAX) for the dynamic int8 product of
  ``ops/quant.py``: ``"int8"`` for inference, ``"int8_ste"`` for training
  through the straight-through estimator. As flax's ``Dense`` casts the
  kernel to the layer dtype before its dot, the int8 path quantizes the cast
  weight and adds the bias after the cast to the output dtype.
- ``Attention`` keeps the JAX dispatch: for bf16 self-attention on a CUDA
  device the fused short-attention kernel (K1) where it fits and the flash
  kernel (K7) otherwise; dense attention for f32 and for cross-attention.
  With ``sp_axis`` set, self-attention runs sequence-parallel over that axis
  of the ambient process grid (``sp_impl``: the ring or Ulysses core of
  ``parallel/``, plain PyTorch as in JAX); every rank of the axis computes
  the projections, MLP and pooling on the whole sequence.
- ``remat`` recomputes each block in the backward
  (``torch.utils.checkpoint``, non-reentrant), with the JAX package's
  ``remat_policy`` as a selective-checkpoint policy: ``"nothing"`` recomputes
  everything; ``"save_hot"`` keeps ``attn_core`` and ``mlp_hidden``;
  ``"save_all_hot"`` also keeps ``q_proj``/``k_proj``/``v_proj``;
  ``"save_mlp"`` keeps ``mlp_hidden`` only. PyTorch's selective checkpointing
  chooses by op, not by name, so a name is an op it can recognise:
  ``attn_core`` is either fused kernel's custom op
  (``short_attention.ATTN_CORE_OP``, ``flash_attention.FLASH_CORE_OP``, whose
  output and row statistics are both kept; the dense core of the f32 towers
  is recomputed), and the other names tag the ops run inside
  :func:`checkpoint_name`. Under ``save_hot`` the backward never launches the
  attention forward again. An int8 projection is one custom op
  (``quant.int8_linear``), so ``mlp_hidden`` keeps wi's output, as JAX's
  policy does, and not its quantization intermediates.

``scan_layers`` only shapes the JAX parameter layout; the port always runs a
plain loop over ``blocks``.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from distributed_sigmoid_loss_tpu_torch.ops import flash_attention, quant, short_attention
from distributed_sigmoid_loss_tpu_torch.parallel import ring_attention

__all__ = [
    "Dense", "LayerNorm", "Mlp", "Attention", "Block", "Encoder", "MapHead",
    "checkpoint_name", "dtype_of", "REMAT_POLICIES",
]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


# remat_policy -> the names whose values the backward keeps (JAX
# models/transformer.py:_remat_policy).
REMAT_POLICIES = {
    "nothing": (),
    "save_hot": ("attn_core", "mlp_hidden"),
    "save_all_hot": ("attn_core", "mlp_hidden", "q_proj", "k_proj", "v_proj"),
    "save_mlp": ("mlp_hidden",),
}

_CHECKPOINT_NAME = contextvars.ContextVar("checkpoint_name", default=None)


@contextlib.contextmanager
def checkpoint_name(name: str):
    """Name the ops run inside for the remat policy (JAX ``checkpoint_name``).
    The recompute runs the same code, so it sees the same names."""
    token = _CHECKPOINT_NAME.set(name)
    try:
        yield
    finally:
        _CHECKPOINT_NAME.reset(token)


# The fused attention forwards, each a custom op the policy can recognise.
_ATTN_CORE_OPS = (short_attention.ATTN_CORE_OP, flash_attention.FLASH_CORE_OP)


def _policy(saved: tuple[str, ...]):
    def policy(ctx, op, *args, **kwargs):
        name = "attn_core" if op in _ATTN_CORE_OPS else _CHECKPOINT_NAME.get()
        return CheckpointPolicy.MUST_SAVE if name in saved else CheckpointPolicy.PREFER_RECOMPUTE

    return policy


def xavier_uniform_(t: torch.Tensor, fan_in: int, fan_out: int, generator) -> None:
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    t.uniform_(-bound, bound, generator=generator)


def lecun_normal_(t: torch.Tensor, fan_in: int, generator) -> None:
    """flax's ``lecun_normal``: a normal truncated at ±2σ, scaled so the
    variance is 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    t.mul_(std)


class Dense(nn.Module):
    """``y = x @ Wᵀ + b`` with f32 parameters cast to ``dtype`` per call.
    ``weight`` is (out, in), the transpose of a flax kernel. ``quant``:
    ``""`` (full precision), ``"int8"`` or ``"int8_ste"`` (the int8 product
    of ``ops/quant.py``, for inference or through the straight-through
    estimator). Here and in the other modules, ``generator=None`` leaves the
    weights uninitialized, for a state dict to be loaded or the ``meta``
    device."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype, *, init: str = "xavier",
                 quant: str = "", device=None, generator=None):
        super().__init__()
        if quant not in ("", "int8", "int8_ste"):
            raise ValueError(f"unknown quant mode: {quant!r}")
        self.dtype, self.quant = dtype, quant
        self.weight = nn.Parameter(torch.empty(d_out, d_in, device=device))
        self.bias = nn.Parameter(torch.zeros(d_out, device=device))
        if generator is not None:
            w = self.weight.data
            if init == "xavier":
                xavier_uniform_(w, d_in, d_out, generator)
            else:
                lecun_normal_(w, d_in, generator)

    def forward(self, x):
        x, w, b = x.to(self.dtype), self.weight.to(self.dtype), self.bias.to(self.dtype)
        if self.quant == "int8_ste":
            return quant.Int8DenseSTE.apply(x, w, b)
        if self.quant:
            return quant.int8_linear(x, w, b)
        return F.linear(x, w, b)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=...)``: f32 statistics, eps 1e-6, fast
    variance clamped at 0, output in ``dtype``."""

    def __init__(self, width: int, dtype: torch.dtype, *, eps: float = 1e-6, device=None):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(width, device=device))
        self.bias = nn.Parameter(torch.zeros(width, device=device))

    def forward(self, x):
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = torch.clamp(x32.square().mean(dim=-1, keepdim=True) - mean.square(), min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x32 - mean) * mul + self.bias).to(self.dtype)


class Mlp(nn.Module):
    def __init__(self, width: int, mlp_ratio, dtype, *, quant: str = "", device=None,
                 generator=None):
        super().__init__()
        # A fractional ratio (HF so400m: 4304/1152) rounds back to the integer.
        hidden = int(round(width * mlp_ratio))
        kw = dict(quant=quant, device=device, generator=generator)
        self.wi = Dense(width, hidden, dtype, **kw)
        self.wo = Dense(hidden, width, dtype, **kw)

    def forward(self, x):
        with checkpoint_name("mlp_hidden"):
            hidden = self.wi(x)
        return self.wo(F.gelu(hidden, approximate="tanh"))


class Attention(nn.Module):
    """Multi-head attention with separate q/k/v projections.

    ``attn_impl``: "dense", "flash" (the fused kernels, CUDA tensors only) or
    "auto" (the fused kernels for bf16 self-attention on CUDA, dense
    otherwise). The fused path takes the short kernel (K1) where
    ``short_attention_fits`` and the flash kernel (K7) otherwise, as JAX does.
    With ``sp_axis`` set, self-attention takes the sequence-parallel core
    ``sp_impl`` ("ring" or "ulysses") over that axis instead; cross-attention
    keeps the path above.
    """

    def __init__(self, width: int, num_heads: int, dtype, *, attn_impl: str = "auto",
                 causal: bool = False, quant: str = "", sp_axis: str | None = None,
                 sp_impl: str = "ring", device=None, generator=None):
        super().__init__()
        self.width, self.num_heads, self.dtype = width, num_heads, dtype
        self.attn_impl, self.causal = attn_impl, causal
        self.sp_axis, self.sp_impl = sp_axis, sp_impl
        kw = dict(quant=quant, device=device, generator=generator)
        self.q = Dense(width, width, dtype, **kw)
        self.k = Dense(width, width, dtype, **kw)
        self.v = Dense(width, width, dtype, **kw)
        self.out = Dense(width, width, dtype, **kw)

    def forward(self, x_q, x_kv=None):
        is_self_attention = x_kv is None
        x_kv = x_q if x_kv is None else x_kv
        head_dim = self.width // self.num_heads

        def split(t):
            return t.reshape(t.shape[:-1] + (self.num_heads, head_dim))

        with checkpoint_name("q_proj"):
            q = split(self.q(x_q))
        with checkpoint_name("k_proj"):
            k = split(self.k(x_kv))
        with checkpoint_name("v_proj"):
            v = split(self.v(x_kv))
        if self.sp_axis is not None and is_self_attention:
            out = ring_attention.sequence_parallel_attention(
                q, k, v, impl=self.sp_impl, axis_name=self.sp_axis, causal=self.causal)
            return self.out(out.reshape(out.shape[:-2] + (self.width,)))
        if self.attn_impl == "flash" and not is_self_attention:
            raise ValueError(
                "attn_impl='flash' requires self-attention (the fused kernels "
                "assume q/k/v share one sequence); use 'auto' or 'dense' for "
                "cross-attention"
            )
        if self.attn_impl == "flash" and not flash_attention.flash_attention_available(q):
            raise ValueError(
                f"attn_impl='flash' requires a CUDA tensor (got {q.device}); use "
                "'auto' to take the dense path off the GPU"
            )
        use_fused = self.attn_impl == "flash" or (
            self.attn_impl == "auto"
            and is_self_attention
            and self.dtype == torch.bfloat16
            and flash_attention.flash_attention_available(q)
        )
        if use_fused and short_attention.short_attention_fits(
            q.shape[1], self.width, self.dtype.itemsize, self.num_heads
        ):
            out = short_attention.short_self_attention(q, k, v, self.causal)
        elif use_fused:
            out = flash_attention.flash_self_attention(q, k, v, causal=self.causal)
        else:
            out = ring_attention.dense_attention(q, k, v, causal=self.causal)
        out = out.to(self.dtype)
        return self.out(out.reshape(out.shape[:-2] + (self.width,)))


class Block(nn.Module):
    """Pre-LN transformer block. ``moe["moe_experts"] > 0`` swaps the dense
    MLP (``mlp``) for the mixture-of-experts layer (``moe``,
    ``models/moe.py``), as JAX names them."""

    def __init__(self, width: int, num_heads: int, mlp_ratio, dtype, *, attn_impl="auto",
                 causal=False, quant: str = "", sp_axis: str | None = None,
                 sp_impl: str = "ring", moe: dict | None = None, device=None, generator=None):
        super().__init__()
        kw = dict(quant=quant, device=device, generator=generator)
        self.ln1 = LayerNorm(width, dtype, device=device)
        self.attn = Attention(width, num_heads, dtype, attn_impl=attn_impl, causal=causal,
                              sp_axis=sp_axis, sp_impl=sp_impl, **kw)
        self.ln2 = LayerNorm(width, dtype, device=device)
        if moe and moe.get("moe_experts", 0) > 0:
            from distributed_sigmoid_loss_tpu_torch.models.moe import MoeMlp

            self.moe = MoeMlp(width, mlp_ratio, moe["moe_experts"], dtype,
                              num_selected=moe.get("moe_num_selected", 1),
                              capacity_factor=moe.get("moe_capacity_factor", 1.25),
                              group_size=moe.get("moe_group_size", 512), **kw)
        else:
            self.mlp = Mlp(width, mlp_ratio, dtype, **kw)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        mlp = self.moe if hasattr(self, "moe") else self.mlp
        return x + mlp(self.ln2(x))


class Encoder(nn.Module):
    """Stack of blocks followed by a final LayerNorm. With ``remat``, each
    block is recomputed in the backward under ``remat_policy`` (see the
    module docstring); without gradients, and while ``torch.export`` traces
    the encoder, blocks run plainly."""

    def __init__(self, width: int, depth: int, num_heads: int, mlp_ratio, dtype, *,
                 attn_impl="auto", causal=False, remat: bool = False,
                 remat_policy: str = "nothing", quant: str = "", sp_axis: str | None = None,
                 sp_impl: str = "ring", moe: dict | None = None, device=None, generator=None):
        super().__init__()
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy: {remat_policy!r}")
        if sp_axis is not None and sp_impl not in ring_attention.SP_IMPLS:
            raise ValueError(f"unknown sp_impl: {sp_impl!r} (expected one of "
                             f"{sorted(ring_attention.SP_IMPLS)})")
        self.remat, self.depth = remat, depth
        saved = REMAT_POLICIES[remat_policy]
        self._checkpoint_kw = {"use_reentrant": False}
        if saved:
            self._checkpoint_kw["context_fn"] = functools.partial(
                create_selective_checkpoint_contexts, _policy(saved)
            )
        self.blocks = nn.ModuleList(
            Block(width, num_heads, mlp_ratio, dtype, attn_impl=attn_impl, causal=causal,
                  quant=quant, sp_axis=sp_axis, sp_impl=sp_impl, moe=moe, device=device,
                  generator=generator)
            for _ in range(depth)
        )
        self.ln_final = LayerNorm(width, dtype, device=device)

    def forward(self, x):
        # An exported step does not hold ``torch.utils.checkpoint``: under
        # ``torch.export`` (train/export.py) the blocks run plainly, with the
        # same values and more memory.
        remat = self.remat and torch.is_grad_enabled() and not torch.compiler.is_exporting()
        blocks = self.blocks
        if isinstance(blocks, nn.ModuleDict):  # one pipeline stage's (parallel/pp_towers.py)
            if len(blocks) != self.depth:
                raise ValueError(
                    f"this encoder holds {len(blocks)} of its {self.depth} blocks, one "
                    "pipeline stage's: run it through parallel.pp_towers"
                )
            blocks = blocks.values()
        for block in blocks:
            x = checkpoint(block, x, **self._checkpoint_kw) if remat else block(x)
        return self.ln_final(x)


class MapHead(nn.Module):
    """SigLIP's MAP (multihead attention pooling) head: a learned probe token
    attends over the sequence (no LayerNorm before, no residual around the
    attention), followed by an MLP residual."""

    def __init__(self, width: int, num_heads: int, mlp_ratio, dtype, *, device=None,
                 generator=None):
        super().__init__()
        self.dtype = dtype
        self.probe = nn.Parameter(torch.empty(1, 1, width, device=device))
        if generator is not None:
            # flax xavier_uniform on (1, 1, width): fan_in 1, fan_out width.
            xavier_uniform_(self.probe.data, 1, width, generator)
        self.attn = Attention(width, num_heads, dtype, device=device, generator=generator)
        self.ln = LayerNorm(width, dtype, device=device)
        self.mlp = Mlp(width, mlp_ratio, dtype, device=device, generator=generator)

    def forward(self, tokens):
        probe = self.probe.to(self.dtype).expand(tokens.shape[0], 1, -1)
        x = self.attn(probe, tokens)
        x = x + self.mlp(self.ln(x))
        return x[:, 0]
