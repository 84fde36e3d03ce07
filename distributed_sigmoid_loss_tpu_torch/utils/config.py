"""Config dataclasses of the port: copies of the JAX package's
``utils/config.py`` (``LossConfig``, ``ViTConfig``, ``TextConfig``,
``SigLIPConfig``, ``TrainConfig`` and ``tower_quant_mode``), kept field for
field so one config means the same model and run in both packages.

``remat`` and ``remat_policy`` shape the backward (``models/transformer.py``);
``scan_layers`` names the JAX parameter layout, which
``models.convert.params_from_jax`` reads either way; Adafactor's per-leaf
statistics follow it (``models.convert.jax_leaves``), as does the adaptive
compression's tensor order. :func:`check_supported` refuses ``quant`` and
``quant_train`` together; :func:`moe_config` hands a tower's MoE fields to
its blocks.
"""

from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Distributed sigmoid loss knobs (reference constructor args)."""

    variant: Literal["all_gather", "ring"] = "ring"
    # "sigmoid" = SigLIP (the reference's loss); "softmax" = CLIP/InfoNCE (the
    # open_clip loss the reference's ring variant was a PR against) — same two
    # comm variants; the model's `bias` param is unused (zero grad) under it.
    family: Literal["sigmoid", "softmax"] = "sigmoid"
    bidir: bool = True  # rwightman_sigmoid_loss.py:30
    axis_name: str = "dp"
    # "highest" = an IEEE f32 product for parity gates; "default" = one bf16
    # pass with f32 accumulation (ops/sigmoid_loss.py).
    precision: str = "highest"
    # Streaming 2-D loss kernel for every logits block (fused gather, chunked
    # scan body, ring hop): K4-K6, ops/streaming_sigmoid_loss.py.
    use_pallas: bool = False
    # "chunked" (all_gather sigmoid only): stream the gathered negatives
    # chunk by chunk instead of one fused (local_b, W*local_b) product.
    loss_impl: Literal["fused", "chunked"] = "fused"
    # Ring sigmoid only: issue hop k+1's exchange before hop k's block
    # products. Same accumulation order as the serial ring.
    ring_overlap: bool = False


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """Image tower. Defaults = ViT-B/16."""

    image_size: int = 224
    patch_size: int = 16
    width: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: int | float = 4
    embed_dim: int = 512  # shared image-text embedding space
    pool: Literal["gap", "map"] = "map"  # SigLIP uses MAP (attention-pool) heads
    # HF-format SigLIP has no vision projection (the MAP head output IS the
    # embedding, so embed_dim must equal width); ours defaults to a projection
    # into the shared space like open_clip.
    use_proj: bool = True
    dtype: str = "bfloat16"  # activation dtype; params stay fp32
    remat: bool = True  # training only: recompute each block in backward
    scan_layers: bool = True  # parameter layout: one stacked set over depth
    # "auto" = a fused kernel for bf16 self-attention on a CUDA device: the
    # short-attention kernel (K1) where it fits, the flash kernel (K7)
    # otherwise; f32 and cross-attention keep the dense path, as does any
    # tower off the GPU. "flash" = the fused kernels in bf16 or f32.
    attn_impl: Literal["auto", "dense", "flash"] = "auto"
    # "nothing" = full remat; "save_hot" = save attention-core + MLP-hidden
    # activations across backward (recompute only projections/elementwise).
    remat_policy: Literal["nothing", "save_hot", "save_all_hot", "save_mlp"] = "nothing"
    # Long-context vision: run the blocks' self-attention sequence-parallel
    # over this axis of the ambient process grid (parallel/mesh.py).
    sequence_parallel_axis: str | None = None
    sequence_parallel_impl: Literal["ring", "ulysses"] = "ring"
    # Mixture-of-experts: >0 swaps each block's dense MLP for that many
    # experts (models/moe.py; sharded over the grid's ep axis when it has one).
    moe_experts: int = 0
    moe_num_selected: int = 1  # 1 = Switch top-1, 2 = top-2 with renormalized gates
    moe_capacity_factor: float = 1.25
    # Routing group size (GShard groups): capacity is per-group.
    moe_group_size: int = 512
    # "int8": run the block projection matmuls (q/k/v/out/wi/wo) in dynamic
    # symmetric int8, inference only (ops/quant.py).
    quant: Literal["", "int8"] = ""
    # "int8": trainable int8 through the straight-through estimator.
    # Mutually exclusive with `quant` (see tower_quant_mode).
    quant_train: Literal["", "int8"] = ""

    @classmethod
    def vit_b16(cls, **kw) -> "ViTConfig":
        return cls(**kw)

    @classmethod
    def vit_l14(cls, **kw) -> "ViTConfig":
        return cls(patch_size=14, width=1024, depth=24, num_heads=16, **kw)

    @classmethod
    def tiny_test(cls) -> "ViTConfig":
        return cls(
            image_size=16, patch_size=8, width=32, depth=2, num_heads=2,
            embed_dim=16, dtype="float32", remat=False, scan_layers=False,
        )


@dataclasses.dataclass(frozen=True)
class TextConfig:
    """Text tower: non-causal transformer over tokenized captions (SigLIP-style)."""

    vocab_size: int = 32000
    context_length: int = 64
    width: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: int | float = 4
    embed_dim: int = 512
    # "map" = attention pooling (open_clip SigLIP); "last" = last-token hidden
    # state (HF-format SigLIP, modeling_siglip.SiglipTextTransformer).
    pool: Literal["map", "last"] = "map"
    dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    attn_impl: Literal["auto", "dense", "flash"] = "auto"
    remat_policy: Literal["nothing", "save_hot", "save_all_hot", "save_mlp"] = "nothing"
    # Long-context: run the blocks' self-attention sequence-parallel over
    # this axis of the ambient process grid (parallel/mesh.py).
    sequence_parallel_axis: str | None = None
    # "ring" (ppermute, O(s_local²) memory) or "ulysses" (all-to-all head scatter,
    # 2 collective hops; needs num_heads % axis_size == 0).
    sequence_parallel_impl: Literal["ring", "ulysses"] = "ring"
    causal: bool = False
    # Mixture-of-experts (see ViTConfig): >0 enables MoE MLPs in the blocks.
    moe_experts: int = 0
    moe_num_selected: int = 1
    moe_capacity_factor: float = 1.25
    moe_group_size: int = 512
    # "int8": run the block projection matmuls (q/k/v/out/wi/wo) in dynamic
    # symmetric int8, inference only (ops/quant.py).
    quant: Literal["", "int8"] = ""
    # "int8": trainable int8 via the straight-through estimator — see
    # ViTConfig.quant_train (same contract, text tower).
    quant_train: Literal["", "int8"] = ""

    @classmethod
    def base(cls, **kw) -> "TextConfig":
        return cls(**kw)

    @classmethod
    def tiny_test(cls) -> "TextConfig":
        return cls(
            vocab_size=64, context_length=8, width=32, depth=2, num_heads=2,
            embed_dim=16, dtype="float32", remat=False, scan_layers=False,
        )


def tower_quant_mode(cfg: "ViTConfig | TextConfig") -> str:
    """The quant-mode resolution for a tower config. Returns ``""`` (full
    precision), ``"int8"``
    (inference-only dynamic int8), or ``"int8_ste"`` (trainable
    straight-through int8); raises when both flags are set — one tower cannot
    run two quantization recipes at once.
    """
    if cfg.quant and cfg.quant_train:
        raise ValueError(
            f"quant={cfg.quant!r} and quant_train={cfg.quant_train!r} are "
            "mutually exclusive: pick the inference recipe (quant) or the "
            "trainable STE recipe (quant_train)"
        )
    if cfg.quant_train:
        return "int8_ste"
    if cfg.quant:
        return "int8"
    return ""


@dataclasses.dataclass(frozen=True)
class SigLIPConfig:
    vision: ViTConfig = dataclasses.field(default_factory=ViTConfig)
    text: TextConfig = dataclasses.field(default_factory=TextConfig)
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)

    @classmethod
    def b16(cls) -> "SigLIPConfig":
        return cls()

    @classmethod
    def l14(cls, **vision_kw) -> "SigLIPConfig":
        """ViT-L/14 + width-1024 text tower."""
        return cls(
            vision=ViTConfig.vit_l14(**vision_kw),
            text=TextConfig(width=1024, num_heads=16),
        )

    @classmethod
    def so400m(cls) -> "SigLIPConfig":
        """SoViT-400m/14 — the shape-optimized flagship of the SigLIP release
        (google/siglip-so400m-patch14-224), HF-shaped: no vision projection,
        last-token text pooling, fractional MLP."""
        return cls(
            vision=ViTConfig(
                patch_size=14, width=1152, depth=27, num_heads=16,
                mlp_ratio=4304 / 1152, embed_dim=1152, use_proj=False,
            ),
            text=TextConfig(
                width=1152, depth=27, num_heads=16, mlp_ratio=4304 / 1152,
                embed_dim=1152, pool="last",
            ),
        )

    @classmethod
    def tiny_test(cls) -> "SigLIPConfig":
        return cls(vision=ViTConfig.tiny_test(), text=TextConfig.tiny_test())


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-3
    weight_decay: float = 1e-4
    warmup_steps: int = 2000
    total_steps: int = 100_000
    b1: float = 0.9
    b2: float = 0.95
    global_batch: int = 4096
    # "warmup_cosine" (open_clip default), "rsqrt" (the SigLIP paper's inverse
    # sqrt with linear warmup — total_steps-free, for open-ended pretraining),
    # or "constant" (after warmup).
    schedule: Literal["warmup_cosine", "rsqrt", "constant"] = "warmup_cosine"
    # Dtype of Adam's first moment (None = param dtype, f32). "bfloat16" halves
    # the larger moment buffer; the second moment stays f32.
    adam_mu_dtype: str | None = None
    # Optimizer family: "adamw", "lion" (one momentum slot in adam_mu_dtype)
    # or "adafactor" (factored second moments, optax's defaults).
    optimizer: Literal["adamw", "lion", "adafactor"] = "adamw"


def check_supported(cfg: "ViTConfig | TextConfig") -> None:
    """Raise ``ValueError`` for ``quant`` and ``quant_train`` set together."""
    tower_quant_mode(cfg)  # quant and quant_train together raise


def moe_config(cfg: "ViTConfig | TextConfig") -> dict | None:
    """A tower's MoE fields as the blocks take them, or None when its MLPs
    are dense."""
    if cfg.moe_experts <= 0:
        return None
    return {"moe_experts": cfg.moe_experts, "moe_num_selected": cfg.moe_num_selected,
            "moe_capacity_factor": cfg.moe_capacity_factor,
            "moe_group_size": cfg.moe_group_size}
