"""Import HF-format SigLIP checkpoints (``google/siglip-*``) into the port.

The port of the JAX package's ``models/hf_import.py``. It maps a
``transformers`` SigLIP state dict (any mapping of tensors or arrays under
``SiglipModel``'s key names) onto the port's ``SigLIP`` state dict, covering
every tensor: patch, token and position embeddings, the pre-LN encoder
stacks, the MAP vision pooling head (the packed q/k/v of its
``nn.MultiheadAttention`` split), the last-token text head, and the loss
scalars (HF ``logit_scale``/``logit_bias`` are the port's
``t_prime``/``bias``, with the same meaning: ``logits = z @ z.T *
exp(t') + b``). Nothing here imports ``transformers``: :func:`config_from_hf`
reads attributes from any object (a ``SiglipConfig`` or a
``types.SimpleNamespace`` of the same fields), so weights can be imported on
a machine without it.

Layout notes (torch → port): an ``nn.Linear`` weight (out, in) is the
port's ``Dense.weight`` as it is; the patch ``nn.Conv2d`` weight (out, in,
kh, kw) becomes the (kh, kw, in, out) ``PatchEmbed.kernel``; the position
tables gain a leading batch axis.

JAX's ``stack_for_scan`` has no counterpart: it restacks the per-block
subtrees into the ``scan_layers=True`` layout, but the port keeps one
tensor per layer under either value of ``scan_layers``, which only names
JAX's leaf grouping (Adafactor's factoring, ``models.convert.jax_leaves``).
A ``scan_layers=True`` config loads the state dict :func:`params_from_hf`
returns as it is.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from distributed_sigmoid_loss_tpu_torch.models.convert import check_state_dict
from distributed_sigmoid_loss_tpu_torch.utils.config import SigLIPConfig, TextConfig, ViTConfig

__all__ = ["config_from_hf", "params_from_hf"]


def config_from_hf(hf_config: Any, dtype: str = "bfloat16") -> SigLIPConfig:
    """The matching :class:`SigLIPConfig` of a ``transformers.SiglipConfig``
    (or any object with its ``vision_config`` / ``text_config`` fields).

    The config is HF-shaped: no vision projection (``use_proj=False``,
    ``embed_dim = hidden_size``), last-token text pooling, unscanned layers.
    Raises ``ValueError`` where the heads do not divide the width, an
    intermediate size is not an exact ratio of the width, or the vision
    width differs from the text projection.
    """
    v, t = hf_config.vision_config, hf_config.text_config
    if v.hidden_size % v.num_attention_heads or t.hidden_size % t.num_attention_heads:
        raise ValueError(
            f"num_attention_heads must divide hidden_size (got vision "
            f"{v.hidden_size}/{v.num_attention_heads}, text "
            f"{t.hidden_size}/{t.num_attention_heads})"
        )

    def ratio(intermediate: int, hidden: int) -> float:
        # mlp_ratio may be fractional (so400m: 4304/1152); Mlp rounds
        # width*ratio back to an integer — the round trip must be exact.
        r = intermediate / hidden
        if int(round(hidden * r)) != intermediate:
            raise ValueError(
                f"cannot represent intermediate_size {intermediate} as a ratio "
                f"of hidden_size {hidden}"
            )
        return r

    vision = ViTConfig(
        image_size=v.image_size,
        patch_size=v.patch_size,
        width=v.hidden_size,
        depth=v.num_hidden_layers,
        num_heads=v.num_attention_heads,
        mlp_ratio=ratio(v.intermediate_size, v.hidden_size),
        embed_dim=v.hidden_size,
        pool="map",
        use_proj=False,
        dtype=dtype,
        scan_layers=False,
    )
    text = TextConfig(
        vocab_size=t.vocab_size,
        context_length=t.max_position_embeddings,
        width=t.hidden_size,
        depth=t.num_hidden_layers,
        num_heads=t.num_attention_heads,
        mlp_ratio=ratio(t.intermediate_size, t.hidden_size),
        embed_dim=t.projection_size,
        pool="last",
        dtype=dtype,
        scan_layers=False,
    )
    if vision.embed_dim != text.embed_dim:
        raise ValueError(
            f"HF vision hidden_size ({vision.embed_dim}) must equal text "
            f"projection_size ({text.embed_dim}) for a shared embedding space"
        )
    return SigLIPConfig(vision=vision, text=text)


def _f32(t) -> torch.Tensor:
    """A tensor or array as a contiguous f32 CPU tensor (the conversion is
    layout work; the model's dtype policy applies when it runs)."""
    if not torch.is_tensor(t):
        t = torch.from_numpy(np.asarray(t))
    return t.detach().to(device="cpu", dtype=torch.float32).contiguous()


def _block(hf: str, port: str) -> list[tuple[str, str]]:
    """(HF prefix, port prefix) pairs of one pre-LN encoder block."""
    pairs = [("layer_norm1", "ln1"), ("layer_norm2", "ln2"), ("mlp.fc1", "mlp.wi"),
             ("mlp.fc2", "mlp.wo")]
    pairs += [(f"self_attn.{x}_proj", f"attn.{x}") for x in ("q", "k", "v", "out")]
    return [(f"{hf}.{a}", f"{port}.{b}") for a, b in pairs]


def params_from_hf(state_dict: Mapping, cfg: SigLIPConfig) -> dict[str, torch.Tensor]:
    """``transformers.SiglipModel`` state dict → the port's ``SigLIP(cfg)``
    state dict, f32 CPU tensors, for ``load_state_dict``.

    ``cfg`` must be HF-shaped (see :func:`config_from_hf`); raises
    ``ValueError`` otherwise, and where a name or shape does not match the
    port's model.
    """
    sd = state_dict
    if cfg.vision.use_proj or cfg.text.pool != "last" or cfg.vision.scan_layers \
            or cfg.text.scan_layers:
        raise ValueError(
            "cfg must be HF-shaped (use_proj=False, text pool='last', "
            "scan_layers=False) — build it with config_from_hf"
        )
    width = cfg.vision.width
    out = {
        # (out, in, kh, kw) -> (kh, kw, in, out)
        "visual.patch_embed.kernel": _f32(
            sd["vision_model.embeddings.patch_embedding.weight"]).permute(2, 3, 1, 0).contiguous(),
        "visual.patch_embed.bias": _f32(sd["vision_model.embeddings.patch_embedding.bias"]),
        "visual.pos_embed": _f32(sd["vision_model.embeddings.position_embedding.weight"])[None],
        "visual.map_head.probe": _f32(sd["vision_model.head.probe"]),
        "textual.token_embed": _f32(sd["text_model.embeddings.token_embedding.weight"]),
        "textual.pos_embed": _f32(sd["text_model.embeddings.position_embedding.weight"])[None],
        # HF's shape-(1,) scalars are the port's 0-d ones.
        "t_prime": _f32(sd["logit_scale"]).reshape(()),
        "bias": _f32(sd["logit_bias"]).reshape(()),
    }
    # torch MultiheadAttention's packed [q; k; v] in_proj -> separate q/k/v.
    in_w = _f32(sd["vision_model.head.attention.in_proj_weight"])
    in_b = _f32(sd["vision_model.head.attention.in_proj_bias"])
    for i, x in enumerate(("q", "k", "v")):
        out[f"visual.map_head.attn.{x}.weight"] = in_w[i * width:(i + 1) * width].contiguous()
        out[f"visual.map_head.attn.{x}.bias"] = in_b[i * width:(i + 1) * width].contiguous()
    pairs = [("vision_model.post_layernorm", "visual.encoder.ln_final"),
             ("vision_model.head.attention.out_proj", "visual.map_head.attn.out"),
             ("vision_model.head.layernorm", "visual.map_head.ln"),
             ("vision_model.head.mlp.fc1", "visual.map_head.mlp.wi"),
             ("vision_model.head.mlp.fc2", "visual.map_head.mlp.wo"),
             ("text_model.final_layer_norm", "textual.encoder.ln_final"),
             ("text_model.head", "textual.proj")]
    for i in range(cfg.vision.depth):
        pairs += _block(f"vision_model.encoder.layers.{i}", f"visual.encoder.blocks.{i}")
    for i in range(cfg.text.depth):
        pairs += _block(f"text_model.encoder.layers.{i}", f"textual.encoder.blocks.{i}")
    for hf, port in pairs:  # weight (out, in) and bias, or a LayerNorm's pair
        for leaf in ("weight", "bias"):
            out[f"{port}.{leaf}"] = _f32(sd[f"{hf}.{leaf}"])
    check_state_dict(out, cfg, "params_from_hf")
    return out
