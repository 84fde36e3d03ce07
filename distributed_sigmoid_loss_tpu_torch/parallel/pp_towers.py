"""Pipeline-parallel SigLIP tower forwards, ported from the JAX package's
``parallel/pp_towers.py``: each tower's block stack runs as pipeline stages
over the ``pp`` axis of the ambient process grid, in the GPipe or the 1F1B
schedule (``parallel/pipeline.py``).

JAX keeps the scanned block stack whole and shards its leading (depth) axis
over ``pp``. Here a rank of the axis holds only its stage's blocks:
:func:`keep_stage_blocks` drops the others from a model every rank built
alike, keeping each block's name (``encoder.blocks.<layer>``), so a stage's
parameters, optimizer moments and checkpoint entries are named as in the
whole model. The patch or token embedding before the blocks and the final
LayerNorm, pooling and projection after them are small and run replicated
on every stage, as in JAX.

The local rows are split into the pipeline's microbatches contiguously
(JAX's per-device interleaved split, ``microbatch_split``) and merged back
in order (``microbatch_merge``), so the loss's positive pairs stay aligned.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from distributed_sigmoid_loss_tpu_torch.ops.sigmoid_loss import l2_normalize
from distributed_sigmoid_loss_tpu_torch.parallel.mesh import axis_group, axis_index, axis_size
from distributed_sigmoid_loss_tpu_torch.parallel.microbatch import (
    microbatch_merge,
    microbatch_split,
)
from distributed_sigmoid_loss_tpu_torch.parallel.pipeline import (
    gpipe,
    pipeline_1f1b,
    pipeline_axis,
    stage_layers,
)

__all__ = [
    "PP_SCHEDULES",
    "keep_stage_blocks",
    "siglip_forward_pp",
    "text_forward_pp",
    "validate_pp_tower",
    "vision_forward_pp",
]

PP_SCHEDULES = ("gpipe", "1f1b")


def validate_pp_tower(cfg, num_stages: int, name: str) -> None:
    """Raise with JAX's message when a tower can't be pipelined."""
    if not cfg.scan_layers:
        raise ValueError(
            f"{name}: pipeline parallelism needs scan_layers=True (stage params "
            "are the nn.scan-stacked block leaves)"
        )
    if cfg.depth % num_stages:
        raise ValueError(
            f"{name}: depth {cfg.depth} must divide into {num_stages} pipeline "
            "stages"
        )
    if cfg.sequence_parallel_axis is not None:
        raise ValueError(
            f"{name}: sequence parallelism inside a pipelined tower would nest "
            "manual shard_maps; run sp XOR pp per tower"
        )
    if cfg.moe_experts:
        raise ValueError(
            f"{name}: MoE blocks sow router aux losses, which Block.apply under "
            "the pipeline schedule would silently drop; pp towers must be dense"
        )


def keep_stage_blocks(model: nn.Module, axis_name: str = pipeline_axis, group=None) -> nn.Module:
    """Keep only this rank's stage of each tower's blocks, in place: the
    blocks ``stage_layers(depth, S, stage)`` of the axis's S stages, under
    their names in the whole model. Returns ``model``."""
    group = axis_group(axis_name, group)
    num_stages, stage = axis_size(group), axis_index(group)
    for tower, name in ((model.visual, "vision"), (model.textual, "text")):
        validate_pp_tower(tower.cfg, num_stages, name)
        encoder = tower.encoder
        if isinstance(encoder.blocks, nn.ModuleDict):
            raise ValueError(f"{name}: the blocks are already one pipeline stage's")
        keep = stage_layers(len(encoder.blocks), num_stages, stage)
        encoder.blocks = nn.ModuleDict({str(i): encoder.blocks[i] for i in keep})
    return model


def _pipelined_blocks(encoder, x, *, num_microbatches: int, schedule: str, axis_name: str):
    """The encoder's block stack over ``x`` as pipeline stages, the blocks
    under the encoder's remat policy as in its own forward."""
    if schedule not in PP_SCHEDULES:
        raise ValueError(f"unknown pp schedule {schedule!r} (expected one of {PP_SCHEDULES})")
    group = axis_group(axis_name)
    num_stages = axis_size(group)
    blocks = list(encoder.blocks.values()) if isinstance(encoder.blocks, nn.ModuleDict) \
        else list(encoder.blocks)
    if len(blocks) * num_stages != encoder.depth:
        raise ValueError(
            f"a pipelined encoder of depth {encoder.depth} over {num_stages} stages holds "
            f"{len(blocks)} blocks on each; build the stage with keep_stage_blocks"
        )

    def stage_fn(h):
        remat = encoder.remat and torch.is_grad_enabled()
        for block in blocks:
            h = checkpoint(block, h, **encoder._checkpoint_kw) if remat else block(h)
        return h

    params = [p for b in blocks for p in b.parameters()]
    xs = microbatch_split(x, num_microbatches, what="pp_microbatches")
    if schedule == "gpipe":
        ys = gpipe(stage_fn, xs, params=params, axis_name=axis_name, group=group,
                   stream_io=num_microbatches % num_stages == 0)
    else:
        ys = pipeline_1f1b(stage_fn, xs, params=params, axis_name=axis_name, group=group)
    return microbatch_merge(ys)


def vision_forward_pp(visual, images, *, num_microbatches: int, schedule: str = "gpipe",
                      axis_name: str = pipeline_axis) -> torch.Tensor:
    """``models.vit.ViT.forward`` with the blocks pipelined over
    ``axis_name``: unnormalized f32 embeddings."""
    cfg = visual.cfg
    validate_pp_tower(cfg, axis_size(axis_group(axis_name)), "vision")
    x = visual.patch_embed(images)
    x = x + visual.pos_embed.to(visual.dtype)
    x = _pipelined_blocks(visual.encoder, x, num_microbatches=num_microbatches,
                          schedule=schedule, axis_name=axis_name)
    x = visual.encoder.ln_final(x)
    x = visual.map_head(x) if cfg.pool == "map" else x.mean(dim=1)
    if cfg.use_proj:
        x = visual.proj(x)
    return x.float()


def text_forward_pp(textual, token_ids, *, num_microbatches: int, schedule: str = "gpipe",
                    axis_name: str = pipeline_axis) -> torch.Tensor:
    """``models.text.TextTransformer.forward`` with the blocks pipelined."""
    cfg = textual.cfg
    validate_pp_tower(cfg, axis_size(axis_group(axis_name)), "text")
    emb = torch.nn.functional.embedding(token_ids.long(), textual.token_embed)
    x = emb.to(textual.dtype) + textual.pos_embed.to(textual.dtype)
    x = _pipelined_blocks(textual.encoder, x, num_microbatches=num_microbatches,
                          schedule=schedule, axis_name=axis_name)
    x = textual.encoder.ln_final(x)
    x = textual.map_head(x) if cfg.pool == "map" else x[:, -1]
    return textual.proj(x).float()


def siglip_forward_pp(model, images, token_ids, *, num_microbatches: int,
                      schedule: str = "gpipe", axis_name: str = pipeline_axis):
    """``SigLIP.forward`` with both towers' blocks pipelined over
    ``axis_name``: ``(zimg, ztxt, loss_params)``."""
    zimg = l2_normalize(vision_forward_pp(model.visual, images, num_microbatches=num_microbatches,
                                          schedule=schedule, axis_name=axis_name))
    ztxt = l2_normalize(text_forward_pp(model.textual, token_ids,
                                        num_microbatches=num_microbatches, schedule=schedule,
                                        axis_name=axis_name))
    return zimg, ztxt, {"t_prime": model.t_prime, "bias": model.bias}
