"""The reference's class API on the port's distributed loss: the classes a
user of ``ahmdtaha/distributed_sigmoid_loss`` imports, with the same names,
constructor knobs and parameter placement, as ``nn.Module``s.

- :class:`DDPSigmoidLoss` (the all-gather variant) owns ``t_prime`` and
  ``bias`` as parameters (reference distributed_sigmoid_loss.py:8-15).
- :class:`SigLipLoss` (the ring variant) takes ``logit_scale`` and
  ``logit_bias`` as call arguments (reference rwightman_sigmoid_loss.py:68).

They work as the reference's classes did under DDP: every rank of the
process group calls the module on its own (local_b, d) rows, and the
gradients are averaged over the ranks afterwards
(``parallel.api.average_gradients``, or DDP itself). The returned loss is
the mean of the ranks' losses, the same number on every rank. The JAX
package's classes instead take the global arrays and a mesh, and return
the gradient already averaged.
"""

from __future__ import annotations

import torch
from torch import nn

from distributed_sigmoid_loss_tpu_torch.ops.sigmoid_loss import BIAS_INIT, T_PRIME_INIT
from distributed_sigmoid_loss_tpu_torch.parallel.api import make_sharded_loss_fn
from distributed_sigmoid_loss_tpu_torch.parallel.mesh import axis_group, axis_index, axis_size
from distributed_sigmoid_loss_tpu_torch.utils.device import resolve_device

__all__ = ["DDPSigmoidLoss", "SigLipLoss"]


class DDPSigmoidLoss(nn.Module):
    """All-gather variant with the reference's surface
    (``DDPSigmoidLoss(gpu_batch_size)``, distributed_sigmoid_loss.py:8).

    ``gpu_batch_size``: the rows each rank passes, checked on every call
    (``None`` skips the check). ``group``: the process group (default: the
    world, or one process without ``torch.distributed``). ``use_pallas``:
    the streaming loss kernel (K4-K6) as the block body. ``device``: where
    ``t_prime`` (init log 10) and ``bias`` (init -10) live; ``None`` means
    ``cuda``. They must ride the optimizer, as in the reference
    (README.md:20)::

        loss_mod = DDPSigmoidLoss(gpu_batch_size=64)
        loss = loss_mod(zimg_local, ztxt_local)
        loss.backward()
        average_gradients([*encoder.parameters(), *loss_mod.parameters()])
    """

    def __init__(self, gpu_batch_size: int | None = None, group=None, use_pallas: bool = False,
                 *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.gpu_batch_size = gpu_batch_size
        self.t_prime = nn.Parameter(torch.tensor(T_PRIME_INIT, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.tensor(BIAS_INIT, dtype=torch.float32, device=device))
        self._fn = make_sharded_loss_fn(group, variant="all_gather", use_pallas=use_pallas)

    def forward(self, image_embeddings: torch.Tensor, text_embeddings: torch.Tensor):
        """This rank's L2-normalized (local_b, d) embeddings → the loss, the
        mean over the ranks of each rank's sum over its rows divided by
        local_b (the reference's DP-averaged quantity)."""
        if self.gpu_batch_size is not None and image_embeddings.shape[0] != self.gpu_batch_size:
            raise ValueError(
                f"local batch {image_embeddings.shape[0]} != gpu_batch_size "
                f"({self.gpu_batch_size})"
            )
        return self._fn({"t_prime": self.t_prime, "bias": self.bias},
                        image_embeddings, text_embeddings)


class SigLipLoss(nn.Module):
    """Ring (neighbour-exchange) variant with the reference's surface
    (``SigLipLoss(cache_labels, rank, world_size, bidir, use_horovod)``,
    rwightman_sigmoid_loss.py:23-30).

    ``rank`` and ``world_size`` are checked against ``group`` when given;
    ``cache_labels`` changes nothing (the reference's label cache is dead
    state, rwightman_sigmoid_loss.py:39-41); horovod is refused, as in the
    reference. ``logit_scale`` is ``t_prime``, ``logit_bias`` is ``bias``.
    """

    def __init__(self, cache_labels: bool = False, rank: int | None = None,
                 world_size: int | None = None, bidir: bool = True, use_horovod: bool = False,
                 group=None, use_pallas: bool = False):
        super().__init__()
        if use_horovod:
            # Reference: `assert not use_horovod` (rwightman_sigmoid_loss.py:35).
            raise NotImplementedError("horovod is not supported (matching reference)")
        del cache_labels  # signature parity only
        resolved = axis_group(group=group)
        w = axis_size(resolved)
        if world_size is not None and world_size != w:
            raise ValueError(f"world_size={world_size} but the process group has {w} ranks")
        if rank is not None and rank != axis_index(resolved):
            raise ValueError(f"rank={rank} but this process is rank {axis_index(resolved)}")
        self.bidir = bidir
        self._fn = make_sharded_loss_fn(group, variant="ring", bidir=bidir,
                                        use_pallas=use_pallas)

    def forward(self, image_features: torch.Tensor, text_features: torch.Tensor,
                logit_scale: torch.Tensor, logit_bias: torch.Tensor, output_dict: bool = False):
        """This rank's (local_b, d) features and the two loss scalars → the
        loss (``{"contrastive_loss": loss}`` with ``output_dict``)."""
        loss = self._fn({"t_prime": logit_scale, "bias": logit_bias},
                        image_features, text_features)
        return {"contrastive_loss": loss} if output_dict else loss

    @staticmethod
    def init_params(device=None) -> dict[str, nn.Parameter]:
        """``{"logit_scale": log 10, "logit_bias": -10}`` as f32 parameters
        on ``device`` (``None`` means ``cuda``)."""
        device = resolve_device(device)
        return {"logit_scale": nn.Parameter(torch.tensor(T_PRIME_INIT, device=device)),
                "logit_bias": nn.Parameter(torch.tensor(BIAS_INIT, device=device))}
