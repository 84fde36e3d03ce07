"""The reference test harness's data and weight recipe, so the port's runs
see the same inputs as the PyTorch reference (the port's copy of the JAX
package's ``utils/parity_data.py``).

The reference makes the FULL global batch on every rank and slices its
shard (reference test_distributed_sigmoid_loss.py:57-68): images from
``torch.randn`` under seed 42, texts under seed 40. Its toy towers are
``nn.Linear(emb_dim, 2, bias=False)`` seeded 42 for BOTH encoders, so they
start with identical weights (test_distributed_sigmoid_loss.py:71-76).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

__all__ = ["reference_partition", "reference_encoder_weights"]


def reference_partition(
    world_size: int, gpu_batch_size: int, emb_dim: int
) -> tuple[np.ndarray, np.ndarray]:
    """Global (W·b, d) image and text inputs with the reference's seeds (42 /
    40). Rank ``r`` takes rows ``[r·b, (r+1)·b)``, as the reference slices
    them."""
    torch.manual_seed(42)
    image_inputs = torch.randn(world_size * gpu_batch_size, emb_dim)
    torch.manual_seed(40)
    text_inputs = torch.randn(world_size * gpu_batch_size, emb_dim)
    return image_inputs.numpy(), text_inputs.numpy()


def reference_encoder_weights(emb_dim: int, output_dim: int = 2) -> tuple[np.ndarray, np.ndarray]:
    """Toy tower weights, shape (output_dim, emb_dim), applied as ``x @ W.T``.

    Both towers seeded 42, so both start equal, as ``get_encoders`` does
    (test_distributed_sigmoid_loss.py:71-76).
    """
    torch.manual_seed(42)
    image_encoder = nn.Linear(emb_dim, output_dim, bias=False)
    torch.manual_seed(42)
    text_encoder = nn.Linear(emb_dim, output_dim, bias=False)
    return (
        image_encoder.weight.detach().numpy().copy(),
        text_encoder.weight.detach().numpy().copy(),
    )
