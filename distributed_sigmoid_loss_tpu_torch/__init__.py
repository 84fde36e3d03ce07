"""PyTorch / CUDA port of distributed_sigmoid_loss_tpu for NVIDIA Hopper.

A package of its own beside the JAX one: it imports torch, numpy and the
standard library, never JAX or the JAX package. Subpackages mirror the JAX
package's names (``utils``, ``ops``, ``parallel``, ``models``, ``eval``,
``serve``); hand-written kernels live under ``csrc/`` and are built with
``nvcc`` at first use. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"
