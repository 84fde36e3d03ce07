"""Operators: loss helpers and the hand-written kernels.

Importing the package registers every kernel's custom op
(``dsl_torch_port::*``, each with a fake version), which is what loading an
exported artifact (``train.export.load_exported``) needs of the port: no
model code.
"""

from distributed_sigmoid_loss_tpu_torch.ops import (  # noqa: F401
    flash_attention,
    quant,
    short_attention,
    streaming_sigmoid_loss,
)
