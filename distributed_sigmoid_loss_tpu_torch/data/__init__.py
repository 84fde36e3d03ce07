"""The input pipeline: synthetic data, tokenizers, prefetch to the device."""

from distributed_sigmoid_loss_tpu_torch.data.loader import (
    PrefetchStats,
    global_batch_from_local,
    prefetch,
    put_batch,
)
from distributed_sigmoid_loss_tpu_torch.data.synthetic import SyntheticImageText, shard_batch
from distributed_sigmoid_loss_tpu_torch.data.tokenizer import BpeTokenizer, ByteTokenizer
from distributed_sigmoid_loss_tpu_torch.data.workers import (
    default_data_workers,
    resolve_data_workers,
)

__all__ = [
    "BpeTokenizer",
    "ByteTokenizer",
    "PrefetchStats",
    "SyntheticImageText",
    "default_data_workers",
    "global_batch_from_local",
    "prefetch",
    "put_batch",
    "resolve_data_workers",
    "shard_batch",
]
