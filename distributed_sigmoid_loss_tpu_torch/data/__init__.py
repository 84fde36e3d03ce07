"""The input pipeline: synthetic and real image-text data, tokenizers,
augmentation, prefetch to the device."""

from distributed_sigmoid_loss_tpu_torch.data.augment import (
    augment_batch,
    color_jitter,
    normalize,
    random_flip,
    random_resized_crop,
)
from distributed_sigmoid_loss_tpu_torch.data.files import (
    ImageTextFolder,
    ImageTextShards,
    decode_and_resize,
)
from distributed_sigmoid_loss_tpu_torch.data.loader import PrefetchStats, prefetch, put_batch
from distributed_sigmoid_loss_tpu_torch.data.native_loader import (
    NativeSyntheticImageText,
    native_available,
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
    "ImageTextFolder",
    "ImageTextShards",
    "NativeSyntheticImageText",
    "PrefetchStats",
    "SyntheticImageText",
    "augment_batch",
    "color_jitter",
    "decode_and_resize",
    "default_data_workers",
    "native_available",
    "normalize",
    "prefetch",
    "put_batch",
    "random_flip",
    "random_resized_crop",
    "resolve_data_workers",
    "shard_batch",
]
