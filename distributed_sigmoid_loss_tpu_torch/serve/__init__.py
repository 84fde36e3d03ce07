"""Online embedding serving: cache → micro-batcher → bucketed engine → index."""

from distributed_sigmoid_loss_tpu_torch.serve.batcher import (
    BatcherClosedError,
    MicroBatcher,
    QueueFullError,
    ShutdownError,
)
from distributed_sigmoid_loss_tpu_torch.serve.cache import EmbeddingCache, content_key
from distributed_sigmoid_loss_tpu_torch.serve.engine import InferenceEngine
from distributed_sigmoid_loss_tpu_torch.serve.index import RetrievalIndex
from distributed_sigmoid_loss_tpu_torch.serve.service import (
    EmbeddingService,
    RequestTimeoutError,
)

__all__ = [
    "BatcherClosedError",
    "EmbeddingCache",
    "EmbeddingService",
    "InferenceEngine",
    "MicroBatcher",
    "QueueFullError",
    "RequestTimeoutError",
    "RetrievalIndex",
    "ShutdownError",
    "content_key",
]
