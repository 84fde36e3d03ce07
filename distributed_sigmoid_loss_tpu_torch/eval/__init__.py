"""Retrieval and zero-shot evaluation, and the ranking helpers shared with
serving."""

from distributed_sigmoid_loss_tpu_torch.eval.retrieval import (
    merge_topk,
    recall_at_k,
    retrieval_metrics,
    retrieval_ranks,
    topk_ids,
)
from distributed_sigmoid_loss_tpu_torch.eval.zeroshot import (
    CLIP_TEMPLATES,
    build_classifier,
    classifier_weights,
    classify_ranks,
    zeroshot_metrics,
)

__all__ = [
    "CLIP_TEMPLATES",
    "build_classifier",
    "classifier_weights",
    "classify_ranks",
    "merge_topk",
    "recall_at_k",
    "retrieval_metrics",
    "retrieval_ranks",
    "topk_ids",
    "zeroshot_metrics",
]
