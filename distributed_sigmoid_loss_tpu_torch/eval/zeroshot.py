"""Zero-shot classification, the second standard SigLIP eval next to
retrieval, ported from the JAX package's ``eval/zeroshot.py``: each class
becomes a text embedding averaged over prompt templates, and an image is
classified by its nearest class embedding.

Every rank ranks its own images against the whole (n_classes, d)
classifier, with no collective; the accuracies are means over the global
batch. Ranks are exact counts of strictly-greater logits (ties resolve
optimistically), as in ``eval/retrieval.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_sigmoid_loss_tpu_torch.eval.retrieval import global_mean
from distributed_sigmoid_loss_tpu_torch.ops.sigmoid_loss import l2_normalize

__all__ = [
    "classifier_weights",
    "classify_ranks",
    "zeroshot_metrics",
    "build_classifier",
    "CLIP_TEMPLATES",
]

# A compact prompt-ensemble set (the CLIP/SigLIP recipe uses ~80 templates;
# these seven carry most of the ensemble gain). The class name sits LATE in
# each template: with a short context_length the tokenizer truncates it away
# and every class collapses onto the same tokens — use name-first templates
# ("{} photo.") when context_length cannot hold the whole prompt.
CLIP_TEMPLATES = (
    "a photo of a {}.",
    "a photo of the {}.",
    "a bad photo of a {}.",
    "a photo of many {}.",
    "a close-up photo of a {}.",
    "a black and white photo of a {}.",
    "an illustration of a {}.",
)


def classifier_weights(class_text_embeddings: torch.Tensor) -> torch.Tensor:
    """(n_classes, n_templates, d) per-template text embeddings → (n_classes,
    d) classifier: L2-normalize each template embedding, average over the
    templates, normalize again (the CLIP/SigLIP prompt ensemble)."""
    z = l2_normalize(class_text_embeddings)
    return l2_normalize(torch.mean(z, dim=1))


@torch.no_grad()
def build_classifier(
    encode_text,
    class_names,
    tokenizer,
    context_length: int,
    templates=CLIP_TEMPLATES,
    batch_size: int = 1024,
) -> torch.Tensor:
    """Class names → (n_classes, d) prompt-ensembled classifier.

    ``encode_text`` is any ``tokens -> (n, d) embeddings`` callable (it puts
    the int32 CPU tokens on its device, e.g. ``lambda t:
    model.encode_text(t.to(device))``); ``tokenizer`` is the ``data``
    tokenizers' interface (``(texts, length) -> ids``). Prompts are encoded
    in chunks of ``batch_size`` (at most the prompt count), the last padded
    with zeros. ``context_length`` must hold the whole prompt: a class name
    truncated away collapses the classes onto the same tokens.
    """
    if not class_names:
        raise ValueError("class_names must be non-empty")
    if not templates:
        raise ValueError("templates must be non-empty")
    prompts = [t.format(name) for name in class_names for t in templates]
    tokens = torch.from_numpy(np.asarray(tokenizer(prompts, context_length), dtype=np.int32))
    batch_size = min(batch_size, tokens.shape[0])
    chunks = []
    for start in range(0, tokens.shape[0], batch_size):
        chunk = tokens[start:start + batch_size]
        pad = batch_size - chunk.shape[0]
        if pad:  # only the final chunk is short
            chunk = torch.cat([chunk, chunk.new_zeros((pad, chunk.shape[1]))])
        chunks.append(encode_text(chunk))
    z = torch.cat(chunks)[:len(prompts)]
    return classifier_weights(z.reshape(len(class_names), len(templates), -1))


def classify_ranks(zimg: torch.Tensor, classifier: torch.Tensor,
                   labels: torch.Tensor) -> torch.Tensor:
    """Rank (0-based) of each image's true class: the number of classes
    scoring strictly higher than ``labels[i]`` for image ``i``, the true
    logit read out of the same product. ``rank == 0`` is a top-1 hit."""
    logits = zimg @ classifier.T  # (b, n_classes)
    true_logit = torch.take_along_dim(logits, labels.long()[:, None], dim=1)
    return torch.sum(logits > true_logit, dim=1)


@torch.no_grad()
def zeroshot_metrics(
    zimg: torch.Tensor,
    classifier: torch.Tensor,
    labels: torch.Tensor,
    ks: tuple[int, ...] = (1, 5),
) -> dict[str, torch.Tensor]:
    """Top-k zero-shot accuracy over the global image batch, as 0-d tensors.
    Every rank of the world passes its own images and labels and the whole
    classifier."""
    ranks = classify_ranks(zimg, classifier, labels)
    return {f"top@{k}": global_mean(ranks < k) for k in ks}
