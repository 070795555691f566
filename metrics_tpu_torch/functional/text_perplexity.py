"""Perplexity over next-token logits.

Counterpart of ``metrics_tpu/functional/text_perplexity.py``. Streaming form:
total negative log-likelihood + token count, two scalar ``"sum"`` states.

The JAX package casts the whole ``(tokens, vocab)`` logits to float32 and
materializes ``log_softmax`` before its gather. At a large vocabulary that is
gigabytes of float32 temporaries, so the port walks row chunks whose float32
temporaries stay near 1 GiB (:data:`CHUNK_BYTES`): the same function, one
``log_softmax`` (in float32, whatever the logits' dtype) and one gather a chunk.

Target ids follow the JAX package's gather exactly: a negative id wraps once
(``-1`` is ``V - 1``; ``-100`` without ``ignore_index`` is ``V - 100``), an id
still outside ``[0, V)`` gives a NaN log-likelihood (its gather fill), and
``ignore_index`` ids count as id 0 with weight 0. The gather itself only ever
sees a clamped index: an out-of-range index in a CUDA gather is a device-side
assert that ends the process.
"""
from typing import Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utils.data import accum_int_dtype

# float32 log-probabilities a chunk holds. ``log_softmax`` may first convert a
# bf16 chunk to float32, so a chunk's temporaries peak near twice this: 1 GiB
CHUNK_BYTES = 1 << 29


def _token_nll(logits: Tensor, ids: Tensor) -> Tensor:
    """Float32 negative log-likelihood of each row's id, NaN where the id lies outside the vocabulary."""
    vocab = logits.shape[-1]
    ids = torch.where(ids < 0, ids + vocab, ids)
    inside = (ids >= 0) & (ids < vocab)
    index = ids.clamp(0, vocab - 1)[:, None]
    nll = torch.empty(logits.shape[0], dtype=torch.float32, device=logits.device)
    rows = max(1, CHUNK_BYTES // (4 * vocab))
    for lo in range(0, logits.shape[0], rows):
        logp = torch.log_softmax(logits[lo : lo + rows], dim=-1, dtype=torch.float32)
        nll[lo : lo + rows] = -logp.gather(1, index[lo : lo + rows])[:, 0]
    return torch.where(inside, nll, torch.full_like(nll, float("nan")))


def _perplexity_update(
    preds: Tensor, target: Tensor, ignore_index: Optional[int] = None
) -> Tuple[Tensor, Tensor]:
    """(sum of token NLLs, token count) for logits ``(..., T, V)`` and ids
    ``(..., T)``; ``ignore_index`` rows contribute nothing."""
    if preds.ndim < 2:
        raise ValueError(f"`preds` must be (..., seq, vocab) logits, got shape {tuple(preds.shape)}")
    if target.shape != preds.shape[:-1]:
        raise ValueError(
            f"`target` shape {tuple(target.shape)} must equal `preds` shape without the vocab axis"
            f" {tuple(preds.shape[:-1])}"
        )
    logits = preds.reshape(-1, preds.shape[-1])
    ids = target.reshape(-1).to(torch.int32)
    mask = torch.ones_like(ids, dtype=torch.float32)
    if ignore_index is not None:
        ignored = ids == ignore_index
        mask = (~ignored).to(torch.float32)
        ids = torch.where(ignored, torch.zeros_like(ids), ids)
    nll = _token_nll(logits, ids.long())
    # integer token count: float32 counts stop incrementing at 2^24 tokens
    return torch.sum(nll * mask), torch.sum(mask.to(accum_int_dtype()))


def perplexity(preds: Tensor, target: Tensor, ignore_index: Optional[int] = None) -> Tensor:
    """``exp`` of the mean per-token negative log-likelihood.

    Args:
        preds: ``(..., seq, vocab)`` UNNORMALIZED logits.
        target: ``(..., seq)`` integer token ids.
        ignore_index: target id to mask out (e.g. padding).

    Example:
        >>> import torch
        >>> logits = torch.log(torch.tensor([[[0.25, 0.75], [0.5, 0.5]]]))
        >>> round(float(perplexity(logits, torch.tensor([[1, 0]]))), 4)
        1.633
    """
    total, count = _perplexity_update(preds, target, ignore_index)
    return torch.exp(total / torch.clamp_min(count, 1).to(torch.float32))
