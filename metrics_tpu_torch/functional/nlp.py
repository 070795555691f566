"""BLEU score over window-equality matrices on the device.

Counterpart of ``metrics_tpu/functional/nlp.py``: clipped n-gram precision per
order, max-over-references clipping, brevity penalty from the closest
reference length (first reference wins ties), optional add-1 smoothing. As
there:

* tokens are interned to integer ids once on the host and padded into
  ``(B, L)`` / ``(B, R, L)`` tensors, moved to the device in one copy each;
* every n-gram statistic comes from window-equality matrices: ``E_n[i, j]``
  says whether the length-``n`` windows starting at ``i`` and ``j`` are equal,
  ``E_n = E_{n-1} & shifted token equality``, so counts are exact with no
  hashing;
* the clipped-count sum over distinct n-grams is a sum over positions: a gram
  with multiplicity ``c`` clipped at ``m`` contributes ``min(c, m) / c`` at
  each of its ``c`` windows.

The JAX package vmaps one example at a time. The port runs the whole batch at
once, in chunks of examples whose ``(b, L, R, L)`` comparison stays under
:data:`CHUNK_ELEMENTS`, so one long sentence in a large batch cannot blow up
the temporaries (``L`` is the batch's longest sentence, hypotheses and
references together).
"""
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.utils.data import accum_int_dtype
from metrics_tpu_torch.utils.device import resolve_device

_PAD = -1  # never equal to a real token id (ids start at 0)

# elements of a chunk's (b, L, R, L) bool comparison
CHUNK_ELEMENTS = 1 << 26


def _intern_corpus(
    translate_corpus: Sequence[Sequence[str]],
    reference_corpus: Sequence[Sequence[Sequence[str]]],
) -> Tuple[List[List[int]], List[List[List[int]]]]:
    """Map every distinct token to a dense integer id (host-side, one pass)."""
    vocab: dict = {}

    def ids(seq: Sequence[str]) -> List[int]:
        return [vocab.setdefault(tok, len(vocab)) for tok in seq]

    hyp_ids = [ids(t) for t in translate_corpus]
    ref_ids = [[ids(r) for r in refs] for refs in reference_corpus]
    return hyp_ids, ref_ids


def _pad_corpus(
    hyp_ids: List[List[int]], ref_ids: List[List[List[int]]], device: Optional[torch.device] = None
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Pack ragged id lists into padded tensors + lengths/masks on ``device``
    (packed on the host, one copy a tensor)."""
    batch = len(hyp_ids)
    max_refs = max((len(r) for r in ref_ids), default=1) or 1
    max_len = max([len(h) for h in hyp_ids] + [len(r) for refs in ref_ids for r in refs] + [1])

    hyp = np.full((batch, max_len), _PAD, dtype=np.int32)
    refs = np.full((batch, max_refs, max_len), _PAD, dtype=np.int32)
    hyp_len = np.asarray([len(h) for h in hyp_ids], dtype=np.int32)
    ref_len = np.zeros((batch, max_refs), dtype=np.int32)
    ref_mask = np.zeros((batch, max_refs), dtype=bool)

    for b, h in enumerate(hyp_ids):
        hyp[b, : len(h)] = h
    for b, rs in enumerate(ref_ids):
        for j, r in enumerate(rs):
            refs[b, j, : len(r)] = r
            ref_len[b, j] = len(r)
            ref_mask[b, j] = True
    return tuple(torch.from_numpy(x).to(device) for x in (hyp, hyp_len, refs, ref_len, ref_mask))


def _shift_diag(mat: Tensor, k: int, axes: Tuple[int, int]) -> Tensor:
    """``out[.., i, .., j] = mat[.., i+k, .., j+k]`` with False padding."""
    if k == 0:
        return mat
    src, dst = [slice(None)] * mat.ndim, [slice(None)] * mat.ndim
    for axis in axes:
        src[axis], dst[axis] = slice(k, None), slice(None, -k)
    out = torch.zeros_like(mat)
    out[tuple(dst)] = mat[tuple(src)]
    return out


def _chunk_counts(hyp: Tensor, hyp_len: Tensor, refs: Tensor, ref_len: Tensor, ref_mask: Tensor,
                  n_gram: int) -> Tuple[Tensor, Tensor]:
    """Per-example clipped sums ``(b, n_gram)`` (float32) and per-order window counts ``(n_gram,)``."""
    pos = torch.arange(hyp.shape[-1], device=hyp.device)
    eq_hh = hyp[:, :, None] == hyp[:, None, :]  # (b, L, L)
    eq_hr = hyp[:, :, None, None] == refs[:, None, :, :]  # (b, L, R, L)
    e_hh, e_hr = eq_hh, eq_hr
    nums, dens = [], []
    for n in range(1, n_gram + 1):
        if n > 1:
            e_hh = e_hh & _shift_diag(eq_hh, n - 1, (1, 2))
            e_hr = e_hr & _shift_diag(eq_hr, n - 1, (1, 3))
        valid_h = pos <= hyp_len[:, None] - n  # (b, L): full windows only
        valid_r = (pos <= ref_len[:, :, None] - n) & ref_mask[:, :, None]  # (b, R, L)
        # multiplicity of window i among the hypothesis's windows / the best reference's
        c_hyp = (e_hh & valid_h[:, None, :]).sum(-1)
        m_ref = (e_hr & valid_r[:, None]).sum(-1).amax(-1)
        clipped = torch.where(valid_h, torch.minimum(c_hyp, m_ref) / torch.clamp_min(c_hyp, 1), 0.0)
        nums.append(clipped.sum(1))
        dens.append(valid_h.sum())
    return torch.stack(nums, 1), torch.stack(dens)


def bleu_counts(
    hyp: Tensor,
    hyp_len: Tensor,
    refs: Tensor,
    ref_len: Tensor,
    ref_mask: Tensor,
    n_gram: int = 4,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """BLEU sufficient statistics (all ``"sum"``-reducible) on the inputs' device.

    Args:
        hyp: ``(B, L)`` int token ids, padded with a negative sentinel.
        hyp_len: ``(B,)`` true hypothesis lengths.
        refs: ``(B, R, L)`` padded reference token ids.
        ref_len: ``(B, R)`` true reference lengths.
        ref_mask: ``(B, R)`` True where a reference actually exists.
        n_gram: max n-gram order.

    Returns:
        ``(numerator (n_gram,) float32, denominator (n_gram,) int64, c, r)`` —
        clipped match counts and total hyp n-gram counts per order, total
        translation length ``c`` and closest-reference length ``r`` (int64;
        ties on closeness go to the first reference in list order).
    """
    batch, length = hyp.shape
    per_chunk = max(1, CHUNK_ELEMENTS // max(1, length * refs.shape[1] * length))
    nums, den = [], torch.zeros(n_gram, dtype=accum_int_dtype(), device=hyp.device)
    for lo in range(0, batch, per_chunk):
        sl = slice(lo, lo + per_chunk)
        num_b, den_b = _chunk_counts(hyp[sl], hyp_len[sl], refs[sl], ref_len[sl], ref_mask[sl], n_gram)
        nums.append(num_b)
        den = den + den_b
    numerator = torch.cat(nums).sum(0) if nums else torch.zeros(n_gram, device=hyp.device)
    # brevity: the reference length closest to the hypothesis length (argmin: the first wins ties)
    diff = torch.where(ref_mask, (ref_len - hyp_len[:, None]).abs(), torch.iinfo(torch.int32).max)
    closest = ref_len.gather(1, diff.argmin(1, keepdim=True))
    return numerator, den, hyp_len.sum(dtype=accum_int_dtype()), closest.sum(dtype=accum_int_dtype())


def bleu_from_counts(
    numerator: Tensor, denominator: Tensor, c: Tensor, r: Tensor, smooth: bool = False
) -> Tensor:
    """Final BLEU from accumulated sufficient statistics (float32 tensors)."""
    n_gram = numerator.shape[0]
    if smooth:
        precision = (numerator + 1.0) / (denominator + 1.0)
    else:
        # guard 0/0 and log(0); the min(numerator) == 0 gate below zeroes the result
        precision = torch.where(numerator > 0, numerator, 1.0) / torch.clamp_min(denominator, 1.0)
    geometric_mean = torch.exp(torch.sum(torch.log(precision) / n_gram))
    brevity_penalty = torch.where(c > r, 1.0, torch.exp(1.0 - r / torch.clamp_min(c, 1e-9)))
    score = brevity_penalty * geometric_mean
    return torch.where(numerator.min() == 0, 0.0, score)


def bleu_score(
    translate_corpus: Sequence[Sequence[str]],
    reference_corpus: Sequence[Sequence[Sequence[str]]],
    n_gram: int = 4,
    smooth: bool = False,
    device: Optional[Union[str, torch.device]] = None,
) -> Tensor:
    """BLEU of machine-translated text against one or more references.

    Clipped n-gram precisions per order, brevity penalty, geometric mean;
    optional Lin et al. 2004 add-1 smoothing. Tokens are interned on the host;
    the counting runs on ``device`` (``None``: ``cuda``; see :func:`bleu_counts`).

    Example:
        >>> translate_corpus = ['the cat is on the mat'.split()]
        >>> reference_corpus = [['there is a cat on the mat'.split(), 'a cat is on the mat'.split()]]
        >>> round(float(bleu_score(translate_corpus, reference_corpus, device="cpu")), 4)
        0.7598
    """
    if len(translate_corpus) != len(reference_corpus):
        raise ValueError(
            f"translate_corpus has {len(translate_corpus)} sentences, reference_corpus {len(reference_corpus)}"
        )
    hyp_ids, ref_ids = _intern_corpus(translate_corpus, reference_corpus)
    padded = _pad_corpus(hyp_ids, ref_ids, resolve_device(device))
    numerator, denominator, c, r = bleu_counts(*padded, n_gram=n_gram)
    return bleu_from_counts(numerator, denominator.float(), c.float(), r.float(), smooth=smooth)
