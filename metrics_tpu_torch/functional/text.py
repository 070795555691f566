"""Word / character error rates and the batched Levenshtein and LCS DPs.

Counterpart of ``metrics_tpu/functional/text.py``. Two evaluation paths, as there:

- ``wer(preds, target)`` and its siblings: host API over strings / token lists
  (tokenizing is host work regardless), a numpy DP per pair, returning Python
  floats.
- ``edit_distance_padded`` / ``lcs_length_padded``: batched DPs over padded
  token-id tensors on the tensors' device, one vectorized step a prediction
  token for the whole batch.

Both DPs compute a row at a time. The Levenshtein row has a left dependency
(``cur[j] = min(c[j], cur[j - 1] + 1)``, where ``c[j]`` is the better of the
diagonal and the vertical step), which the JAX package walks with an inner
serial scan. Unrolled, ``cur[j] = min_{k <= j} c[k] + (j - k)``, so the whole row
is ``j + cummin(c - j)``: one ``cummin`` a row and no per-cell loop. The
(distance, hits) DP, lexicographic over ``(distance, -hits)``, takes the same
form on one integer key ``K = d * L - h`` with ``L`` above every possible hit
count: a match step costs ``-1``, every other step ``+L``, and the new row is
``j * L + cummin(c - j * L)``; ``d = ceil(K / L)`` and ``h = d * L - K``. Both
are exact (``tests/test_torch_text.py`` holds them to the JAX package's per-cell
DPs on thousands of random pairs).
"""
from typing import Callable, List, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

TokenSeq = Union[str, Sequence[str]]


def _tokens(x: TokenSeq) -> List[str]:
    return x.split() if isinstance(x, str) else list(x)


def _chars(x: TokenSeq) -> List[str]:
    return list(x) if isinstance(x, str) else [c for tok in x for c in tok]


def _interned(a: Sequence[str], b: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
    """The two sequences as int64 ids of one vocabulary (equal tokens, equal ids)."""
    vocab: dict = {}
    ids = np.asarray([vocab.setdefault(t, len(vocab)) for t in (*a, *b)], dtype=np.int64)
    return ids[: len(a)], ids[len(a):]


def _np_edit_keys(a: np.ndarray, b: np.ndarray, unit: int, match: int) -> int:
    """Last cell of the row DP: a match step costs ``match``, every other step ``unit``."""
    cols = np.arange(len(b) + 1, dtype=np.int64) * unit
    row = cols.copy()
    c = np.empty(len(b) + 1, dtype=np.int64)
    for i, tok in enumerate(a, 1):
        c[0] = i * unit
        np.minimum(row[:-1] + np.where(b == tok, match, unit), row[1:] + unit, out=c[1:])
        row = np.minimum.accumulate(c - cols) + cols
    return int(row[-1])


def _np_edit_distance(a: List[str], b: List[str]) -> int:
    """Host Levenshtein distance (numpy row recurrence, one ``cummin`` a row)."""
    if not a:
        return len(b)
    ai, bi = _interned(a, b)
    return _np_edit_keys(ai, bi, 1, 0)


def _np_edit_distance_hits(a: List[str], b: List[str]) -> Tuple[int, int]:
    """(edit distance, aligned matches) via a host DP.

    ``hits`` is the number of matched tokens in a minimum-edit alignment,
    maximized over all minimum-distance alignments (a deterministic
    definition; jiwer-style MER/WIP derive from exactly these two numbers:
    ``S + D = len(b) - hits``, ``I = dist - S - D``).
    """
    if not a:
        return len(b), 0
    if not b:
        return len(a), 0
    ai, bi = _interned(a, b)
    scale = min(len(a), len(b)) + 1  # above every hit count, so K orders (distance, -hits)
    key = _np_edit_keys(ai, bi, scale, -1)
    dist = -(-key // scale)
    return dist, dist * scale - key


def _sequence_stats(
    preds: Union[str, Sequence[TokenSeq]],
    target: Union[str, Sequence[TokenSeq]],
    tokenize: Callable[[TokenSeq], List[str]],
    need_hits: bool = True,
) -> Tuple[int, int, int, int]:
    """(edit errors, hits, target length, pred length) summed over pairs.

    ``need_hits=False`` (CER: distance only) reports hits as 0.
    """
    if isinstance(preds, str):
        preds = [preds]
    if isinstance(target, str):
        target = [target]
    if len(preds) != len(target):
        raise ValueError("`preds` and `target` must have the same number of sequences")
    errors = hits = total_t = total_p = 0
    for p, t in zip(preds, target):
        pt, tt = tokenize(p), tokenize(t)
        if need_hits:
            d, h = _np_edit_distance_hits(pt, tt)
            hits += h
        else:
            d = _np_edit_distance(pt, tt)
        errors += d
        total_t += len(tt)
        total_p += len(pt)
    return errors, hits, total_t, total_p


def cer(preds: Union[str, Sequence[str]], target: Union[str, Sequence[str]]) -> float:
    """Character error rate: character-level edit distance / reference chars.

    Characters are taken from the strings as-is (spaces included);
    pre-tokenized input concatenates its tokens' characters.

    Example:
        >>> cer("abcd", "abce")
        0.25
    """
    errors, _, total, _ = _sequence_stats(preds, target, _chars, need_hits=False)
    if total == 0:
        return 0.0 if errors == 0 else float("inf")
    return errors / total


def match_error_rate(preds: Union[str, Sequence[TokenSeq]], target: Union[str, Sequence[TokenSeq]]) -> float:
    """MER: ``(S + D + I) / (H + S + D + I)`` over all word pairs.

    Example:
        >>> round(match_error_rate("the cat sat", "the cat sat on the mat"), 4)
        0.5
    """
    errors, hits, _, _ = _sequence_stats(preds, target, _tokens)
    denom = errors + hits
    if denom == 0:
        return 0.0
    return errors / denom


def word_information_preserved(
    preds: Union[str, Sequence[TokenSeq]], target: Union[str, Sequence[TokenSeq]]
) -> float:
    """WIP: ``(H / N_target) * (H / N_pred)``.

    Example:
        >>> round(word_information_preserved("the cat sat", "the cat sat on the mat"), 4)
        0.5
    """
    _, hits, total_t, total_p = _sequence_stats(preds, target, _tokens)
    if total_t == 0 or total_p == 0:
        return 0.0
    return (hits / total_t) * (hits / total_p)


def word_information_lost(
    preds: Union[str, Sequence[TokenSeq]], target: Union[str, Sequence[TokenSeq]]
) -> float:
    """WIL: ``1 - WIP``.

    Example:
        >>> round(word_information_lost("the cat sat", "the cat sat on the mat"), 4)
        0.5
    """
    return 1.0 - word_information_preserved(preds, target)


def _wer_update(preds: Union[str, Sequence[TokenSeq]], target: Union[str, Sequence[TokenSeq]]) -> Tuple[int, int]:
    if isinstance(preds, str):
        preds = [preds]
    if isinstance(target, str):
        target = [target]
    if len(preds) != len(target):
        raise ValueError("`preds` and `target` must have the same number of sequences")
    errors = total = 0
    for p, t in zip(preds, target):
        pt, tt = _tokens(p), _tokens(t)
        errors += _np_edit_distance(pt, tt)
        total += len(tt)
    return errors, total


def wer(preds: Union[str, Sequence[TokenSeq]], target: Union[str, Sequence[TokenSeq]]) -> float:
    """Word error rate: edit distance / reference length, over all pairs.

    ``preds``/``target`` are a single sentence string or a sequence of
    sentences, where each sentence is a string (whitespace-tokenized) or a
    pre-tokenized token list — i.e. pre-tokenized input nests one level:
    ``wer([["the", "cat"]], [["the", "cat", "sat"]])``. A flat list is
    always read as a BATCH of sentences, never as one token list.

    With no reference words the result is 0.0 for a perfect empty match and
    ``inf`` when there are errors.

    Example:
        >>> wer("the cat sat", "the cat sat on the mat")
        0.5
    """
    errors, total = _wer_update(preds, target)
    if total == 0:
        return 0.0 if errors == 0 else float("inf")
    return errors / total


def _check_lengths(pred_len: Tensor, target_len: Tensor, n: int, m: int) -> None:
    """The JAX package's ``ValueError`` for lengths outside ``[0, padded width]``: one host read a call."""
    if pred_len.numel() == 0:
        return
    lo_p, hi_p, lo_t, hi_t = torch.stack(
        [pred_len.min(), pred_len.max(), target_len.min(), target_len.max()]
    ).tolist()
    for name, lo, hi, width in (("pred_len", lo_p, hi_p, n), ("target_len", lo_t, hi_t, m)):
        if lo < 0 or hi > width:
            raise ValueError(
                f"`{name}` must lie in [0, {width}] (the padded axis length); got range [{lo}, {hi}]"
            )


def edit_distance_padded(pred_ids: Tensor, target_ids: Tensor, pred_len: Tensor, target_len: Tensor) -> Tensor:
    """Batched Levenshtein over padded token-id tensors, on their device.

    Args:
        pred_ids: (B, N) int token ids, padded.
        target_ids: (B, M) int token ids, padded.
        pred_len: (B,) true lengths of ``pred_ids`` rows.
        target_len: (B,) true lengths of ``target_ids`` rows.

    Returns:
        (B,) int32 edit distances.

    Lengths must satisfy ``0 <= pred_len[i] <= N`` and
    ``0 <= target_len[i] <= M``; out-of-range lengths raise a ``ValueError``.
    One vectorized row step a prediction position (a ``cummin`` over the row,
    see the module docstring), rows past a pair's ``pred_len`` left as they are.

    Example:
        >>> import torch
        >>> p = torch.tensor([[1, 2, 3, 0]])
        >>> t = torch.tensor([[1, 9, 3, 4]])
        >>> int(edit_distance_padded(p, t, torch.tensor([3]), torch.tensor([4]))[0])
        2
    """
    batch, n = pred_ids.shape
    m = target_ids.shape[1]
    _check_lengths(pred_len, target_len, n, m)
    cols = torch.arange(m + 1, dtype=torch.int32, device=pred_ids.device)
    row = cols.expand(batch, m + 1).contiguous()
    step = torch.empty_like(row)
    for i in range(n):
        step[:, 0] = i + 1
        torch.minimum(row[:, :-1] + (target_ids != pred_ids[:, i : i + 1]), row[:, 1:] + 1, out=step[:, 1:])
        new = torch.cummin(step - cols, dim=1).values + cols
        row = torch.where((pred_len > i)[:, None], new, row)
    return row.gather(1, target_len.long()[:, None])[:, 0]


def lcs_length_padded(pred_ids: Tensor, target_ids: Tensor, pred_len: Tensor, target_len: Tensor) -> Tensor:
    """Batched longest-common-subsequence length over padded token-id
    tensors, on their device (the ROUGE-L DP; ``edit_distance_padded``'s contract).

    ``L(i, j) = max(L(i-1, j), L(i, j-1), L(i-1, j-1) + match)``: taking the
    extra maxes is always valid because skipping tokens never lengthens an
    LCS, so the ``L(i, j-1)`` running max is one ``cummax`` a row. Padded
    target slots never match.

    Args:
        pred_ids: (B, N) int token ids, padded.
        target_ids: (B, M) int token ids, padded.
        pred_len: (B,) true lengths of ``pred_ids`` rows.
        target_len: (B,) true lengths of ``target_ids`` rows.

    Returns:
        (B,) int32 LCS lengths.

    Example:
        >>> import torch
        >>> p = torch.tensor([[1, 2, 3, 4, 0]])
        >>> t = torch.tensor([[1, 9, 3, 4]])
        >>> int(lcs_length_padded(p, t, torch.tensor([4]), torch.tensor([4]))[0])
        3
    """
    batch, n = pred_ids.shape
    m = target_ids.shape[1]
    _check_lengths(pred_len, target_len, n, m)
    device = pred_ids.device
    valid_t = torch.arange(m, device=device) < target_len[:, None]
    row = torch.zeros(batch, m + 1, dtype=torch.int32, device=device)
    first = row[:, :1]  # column 0 stays 0
    for i in range(n):
        match = (target_ids == pred_ids[:, i : i + 1]) & valid_t
        new = torch.cat([first, torch.cummax(torch.maximum(row[:, 1:], row[:, :-1] + match), dim=1).values], 1)
        row = torch.where((pred_len > i)[:, None], new, row)
    return row.gather(1, target_len.long()[:, None])[:, 0]
