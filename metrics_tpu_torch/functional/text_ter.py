"""Translation edit rate (TER, Snover et al. 2006).

Counterpart of ``metrics_tpu/functional/text_ter.py``, host work copied as it is.

Implements the Tercom algorithm's semantics — greedy block-shift search on
top of word-level Levenshtein, with Tercom's admissibility rules (a span
may shift only when it matches a reference span, both sides contain
alignment errors, and it is not already aligned there), its
alignment-derived destination rule, its shift ranking (gain, then longest,
then earliest source, then earliest target), and its candidate budget.
The JAX package's ``tests/text/test_ter.py`` verifies it against sacrebleu
on random corpora. Corpus TER is
``total best edits / total average reference length`` with per-segment
minimum over multiple references.

The accumulated statistics are two scalar sums, so the stateful metric
streams and sum-syncs like every text metric. All string work is host-side.
"""
from typing import Dict, List, Sequence, Tuple, Union

# Tercom's published limits
MAX_SHIFT_SIZE = 10
MAX_SHIFT_DIST = 50
MAX_SHIFT_CANDIDATES = 1000

_NOP, _SUB, _INS, _DEL = " ", "s", "i", "d"


_BEAM_WIDTH = 25
_INF = int(1e16)


def _edit_distance_trace(hyp: List[str], ref: List[str]) -> Tuple[int, str]:
    """Word Levenshtein + operation trace, Tercom's tie preference
    (match/substitute, then delete-from-hyp, then insert-from-ref), with
    sacrebleu's pseudo-diagonal beam (width 25) so scores stay bit-exact
    with the library even on extreme length mismatches."""
    import math

    n_h, n_r = len(hyp), len(ref)
    # dist[i][j] = (cost, op) rewriting hyp[:i] against ref[:j]
    dist = [[(_INF, _NOP)] * (n_r + 1) for _ in range(n_h + 1)]
    dist[0] = [(j, _INS) for j in range(n_r + 1)]
    length_ratio = n_r / n_h if hyp else 1.0
    beam = _BEAM_WIDTH if _BEAM_WIDTH >= length_ratio / 2 else math.ceil(length_ratio / 2 + _BEAM_WIDTH)
    for i in range(1, n_h + 1):
        row, prev = dist[i], dist[i - 1]
        h_word = hyp[i - 1]
        pseudo_diag = math.floor(i * length_ratio)
        min_j = max(0, pseudo_diag - beam)
        max_j = n_r + 1 if i == n_h else min(n_r + 1, pseudo_diag + beam)
        for j in range(min_j, max_j):
            if j == 0:
                row[0] = (prev[0][0] + 1, _DEL)
                continue
            sub = (prev[j - 1][0] + (h_word != ref[j - 1]), _NOP if h_word == ref[j - 1] else _SUB)
            best = sub
            if prev[j][0] + 1 < best[0]:
                best = (prev[j][0] + 1, _DEL)
            if row[j - 1][0] + 1 < best[0]:
                best = (row[j - 1][0] + 1, _INS)
            row[j] = best
    trace = []
    i, j = n_h, n_r
    while i > 0 or j > 0:
        op = dist[i][j][1]
        trace.append(op)
        if op in (_NOP, _SUB):
            i -= 1
            j -= 1
        elif op == _INS:
            j -= 1
        else:
            i -= 1
    return dist[n_h][n_r][0], "".join(reversed(trace))


def _alignment(trace: str) -> Tuple[Dict[int, int], List[int], List[int]]:
    """Flip the hyp->ref trace into ref->hyp and derive (ref pos -> hyp pos,
    ref error flags, hyp error flags) — the Tercom alignment."""
    pos_h = pos_r = -1
    align: Dict[int, int] = {}
    ref_err: List[int] = []
    hyp_err: List[int] = []
    for op in trace:
        if op in (_NOP, _SUB):
            pos_h += 1
            pos_r += 1
            align[pos_r] = pos_h
            err = 1 if op == _SUB else 0
            hyp_err.append(err)
            ref_err.append(err)
        elif op == _DEL:  # hyp word absent from ref (flipped: an insertion)
            pos_h += 1
            hyp_err.append(1)
        else:  # _INS: ref word absent from hyp (flipped: a deletion)
            pos_r += 1
            align[pos_r] = pos_h
            ref_err.append(1)
    return align, ref_err, hyp_err


def _matching_spans(hyp: List[str], ref: List[str]):
    """All (start_h, start_r, length) with equal words, within the limits."""
    n_h, n_r = len(hyp), len(ref)
    for start_h in range(n_h):
        for start_r in range(n_r):
            if abs(start_r - start_h) > MAX_SHIFT_DIST:
                continue
            length = 0
            while (
                start_h + length < n_h
                and start_r + length < n_r
                and hyp[start_h + length] == ref[start_r + length]
                and length < MAX_SHIFT_SIZE
            ):
                length += 1
                yield start_h, start_r, length


def _apply_shift(words: List[str], start: int, length: int, target: int) -> List[str]:
    if target < start:
        return words[:target] + words[start : start + length] + words[target:start] + words[start + length :]
    if target > start + length:
        return (
            words[:start]
            + words[start + length : target]
            + words[start : start + length]
            + words[target:]
        )
    return (
        words[:start]
        + words[start + length : length + target]
        + words[start : start + length]
        + words[length + target :]
    )


def _best_shift(hyp: List[str], ref: List[str], budget: int) -> Tuple[int, List[str], int]:
    """One round of Tercom's shift search: the admissible shift ranked
    highest by (gain, length, earliest source, earliest target)."""
    base, trace = _edit_distance_trace(hyp, ref)
    align, ref_err, hyp_err = _alignment(trace)

    best = None
    for start_h, start_r, length in _matching_spans(hyp, ref):
        # the hyp span must contain an error AND the ref span must too
        if not any(hyp_err[start_h : start_h + length]):
            continue
        if not any(ref_err[start_r : start_r + length]):
            continue
        # already aligned to this position: nothing to gain
        if start_h <= align[start_r] < start_h + length:
            continue
        prev_idx = -1
        for offset in range(-1, length):
            ref_pos = start_r + offset
            if ref_pos == -1:
                idx = 0
            elif ref_pos in align:
                idx = align[ref_pos] + 1
            else:
                break  # past the reference
            if idx == prev_idx:
                continue
            prev_idx = idx
            shifted = _apply_shift(hyp, start_h, length, idx)
            gain = base - _edit_distance_trace(shifted, ref)[0]
            candidate = (gain, length, -start_h, -idx, shifted)
            budget += 1
            if best is None or candidate > best:
                best = candidate
            if budget >= MAX_SHIFT_CANDIDATES:
                break
        if budget >= MAX_SHIFT_CANDIDATES:
            break
    if best is None:
        return 0, hyp, budget
    return best[0], best[4], budget


def _ter_edits(hyp: List[str], ref: List[str]) -> int:
    """Minimum shifts + Levenshtein edits, the Tercom greedy search."""
    if not ref:
        return len(hyp)
    hyp = list(hyp)
    shifts = 0
    budget = 0
    while True:
        gain, shifted, budget = _best_shift(hyp, ref, budget)
        if budget >= MAX_SHIFT_CANDIDATES or gain <= 0:
            break  # the losing candidate is NOT adopted (Tercom order)
        hyp = shifted
        shifts += 1
    return shifts + _edit_distance_trace(hyp, ref)[0]


def _ter_preprocess(sent: str, case_sensitive: bool) -> List[str]:
    sent = " ".join(sent.split())
    if not case_sensitive:
        sent = sent.lower()
    return sent.split()


def ter_stats(
    preds: Union[str, Sequence[str]],
    target: Sequence[Sequence[str]],
    case_sensitive: bool = False,
) -> Tuple[float, float]:
    """(total best edits, total average reference length) over the batch —
    both "sum"-reducible; per segment the edits are the minimum over the
    references and the length is their average (Tercom aggregation)."""
    if isinstance(preds, str):
        preds = [preds]
    if len(preds) != len(target):
        raise ValueError(f"preds has {len(preds)} sentences, target {len(target)}")
    total_edits = 0.0
    total_ref_len = 0.0
    for hyp, refs in zip(preds, target):
        if isinstance(refs, str):
            raise ValueError(
                "`target` must be a list of reference LISTS (one list per"
                " hypothesis); got a bare string — wrap it: [[ref]]"
            )
        if not refs:
            raise ValueError("each hypothesis needs at least one reference")
        h = _ter_preprocess(hyp, case_sensitive)
        best = None
        ref_len_sum = 0
        for ref in refs:
            r = _ter_preprocess(ref, case_sensitive)
            ref_len_sum += len(r)
            edits = _ter_edits(h, r)
            if best is None or edits < best:
                best = edits
        total_edits += best
        total_ref_len += ref_len_sum / len(refs)
    return total_edits, total_ref_len


def ter_from_stats(total_edits: float, total_ref_len: float) -> float:
    if total_ref_len > 0:
        return total_edits / total_ref_len
    return 1.0 if total_edits > 0 else 0.0


def translation_edit_rate(
    preds: Union[str, Sequence[str]],
    target: Sequence[Sequence[str]],
    case_sensitive: bool = False,
) -> float:
    """Corpus TER in [0, inf) (sacrebleu reports the same value x 100);
    lower is better, 0 means every hypothesis matches a reference.

    Example:
        >>> round(translation_edit_rate(["the cat sat on mat"],
        ...                             [["the cat sat on the mat"]]), 4)
        0.1667
        >>> round(translation_edit_rate(["b a c d"], [["a b c d"]]), 2)
        0.25
    """
    return ter_from_stats(*ter_stats(preds, target, case_sensitive))
