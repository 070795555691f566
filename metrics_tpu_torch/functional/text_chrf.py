"""chrF score (character n-gram F-score, Popović 2015).

Counterpart of ``metrics_tpu/functional/text_chrf.py``, host work copied
as it is. It follows the sacrebleu chrF2 conventions: char order 6, beta=2,
whitespace stripped before n-gram extraction, corpus scores from SUMMED
per-order statistics, per-order F averaged over the orders where both
hypothesis and reference produced n-grams).

The statistics are ``(3, order)`` integer sums (matches, hypothesis
n-grams, reference n-grams) — "sum"-reducible across batches, processes,
and mesh axes, so the stateful metric streams like every sum-state metric.
N-gram extraction is host-side string work (as for BLEU/ROUGE); the
arithmetic is trivial either side.
"""
from collections import Counter
from typing import Sequence, Tuple, Union

import numpy as np

CHRF_CHAR_ORDER = 6


def _char_ngram_counts(text: str, n: int, lowercase: bool, whitespace: bool) -> Counter:
    if lowercase:
        text = text.lower()
    if not whitespace:
        text = "".join(text.split())
    return Counter(text[i : i + n] for i in range(len(text) - n + 1))


def _as_list(x: Union[str, Sequence[str]]) -> Sequence[str]:
    return [x] if isinstance(x, str) else list(x)


def chrf_stats(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str]],
    n_char_order: int = CHRF_CHAR_ORDER,
    lowercase: bool = False,
    whitespace: bool = False,
) -> np.ndarray:
    """``(3, n_char_order)`` summed (matches, hyp n-grams, ref n-grams)."""
    preds, target = _as_list(preds), _as_list(target)
    if len(preds) != len(target):
        raise ValueError(f"preds has {len(preds)} sentences, target {len(target)}")
    stats = np.zeros((3, n_char_order), dtype=np.int64)
    for hyp, ref in zip(preds, target):
        for i, n in enumerate(range(1, n_char_order + 1)):
            h = _char_ngram_counts(hyp, n, lowercase, whitespace)
            r = _char_ngram_counts(ref, n, lowercase, whitespace)
            stats[0, i] += sum((h & r).values())
            # sacrebleu: a segment's hypothesis n-grams do not count at
            # orders where its reference produced none ("don't count hits
            # if no reference exists for that n-gram" — helpers.py parity)
            stats[1, i] += sum(h.values()) if r else 0
            stats[2, i] += sum(r.values())
    return stats


def chrf_from_stats(stats: np.ndarray, beta: float = 2.0, eps_smoothing: bool = False) -> float:
    """Corpus chrF from summed statistics — sacrebleu 2.x semantics exactly
    (the JAX package's ``tests/text/test_chrf.py`` verifies it against the
    library; ``tests/test_torch_text.py`` holds this copy to the JAX package).

    Default: per-order precision/recall averaged over the EFFECTIVE orders
    (both sides produced n-grams), then one F_beta of the averages.
    ``eps_smoothing=True``: the chrF++.py / NLTK / Moses variant — per-order
    F_beta with eps-smoothed missing sides, averaged over ALL orders.
    """
    stats = np.asarray(stats, dtype=np.float64)
    matches, hyp_total, ref_total = stats
    b2 = beta * beta
    eps = 1e-16
    eps_score = 0.0
    avg_prec = avg_rec = 0.0
    effective = 0
    for m, h, r in zip(matches, hyp_total, ref_total):
        prec = m / h if h > 0 else eps
        rec = m / r if r > 0 else eps
        denom = b2 * prec + rec
        eps_score += (1 + b2) * prec * rec / denom if denom > 0 else eps
        if h > 0 and r > 0:
            avg_prec += prec
            avg_rec += rec
            effective += 1
    if eps_smoothing:
        return eps_score / stats.shape[1]
    if effective:
        avg_prec /= effective
        avg_rec /= effective
    if avg_prec + avg_rec:
        return (1 + b2) * avg_prec * avg_rec / (b2 * avg_prec + avg_rec)
    return 0.0


def chrf_score(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str]],
    n_char_order: int = CHRF_CHAR_ORDER,
    beta: float = 2.0,
    lowercase: bool = False,
    whitespace: bool = False,
    eps_smoothing: bool = False,
) -> float:
    """Corpus chrF between hypothesis and reference sentences, in [0, 1]
    (sacrebleu reports the same value scaled by 100).

    Example:
        >>> round(float(chrf_score(["the cat sat"], ["the cat sat"])), 4)
        1.0
        >>> bool(0.0 < chrf_score(["the cat sat"], ["the cat was sitting"]) < 1.0)
        True
    """
    if not isinstance(n_char_order, int) or n_char_order < 1:
        raise ValueError(f"`n_char_order` must be a positive int, got {n_char_order!r}")
    if beta <= 0:
        raise ValueError(f"`beta` must be positive, got {beta!r}")
    return chrf_from_stats(
        chrf_stats(preds, target, n_char_order, lowercase, whitespace), beta, eps_smoothing
    )
