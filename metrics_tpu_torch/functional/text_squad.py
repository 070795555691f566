"""SQuAD exact-match / F1 (Rajpurkar et al. 2016).

Counterpart of ``metrics_tpu/functional/text_squad.py``, host work copied as
it is. Host-side text metric using the official evaluation
normalization: lowercase, strip punctuation and articles (a/an/the),
whitespace-split; EM is string equality of the normalized answers, F1 the
token-multiset overlap. With several reference answers per question the best
score over the references counts (the official convention).
"""
import re
import string
from collections import Counter
from typing import Dict, List, Sequence, Tuple, Union

_ARTICLES = re.compile(r"\b(a|an|the)\b")
_PUNCT = set(string.punctuation)


def _normalize_answer(text: str) -> List[str]:
    text = "".join(ch for ch in text.lower() if ch not in _PUNCT)
    text = _ARTICLES.sub(" ", text)
    return text.split()


def _pair_em_f1(pred: str, answers: Sequence[str]) -> Tuple[float, float]:
    p_tok = _normalize_answer(pred)
    best_em = best_f1 = 0.0
    for ans in answers:
        a_tok = _normalize_answer(ans)
        best_em = max(best_em, float(p_tok == a_tok))
        # v1.1 script semantics: zero token overlap -> F1 0, including pairs
        # that normalize to nothing (EM can still be 100 there)
        overlap = sum((Counter(p_tok) & Counter(a_tok)).values())
        if overlap == 0:
            continue
        precision = overlap / len(p_tok)
        recall = overlap / len(a_tok)
        best_f1 = max(best_f1, 2 * precision * recall / (precision + recall))
    return best_em, best_f1


def _squad_batch_sums(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str], Sequence[Sequence[str]]],
) -> Tuple[float, float, int]:
    """(EM sum, F1 sum, question count) — shared by the functional one-shot
    and the streaming module."""
    if isinstance(preds, str):
        preds = [preds]
        # a single question: a FLAT string sequence can only mean its
        # acceptable reference answers; an already-nested sequence is the
        # 1-question batch form and needs no wrapping
        if not isinstance(target, str) and all(isinstance(x, str) for x in target):
            target = [target]
    if isinstance(target, str):
        target = [target]
    if len(preds) != len(target):
        raise ValueError("`preds` and `target` must have the same number of questions")
    em_sum = f1_sum = 0.0
    for p, refs in zip(preds, target):
        answers = [refs] if isinstance(refs, str) else list(refs)
        em, f1 = _pair_em_f1(p, answers)
        em_sum += em
        f1_sum += f1
    return em_sum, f1_sum, len(preds)


def squad(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str], Sequence[Sequence[str]]],
) -> Dict[str, float]:
    """Mean exact-match and F1 over (prediction, reference answers) pairs.

    ``target`` entries may be a single reference string or a sequence of
    acceptable reference answers (best score counts). Returns percentages
    in [0, 100] with official v1.1 script semantics (in particular, a pair
    whose normalized answers are both empty scores EM 100 but F1 0).

    Example:
        >>> out = squad(["the cat"], [["The cat!", "a dog"]])
        >>> (out["exact_match"], out["f1"])
        (100.0, 100.0)
    """
    em_sum, f1_sum, n = _squad_batch_sums(preds, target)
    if n == 0:
        return {"exact_match": 0.0, "f1": 0.0}
    return {"exact_match": 100.0 * em_sum / n, "f1": 100.0 * f1_sum / n}
