"""ROUGE score (rouge-1 / rouge-2 / rouge-L).

Counterpart of ``metrics_tpu/functional/text_rouge.py``. Tokenization and the
per-pair n-gram counting are host work; the LCS of a batch runs on the device
once the batch's DP exceeds :data:`_DEVICE_LCS_MIN_CELLS` cells. The accumulated form streams per-pair
precision/recall/F1 sums, so the module metric is O(1) memory and the
aggregate is the MEAN of per-sentence scores (the rouge_score convention).

Tokenization follows the standard rouge_score default: lowercase,
non-alphanumeric characters become separators.
"""
import re
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.functional.text import lcs_length_padded
from metrics_tpu_torch.utils.device import resolve_device

_TOKEN_RE = re.compile(r"[^a-z0-9]+")

ROUGE_KEYS = ("rouge1", "rouge2", "rougeL")


def _rouge_tokens(text: str) -> List[str]:
    return [t for t in _TOKEN_RE.split(text.lower()) if t]


def _ngrams(tokens: List[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def _prf(overlap: int, pred_total: int, target_total: int) -> Tuple[float, float, float]:
    precision = overlap / pred_total if pred_total else 0.0
    recall = overlap / target_total if target_total else 0.0
    f1 = 2 * precision * recall / (precision + recall) if precision + recall else 0.0
    return precision, recall, f1


def _lcs_len(a: List[str], b: List[str]) -> int:
    """Host DP oracle (small pairs; the device kernel covers corpus scale)."""
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for tok in a:
        cur = [0] * (len(b) + 1)
        for j, other in enumerate(b, 1):
            cur[j] = prev[j - 1] + 1 if tok == other else max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


# batches whose total DP cell count clears this run the LCS on the device (the
# batched row DP, functional/text.py lcs_length_padded); below it the host loop
# wins, a few launches a row against a few microseconds of host DP a pair
_DEVICE_LCS_MIN_CELLS = 50_000


def _lcs_lens(
    pairs: List[Tuple[List[str], List[str]]], device: Optional[Union[str, torch.device]] = None
) -> List[int]:
    """LCS length per tokenized pair — host DP for small batches, the
    batched DP on ``device`` (``None``: ``cuda``) at corpus scale, with one
    read of the lengths back to the host."""
    cells = sum(len(a) * len(b) for a, b in pairs)
    if cells < _DEVICE_LCS_MIN_CELLS:
        return [_lcs_len(a, b) for a, b in pairs]

    device = resolve_device(device)
    batch = len(pairs)
    n = max(max((len(a) for a, _ in pairs), default=0), 1)
    m = max(max((len(b) for _, b in pairs), default=0), 1)
    pred_ids = np.zeros((batch, n), dtype=np.int32)
    target_ids = np.full((batch, m), -1, dtype=np.int32)  # distinct pads never match
    for k, (a, b) in enumerate(pairs):
        vocab: Dict[str, int] = {}
        pred_ids[k, : len(a)] = [vocab.setdefault(t, len(vocab) + 1) for t in a]
        target_ids[k, : len(b)] = [vocab.setdefault(t, len(vocab) + 1) for t in b]
    out = lcs_length_padded(
        torch.from_numpy(pred_ids).to(device),
        torch.from_numpy(target_ids).to(device),
        torch.tensor([len(a) for a, _ in pairs], dtype=torch.int32).to(device),
        torch.tensor([len(b) for _, b in pairs], dtype=torch.int32).to(device),
    )
    return out.tolist()


def _check_rouge_keys(rouge_keys: Sequence[str]) -> Tuple[str, ...]:
    keys = tuple(rouge_keys)
    for key in keys:
        if key == "rougeL" or (key.startswith("rouge") and key[5:].isdigit() and int(key[5:]) >= 1):
            continue
        raise ValueError(f"rouge key must be 'rougeN' (N >= 1) or 'rougeL', got {key!r}")
    return keys


def _batch_sums(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str]],
    keys: Sequence[str],
    device: Optional[Union[str, torch.device]] = None,
) -> Tuple[Dict[str, List[float]], int]:
    """Per-key [P, R, F] sums over the pairs plus the pair count (shared by
    the functional one-shot and the streaming module); ``device`` runs a
    large batch's LCS."""
    if isinstance(preds, str):
        preds = [preds]
    if isinstance(target, str):
        target = [target]
    if len(preds) != len(target):
        raise ValueError("`preds` and `target` must have the same number of sentences")
    sums = {k: [0.0, 0.0, 0.0] for k in keys}
    tok_pairs = [(_rouge_tokens(p), _rouge_tokens(t)) for p, t in zip(preds, target)]
    ngram_keys = [k for k in keys if k != "rougeL"]
    for p_tok, t_tok in tok_pairs:
        for k in ngram_keys:
            n = int(k[5:])
            p_ngrams, t_ngrams = _ngrams(p_tok, n), _ngrams(t_tok, n)
            overlap = sum((p_ngrams & t_ngrams).values())
            prf = _prf(overlap, sum(p_ngrams.values()), sum(t_ngrams.values()))
            for i in range(3):
                sums[k][i] += prf[i]
    if "rougeL" in keys:
        # all pairs' LCS in one pass: the batched device DP at corpus scale
        for (p_tok, t_tok), lcs in zip(tok_pairs, _lcs_lens(tok_pairs, device)):
            prf = _prf(lcs, len(p_tok), len(t_tok))
            for i in range(3):
                sums["rougeL"][i] += prf[i]
    return sums, len(preds)


def rouge_score(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str]],
    rouge_keys: Sequence[str] = ROUGE_KEYS,
    device: Optional[Union[str, torch.device]] = None,
) -> Dict[str, float]:
    """Mean per-sentence ROUGE precision/recall/F1 over the pairs.

    ``device`` runs the ROUGE-L LCS of a batch above 50,000 DP cells
    (``None``: ``cuda``); smaller batches never touch it.

    Returns ``{f"{key}_precision" | f"{key}_recall" | f"{key}_fmeasure": value}``.

    Example:
        >>> out = rouge_score("the cat sat on the mat", "the cat was on the mat")
        >>> round(out["rouge1_fmeasure"], 4)
        0.8333
        >>> round(out["rougeL_fmeasure"], 4)
        0.8333
    """
    keys = _check_rouge_keys(rouge_keys)
    sums, n = _batch_sums(preds, target, keys, device)
    if n == 0:
        return {f"{k}_{stat}": 0.0 for k in keys for stat in ("precision", "recall", "fmeasure")}
    return {
        f"{k}_{stat}": sums[k][i] / n
        for k in keys
        for i, stat in enumerate(("precision", "recall", "fmeasure"))
    }
