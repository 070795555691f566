"""Clustering metrics over a streamed contingency matrix.

Counterpart of ``metrics_tpu/functional/clustering.py``. Every metric here is
a closed form of the ``(num_clusters, num_classes)`` contingency matrix, which
streams like a confusion matrix. Semantics match sklearn (``rand_score``,
``adjusted_rand_score``, ``mutual_info_score``, ``normalized_mutual_info_score``,
``adjusted_mutual_info_score``, ``homogeneity/completeness/v_measure``,
``fowlkes_mallows_score``).

Two things differ from the JAX package:

* the contingency is one int64 ``torch.bincount`` of ``pred * num_classes +
  target`` with a spare bin for out-of-range pairs, dropped after the count
  (the JAX package's one-hot matmul drops them too), so the counts are exact
  with no matmul and no TF32 question;
* every closed form runs in float64 from the int64 counts and is rounded once
  to float32. The JAX package works in float32 unless ``jax_enable_x64`` is
  set: its pair counts ``C(n, 2)`` stop being exact past n = 5,793 samples and
  its expected mutual information drifts on large epochs.

The expected mutual information (AMI's chance term) sums, for every cell
``(i, j)`` and every count ``k`` in the cell's feasible range, the
hypergeometric summand in float64 log space. ``lgamma`` of the integer
arguments comes from one float64 table over ``[0, N + 1]``, as sklearn's loop
takes it from ``gammaln``. Only each cell's feasible range is swept, cut further
to the counts whose hypergeometric probability can exceed ``exp(-800)`` by the
Chernoff bound of the binomial that dominates it (Hoeffding 1963, Thm. 4), where
some cell's range is long enough to pay for the bisection that finds it; the
probability of every count outside underflows to an exact float64 zero, so
the sum is unchanged. The sweep walks the flat (cell, k) index in chunks of
:data:`EMI_CHUNK_TERMS`, which bounds its device memory.
"""
import math
from typing import Tuple

import torch
from torch import Tensor

# terms per EMI chunk: about 16 int64 / float64 temporaries of this length (~1.1 GB)
EMI_CHUNK_TERMS = 1 << 23
# a hypergeometric probability below exp(-800) underflows to 0.0 in float64
_EMI_LOG_CUTOFF = 800.0
_EMI_BISECTIONS = 48
# cells whose feasible ranges all hold fewer counts than this are swept whole: the window's bisection
# (48 passes over every cell) would cost more than the terms it saves
_EMI_WINDOW_MIN_RANGE = 256


def _contingency(preds: Tensor, target: Tensor, num_clusters: int, num_classes: int) -> Tensor:
    """``(num_clusters, num_classes)`` int64 pair-count matrix, one ``bincount``.

    Labels outside ``[0, num_clusters)`` / ``[0, num_classes)`` land in a spare
    bin and are silently dropped from the counts, as the JAX package's one-hot
    contraction drops them.
    """
    if preds.ndim != 1 or target.ndim != 1 or preds.shape != target.shape:
        raise ValueError(
            f"Expected 1-D label arrays of identical shape, got {tuple(preds.shape)} and {tuple(target.shape)}"
        )
    p = preds.to(torch.int64)
    t = target.to(torch.int64)
    spare = num_clusters * num_classes
    inside = (p >= 0) & (p < num_clusters) & (t >= 0) & (t < num_classes)
    flat = torch.where(inside, p * num_classes + t, torch.full_like(p, spare))
    return torch.bincount(flat, minlength=spare + 1)[:spare].view(num_clusters, num_classes)


def _f32(x: Tensor) -> Tensor:
    return x.to(torch.float32)


def _comb2(x: Tensor) -> Tensor:
    """``C(x, 2)`` in float64: exact while ``x (x - 1) <= 2**53`` (x ~ 9.5e7)."""
    x = x.to(torch.float64)
    return x * (x - 1.0) / 2.0


def _pair_counts(cont: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """(sum C(nij,2), sum C(ai,2), sum C(bj,2), C(n,2)) from a contingency, float64."""
    a = cont.sum(dim=1)
    b = cont.sum(dim=0)
    n = cont.sum()
    return _comb2(cont).sum(), _comb2(a).sum(), _comb2(b).sum(), _comb2(n)


def _safe_div(num: Tensor, den: Tensor, ok: Tensor, fallback: float) -> Tensor:
    """``num / den`` where ``ok``, else ``fallback``."""
    return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)), torch.full_like(num, fallback))


def _rand64(cont: Tensor) -> Tensor:
    nij2, a2, b2, n2 = _pair_counts(cont)
    # agreements: concordant pairs = n2 + 2*nij2 - a2 - b2
    return _safe_div(n2 + 2.0 * nij2 - a2 - b2, n2, n2 > 0, 1.0)


def _rand_compute(cont: Tensor) -> Tensor:
    return _f32(_rand64(cont))


def _adjusted_rand_compute(cont: Tensor) -> Tensor:
    nij2, a2, b2, n2 = _pair_counts(cont)
    expected = _safe_div(a2 * b2, n2, n2 > 0, 0.0)
    max_index = (a2 + b2) / 2.0
    denom = max_index - expected
    # degenerate (single cluster both sides, or n<2): sklearn returns 1.0
    return _f32(_safe_div(nij2 - expected, denom, torch.abs(denom) > 1e-12, 1.0))


def _entropy(counts: Tensor) -> Tensor:
    """Shannon entropy (nats) of a 1-D count vector, float64."""
    counts = counts.to(torch.float64)
    p = counts / torch.clamp(counts.sum(), min=1.0)
    return -torch.sum(torch.where(p > 0, p * torch.log(torch.where(p > 0, p, torch.ones_like(p))), torch.zeros_like(p)))


def _mutual_info64(cont: Tensor) -> Tensor:
    cont = cont.to(torch.float64)
    n = torch.clamp(cont.sum(), min=1.0)
    a = cont.sum(dim=1, keepdim=True)
    b = cont.sum(dim=0, keepdim=True)
    pos = cont > 0
    log_term = torch.log(torch.where(pos, n * cont / torch.clamp(a * b, min=1.0), torch.ones_like(cont)))
    return torch.sum(torch.where(pos, cont / n * log_term, torch.zeros_like(cont)))


def _mutual_info_compute(cont: Tensor) -> Tensor:
    return _f32(_mutual_info64(cont))


def _marginal_entropies(cont: Tensor) -> Tuple[Tensor, Tensor]:
    """(H(pred clusters), H(true classes)), float64."""
    return _entropy(cont.sum(dim=1)), _entropy(cont.sum(dim=0))


def _homogeneity_completeness64(cont: Tensor) -> Tuple[Tensor, Tensor]:
    mi = _mutual_info64(cont)
    h_pred, h_true = _marginal_entropies(cont)
    return _safe_div(mi, h_true, h_true > 0, 1.0), _safe_div(mi, h_pred, h_pred > 0, 1.0)


def _homogeneity_completeness(cont: Tensor) -> Tuple[Tensor, Tensor]:
    hom, com = _homogeneity_completeness64(cont)
    return _f32(hom), _f32(com)


def _v_measure_compute(cont: Tensor, beta: float = 1.0) -> Tensor:
    hom, com = _homogeneity_completeness64(cont)
    denom = beta * hom + com
    return _f32(_safe_div((1.0 + beta) * hom * com, denom, denom > 0, 0.0))


def _generalized_average(h_pred: Tensor, h_true: Tensor, average_method: str) -> Tensor:
    """sklearn's ``_generalized_average``: the NMI/AMI normalizer."""
    if average_method == "arithmetic":
        return (h_pred + h_true) / 2.0
    if average_method == "geometric":
        return torch.sqrt(h_pred * h_true)
    if average_method == "min":
        return torch.minimum(h_pred, h_true)
    if average_method == "max":
        return torch.maximum(h_pred, h_true)
    raise ValueError(
        f"average_method must be 'arithmetic', 'geometric', 'min' or 'max', got {average_method!r}"
    )


_EPS_TRIVIAL = 1e-12


def _normalized_mutual_info_compute(cont: Tensor, average_method: str = "arithmetic") -> Tensor:
    mi = _mutual_info64(cont)
    h_pred, h_true = _marginal_entropies(cont)
    norm = _generalized_average(h_pred, h_true, average_method)
    # sklearn returns 1.0 only when BOTH labelings are trivial (both entropies
    # 0); if just the normalizer vanishes the score is 0.0
    both_trivial = (h_pred <= _EPS_TRIVIAL) & (h_true <= _EPS_TRIVIAL)
    degenerate = torch.where(both_trivial, torch.ones_like(mi), torch.zeros_like(mi))
    ok = norm > _EPS_TRIVIAL
    return _f32(torch.where(ok, mi / torch.where(ok, norm, torch.ones_like(norm)), degenerate))


def _chernoff_window(s: Tensor, p: Tensor, mean: Tensor, upper: bool) -> Tensor:
    """The real ``k`` beyond which ``s D(k / s || p) > _EMI_LOG_CUTOFF``, above (``upper``) or
    below the mean, by bisection; ``D`` is the Bernoulli relative entropy."""
    lo = mean.clone()
    hi = s.clone() if upper else torch.zeros_like(s)
    for _ in range(_EMI_BISECTIONS):
        mid = (lo + hi) / 2.0
        x = mid / s
        div = torch.xlogy(x, x / p) + torch.xlogy(1.0 - x, (1.0 - x) / (1.0 - p))
        inside = s * div <= _EMI_LOG_CUTOFF
        lo = torch.where(inside, mid, lo)
        hi = torch.where(inside, hi, mid)
    return hi


def _expected_mutual_info(cont: Tensor, n_samples: int, chunk_terms: int = EMI_CHUNK_TERMS) -> Tensor:
    """E[MI] under the permutation model (sklearn's AMI chance term), float64.

    For every cell ``(i, j)`` with marginals ``a_i``, ``b_j`` and every count
    ``k`` in ``[max(1, a_i + b_j - N), min(a_i, b_j)]``, the summand
    ``k / N * log(N k / (a_i b_j)) * P_hyper(k)``, ``P_hyper`` in log space from
    a float64 ``lgamma`` table. ``n_samples`` is the epoch's count (the one
    host read of the caller).
    """
    dev = cont.device
    zero = torch.zeros((), dtype=torch.float64, device=dev)
    n = int(n_samples)
    if n <= 0:
        return zero
    a_all = cont.sum(dim=1)
    b_all = cont.sum(dim=0)
    a = a_all[a_all > 0].to(torch.float64)  # an empty row or column has no feasible k
    b = b_all[b_all > 0].to(torch.float64)
    nb = b.shape[0]
    nf = float(n)
    lg = torch.lgamma(torch.arange(n + 2, dtype=torch.float64, device=dev))  # lg[m] = lgamma(m)

    aa = a[:, None].expand(-1, nb).reshape(-1)
    bb = b[None, :].expand(a.shape[0], -1).reshape(-1)
    lo = torch.clamp(aa + bb - nf, min=1.0)
    hi = torch.minimum(aa, bb)
    if hi.numel() and float((hi - lo).max()) >= _EMI_WINDOW_MIN_RANGE:
        # the Chernoff window: sample size s = min(a, b) drawn against p = max(a, b) / N
        s = hi
        p = torch.maximum(aa, bb) / nf
        mean = aa * bb / nf
        cut = (p > 0) & (p < 1)
        p_safe = torch.where(cut, p, torch.full_like(p, 0.5))
        lo = torch.where(cut, torch.maximum(lo, torch.floor(_chernoff_window(s, p_safe, mean, False))), lo)
        hi = torch.where(cut, torch.minimum(hi, torch.ceil(_chernoff_window(s, p_safe, mean, True))), hi)
    count = torch.clamp(hi - lo + 1.0, min=0.0).to(torch.int64)
    ends = torch.cumsum(count, 0)
    total = int(ends[-1]) if ends.numel() else 0
    if total == 0:
        return zero
    starts = ends - count
    lo_i = lo.to(torch.int64)
    # cell-constant part of log P_hyper
    ai, bi = aa.to(torch.int64), bb.to(torch.int64)
    base = lg[ai + 1] + lg[bi + 1] + lg[n - ai + 1] + lg[n - bi + 1] - lg[n + 1]
    log_ab = torch.log(aa * bb)
    log_n = math.log(nf)
    acc = zero
    for t0 in range(0, total, chunk_terms):
        g = torch.arange(t0, min(t0 + chunk_terms, total), device=dev)
        cell = torch.searchsorted(ends, g, right=True)
        k = lo_i[cell] + (g - starts[cell])
        a_c, b_c = ai[cell], bi[cell]
        log_p = base[cell] - (lg[k + 1] + lg[a_c - k + 1] + lg[b_c - k + 1] + lg[n - a_c - b_c + k + 1])
        kf = k.to(torch.float64)
        term = (kf / nf) * (torch.log(kf) + log_n - log_ab[cell]) * torch.exp(log_p)
        acc = acc + term.sum()
    return acc


def _adjusted_mutual_info_compute(cont: Tensor, n_samples: int, average_method: str = "arithmetic") -> Tensor:
    mi = _mutual_info64(cont)
    h_pred, h_true = _marginal_entropies(cont)
    emi = _expected_mutual_info(cont, n_samples)
    norm = _generalized_average(h_pred, h_true, average_method)
    denom = norm - emi
    # sklearn: degenerate denominators take the sign-preserving tiny value
    eps = float(torch.finfo(torch.float64).eps)
    denom = torch.where(denom < 0, torch.clamp(denom, max=-eps), torch.clamp(denom, min=eps))
    both_trivial = (h_pred <= _EPS_TRIVIAL) & (h_true <= _EPS_TRIVIAL)
    return _f32(torch.where(both_trivial, torch.ones_like(mi), (mi - emi) / denom))


def _fowlkes_mallows_compute(cont: Tensor) -> Tensor:
    nij2, a2, b2, _ = _pair_counts(cont)
    denom = torch.sqrt(a2) * torch.sqrt(b2)
    return _f32(_safe_div(nij2, denom, denom > 0, 0.0))


def rand_score(preds: Tensor, target: Tensor, num_clusters: int, num_classes: int) -> Tensor:
    """Rand index between predicted cluster labels and true labels
    (``sklearn.metrics.rand_score``).

    Example:
        >>> import torch
        >>> float(rand_score(torch.tensor([0, 0, 1, 1]), torch.tensor([1, 1, 0, 0]),
        ...                  num_clusters=2, num_classes=2))
        1.0
    """
    return _rand_compute(_contingency(preds, target, num_clusters, num_classes))


def adjusted_rand_score(preds: Tensor, target: Tensor, num_clusters: int, num_classes: int) -> Tensor:
    """Chance-adjusted Rand index (``sklearn.metrics.adjusted_rand_score``).

    Example:
        >>> import torch
        >>> float(adjusted_rand_score(torch.tensor([0, 0, 1, 1]), torch.tensor([0, 0, 1, 1]),
        ...                           num_clusters=2, num_classes=2))
        1.0
    """
    return _adjusted_rand_compute(_contingency(preds, target, num_clusters, num_classes))


def mutual_info_score(preds: Tensor, target: Tensor, num_clusters: int, num_classes: int) -> Tensor:
    """Mutual information (nats) between two labelings (``sklearn.metrics.mutual_info_score``).

    Example:
        >>> import torch
        >>> round(float(mutual_info_score(torch.tensor([0, 0, 1, 1]), torch.tensor([0, 0, 1, 1]),
        ...                               num_clusters=2, num_classes=2)), 4)
        0.6931
    """
    return _mutual_info_compute(_contingency(preds, target, num_clusters, num_classes))


def normalized_mutual_info_score(
    preds: Tensor, target: Tensor, num_clusters: int, num_classes: int,
    average_method: str = "arithmetic",
) -> Tensor:
    """NMI with arithmetic/geometric/min/max normalization
    (``sklearn.metrics.normalized_mutual_info_score``).

    Example:
        >>> import torch
        >>> float(normalized_mutual_info_score(torch.tensor([0, 0, 1, 1]), torch.tensor([1, 1, 0, 0]),
        ...                                    num_clusters=2, num_classes=2))
        1.0
    """
    return _normalized_mutual_info_compute(_contingency(preds, target, num_clusters, num_classes), average_method)


def adjusted_mutual_info_score(
    preds: Tensor, target: Tensor, num_clusters: int, num_classes: int,
    average_method: str = "arithmetic",
) -> Tensor:
    """Adjusted mutual information (``sklearn.metrics.adjusted_mutual_info_score``).

    The epoch length comes from the contingency total (out-of-range labels
    drop from the counts, and the EMI's N must agree with the marginals), one
    host read.

    Example:
        >>> import torch
        >>> float(adjusted_mutual_info_score(torch.tensor([0, 0, 1, 1]),
        ...     torch.tensor([1, 1, 0, 0]), num_clusters=2, num_classes=2))
        1.0
    """
    cont = _contingency(preds, target, num_clusters, num_classes)
    return _adjusted_mutual_info_compute(cont, int(cont.sum()), average_method)


def homogeneity_score(preds: Tensor, target: Tensor, num_clusters: int, num_classes: int) -> Tensor:
    """Each cluster contains only one class (``sklearn.metrics.homogeneity_score``).

    Example:
        >>> import torch
        >>> float(homogeneity_score(torch.tensor([0, 1, 2, 3]), torch.tensor([0, 0, 1, 1]),
        ...                         num_clusters=4, num_classes=2))
        1.0
    """
    return _homogeneity_completeness(_contingency(preds, target, num_clusters, num_classes))[0]


def completeness_score(preds: Tensor, target: Tensor, num_clusters: int, num_classes: int) -> Tensor:
    """Each class lands in one cluster (``sklearn.metrics.completeness_score``).

    Example:
        >>> import torch
        >>> float(completeness_score(torch.tensor([0, 0, 0, 0]), torch.tensor([0, 0, 1, 1]),
        ...                          num_clusters=1, num_classes=2))
        1.0
    """
    return _homogeneity_completeness(_contingency(preds, target, num_clusters, num_classes))[1]


def v_measure_score(
    preds: Tensor, target: Tensor, num_clusters: int, num_classes: int, beta: float = 1.0
) -> Tensor:
    """Harmonic mean of homogeneity and completeness (``sklearn.metrics.v_measure_score``).

    Example:
        >>> import torch
        >>> float(v_measure_score(torch.tensor([0, 0, 1, 1]), torch.tensor([0, 0, 1, 1]),
        ...                       num_clusters=2, num_classes=2))
        1.0
    """
    return _v_measure_compute(_contingency(preds, target, num_clusters, num_classes), beta)


def fowlkes_mallows_score(preds: Tensor, target: Tensor, num_clusters: int, num_classes: int) -> Tensor:
    """Geometric mean of pairwise precision and recall (``sklearn.metrics.fowlkes_mallows_score``).

    Example:
        >>> import torch
        >>> round(float(fowlkes_mallows_score(torch.tensor([0, 0, 1, 1]), torch.tensor([0, 0, 1, 1]),
        ...                                   num_clusters=2, num_classes=2)), 4)
        1.0
    """
    return _fowlkes_mallows_compute(_contingency(preds, target, num_clusters, num_classes))
