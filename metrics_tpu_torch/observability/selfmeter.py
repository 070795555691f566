"""Counterpart of ``metrics_tpu/observability/selfmeter.py``, copied (the JAX
package's module imports no JAX, but the port imports nothing of that
package): the same grid, quantile read, certificate and merge, so a meter
gives bit-equal results in both packages for the same observations.

Self-metering: the pipeline measured with its own quantile sketch.

The serving stack's stage latencies (``observability/lifecycle.py``) need
p50/p95/p99 reads at constant memory, across an unbounded stream, mergeable
across fleet shards — which is exactly the problem the library already
solved for metric values in ``parallel/qsketch.py``. :class:`LatencyMeter`
is that DDSketch-style grid re-hosted on numpy int64 counts (no jax import:
self-metering must work from publish worker threads without touching the
device path), with the identical layout and certificate:

- **Grid.** ``gamma = (1 + alpha) / (1 - alpha)``, ``m = ceil(log(max/min)
  / log(gamma))`` log buckets per sign, total ``B = 2 m + 3`` cells (index
  0: negative overflow, ``1..m``: negative log buckets ascending, ``m+1``:
  the zero bucket for ``|x| < min_value``, ``m+2..2m+1``: positive log
  buckets, ``2m+2``: positive overflow) — byte-for-byte the
  ``qsketch_bucket`` layout, so the self-meter inherits its proofs.
- **Certificate.** A quantile read is the selected bucket's multiplicative
  midpoint: ``|estimate - true| <= alpha * |true| + min_value`` whenever the
  rank resolves inside the certified span, ``inf`` when it resolves in an
  overflow bucket, ``nan`` on an empty meter — ``quantile_error_bound``'s
  contract verbatim (``bench.py --check-health`` pins it against exact
  per-window latencies).
- **Merge = integer addition.** Two meters over the same grid merge by
  adding counts — associative, commutative, lossless — so fleet shards'
  self-meter sketches fold into one fleet-wide view
  (:meth:`~metrics_tpu.serving.fleet.MetricFleet.health_report`) the same
  way their metric partials do.

The default grid covers ``[1 microsecond, ~2.8 hours)`` in milliseconds at
1% relative error: ``m = 1152`` log buckets per sign, ``B = 2307`` int64
cells, ~18 KB per (label, stage) meter — constant in the window count.

:data:`SELFMETER` is the process-wide registry keyed ``(label, stage)``;
``observability.reset()`` clears it alongside the counters and the span
buffers.
"""
import math
import threading
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np

__all__ = [
    "LatencyMeter",
    "SELFMETER",
    "SELFMETER_ALPHA",
    "SELFMETER_MAX_MS",
    "SELFMETER_MIN_MS",
    "SELFMETER_QUANTILES",
    "merge_meters",
]

# the default latency grid, in milliseconds: 1% relative error over
# [1 us, 1e7 ms) — wide enough for a sub-ms scatter and a stalled publish
SELFMETER_ALPHA = 0.01
SELFMETER_MIN_MS = 1e-3
SELFMETER_MAX_MS = 1e7

# the summary read every snapshot/report surfaces
SELFMETER_QUANTILES = (0.5, 0.95, 0.99)


def _grid_params(alpha: float, min_value: float, max_value: float) -> Tuple[int, float]:
    """``(m, gamma)`` — ``qsketch._grid_params`` re-derived host-side."""
    if not (0.0 < alpha < 1.0):
        raise ValueError(f"alpha must be in (0, 1), got {alpha!r}")
    if not (0.0 < min_value < max_value):
        raise ValueError(
            f"need 0 < min_value < max_value, got {min_value!r} >= {max_value!r}"
        )
    gamma = (1.0 + alpha) / (1.0 - alpha)
    m = int(math.ceil(math.log(max_value / min_value) / math.log(gamma)))
    return max(m, 1), gamma


def _bucket_values(alpha: float, min_value: float, max_value: float) -> np.ndarray:
    """The ``(B,)`` representative value per bucket — the qsketch grid's
    multiplicative midpoints (``qsketch_bucket_values``, numpy verbatim)."""
    m, gamma = _grid_params(alpha, min_value, max_value)
    rep = min_value * gamma ** np.arange(m, dtype=np.float64) * (2.0 * gamma / (gamma + 1.0))
    vals = np.zeros(2 * m + 3, dtype=np.float64)
    vals[m + 2 : 2 * m + 2] = rep
    vals[1 : m + 1] = -rep[::-1]
    top = min_value * gamma**m
    vals[0] = -top * gamma
    vals[2 * m + 2] = top * gamma
    return vals


class LatencyMeter:
    """One stage's latency distribution as a ``(B,)`` int64 count grid.

    ``observe(ms)`` is one log + one increment; ``quantile(q)`` is a cumsum
    + searchsorted over ``B`` cells (microseconds of host work, read-path
    only). ``total_ms`` rides along so summary reads report an exact sum
    next to the certified quantiles — it merges by addition like the
    counts. Not thread-safe by itself; the :data:`SELFMETER` registry
    serializes access.
    """

    __slots__ = ("alpha", "min_value", "max_value", "_m", "_gamma", "counts", "total_ms")

    def __init__(
        self,
        alpha: float = SELFMETER_ALPHA,
        min_value: float = SELFMETER_MIN_MS,
        max_value: float = SELFMETER_MAX_MS,
        counts: Optional[np.ndarray] = None,
        total_ms: float = 0.0,
    ) -> None:
        self.alpha = float(alpha)
        self.min_value = float(min_value)
        self.max_value = float(max_value)
        self._m, self._gamma = _grid_params(self.alpha, self.min_value, self.max_value)
        B = 2 * self._m + 3
        if counts is None:
            self.counts = np.zeros(B, dtype=np.int64)
        else:
            counts = np.asarray(counts, dtype=np.int64)
            if counts.shape != (B,):
                raise ValueError(
                    f"counts must have shape ({B},) for this grid, got {counts.shape}"
                )
            self.counts = counts.copy()
        self.total_ms = float(total_ms)

    # ------------------------------------------------------------- writing
    def bucket(self, ms: float) -> int:
        """The strictly monotone bucket index of ``ms`` — the host mirror of
        ``qsketch_bucket`` (NaN is the caller's bug: fail loudly, a stage
        latency is always a real number)."""
        x = float(ms)
        if math.isnan(x):
            raise ValueError("latency must not be NaN")
        m = self._m
        mag = abs(x)
        if mag < self.min_value:
            return m + 1
        if mag >= self.min_value * self._gamma**m:
            return 2 * m + 2 if x > 0 else 0
        j = min(
            max(int(math.floor(math.log(mag / self.min_value) / math.log(self._gamma))), 0),
            m - 1,
        )
        return m + 2 + j if x > 0 else m - j

    def observe(self, ms: float) -> None:
        """Fold one latency sample into the grid."""
        self.counts[self.bucket(ms)] += 1
        self.total_ms += float(ms)

    # ------------------------------------------------------------- merging
    def copy(self) -> "LatencyMeter":
        return LatencyMeter(
            self.alpha, self.min_value, self.max_value, counts=self.counts,
            total_ms=self.total_ms,
        )

    def merge_(self, other: "LatencyMeter") -> "LatencyMeter":
        """In-place merge by pure state addition (grids must match — a
        silent cross-grid add would corrupt both certificates)."""
        if (self.alpha, self.min_value, self.max_value) != (
            other.alpha, other.min_value, other.max_value,
        ):
            raise ValueError("cannot merge LatencyMeters with different grids")
        self.counts += other.counts
        self.total_ms += other.total_ms
        return self

    # ------------------------------------------------------------- reading
    @property
    def count(self) -> int:
        return int(self.counts.sum())

    @property
    def nbytes(self) -> int:
        """The constant per-meter footprint the docs quote."""
        return int(self.counts.nbytes)

    def _rank_select(self, q: float) -> Tuple[int, int]:
        """DDSketch rank rule: the first bucket whose cumulative count
        exceeds ``q * (n - 1)`` — ``qsketch._rank_select`` on numpy."""
        n = int(self.counts.sum())
        cum = np.cumsum(self.counts)
        target = float(q) * max(n - 1, 0)
        idx = int(np.clip(np.searchsorted(cum, target, side="right"), 0, self.counts.shape[0] - 1))
        return idx, n

    def quantile(self, q: float) -> float:
        """The certified estimate: selected bucket's representative value;
        ``nan`` on an empty meter."""
        idx, n = self._rank_select(q)
        if n == 0:
            return float("nan")
        return float(_bucket_values(self.alpha, self.min_value, self.max_value)[idx])

    def error_bound(self, q: float) -> float:
        """The data-dependent certificate: ``alpha`` when the rank resolves
        in a log/zero bucket (then ``|est - true| <= alpha * |true| +
        min_value``), ``inf`` in an overflow bucket, ``nan`` empty."""
        idx, n = self._rank_select(q)
        if n == 0:
            return float("nan")
        if idx == 0 or idx == 2 * self._m + 2:
            return float("inf")
        return self.alpha

    def summary(self) -> Dict[str, float]:
        """The snapshot/report row: count, exact sum, the three standard
        quantiles, and the WORST certificate across them."""
        out: Dict[str, float] = {
            "count": self.count,
            "sum_ms": float(self.total_ms),
        }
        bound = float("nan")
        for q in SELFMETER_QUANTILES:
            out[f"p{int(q * 100)}_ms"] = self.quantile(q)
            b = self.error_bound(q)
            if math.isnan(bound) or (not math.isnan(b) and b > bound):
                bound = b
        out["error_bound"] = bound
        return out


def merge_meters(meters: Iterable[LatencyMeter]) -> Optional[LatencyMeter]:
    """Fold an iterable of meters into one fresh meter by count addition
    (None when empty) — the fleet ``health_report`` fold, reusable from
    gates that pin the fold against the report."""
    fold: Optional[LatencyMeter] = None
    for meter in meters:
        if fold is None:
            fold = meter.copy()
        else:
            fold.merge_(meter)
    return fold


class _SelfMeterRegistry:
    """Process-wide ``(label, stage) -> LatencyMeter`` registry, one lock.

    Callers gate on ``lifecycle.LEDGER.enabled`` — the registry itself is
    always writable so tests can drive it directly."""

    __slots__ = ("_lock", "_meters")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._meters: Dict[Tuple[str, str], LatencyMeter] = {}

    def observe(self, label: str, stage: str, ms: float) -> Dict[str, float]:
        """Fold one stage latency and return the meter's refreshed summary
        (what the counters' ``selfmeter`` gauge block stores)."""
        with self._lock:
            meter = self._meters.get((label, stage))
            if meter is None:
                meter = self._meters[(label, stage)] = LatencyMeter()
            meter.observe(ms)
            return meter.summary()

    def meters(self, label: Optional[str] = None) -> Dict[Any, LatencyMeter]:
        """COPIES of the registered meters — keyed by stage when ``label``
        is given, by ``(label, stage)`` otherwise — safe to merge/mutate."""
        with self._lock:
            if label is None:
                return {key: meter.copy() for key, meter in self._meters.items()}
            return {
                stage: meter.copy()
                for (lab, stage), meter in self._meters.items()
                if lab == label
            }

    def labels(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(sorted({label for label, _ in self._meters}))

    def clear(self) -> None:
        with self._lock:
            self._meters.clear()


SELFMETER = _SelfMeterRegistry()
