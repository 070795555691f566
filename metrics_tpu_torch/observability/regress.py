"""Counterpart of ``metrics_tpu/observability/regress.py``, copied: pure
Python over the rounds' parsed JSON lines, with the same key tuples,
tolerances and verdicts.

Bench-trajectory regression gate: diff the current bench numbers against
prior ``BENCH_r*.json`` rounds and fail on drift beyond pinned tolerances.

The repo's bench rounds (``BENCH_r01.json`` .. ``BENCH_rNN.json``, one per
growth PR) were until now a log humans eyeballed; this module makes the
trajectory a first-class regression surface with two gate classes:

- **Phase latency** (``*_ms`` keys): the current value may not exceed the
  BEST prior round's value by more than ``ms_ratio`` AND ``ms_slack_ms``
  (both must be exceeded — sub-millisecond phases are timing noise, never
  gated on ratio alone). Best-of-prior is the right baseline for a
  monotonically-optimized trajectory: regressing to round-3 performance is
  a failure even if round-1 was slower still.
- **Collective counts / bytes** (integer keys from the staged-program
  counters): exact, deterministic numbers — ANY growth over the most recent
  round that carries the key fails. A shrink reports ``improved`` (re-pin
  by letting the next BENCH round record it).
- **Throughput rates** (``*_steps_per_s`` keys): higher is better, and
  smoke-mode loops are noisy, so the gate is a collapse detector rather
  than a precision pin: the current value may not fall below the BEST
  prior round's value divided by ``rate_ratio``. A fleet whose 8-shard
  ingest throughput quietly drops to a third of its recorded best has
  serialized something; ordinary wobble passes.
- **Fault counters** (``sync_retries`` / ``sync_deadline_exceeded`` /
  ``degraded_computes`` / ``quarantined_updates``): pinned at EXACTLY ZERO
  whenever the current line carries them — a clean bench run that retried,
  degraded, or quarantined anything is a fault-tolerance regression
  regardless of what prior rounds recorded. These bind on every new
  ``BENCH_r*`` round since the keys joined the default line.

Rounds predating a key (older schemas) simply don't constrain it, so the
gate tightens as the trajectory grows instead of blocking schema evolution.
``bench.py --check-trajectory`` wires this into CI.
"""
import glob
import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "COUNT_KEYS",
    "FAULT_KEYS",
    "MS_KEYS",
    "RATE_KEYS",
    "TOLERANCES",
    "check_trajectory",
    "load_rounds",
]

# phase-latency keys gated by ratio + absolute slack over the best prior
# round. The headline "value" is deliberately NOT gated: its meaning changed
# across schema generations (round 1 measured the single-chip marginal, later
# rounds the 8-device sync step), so only the unambiguous named keys bind.
MS_KEYS: Tuple[str, ...] = (
    "grouped_sync8_ms",
    "ungrouped_sync8_ms",
    "gather_coalesced_ms",
    "gather_per_leaf_ms",
    "gather_hier_ms",
    "gather_flat2d_ms",
    "sketch_sync_ms",
    "keyed_sync_ms",
    # the megafused whole-collection forward: ONE staged program per
    # host-API step with donated state slabs — its step ms is the
    # single-dispatch headline; the mixed packed-sync plane rides next
    # to it so a packing regression shows up in ms too
    "fused_step_ms",
    "mixed_sync_ms",
    "sparse_sync_ms",
    "hh_sync_ms",
    "qsketch_sync_ms",
    "service_sync_ms",
    # the deferred-sync A/B: both variants gate so a regression in either
    # the overlapped path or its fenced twin is caught (their ORDERING —
    # async strictly below fenced — is bench.py --check-async's pin)
    "async_sync8_ms",
    "fenced_sync8_ms",
    # the lag-k ring at depths 2 and 3: deeper rings replay the same
    # compiled program, so their step ms must track the depth-1 plane's
    # (monotonicity across depths is --check-async's pin, not this gate's)
    "async_lag2_ms",
    "async_lag3_ms",
    # one watermark-agreement round (report + min-exchange through the
    # background host plane + fold): the cross-rank clock must stay cheap
    # enough to ride every ingest cadence tick
    "wm_agreement_ms",
    # one full-range native query against the banked retention ladder
    # (every retained bucket finished through value_from_partials): the
    # read path must stay cheap enough to serve scrapes inline
    "retention_query_ms",
    # the pipeline health plane: worst close -> publish latency and the
    # self-metered e2e p99 over the seeded wall-clock soak — growth means
    # the publish stage (or the health plane's own bookkeeping) got slower
    "publish_lag_ms",
    "selfmeter_p99_ms",
)

# staged-collective keys gated exactly (no growth) vs the latest prior round
COUNT_KEYS: Tuple[str, ...] = (
    "collective_calls",
    "sync_bytes",
    "collective_calls_ungrouped",
    "sync_bytes_ungrouped",
    "gather_collective_calls",
    "gather_sync_bytes",
    "gather_collective_calls_per_leaf",
    "gather_sync_bytes_per_leaf",
    "hier_collective_calls",
    "hier_sync_bytes",
    "hier_dcn_calls",
    "hier_dcn_bytes",
    "hier_ici_bytes",
    "flat2d_collective_calls",
    "flat2d_world_bytes",
    "states_synced",
    "states_synced_ungrouped",
    "gather_states_synced",
    # the sketch plane: psum-only, traffic-independent payload — any growth
    # in its staged counts/bytes is a regression of the constant-memory story
    "sketch_collective_calls",
    "sketch_sync_bytes",
    "sketch_dcn_bytes",
    "sketch_gather_calls",
    "sketch_states_synced",
    # the keyed slab plane: staged counts must stay K-independent (equal to
    # the unkeyed metric's) and psum-only; any growth is a regression of the
    # segments-as-a-state-axis story
    "keyed_collective_calls",
    "keyed_sync_bytes",
    "keyed_gather_calls",
    "keyed_states_synced",
    "keyed_unkeyed_collective_calls",
    # the megafusion mixed plane: ONE packed psum per crossing with the
    # pmin/pmax riders — the staged count is pinned IDENTICAL at 6 and 14
    # members (fused_collective_calls == fused_collective_calls_14), so
    # any growth in either count or the packed bytes is a regression of
    # the membership-independent-program story
    "fused_collective_calls",
    "fused_sync_bytes",
    "fused_collective_calls_14",
    "mixed_states_synced",
    # the sparse delta-sync plane: staged bytes follow the touched-row
    # count, not the table size — any growth in its counts or bytes is a
    # regression of the bytes-proportional-to-touched-rows story
    "sparse_collective_calls",
    "sparse_sync_bytes",
    "sparse_gather_calls",
    "sparse_states_synced",
    # the heavy-hitter plane: staged counts must stay independent of the
    # simulated key count (equal to the unkeyed metric's) and psum-only,
    # and the tail's (e/width)*N certificate may never GROW on the seeded
    # gate stream — a wider bound means the tail got less exact
    "hh_collective_calls",
    "hh_sync_bytes",
    "hh_gather_calls",
    "hh_states_synced",
    "hh_unkeyed_collective_calls",
    "hh_tail_overcount_bound",
    # the quantile-sketch plane: the per-tenant p99 slab must stay
    # K-independent (staged count equal to the unkeyed scalar Quantile's),
    # psum-only, with DETERMINISTIC state bytes ((K*B + K) int32 cells) —
    # any byte growth means the grid or slab layout silently changed
    "qsketch_collective_calls",
    "qsketch_sync_bytes",
    "qsketch_gather_calls",
    "qsketch_states_synced",
    "qsketch_unkeyed_collective_calls",
    "qsketch_state_bytes",
    # the windowed serving plane: staged counts must stay window-count-
    # independent (equal to the unwindowed metric's) and psum-only; any
    # growth is a regression of the windows-as-a-state-axis story
    "service_collective_calls",
    "service_sync_bytes",
    "service_gather_calls",
    "service_states_synced",
    "service_unwindowed_collective_calls",
    # the deferred sync plane: the async dispatch must stage the identical
    # program as the fenced synchronous twin (psum-only on the sync8
    # collection); any growth is a regression of the only-the-fence-moves
    # contract
    "async_collective_calls",
    "async_sync_bytes",
    "async_gather_calls",
    "async_states_synced",
    "async_fenced_collective_calls",
    # the lag-k ring: a depth-3 ring must stage the IDENTICAL program as the
    # depth-1 plane (depth is in-flight handles, never extra collectives),
    # and the deferred epoch gather must issue exactly the synchronous
    # grouped plane's per-group gather-call count
    "async_lag_collective_calls",
    "async_lag_sync_bytes",
    "async_lag_epoch_gather_calls",
    "async_lag_epoch_sync_gather_calls",
    # the sharded fleet's merge tier: the exact-stream window counts are
    # deterministic (routing + watermark arithmetic, no timing); growth in
    # either means the scenario changed — re-pin deliberately
    "fleet_shards_merged_windows",
    "fleet_shards_published_windows",
    # the watermark-agreement plane: exchange rounds on the seeded scenario
    # are deterministic (one per report cadence tick, the in-flight guard
    # collapses none on the synchronous drive), and the sliding-window
    # publish count over the seeded stream is pure routing arithmetic —
    # growth in either means the scenario changed, re-pin deliberately
    "wm_exchange_calls",
    "slide_windows_published",
    # the tiered retention store: the seeded stream's banked-window and
    # roll-up counts are routing arithmetic (deterministic), and resident
    # bytes are bounded by the ladder shape — growth in the counts means
    # the scenario changed (re-pin deliberately), growth in the bytes
    # means retention started leaking state
    "retention_windows_banked",
    "retention_rollups",
    "retention_resident_bytes",
    # the window-lifecycle ledger: every window the seeded health soak
    # publishes must carry a complete core stage ledger — a drop means a
    # publish path stopped stamping (an observability coverage regression)
    "lifecycle_windows_stamped",
    # the ingest fast path's bucketed routing programs: the seeded coalesce
    # soak compiles one program per (sample bucket, tree structure) and the
    # bucket set is fixed by the scenario — growth means the program-cache
    # key churns and steady-state ingest recompiles
    "ingest_program_cache_misses",
)

# throughput keys (batches/sec through real serving loops): gated as
# collapse detectors — current may not fall below best prior / rate_ratio
RATE_KEYS: Tuple[str, ...] = (
    "service_ingest_steps_per_s",
    # the coalescing drain loop's throughput on the bursty stream, plus the
    # batches-per-drain factor (dimensionless but rate-shaped: a collapse
    # toward 1.0 means the drain loop stopped batching the backlog)
    "ingest_coalesced_steps_per_s",
    "ingest_coalesce_factor",
    "fleet_ingest_steps_per_s",
    "fleet_ingest_steps_per_s_1shard",
    # the heavy-hitter ingest pair: the open-world loop's throughput must
    # not collapse at EITHER key-space size (their equality — flatness in
    # the key count — is the hh scenario's headline, gated as a pairwise
    # collapse detector here)
    "hh_ingest_steps_per_s",
    "hh_ingest_steps_per_s_10k",
)

# fault counters: bound at exactly zero whenever the current line carries
# them (no baseline needed — zero IS the contract on a clean run).
# slab_dropped_samples rides here too: the bench scenarios route only
# in-range slot ids / in-window events, so a clean line that dropped a
# sample means a slab scatter silently lost data.
FAULT_KEYS: Tuple[str, ...] = (
    "sync_retries",
    "sync_deadline_exceeded",
    "degraded_computes",
    "quarantined_updates",
    "slab_dropped_samples",
    # the clean bench sparse stream touches <= sparse_capacity rows per
    # step, so a fallback to the dense plane means the sparse estimate or
    # the capacity plumbing silently broke
    "sparse_fallbacks",
    # the fleet merge tier may never lose a window on the clean bench stream
    "fleet_lost_windows",
    # the clean bench trajectory never excludes a rank from the agreed
    # watermark: a straggler exclusion on healthy ranks is a clock regression
    "wm_stragglers",
)

TOLERANCES: Dict[str, float] = {
    # both thresholds must be exceeded to fail a ms key: 2x the best prior
    # round AND at least 2 ms absolute — smoke-mode timings (2 steps) are
    # noisy, staged counts are the precise gate; ms only catches blowups.
    # (Tightened from the initial 2.5x once rounds began carrying the
    # trace-schema keys by default; the absolute slack still absorbs
    # sub-millisecond wobble.)
    "ms_ratio": 2.0,
    "ms_slack_ms": 2.0,
    # throughput keys fail only on a collapse below best prior / rate_ratio:
    # smoke throughput wobbles, a 3x drop is structural
    "rate_ratio": 3.0,
}

_ROUND_RE = re.compile(r"BENCH_r(\d+)\.json$")


def load_rounds(rounds_dir: str) -> List[Dict[str, Any]]:
    """Prior bench rounds as ``[{"n": int, "parsed": {...}}, ...]``, sorted.

    Each ``BENCH_r*.json`` carries the bench's printed JSON line under
    ``parsed`` (the rounds' recording format); files without a parseable
    ``parsed`` dict are skipped, never fatal — a gate that cannot read one
    historical round must not fail every future run.
    """
    rounds = []
    for path in sorted(glob.glob(os.path.join(rounds_dir, "BENCH_r*.json"))):
        match = _ROUND_RE.search(os.path.basename(path))
        if not match:
            continue
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        parsed = doc.get("parsed") if isinstance(doc, dict) else None
        if isinstance(parsed, dict):
            rounds.append({"n": int(match.group(1)), "parsed": parsed})
    rounds.sort(key=lambda r: r["n"])
    return rounds


def _prior_values(rounds: List[Dict[str, Any]], key: str) -> List[Tuple[int, float]]:
    out = []
    for rnd in rounds:
        value = rnd["parsed"].get(key)
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            out.append((rnd["n"], float(value)))
    return out


def check_trajectory(
    current: Dict[str, Any],
    rounds: List[Dict[str, Any]],
    tolerances: Optional[Dict[str, float]] = None,
) -> Dict[str, Any]:
    """Diff ``current`` bench numbers against prior rounds.

    Returns ``{"ok", "failures", "checks", "rounds_compared"}``; every
    gated key gets a row in ``checks`` with its baseline, the baseline's
    round, and a status in ``{"ok", "improved", "regression",
    "no-baseline", "missing"}``. Only ``"regression"`` rows land in
    ``failures``.
    """
    tol = dict(TOLERANCES)
    if tolerances:
        tol.update(tolerances)
    checks: Dict[str, Any] = {}
    failures: List[str] = []

    for key in MS_KEYS:
        priors = _prior_values(rounds, key)
        got = current.get(key)
        if not priors or not isinstance(got, (int, float)):
            checks[key] = {"status": "no-baseline" if not priors else "missing"}
            continue
        best_round, best = min(priors, key=lambda p: p[1])
        row = {"current": got, "baseline": best, "baseline_round": best_round, "kind": "ms"}
        if got > best * tol["ms_ratio"] and got - best > tol["ms_slack_ms"]:
            row["status"] = "regression"
            failures.append(
                f"{key}: {got:.4g} ms > {tol['ms_ratio']}x best prior"
                f" {best:.4g} ms (round {best_round})"
            )
        else:
            row["status"] = "ok"
        checks[key] = row

    for key in RATE_KEYS:
        priors = _prior_values(rounds, key)
        got = current.get(key)
        if not priors or not isinstance(got, (int, float)):
            checks[key] = {"status": "no-baseline" if not priors else "missing"}
            continue
        best_round, best = max(priors, key=lambda p: p[1])
        row = {"current": got, "baseline": best, "baseline_round": best_round, "kind": "rate"}
        if got < best / tol["rate_ratio"]:
            row["status"] = "regression"
            failures.append(
                f"{key}: {got:.4g}/s collapsed below best prior"
                f" {best:.4g}/s (round {best_round}) / {tol['rate_ratio']}"
            )
        else:
            row["status"] = "ok"
        checks[key] = row

    for key in COUNT_KEYS:
        priors = _prior_values(rounds, key)
        got = current.get(key)
        if not priors or not isinstance(got, (int, float)):
            checks[key] = {"status": "no-baseline" if not priors else "missing"}
            continue
        last_round, last = priors[-1]  # most recent round carrying the key
        row = {"current": got, "baseline": last, "baseline_round": last_round, "kind": "count"}
        if got > last:
            row["status"] = "regression"
            failures.append(f"{key}: {got} > pinned {last} (round {last_round})")
        elif got < last:
            row["status"] = "improved"
        else:
            row["status"] = "ok"
        checks[key] = row

    for key in FAULT_KEYS:
        got = current.get(key)
        if not isinstance(got, (int, float)) or isinstance(got, bool):
            checks[key] = {"status": "missing"}
            continue
        row = {"current": got, "baseline": 0, "kind": "fault"}
        if got != 0:
            row["status"] = "regression"
            failures.append(f"{key}: {got} != 0 (fault counters must be zero on a clean bench run)")
        else:
            row["status"] = "ok"
        checks[key] = row

    return {
        "ok": not failures,
        "failures": failures,
        "checks": checks,
        "rounds_compared": [r["n"] for r in rounds],
    }
