"""Debug-mode check that the ranks agree on their synced computes.

Counterpart of ``metrics_tpu/utils/debug.py``. A rank that calls a synced
``compute()`` a different number of times than its peers pairs its
collectives with the wrong ones of the others, and in the end deadlocks.
With the check enabled, every synced ``compute()`` first gathers the metric's
sync sequence number (one small ``all_gather``, or the metric's own
``dist_sync_fn``) and raises when the ranks disagree, turning a silent
mispairing into an immediate error. Off by default: it costs one extra small
collective a synced compute, and every rank must enable it the same way. The
deferred per-step sync (``sync_lag``) skips it, as the JAX package does.
"""

_SYNC_COUNT_CHECK = False


def enable_sync_count_check(value: bool = True) -> bool:
    """Toggle the cross-rank sync-sequence check; returns the previous value.

    Must be enabled (or disabled) the same way on every process: the check
    itself is a collective.
    """
    global _SYNC_COUNT_CHECK
    old = _SYNC_COUNT_CHECK
    _SYNC_COUNT_CHECK = bool(value)
    return old


def sync_count_check_enabled() -> bool:
    return _SYNC_COUNT_CHECK
