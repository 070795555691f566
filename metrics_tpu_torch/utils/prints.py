"""Rank-zero gated warnings/logging.

Counterpart of ``metrics_tpu/utils/prints.py``. The rank comes from the
``LOCAL_RANK`` / ``SLURM_PROCID`` / ``RANK`` environment variables, else from
an initialized ``torch.distributed`` group, else 0.
"""
import logging
import os
import warnings
from functools import wraps
from typing import Any, Callable

log = logging.getLogger("metrics_tpu_torch")


def _current_rank() -> int:
    for env_var in ("LOCAL_RANK", "SLURM_PROCID", "RANK"):
        if env_var in os.environ:
            return int(os.environ[env_var])
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def rank_zero_only(fn: Callable) -> Callable:
    """Decorator: run ``fn`` only on rank 0 (the rank is resolved at call time)."""

    @wraps(fn)
    def wrapped_fn(*args: Any, **kwargs: Any) -> Any:
        rank = getattr(rank_zero_only, "rank", None)
        if rank is None:
            rank = _current_rank()
        if rank == 0:
            return fn(*args, **kwargs)
        return None

    return wrapped_fn


def _warn(*args: Any, **kwargs: Any) -> None:
    warnings.warn(*args, **kwargs)


def _info(*args: Any, **kwargs: Any) -> None:
    log.info(*args, **kwargs)


def _debug(*args: Any, **kwargs: Any) -> None:
    log.debug(*args, **kwargs)


rank_zero_debug = rank_zero_only(_debug)
rank_zero_info = rank_zero_only(_info)
rank_zero_warn = rank_zero_only(_warn)

# messages already emitted through rank_zero_warn_once (process lifetime)
_WARN_ONCE_SEEN: set = set()


def rank_zero_warn_once(message: str, *args: Any, **kwargs: Any) -> None:
    """``rank_zero_warn`` deduplicated by message text for the process lifetime."""
    if message in _WARN_ONCE_SEEN:
        return
    _WARN_ONCE_SEEN.add(message)
    rank_zero_warn(message, *args, **kwargs)
