"""Timing helpers: milliseconds a call, with the card's queue drained.

Counterpart of ``metrics_tpu/utils/profiling.py``. Where the JAX package
blocks on the last output (``jax.block_until_ready``), these synchronize the
current CUDA stream of every device the output lives on; an output held on
the CPU needs no wait. For deep traces use ``observability.start_trace``.
"""
import time
from typing import Any, Callable, Dict

import torch

from metrics_tpu_torch.observability.devtime import _tensors


def _block_until_ready(value: Any) -> None:
    for device in {t.device for t in _tensors(value) if t.is_cuda}:
        torch.cuda.current_stream(device).synchronize()


def time_fn(fn: Callable, *args: Any, iters: int = 50, warmup: int = 5, **kwargs: Any) -> float:
    """Wall-clock ms per call of ``fn(*args, **kwargs)``, device-synchronized:
    ``warmup`` calls (kernel builds, caches), a wait on the last output, then
    ``iters`` timed calls ending with a wait on the last output."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    _block_until_ready(out)
    start = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kwargs)
    _block_until_ready(out)
    return (time.perf_counter() - start) / iters * 1e3


def profile_metric(metric: Any, *args: Any, iters: int = 50, **kwargs: Any) -> Dict[str, float]:
    """ms a call of a metric's pure ``update`` and ``compute`` on the given batch.

    Uses the pure view, so repeated updates see the same fresh state and the
    caller's metric is left as it is.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Accuracy
        >>> times = profile_metric(Accuracy(device="cpu"), torch.tensor([1, 0]), torch.tensor([1, 1]), iters=2)
        >>> sorted(times)
        ['compute_ms', 'update_ms']
    """
    pure = metric.pure()
    init = pure.init()
    update_ms = time_fn(lambda: pure.update(init, *args, **kwargs), iters=iters)
    state = pure.update(init, *args, **kwargs)
    compute_ms = time_fn(lambda: pure.compute(state), iters=iters)
    return {"update_ms": update_ms, "compute_ms": compute_ms}
