"""Running-window wrapper: the value over the last ``window`` updates.

Counterpart of ``metrics_tpu/wrappers/running.py``: each update stages the
batch as an independent state delta through the base metric's pure view
(``init -> update``); ``compute()`` merges the last ``window`` deltas and
computes on the result. The window is process-local (a sliding window has no
well-defined cross-process sync), so the wrapper never syncs. The retained
deltas ride ``state_dict`` under ``_running_deltas`` in the JAX package's
layout.
"""
from typing import Any, List, Optional

import numpy as np
import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.parallel.buffer import PaddedBuffer
from metrics_tpu_torch.parallel.sketch import is_sketch
from metrics_tpu_torch.utils.data import host_copy

__all__ = ["Running"]


class Running(Metric):
    r"""A sliding-window view of any metric: the value over the last
    ``window`` updates. The window costs ``window x state size`` memory.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MeanSquaredError
        >>> running = Running(MeanSquaredError(device="cpu"), window=2)
        >>> for step in range(4):
        ...     _ = running(torch.tensor([float(step)]), torch.tensor([0.0]))
        >>> float(running.compute())  # last two steps: (2^2 + 3^2) / 2
        6.5
    """

    def __init__(self, base_metric: Metric, window: int = 5):
        if not isinstance(base_metric, Metric):
            raise ValueError(f"`base_metric` must be a Metric, got {type(base_metric).__name__}")
        if not isinstance(window, int) or window < 1:
            raise ValueError(f"`window` must be a positive int, got {window!r}")
        super().__init__(compute_on_step=base_metric.compute_on_step, device=base_metric.device)
        self.base_metric = base_metric
        self.window = window
        self._pure = base_metric.pure()
        self._deltas: List[Any] = []

    def update(self, *args: Any, **kwargs: Any) -> None:
        delta = self._pure.update(self._pure.init(), *args, **kwargs)
        self._deltas.append(delta)
        if len(self._deltas) > self.window:
            self._deltas.pop(0)

    def forward(self, *args: Any, **kwargs: Any) -> Optional[Any]:
        self.update(*args, **kwargs)
        self._computed = None
        if not self.compute_on_step:
            return None
        return self.compute()

    def compute(self) -> Any:
        state = self._pure.init()
        for delta in self._deltas:
            state = self._pure.merge(state, delta)
        return self._pure.compute(state)

    def reset(self) -> None:
        super().reset()
        self._deltas = []

    # The window is the state: ``_deltas`` holds one state dict per retained
    # step, and the base ``state_dict`` covers registered states only.
    _DELTAS_KEY = "_running_deltas"

    def state_dict(self, destination: Optional[dict] = None, prefix: str = "") -> dict:  # type: ignore[override]
        """The retained window deltas as host numpy, plus the base entries."""
        destination = super().state_dict(destination, prefix=prefix)
        destination[prefix + self._DELTAS_KEY] = [
            {name: _encode_leaf(value) for name, value in delta.items()} for delta in self._deltas
        ]
        return destination

    def load_state_dict(self, state_dict: dict, prefix: str = "") -> None:  # type: ignore[override]
        super().load_state_dict(state_dict, prefix=prefix)
        key = prefix + self._DELTAS_KEY
        if key not in state_dict:
            return
        template = self._pure.init()
        self._deltas = [
            {name: _decode_leaf(entry[name], template.get(name), self.device) for name in entry}
            for entry in state_dict[key]
        ][-self.window:]


def _encode_leaf(value: Any) -> Any:
    """One delta leaf as host data, in the base ``state_dict``'s conventions."""
    if isinstance(value, PaddedBuffer):
        return {"data": host_copy(value.data), "count": host_copy(value.count)}
    if is_sketch(value):
        return {"sketch_counts": host_copy(value.counts)}
    if isinstance(value, list):
        return [host_copy(v) for v in value]
    return host_copy(value)


def _decode_leaf(value: Any, template: Any, device: torch.device) -> Any:
    """One checkpointed delta leaf back on ``device``, in the template's dtype."""
    if isinstance(value, dict) and set(value) == {"data", "count"}:
        return PaddedBuffer(torch.as_tensor(np.asarray(value["data"]), device=device),
                            torch.as_tensor(np.asarray(value["count"]), device=device).to(torch.int64))
    if isinstance(value, dict) and set(value) == {"sketch_counts"}:
        if not is_sketch(template):
            raise ValueError("checkpoint delta holds sketch counts but the state is not a sketch")
        return type(template)(torch.as_tensor(np.asarray(value["sketch_counts"]), device=device).to(template.counts.dtype))
    if isinstance(value, list):
        return [torch.as_tensor(np.asarray(v), device=device) for v in value]
    dtype = template.dtype if isinstance(template, torch.Tensor) else None
    return torch.as_tensor(np.asarray(value), device=device, dtype=dtype)
