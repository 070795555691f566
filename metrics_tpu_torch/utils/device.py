"""Device policy: the port runs on the GPU unless the caller asks for the CPU.

There is no silent CPU fallback. ``device=None`` means ``cuda``; where no GPU
is present that raises :class:`NoDeviceError`, and the caller passes
``device="cpu"`` to run on the CPU (as the tests do).
"""
from typing import Any, Optional, Union

import torch

from metrics_tpu_torch.utils.exceptions import DeviceMismatchError, NoDeviceError


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """The device a metric places its states on: ``cuda`` by default."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise NoDeviceError(
                "metrics_tpu_torch runs on the GPU by default and no CUDA device is available;"
                " pass device='cpu' to run on the CPU."
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def check_same_device(device: torch.device, *values: Any) -> None:
    """Raise when a tensor among ``values`` lies on another device than ``device``."""
    for v in values:
        if isinstance(v, torch.Tensor) and v.device != device:
            raise DeviceMismatchError(
                f"input on {v.device} but the metric's states are on {device};"
                " move the input (or build the metric with that device)."
            )
