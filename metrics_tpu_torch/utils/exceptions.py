"""Typed exception hierarchy for metrics_tpu_torch.

Counterpart of ``metrics_tpu/utils/exceptions.py``, cut to the errors this
package raises. Every deliberate error derives from :class:`MetricsTorchError`.
"""

__all__ = ["BufferOverflowError", "DeviceMismatchError", "MetricsTorchError", "NoDeviceError"]


class MetricsTorchError(Exception):
    """Base class for library errors."""


class NoDeviceError(MetricsTorchError, RuntimeError):
    """A metric or kernel was asked to run on the GPU (the default) where
    ``torch.cuda.is_available()`` is false. Pass ``device="cpu"`` to run on
    the CPU; nothing falls back silently."""


class DeviceMismatchError(MetricsTorchError, RuntimeError):
    """An input tensor lies on another device than the metric's states."""


class BufferOverflowError(MetricsTorchError, RuntimeError):
    """More rows were appended into a ``PaddedBuffer`` than its capacity holds
    (the overflowed rows were dropped on the device). Raised by the ``error``
    overflow policy; ``warn_drop`` warns once and keeps the capacity-truncated
    rows (see ``parallel.buffer.set_overflow_policy``)."""
