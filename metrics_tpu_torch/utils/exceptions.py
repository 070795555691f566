"""Typed exception hierarchy for metrics_tpu_torch.

Counterpart of ``metrics_tpu/utils/exceptions.py``. Every deliberate error
derives from :class:`MetricsTorchError`, so a caller can catch anything this
package decided to fail on with one ``except`` clause and still match the
specific classes. An error that stands in for a builtin (``RuntimeError``,
``TimeoutError``) keeps it as a second base, so callers that match the builtin
keep working.
"""

__all__ = [
    "BufferOverflowError",
    "DeviceMismatchError",
    "InjectedFaultError",
    "MetricsTorchError",
    "NoDeviceError",
    "PreemptionError",
    "StateCorruptionError",
    "SyncTimeoutError",
    "TracingUnsupportedError",
]


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


class TracingUnsupportedError(MetricsTorchError):
    """A value-dependent host operation was asked for on values that cannot be
    read back: tensors batched by ``torch.func.vmap``, or a region that
    ``torch.compile`` is tracing (the JAX package raises it under jit
    tracing)."""


class SyncTimeoutError(MetricsTorchError, TimeoutError):
    """A host-plane sync or a watermark agreement ran past its deadline under
    the ``raise`` policy; the ``degrade`` policy goes on without the stalled
    participant instead."""


class StateCorruptionError(MetricsTorchError):
    """A metric state (or a gathered sync payload) failed an integrity scan:
    non-finite values where none entered, or a saturated integer count."""


class PreemptionError(MetricsTorchError):
    """The process is being preempted mid-epoch. Never retried by a sync
    guard: the caller checkpoints and re-raises or exits, and resumes from the
    checkpointed epoch watermark."""


class InjectedFaultError(MetricsTorchError):
    """A transient fault injected on purpose (a dropped participant or a failed
    collective, to test recovery). Retryable by a sync guard."""
