"""Observability on the card: the fence on CUDA streams and the profiler projection.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is false.
This file imports no JAX, so it runs on a GPU machine without the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_observability.py

* The fence: with ``enable(device_time=True)`` a ``BinnedAUROC`` update on the
  card stamps its ``metric.update`` span with ``device_ms``, a wait on the
  current stream of the state's device; the values equal the unfenced run's
  bit for bit.
* ``start_trace`` / ``stop_trace`` around an annotated ``BinnedAUROC``
  update: the Chrome trace holds the ``metric.update`` scope as a
  ``gpu_user_annotation`` event, K1's ``count_kernel`` lies inside it on the
  device timeline, and ``from_profiler_trace`` reports the phase's device
  time from the device events (not host and device added together).

Tolerances: counts are equal; times are only checked to be positive.
"""
import json

import pytest
import torch

import metrics_tpu_torch as pt
import metrics_tpu_torch.observability as pobs
from metrics_tpu_torch.observability import profiler as pprofiler
from metrics_tpu_torch.observability import trace as ptrace

_N = 1 << 20
_T = 256


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def obs_hygiene():
    """The port's observability off and empty around each test; fails the
    test if it left a profiler session open."""
    pobs.disable()
    pobs.reset()
    yield
    left_open = pprofiler.is_tracing()
    if left_open:
        session = pprofiler._SESSION.profile
        pprofiler._SESSION.profile = pprofiler._SESSION.log_dir = None
        ptrace.PROFILER_SCOPE = None
        session.stop()
    pobs.disable()
    pobs.reset()
    assert not left_open, "a torch.profiler session was left open"


def _batch(device):
    gen = torch.Generator(device=device).manual_seed(16)
    return torch.rand(_N, generator=gen, device=device), torch.randint(0, 2, (_N,), generator=gen, device=device)


@pytest.mark.cuda
def test_fence_stamps_device_ms_on_a_cuda_update(cuda):
    preds, target = _batch(cuda)
    plain = pt.BinnedAUROC(thresholds=_T, device=cuda)
    plain.update(preds, target)
    fenced = pt.BinnedAUROC(thresholds=_T, device=cuda)
    pobs.enable(device_time=True)
    fenced.update(preds, target)
    value = fenced.compute()
    pobs.disable()
    (update,) = [r for r in pobs.records() if r.name == "metric.update"]
    assert update.attrs["device_ms"] > 0.0 and update.attrs["state_bytes"] > 0
    assert pobs.device_time_table()["BinnedAUROC"]["update"] == update.attrs["device_ms"]
    for name in plain._defaults:
        assert torch.equal(getattr(plain, name), getattr(fenced, name)), name
    assert torch.equal(value, plain.compute())


@pytest.mark.cuda
def test_profiler_shows_k1_inside_the_update_scope(cuda, tmp_path):
    preds, target = _batch(cuda)
    m = pt.BinnedAUROC(thresholds=_T, device=cuda)
    m.update(preds, target)  # builds and loads K1 outside the session
    torch.cuda.synchronize()
    pobs.enable()
    pobs.start_trace(str(tmp_path))
    try:
        with pobs.annotate("metric.sync"):
            m.update(preds, target)
        torch.cuda.synchronize()
    finally:
        path = pobs.stop_trace()
    events = json.loads(open(path).read())["traceEvents"]
    scopes = [e for e in events if e.get("ph") == "X" and e.get("cat") == "gpu_user_annotation"
              and e.get("name") == "metric.update"]
    kernels = [e for e in events if e.get("ph") == "X" and e.get("cat") == "kernel"
               and "count_kernel" in e.get("name", "")]
    assert scopes and kernels
    scope = scopes[0]
    assert any(scope["ts"] <= k["ts"] and k["ts"] + k["dur"] <= scope["ts"] + scope["dur"] + 1.0 for k in kernels)
    totals = pobs.devtime.from_profiler_trace(str(tmp_path))
    device_ms = sum(e["dur"] for e in scopes) / 1e3
    assert totals["metric.update"] == pytest.approx(device_ms)
    assert totals["metric.update"] > 0.0
