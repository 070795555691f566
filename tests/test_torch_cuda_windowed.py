"""The windowed plane on the card, held against the CPU run of the port.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is false.
This file imports no JAX, so it runs on a GPU machine without the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_windowed.py

* ``Windowed`` in ring, sliding, decay and nested (``Windowed(Keyed(...))``)
  modes over ``AUROC(approx="sketch")``, Accuracy and MeanSquaredError: the
  card's slabs equal the CPU run's (every integer count exactly), the stream
  position and the drop / late counts are the same, and so are ``compute()``
  and every ``compute_window(w)``;
* the nested mode's per-sample deltas run ``Keyed`` under ``torch.func.vmap``
  on the card with out-of-range cohort ids (no device assert), and those ids
  are counted in ``slab_dropped_samples``;
* ``forward`` on the card equals the CPU's, and a tumbling step makes two
  synchronizing calls of the port's own, the copies of its host ids (the kept
  samples' index and the slot rows); the event times are host numpy.

Tolerances: counts and rows are integers and equal; float32 sums in another
order (the card's atomics), the decay weights' products and the values from
them agree to rtol 1e-6 (absolute 1e-6 for sums that cancel).
"""
import warnings

import numpy as np
import pytest
import torch

import metrics_tpu_torch as pt
from metrics_tpu_torch.observability import counters

RTOL = 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _batch(seed, n, step, stride):
    rng = np.random.RandomState(seed)
    t = step * stride + rng.uniform(0, stride, n)
    late = rng.rand(n) < 0.05
    t[late] -= rng.uniform(0, 2 * stride, late.sum())
    t[rng.rand(n) < 0.005] -= 50 * stride
    labels = (rng.rand(n) < 0.3).astype(np.int64)
    scores = (1 / (1 + np.exp(-(rng.randn(n) + 1.5 * labels)))).astype(np.float32)
    logits = rng.randn(n, 10).astype(np.float32)
    probs = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(np.float32)
    classes = rng.randint(0, 10, n)
    target = np.exp(rng.randn(n)).astype(np.float32)
    preds = (target * np.exp(0.1 * rng.randn(n))).astype(np.float32)
    slots = rng.randint(0, 100, n)
    slots[:8], slots[8:16] = -1, 100
    return {"t": t, "scores": scores, "labels": labels, "probs": probs, "classes": classes, "preds": preds,
            "target": target, "slots": slots}


_MODES = {
    "ring_auroc": (lambda d: pt.Windowed(pt.AUROC(approx="sketch", device=d), window_s=60.0, num_windows=4,
                                         allowed_lateness_s=180.0), ("scores", "labels"), 20.0),
    "sliding_accuracy": (lambda d: pt.Windowed(pt.Accuracy(device=d), window_s=6.0, slide_s=2.0, num_windows=6,
                                               allowed_lateness_s=4.0), ("probs", "classes"), 1.0),
    "decay_mse": (lambda d: pt.Windowed(pt.MeanSquaredError(device=d), decay_half_life_s=30.0),
                  ("preds", "target"), 5.0),
    "nested_keyed": (lambda d: pt.Windowed(pt.Keyed(pt.Accuracy(device=d), 100), window_s=60.0, num_windows=4,
                                           allowed_lateness_s=120.0), ("probs", "classes", "slots"), 20.0),
}


def _feed(metric, b, names, device, call):
    args = [torch.from_numpy(b[n]).to(device) for n in names if n != "slots"]
    kw = {"slot": torch.from_numpy(b["slots"]).to(device)} if "slots" in names else {}
    return (metric if call else metric.update)(*args, event_time=b["t"], **kw)


def _assert_same(card, cpu):
    for name, value in cpu._current_state().items():
        got = card._current_state()[name]
        got, want = (got.counts if hasattr(got, "counts") else got).cpu(), value.counts if hasattr(value, "counts") \
            else value
        if want.is_floating_point():
            torch.testing.assert_close(got, want, rtol=RTOL, atol=1e-6)
        else:
            assert torch.equal(got, want), name
    assert (card.watermark, card.head_window, card.resident_windows(), card.dropped_samples, card.late_samples) == \
        (cpu.watermark, cpu.head_window, cpu.resident_windows(), cpu.dropped_samples, cpu.late_samples)


def _close(got, want):
    torch.testing.assert_close(got.cpu(), want, rtol=RTOL, atol=1e-6, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(_MODES))
def test_windowed_on_the_card_equals_cpu(cuda, mode):
    make, names, stride = _MODES[mode]
    card, cpu = make(cuda), make("cpu")
    counters.reset()
    for step in range(6):
        b = _batch(step, 8_192, step, stride)
        _feed(card, b, names, cuda, call=step % 2 == 1)
        _feed(cpu, b, names, "cpu", call=step % 2 == 1)
    torch.cuda.synchronize()
    _assert_same(card, cpu)
    _close(card.compute(), cpu.compute())
    for w in cpu.resident_windows():
        _close(card.compute_window(w), cpu.compute_window(w))
    dropped = counters.snapshot()["slab_dropped_samples"]
    misrouted = 2 * 6 * 16 if mode == "nested_keyed" else 0  # each run counts its own out-of-range cohort ids
    assert dropped == card.dropped_samples + cpu.dropped_samples + misrouted


@pytest.mark.cuda
def test_tumbling_forward_on_the_card_makes_two_host_copies_and_no_read(cuda):
    make, names, stride = _MODES["ring_auroc"]
    card = make(cuda)
    b = _batch(11, 8_192, 0, stride)
    _feed(card, b, names, cuda, call=True)
    b = _batch(12, 8_192, 1, stride)
    args = [torch.from_numpy(b[n]).to(cuda) for n in names]
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            card(*args, event_time=b["t"])
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [f"{w.filename}:{w.lineno}" for w in caught if "synchroniz" in str(w.message).lower()]
    # the port's own: the kept samples' index and the slot rows, copied from host numpy (the batch holds events too
    # late to keep); torch itself may add one of its own. The event times are host numpy: no read.
    ours = [site for site in syncs if "metrics_tpu_torch" in site]
    assert len(ours) == 2 and all("wrappers/windowed.py" in site for site in ours), syncs
