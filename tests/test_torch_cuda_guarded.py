"""The guarded and deferred sync plane on the card, in a one-rank NCCL group.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is false.
This file imports no JAX, so it runs on a GPU machine without the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_guarded.py

* The guard on the card (``MetricCollection([Accuracy, F1, Precision,
  Recall])`` with ``dist_sync_on_step``, 100 classes, 8 steps): a transient
  drop x2 records 2 retries with values bit-equal to the unfaulted run; a
  corrupted payload under ``check_finite=True`` is retried to the same values;
  a persistent drop under ``policy="degrade"`` gives the local values and
  counts ``degraded_computes``; under ``"raise"`` it raises
  ``SyncTimeoutError``. A deadline on the card polls the NCCL work.
* Integrity on the card: ``Windowed(MeanSquaredError())`` and
  ``Keyed(MeanSquaredError())`` fed one NaN-poisoned batch under
  ``check_finite="quarantine"`` restore the slabs from before it bit for bit
  and end equal to a run without it (``quarantined_updates`` + 1 each); ``"raise"`` raises
  ``StateCorruptionError``; ``state_integrity_counts`` of a corrupted state
  equals its count on the CPU.
* The deferred device handle: ``sync_state(..., deferred=True)`` enters one
  ``all_reduce`` a bucket at dispatch, and resolves to the synchronous
  ``all_reduce`` result although the live ``Keyed`` state is written in place
  after dispatch; ``sync_lag=2`` reads the synchronous values two steps late.

Tolerances: counts are integers and equal; values from equal counts are
equal; a quarantine's restore is exact; float32 slab sums of two runs on the
card agree to rtol 1e-4 (the same terms, added by atomics in another order;
one batch more or less would move a cell by several percent).
"""
import contextlib
import socket

import numpy as np
import pytest
import torch

import metrics_tpu_torch as pt
from metrics_tpu_torch.observability import counters
from metrics_tpu_torch.parallel import faults, sync
from metrics_tpu_torch.utils.exceptions import StateCorruptionError, SyncTimeoutError

_CLASSES = 100
RTOL = 1e-4  # float32 slab sums of two card runs: ~16,000 terms a cell at most, added by atomics in another order


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture
def nccl(cuda):
    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    counters.reset()
    try:
        yield cuda
    finally:
        sync.set_sync_guard(None)
        if sync._FAULT_HOOK is not None:
            sync._FAULT_HOOK.uninstall()
        dist.destroy_process_group()


def _batches(device, steps=8, n=512):
    gen = torch.Generator(device=device).manual_seed(3)
    return [(torch.softmax(torch.randn(n, _CLASSES, generator=gen, device=device), 1),
             torch.randint(0, _CLASSES, (n,), generator=gen, device=device)) for _ in range(steps)]


def _collection(device, lag=0):
    col = pt.MetricCollection([
        pt.Accuracy(device=device, dist_sync_on_step=True),
        pt.F1(num_classes=_CLASSES, average="macro", device=device, dist_sync_on_step=True),
        pt.Precision(num_classes=_CLASSES, average="macro", device=device, dist_sync_on_step=True),
        pt.Recall(num_classes=_CLASSES, average="macro", device=device, dist_sync_on_step=True),
    ])
    for m in col.values():
        m.sync_lag = lag
    return col


def _run(device, batches, guard=None, specs=(), lag=0):
    counters.reset()
    col = _collection(device, lag)
    sync.set_sync_guard(guard)
    try:
        with faults.chaos(*[faults.FaultSpec(**s) for s in specs]) if specs else contextlib.nullcontext():
            values = [{k: v.item() for k, v in col(*b).items()} for b in batches]
            epoch = {k: v.item() for k, v in col.compute().items()}
    finally:
        sync.set_sync_guard(None)
    return values, epoch, counters.snapshot()["faults"]


@pytest.mark.cuda
def test_guard_outcomes_on_the_card(nccl):
    batches = _batches(nccl)
    clean, clean_epoch, _ = _run(nccl, batches)
    got, epoch, f = _run(nccl, batches, sync.SyncGuard(max_retries=2, backoff_s=0.01), [dict(kind="drop", call=1,
                                                                                           times=2)])
    assert got == clean and epoch == clean_epoch and f["sync_retries"] == 2 and f["degraded_computes"] == 0
    got, epoch, f = _run(nccl, batches, sync.SyncGuard(max_retries=2, backoff_s=0.01, check_finite=True),
                         [dict(kind="corrupt", call=0, times=1)])
    assert got == clean and epoch == clean_epoch and f["sync_retries"] == 1
    got, epoch, f = _run(nccl, batches, sync.SyncGuard(deadline_s=5.0, max_retries=1, backoff_s=0.01,
                                                       policy="degrade"), [dict(kind="drop", rate=1.0, times=10**6)])
    assert got == clean and f["degraded_computes"] >= len(batches)  # one rank: the local values are the synced ones
    with pytest.raises(SyncTimeoutError):
        _run(nccl, batches, sync.SyncGuard(max_retries=1, backoff_s=0.01), [dict(kind="drop", call=0, times=99)])
    got, epoch, f = _run(nccl, batches, sync.SyncGuard(deadline_s=5.0, max_retries=1))
    assert got == clean and f["sync_retries"] == 0  # the deadline path: async NCCL work, polled


@pytest.mark.cuda
def test_sync_lag_two_on_the_card(nccl):
    batches = _batches(nccl)
    clean, clean_epoch, _ = _run(nccl, batches)
    got, epoch, _ = _run(nccl, batches, lag=2)
    assert got[2:] == clean[:-2] and epoch == clean_epoch


def _events(seed, n, t0):
    rng = np.random.RandomState(seed)
    preds = rng.rand(n).astype(np.float32)
    target = (preds + 0.1 * rng.randn(n)).astype(np.float32)
    return preds, target, t0 + rng.uniform(0, 5, n), rng.randint(0, 64, n)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["windowed", "keyed"])
def test_quarantine_and_raise_on_the_card(cuda, kind):
    def build():
        inner = pt.MeanSquaredError(device=cuda)
        if kind == "windowed":
            return pt.Windowed(inner, window_s=10.0, num_windows=4, allowed_lateness_s=20.0)
        return pt.Keyed(inner, num_slots=64)

    def feed(m, batch, poison=False):
        preds, target, times, slots = batch
        p = torch.from_numpy(preds).to(cuda)
        if poison:
            p[::7] = float("nan")
        t = torch.from_numpy(target).to(cuda)
        if kind == "windowed":
            m(p, t, event_time=times)
        else:
            m(p, t, slot=torch.from_numpy(slots).to(cuda))

    batches = [_events(s, 4096, 2.0 * s) for s in range(6)]
    counters.reset()
    poisoned, clean = build(), build()
    poisoned.check_finite = "quarantine"
    for i, b in enumerate(batches):
        if i == 3:
            before = {n: v.clone() for n, v in poisoned._current_state().items()}
            with pytest.warns(UserWarning, match="quarantined"):
                feed(poisoned, (b[0], b[1], batches[2][2], b[3]), poison=True)  # times of a window already open
            for name, value in before.items():  # the restore is exact
                assert torch.equal(getattr(poisoned, name), value), name
        feed(poisoned, b)
        feed(clean, b)
    for name, value in clean._current_state().items():
        if value.is_floating_point():  # the same terms, added by the card's atomics in another order
            torch.testing.assert_close(getattr(poisoned, name), value, rtol=RTOL, atol=0)
        else:
            assert torch.equal(getattr(poisoned, name), value), name
    assert counters.snapshot()["faults"]["quarantined_updates"] == 1
    raising = build()
    raising.check_finite = "raise"
    with pytest.raises(StateCorruptionError):
        feed(raising, batches[0], poison=True)
    corrupted = faults.corrupt_pytree(clean._current_state(), fraction=0.3)
    on_card = [int(c) for c in pt.state_integrity_counts(corrupted)]
    on_cpu = [int(c) for c in pt.state_integrity_counts({k: v.cpu() for k, v in corrupted.items()})]
    assert on_card == on_cpu and on_card[0] > 0


@pytest.mark.cuda
def test_deferred_device_handle_equals_the_synchronous_all_reduce(nccl):
    import torch.distributed as dist

    keyed = pt.Keyed(pt.MeanSquaredError(device=nccl), num_slots=1000)
    gen = torch.Generator(device=nccl).manual_seed(5)

    def update():
        keyed.update(torch.rand(65_536, generator=gen, device=nccl), torch.rand(65_536, generator=gen, device=nccl),
                     slot=torch.randint(0, 1000, (65_536,), generator=gen, device=nccl))

    update()
    want = keyed.sync_state(keyed._current_state())
    calls = []
    real = dist.all_reduce
    dist.all_reduce = lambda *a, **k: (calls.append(k.get("async_op")), real(*a, **k))[1]
    try:
        handle = keyed.sync_state(keyed._current_state(), deferred=True)
    finally:
        dist.all_reduce = real
    assert calls == [True, True]  # one unfenced all_reduce a bucket (float32 and int64 sums)
    update()  # written in place while the collective may still run
    got = handle.result()
    for name in want:
        assert torch.equal(got[name], want[name]), name
    assert handle.done() and handle.watermark == 1
