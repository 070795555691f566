"""The sparse delta-sync plane and the two-level hierarchy on the card.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is false
(the four-card test also where fewer than four cards are visible). This file
imports no JAX, so it runs on a GPU machine without the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_sparse.py

* One card, a one-rank NCCL group: ``Keyed(AUROC(approx="sketch"), 256)``'s
  ``sparse_plane`` rounds (sparse with a ``touched=`` hint, skip, fallback)
  equal the same rounds on the CPU and the dense bucketed sync bit for bit,
  with one ``all_reduce`` and one ``all_gather`` a sparse round;
  ``deferred_sparse_sync`` resolves to the synchronous round; a one-rank
  ``MeshHierarchy`` is the flat plane over ``ici``.
* Four cards (NCCL, one process a card, 2 slices of 2): the two-stage sum
  equals the flat sum (int64 bit for bit, float32 within ``RTOL``), the
  gather plane comes back in flat rank order, and sparse rounds over a
  ``Keyed(AUROC sketch, 1,000)`` with each rank's own slots equal the flat
  dense sync bit for bit, with 4 staged collectives a two-level round and 2
  a flat one.

Tolerances: counts are integers and equal; float32 sums of 4 terms in another
order within ``RTOL``.
"""
import contextlib
import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import metrics_tpu_torch as pt
from metrics_tpu_torch.observability import counters
from metrics_tpu_torch.parallel import sync
from metrics_tpu_torch.parallel.deferred import deferred_sparse_sync, drain_host_plane
from metrics_tpu_torch.parallel.slab import slab_touched_mask
from metrics_tpu_torch.parallel.sparse import _payload_of

RTOL = 1e-6  # float32 sums of 4 terms in another order
_REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@contextlib.contextmanager
def _one_rank_nccl():
    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    counters.reset()
    try:
        yield
    finally:
        drain_host_plane()
        counters.disable()
        dist.destroy_process_group()


@pytest.fixture
def nccl(cuda):
    with _one_rank_nccl():
        yield cuda


def _equal(a, b):
    return all(torch.equal(_payload_of(a[k]).cpu(), _payload_of(b[k]).cpu()) for k in a)


def _keyed_steps(device, steps, num_slots=256, n=4096):
    """Seeded batches: a few hot slots a step, then one step over most slots (a fallback)."""
    gen = np.random.RandomState(5)
    out = []
    for i in range(steps):
        hot = gen.choice(num_slots, 200 if i == steps - 1 else 12, replace=False)
        slots = torch.from_numpy(hot[gen.randint(0, hot.size, n)]).to(device)
        out.append((torch.from_numpy(gen.rand(n).astype(np.float32)).to(device),
                    torch.from_numpy(gen.randint(0, 2, n)).to(device), slots))
    return out


def _rounds(device, steps):
    metric = pt.Keyed(pt.AUROC(approx="sketch", device=device), num_slots=256)
    plane = metric.sparse_plane(capacity=64)
    merged, modes = [], []
    for i, (p, t, s) in enumerate(steps):
        if i != 1:  # step 1 adds nothing: a skip
            metric.update(p, t, slot=s)
        out = plane.sync(metric._current_state(), touched=slab_touched_mask(s, 256) if i == 0 else None)
        merged.append({k: _payload_of(v).cpu().clone() for k, v in out.items()})
        modes.append((plane.rounds, plane.fallbacks, plane.skips))
    return metric, merged, modes


@pytest.mark.cuda
def test_sparse_rounds_on_the_card_equal_the_cpu_and_the_dense_sync(cuda):
    steps = _keyed_steps(cuda, 3)
    # the CPU run first, outside the process group (an NCCL group takes card tensors only)
    _, cpu_merged, cpu_modes = _rounds(torch.device("cpu"), [tuple(x.cpu() for x in step) for step in steps])
    with _one_rank_nccl():
        counters.enable()
        metric, merged, modes = _rounds(cuda, steps)
        calls = counters.snapshot()["calls_by_kind"]
        counters.disable()
        assert _equal(merged[-1], sync.all_reduce_state(metric._current_state(), metric._reductions))
    assert modes == [(1, 0, 0), (2, 0, 1), (3, 1, 1)]
    assert calls["all_gather"] == 1  # one sparse round; the skip and the fallback gather nothing
    assert cpu_modes == modes
    for got, want in zip(merged, cpu_merged):
        assert _equal(got, want)


@pytest.mark.cuda
def test_deferred_sparse_round_on_the_card(nccl):
    steps = _keyed_steps(nccl, 2)
    metric = pt.Keyed(pt.AUROC(approx="sketch", device=nccl), num_slots=256)
    plane, twin = metric.sparse_plane(capacity=64), metric.sparse_plane(capacity=64)
    p, t, s = steps[0]
    metric.update(p, t, slot=s)
    state = metric._current_state()
    handle = deferred_sparse_sync(plane, state, touched=slab_touched_mask(s, 256))
    metric.update(*steps[1][:2], slot=steps[1][2])  # in place, after dispatch: the round holds a copy
    got = handle.result()
    want = twin.sync({k: v for k, v in state.items()})
    assert handle.label == "sparse_sync" and plane.rounds == 1
    p0 = pt.Keyed(pt.AUROC(approx="sketch", device=nccl), num_slots=256)
    p0.update(p, t, slot=s)
    assert _equal(got, p0._current_state())
    assert not _equal(want, p0._current_state())  # the live state moved on; the deferred round did not


@pytest.mark.cuda
def test_one_rank_hierarchy_is_the_flat_plane_over_ici(nccl):
    h = pt.parallel.hierarchical_mesh()
    col = pt.MetricCollection([pt.Accuracy(device=nccl), pt.Precision(device=nccl)])
    pure = col.pure()
    gen = torch.Generator(device=nccl).manual_seed(1)
    state = pure.update(pure.init(), torch.rand(512, generator=gen, device=nccl),
                        torch.randint(0, 2, (512,), generator=gen, device=nccl))
    counters.enable()
    got = col.sync_state(state, group=h)
    crossings = counters.snapshot()["calls_by_crossing"]
    counters.disable()
    want = col.sync_state(state)
    assert all(torch.equal(got[k][n], want[k][n]) for k in got for n in got[k])
    assert set(crossings) == {"ici"} and crossings["ici"] >= 1


_WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np, torch, torch.distributed as dist
    sys.path.insert(0, sys.argv[4])
    import metrics_tpu_torch as pt
    from metrics_tpu_torch.observability import counters
    from metrics_tpu_torch.parallel import sync
    from metrics_tpu_torch.parallel.sparse import _payload_of

    rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    torch.cuda.set_device(rank)
    dev = torch.device("cuda", rank)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=4, rank=rank)
    h = pt.parallel.hierarchical_mesh(slices=2)
    rng = np.random.RandomState(40 + rank)
    state = {"n": torch.from_numpy(rng.randint(-2**40, 2**40, 64)).to(dev),
             "f": torch.from_numpy(rng.rand(64).astype(np.float32)).to(dev),
             "cat": [torch.from_numpy(rng.rand(rank + 1, 2).astype(np.float32)).to(dev)]}
    red = {"n": "sum", "f": "sum", "cat": "cat"}
    hier = sync.all_reduce_state(state, red, group=h)
    flat = sync.all_reduce_state(state, red)
    res = {"n": hier["n"].tolist() == flat["n"].tolist(),
           "f": float(((hier["f"] - flat["f"]).abs() / flat["f"].abs()).max()),
           "cat": torch.equal(hier["cat"], flat["cat"]), "cat_rows": hier["cat"].shape[0]}

    def equal(a, b):
        return all(torch.equal(_payload_of(a[k]), _payload_of(b[k])) for k in a)

    for label, group in (("flat", None), ("hier", h)):
        metric = pt.Keyed(pt.AUROC(approx="sketch", device=dev), num_slots=1000)
        plane = metric.sparse_plane(group, capacity=64)
        oks, calls = [], []
        for step in range(5):
            slots = torch.from_numpy(rng.choice(np.arange(rank * 250, rank * 250 + 250), 8)[rng.randint(0, 8, 2048)])
            metric.update(torch.from_numpy(rng.rand(2048).astype(np.float32)).to(dev),
                          torch.from_numpy(rng.randint(0, 2, 2048)).to(dev), slot=slots.to(dev))
            counters.reset()
            counters.enable()
            merged = plane.sync(metric._current_state())
            calls.append(counters.snapshot()["collective_calls"])
            counters.disable()
            oks.append(equal(merged, sync.all_reduce_state(metric._current_state(), metric._reductions)))
        res[label] = {"equal": oks, "calls": calls, "fallbacks": plane.fallbacks}
    json.dump(res, open(out, "w"))
    dist.destroy_process_group()
""")


@pytest.mark.cuda
def test_two_by_two_nccl_hierarchy_on_four_cards(cuda, tmp_path):
    if torch.cuda.device_count() < 4:
        pytest.skip(f"needs 4 CUDA devices, have {torch.cuda.device_count()}")
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(port), str(tmp_path / f"out{r}.json"),
                               str(_REPO)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=dict(os.environ, OMP_NUM_THREADS="1"))
             for r in range(4)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0] * 4, logs
    for r in range(4):
        res = json.loads((tmp_path / f"out{r}.json").read_text())
        assert res["n"] and res["cat"] and res["cat_rows"] == 1 + 2 + 3 + 4 and res["f"] <= RTOL, (r, res)
        for label, per_round in (("flat", 2), ("hier", 4)):
            assert res[label]["equal"] == [True] * 5 and res[label]["fallbacks"] == 0, (r, label)
            assert res[label]["calls"] == [per_round] * 5, (r, label, res[label]["calls"])
