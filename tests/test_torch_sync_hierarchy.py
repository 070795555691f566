"""The two-level sync plane across four real processes (Gloo, 2 slices of 2).

Four ranks over ``torch.distributed`` (Gloo, a FileStore under ``tmp_path``),
grouped by ``hierarchical_mesh(slices=2)`` into a ``MeshHierarchy`` of two
slices of two ranks, each rank's state made from a seed here and handed to it.
The same per-rank states go through the JAX package's in-jit planes on a
``(2, 2)`` ``("dcn", "ici")`` mesh and a flat 4-device mesh of the conftest's
virtual CPU devices:

* mixed buckets (int64, int32 and float32 sums, an int32 min, a float32 max, a
  float32 mean): the two-stage sum equals the flat sum and the JAX package's
  planes, integers bit for bit, floats within ``RTOL``; ``hierarchy=False``
  and a one-slice hierarchy are the flat plane;
* the gather plane (a list ``cat`` state with a different row count on each
  rank, a stack state, a ``PaddedBuffer``): the hierarchical gather equals the
  flat one bit for bit, in flat rank order, and the JAX package's;
* ``buffer_all_gather`` flat and two-level against the JAX package's;
* ``slice_leader_gather`` through ``host_gather(slice_leaders=)``: one copy a
  slice of a slice-replicated state, counted at ``dcn`` with slice fanout;
* the counters: calls and bytes by crossing of a reduce state equal the JAX
  package's snapshot for the same state, flat and two-level;
* the guard wraps each stage: a dropped ``dcn`` stage is retried;
* ``Metric(process_group=hierarchy)`` and ``MetricCollection.sync_state``
  with a hierarchy equal the flat plane.

The children run once for the module; each test reads their results. No
``torch.distributed`` group exists in this process. Tolerances: integers
exact; float32 sums of 4 terms in another order within ``RTOL``.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from metrics_tpu.observability import counters as jcounters
from metrics_tpu.parallel import buffer as jbuffer
from metrics_tpu.parallel import sync as jsync
from metrics_tpu.parallel.placement import MeshHierarchy as JMeshHierarchy
from metrics_tpu.utils import compat
from tests.test_torch_faults import plane_hygiene  # noqa: F401  (autouse: every test leaves the process clean)

torch.set_num_threads(1)

_REPO = Path(__file__).resolve().parents[1]
WORLD = 4
RTOL = 1e-6  # float32 sums of 4 terms, added in another order
REDUCE = {"f": "sum", "g": "sum", "n": "sum", "m": "sum", "lo": "min", "hi": "max", "mu": "mean"}
# the reduce state whose counters are held to the JAX package's: one bucket a (dtype, op) in both
COUNTED = {"f": "sum", "g": "sum", "lo": "min", "hi": "max"}

_WORKER = textwrap.dedent("""
    import json, sys, warnings
    import numpy as np, torch, torch.distributed as dist
    sys.path.insert(0, sys.argv[4])
    import metrics_tpu_torch as pt
    from metrics_tpu_torch.observability import counters
    from metrics_tpu_torch.parallel import faults, sync
    from metrics_tpu_torch.parallel.buffer import PaddedBuffer, buffer_all_gather

    warnings.simplefilter("ignore")
    rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=4)
    data = np.load(sys.argv[5])
    red = json.loads(sys.argv[6])
    counted = json.loads(sys.argv[7])
    h = pt.parallel.hierarchical_mesh(slices=2)
    one = pt.parallel.hierarchical_mesh(slices=1)
    state = {k: torch.from_numpy(data[f"{k}{rank}"]) for k in red}
    res = {"grid": [list(g) for g in h.grid], "slices": h.slices, "per_slice": h.per_slice}

    def host(v):
        if isinstance(v, PaddedBuffer):
            return {"data": v.data.tolist(), "count": int(v.count)}
        if isinstance(v, list):
            return [x.tolist() for x in v]
        return v.tolist()

    def run(name, fn):
        counters.reset()
        counters.enable()
        out_state = fn()
        snap = counters.snapshot()
        counters.disable()
        res[name] = {k: host(v) for k, v in out_state.items()}
        res[name + "_counters"] = {k: snap[k] for k in ("calls_by_crossing", "bytes_by_crossing", "calls_by_kind")}

    run("hier", lambda: sync.all_reduce_state(state, red, group=h))
    run("flat", lambda: sync.all_reduce_state(state, red))
    run("forced_flat", lambda: sync.all_reduce_state(state, red, group=h, hierarchy=False))
    run("one_slice", lambda: sync.all_reduce_state(state, red, group=one))
    sub = {k: state[k] for k in counted}
    run("counted_hier", lambda: sync.all_reduce_state(sub, counted, group=h))
    run("counted_flat", lambda: sync.all_reduce_state(sub, counted))

    # the gather plane: a list cat state (rank + 1 rows of 2), a stack state, a buffer
    cat = [torch.from_numpy(data[f"cat{rank}"])]
    buf = PaddedBuffer(torch.from_numpy(data[f"buf{rank}"]), torch.tensor(rank + 2))
    gstate = {"cat": cat, "stack": torch.from_numpy(data[f"stack{rank}"]), "buf": buf}
    gred = {"cat": "cat", "stack": None, "buf": "cat"}
    layouts = {"cat": (torch.float32, (2,))}
    run("gather_hier", lambda: sync.all_reduce_state(gstate, gred, group=h, layouts=layouts))
    run("gather_flat", lambda: sync.all_reduce_state(gstate, gred, layouts=layouts))
    run("buffer_hier", lambda: {"buf": buffer_all_gather(buf, h)})
    run("buffer_flat", lambda: {"buf": buffer_all_gather(buf)})

    # slice-leader gather: a state replicated within each slice (its slice's id + 1)
    hh = pt.parallel.HostHierarchy((0, 0, 1, 1))
    rep = {"x": torch.full((3,), float(rank // 2 + 1))}
    run("leaders", lambda: sync.host_gather(rep, {"x": "sum"}, slice_leaders=hh))
    run("leaders_flat", lambda: sync.host_gather(rep, {"x": "sum"}))
    res["leader_gather"] = [t.tolist() for t in sync.slice_leader_gather(hh)(torch.tensor([float(rank)]))]

    # the guard wraps each stage: call 1 is the first bucket's dcn stage
    counters.reset()
    with faults.ChaosInjector([faults.FaultSpec(kind="drop", call=1, times=1)], seed=1):
        old = sync.set_sync_guard(sync.SyncGuard(max_retries=2, backoff_s=0.0))
        try:
            guarded = sync.all_reduce_state(state, red, group=h)
        finally:
            sync.set_sync_guard(old)
    res["guarded"] = {k: host(v) for k, v in guarded.items()}
    res["guarded_faults"] = counters.snapshot()["faults"]

    # the metric and the collection with a hierarchy as their group
    p, t = torch.from_numpy(data[f"p{rank}"]), torch.from_numpy(data[f"t{rank}"])
    acc_h = pt.Accuracy(device="cpu", process_group=h)
    acc_h.update(p, t)
    acc_f = pt.Accuracy(device="cpu")
    acc_f.update(p, t)
    res["accuracy"] = [float(acc_h.compute()), float(acc_f.compute())]
    col = pt.MetricCollection([pt.Accuracy(device="cpu"), pt.Precision(device="cpu")])
    pure = col.pure()
    st = pure.update(pure.init(), p, t)
    a, b = col.sync_state(st, group=h), col.sync_state(st)
    res["collection_equal"] = all(torch.equal(a[k][n], b[k][n]) for k in a for n in a[k])
    json.dump(res, open(out, "w"))
    dist.destroy_process_group()
""")


def _rank_data():
    rng = np.random.RandomState(23)
    data = {}
    for r in range(WORLD):
        data[f"f{r}"] = rng.rand(5, 3).astype(np.float32)
        data[f"g{r}"] = rng.rand(7).astype(np.float32)
        data[f"n{r}"] = rng.randint(-2**40, 2**40, 4).astype(np.int64)
        data[f"m{r}"] = rng.randint(-1000, 1000, 3).astype(np.int32)
        data[f"lo{r}"] = rng.randint(-1000, 1000, 6).astype(np.int32)
        data[f"hi{r}"] = rng.rand(4).astype(np.float32)
        data[f"mu{r}"] = rng.rand(3).astype(np.float32)
        data[f"cat{r}"] = rng.rand(r + 1, 2).astype(np.float32)
        data[f"stack{r}"] = rng.rand(2).astype(np.float32)
        data[f"buf{r}"] = rng.rand(5, 2).astype(np.float32)
        data[f"p{r}"] = rng.rand(20).astype(np.float32)
        data[f"t{r}"] = rng.randint(0, 2, 20).astype(np.int64)
    return data


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("hier")
    data = _rank_data()
    np.savez(tmp / "data.npz", **data)
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    procs = [
        subprocess.Popen([sys.executable, str(script), str(r), str(tmp / "store"), str(tmp / f"out{r}.json"),
                          str(_REPO), str(tmp / "data.npz"), json.dumps(REDUCE), json.dumps(COUNTED)],
                         env=dict(os.environ, OMP_NUM_THREADS="1"), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for r in range(WORLD)
    ]
    try:
        logs = [p.communicate(timeout=150)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0] * WORLD, logs
    return data, [json.loads((tmp / f"out{r}.json").read_text()) for r in range(WORLD)]


def _meshes(eight_devices):
    devices = np.array(eight_devices[:WORLD])
    return Mesh(devices.reshape(2, 2), ("dcn", "ici")), Mesh(devices, ("dp",))


def _jax_sync(mesh, axis, stacked, reductions, hierarchy=None):
    """The JAX package's bucketed in-jit plane over per-device rows of ``stacked``."""

    def body(state):
        return jsync.coalesced_sync_state({k: v[0] for k, v in state.items()}, reductions, axis, hierarchy)

    spec = P(axis) if isinstance(axis, str) else P(tuple(axis))
    fn = jax.jit(compat.shard_map(body, mesh=mesh, in_specs=(spec,), out_specs=P(), check_vma=False))
    return fn(stacked)


def _stacked(data, names, jax_dtypes=None):
    jax_dtypes = jax_dtypes or {}
    return {k: jnp.asarray(np.stack([data[f"{k}{r}"] for r in range(WORLD)]).astype(jax_dtypes.get(k, None)))
            for k in names}


def _assert_close(port, ref, name):
    ref = np.asarray(ref)
    port = np.asarray(port, dtype=ref.dtype if ref.dtype.kind == "f" else np.int64)
    if ref.dtype.kind == "f":
        np.testing.assert_allclose(port, ref, rtol=RTOL, err_msg=name)
    else:
        np.testing.assert_array_equal(port, ref.astype(np.int64), err_msg=name)


def test_grid_is_slice_major(ranks):
    _, res = ranks
    for r in res:
        assert r["grid"] == [[0, 1], [2, 3]] and r["slices"] == 2 and r["per_slice"] == 2


@pytest.mark.parametrize("name", ["hier", "flat", "forced_flat", "one_slice", "guarded"])
def test_mixed_buckets_equal_the_numpy_sum_and_each_other(ranks, name):
    data, res = ranks
    for r in res:
        for k, fx in REDUCE.items():
            per = np.stack([data[f"{k}{q}"] for q in range(WORLD)])
            want = {"sum": per.sum(0), "min": per.min(0), "max": per.max(0), "mean": per.mean(0)}[fx]
            got = np.asarray(r[name][k])
            if per.dtype.kind == "f":
                np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=k)
                if fx in ("min", "max"):
                    np.testing.assert_array_equal(got, want, err_msg=k)
            else:
                np.testing.assert_array_equal(got, want, err_msg=k)  # integers: bit for bit
            np.testing.assert_array_equal(got, np.asarray(res[0][name][k]), err_msg=k)  # every rank alike


def test_two_stage_sums_equal_the_jax_planes(ranks, eight_devices):
    data, res = ranks
    mesh2, mesh1 = _meshes(eight_devices)
    names = ("f", "g", "m", "lo", "hi", "mu")  # the JAX package's int64 is off: n is held to numpy above
    stacked = _stacked(data, names)
    red = {k: REDUCE[k] for k in names}
    ref_h = _jax_sync(mesh2, ("dcn", "ici"), stacked, red)
    ref_f = _jax_sync(mesh1, "dp", stacked, red)
    for k in names:
        _assert_close(res[0]["hier"][k], ref_h[k], k)
        _assert_close(res[0]["flat"][k], ref_f[k], k)
        for r in res:  # integer buckets: two stages bit-equal to one
            if data[f"{k}0"].dtype.kind != "f":
                assert r["hier"][k] == r["flat"][k], k


def test_counters_by_crossing_equal_the_jax_package(ranks, eight_devices):
    data, res = ranks
    mesh2, mesh1 = _meshes(eight_devices)
    stacked = _stacked(data, COUNTED)
    was = jcounters.is_enabled()
    jcounters.enable()
    try:
        snaps = {}
        for key, mesh, axis in (("hier", mesh2, ("dcn", "ici")), ("flat", mesh1, "dp")):
            jcounters.reset()
            _jax_sync(mesh, axis, stacked, COUNTED)
            snaps[key] = jcounters.snapshot()
    finally:
        (jcounters.enable if was else jcounters.disable)()
        jcounters.reset()
    assert snaps["hier"]["bytes_by_crossing"] == {"dcn": 4 * 22 + 4 * 6 + 4 * 4, "ici": 4 * 22 + 4 * 6 + 4 * 4}
    for r in res:
        for key in ("hier", "flat"):
            got = r[f"counted_{key}_counters"]
            assert got["calls_by_crossing"] == snaps[key]["calls_by_crossing"], key
            assert got["bytes_by_crossing"] == snaps[key]["bytes_by_crossing"], key
        assert r["counted_hier_counters"]["calls_by_crossing"] == {"dcn": 3, "ici": 3}
        assert r["counted_flat_counters"]["calls_by_crossing"] == {"world": 3}
        # one slice: the flat plane over ici, the same collectives
        assert r["one_slice_counters"]["calls_by_crossing"] == {"ici": sum(r["flat_counters"]["calls_by_kind"].values())}
        assert r["forced_flat_counters"] == r["flat_counters"]


def test_gather_plane_is_flat_rank_order(ranks, eight_devices):
    data, res = ranks
    mesh2, mesh1 = _meshes(eight_devices)
    cat = np.concatenate([data[f"cat{q}"] for q in range(WORLD)])
    stack = np.stack([data[f"stack{q}"] for q in range(WORLD)])
    ref = _jax_sync(mesh2, ("dcn", "ici"), _stacked(data, ("stack",)), {"stack": None})["stack"]
    for r in res:
        assert r["gather_hier"] == r["gather_flat"]  # bit for bit, every state
        np.testing.assert_array_equal(np.asarray(r["gather_hier"]["cat"], np.float32), cat)
        np.testing.assert_array_equal(np.asarray(r["gather_hier"]["stack"], np.float32), stack)
        np.testing.assert_array_equal(np.asarray(r["gather_hier"]["stack"], np.float32), np.asarray(ref))


@pytest.mark.parametrize("name", ["buffer_hier", "buffer_flat", "gather_hier"])
def test_buffer_all_gather_equals_the_jax_package(ranks, eight_devices, name):
    data, res = ranks
    mesh2, mesh1 = _meshes(eight_devices)
    bufs = jbuffer.PaddedBuffer(jnp.asarray(np.stack([data[f"buf{q}"] for q in range(WORLD)])),
                                jnp.asarray(np.arange(WORLD, dtype=np.int32) + 2))
    hierarchical = name != "buffer_flat"
    mesh = mesh2 if hierarchical else mesh1
    axis = ("dcn", "ici") if hierarchical else "dp"

    def body(buf):
        local = jbuffer.PaddedBuffer(buf.data[0], buf.count[0])
        if hierarchical:
            return jsync.sync_value("cat", local, JMeshHierarchy())
        return jbuffer.buffer_all_gather(local, axis)

    spec = P(tuple(axis)) if hierarchical else P(axis)
    ref = jax.jit(compat.shard_map(body, mesh=mesh, in_specs=(spec,), out_specs=P(), check_vma=False))(bufs)
    for r in res:
        got = r[name]["buf"]
        assert got["count"] == int(ref.count) == sum(q + 2 for q in range(WORLD))
        np.testing.assert_array_equal(np.asarray(got["data"], np.float32), np.asarray(ref.data))


def test_slice_leader_gather_keeps_one_copy_a_slice(ranks):
    _, res = ranks
    for r in res:
        assert r["leaders"]["x"] == [3.0] * 3  # slices 1 + 2: one copy each
        assert r["leaders_flat"]["x"] == [6.0] * 3  # every rank's copy
        assert r["leader_gather"] == [[0.0], [2.0]]  # the leaders' rows, in slice order
        counted = r["leaders_counters"]
        assert counted["calls_by_crossing"] == {"dcn": 1} and counted["calls_by_kind"] == {"process_allgather": 1}
        assert counted["bytes_by_crossing"] == {"dcn": 12 * (2 - 1)}  # payload x (slices - 1)
        assert r["leaders_flat_counters"]["bytes_by_crossing"] == {"world": 12 * (WORLD - 1)}


def test_guard_retries_a_dropped_stage(ranks):
    _, res = ranks
    for r in res:
        assert r["guarded_faults"]["sync_retries"] == 1 and r["guarded_faults"]["degraded_computes"] == 0
        assert r["guarded"] == r["hier"]


def test_metric_and_collection_take_a_hierarchy(ranks):
    data, res = ranks
    p = np.concatenate([data[f"p{q}"] for q in range(WORLD)])
    t = np.concatenate([data[f"t{q}"] for q in range(WORLD)])
    want = float(np.mean((p >= 0.5).astype(np.int64) == t))
    for r in res:
        assert r["accuracy"][0] == r["accuracy"][1]
        assert abs(r["accuracy"][0] - want) < 1e-6
        assert r["collection_equal"]
