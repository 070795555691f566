"""The sparse delta-sync plane across real processes (Gloo), against the JAX package's plane.

Four ranks over ``torch.distributed`` (Gloo, a FileStore under ``tmp_path``),
flat and as a ``MeshHierarchy`` of 2 slices of 2. Each rank's state follows a
seeded schedule made here: a hand-built slab state with every row fold
(``sum`` rows, ``min`` / ``max`` rows) and a dense residual, at its reset fill,
then five rounds: each rank's own rows (sparse), no change (skip), a union
beyond the capacity (fallback), one row a rank, two rows and the residual.
The same per-rank states go through the JAX package's
``SparseSyncPlane(stacked=True)`` on a flat 4-device mesh and a ``(2, 2)``
``("dcn", "ici")`` mesh of the conftest's virtual CPU devices:

* each round's mode, merged view and ledger equal the JAX plane's, flat and
  two-level, with and without a ``touched=`` hint (the hinted plane equals the
  unhinted one), and the merged view equals the dense bucketed sync;
* the staged collectives are 2 a round flat and 4 two-level, at K = 1,000 and
  K = 10,000 alike;
* ``Keyed`` / ``HeavyHitters`` / ``Windowed`` ``sparse_plane`` rounds equal the
  dense sync bit for bit, and HeavyHitters' tails ride the bitmap collective.

Three ranks run the chaos site ``"sparse_sync"`` with the JAX package's
verdicts (``tests/parallel/test_sparse.py``): a drop x2 is retried twice to
the dense result, on every rank or on one rank alone; a stall past the
deadline on one rank is retried; a corruption injected on one rank only is
retried once on every rank; exhaustion degrades to the local state (nothing
committed, the next clean round equal to the dense result) or raises, on
every rank alike. ``deferred_sparse_sync`` resolves to the synchronous
round's merged view, in order with the synchronous rounds.

Every child is killed if it outlives its timeout; this process never joins a
group. Tolerances: the states are integers, compared exactly.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from metrics_tpu.observability import counters as jcounters
from metrics_tpu.parallel.sparse import SparseSyncPlane as JSparseSyncPlane
from tests.test_torch_faults import plane_hygiene  # noqa: F401  (autouse: every test leaves the process clean)

torch.set_num_threads(1)

_REPO = Path(__file__).resolve().parents[1]
N, CAP = 32, 8
I32 = np.iinfo(np.int32)
REDUCTIONS = {"hits": "sum", "lo": "min", "hi": "max", "tail": "sum"}
MODES = ("sparse", "skip", "fallback", "sparse", "sparse")


def _reset():
    return {"hits": np.zeros((N, 3), np.int64), "lo": np.full((N,), I32.max, np.int64),
            "hi": np.full((N,), I32.min, np.int64), "tail": np.zeros((2, 5), np.int64)}


def _touch(state, rows, salt):
    out = {k: v.copy() for k, v in state.items()}
    idx = np.asarray(rows, np.int64)
    if idx.size:
        out["hits"][idx] += salt + idx[:, None] * 3
        out["lo"][idx] = np.minimum(out["lo"][idx], salt * 10 + idx)
        out["hi"][idx] = np.maximum(out["hi"][idx], salt * 10 + idx)
    out["tail"] += salt
    return out


def _round_rows(rnd, r):
    """The rows rank ``r`` touches in round ``rnd`` (``None``: no change at all)."""
    return [[2 * r, 2 * r + 1], None, list(range(8 + r, 18)), [20 + r], [3, 17] if r % 2 == 0 else []][rnd]


def _schedule(world):
    """Per round, per rank: the current state and the touched rows."""
    states = [_reset() for _ in range(world)]
    rounds = []
    for rnd in range(len(MODES)):
        cur = []
        for r in range(world):
            rows = _round_rows(rnd, r)
            if rows is not None:
                states[r] = _touch(states[r], rows, salt=rnd + r + 1)
            cur.append((states[r], rows or []))
        rounds.append(cur)
    return rounds


_WORKER = textwrap.dedent("""
    import json, sys, time, warnings
    import numpy as np, torch, torch.distributed as dist
    sys.path.insert(0, sys.argv[4])
    import metrics_tpu_torch as pt
    from metrics_tpu_torch.observability import counters
    from metrics_tpu_torch.parallel import faults, sync
    from metrics_tpu_torch.parallel.deferred import deferred_sparse_sync
    from metrics_tpu_torch.parallel.slab import slab_touched_mask
    from metrics_tpu_torch.parallel.sparse import SparseSyncPlane, _payload_of
    from metrics_tpu_torch.utils.exceptions import StateCorruptionError, SyncTimeoutError

    warnings.simplefilter("ignore")
    rank, store, out, world, mode = int(sys.argv[1]), sys.argv[2], sys.argv[3], int(sys.argv[6]), sys.argv[7]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=world)
    data = np.load(sys.argv[5])
    red = {"hits": "sum", "lo": "min", "hi": "max", "tail": "sum"}
    N, CAP, ROUNDS = int(data["N"]), int(data["CAP"]), int(data["ROUNDS"])
    reset = {k: torch.from_numpy(data[f"reset_{k}"]) for k in red}

    def current(rnd):
        return {k: torch.from_numpy(data[f"r{rnd}_{rank}_{k}"]) for k in red}

    def hint(rnd):
        return slab_touched_mask(torch.from_numpy(data[f"r{rnd}_{rank}_rows"]), N)

    def host(state):
        return {k: _payload_of(v).tolist() for k, v in state.items()}

    def equal(a, b):
        return all(torch.equal(_payload_of(a[k]), _payload_of(b[k])) for k in a)

    res = {}
    if mode == "parity":
        h = pt.parallel.hierarchical_mesh(slices=2)
        for label, group in (("flat", None), ("hier", h)):
            counters.reset()
            plane = SparseSyncPlane(reset, red, N, group, capacity=CAP)
            hinted = SparseSyncPlane(reset, red, N, group, capacity=CAP)
            rounds, same = [], []
            for rnd in range(ROUNDS):
                merged = plane.sync(current(rnd))
                rounds.append({"merged": host(merged), "modes": [plane.rounds, plane.fallbacks, plane.skips],
                               "dense": equal(merged, sync.all_reduce_state(current(rnd), red))})
                snap = counters.snapshot()
                same.append(equal(hinted.sync(current(rnd), touched=hint(rnd)), merged))
                counters.COUNTERS.sparse.update(snap["sparse"])  # the ledger of the unhinted plane alone
            res[label] = {"rounds": rounds, "hinted_equal": same, "ledger": counters.snapshot()["sparse"]}
            # the staged collectives of one sparse round at K = 1,000 and K = 10,000
            for k in (1000, 10000):
                state = {"hits": torch.zeros(k, 3, dtype=torch.int64), "tail": torch.zeros(2, 5, dtype=torch.int64)}
                p = SparseSyncPlane(state, {"hits": "sum", "tail": "sum"}, k, group, capacity=64)
                cur = {"hits": state["hits"].clone(), "tail": state["tail"] + 1}
                cur["hits"][rank * 7: rank * 7 + 5] += 1
                counters.reset()
                counters.enable()
                p.sync(cur)
                res[label][f"calls_{k}"] = counters.snapshot()["calls_by_kind"]
                counters.disable()
        # the wrappers' planes against the dense sync
        rng = np.random.RandomState(50 + rank)
        keyed = pt.Keyed(pt.AUROC(approx="sketch", num_bins=16, device="cpu"), num_slots=64)
        kp = keyed.sparse_plane(capacity=16)
        hh = pt.HeavyHitters(pt.Accuracy(device="cpu"), num_hot_slots=8, tail=(2, 32))
        hp = hh.sparse_plane(capacity=8)
        win = pt.Windowed(pt.Accuracy(device="cpu"), window_s=10.0, num_windows=4)
        wp = win.sparse_plane()
        wrappers = {"keyed": [], "hh": [], "windowed": [], "hh_dense_names": list(hp._dense_names),
                    "windowed_capacity": wp.capacity, "hh_calls": None}
        for step in range(3):
            slots = torch.from_numpy(rng.choice(64, 3, replace=False)[rng.randint(0, 3, 30)] + 0)
            keyed.update(torch.rand(30), torch.randint(0, 2, (30,)), slot=slots)
            cur = keyed._current_state()
            wrappers["keyed"].append(equal(kp.sync(cur, touched=slab_touched_mask(slots, 64)),
                                           sync.all_reduce_state(cur, keyed._reductions)))
            keys = [f"seg{(i * (rank + 1) + step) % 20}" for i in range(40)]
            hh.update(torch.rand(40), torch.randint(0, 2, (40,)), key=keys)
            cur = hh._current_state()
            counters.reset()
            counters.enable()
            merged = hp.sync(cur)
            wrappers["hh_calls"] = counters.snapshot()["calls_by_kind"]
            counters.disable()
            wrappers["hh"].append(equal(merged, sync.all_reduce_state(cur, hh._reductions)))
            times = torch.from_numpy(rng.uniform(10.0 * step, 10.0 * step + 12.0, 25).astype(np.float32))
            win.update(torch.rand(25), torch.randint(0, 2, (25,)), event_time=times)
            cur = win._current_state()
            wrappers["windowed"].append(equal(wp.sync(cur), sync.all_reduce_state(cur, win._reductions)))
        res["wrappers"] = wrappers
    else:
        dense = [sync.all_reduce_state(current(r), red) for r in range(ROUNDS)]

        def scenario(name, guard, specs, rnd=0, on_ranks=None):
            counters.reset()
            plane = SparseSyncPlane(reset, red, N, capacity=CAP, guard=guard)
            mine = [faults.FaultSpec(site="sparse_sync", **s) for s in specs] if on_ranks is None or rank in on_ranks else []
            inj = faults.ChaosInjector(mine, seed=3)
            t0 = time.perf_counter()
            with inj:
                try:
                    merged = plane.sync(current(rnd))
                    got = {"dense": equal(merged, dense[rnd]), "local": equal(merged, current(rnd))}
                except (SyncTimeoutError, StateCorruptionError) as err:
                    got = {"raised": type(err).__name__}
            got.update(faults=counters.snapshot()["faults"], injected=dict(inj.injected), rounds=plane.rounds,
                       s=time.perf_counter() - t0)
            if "raised" not in got and not got["dense"]:  # degraded: nothing committed, a clean round re-offers
                got["after"] = equal(plane.sync(current(rnd)), dense[rnd])
            res[name] = got

        g = lambda **kw: sync.SyncGuard(backoff_s=0.0, **kw)
        scenario("drop2", g(max_retries=2), [dict(kind="drop", call=0, times=2)])
        scenario("drop2_one_rank", g(max_retries=2), [dict(kind="drop", call=0, times=2)], on_ranks=(1,))
        scenario("stall_one_rank", g(deadline_s=0.25, max_retries=2), [dict(kind="stall", call=0, times=1,
                                                                          duration_s=1.2)], on_ranks=(2,))
        scenario("corrupt_one_rank", g(max_retries=2, check_finite=True), [dict(kind="corrupt", call=0, times=1)],
                 on_ranks=(1,))
        scenario("corrupt_fallback", g(max_retries=2, check_finite=True), [dict(kind="corrupt", call=0, times=1)],
                 rnd=2, on_ranks=(0,))
        scenario("corrupt_exhausted", g(max_retries=1, check_finite=True), [dict(kind="corrupt", call=0, times=5)],
                 on_ranks=(1,))
        scenario("degrade", g(max_retries=1, policy="degrade"), [dict(kind="drop", call=0, times=5)])
        scenario("degrade_one_rank", g(max_retries=1, policy="degrade"), [dict(kind="drop", call=0, times=5)],
                 on_ranks=(0,))
        scenario("raise", g(max_retries=1), [dict(kind="drop", call=0, times=5)])

        # the deferred round, in order with the synchronous ones
        counters.reset()
        counters.enable()
        plane = SparseSyncPlane(reset, red, N, capacity=CAP)
        first = plane.sync_deferred(current(0), watermark=7)
        live = current(0)
        state1 = {k: v.clone() for k, v in current(1).items()}
        handle = deferred_sparse_sync(plane, state1, touched=hint(1))
        for v in state1.values():
            v.add_(1000)  # the caller writes in place after dispatch: the round holds a copy
        r0 = {k: _payload_of(v).clone() for k, v in first.result().items()}
        r1 = handle.result()
        r1 = {k: _payload_of(v).clone() for k, v in r1.items()}
        third = plane.sync(current(2))
        res["deferred"] = {"first": equal(r0, dense[0]), "second": equal(r1, dense[1]), "third": equal(third, dense[2]),
                           "label": first.label, "watermark": first.watermark, "rounds": plane.rounds,
                           "lifecycle": counters.snapshot()["deferred"]}
        counters.disable()
    json.dump(res, open(out, "w"))
    dist.destroy_process_group()
""")


def _launch(tmp, world, mode, data):
    np.savez(tmp / "data.npz", **data)
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    procs = [
        subprocess.Popen([sys.executable, str(script), str(r), str(tmp / "store"), str(tmp / f"out{r}.json"),
                          str(_REPO), str(tmp / "data.npz"), str(world), mode],
                         env=dict(os.environ, OMP_NUM_THREADS="1"), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for r in range(world)
    ]
    try:
        logs = [p.communicate(timeout=150)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0] * world, logs
    return [json.loads((tmp / f"out{r}.json").read_text()) for r in range(world)]


def _data(world):
    data = {"N": N, "CAP": CAP, "ROUNDS": len(MODES)}
    data.update({f"reset_{k}": v for k, v in _reset().items()})
    for rnd, per_rank in enumerate(_schedule(world)):
        for r, (state, rows) in enumerate(per_rank):
            data.update({f"r{rnd}_{r}_{k}": v for k, v in state.items()})
            data[f"r{rnd}_{r}_rows"] = np.asarray(rows, np.int64)
    return data


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    return _launch(tmp_path_factory.mktemp("sparse4"), 4, "parity", _data(4))


@pytest.fixture(scope="module")
def chaos(tmp_path_factory):
    return _launch(tmp_path_factory.mktemp("sparse3"), 3, "chaos", _data(3))


@pytest.fixture(scope="module")
def jax_rounds(eight_devices):
    """The JAX package's stacked plane over the same per-rank states, flat and (2, 2)."""
    devices = np.array(eight_devices[:4])
    out = {}
    schedule = _schedule(4)
    reset = {k: jnp.asarray(v.astype(np.int32)) for k, v in _reset().items()}
    stacked_reset = {k: jnp.broadcast_to(v, (4,) + v.shape) for k, v in reset.items()}
    for label, mesh, axis in (("flat", Mesh(devices, ("dp",)), "dp"),
                              ("hier", Mesh(devices.reshape(2, 2), ("dcn", "ici")), ("dcn", "ici"))):
        jcounters.reset()
        plane = JSparseSyncPlane(stacked_reset, REDUCTIONS, N, axis, mesh, capacity=CAP, stacked=True)
        plane.rebase(stacked_reset, merged=reset)
        rounds = []
        for per_rank in schedule:
            current = {k: jnp.asarray(np.stack([s[k] for s, _ in per_rank]).astype(np.int32)) for k in REDUCTIONS}
            merged = plane.sync(current)
            rounds.append({"merged": {k: np.asarray(v).astype(np.int64) for k, v in merged.items()},
                           "modes": [plane.rounds, plane.fallbacks, plane.skips]})
        out[label] = {"rounds": rounds, "ledger": jcounters.snapshot()["sparse"]}
    jcounters.reset()
    return out


@pytest.mark.parametrize("label", ["flat", "hier"])
def test_rounds_equal_the_jax_plane(parity, jax_rounds, label):
    ref = jax_rounds[label]
    assert [r["modes"] for r in ref["rounds"]] == [[1, 0, 0], [2, 0, 1], [3, 1, 1], [4, 1, 1], [5, 1, 1]]
    for res in parity:
        got = res[label]
        for rnd, (g, want) in enumerate(zip(got["rounds"], ref["rounds"])):
            assert g["modes"] == want["modes"], (label, rnd)
            assert g["dense"], (label, rnd)  # the merged view is the dense bucketed sync
            for k in REDUCTIONS:
                np.testing.assert_array_equal(np.asarray(g["merged"][k], np.int64), want["merged"][k],
                                              err_msg=f"{label} round {rnd} {k}")
        assert got["ledger"] == ref["ledger"], label


@pytest.mark.parametrize("label", ["flat", "hier"])
def test_hint_equals_the_full_compare(parity, label):
    for res in parity:
        assert res[label]["hinted_equal"] == [True] * len(MODES)


@pytest.mark.parametrize("label, k", [("flat", 1000), ("flat", 10000), ("hier", 1000), ("hier", 10000)])
def test_staged_collectives_do_not_grow_with_k(parity, label, k):
    want = {"psum": 1, "all_gather": 1} if label == "flat" else {"psum": 2, "all_gather": 2}
    for res in parity:
        assert res[label][f"calls_{k}"] == want


@pytest.mark.parametrize("wrapper", ["keyed", "hh", "windowed"])
def test_wrapper_planes_equal_the_dense_sync(parity, wrapper):
    for res in parity:
        w = res["wrappers"]
        assert w[wrapper] == [True] * 3
        assert w["windowed_capacity"] == 4
        assert w["hh_dense_names"] == ["Accuracy_tail", "hh_tail_rows"] or all(
            n.endswith("_tail") or n == "hh_tail_rows" for n in w["hh_dense_names"])
        assert w["hh_calls"] == {"psum": 1, "all_gather": 1}  # the tails ride the bitmap collective


_ZERO = {"sync_retries": 0, "sync_deadline_exceeded": 0, "degraded_computes": 0, "quarantined_updates": 0}


@pytest.mark.parametrize("name, retries", [("drop2", 2), ("drop2_one_rank", 2), ("stall_one_rank", 1),
                                           ("corrupt_one_rank", 1), ("corrupt_fallback", 1)])
def test_chaos_retries_to_the_dense_result_on_every_rank(chaos, name, retries):
    for r, res in enumerate(chaos):
        got = res[name]
        assert got["dense"] and got["rounds"] == 1, (name, r)
        assert got["faults"] == dict(_ZERO, sync_retries=retries), (name, r)
    if name == "drop2":
        assert all(res[name]["injected"]["drop"] == 2 for res in chaos)
    if name.endswith("one_rank") or name == "corrupt_fallback":
        kinds = {"drop2_one_rank": "drop", "stall_one_rank": "stall"}.get(name, "corrupt")
        injected = [res[name]["injected"][kinds] for res in chaos]
        assert sorted(injected) == [0, 0, 2 if kinds == "drop" else 1], injected  # one rank's fault, every rank's retry


@pytest.mark.parametrize("name", ["degrade", "degrade_one_rank"])
def test_chaos_exhaustion_degrades_on_every_rank(chaos, name):
    for r, res in enumerate(chaos):
        got = res[name]
        assert got["local"] and not got["dense"] and got["rounds"] == 0, r  # the local view, nothing committed
        assert got["faults"] == dict(_ZERO, sync_retries=2, sync_deadline_exceeded=1, degraded_computes=1), r
        assert got["after"], r  # a clean round offers the same deltas again


@pytest.mark.parametrize("name, raised", [("raise", "SyncTimeoutError"), ("corrupt_exhausted", "StateCorruptionError")])
def test_chaos_exhaustion_raises_on_every_rank(chaos, name, raised):
    for res in chaos:
        assert res[name]["raised"] == raised
        assert res[name]["faults"]["sync_deadline_exceeded"] == 1 and res[name]["rounds"] == 0


def test_deferred_sparse_sync_resolves_to_the_round(chaos):
    for res in chaos:
        d = res["deferred"]
        assert d["first"] and d["second"] and d["third"]
        assert d["label"] == "sparse_sync" and d["watermark"] == 7 and d["rounds"] == 3
        assert d["lifecycle"] == {"dispatched": 2, "fenced": 2, "completed": 2}
