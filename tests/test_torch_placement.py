"""The topology descriptors, the sparse plane's bitmap and the deferred-check window, against the JAX package.

In this process (no ``torch.distributed`` group; the multi-rank planes run in
``test_torch_sync_hierarchy.py`` and ``test_torch_sync_sparse.py``):

* ``HostHierarchy``: slice count, leaders and ``is_leader`` equal the JAX
  package's for the same process-to-slice maps;
* ``slice_grid`` (the grouping ``hierarchical_mesh`` builds its groups from)
  equals the JAX package's mesh for every slice count of 8 devices, and the
  ragged and indivisible cases raise its errors;
* ``touched_lane_bits`` for worlds 1-40, and ``pack_touched`` /
  ``unpack_touched_counts`` value-equal to the JAX package's ``uint32`` words
  on seeded masks, lane sums included;
* a one-process ``SparseSyncPlane`` against the JAX package's plane on a
  one-device mesh: modes, merged views, the ledger, the fallback warning and
  the constructor's errors;
* the counters' collective formula and sparse ledger against the JAX package's;
* the deferred-check window: AUROC / AP on inputs with no positives, no
  negatives, bad values and a bad ``max_fpr`` raise the JAX package's errors in
  its order (an exception inside the window skips the pending checks);
* the subpackage exports: everything the JAX package's ``parallel`` exports
  but the names that wait for the sharded slice and the in-jit plane.

Tolerances: counts, words and errors are equal; AUROC / AP values from the
same float32 inputs within 1e-6.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import metrics_tpu as mt
import metrics_tpu_torch as pt
from metrics_tpu.observability import counters as jcounters
from metrics_tpu.parallel import placement as jplace
from metrics_tpu.parallel import sparse as jsparse
from metrics_tpu_torch.observability import counters as pcounters
from metrics_tpu_torch.parallel import placement as pplace
from metrics_tpu_torch.parallel import sparse as psparse
from metrics_tpu_torch.utils import checks as pchecks
from tests.test_torch_faults import plane_hygiene  # noqa: F401  (autouse: every test leaves the process clean)

torch.set_num_threads(1)


# ------------------------------------------------------------ the hierarchies
@pytest.mark.parametrize("mapping", [(0,), (0, 0, 1, 1), (1, 1, 0, 0), (0, 1, 0, 1), (2, 0, 2, 1, 1, 0), (5, 5, 5)])
def test_host_hierarchy_leaders_equal_jax(mapping):
    port, ref = pt.parallel.HostHierarchy(mapping), jplace.HostHierarchy(mapping)
    assert port.n_slices == ref.n_slices and port.leaders == ref.leaders
    assert [port.is_leader(p) for p in range(len(mapping) + 1)] == [ref.is_leader(p) for p in range(len(mapping) + 1)]


def test_one_process_hierarchies():
    h = pt.parallel.hierarchical_mesh()
    assert (h.slices, h.per_slice, h.grid, h.size) == (1, 1, ((0,),), 1)
    assert pt.parallel.host_hierarchy() == pt.parallel.HostHierarchy((0,))
    assert pt.parallel.host_hierarchy(slices=[3]).leaders == (0,)
    with pytest.raises(ValueError, match="got 2 slice ids for 1 processes"):
        pt.parallel.host_hierarchy(slices=[0, 1])
    with pytest.raises(ValueError, match="do not split into 2 equal slices"):
        pt.parallel.hierarchical_mesh(slices=2)


@pytest.mark.parametrize("slices", [None, 1, 2, 4, 8])
def test_slice_grid_equals_the_jax_mesh(eight_devices, slices):
    mesh, names = jplace.hierarchical_mesh(eight_devices, slices=slices)
    position = {d.id: i for i, d in enumerate(eight_devices)}
    want = [[position[d.id] for d in row] for row in mesh.devices]
    assert pplace.slice_grid(8, slices) == want
    assert mesh.axis_names == ("dcn", "ici")


class _Dev:
    def __init__(self, slice_index):
        self.slice_index = slice_index


@pytest.mark.parametrize("ids", [(0, 0, 1), (1, 0, 1, 1), (2, 2, 0, 1, 1, 1)])
def test_ragged_slices_raise_as_in_jax(ids):
    with pytest.raises(ValueError) as ref:
        jplace.hierarchical_mesh([_Dev(i) for i in ids])
    with pytest.raises(ValueError) as port:
        pplace.slice_grid(len(ids), slice_ids=ids)
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("slices", [0, 3, 5])
def test_indivisible_slices_raise_as_in_jax(eight_devices, slices):
    with pytest.raises(ValueError) as ref:
        jplace.hierarchical_mesh(eight_devices, slices=slices)
    with pytest.raises(ValueError) as port:
        pplace.slice_grid(8, slices)
    assert str(port.value) == str(ref.value)


def test_slice_ids_group_in_sorted_order():
    assert pplace.slice_grid(6, slice_ids=["b", "a", "b", "c", "a", "c"]) == [[1, 4], [0, 2], [3, 5]]


# --------------------------------------------------------------- the bitmap
@pytest.mark.parametrize("world", list(range(1, 41)))
def test_touched_lane_bits_equal_jax(world):
    assert psparse.touched_lane_bits(world) == jsparse.touched_lane_bits(world)
    assert world < 2 ** psparse.touched_lane_bits(world)


@pytest.mark.parametrize("world, k", [(1, 77), (2, 64), (3, 100), (4, 1000), (7, 33), (8, 77), (16, 250), (17, 31),
                                      (40, 999), (255, 64), (256, 65)])
def test_pack_touched_equals_the_jax_words(world, k):
    rng = np.random.RandomState(world * 1000 + k)
    masks = [rng.rand(k) < 0.3 for _ in range(min(world, 6))]
    ref = [np.asarray(jsparse.pack_touched(jnp.asarray(m), world)) for m in masks]
    port = [psparse.pack_touched(torch.from_numpy(m), world) for m in masks]
    for r, p in zip(ref, port):
        assert p.dtype == torch.int64
        np.testing.assert_array_equal(p.numpy(), r.astype(np.int64))
    summed_ref = np.sum(np.stack(ref), axis=0, dtype=np.uint32)  # the psum of the ranks' words
    summed = torch.stack(port).sum(0)
    np.testing.assert_array_equal(psparse.unpack_touched_counts(summed, k, world),
                                  jsparse.unpack_touched_counts(summed_ref, k, world))
    np.testing.assert_array_equal(psparse.unpack_touched_counts(summed, k, world), np.sum(masks, axis=0))


# ---------------------------------------------------- the one-process plane
N, CAP = 32, 8
_RED = {"hits": "sum", "lo": "min", "hi": "max", "tail": "sum"}
I32 = np.iinfo(np.int32)


def _reset(np_dtype=np.int64):
    return {"hits": np.zeros((N, 3), np_dtype), "lo": np.full((N,), I32.max, np_dtype),
            "hi": np.full((N,), I32.min, np_dtype), "tail": np.zeros((2, 5), np_dtype)}


def _touched(state, rows, salt):
    out = {k: v.copy() for k, v in state.items()}
    idx = np.asarray(rows, np.int64)
    out["hits"][idx] += salt + idx[:, None] * 3
    out["lo"][idx] = np.minimum(out["lo"][idx], salt * 10 + idx)
    out["hi"][idx] = np.maximum(out["hi"][idx], salt * 10 + idx)
    out["tail"] += salt
    return out


def test_one_process_plane_equals_the_jax_plane(eight_devices):
    mesh = Mesh(np.array(eight_devices[:1]), ("dp",))
    jreset = {k: jnp.asarray(v.astype(np.int32)) for k, v in _reset().items()}
    jcounters.reset()
    jplane = jsparse.SparseSyncPlane(jreset, _RED, N, "dp", mesh, capacity=CAP)
    plane = psparse.SparseSyncPlane({k: torch.from_numpy(v) for k, v in _reset().items()}, _RED, N, capacity=CAP)
    state = _reset()
    for rows, salt in (([3, 17, 31], 1), ([], 0), (list(range(10)), 2), ([0, 17], 5)):
        if rows:
            state = _touched(state, rows, salt)
        got = plane.sync({k: torch.from_numpy(v) for k, v in state.items()})
        want = jplane.sync({k: jnp.asarray(v.astype(np.int32)) for k, v in state.items()})
        assert (plane.rounds, plane.fallbacks, plane.skips) == (jplane.rounds, jplane.fallbacks, jplane.skips)
        for k in _RED:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]).astype(np.int64), err_msg=k)
            np.testing.assert_array_equal(got[k].numpy(), state[k], err_msg=k)  # a world of one: the state
    assert pcounters.snapshot()["sparse"] == jcounters.snapshot()["sparse"] == {
        "syncs": 4, "rows": 3 + 0 + 10 + 2, "fallbacks": 1, "skips": 1}
    jcounters.reset()


def test_fallback_warns_once_naming_the_capacity():
    from metrics_tpu_torch.utils import prints

    plane = psparse.SparseSyncPlane({k: torch.from_numpy(v) for k, v in _reset().items()}, _RED, N, capacity=4,
                                    fallback_warn_rounds=2, fallback_warn_fraction=0.4)
    prints._WARN_ONCE_SEEN.clear()
    state = _touched(_reset(), list(range(10)), 1)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # round 1 of 2 stays silent
        plane.sync({k: torch.from_numpy(v) for k, v in state.items()})
    state = _touched(state, list(range(10, 20)), 2)
    with pytest.warns(UserWarning, match=r"sparse_capacity=4"):
        plane.sync({k: torch.from_numpy(v) for k, v in state.items()})
    state = _touched(state, list(range(20, 30)), 3)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # once: a third fallback stays silent
        plane.sync({k: torch.from_numpy(v) for k, v in state.items()})
    assert plane.fallbacks == 3


@pytest.mark.parametrize("case", ["num_rows", "capacity", "empty", "no_rows", "row_reduction", "residual"])
def test_plane_constructor_errors_equal_jax(eight_devices, case):
    mesh = Mesh(np.array(eight_devices[:1]), ("dp",))
    jstate = {k: jnp.asarray(v.astype(np.int32)) for k, v in _reset().items()}
    pstate = {k: torch.from_numpy(v) for k, v in _reset().items()}
    args = {
        "num_rows": lambda s: ((s, _RED, 0), {}),
        "capacity": lambda s: ((s, _RED, N), {"capacity": 0}),
        "empty": lambda s: (({}, {}, N), {}),
        "no_rows": lambda s: (({"tail": s["tail"]}, {"tail": "sum"}, N), {}),
        "row_reduction": lambda s: ((s, {**_RED, "hits": "mean"}, N), {}),
        "residual": lambda s: ((s, {**_RED, "tail": "min"}, N), {"row_leaves": ("hits", "lo", "hi")}),
    }[case]
    (jargs, jkw), (pargs, pkw) = args(jstate), args(pstate)
    with pytest.raises(ValueError) as ref:
        jsparse.SparseSyncPlane(*jargs, "dp", mesh, **jkw)
    with pytest.raises(ValueError) as port:
        psparse.SparseSyncPlane(*pargs, **pkw)
    assert str(port.value) == str(ref.value)


def test_buffer_all_gather_and_overflow_policy_in_one_process():
    buf = pt.parallel.PaddedBuffer(torch.arange(8.0).view(4, 2), torch.tensor(3))
    out = pt.parallel.buffer_all_gather(buf)
    assert torch.equal(out.data, buf.data * (torch.arange(4) < 3)[:, None]) and int(out.count) == 3
    old = pt.parallel.set_overflow_policy("warn_drop")
    try:
        assert pt.parallel.overflow_policy() == "warn_drop"
    finally:
        pt.parallel.set_overflow_policy(old)
    assert pt.parallel.overflow_policy() == old == "error"


# ---------------------------------------------------------------- counters
@pytest.mark.parametrize("fanout", [None, 1, 2, 4, 8])
def test_record_collective_formula_equals_jax(fanout):
    j, p = jcounters.CollectiveCounters(), pcounters.CollectiveCounters()
    for crossing, (jv, pv) in (("ici", (jnp.zeros((5, 3), jnp.float32), torch.zeros(5, 3))),
                               ("dcn", (jnp.zeros(7, jnp.int32), torch.zeros(7, dtype=torch.int32))),
                               ("world", ([jnp.zeros(2, jnp.float32), jnp.zeros(3, jnp.int32)],
                                          [torch.zeros(2), torch.zeros(3, dtype=torch.int32)]))):
        j.record_collective("psum", jv, crossing=crossing, fanout=fanout)
        p.record_collective("psum", pv, crossing=crossing, fanout=fanout)
    js, ps = j.snapshot(), p.snapshot()
    for key in ("collective_calls", "sync_bytes", "calls_by_kind", "bytes_by_kind_dtype", "calls_by_crossing",
                "bytes_by_crossing"):
        assert ps[key] == js[key], key


def test_sparse_ledger_and_gates_equal_jax():
    assert pcounters.SPARSE_KINDS == jcounters.SPARSE_KINDS
    was = pcounters.is_enabled()
    pcounters.disable()
    try:
        pcounters.record_sparse_round(5)  # the ledger records with counting off
        pcounters.record_sparse_fallback()
        pcounters.record_sparse_skip()
        pcounters.record_collective("psum", torch.zeros(3))  # collectives do not
        pcounters.record_states_synced(4)
        snap = pcounters.snapshot()
    finally:
        (pcounters.enable if was else pcounters.disable)()
    assert snap["sparse"] == {"syncs": 1, "rows": 5, "fallbacks": 1, "skips": 1}
    assert snap["collective_calls"] == 0 and snap["states_synced"] == 0
    assert set(snap) <= set(jcounters.snapshot())
    with pytest.raises(ValueError, match="must be >= 0"):
        pcounters.COUNTERS.record_sparse_round(-1)


# ------------------------------------------------- the deferred-check window
def _auroc_case(case):
    rng = np.random.RandomState(11)
    p = rng.rand(16).astype(np.float32)
    if case == "no_negatives":
        return (p, np.ones(16, np.int64)), {}
    if case == "no_positives":
        return (p, np.zeros(16, np.int64)), {}
    if case == "bad_values_no_negatives":
        return (p * 3, np.ones(16, np.int64)), {}
    if case == "bad_max_fpr_and_values":
        return (p * 3, np.ones(16, np.int64)), {"max_fpr": 2.0}
    if case == "multiclass_missing_class":
        q = rng.rand(16, 3).astype(np.float32)
        return (q / q.sum(1, keepdims=True), rng.randint(0, 2, 16).astype(np.int64)), {"num_classes": 3}
    if case == "multilabel_full_column":
        t = rng.randint(0, 2, (16, 3)).astype(np.int64)
        t[:, 1] = 1
        return (rng.rand(16, 3).astype(np.float32), t), {"num_classes": 3}
    return (p, rng.randint(0, 2, 16).astype(np.int64)), {}


def _outcome(fn):
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return ("value", float(np.nanmean(np.asarray(fn(), dtype=np.float64))))
    except (ValueError, RuntimeError, IndexError) as err:
        return (type(err).__name__, str(err))


@pytest.mark.parametrize("fn", ["auroc", "average_precision"])
@pytest.mark.parametrize("case", ["clean", "no_negatives", "no_positives", "bad_values_no_negatives",
                                  "bad_max_fpr_and_values", "multiclass_missing_class", "multilabel_full_column"])
def test_deferred_window_errors_equal_jax(fn, case):
    (p, t), kw = _auroc_case(case)
    if fn == "average_precision":
        kw = {k: v for k, v in kw.items() if k != "max_fpr"}
    jt = t.astype(np.int32)
    ref = _outcome(lambda: getattr(mt.functional, fn)(jnp.asarray(p), jnp.asarray(jt), **kw))
    port = _outcome(lambda: getattr(pt.functional, fn)(torch.from_numpy(p), torch.from_numpy(t), **kw))
    assert port[0] == ref[0], (port, ref)
    if ref[0] == "value":
        np.testing.assert_allclose(port[1], ref[1], rtol=1e-6)
    else:
        assert port[1] == ref[1]


def test_window_postpones_checks_and_an_exception_skips_them():
    seen = []
    with pchecks.deferred_value_checks():
        pchecks.defer_or_run_value_check(lambda: seen.append(1))
        with pchecks.deferred_value_checks():  # a nested window runs its own at its end
            pchecks.defer_or_run_value_check(lambda: seen.append(2))
        assert seen == [2]
        pchecks.defer_or_run_value_check(lambda: seen.append(3))
        assert seen == [2]
    assert seen == [2, 1, 3]
    with pytest.raises(KeyError):
        with pchecks.deferred_value_checks():
            pchecks.defer_or_run_value_check(lambda: seen.append(4))
            raise KeyError("inside")
    assert seen == [2, 1, 3]  # the exception skipped the pending check
    y = torch.ones(8, dtype=torch.int32)
    from metrics_tpu_torch.functional.classification.auroc import _check_pos_neg_eager

    with pytest.raises(ValueError, match="No negative samples"):
        with pchecks.deferred_value_checks():
            _check_pos_neg_eager(y)  # postponed: nothing raises here
            seen.append(5)
    assert seen[-1] == 5


# ----------------------------------------------------------------- exports
# JAX exports of ``metrics_tpu.parallel`` that the port does not have yet, with their reason
_LEFT_OUT = {
    # the in-jit plane over a named mesh axis: the port has no mesh (its plane is all_reduce_state)
    "coalesced_sync_state", "gather_all_arrays", "mesh_hierarchy", "sync_state", "sync_value",
}


def test_parallel_exports_what_jax_exports_but_the_left_out_names():
    import metrics_tpu.parallel as jpar
    import metrics_tpu_torch.parallel as ppar

    public = {n for n in dir(jpar) if not n.startswith("_") and not isinstance(getattr(jpar, n), type(jpar))}
    missing = sorted(n for n in public if not hasattr(ppar, n))
    assert missing == sorted(_LEFT_OUT & public), missing
    for name in ("MeshHierarchy", "hierarchical_mesh", "HostHierarchy", "host_hierarchy", "slice_leader_gather",
                 "SparseSyncPlane", "pack_touched", "touched_lane_bits", "unpack_touched_counts",
                 "deferred_sparse_sync", "buffer_all_gather", "overflow_policy",
                 # the sharded slice: the placement policies and the sharded epoch engines
                 "batch_sharded", "class_sharded", "row_sharded", "regroup_by_query", "sharded_auroc",
                 "sharded_auroc_matrix", "sharded_average_precision", "sharded_average_precision_matrix",
                 "sharded_clf_curve_matrix", "sharded_kendall", "sharded_rank", "sharded_retrieval_sums",
                 "sharded_spearman"):
        assert hasattr(jpar, name) and hasattr(ppar, name), name
    for cls in (pt.Keyed, pt.HeavyHitters, pt.Windowed):
        assert callable(getattr(cls, "sparse_plane")) and callable(getattr(getattr(mt, cls.__name__), "sparse_plane"))
