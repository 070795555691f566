"""MetricCollection: the port against the JAX package, and a real two-rank sync.

* The main-path collection ``[Accuracy, F1, Precision, Recall]`` (macro,
  C = 32) and the binned collection ``[BinnedAUROC, BinnedAveragePrecision]``:
  per-step forward values and the epoch compute equal the JAX package's on the
  same numpy batches. Classification values agree to rtol 1e-6 and the binned
  AUROC / AP to rtol 1e-5 (sums taken in another order); counts are equal.
* Compute groups run one update per group per step.
* ``dist_sync_on_step`` through a fake two-rank ``dist_sync_fn``, the same
  fake on both sides.
* Two real processes over ``torch.distributed`` (Gloo, a FileStore under
  ``tmp_path``): the synced values on both ranks equal one process over the
  concatenated data.
* ``state_dict`` carried across: half an epoch in one package, the rest in the
  other, equal to one package over all batches (both directions).
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

import metrics_tpu as mt
import metrics_tpu_torch as pt
from metrics_tpu_torch.classification.stat_scores import StatScores

torch.set_num_threads(1)

C = 32
_RTOL = {"Accuracy": 1e-6, "F1": 1e-6, "Precision": 1e-6, "Recall": 1e-6,
         "BinnedAUROC": 1e-5, "BinnedAveragePrecision": 1e-5}
_REPO = Path(__file__).resolve().parents[1]


def _main_path(pkg, **kw):
    extra = {"device": "cpu"} if pkg is pt else {}
    return pkg.MetricCollection([
        pkg.Accuracy(**kw, **extra),
        pkg.F1(num_classes=C, average="macro", **kw, **extra),
        pkg.Precision(num_classes=C, average="macro", **kw, **extra),
        pkg.Recall(num_classes=C, average="macro", **kw, **extra),
    ])


def _binned(pkg, **kw):
    extra = {"device": "cpu"} if pkg is pt else {}
    return pkg.MetricCollection([
        pkg.BinnedAUROC(thresholds=64, **kw, **extra),
        pkg.BinnedAveragePrecision(thresholds=64, **kw, **extra),
    ])


def _batches(kind, steps=4, n=64, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        if kind == "main":
            logits = rng.randn(n, C)
            probs = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(np.float32)
            out.append((probs, rng.randint(0, C, n)))
        else:
            out.append((rng.rand(n).astype(np.float32), rng.randint(0, 2, n)))
    return out


def _assert_values(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=_RTOL[k], atol=0, err_msg=k)


@pytest.mark.parametrize("kind,build", [("main", _main_path), ("binned", _binned)])
def test_collection_forward_and_compute_match_jax(kind, build):
    ref, port = build(mt), build(pt)
    assert port.compute_groups == ref.compute_groups
    for preds, target in _batches(kind):
        _assert_values(port(torch.from_numpy(preds), torch.from_numpy(target)),
                       ref(jnp.asarray(preds), jnp.asarray(target)))
    _assert_values(port.compute(), ref.compute())
    port.reset()
    ref.reset()
    preds, target = _batches(kind, steps=1, seed=9)[0]
    _assert_values(port(torch.from_numpy(preds), torch.from_numpy(target)),
                   ref(jnp.asarray(preds), jnp.asarray(target)))
    _assert_values(port.compute(), ref.compute())


@pytest.mark.parametrize("compute_groups,updates_per_step", [(True, 1), (False, 3)])
def test_one_update_per_compute_group(monkeypatch, compute_groups, updates_per_step):
    calls = []
    original = StatScores.update

    def counting_update(self, preds, target):
        calls.append(type(self).__name__)
        return original(self, preds, target)

    monkeypatch.setattr(StatScores, "update", counting_update)
    col = _main_path(pt)
    col = pt.MetricCollection(dict(col.items()), compute_groups=compute_groups)
    assert col.compute_groups == ({"Accuracy": ("Accuracy",), "F1": ("F1", "Precision", "Recall")}
                                  if compute_groups else {k: (k,) for k in col})
    batches = _batches("main", steps=3)
    for preds, target in batches:
        col(torch.from_numpy(preds), torch.from_numpy(target))
    assert len(calls) == 3 * updates_per_step
    col.update(*(torch.from_numpy(x) for x in batches[0]))
    assert len(calls) == 4 * updates_per_step
    # every member of the group holds the same accumulated counts
    assert torch.equal(col["F1"].tp, col["Recall"].tp) and torch.equal(col["F1"].fp, col["Precision"].fp)


class _FakeWorld:
    """fn(x) -> [x, other]: a two-rank world whose other rank holds ``x // 2 + 1``
    (a different, data-dependent state), counting its calls."""

    def __init__(self):
        self.calls = 0

    def __call__(self, x):
        self.calls += 1
        return [x, x // 2 + 1]


@pytest.mark.parametrize("kind,build", [("main", _main_path), ("binned", _binned)])
def test_dist_sync_on_step_with_fake_world_matches_jax(kind, build):
    ref_world, port_world = _FakeWorld(), _FakeWorld()
    ref = build(mt, dist_sync_on_step=True, dist_sync_fn=ref_world)
    port = build(pt, dist_sync_on_step=True, dist_sync_fn=port_world)
    plain = build(pt)
    for preds, target in _batches(kind, steps=3):
        got = port(torch.from_numpy(preds), torch.from_numpy(target))
        _assert_values(got, ref(jnp.asarray(preds), jnp.asarray(target)))
        unsynced = plain(torch.from_numpy(preds), torch.from_numpy(target))
        assert any(not torch.equal(got[k], unsynced[k]) for k in got)  # the sync changed the values
    assert port_world.calls == ref_world.calls  # one shared sync per group per step
    _assert_values(port.compute(), ref.compute())


def test_cat_state_sync_through_fake_world_matches_jax():
    """List (cat) states gather element-major through a ``dist_sync_fn``, as in the JAX package."""
    ref = mt.StatScores(reduce="samples", dist_sync_on_step=True, dist_sync_fn=_FakeWorld())
    port = pt.StatScores(reduce="samples", dist_sync_on_step=True, dist_sync_fn=_FakeWorld(), device="cpu")
    rng = np.random.RandomState(4)
    for _ in range(2):
        preds, target = rng.rand(6, 3).astype(np.float32), rng.randint(0, 2, (6, 3))
        np.testing.assert_array_equal(port(torch.from_numpy(preds), torch.from_numpy(target)).numpy(),
                                      np.asarray(ref(jnp.asarray(preds), jnp.asarray(target))))
    np.testing.assert_array_equal(port.compute().numpy(), np.asarray(ref.compute()))


_WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np, torch, torch.distributed as dist
    sys.path.insert(0, {repo!r})
    import metrics_tpu_torch as pt
    rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=2)
    batches = json.load(open({data!r}))
    result = {{}}
    for kind in ("main", "binned"):
        if kind == "main":
            col = pt.MetricCollection([m(dist_sync_on_step=True, device="cpu", **kw) for m, kw in (
                (pt.Accuracy, {{}}), (pt.F1, {{"num_classes": {c}, "average": "macro"}}),
                (pt.Precision, {{"num_classes": {c}, "average": "macro"}}),
                (pt.Recall, {{"num_classes": {c}, "average": "macro"}}))])
        else:
            col = pt.MetricCollection([pt.BinnedAUROC(thresholds=64, dist_sync_on_step=True, device="cpu"),
                                       pt.BinnedAveragePrecision(thresholds=64, dist_sync_on_step=True, device="cpu")])
        steps = []
        for preds, target in batches[kind][rank]:
            values = col(torch.tensor(preds, dtype=torch.float32), torch.tensor(target))
            steps.append({{k: v.item() for k, v in values.items()}})
        result[kind] = {{"steps": steps, "epoch": {{k: v.item() for k, v in col.compute().items()}}}}
    # the bucketed all_reduce: one call per (dtype, op) bucket, mean = sum / world
    from metrics_tpu_torch.parallel.sync import all_reduce_state
    calls = []
    real = dist.all_reduce
    dist.all_reduce = lambda t, *a, **k: (calls.append(str(t.dtype)), real(t, *a, **k))[1]
    state = {{"a": torch.tensor([rank, 1]), "b": torch.tensor(rank + 2), "c": torch.tensor([rank * 1.0, 4.0]),
             "d": torch.tensor(0.5 + rank), "e": torch.tensor([rank + 0.25]), "f": torch.tensor(10 - rank)}}
    fx = {{"a": "sum", "b": "sum", "c": "mean", "d": "sum", "e": "min", "f": "max"}}
    synced = all_reduce_state(state, fx)
    dist.all_reduce = real
    result["buckets"] = sorted(calls)
    result["synced"] = {{k: v.tolist() for k, v in synced.items()}}
    result["local_kept"] = state["a"].tolist() == [rank, 1]
    cat = pt.StatScores(reduce="samples", device="cpu")
    cat.update(torch.tensor([0.2, 0.8 - 0.5 * rank]), torch.tensor([0, 1]))
    result["cat_sync"] = cat.compute().tolist()
    json.dump(result, open(out, "w"))
    dist.destroy_process_group()
""")


def test_two_process_gloo_sync_equals_one_process(tmp_path):
    per_rank = {kind: [_batches(kind, steps=3, n=32, seed=10 + r) for r in range(2)] for kind in ("main", "binned")}
    data = tmp_path / "batches.json"
    data.write_text(json.dumps({k: [[[p.tolist(), t.tolist()] for p, t in r] for r in v] for k, v in per_rank.items()}))
    script = tmp_path / "worker.py"
    script.write_text(_WORKER.format(repo=str(_REPO), data=str(data), c=C))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen([sys.executable, str(script), str(r), str(tmp_path / "store"), str(tmp_path / f"out{r}.json")],
                         env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)
    ]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], logs
    results = [json.loads((tmp_path / f"out{r}.json").read_text()) for r in range(2)]

    for kind, build in (("main", _main_path), ("binned", _binned)):
        single = build(pt)
        for step in range(3):
            preds = np.concatenate([per_rank[kind][r][step][0] for r in range(2)])
            target = np.concatenate([per_rank[kind][r][step][1] for r in range(2)])
            want = single(torch.from_numpy(preds), torch.from_numpy(target))
            for r in range(2):
                for k, v in want.items():
                    np.testing.assert_allclose(results[r][kind]["steps"][step][k], v.item(), rtol=_RTOL[k], err_msg=k)
        for r in range(2):
            for k, v in single.compute().items():
                np.testing.assert_allclose(results[r][kind]["epoch"][k], v.item(), rtol=_RTOL[k], err_msg=k)

    for r in range(2):
        assert results[r]["buckets"] == ["torch.float32", "torch.float32", "torch.int64", "torch.int64"]
        assert results[r]["synced"] == {"a": [1, 2], "b": 5, "c": [0.5, 4.0], "d": 2.0, "e": [0.25], "f": 10}
        assert results[r]["local_kept"]
    # the cat (list) state gathers across the ranks: equal to one process over both ranks' batches in rank order
    cat = pt.StatScores(reduce="samples", device="cpu")
    for r in range(2):
        cat.update(torch.tensor([0.2, 0.8 - 0.5 * r]), torch.tensor([0, 1]))
    for r in range(2):
        assert results[r]["cat_sync"] == cat.compute().tolist()


@pytest.mark.parametrize("kind,build", [("main", _main_path), ("binned", _binned)])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_state_dict_carried_across_packages(kind, build, direction):
    batches = _batches(kind, steps=4, seed=3)
    full = build(mt)
    for preds, target in batches:
        full(jnp.asarray(preds), jnp.asarray(target))

    ref, port = build(mt), build(pt)
    ref.persistent(True)
    port.persistent(True)
    first, second = (ref, port) if direction == "jax_to_port" else (port, ref)
    for preds, target in batches[:2]:
        first(*(_as(first, x) for x in (preds, target)))
    saved = first.state_dict()
    if kind == "main":  # the group manifest rides the checkpoint: one copy of the StatScores group
        assert saved["_compute_group_manifest"] == {"Precision": "F1", "Recall": "F1"}
        assert "Precision.tp" not in saved and "F1.tp" in saved
    second.load_state_dict(saved)
    for preds, target in batches[2:]:
        second(*(_as(second, x) for x in (preds, target)))
    got = {k: torch.as_tensor(np.asarray(v)) for k, v in second.compute().items()}
    _assert_values(got, full.compute())
    for name, m in second.items():
        assert m._epoch_watermark == 4 and m._count_bound == full[name]._count_bound


def _as(collection, x):
    return torch.from_numpy(x) if isinstance(collection, pt.MetricCollection) else jnp.asarray(x)


# ------------------------------------------------ clone, repr, the pure view and forward_batched
def _assert_prefixed(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=0, err_msg=k)


@pytest.mark.parametrize("new_prefix", ["b_", None])
def test_clone_with_prefix_equals_jax_and_leaves_the_original(new_prefix):
    ref = mt.MetricCollection(dict(_main_path(mt).items()), prefix="a_")
    port = pt.MetricCollection(dict(_main_path(pt).items()), prefix="a_")
    batches = _batches("main", steps=3)
    for preds, target in batches[:2]:
        ref.update(jnp.asarray(preds), jnp.asarray(target))
        port.update(torch.from_numpy(preds), torch.from_numpy(target))
    jclone, pclone = ref.clone(prefix=new_prefix), port.clone(prefix=new_prefix)
    assert pclone.prefix == jclone.prefix == new_prefix and port.prefix == "a_"
    assert pclone is not port and all(pclone[k] is not port[k] for k in port)
    preds, target = batches[2]
    _assert_prefixed(pclone(torch.from_numpy(preds), torch.from_numpy(target)),
                   jclone(jnp.asarray(preds), jnp.asarray(target)))
    _assert_prefixed(pclone.compute(), jclone.compute())
    assert set(pclone.compute()) == {f"{new_prefix or ''}{k}" for k in port}
    # the original kept its two updates and its prefix
    _assert_prefixed(port.compute(), ref.compute())
    assert int((port["F1"].tp + port["F1"].fn).sum()) == 2 * 64 and pclone.compute_groups == port.compute_groups
    with pytest.raises(ValueError, match="prefix"):
        port.clone(prefix=3)


def test_repr_lists_members_as_jax():
    ref, port = _main_path(mt), _main_path(pt)
    want = ref.__repr__().splitlines()
    got = port.__repr__().splitlines()
    assert got[0] == want[0] == "MetricCollection(" and got[-1] == want[-1] == ")"
    assert [line.split(":")[0] for line in got[1:-1]] == [line.split(":")[0] for line in want[1:-1]]
    assert got[1] == f"  Accuracy: {port['Accuracy']!r},"


def test_pure_view_dedups_groups_and_equals_jax():
    ref, port = _main_path(mt), _main_path(pt)
    jpure, ppure = ref.pure(), port.pure()
    pstate, jstate = ppure.init(), jpure.init()
    assert set(pstate) == set(jstate) == {"Accuracy", "F1"}  # one entry a compute group
    batches = _batches("main", steps=3)
    for preds, target in batches:
        pstate = ppure.update(pstate, torch.from_numpy(preds), torch.from_numpy(target))
        jstate = jpure.update(jstate, jnp.asarray(preds), jnp.asarray(target))
    _assert_values(ppure.compute(pstate), jpure.compute(jstate))
    for k in pstate:
        for name, value in pstate[k].items():
            np.testing.assert_array_equal(value.numpy(), np.asarray(jstate[k][name]))
    # the collection's own states stay untouched
    assert int(port["F1"].tp.sum()) == 0 and int(port["Accuracy"].total) == 0
    # the stateful collection fed the same batches agrees
    for preds, target in batches:
        port.update(torch.from_numpy(preds), torch.from_numpy(target))
    _assert_values(ppure.compute(pstate), {k: v for k, v in port.compute().items()})
    # merge of two halves equals the whole; a full per-member state still works
    half_a = ppure.update(ppure.init(), *(torch.from_numpy(x) for x in batches[0]))
    half_b = ppure.init()
    for preds, target in batches[1:]:
        half_b = ppure.update(half_b, torch.from_numpy(preds), torch.from_numpy(target))
    _assert_values(ppure.compute(ppure.merge(half_a, half_b)), ppure.compute(pstate))
    full = {k: m.init_state() for k, m in port.items()}
    jfull = {k: m.init_state() for k, m in ref.items()}
    for preds, target in batches:
        full = ppure.update(full, torch.from_numpy(preds), torch.from_numpy(target))
        jfull = jpure.update(jfull, jnp.asarray(preds), jnp.asarray(target))
    assert set(full) == set(port)
    _assert_values(ppure.compute(full), jpure.compute(jfull))


def test_pure_sync_with_fake_single_rank_group_is_identity(monkeypatch):
    """Without a process group the bucketed plane is not reachable; with a
    one-rank Gloo group the sync is the identity, one all_reduce a bucket."""
    import torch.distributed as dist

    port = _main_path(pt)
    pure = port.pure()
    state = pure.update(pure.init(), *(torch.from_numpy(x) for x in _batches("main", steps=1)[0]))
    store = dist.HashStore()
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        calls = []
        real = dist.all_reduce
        monkeypatch.setattr(dist, "all_reduce", lambda t, *a, **k: calls.append(t.dtype) or real(t, *a, **k))
        synced = pure.sync(state)
    finally:
        dist.destroy_process_group()
    assert calls == [torch.int64]  # Accuracy's and the stat-score group's int64 sums: one bucket
    for k in state:
        for name in state[k]:
            assert torch.equal(synced[k][name], state[k][name])


@pytest.mark.parametrize("kind,build", [("main", _main_path), ("binned", _binned)])
def test_forward_batched_equals_jax_and_a_forward_loop(kind, build):
    ref, port, loop = build(mt), build(pt), build(pt)
    batches = _batches(kind, steps=4)
    preds = np.stack([b[0] for b in batches])
    target = np.stack([b[1] for b in batches])
    got = port.forward_batched(torch.from_numpy(preds), torch.from_numpy(target))
    want = ref.forward_batched(jnp.asarray(preds), jnp.asarray(target))
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == (4,)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=_RTOL[k], atol=0, err_msg=k)
    stepwise = [loop(torch.from_numpy(p), torch.from_numpy(t)) for p, t in batches]
    for k in got:
        assert torch.equal(got[k], torch.stack([s[k] for s in stepwise]))
    # the epoch value is cached: compute() runs no member compute
    cached = {k: m._computed for k, m in port.items()}
    assert all(v is not None for v in cached.values())
    _assert_values(port.compute(), ref.compute())
    _assert_values(port.compute(), loop.compute())
    assert all(port[k]._epoch_watermark == 4 for k in port)


def test_metric_forward_batched_equals_jax_and_falls_back_with_kwargs():
    port, ref = pt.Accuracy(device="cpu"), mt.Accuracy()
    batches = _batches("main", steps=3)
    preds = np.stack([b[0] for b in batches])
    target = np.stack([b[1] for b in batches])
    got = port.forward_batched(torch.from_numpy(preds), torch.from_numpy(target))
    want = ref.forward_batched(jnp.asarray(preds), jnp.asarray(target))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert port._computed is not None and port._epoch_watermark == ref._epoch_watermark == 3
    np.testing.assert_allclose(float(port.compute()), float(ref.compute()), rtol=1e-6)
    # keyword arguments: the per-step forwards, no cached epoch value
    kw = pt.Accuracy(device="cpu")
    by_kw = kw.forward_batched(preds=torch.from_numpy(preds), target=torch.from_numpy(target))
    assert torch.equal(by_kw, got) and kw._computed is None
    off = pt.Accuracy(device="cpu", compute_on_step=False)
    assert off.forward_batched(torch.from_numpy(preds), torch.from_numpy(target)) is None
    assert int(off.total) == preds.shape[0] * preds.shape[1]
    # a synced configuration leaves compute() to sync
    synced = pt.Accuracy(device="cpu", dist_sync_fn=lambda x: [x])
    synced.forward_batched(torch.from_numpy(preds), torch.from_numpy(target))
    assert synced._computed is None
