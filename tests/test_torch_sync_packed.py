"""A collection's packed per-step sync across three real processes (Gloo).

Three ranks over ``torch.distributed`` (Gloo, a FileStore under ``tmp_path``),
each fed its own seeded batches, with ``all_reduce`` / ``all_gather`` wrapped
to count every collective, and the synced state each member computes its
batch value from recorded (``Metric._value_of_synced`` in a packed step,
``Metric._synced_state`` in a member's own sync). The reference is the
per-member path: each member, built alike, forwarded alone in the same group.

* The image collection of ``portbench/configs/div2k_image_quality.json``
  (SSIM, MS-SSIM, PSNR, UQI, TV, SAM, ERGAS; ``dist_sync_on_step``) at that
  configuration's rehearsal size, 4 x 3 x 192 x 192: each step's synced
  deltas, batch values and the epoch values equal the reference's, and each
  member counts its synced computes as alone. A packed step makes 2
  ``all_reduce`` (the float32 and the int64 sum buckets of all seven), the
  members alone 14.
* A mixed collection: one shared compute group (F1 and Precision, macro, with
  a ``sync_lag=1`` Specificity in it), two singletons (Accuracy, top-2
  Accuracy), a ``dist_sync_fn`` member (MatthewsCorrcoef over the host plane)
  and a list-state member (exact AUROC). Only the eligible five share the
  step's one ``collection.step_sync`` (one int64 ``all_reduce`` and AUROC's
  layout and two data ``all_gather``); the lag member dispatches its own
  deferred sync and the host-plane member records its own
  ``metric.sync_state``. Every member's values, synced deltas and sync count
  equal the reference's.
* ``check_finite`` under packing: PSNR's batch delta on rank 1 counts within
  the integrity guard's margin of int64's range once summed over the ranks
  (not before, so the forward's own guard passes). Under ``quarantine`` that
  member's value comes from each rank's local delta, the other members'
  synced values are the reference's, and the next step syncs again; under
  ``raise`` every rank raises ``StateCorruptionError``.

Every child is killed if it outlives its timeout; this process never joins a
group. Tolerances: integer states bit for bit; float32 states and values
within rtol 1e-6, since Gloo may sum a packed buffer in another order.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

_REPO = Path(__file__).resolve().parents[1]
_WORLD = 3
_STEPS = 3
_IMAGE = ("ssim", "ms_ssim", "psnr", "uqi", "tv", "sam", "ergas")
_MIXED = ("f1", "prec", "spec_lag", "acc", "acc_top2", "mcc_host", "auroc")
_PACKED = ("f1", "prec", "acc", "acc_top2", "auroc")

_WORKER = textwrap.dedent("""
    import json, math, sys, warnings
    import torch, torch.distributed as dist
    sys.path.insert(0, sys.argv[4])
    import metrics_tpu_torch as pt
    from metrics_tpu_torch import observability as obs
    from metrics_tpu_torch.core.metric import Metric
    from metrics_tpu_torch.parallel import sync
    from metrics_tpu_torch.utils.exceptions import StateCorruptionError

    warnings.simplefilter("ignore")
    rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    steps = int(sys.argv[5])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=3)
    res = {}

    calls = []
    real_reduce, real_gather = dist.all_reduce, dist.all_gather
    dist.all_reduce = lambda *a, **k: (calls.append("all_reduce"), real_reduce(*a, **k))[1]
    dist.all_gather = lambda *a, **k: (calls.append("all_gather"), real_gather(*a, **k))[1]

    def plain(state):
        def one(v):
            if isinstance(v, list):
                return [one(x) for x in v]
            return [str(v.dtype), v.tolist()]
        return {n: one(v) for n, v in state.items()}

    seen = {}
    real_synced, real_value = Metric._synced_state, Metric._value_of_synced
    def synced_state(self, *a, **k):
        got = real_synced(self, *a, **k)
        seen[getattr(self, "label", "?")] = plain(got)
        return got
    def value_of_synced(self, synced, local):
        seen[getattr(self, "label", "?")] = plain(synced)
        return real_value(self, synced, local)
    Metric._synced_state, Metric._value_of_synced = synced_state, value_of_synced

    def run(members, batches, together, kwargs):
        # each step's values, synced deltas and collectives, then the epoch
        for k, m in members.items():
            m.label = k
        col = pt.MetricCollection(members) if together else None
        rows = []
        for batch in batches:
            call = kwargs(*batch)
            seen.clear()
            del calls[:]
            if together:
                vals = col(**call)
            else:
                vals = {k: m(**m._filter_kwargs(**call)) for k, m in members.items()}
            rows.append({"values": {k: float(v) for k, v in vals.items()}, "synced": dict(seen),
                         "calls": list(calls)})
        counts = {k: m._sync_count for k, m in members.items()}  # the steps' synced computes
        epoch = col.compute() if together else {k: m.compute() for k, m in members.items()}
        return {"steps": rows, "epoch": {k: float(v) for k, v in epoch.items()}, "sync_counts": counts,
                "groups": [list(g) for g in col.compute_groups.values()] if together else None}

    def images(n, size, seed):
        # a smooth field a channel plus N(0, 0.05^2) noise, in [0, 1]
        g = torch.Generator().manual_seed(seed)
        y, x = torch.meshgrid(torch.linspace(0, 1, size), torch.linspace(0, 1, size), indexing="ij")
        f = 2 + 6 * torch.rand((n, 3, 1, 1), generator=g)
        phase = 6.3 * torch.rand((n, 3, 1, 1), generator=g)
        target = 0.5 + 0.3 * torch.sin(f * x + phase) * torch.cos(f * y - phase)
        return (target + 0.05 * torch.randn(target.shape, generator=g)).clamp(0, 1), target

    image_kw = lambda preds, target: {"preds": preds, "target": target, "img": preds}

    def image_members():
        kw = {"device": "cpu", "dist_sync_on_step": True}
        return {"ssim": pt.SSIM(data_range=1.0, **kw), "ms_ssim": pt.MultiScaleSSIM(data_range=1.0, **kw),
                "psnr": pt.PSNR(data_range=1.0, **kw), "uqi": pt.UniversalImageQualityIndex(**kw),
                "tv": pt.TotalVariation(**kw), "sam": pt.SpectralAngleMapper(**kw),
                "ergas": pt.ErrorRelativeGlobalDimensionlessSynthesis(**kw)}

    batches = [images(4, 192, 100 * rank + i) for i in range(steps)]
    res["image_packed"] = run(image_members(), batches, True, image_kw)
    res["image_alone"] = run(image_members(), batches, False, image_kw)

    def mixed_members():
        kw = {"device": "cpu", "dist_sync_on_step": True}
        m = {"f1": pt.F1(num_classes=5, average="macro", **kw), "prec": pt.Precision(num_classes=5, average="macro", **kw),
             "spec_lag": pt.Specificity(num_classes=5, average="macro", **kw), "acc": pt.Accuracy(**kw),
             "acc_top2": pt.Accuracy(top_k=2, **kw), "mcc_host": pt.MatthewsCorrcoef(num_classes=5, **kw),
             "auroc": pt.AUROC(num_classes=5, **kw)}
        m["spec_lag"].sync_lag = 1
        m["mcc_host"].dist_sync_fn = sync._world_gather
        return m

    g = torch.Generator().manual_seed(7 + rank)
    rows = (24, 17, 30)[rank]
    batches = [(torch.softmax(torch.randn((rows, 5), generator=g), 1), torch.randint(0, 5, (rows,), generator=g))
               for _ in range(steps)]
    class_kw = lambda preds, target: {"preds": preds, "target": target}
    obs.enable(spans=True, counters=False)
    try:
        res["mixed_packed"] = run(mixed_members(), batches, True, class_kw)
        res["mixed_spans"] = [[r.name, r.attrs] for r in sorted(obs.records(), key=lambda r: r.start_ns)
                              if r.name in ("collection.step_sync", "metric.sync_state", "deferred.dispatch")]
    finally:
        obs.disable()
        obs.reset()
    res["mixed_alone"] = run(mixed_members(), batches, False, class_kw)

    class SaturatedPSNR(pt.PSNR):
        # on rank 1, a delta count within the guard's margin of int64's range once summed over the ranks
        saturate = False

        def update(self, preds, target):
            super().update(preds, target)
            if type(self).saturate and dist.get_rank() == 1:
                info = torch.iinfo(torch.int64)
                self.total = torch.full_like(self.total, info.max - info.max // 2048 - 1)

    def finite_members(policy):
        kw = {"device": "cpu", "dist_sync_on_step": True}
        m = {"ssim": pt.SSIM(data_range=1.0, **kw), "psnr": SaturatedPSNR(data_range=1.0, **kw),
             "tv": pt.TotalVariation(**kw)}
        m["psnr"].check_finite = policy
        return m

    batches = [images(2, 32, 500 + 10 * rank + i) for i in range(2)]
    res["local_psnr"] = [float(pt.functional.psnr(p, t, data_range=1.0)) for p, t in batches]
    for together in (True, False):
        SaturatedPSNR.saturate = True
        members = finite_members("quarantine")
        col = pt.MetricCollection(members) if together else None
        values = []
        for i, (p, t) in enumerate(batches):
            call = image_kw(p, t)
            vals = col(**call) if together else {k: m(**m._filter_kwargs(**call)) for k, m in members.items()}
            values.append({k: float(v) for k, v in vals.items()})
            SaturatedPSNR.saturate = False
        res[f"quarantine_{together}"] = values

        SaturatedPSNR.saturate = True
        members = finite_members("raise")
        col = pt.MetricCollection(members) if together else None
        call = image_kw(*batches[0])
        try:
            if together:
                col(**call)
            else:
                for m in members.values():
                    m(**m._filter_kwargs(**call))
            res[f"raise_{together}"] = "no error"
        except StateCorruptionError as err:
            res[f"raise_{together}"] = str(err)
        SaturatedPSNR.saturate = False

    json.dump(res, open(out, "w"))
    dist.destroy_process_group()
""")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sync_packed")
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    procs = [
        subprocess.Popen([sys.executable, str(script), str(r), str(tmp / "store"), str(tmp / f"out{r}.json"),
                          str(_REPO), str(_STEPS)],
                         env=dict(os.environ, OMP_NUM_THREADS="1"), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for r in range(_WORLD)
    ]
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0] * _WORLD, logs
    return [json.loads((tmp / f"out{r}.json").read_text()) for r in range(_WORLD)]


def _assert_same_state(got, want, where):
    assert set(got) == set(want), where
    for name in want:
        a, b = got[name], want[name]
        if isinstance(b[0], list):  # a gathered list state: one [dtype, values] a rank
            assert len(a) == len(b), (where, name)
            for x, y in zip(a, b):
                _assert_same_state({name: x}, {name: y}, where)
            continue
        assert a[0] == b[0], (where, name)
        if b[0].startswith("torch.int"):
            assert a[1] == b[1], (where, name)
        else:
            np.testing.assert_allclose(a[1], b[1], rtol=1e-6, err_msg=f"{where} {name}")


def _assert_same_run(packed, alone, names, where):
    for i, (p, a) in enumerate(zip(packed["steps"], alone["steps"])):
        np.testing.assert_allclose([p["values"][k] for k in names], [a["values"][k] for k in names], rtol=1e-6,
                                   err_msg=f"{where} step {i}")
        for k in p["synced"]:
            _assert_same_state(p["synced"][k], a["synced"][k], f"{where} step {i} {k}")
    np.testing.assert_allclose([packed["epoch"][k] for k in names], [alone["epoch"][k] for k in names], rtol=1e-6,
                               err_msg=f"{where} epoch")
    assert packed["sync_counts"] == alone["sync_counts"], where


def test_image_collection_packs_a_step_into_two_all_reduces(ranks):
    for r, res in enumerate(ranks):
        packed, alone = res["image_packed"], res["image_alone"]
        assert packed["groups"] == [[k] for k in _IMAGE]  # seven compute groups of one member each
        for p, a in zip(packed["steps"], alone["steps"]):
            assert p["calls"] == ["all_reduce"] * 2 and a["calls"] == ["all_reduce"] * 14, r
            assert set(p["synced"]) == set(a["synced"]) == set(_IMAGE), r
        _assert_same_run(packed, alone, _IMAGE, f"rank {r} image")
        assert packed["sync_counts"] == {k: _STEPS for k in _IMAGE}  # a synced compute a step
    # a synced value is the same on every rank
    for i in range(_STEPS):
        assert len({json.dumps(res["image_packed"]["steps"][i]["values"]) for res in ranks}) == 1


def test_mixed_collection_packs_only_the_eligible_members(ranks):
    for r, res in enumerate(ranks):
        packed, alone = res["mixed_packed"], res["mixed_alone"]
        assert packed["groups"] == [["f1", "prec", "spec_lag"], ["acc"], ["acc_top2"], ["mcc_host"], ["auroc"]]
        # a step, in order: the lag member's own deferred dispatch and the host-plane member's own sync, each
        # in its forward, then the pack's one sync
        want = [["deferred.dispatch", {"lag_controller": 1, "plane": "sync_state"}],
                ["metric.sync_state", {"metric": "MatthewsCorrcoef"}],
                ["collection.step_sync", {"group": "f1", "members": len(_PACKED)}]]
        spans = [[n, {k: v for k, v in a.items() if k != "state_bytes"}] for n, a in res["mixed_spans"]]
        assert spans[:len(want) * _STEPS] == want * _STEPS, spans
        assert all(n == "metric.sync_state" for n, _a in spans[len(want) * _STEPS:]), spans  # the epoch's
        for i, (p, a) in enumerate(zip(packed["steps"], alone["steps"])):
            assert set(p["synced"]) == set(a["synced"]) == {*_PACKED, "mcc_host"}, (r, i)
            # one int64 bucket and the list state's layout and float32 / int64 gathers for the pack; the lag
            # member's deferred all_reduce; the host plane's gather of its int64 confusion matrix
            assert sorted(p["calls"]) == ["all_gather"] * 4 + ["all_reduce"] * 2, (r, i, p["calls"])
            # alone: four int64 buckets, AUROC's three gathers, the lag member's, the host plane's
            assert sorted(a["calls"]) == ["all_gather"] * 4 + ["all_reduce"] * 5, (r, i, a["calls"])
        _assert_same_run(packed, alone, _MIXED, f"rank {r} mixed")


def test_check_finite_quarantines_one_member_of_a_pack(ranks):
    for r, res in enumerate(ranks):
        packed, alone = res["quarantine_True"], res["quarantine_False"]
        for i, (p, a) in enumerate(zip(packed, alone)):
            np.testing.assert_allclose([p[k] for k in ("ssim", "psnr", "tv")], [a[k] for k in ("ssim", "psnr", "tv")],
                                       rtol=1e-6, err_msg=f"rank {r} step {i}")
        if r != 1:  # the poisoned sum is refused: this rank's value is its own batch's
            np.testing.assert_allclose(packed[0]["psnr"], res["local_psnr"][0], rtol=1e-6)
        # the next step syncs again: every rank reads one value
        assert len({ranks[q]["quarantine_True"][1]["psnr"] for q in range(_WORLD)}) == 1
    # the other members' synced step values agree across the ranks
    for k in ("ssim", "tv"):
        assert len({res["quarantine_True"][0][k] for res in ranks}) == 1


def test_check_finite_raise_raises_on_every_rank_under_packing(ranks):
    for res in ranks:
        for together in (True, False):
            message = res[f"raise_{together}"]
            assert "SaturatedPSNR state failed the integrity scan after sync" in message, message
            assert "1 near-saturated integer count" in message, message
