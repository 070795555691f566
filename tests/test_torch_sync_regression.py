"""Regression metrics synced across three real processes (Gloo), against one process over all rows.

Three ranks over ``torch.distributed`` (Gloo, a FileStore under ``tmp_path``)
with uneven batch counts and sizes, and one rank with no rows:

* ``PearsonCorrcoef``: its ``(6,)`` co-moment state has a callable reduction
  (``chan_fold``, marked ``associative``), so the sync gathers the
  ``(world, 6)`` stack and folds it in rank order: one layout ``all_gather``,
  one float32 ``all_gather`` and one ``all_reduce`` for the int64 count. The
  epoch value equals one process over the rank-major rows, and so does each
  step's value with ``dist_sync_on_step``, a rank with an empty batch included;
  each forward makes one update.
* ``SpearmanCorrcoef`` and ``KendallRankCorrCoef`` with list and ``capacity``
  (PaddedBuffer) states, ``PSNR(dim=...)``'s list states and the stored-image
  ``SSIM``'s 4-D list states gather at ``compute()``; a rank that never
  updated takes each state's layout from the table.

Tolerances: Kendall's counts are exact (int64), so tau is equal; the other
values are float32 sums over the same rows in another order or merge tree:
rtol 1e-5 (1e-4 absolute for the co-moment sums of ~1e2).
"""
import json
import os
import subprocess
import sys
import textwrap
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import metrics_tpu_torch as pt

torch.set_num_threads(1)

_REPO = Path(__file__).resolve().parents[1]

_WORKER = textwrap.dedent("""
    import json, sys, warnings
    import numpy as np, torch, torch.distributed as dist
    sys.path.insert(0, {repo!r})
    import metrics_tpu_torch as pt

    warnings.simplefilter("ignore")
    rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=3)
    data = json.load(open({data!r}))

    calls = []
    real_gather, real_reduce = dist.all_gather, dist.all_reduce
    dist.all_gather = lambda *a, **k: (calls.append("all_gather"), real_gather(*a, **k))[1]
    dist.all_reduce = lambda *a, **k: (calls.append("all_reduce"), real_reduce(*a, **k))[1]

    class CountingPearson(pt.PearsonCorrcoef):
        updates = 0

        def update(self, preds, target):
            type(self).updates += 1
            super().update(preds, target)

    t = lambda x: torch.tensor(x, dtype=torch.float32)
    result = {{"values": {{}}, "calls": {{}}, "steps": []}}

    pairs = {{
        "pearson": pt.PearsonCorrcoef(device="cpu"),
        "spearman": pt.SpearmanCorrcoef(device="cpu"),
        "spearman_cap": pt.SpearmanCorrcoef(capacity=64, device="cpu"),
        "kendall": pt.KendallRankCorrCoef(device="cpu"),
        "kendall_cap": pt.KendallRankCorrCoef(capacity=64, device="cpu"),
    }}
    for p, y in data["pairs"][rank]:
        for m in pairs.values():
            m.update(t(p), t(y))
    images = {{"psnr_dim": pt.PSNR(data_range=1.0, dim=(1, 2, 3), reduction="none", device="cpu"),
               "ssim_stored": pt.SSIM(kernel_size=(3, 5), device="cpu")}}
    for p, y in data["images"][rank]:
        for m in images.values():
            m.update(t(p), t(y))
    for name, m in {{**pairs, **images}}.items():
        del calls[:]
        value = m.compute()
        result["values"][name] = value.tolist()
        result["calls"][name] = list(calls)
    result["pearson_n_total"] = int(pairs["pearson"].n_total)  # the local count is back after compute

    stepper = CountingPearson(dist_sync_on_step=True, device="cpu")
    for p, y in data["steps"][rank]:
        result["steps"].append(stepper(t(p), t(y)).item())
    result["step_updates"] = CountingPearson.updates
    json.dump(result, open(out, "w"))
    dist.destroy_process_group()
""")

# rank 0: three batches, rank 1: one, rank 2: no update at all
_PAIR_SIZES = [[9, 14, 5], [11], []]
_IMAGE_SIZES = [[2, 1], [], [1]]
# dist_sync_on_step: every rank steps together; a 0 is an empty batch on that rank
_STEP_SIZES = [[16, 5, 0], [8, 0, 7], [0, 0, 12]]


def _pair(seed, n):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 6, n).astype(np.float32)  # tied
    return x, (x + rng.randn(n)).astype(np.float32)


def _image(seed, n):
    rng = np.random.RandomState(seed)
    y = rng.rand(n, 2, 12, 13).astype(np.float32)
    return np.clip(y + 0.1 * rng.randn(*y.shape), 0, 1).astype(np.float32), y


def test_three_rank_gloo_regression_sync_equals_one_process(tmp_path):
    pairs = [[_pair(10 * r + i, n) for i, n in enumerate(sizes)] for r, sizes in enumerate(_PAIR_SIZES)]
    images = [[_image(50 + 10 * r + i, n) for i, n in enumerate(sizes)] for r, sizes in enumerate(_IMAGE_SIZES)]
    steps = [[_pair(100 + 10 * r + i, n) for i, n in enumerate(sizes)] for r, sizes in enumerate(_STEP_SIZES)]
    plain = lambda rank: [[p.tolist(), y.tolist()] for p, y in rank]  # noqa: E731
    data = tmp_path / "batches.json"
    data.write_text(json.dumps({"pairs": [plain(r) for r in pairs], "images": [plain(r) for r in images],
                                "steps": [plain(r) for r in steps]}))
    script = tmp_path / "worker.py"
    script.write_text(_WORKER.format(repo=str(_REPO), data=str(data)))
    procs = [
        subprocess.Popen([sys.executable, str(script), str(r), str(tmp_path / "store"), str(tmp_path / f"out{r}.json")],
                         env=dict(os.environ, OMP_NUM_THREADS="1"), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for r in range(3)
    ]
    try:
        logs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0, 0], logs
    results = [json.loads((tmp_path / f"out{r}.json").read_text()) for r in range(3)]

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        one = {
            "pearson": pt.PearsonCorrcoef(device="cpu"),
            "spearman": pt.SpearmanCorrcoef(device="cpu"),
            "kendall": pt.KendallRankCorrCoef(device="cpu"),
            "psnr_dim": pt.PSNR(data_range=1.0, dim=(1, 2, 3), reduction="none", device="cpu"),
            "ssim_stored": pt.SSIM(kernel_size=(3, 5), device="cpu"),
        }
    for p, y in (b for rank in pairs for b in rank):
        for name in ("pearson", "spearman", "kendall"):
            one[name].update(torch.from_numpy(p), torch.from_numpy(y))
    for p, y in (b for rank in images for b in rank):
        for name in ("psnr_dim", "ssim_stored"):
            one[name].update(torch.from_numpy(p), torch.from_numpy(y))
    want = {name: m.compute().numpy() for name, m in one.items()}
    assert want["psnr_dim"].shape == (4,)  # one value per image, in rank order

    for r, res in enumerate(results):
        got = res["values"]
        np.testing.assert_allclose(got["pearson"], want["pearson"], rtol=1e-5)
        for name in ("spearman", "spearman_cap"):
            np.testing.assert_allclose(got[name], want["spearman"], rtol=1e-5)
        assert got["kendall"] == got["kendall_cap"] == float(want["kendall"])
        np.testing.assert_allclose(got["psnr_dim"], want["psnr_dim"], rtol=1e-5)
        np.testing.assert_allclose(got["ssim_stored"], want["ssim_stored"], rtol=1e-5)
        # the co-moment vector: layout + float32 gather, and one all_reduce for the int64 count
        assert sorted(res["calls"]["pearson"]) == ["all_gather", "all_gather", "all_reduce"]
        assert res["calls"]["spearman"] == res["calls"]["kendall_cap"] == ["all_gather"] * 2  # layout, float32
        assert res["pearson_n_total"] == sum(_PAIR_SIZES[r])

        # dist_sync_on_step: each step's value is Pearson over that step's rows of every rank
        for step in range(3):
            rows = [steps[q][step] for q in range(3)]
            p = np.concatenate([x for x, _ in rows])
            y = np.concatenate([x for _, x in rows])
            np.testing.assert_allclose(res["steps"][step], np.corrcoef(p, y)[0, 1], rtol=1e-5)
        assert res["step_updates"] == 3  # one update a forward
