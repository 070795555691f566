"""Agreement-governed serving across two real processes (Gloo).

Two ranks over ``torch.distributed`` (Gloo, a FileStore under ``tmp_path``).
Each runs a ``MetricService`` over ``Windowed(Accuracy)`` joined to one
cross-process ``WatermarkAgreement`` as its rank; the merged view of every
publish syncs with ``all_reduce`` on the host plane's worker. A step is: the
rank's batch (every step's batches of both ranks end at the same event time,
so the ranks' clocks agree and no event is late), ``flush``, one explicit
``exchange()`` round entered by both processes, then an empty heartbeat batch
whose close check publishes what the agreed clock closed. So each rank
enters its collectives in the same order: publishes, then the round.

Held: both ranks publish the same windows, none degraded, and every
publication's merged value, and the final merged value, equal the JAX
package's ``MetricService`` in one process fed both ranks' events (the union
of each step's batches): window ids and ``final`` flags equal, values within
rtol 1e-6 (each is a ratio of equal integer counts, rounded to float32 by
each package); both ranks made the same number of ``all_reduce`` calls.
"""
import json
import os
import subprocess
import sys
import textwrap
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

import metrics_tpu as mt
from tests.test_torch_faults import plane_hygiene  # noqa: F401  (autouse)
from tests.test_torch_observability import obs_hygiene  # noqa: F401  (autouse)
from tests.test_torch_serving_service import serving_hygiene  # noqa: F401  (autouse)

torch.set_num_threads(1)

_REPO = Path(__file__).resolve().parents[1]
_STEPS = 12
_SIZES = (6, 4)
_WINDOW = dict(window_s=10.0, num_windows=4, allowed_lateness_s=10.0)

_WORKER = textwrap.dedent("""
    import json, sys, warnings
    import numpy as np, torch, torch.distributed as dist
    sys.path.insert(0, {repo!r})
    import metrics_tpu_torch as pt
    from metrics_tpu_torch.parallel.sync import SyncGuard

    warnings.simplefilter("ignore")
    rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=2)
    steps = json.load(open({data!r}))[rank]

    calls = []
    real_reduce = dist.all_reduce
    dist.all_reduce = lambda *a, **k: (calls.append(1), real_reduce(*a, **k))[1]

    agreement = pt.WatermarkAgreement(deadline_s=120.0, exchange_every_s=3600.0)
    metric = pt.Windowed(pt.Accuracy(device="cpu"), agreement=agreement, rank=rank, **{window!r})
    svc = pt.MetricService(metric, name=f"rank{{rank}}",
                           guard=SyncGuard(deadline_s=60.0, max_retries=1, backoff_s=0.05, policy="degrade"))
    for step, (times, preds, target) in enumerate(steps):
        svc.submit(torch.tensor(preds, dtype=torch.float32), torch.tensor(target), event_time=np.asarray(times),
                   seq=2 * step)
        svc.flush(60.0)
        agreement.exchange().result()  # every process enters the round at the same point
        svc.submit(torch.zeros(0), torch.zeros(0, dtype=torch.int64), event_time=np.zeros(0), seq=2 * step + 1)
        svc.flush(60.0)
    merged = float(svc.finalize(60.0))
    svc.stop()
    records = [{{"window": r["window"], "merged": float(r["merged"]), "degraded": r["degraded"],
                 "final": r["final"]}} for r in svc.publications]
    json.dump({{"records": records, "merged": merged, "calls": len(calls), "agreed": agreement.agreed(),
               "exchanges": agreement.exchanges}}, open(out, "w"))
    dist.destroy_process_group()
""")


def _steps(rank):
    """Per step: times in [5 k, 5 k + 4.9] with one event at 5 k + 4.9 (the step's clock), scores, labels."""
    rng = np.random.RandomState(40 + rank)
    out = []
    for k in range(_STEPS):
        n = _SIZES[rank]
        times = np.sort(np.append(5.0 * k + rng.uniform(0.0, 4.9, n - 1), 5.0 * k + 4.9))
        out.append((times.tolist(), rng.rand(n).astype(np.float32).tolist(), rng.randint(0, 2, n).tolist()))
    return out


def test_two_rank_agreement_governed_services_publish_the_one_process_merged_view(tmp_path):
    data = [_steps(r) for r in range(2)]
    (tmp_path / "data.json").write_text(json.dumps(data))
    script = tmp_path / "worker.py"
    script.write_text(_WORKER.format(repo=str(_REPO), data=str(tmp_path / "data.json"), window=_WINDOW))
    procs = [
        subprocess.Popen([sys.executable, str(script), str(r), str(tmp_path / "store"), str(tmp_path / f"out{r}.json")],
                         env=dict(os.environ, OMP_NUM_THREADS="1"), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for r in range(2)
    ]
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], logs
    results = [json.loads((tmp_path / f"out{r}.json").read_text()) for r in range(2)]

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        one = mt.MetricService(mt.Windowed(mt.Accuracy(), **_WINDOW), name="one-process")
        for k in range(_STEPS):
            times = np.concatenate([np.asarray(data[r][k][0]) for r in range(2)])
            preds = np.concatenate([np.asarray(data[r][k][1], np.float32) for r in range(2)])
            target = np.concatenate([np.asarray(data[r][k][2], np.int32) for r in range(2)])
            one.submit(jnp.asarray(preds), jnp.asarray(target), event_time=times, seq=k)
        want_merged = float(one.finalize())
        one.stop()
    want = [(r["window"], r["final"]) for r in one.publications]
    assert len(want) >= 6
    for res in results:
        assert [(r["window"], r["final"]) for r in res["records"]] == want
        np.testing.assert_allclose([r["merged"] for r in res["records"]],
                                   [float(r["merged"]) for r in one.publications], rtol=1e-6, atol=0.0)
        assert not any(r["degraded"] for r in res["records"])
        np.testing.assert_allclose(res["merged"], want_merged, rtol=1e-6, atol=0.0)
        assert res["agreed"] == 5.0 * (_STEPS - 1) + 4.9 and res["exchanges"] == _STEPS
    assert results[0]["calls"] == results[1]["calls"] > 0
