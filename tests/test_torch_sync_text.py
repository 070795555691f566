"""Text states synced across three real processes (Gloo).

Three ranks over ``torch.distributed`` (Gloo, a FileStore under ``tmp_path``),
with uneven work:

* a collection of WER, CharErrorRate, MatchErrorRate, WordInfoLost,
  WordInfoPreserved and EditDistance with ``dist_sync_on_step``, and Perplexity
  with ``dist_sync_on_step`` beside it: every rank makes the same number of
  steps with batches of different sizes (one rank's batch empty at one step),
  and each step's synced value equals one process fed that step's rows of
  every rank;
* the corpus metrics synced at ``compute()``: BLEUScore, SacreBLEUScore,
  TranslationEditRate and SQuAD over reference lists, CHRFScore and ROUGEScore
  over sentence pairs; rank 0 feeds three batches, rank 1 one, rank 2 none.

Every state is a ``"sum"`` state, so the sync is ``all_reduce`` alone (no
gather). Integer states equal the one process's bit for bit. Float states
(BLEU's numerator, TER / ROUGE / SQuAD sums, Perplexity's total) are float32
sums in another grouping (rank partials added, not one batch after another):
rtol 1e-6, and the values made from them rtol 1e-6.
"""
import json
import os
import subprocess
import sys
import textwrap
import warnings
from pathlib import Path

import numpy as np
import torch

torch.set_num_threads(1)

_REPO = Path(__file__).resolve().parents[1]
RTOL = 1e-6

_COMMON = """
import numpy as np
import torch
import metrics_tpu_torch as pt


def step_collections():
    cpu = dict(device="cpu", dist_sync_on_step=True)
    return {
        "rates": pt.MetricCollection([pt.WER(**cpu), pt.CharErrorRate(**cpu), pt.MatchErrorRate(**cpu),
                                      pt.WordInfoLost(**cpu), pt.WordInfoPreserved(**cpu), pt.EditDistance(**cpu)]),
        "ppl": pt.MetricCollection([pt.Perplexity(ignore_index=-100, **cpu)]),
    }


def corpus_collections():
    cpu = dict(device="cpu")
    return {
        "refs": pt.MetricCollection([pt.BLEUScore(**cpu), pt.SacreBLEUScore(**cpu),
                                     pt.TranslationEditRate(**cpu), pt.SQuAD(**cpu)]),
        "pairs": pt.MetricCollection([pt.CHRFScore(**cpu), pt.ROUGEScore(**cpu)]),
    }


def ppl_args(batch):
    logits = torch.tensor(batch["logits"], dtype=torch.float32).reshape(-1, 5, 32)
    return logits.to(torch.bfloat16), torch.tensor(batch["ids"], dtype=torch.int64).reshape(-1, 5)


def feed_corpus(cols, batch):
    cols["refs"].update(batch["preds"], batch["refs"])
    cols["pairs"].update(batch["preds"], [r[0] for r in batch["refs"]])


def plain(values):
    out = {}
    for k, v in values.items():
        if isinstance(v, dict):
            out.update({f"{k}.{kk}": float(vv) for kk, vv in v.items()})
        else:
            out[k] = float(v)
    return out


def states(cols):
    return {f"{name}.{m}.{s}": getattr(metric, s).tolist()
            for name, col in cols.items() for m, metric in col.items() for s in metric._defaults}
"""

_WORKER = textwrap.dedent("""
    import json, sys, warnings
    import numpy as np, torch, torch.distributed as dist
    sys.path.insert(0, {repo!r})
    exec(open({common!r}).read())

    warnings.simplefilter("ignore")
    rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=3)
    data = json.load(open({data!r}))

    calls = []
    real_gather, real_reduce = dist.all_gather, dist.all_reduce
    dist.all_gather = lambda *a, **k: (calls.append("all_gather"), real_gather(*a, **k))[1]
    dist.all_reduce = lambda *a, **k: (calls.append("all_reduce"), real_reduce(*a, **k))[1]

    steps = step_collections()
    step_values = []
    for batch in data["steps"][rank]:
        value = plain(steps["rates"](batch["preds"], batch["target"]))
        value.update(plain(steps["ppl"](*ppl_args(batch))))
        step_values.append(value)
    cols = corpus_collections()
    for batch in data["corpus"][rank]:
        feed_corpus(cols, batch)
    result = {{"steps": step_values, "epoch": {{}}, "calls": sorted(set(calls))}}
    for name, col in {{**steps, **cols}}.items():
        result["epoch"].update(plain(col.compute()))
    result["synced"] = {{f"{{name}}.{{m}}.{{s}}": v.tolist() for name, col in cols.items()
                        for m, metric in col.items() for s, v in metric._synced_state().items()}}
    result["calls"] = sorted(set(calls))
    json.dump(result, open(out, "w"))
    dist.destroy_process_group()
""")

_WORDS = ("the", "a", "cat", "sat", "on", "mat", "dog", "ran", "in", "park", ",", ".", "3.5", "&quot;", "It's")


def _text(rng, lo, hi):
    return " ".join(rng.choice(_WORDS, int(rng.integers(lo, hi))))


def _step_batch(seed, n):
    rng = np.random.default_rng(seed)
    target = [_text(rng, 0, 12) for _ in range(n)]
    preds = [" ".join(w for w in t.split() if rng.random() > 0.2) + (" dog" if rng.random() < 0.3 else "")
             for t in target]
    logits = rng.normal(size=(n, 5, 32)).astype(np.float32) * 2
    ids = rng.integers(0, 32, (n, 5))
    ids[rng.random((n, 5)) < 0.1] = -100
    return {"preds": preds, "target": target, "logits": logits.ravel().tolist(), "ids": ids.ravel().tolist()}


def _corpus_batch(seed, n):
    rng = np.random.default_rng(seed)
    refs = [[_text(rng, 1, 14) for _ in range(int(rng.integers(1, 3)))] for _ in range(n)]
    preds = [" ".join(rng.permutation(r[0].split())[: max(1, len(r[0].split()) - 1)]) for r in refs]
    return {"preds": preds, "refs": refs}


# per rank and step: the step batch sizes (rank 1's second batch empty); corpus batches per rank
_STEPS = [[4, 3, 5], [2, 0, 6], [1, 2, 3]]
_CORPUS = [[6, 3, 8], [5], []]


def test_three_rank_gloo_text_sync_equals_one_process(tmp_path):
    data = {"steps": [[_step_batch(100 * r + i, n) for i, n in enumerate(sizes)] for r, sizes in enumerate(_STEPS)],
            "corpus": [[_corpus_batch(200 * r + i, n) for i, n in enumerate(sizes)] for r, sizes in enumerate(_CORPUS)]}
    path = tmp_path / "batches.json"
    path.write_text(json.dumps(data))
    common = tmp_path / "common.py"
    common.write_text(_COMMON)
    script = tmp_path / "worker.py"
    script.write_text(_WORKER.format(repo=str(_REPO), common=str(common), data=str(path)))
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

    namespace = {}
    exec(_COMMON, namespace)
    plain, ppl_args = namespace["plain"], namespace["ppl_args"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        one_steps = namespace["step_collections"]()
        want_steps = []
        for step in range(len(_STEPS[0])):
            merged = {k: [] for k in ("preds", "target", "logits", "ids")}
            for rank in range(3):
                for k in merged:
                    merged[k] += data["steps"][rank][step][k]
            value = plain(one_steps["rates"](merged["preds"], merged["target"]))
            value.update(plain(one_steps["ppl"](*ppl_args(merged))))
            want_steps.append(value)
        one = namespace["corpus_collections"]()
        for batch in (b for rank in data["corpus"] for b in rank):
            namespace["feed_corpus"](one, batch)
        want_epoch = {}
        for col in (*one_steps.values(), *one.values()):
            want_epoch.update(plain(col.compute()))
        want_states = namespace["states"](one)

    for r, res in enumerate(results):
        assert res["calls"] == ["all_reduce"], f"rank {r}: text syncs through the sum bucket alone"
        for step, (got, want) in enumerate(zip(res["steps"], want_steps)):
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=f"rank {r} step {step} {k}")
        assert sorted(res["epoch"]) == sorted(want_epoch)
        for k in want_epoch:
            np.testing.assert_allclose(res["epoch"][k], want_epoch[k], rtol=RTOL, err_msg=f"rank {r} epoch {k}")
        assert sorted(res["synced"]) == sorted(want_states)
        for k, want in want_states.items():
            got = res["synced"][k]
            if np.asarray(want).dtype.kind == "i":
                assert got == want, f"rank {r} {k}"
            else:
                np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=f"rank {r} {k}")
    assert 0 < want_epoch["BLEUScore"] < 1 and 0 < want_epoch["WER"] < 1
