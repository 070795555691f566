"""The command as the benchmark's runner calls it: its exits, its last line,
and the modules it may not load. Rehearsals run on the CPU at the
configurations' rehearsal sizes."""
import json
import shutil
import subprocess
import sys
import types

import pytest

from portbench import discover, run

RUN = [sys.executable, str(discover.HERE / "run.py")]
CELLS = [w["name"] for w in discover.benchmark()["workloads"]]
STAGED = [w["name"] for w in discover.with_staged({})["workloads"] if w["chips"] == 1]


def _run(*args, cwd=discover.ROOT):
    return subprocess.run([*RUN, *args], capture_output=True, text=True, timeout=300, cwd=cwd)


def test_no_card_no_result():
    r = _run("--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0")
    assert r.returncode == run.EXIT_NO_CARD and r.stdout == ""


@pytest.mark.parametrize("workload", CELLS + STAGED)
@pytest.mark.parametrize("trace", [0, 1])
def test_rehearsal_last_line(workload, trace):
    r = _run("--workload", workload, "--seed", str(2**32 + 3), "--seconds", "1", "--trace", str(trace),
             "--device", "cpu")
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks" and {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    bench = discover.with_staged(discover.benchmark())
    section = "per_layer" if trace else "end_to_end"
    allowed = {m["name"]: m["unit"] for m in discover.metrics_of(bench, section, workload)}
    assert line["metrics"] and all(allowed[k] == v["unit"] for k, v in line["metrics"].items())
    tail = r.stderr.strip().splitlines()[-len(line["checks"]):]
    assert [t.split()[1] for t in tail] == list(line["checks"])
    assert all(v["value"] <= v["limit"] for v in line["checks"].values())


def test_forbidden_modules_compare_whole_names(monkeypatch):
    import metrics_tpu_torch  # noqa: F401  (the port: its name only begins with the JAX package's)

    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "metrics_tpu_tools", types.ModuleType("metrics_tpu_tools"))
    monkeypatch.setitem(sys.modules, "jaxish", types.ModuleType("jaxish"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "metrics_tpu.core", types.ModuleType("metrics_tpu.core"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert run.forbidden_modules() == ["jax", "metrics_tpu"]


def test_harness_imports_no_jax():
    code = ("import sys; from portbench import run, discover, tracing, calibrate, trace_reader;"
            "import metrics_tpu_torch, metrics_tpu_torch.observability;"
            "[discover.module(k, p.stem) for k in ('data', 'loops', 'reference', 'layer_metrics', 'end_to_end')"
            " for p in (discover.HERE / k).glob('*.py')];"
            "print(run.forbidden_modules())")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, cwd=discover.ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "[]"


def test_benchmark_files_alone_do_not_run(tmp_path):
    shutil.copy(discover.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(discover.HERE, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0", "--device", "cpu"], capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert r.returncode != 0 and r.stdout == ""
