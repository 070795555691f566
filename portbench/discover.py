"""Finds the benchmark's parts by name: cells in ``BENCHMARK.json``, and the
configuration, traffic, generator, loop, reference and metric files under
this folder. Adding a part is adding a file; nothing here lists them."""
import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Any, Dict

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _checked(name: str) -> str:
    if not _NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def benchmark(root: Path = ROOT) -> Dict[str, Any]:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def with_staged(bench: Dict[str, Any]) -> Dict[str, Any]:
    """``bench`` with the staged cells of ``staged.json`` and their entries after its own: cells built and
    tested that ``BENCHMARK.json`` does not name yet. Each staged metric names its cells, so none of it
    reaches a cell of ``BENCHMARK.json``."""
    with open(HERE / "staged.json") as f:
        staged = json.load(f)
    return {**bench, **{k: bench.get(k, []) + staged[k] for k in ("configs", "workloads", "end_to_end", "per_layer")}}


def cell(bench: Dict[str, Any], name: str) -> Dict[str, Any]:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def json_part(kind: str, name: str) -> Dict[str, Any]:
    """``<kind>/<name>.json`` under this folder (a configuration or a traffic mix)."""
    with open(HERE / kind / f"{_checked(name)}.json") as f:
        return json.load(f)


def module(kind: str, name: str) -> ModuleType:
    """``<kind>/<name>.py`` under this folder, loaded once a process; where
    there is none, the file of the name's first part, which reads every
    metric of that quantity (``layer_metrics/sort_ms.py`` reads ``sort_ms.epoch``
    and ``sort_ms.ddp``, each in the cells that report it). A name may hold
    dots, so the file is loaded by its path."""
    path = HERE / kind / f"{_checked(name)}.py"
    if not path.is_file() and "." in name:
        path = HERE / kind / f"{name.split('.')[0]}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path.relative_to(ROOT)}")
    key = f"portbench.{kind}.{path.stem}"
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def metrics_of(bench: Dict[str, Any], section: str, workload: str):
    """The entries of ``end_to_end`` or ``per_layer`` that ``workload`` reports:
    those without a ``workloads`` key, and those whose key names it."""
    return [m for m in bench[section] if "workloads" not in m or workload in m["workloads"]]
