"""Every part that BENCHMARK.json names is found by its name, and says what
the benchmark says of it."""
import json

import pytest

from portbench import discover

BENCH = discover.benchmark()
ALL = discover.with_staged(BENCH)  # with the staged cells, which BENCHMARK.json does not name yet
E2E = {m["name"]: m for m in BENCH["end_to_end"]}


@pytest.mark.parametrize("cell", ALL["workloads"], ids=lambda c: c["name"])
def test_cell_parts_found_by_name(cell):
    cfg = discover.json_part("configs", cell["config"])
    traffic = discover.json_part("traffic", cell["traffic"])
    assert cfg["name"] == cell["config"]
    gen = discover.module("data", cfg["data"]["kind"])
    assert callable(gen.make)
    loop = discover.module("loops", traffic["loop"])
    for fn in ("warm", "window", "traced_units", "unit"):
        assert callable(getattr(loop, fn))
    assert loop.UNIT in ("step", "epoch")
    ref = discover.module("reference", cell["config"])
    assert ref.LIMITS and callable(ref.expected) and callable(ref.compare)
    reported = discover.metrics_of(ALL, "end_to_end", cell["name"])
    assert "setup_s" in [m["name"] for m in reported] and len(reported) >= 2
    assert discover.metrics_of(ALL, "per_layer", cell["name"])


@pytest.mark.parametrize("entry", ALL["configs"], ids=lambda c: c["name"])
def test_config_entry_matches_its_file(entry):
    with open(discover.ROOT / entry["file"]) as f:
        cfg = json.load(f)
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"] and cfg["reduced"] == entry["reduced"]
    assert any(w["config"] == entry["name"] for w in ALL["workloads"])
    staged = entry not in BENCH["configs"]
    assert staged == all(w not in BENCH["workloads"] for w in ALL["workloads"] if w["config"] == entry["name"])


@pytest.mark.parametrize("entry", ALL["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_reader(entry):
    mod = discover.module("end_to_end", entry["name"])
    assert mod.UNIT == entry["unit"] and callable(mod.read)
    assert entry["source"] in ("host_clock", "device_trace")
    if entry in BENCH["end_to_end"]:  # a staged metric has no bound until it is measured
        assert 0 < entry["bound"] <= 0.25
    else:
        assert entry["bound"] is None and entry["workloads"]


@pytest.mark.parametrize("entry", ALL["per_layer"], ids=lambda m: m["name"])
def test_layer_reader(entry):
    mod = discover.module("layer_metrics", entry["name"])
    assert mod.UNIT == entry["unit"] and callable(mod.read)
    assert entry["moves"] in [m["name"] for m in ALL["end_to_end"]]
    for w in entry["workloads"]:  # every listed cell reports the metric it moves
        assert entry["moves"] in [m["name"] for m in discover.metrics_of(ALL, "end_to_end", w)]
    if entry in BENCH["per_layer"]:
        assert all(w in [c["name"] for c in BENCH["workloads"]] for w in entry["workloads"])


def test_layers_and_names_follow_the_benchmark_format():
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"], []).append(m["name"])
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in ALL[k]]
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)
    assert all(len(w["why"]) <= 200 for w in BENCH["workloads"] + BENCH["configs"])
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_a_quantity_file_reads_each_of_its_named_metrics():
    assert discover.module("layer_metrics", "sort_ms.ddp") is discover.module("layer_metrics", "sort_ms.epoch")
    assert discover.module("layer_metrics", "sort_ms.ddp").__file__.endswith("layer_metrics/sort_ms.py")
    assert discover.module("end_to_end", "epoch_ms.ddp") is discover.module("end_to_end", "epoch_ms")
    with pytest.raises(FileNotFoundError):
        discover.module("layer_metrics", "no_such_quantity.epoch")


def test_unknown_names_are_refused():
    with pytest.raises(ValueError):
        discover.module("layer_metrics", "../run")
    with pytest.raises(FileNotFoundError):
        discover.module("layer_metrics", "no_such_metric")
