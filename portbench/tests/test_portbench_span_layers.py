"""The span-layer metrics of the image cell, on a CPU rehearsal: the traced
line reports each of the six as a number, the idle ones (the whole window is
idle on a CPU) at least the host ones of the same layer, and a program
without the attribution leaves them out."""
import json
import subprocess
import sys

from portbench import discover

NEW = [f"{layer}_{kind}_ms.step" for kind in ("host", "idle") for layer in ("runtime", "sync", "update")]


def test_rehearsal_reports_the_span_layer_metrics():
    r = subprocess.run([sys.executable, str(discover.HERE / "run.py"), "--workload", "div2k_ssim.step", "--seed",
                        str(2**32 + 11), "--seconds", "1", "--trace", "1", "--device", "cpu"],
                       capture_output=True, text=True, timeout=300, cwd=discover.ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    metrics = json.loads(r.stdout.strip().splitlines()[-1])["metrics"]
    for name in NEW:
        assert isinstance(metrics[name]["value"], float) and metrics[name]["value"] > 0.0, name
        assert metrics[name]["unit"] == "ms"
    for layer in ("runtime", "sync", "update"):
        assert metrics[f"{layer}_idle_ms.step"]["value"] >= metrics[f"{layer}_host_ms.step"]["value"] * 0.99
    declared = {m["name"]: m for m in discover.benchmark()["per_layer"]}
    assert all(declared[name]["workloads"] == ["div2k_ssim.step"] for name in NEW)


def test_readers_read_nothing_without_the_attribution(monkeypatch):
    from metrics_tpu_torch.observability import devtime

    from portbench import span_layers

    monkeypatch.delattr(devtime, "idle_attribution")
    monkeypatch.setattr(span_layers, "_LAST", {})
    rec = {"units": 12}
    assert all(discover.module("layer_metrics", name).read(rec) is None for name in NEW)
