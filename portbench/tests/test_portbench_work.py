"""The work counts and the trace reader, on numbers worked by hand."""
import pytest

from portbench import trace_reader
from portbench.work import peaks, ssim_family


def test_ssim_family_work_at_the_cell_shape():
    wk = ssim_family.work((16, 3, 512, 512))
    pixels = 16 * 3 * 512 * 512
    ms_pixels = sum(16 * 3 * (512 >> s) ** 2 for s in range(5))
    assert wk["flops"] == 5 * 2 * 11 * 2 * (2 * pixels + ms_pixels) == 9_223_864_320
    assert wk["bytes"] == 3 * 2 * pixels * 4 == 301_989_888
    b = ssim_family.bound_ms((16, 3, 512, 512), peaks.H100_SXM)
    assert b["bound_by"] == "compute" and b["ms"] == pytest.approx(9_223_864_320 / 67e12 * 1e3)
    assert b["memory_ms"] == pytest.approx(301_989_888 / 3.35e12 * 1e3)


def _x(name, cat, ts, dur, corr=None):
    ev = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def _trace(drop_last=False):
    """Two units of 100 us; in each, two member forwards that launch one kernel each."""
    ev = []
    for u, base in enumerate((0.0, 200.0)):
        ev.append(_x("portbench.unit", "user_annotation", base, 100))
        ev.append(_x("portbench.forward", "user_annotation", base + 1, 60))
        ev.append(_x("portbench.read", "user_annotation", base + 70, 30))
        for j, (name, k) in enumerate((("SSIM", "filter_kernel"), ("PSNR", "sum_kernel"))):
            corr = 10 * u + j
            ev.append(_x("metric.forward", "user_annotation", base + 2 + 20 * j, 15))
            ev.append(_x("cudaLaunchKernel", "cuda_runtime", base + 3 + 20 * j, 1, corr))
            if not (drop_last and u == 1 and j == 1):
                ev.append(_x(k, "kernel", base + 10 + 30 * j, 20, corr))
        ev.append(_x("cudaMemcpyAsync", "cuda_runtime", base + 72, 1, 99 + u))
        ev.append(_x("Memcpy DtoH", "gpu_memcpy", base + 90, 5, 99 + u))
    return ev


def test_summarize_units_groups_and_gaps():
    members = ["SSIM", "PSNR", "SSIM", "PSNR"]
    t = trace_reader.summarize(_trace(), members, {"family": ["SSIM"]}, event_ms=[0.1, 0.1])
    assert not t["notes"]
    assert [u["ops"] for u in t["units"]] == [3, 3]
    assert t["units"][0]["busy_ms"] == pytest.approx(0.045)
    assert t["units"][0]["groups"]["family"] == pytest.approx(0.020)
    assert t["window_s"] == pytest.approx(300e-6) and t["busy_s"] == pytest.approx(90e-6)
    gaps = dict((n, s) for n, s in t["idle_gaps"])
    assert gaps["portbench.between_units"] == pytest.approx(100e-6)
    assert gaps["portbench.read"] == pytest.approx(2 * (20 + 5) * 1e-6)
    assert sum(gaps.values()) == pytest.approx(210e-6)
    assert trace_reader.unit_mean_ms(t, lambda n: "filter" in n) == pytest.approx(0.020)
    assert trace_reader.unit_mean_ms(t, lambda n: "nccl" in n) is None


def test_summarize_names_dropped_records_and_unmatched_members():
    t = trace_reader.summarize(_trace(drop_last=True), ["SSIM", "PSNR", "SSIM", "PSNR"], {"family": ["SSIM"]})
    assert [u["ops"] for u in t["units"]] == [3] and any("dropped" in n for n in t["notes"])
    t = trace_reader.summarize(_trace(), ["SSIM"], {"family": ["SSIM"]})
    assert t["units"][0]["groups"] == {} and any("not attributed" in n for n in t["notes"])


def test_summarize_flags_busy_above_event_time():
    t = trace_reader.summarize(_trace(), [], {}, event_ms=[0.01, 0.1])
    assert any("exceeds its CUDA-event time" in n for n in t["notes"])
