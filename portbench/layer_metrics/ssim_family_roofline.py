"""The SSIM family's share of its roofline a step: the least time its work
needs on the published H100 peaks (``work/ssim_family.py``: the larger of its
bytes over HBM bandwidth and its filter operations over float32 outside the
tensor cores, since the filter refuses TF32), over its measured device ms
(``ssim_family_device_ms``)."""
from portbench import discover
from portbench.work import peaks, ssim_family

UNIT = "%"


def read(rec):
    device_ms = discover.module("layer_metrics", "ssim_family_device_ms").read(rec)
    if not device_ms:
        return None
    d = rec["cfg"]["data"]
    shape = (d["batch"], d["channels"], d["height"], d["width"])
    return 100.0 * ssim_family.bound_ms(shape, peaks.H100_SXM)["ms"] / device_ms
