"""Device milliseconds a step of the operations launched inside the forwards
of SSIM, MultiScaleSSIM and UQI (the configuration's ``ssim_family`` group;
the port's span tracer opens a ``metric.forward`` range a member), the mean
over the profiled steps."""
UNIT = "ms"
GROUP = "ssim_family"


def read(rec):
    t = rec["trace"]
    if rec["unit"] != "step" or not t or not t.get("units"):
        return None
    per = [u["groups"].get(GROUP) for u in t["units"]]
    if any(v is None for v in per) or not any(per):
        return None
    return sum(per) / len(per)
