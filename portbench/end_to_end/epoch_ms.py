"""Milliseconds an epoch: the whole window over the epochs completed in it
(the window holds whole epochs)."""
UNIT = "ms"


def read(rec):
    if rec["unit"] != "epoch" or not rec["units"]:
        return None
    return rec["window_s"] * 1e3 / rec["units"]
