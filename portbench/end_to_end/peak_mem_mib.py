"""Peak device memory of the window: ``torch.cuda.max_memory_allocated()``
after ``reset_peak_memory_stats()`` at its start, the largest over ranks. MiB."""
UNIT = "MiB"


def read(rec):
    return rec["peak_bytes"] / 2**20 if rec["peak_bytes"] else None
