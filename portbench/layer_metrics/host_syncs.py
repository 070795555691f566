"""Synchronizing CUDA calls a unit (the harness's value read among them),
counted with ``torch.cuda.set_sync_debug_mode("warn")``, the mean over the
first two traced units (or the one)."""
UNIT = "calls"


def read(rec):
    n = rec["host_syncs"]
    return sum(n) / len(n) if n else None
