"""Set-up: from the start of rank 0's process to the first timed unit (imports,
CUDA and the process group, the inputs made on the device, the collection
built, every shape warmed up). Seconds, host clock."""
UNIT = "s"


def read(rec):
    return rec["setup_s"]
