"""torch.cuda.max_memory_allocated over the timed window (its statistics
reset as the window opens), in GiB."""


def read(rec):
    if rec.peak_bytes is None:
        return None
    return rec.peak_bytes / 2 ** 30
