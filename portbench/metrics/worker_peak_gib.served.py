"""The largest worker's device memory: the most `peak_bytes` (its
torch.cuda.max_memory_allocated on its own card, since it started) of the
workers, in GiB; None on the CPU."""

from portbench import fleet

HOOKS = []


def read(run):
    got = fleet.records(run)
    peaks = [w.get("peak_bytes", 0) for w in got["workers"]] if got else []
    return max(peaks) / 2**30 if peaks and max(peaks) > 0 else None
