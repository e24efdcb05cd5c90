"""Device time of the host-to-device copies a chunk proof (the profiler's
Memcpy HtoD events: the witness-map inputs, the schedules), over the
windows that kept all their kernels."""

from portbench.harness import device_ms, kept_windows, proofs_in

HOOKS = []


def read(run):
    kept = kept_windows(run)
    n = proofs_in(run, kept)
    return device_ms(kept, ("Memcpy HtoD",)) / n if n else None
