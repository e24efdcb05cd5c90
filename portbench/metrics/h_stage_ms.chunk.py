"""The h stage a chunk proof: the program's `h.stage` span (on its worker
thread: the h coefficients' download, their decode, digits and segment
schedules, the schedules' uploads), in ms, over the chunk proofs of the
window."""

from portbench.spans import per_proof

HOOKS = []


def read(run):
    got = per_proof(run, "h.stage")
    return None if got is None else 1e3 * got
