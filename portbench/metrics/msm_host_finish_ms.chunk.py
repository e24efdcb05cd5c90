"""The MSMs' host finish a chunk proof: the sum of the program's
`msm.finish_host` spans (msm_scan.msm_end_many: each MSM's segment finals
added up in Python integers, its identity correction), in ms, over the
chunk proofs of the window."""

from portbench.spans import per_proof

HOOKS = []


def read(run):
    got = per_proof(run, "msm.finish_host")
    return None if got is None else 1e3 * got
