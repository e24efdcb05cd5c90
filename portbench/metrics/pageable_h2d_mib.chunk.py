"""The MSM schedules copied to the card from pageable memory a chunk proof:
the sum of the `bytes` the program's `msm.upload` spans count (pinned
False: msm_scan._upload's five arrays a segment, z's and h's), in MiB, over
the chunk proofs of the window."""

from portbench.spans import per_proof

HOOKS = []


def read(run):
    got = per_proof(run, "msm.upload", value=lambda r: r.counts["bytes"],
                    keep=lambda r: r.counts.get("pinned") is False)
    return None if got is None else got / 2**20
