"""prove_chunks' waits for a chunk's host stage: the sum of the program's
`chunk.wait_host_stage` spans (the main thread waiting on the worker's
synthesis, check, digits, schedules and uploads; the first chunk of a batch
waits for all of it), in ms, over the chunk proofs of the window."""

from portbench.spans import per_proof

HOOKS = []


def read(run):
    got = per_proof(run, "chunk.wait_host_stage")
    return None if got is None else 1e3 * got
