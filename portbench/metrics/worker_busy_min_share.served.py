"""The dispatch's balance: the least busy worker's share of the window,
its `chunk.prove` spans' union over the window's wall time (1: every worker
proved all through the window)."""

from portbench import fleet

HOOKS = []


def read(run):
    shares = fleet.busy_shares(run)
    return min(shares) if shares else None
