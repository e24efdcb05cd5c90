"""The card's idle time that the program's spans do not name: over the
profiler windows that kept all their kernels, the idle gaps between device
events (harness.gaps) less what the union of the leaf spans, on any
thread, covers, as a share of the idle time."""

from portbench.spans import idle_unattributed_share

HOOKS = []


def read(run):
    return idle_unattributed_share(run)
