"""The card's idle share over the traced windows of the chunk cell: 1 - the
union of device activity intervals / the windows' wall time (windows short
of the port's counted launches left out)."""

from portbench.harness import idle_share

HOOKS = []


def read(run):
    return idle_share(run)
