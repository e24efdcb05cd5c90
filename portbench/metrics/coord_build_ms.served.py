"""The coordinator's host work on a job: `coord.build_chunks` (the chunk
witnesses with their SMT paths, chained roots), in ms, the mean over the
window's jobs."""

from portbench import fleet

HOOKS = []


def read(run):
    got = fleet.records(run)
    if not got:
        return None
    took = [r["end"] - r["start"] for r in
            fleet.inside(run, got["coordinator"], "coord.build_chunks")]
    return 1e3 * sum(took) / len(took) if took else None
