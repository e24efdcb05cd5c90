"""What the coordinator's dispatch of a chunk adds to its prove: the
coordinator's `coord.dispatch` (encode, the HTTP round trip, decode) minus
the same request's `chunk.prove` in its worker, in ms, the mean over the
window's chunk proofs: the wire, the JSON and the wait at the worker."""

from portbench import fleet

HOOKS = []


def read(run):
    got = fleet.records(run)
    if not got:
        return None
    prove = {r["request"]: r["end"] - r["start"]
             for w in got["workers"]
             for r in fleet.inside(run, w["spans"], "chunk.prove")}
    over = [r["end"] - r["start"] - prove[r["request"]]
            for r in fleet.inside(run, got["coordinator"], "coord.dispatch")
            if r["request"] in prove]
    return 1e3 * sum(over) / len(over) if over else None
