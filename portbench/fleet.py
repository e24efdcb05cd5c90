"""Readers of a served cell's records: the coordinator's `GET /spans` (its
process's zelana_tpu_torch.trace ring) and each chunk worker's (its ring,
its `device`, its `peak_bytes`), which the session collects after the
window (`fleet_records()`). Every process of the
host records on one clock, time.perf_counter() (CLOCK_MONOTONIC), so the
workers' spans are placed in the run's window as they stand.

A record is a dict: id, parent, request ("<batch id>/<chunk index>" a
chunk), name, thread, thread_name, start, end, counts. Each reader gives
None where it has nothing sound to read: a session that collects no such
records, or none inside the window."""

from __future__ import annotations

from portbench.harness import union_s


def records(run):
    """The session's {"coordinator": [...], "workers": [...]}, or None."""
    get = getattr(run.session, "fleet_records", None)
    return get() if get is not None else None


def inside(run, rows, name: str) -> list:
    """The records named `name` that lie inside the run's window."""
    lo, hi = run.window
    return [r for r in rows
            if r["name"] == name and lo <= r["start"] and r["end"] <= hi]


def busy_shares(run):
    """Each worker's share of the window's wall time covered by the union
    of its `chunk.prove` spans (clipped to the window); None where there
    are no workers."""
    got = records(run)
    if not got or not got["workers"]:
        return None
    lo, hi = run.window
    out = []
    for w in got["workers"]:
        spans = [(max(r["start"], lo), min(r["end"], hi))
                 for r in w["spans"] if r["name"] == "chunk.prove"
                 and r["end"] > lo and r["start"] < hi]
        out.append(union_s(spans) / (hi - lo))
    return out
