"""Readers of the program's own spans (zelana_tpu_torch.trace), for the
per-layer metrics that read them. A span record has a name, its parent's
id, a request id (one a chunk proof: "<batch id>/<chunk index>"), its
thread, start and end on time.perf_counter() (the clock the profiler
windows are mapped onto) and counts (bytes, pinned, segments).

Each reader gives None where it has nothing sound to read: a program that
records no spans (no `trace.spans`), none of its spans inside the window,
or a full ring whose oldest record ends inside the window (it may have
dropped older ones from inside it)."""

from __future__ import annotations

from portbench.harness import gaps, kept_windows


def window_spans(run):
    """(records inside the run's window, every record of the snapshot), or
    None where there is nothing sound to read."""
    from zelana_tpu_torch import trace

    take = getattr(trace, "spans", None)
    if take is None:
        return None
    snap = take()
    lo, hi = run.window
    if len(snap) >= trace.RING and snap[0].end >= lo:
        return None  # a full ring: records of the window may be gone
    rows = [r for r in snap if lo <= r.start and r.end <= hi]
    return (rows, snap) if rows else None


def per_proof(run, name: str, value=lambda r: r.end - r.start,
              keep=lambda r: True):
    """The sum of value(span) over the window's spans named `name` (and
    kept), over the chunk proofs of the window (the requests with a
    `chunk.prove` span); None where there are none of either."""
    got = window_spans(run)
    if got is None:
        return None
    rows = got[0]
    proofs = {r.request for r in rows if r.name == "chunk.prove"}
    hits = [value(r) for r in rows
            if r.name == name and r.request in proofs and keep(r)]
    if not proofs or not hits:
        return None
    return sum(hits) / len(proofs)


def leaves(snap) -> list:
    """The records no other record names as its parent."""
    parents = {r.parent for r in snap}
    return [r for r in snap if r.id not in parents]


def overlap_s(intervals, lo: float, hi: float) -> float:
    """Seconds of [lo, hi] that the union of (start, end) intervals
    covers."""
    return (hi - lo) - sum(e - s for s, e in gaps(intervals, lo, hi))


def idle_unattributed_share(run):
    """The share of the device's idle time in the kept profiler windows
    that no leaf span, on any thread, covers."""
    got = window_spans(run)
    kept = kept_windows(run)
    if got is None or not kept:
        return None
    cover = [(r.start, r.end) for r in leaves(got[1])]
    idle = uncovered = 0.0
    for w in kept:
        for s, e in gaps([(s, e) for _n, s, e in w["events"]],
                         w["start"], w["end"]):
            idle += e - s
            uncovered += (e - s) - overlap_s(
                [(a, b) for a, b in cover if a < e and b > s], s, e)
    return uncovered / idle if idle else None
