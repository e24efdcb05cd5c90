"""The run-scan segment schedules built on the schedule pool
(msm_scan.build_segment_schedules), on the CPU: every entry equals the one
thread's build_schedule of its slice, array for array, whatever thread
built it and however many calls build at once; one segment builds on the
calling thread."""

import os
import sys
import threading

import numpy as np
import pytest

from zelana_tpu_torch.ops import msm_scan as MSM

CHUNK = 256
ARRAYS = ("pid", "flag", "pos2", "flag2", "dense_idx")


def digits_of(kind: str, n: int, seed: int) -> np.ndarray:
    """(32, n) window digits: uniform, or mostly zero and one (the boolean
    entries of a witness vector)."""
    rng = np.random.default_rng(seed)
    d = rng.integers(0, MSM.SCAN_BUCKETS, size=(MSM.SCAN_WINDOWS, n),
                     dtype=np.int32)
    if kind == "skewed":
        d[rng.random(d.shape) < 0.6] = 0
        d[rng.random(d.shape) < 0.2] = 1
    return d


def assert_serial(segs: list, digits: np.ndarray) -> None:
    """segs: entry for entry the segments of CHUNK points, each with
    build_schedule's arrays of its slice."""
    n = digits.shape[1]
    assert [(s["lo"], s["hi"]) for s in segs] == [
        (lo, min(lo + CHUNK, n)) for lo in range(0, n, CHUNK)]
    for seg in segs:
        want = MSM.build_schedule(digits[:, seg["lo"]:seg["hi"]])
        assert seg["dev"] is None
        for k in ARRAYS:
            got = getattr(seg["sched"], k)
            assert got.dtype == getattr(want, k).dtype, (seg["lo"], k)
            assert np.array_equal(got, getattr(want, k)), (seg["lo"], k)


@pytest.fixture
def fresh_pool(monkeypatch):
    """The schedule pool made anew for the test and shut down after it."""
    monkeypatch.setattr(MSM, "_POOL", None)
    yield
    if MSM._POOL is not None:
        MSM._POOL.shutdown()


@pytest.mark.parametrize("kind,n", [("uniform", 16 * CHUNK),
                                    ("skewed", 16 * CHUNK),
                                    ("uniform", 11 * CHUNK + 77)],
                         ids=["uniform", "skewed", "partial_last"])
def test_segments_equal_serial(kind, n):
    """Uniform and skewed digits, and a partial last segment: each entry
    is build_schedule of its slice; no more threads built them than there
    are segments or usable cores."""
    digits = digits_of(kind, n, 7 + n)
    segs = MSM.build_segment_schedules(digits, chunk_n=CHUNK)
    assert_serial(segs, digits)
    counts = MSM.schedule_counts(segs)
    assert counts["segments"] == len(segs)
    assert 1 <= counts["workers"] <= min(len(segs),
                                         len(os.sched_getaffinity(0)))


def test_two_threads_at_once():
    """The same digits built from two threads at once, switching every
    microsecond: both lists equal the serial build."""
    digits = digits_of("uniform", 12 * CHUNK + 5, 11)
    start = threading.Barrier(2)
    got = [None, None]

    def build(k):
        start.wait(timeout=60)
        got[k] = MSM.build_segment_schedules(digits, chunk_n=CHUNK)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=build, args=(k,)) for k in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    for segs in got:
        assert_serial(segs, digits)


def test_one_segment_inline():
    """One segment builds on the calling thread: workers 1."""
    digits = digits_of("uniform", CHUNK - 3, 5)
    segs = MSM.build_segment_schedules(digits, chunk_n=CHUNK)
    assert MSM.schedule_counts(segs) == {"segments": 1, "workers": 1}
    assert segs[0]["worker"] == threading.get_ident()
    assert_serial(segs, digits)


def test_one_pool_from_threads_at_once(fresh_pool):
    """Eight threads asking for the pool at once get the same one, a thread
    a usable core at most."""
    start = threading.Barrier(8)
    got = []

    def ask():
        start.wait(timeout=60)
        got.append(MSM._schedule_pool())

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=ask) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert len(got) == 8 and all(p is got[0] for p in got)
    assert got[0]._max_workers == len(os.sched_getaffinity(0))
