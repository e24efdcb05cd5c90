"""The readers of the program's spans (portbench/spans.py and the metrics
that use it) on a synthetic run: known spans and windows give known
values; no spans, spans outside the window, a ring that dropped records
from inside the window, or a program that records no spans give None."""

import pytest

from portbench import harness as H

NEW = ("msm_host_finish_ms.chunk", "h_stage_ms.chunk",
       "host_stage_wait_ms.chunk", "pageable_h2d_mib.chunk",
       "idle_unattributed_share.chunk")
MIB = 2**20


def record(id, parent, request, name, start, end, counts=None):
    from zelana_tpu_torch.trace import Record

    return Record(id, parent, request, name, 1, "t", start, end, counts or {})


def two_proofs() -> list:
    """Two chunk proofs over [0, 10] s: containers over leaves. The leaves
    cover the device's idle gaps (see run()) except [4, 5] and [6, 7]."""
    rows = [
        (1, 0, "1", "chunk.batch", 0.0, 10.0, {}),
        (2, 1, "1/0", "chunk.prove", 0.0, 5.0, {}),
        (3, 1, "1/1", "chunk.prove", 5.0, 10.0, {}),
        (4, 2, "1/0", "chunk.wait_host_stage", 0.0, 1.0, {}),
        (5, 3, "1/1", "chunk.wait_host_stage", 7.0, 7.1, {}),
        (6, 2, "1/0", "h.stage", 2.0, 3.0, {}),
        (7, 3, "1/1", "h.stage", 7.1, 9.1, {}),
        (8, 6, "1/0", "msm.upload", 2.0, 4.0,
         {"bytes": 2 * MIB, "pinned": False}),
        (9, 7, "1/1", "msm.upload", 7.1, 9.0,
         {"bytes": MIB, "pinned": False}),
        (10, 7, "1/1", "wm.upload", 9.0, 9.1,
         {"bytes": 4 * MIB, "pinned": True}),
        (11, 3, "1/1", "msm.finish_host", 9.1, 9.4, {"segments": 18}),
        (12, 3, "1/1", "msm.finish_host", 9.4, 9.7, {"segments": 32}),
        (13, 2, "1/0", "msm.finish_host", 3.0, 3.3, {"segments": 18}),
        (14, 3, "1/1", "prove.assembly", 9.7, 10.0, {}),
        (15, 7, "1/1", "msm.upload", 9.0, 9.05,
         {"bytes": 8 * MIB, "pinned": True}),
    ]
    # records enter the ring as their spans end
    return [record(*r) for r in sorted(rows, key=lambda r: r[5])]


def run(window=(0.0, 10.0)):
    kept = {"start": 0.0, "end": 10.0, "kernels": 3, "launches": 3,
            "events": [("k", 1.0, 2.0), ("k", 5.0, 6.0)], "busy_s": 2.0}
    short = dict(kept, kernels=1, events=[])  # dropped by kept_windows
    return H.Run(session=None, proofs=2, units=[], window=window,
                 windows=[kept, short])


def read(name, r):
    return H.load_module("metrics", name).read(r)


@pytest.fixture
def spans(monkeypatch):
    from zelana_tpu_torch import trace

    got = []
    monkeypatch.setattr(trace, "spans", lambda: list(got))
    return got


def test_known_values(spans):
    spans.extend(two_proofs())
    r = run()
    assert read("msm_host_finish_ms.chunk", r) == pytest.approx(450.0)
    assert read("h_stage_ms.chunk", r) == pytest.approx(1500.0)
    assert read("host_stage_wait_ms.chunk", r) == pytest.approx(550.0)
    assert read("pageable_h2d_mib.chunk", r) == pytest.approx(1.5)
    # idle: [0, 1], [2, 5], [6, 10] = 8 s; the leaves leave [4, 5] and
    # [6, 7] uncovered (the containers over them do not count)
    assert read("idle_unattributed_share.chunk", r) == pytest.approx(0.25)


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read(spans, monkeypatch, name):
    from zelana_tpu_torch import trace

    assert read(name, run()) is None  # no spans
    spans.extend(two_proofs())
    assert read(name, run(window=(20.0, 30.0))) is None  # none inside
    monkeypatch.setattr(trace, "RING", len(spans))
    assert read(name, run()) is None  # a full ring: it may have dropped some
    monkeypatch.setattr(trace, "RING", len(spans) + 1)
    assert read(name, run()) is not None
    monkeypatch.delattr(trace, "spans")
    assert read(name, run()) is None  # a program with no spans


def test_full_ring_before_the_window_is_read(spans, monkeypatch):
    """A full ring whose oldest record ended before the window lost only
    records from before it: the reading stands."""
    from zelana_tpu_torch import trace

    spans.extend(two_proofs())
    spans.insert(0, record(99, 0, None, "keygen", -5.0, -4.0))
    monkeypatch.setattr(trace, "RING", len(spans))
    assert read("h_stage_ms.chunk", run(window=(-1.0, 10.0))) == \
        pytest.approx(1500.0)
    assert read("h_stage_ms.chunk", run(window=(-6.0, 10.0))) is None


def test_no_kept_window(spans):
    spans.extend(two_proofs())
    r = run()
    r.windows = r.windows[1:]
    assert read("idle_unattributed_share.chunk", r) is None
    assert read("h_stage_ms.chunk", r) == pytest.approx(1500.0)
