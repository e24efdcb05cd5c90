"""The window rule, the interval arithmetic and the window choice."""

import time

import pytest

from portbench import frozen
from portbench import harness as H


class Units:
    def __init__(self, seconds, per_unit=2):
        self.seconds, self.per_unit, self.started = seconds, per_unit, []

    def run_unit(self):
        self.started.append(time.perf_counter())
        time.sleep(self.seconds)
        return [object()] * self.per_unit


def test_window_counts_every_proof_and_overruns_one_unit():
    s = Units(0.07)
    run = H.run_window(s, 0.2)
    t0, t1 = run.window
    assert all(t - t0 < 0.2 for t in s.started)  # new work only before
    assert t1 - t0 >= 0.2
    assert t1 - t0 < 0.2 + 0.07 + 0.05  # at most one unit past
    assert run.proofs == 2 * len(s.started) == 2 * len(run.units)


def test_window_of_one_long_unit():
    run = H.run_window(Units(0.3, 5), 0.1)
    assert len(run.units) == 1 and run.proofs == 5


def test_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert H.union_s(iv) == pytest.approx(3.0)
    assert H.gaps(iv, -1.0, 5.0) == [(-1.0, 0.0), (2.0, 3.0), (4.0, 5.0)]
    assert H.union_s([]) == 0


def window(kernels, launches, busy, wall=1.0):
    return {"start": 0.0, "end": wall, "events": [], "kernels": kernels,
            "launches": launches, "busy_s": busy}


def test_short_windows_dropped():
    ws = [window(10, 10, 0.1), window(9, 10, 0.5), window(12, 10, 0.2)]
    assert frozen.choose_windows(ws) == [ws[0], ws[2]]
    run = H.Run(session=None, proofs=0, units=[], window=(0, 3), windows=ws)
    assert H.idle_share(run) == pytest.approx(1 - 0.3 / 2)
    run.windows = [ws[1]]
    assert H.idle_share(run) is None


def test_quantile():
    assert H.quantile([5.0], 0.9) == 5.0
    assert H.quantile(list(range(1, 12)), 0.9) == pytest.approx(10.0)


def test_breakdown_names_gaps_by_span():
    hooks = H.Hooks()
    hooks.spans["synthesize_chunk"] = [(1, 0.0, 0.5)]
    w = {"start": 0.0, "end": 1.0, "events": [("k", 0.6, 0.7),
                                              ("k", 0.8, 0.9)],
         "kernels": 2, "launches": 2, "busy_s": 0.2}
    out = H.breakdown([w], hooks)
    assert out["device_ops"] == [["k", pytest.approx(0.2)]]
    assert out["idle_gaps"][0] == ["synthesize_chunk", pytest.approx(0.6)]


def test_launches_per_prove_counts_each_call():
    import types

    cuda = types.SimpleNamespace(LAUNCHES={"ntt_pass": 0, "runscan": 0})

    def prove_synthesized(n):
        cuda.LAUNCHES["ntt_pass"] += 21
        cuda.LAUNCHES["runscan"] += n
        return n

    mod = types.SimpleNamespace(prove_synthesized=prove_synthesized)
    with frozen.launches_per_prove(mod, cuda) as per:
        mod.prove_synthesized(208)
        mod.prove_synthesized(0)
    assert per == [{"ntt_pass": 21, "runscan": 208}, {"ntt_pass": 21}]
    assert mod.prove_synthesized is prove_synthesized


def test_device_busy_of_a_host_profile():
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(8).sum()
    assert frozen.device_events(prof) == []
    assert frozen.device_busy_ms(prof) == 0
