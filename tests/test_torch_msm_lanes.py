"""The stream shape of the port's run-scan MSM (zelana_tpu_torch.ops.msm_scan):
MSM results that do not depend on the lane count, and the level-2 width that
build_schedule picks from the digit histogram so that skewed digits stay
within the native scheduler's merge layers. Exact equality (group points)
with the JAX package's host curves."""

import functools
import random

import numpy as np
import pytest
import torch

from zelana_tpu.curves import g1 as G1
from zelana_tpu.curves import g2 as G2
from zelana_tpu.fields.bn254 import R as FR
from zelana_tpu_torch.ops import msm_scan as TMS
from zelana_tpu_torch.ops import sched_native

torch.set_num_threads(1)  # many small int64 ops: threads only contend


def _multiples(G, n):
    g = G.generator()
    pts, acc = [], g
    for _ in range(n):
        pts.append(acc)
        acc = G.add(acc, g)
    return pts


@functools.lru_cache(maxsize=None)
def _case(curve: str, n: int):
    """Pool (i + 1) G, seeded scalars with a 0 and a 1 among them, and the
    result: the JAX package's host G2.msm, or for G1 its closed form
    (sum_i s_i (i + 1)) G on the JAX package's host curve."""
    r = random.Random(31 if curve == "g1" else 37)
    G = G1 if curve == "g1" else G2
    pts = _multiples(G, n)
    scalars = [r.randrange(FR) for _ in range(n)]
    scalars[5], scalars[6] = 0, 1
    if curve == "g2":
        return pts, scalars, G2.msm(pts, scalars)
    return pts, scalars, G1.mul(
        G1.generator(), sum(s * (i + 1) for i, s in enumerate(scalars)) % FR)


@pytest.mark.parametrize("curve,n,lanes", [
    ("g1", 2048, 128), ("g1", 2048, 1024), ("g1", 2048, 8192),
    ("g2", 128, 128), ("g2", 128, 512)])
def test_msm_does_not_depend_on_lanes(curve, n, lanes):
    """The emit buffers change with the stream shape; the MSM does not."""
    pts, scalars, want = _case(curve, n)
    prep = (TMS.prepare_g1 if curve == "g1" else TMS.prepare_g2)(pts, "cpu")
    segs = TMS.build_segment_schedules(TMS.scalar_digits(scalars), lanes)
    assert segs[0]["sched"].pid.shape == (32 * n // lanes + 1, lanes)
    assert TMS.msm_end(TMS.msm_begin_scheds(prep, segs)) == want


def _skewed_digits(case: str, n: int) -> np.ndarray:
    rng = np.random.default_rng(41)
    if case == "all-equal":
        return TMS.scalar_digits([0x1234567890ABCDEF1234567890ABCDEF] * n)
    if case == "all-one":
        return TMS.scalar_digits([1] * n)
    # half the scalars with digit 1 in window 0, the rest random
    limbs = rng.integers(0, 1 << 63, size=(n, 4), dtype=np.uint64)
    digits = TMS.scalar_digits(limbs)
    digits[0, ::2] = 1
    return digits


@pytest.mark.parametrize("case", ["all-equal", "half-digit-1", "all-one"])
def test_build_schedule_skewed_digits(case):
    """A full 2^16-point segment at the chosen lane count: the schedule
    builds, its K2 (dense merge layers) is the one level2_lanes predicted,
    within K2_BOUND where a level-2 pass of at least one warp allows it
    and always within the scheduler's KMAX. Schedules only, no scan."""
    digits = _skewed_digits(case, TMS.CHUNK_N)
    s = TMS.build_schedule(digits)
    lanes, R = TMS.level1_shape(digits.size)
    assert s.pid.shape == (R + 1, lanes)
    K2, lanes2 = s.dense_idx.shape[0], s.pos2.shape[1]
    parts = TMS._bucket_partials(digits, R)
    assert K2 == TMS.level2_layers(parts, lanes2) <= TMS.KMAX
    if case != "all-one":
        assert K2 <= TMS.K2_BOUND
    else:
        # one bucket's 2^16 entries: a fixed 1,024-lane level 2 overflows
        with pytest.raises(RuntimeError, match="code 2"):
            sched_native.build_schedule_arrays2(digits, TMS.SCAN_BUCKETS,
                                                lanes, R, 1024)


@pytest.mark.parametrize("case,n", [("all-one", 256), ("ones-and-small", 512)])
def test_msm_skewed_digits_matches_host(case, n):
    """MSMs whose digits pile into one bucket, so that level2_lanes takes
    its narrowest level-2 width, against the JAX package's host G1.msm."""
    r = random.Random(43)
    if case == "all-one":
        scalars = [1] * n
    else:  # three in four scalars 1, the rest below 2^16
        scalars = [1 if i % 4 else r.randrange(1 << 16) for i in range(n)]
    pts = _multiples(G1, n)
    assert TMS.build_schedule(TMS.scalar_digits(scalars)).pos2.shape[1] == \
        TMS.LANES2_MIN
    assert TMS.msm_g1(pts, scalars, device="cpu") == G1.msm(pts, scalars)
