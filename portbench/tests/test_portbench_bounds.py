"""The frozen bound arithmetic against the figures PERF.md §3 and §6 give
(H100: HBM3 3.35 TB/s, int32 16.7 T/s derived; a CIOS product 264
operations, a squaring 208)."""

import pytest
import torch

from portbench import frozen as F


def test_peaks_and_products():
    assert F.MUL_OPS == 264 and F.SQR_OPS == 208
    assert F.INT32_OPS_PER_S == pytest.approx(16.727e12, rel=1e-4)
    assert F.RUNSCAN_MULS == {("g1", False): 11, ("g1", True): 12,
                              ("g2", False): 39, ("g2", True): 42}


@pytest.mark.parametrize("log_n,ntt_ms,wm_ms,ntt_built,wm_built", [
    (13, 0.00071, 0.00562, 0.00078, 0.0066),
    (21, 0.314, 2.367, 0.331, 2.615),
])
def test_ntt_bounds(log_n, ntt_ms, wm_ms, ntt_built, wm_built):
    """§6 row 2: the 2^13 and 2^21 transforms and witness maps, operations
    bound, as the function needs and as the passes are built."""
    def ms(products):
        return F.bound_ms(0, products * F.MUL_OPS)[0]

    assert ms(F.ntt_products("ntt", log_n)) == pytest.approx(ntt_ms, rel=6e-3)
    assert ms(F.witness_map_products(log_n)) == pytest.approx(wm_ms, rel=6e-3)
    assert ms(F.ntt_products("ntt", log_n, True)) == pytest.approx(
        ntt_built, rel=6e-3)
    assert ms(F.witness_map_products(log_n, True)) == pytest.approx(
        wm_built, rel=6e-3)


def test_shielded_witness_map_bound():
    """§6 row 2: the shielded transfer's 2^15 witness map, 0.0261 ms."""
    assert F.bound_ms(0, F.witness_map_products(15) * F.MUL_OPS)[0] == \
        pytest.approx(0.0261, rel=6e-3)


@pytest.mark.parametrize("curve,bound", [("g1", 0.0170), ("g2", 0.0596)])
def test_tail_bound(curve, bound):
    """§6 row 4: one 2^16 segment's bucket tail at K 8."""
    emit2 = torch.zeros((24 if curve == "g1" else 48, 4096))
    dense = torch.arange(8 * 8192) % 4096
    nbytes, ops = F.tail_work(torch, emit2, dense, 8, curve)
    ms, what = F.bound_ms(nbytes, ops)
    assert what == "operations"
    assert ms == pytest.approx(bound, rel=6e-3)


def test_runscan_work_counts():
    """One add per row without a flag at the stream add's products; the
    pool columns the ids name once, the ids and flags, the emit."""
    pool = torch.zeros((16, 100))
    ids = torch.tensor([3, 3, 5, 7, 7, 7])
    flags = torch.tensor([1, 0, 1, 1, 0, 0])
    nbytes, ops = F.runscan_work(torch, pool, ids, flags, "g1", False)
    assert nbytes == 4 * (16 * 3 + 2 * 6 + 24 * 6)
    assert ops == 3 * 11 * 264
    _, ops2 = F.runscan_work(torch, pool, ids, flags, "g2", True)
    assert ops2 == 3 * 42 * 264


def test_bound_picks_the_larger():
    assert F.bound_ms(3.35e9, 0) == (pytest.approx(1.0), "bytes")
    assert F.bound_ms(0, F.INT32_OPS_PER_S) == (pytest.approx(1e3),
                                                "operations")
