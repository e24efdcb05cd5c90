"""Frozen copies of the smoke script's measurement pieces, so that the
benchmark's yardstick does not move when chip_smoke.py does. Each names
the function of chip_smoke.py it was copied from; where a copy was changed,
the comment says how.

The peaks: HBM3 3.35 TB/s is NVIDIA's data sheet for the H100 SXM; the
int32 rate of 16.7 T/s is derived (132 SMs x 64 INT32 lanes x 1.98 GHz
boost), not measured: the data sheet gives no int32 rate.
"""

from __future__ import annotations

import contextlib
import random

HBM_BYTES_PER_S = 3.35e12  # chip_smoke.HBM_BYTES_PER_S
INT32_OPS_PER_S = 132 * 64 * 1.98e9  # chip_smoke.INT32_OPS_PER_S (derived)
MUL_OPS = 2 * 2 * 8 * 8 + 8  # chip_smoke.MUL_OPS: one 8x32-bit CIOS product
SQR_OPS = 2 * 36 + 2 * 8 * 8 + 8  # chip_smoke.SQR_OPS

# chip_smoke.RUNSCAN_MULS: Montgomery products per run-scan stream add
RUNSCAN_MULS = {("g1", False): 11, ("g1", True): 12, ("g2", False): 39,
                ("g2", True): 42}


def bound_ms(nbytes: float, ops: float):
    """chip_smoke.bound_ms: the least time of the work, and what bounds
    it."""
    tb, to = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def runscan_work(torch, pool, ids, flags, curve, proj_in):
    """chip_smoke.runscan_work: (bytes, int32 operations) of one run-scan:
    the pool columns the ids name, read once, the ids and flags, the emit
    written; one stream add per row without a flag."""
    C = 24 if curve == "g1" else 48
    uniq = int(torch.unique(ids).numel())
    nbytes = 4 * (pool.shape[0] * uniq + 2 * flags.numel() + C * flags.numel())
    adds = int((flags == 0).sum())
    return nbytes, adds * RUNSCAN_MULS[(curve, proj_in)] * MUL_OPS


def tail_work(torch, emit2, dense, K, curve):
    """chip_smoke.tail_work: (bytes, int32 operations) of one bucket tail:
    (K - 1) merge adds per bucket and 127 tree adds per subset group."""
    C = 24 if curve == "g1" else 48
    uniq = int(torch.unique(dense).numel())
    nbytes = 4 * (C * uniq + dense.numel() + C * 256)
    adds = (K - 1) * 8192 + 256 * 127
    return nbytes, adds * RUNSCAN_MULS[(curve, True)] * MUL_OPS


def ntt_products(kind: str, log_n: int, built: bool = False) -> int:
    """chip_smoke.ntt_products: Montgomery products one transform of
    2^log_n elements needs ((log_n - 2) 2^(log_n - 1) + 1 over the stages,
    n a scaling, 2 n more for the quotient); `built`: what the pass kernel
    does."""
    n = 1 << log_n
    scale = {"ntt": 0, "intt": 1, "coset_ntt": 1, "coset_intt": 1,
             "quotient": 2}[kind]
    if built:
        return (log_n - 1) * n // 2 + (scale + (kind == "quotient")) * n
    return (log_n - 2) * n // 2 + 1 + scale * n


def witness_map_products(log_n: int, built: bool = False) -> int:
    """chip_smoke.witness_map_products: seven transforms' stages, n for
    a b and n for each of four folded scaling tables."""
    kinds = ["intt"] * 3 + ["coset_ntt"] * 3 + ["quotient"]
    if built:
        return sum(ntt_products(k, log_n, True) for k in kinds)
    return 7 * ntt_products("ntt", log_n) + 5 * (1 << log_n)


def production_spec(cap, chunks: int = 5, rng: random.Random = None,
                    draw: dict = None, depth: int = 32) -> dict:
    """chip_smoke.production_batch as a batch spec (reference/chunk_batch.py):
    `chunks` chunks, the last half filled, from 15 funded accounts, the
    first shielded slot a full-verification spend. With no `rng` it is the
    smoke script's batch exactly (pks 1-15 funded with 10,000, amounts 10 +
    i and 5 + i, note (777, 50, 42), commitments 1000 + i). With `rng`,
    the pks, funds, amounts, the note and the commitments are drawn from it
    within `draw`'s ranges; the slots, their order and the occupancy are
    the same for every draw; the accounts' tree positions (the low
    `depth` bits of their pks) are distinct."""
    nt, nw, ns = (c * (chunks - 1) + c // 2 for c in cap)
    if rng is None:
        pks = list(range(1, 16))
        funds = [10_000] * 15
        t_amt = [10 + i for i in range(nt)]
        w_amt = [5 + i for i in range(nw)]
        sk, value, blinding = 777, 50, 42
        out_owner, out_blinding = 0xFACE, 4242
        cms = [1000 + i for i in range(ns - 1)]
        l1 = [0xAA00 + i for i in range(nw)]
    else:
        d = draw
        positions = rng.sample(range(1, 1 << min(depth, 32)), 15)
        pks = [(rng.getrandbits(200) << 32) | p for p in positions]
        funds = [rng.randint(*d["fund"]) for _ in pks]
        t_amt = [rng.randint(*d["transfer_amount"]) for _ in range(nt)]
        w_amt = [rng.randint(*d["withdrawal_amount"]) for _ in range(nw)]
        sk, value, blinding, out_owner, out_blinding = (
            rng.getrandbits(248), rng.randint(*d["note_value"]),
            rng.getrandbits(248), rng.getrandbits(248), rng.getrandbits(248))
        cms = [rng.getrandbits(250) for _ in range(ns - 1)]
        l1 = [rng.getrandbits(160) for _ in range(nw)]
    return {
        "funds": list(zip(pks, funds)),
        "notes": [(sk, value, blinding)],
        "transfers": [(pks[i % 8], pks[(i + 3) % 8], t_amt[i])
                      for i in range(nt)],
        "withdrawals": [(pks[i % 15], l1[i], w_amt[i]) for i in range(nw)],
        "shielded": [["full", 0, sk, out_owner, value, out_blinding]]
        + cms,
    }


@contextlib.contextmanager
def launches_per_prove(prove_module, cuda):
    """chip_smoke.launches_per_prove, with the modules passed in: the
    launches of each prove_synthesized call while the context is open, one
    dict of nonzero counts a call (count serial proves only)."""
    real, out = prove_module.prove_synthesized, []

    def counted(*args, **kwargs):
        before = dict(cuda.LAUNCHES)
        proof = real(*args, **kwargs)
        out.append({k: v - before[k] for k, v in cuda.LAUNCHES.items()
                    if v != before[k]})
        return proof

    prove_module.prove_synthesized = counted
    try:
        yield out
    finally:
        prove_module.prove_synthesized = real


def device_events(prof) -> list:
    """chip_smoke.device_events: key_averages' device-side events (a host
    op carries its kernels' time as its own device time too)."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages() if e.device_type != DeviceType.CPU]


def device_busy_ms(prof) -> float:
    """chip_smoke._device_busy_ms without its log: the sum of the device's
    self time over the profile's device events."""
    return sum(e.self_device_time_total for e in device_events(prof)) / 1e3


def choose_windows(windows: list) -> list:
    """chip_smoke.device_profile's rule for profiler windows, for windows
    of different work: the profiler now and then returns a window short
    of its device kernels, so a window whose port kernels fall short of
    the launches the port counted in it (ops/cuda.LAUNCHES) is dropped.
    `windows`: dicts with "kernels" (seen) and "launches" (counted)."""
    return [w for w in windows if w["kernels"] >= w["launches"]]
