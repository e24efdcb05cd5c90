"""Pippenger MSM by windows over Jacobian point kernels, on the card.

The JAX package's segmented-scan MSM (zelana_tpu/ops/msm.py), the MSM that
its multi-chip path builds on, with its adds in its order:

1. window decomposition: 8-bit digits, 32 windows over the 254-bit scalar
   (msm_scan.scalar_digits)
2. per-window bucket sums without a scatter-add: the points of each window
   sorted by digit (host), then a segmented Hillis-Steele scan over the
   sorted rows, each step one point add over the lanes whose run starts
   beyond reach; windows go in chunks of at most 2^20 lanes. The keep mask
   follows from the digits alone: the host uploads one run position a lane
   (i - the start of its run; -1 for digit 0, whose sum is dropped) and
   runs ceil(log2(longest run)) steps, after which every lane is kept
3. bucket reduction: the descending running sum over buckets 255..1 of
   each window (510 point adds), S_d read at the end of digit d's run
4. window combine: Horner, 8 doublings and an add per window

Steps 2-4 are the forms of ops/curve_ops.py: ``jac_scan_step`` a launch a
step, ``jac_bucket_reduce`` a launch a chunk (on a stream of its own, so
that a chunk's reduction, a block a window, runs beside the next chunk's
scan), ``jac_horner`` one launch; the points' gather is a torch op, the
sort order, run positions and run ends go up through pinned memory. On
CPU tensors the forms' plain versions run. The result's words are the JAX
_msm's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields import tower as tw
from ..fields.bn254 import P as _P
from . import curve_kernels as CK
from . import curve_ops as CO
from . import limbs as L
from . import msm_scan
from . import staging

WINDOW_BITS = CO.WINDOW_BITS
N_WINDOWS = (254 + WINDOW_BITS - 1) // WINDOW_BITS  # 32
N_BUCKETS = 1 << WINDOW_BITS  # bucket 0 is the trash bucket
LANE_BUDGET = 1 << 20  # lanes (window rows x points) a scan chunk holds


# ---------------------------------------------------------------------------
# device steps
# ---------------------------------------------------------------------------


def _k_gather_points(pool: torch.Tensor, order: torch.Tensor,
                     curve: str) -> torch.Tensor:
    """pool (VC, N) affine words, order (W, N) -> (C, W, N) Jacobian words
    of the sorted points, Z = one."""
    C, VC = CK.rows(curve), pool.shape[0]
    out = torch.empty((C,) + tuple(order.shape), dtype=pool.dtype,
                      device=pool.device)
    torch.index_select(pool, 1, order.view(-1), out=out[:VC].view(VC, -1))
    one = CO.ident_words(curve, 1, pool.device)[C // 3:2 * C // 3]
    out[VC:] = one.view(-1, 1, 1)
    return out


def scan_plan(digits: np.ndarray):
    """digits (W, N) -> (pos, ends, steps) of the rows sorted by digit,
    from each row's digit counts: pos (W, N) int32, each sorted lane's
    place in its digit's run, -1 in digit 0's run (the trash bucket: its
    lanes neither add nor are read); ends (W, N_BUCKETS) int32, the lane
    (w * N + i) where nonzero digit d's run ends, -1 where the window has
    no such digit; steps, the scan steps the longest nonzero digit's run
    needs."""
    w, n = digits.shape
    counts = np.stack([np.bincount(row, minlength=N_BUCKETS)
                       for row in digits])
    first = np.cumsum(counts, axis=1) - counts  # each run's first lane
    pos = np.empty((w, n), np.int32)
    for r in range(w):
        pos[r] = np.arange(n) - np.repeat(first[r], counts[r])
        pos[r, :counts[r, 0]] = -1
    ends = np.where(counts > 0, first + counts - 1
                    + n * np.arange(w)[:, None], -1).astype(np.int32)
    ends[:, 0] = -1
    return pos, ends, max(int(counts[:, 1:].max()) - 1, 0).bit_length()


# ---------------------------------------------------------------------------
# MSM driver (host orchestration)
# ---------------------------------------------------------------------------


def _window_chunk(n: int) -> int:
    """Windows per device pass: the scan holds two (C, chunk * n) point
    buffers, so LANE_BUDGET lanes bound its memory (0.2 GB a G2 buffer)."""
    return max(1, min(N_WINDOWS, LANE_BUDGET // max(n, 1)))


def _window_totals(pool: torch.Tensor, digits_np: np.ndarray,
                   curve: str) -> torch.Tensor:
    """pool (VC, N) affine words, digits (W, N) -> the (C, N_WINDOWS)
    Jacobian words of the windows' sums sum_d d * S_d."""
    dev = pool.device

    # host-side sort per window: stable, on 8-bit keys (a radix sort, the
    # same order as on the int32 digits)
    order_all = np.argsort(digits_np.astype(np.uint8), axis=1,
                           kind="stable")

    chunk = _window_chunk(digits_np.shape[1])
    totals = torch.empty((CK.rows(curve), N_WINDOWS), dtype=torch.int32,
                         device=dev)
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    for w0 in range(0, N_WINDOWS, chunk):
        pos, ends, steps = scan_plan(digits_np[w0:w0 + chunk])
        src = _k_gather_points(pool, staging.upload(
            order_all[w0:w0 + chunk].astype(np.int32), dev), curve)
        # a step writes only the lanes with pos >= offset // 2: the first
        # (offset 1) every lane but digit 0's, which nothing reads, so
        # each later step finds its final lanes in both buffers
        dst = torch.empty_like(src)
        pos_d = staging.upload(pos, dev)
        ends_d = staging.upload(ends, dev)
        for k in range(steps):
            CO.jac_scan_step(src, dst, pos_d, 1 << k, curve)
            src, dst = dst, src
        out = totals[:, w0:w0 + pos.shape[0]]
        if side is None:
            CO.jac_bucket_reduce(src, ends_d, out, curve)
            continue
        # the reduction (a block a window) beside the next chunk's scan
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            CO.jac_bucket_reduce(src, ends_d, out, curve)
        for t in (src, ends_d, totals):
            t.record_stream(side)
    if side is not None:
        torch.cuda.current_stream(dev).wait_stream(side)
    return totals


def _msm(pool: torch.Tensor, digits_np: np.ndarray,
         curve: str) -> torch.Tensor:
    """pool (VC, N) affine words, digits (W, N) -> the (C, 1) Jacobian
    words of the MSM."""
    return CO.jac_horner(_window_totals(pool, digits_np, curve), curve)


# ---------------------------------------------------------------------------
# host API
# ---------------------------------------------------------------------------


def _jac_to_affine_host(jac: torch.Tensor, curve: str):
    """(C, 1) Jacobian words -> an affine point of ints, or None."""
    c = [L.decode_mont(L.to_numpy(jac[8 * i:8 * (i + 1)]), L.FQ)[0]
         for i in range(jac.shape[0] // 8)]
    if curve == "g1":
        X, Y, Z = c
        if Z == 0:
            return None
        zinv = pow(Z, _P - 2, _P)
        return (X * zinv * zinv % _P, Y * zinv % _P * zinv % _P * zinv % _P)
    X, Y, Z = (c[0], c[1]), (c[2], c[3]), (c[4], c[5])
    if Z == (0, 0):
        return None
    zinv = tw.fq2_inv(Z)
    zinv2 = tw.fq2_sqr(zinv)
    return (tw.fq2_mul(X, zinv2), tw.fq2_mul(tw.fq2_mul(Y, zinv2), zinv))


def _pad_pow2(points, scalars, min_size=16):
    """Pad to a power-of-two length with infinity points / zero scalars."""
    n = max(min_size, len(points))
    n = 1 << (n - 1).bit_length()
    pad = n - len(points)
    return list(points) + [None] * pad, list(scalars) + [0] * pad


def _msm_host(points, scalars, curve: str, device):
    if not points:
        return None
    points, scalars = _pad_pow2(points, scalars)
    prepare = msm_scan.prepare_g1 if curve == "g1" else msm_scan.prepare_g2
    pool, inf, _ = prepare(points, device)
    digits = msm_scan.scalar_digits(scalars, inf)
    return _jac_to_affine_host(_msm(pool, digits, curve), curve)


def msm_g1(points, scalars, device="cuda"):
    """Host API: affine python G1 points + int scalars -> affine result."""
    return _msm_host(points, scalars, "g1", device)


def msm_g2(points, scalars, device="cuda"):
    return _msm_host(points, scalars, "g2", device)
