"""Pippenger MSM by windows over Jacobian point kernels, on the card.

The JAX package's segmented-scan MSM (zelana_tpu/ops/msm.py), the MSM that
its multi-chip path builds on:

1. window decomposition: 8-bit digits, 32 windows over the 254-bit scalar
   (msm_scan.scalar_digits)
2. per-window bucket sums without a scatter-add: the points of each window
   sorted by digit (host), then a segmented Hillis-Steele scan over the
   sorted rows (log2 N steps, each one point add over all lanes), the end
   of each digit's run scattered into its bucket; windows go in chunks of
   at most 2^20 lanes
   (the scan's masks follow from the digits alone, so the host makes
   them)
3. bucket reduction: the descending running sum over buckets 255..1,
   batched across the windows (510 point adds)
4. window combine: Horner, 8 doublings and an add per window, one launch

Every point operation is a kernel of ops/curve_ops.py (``jac_add``,
``jac_double``); gathers, rolls, masks and scatters are torch ops. On CPU
tensors the kernels' plain versions run.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..fields import tower as tw
from ..fields.bn254 import P as _P
from . import curve_kernels as CK
from . import curve_ops as CO
from . import limbs as L
from . import msm_scan

WINDOW_BITS = 8
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
    vals = pool.index_select(1, order.view(-1)).view(VC, *order.shape)
    one = CO.ident_words(curve, 1, pool.device)[C // 3:2 * C // 3]
    return torch.cat([vals, one.view(-1, 1, 1).expand(C - VC, *order.shape)])


def _k_seg_scan_step(vals: torch.Tensor, keep: torch.Tensor, curve: str,
                     offset: int) -> torch.Tensor:
    """One Hillis-Steele segmented-scan step along the last axis: each lane
    adds the lane `offset` before it unless `keep` (its run starts within
    reach, or the lane is out of range)."""
    C = vals.shape[0]
    shifted = torch.roll(vals, offset, dims=-1)
    combined = CO.jac_add(vals.view(C, -1), shifted.view(C, -1),
                          curve).view_as(vals)
    return torch.where(keep[None], vals, combined)


def _scan_keeps(starts: np.ndarray, log_n: int) -> np.ndarray:
    """(log_n, W, N) bool: the keep mask of each scan step, flags | ~valid,
    with the flags' own scan, flags | (roll(flags) & valid), run on the
    host (they follow from the digits alone)."""
    n = starts.shape[-1]
    flags = starts
    keeps = np.empty((log_n,) + starts.shape, bool)
    for k in range(log_n):
        valid = np.arange(n) >= 1 << k
        keeps[k] = flags | ~valid
        flags = flags | (np.roll(flags, 1 << k, axis=-1) & valid)
    return keeps


def _k_scatter_buckets(vals: torch.Tensor, ends: np.ndarray,
                       keys: np.ndarray) -> torch.Tensor:
    """Segment-end values -> (C, N_BUCKETS, W) bucket words, bucket d of
    every window at [:, d]. The end of each nonzero digit's run lands in
    its bucket; bucket 0 (the trash bucket) and the empty buckets stay zero
    (Z = 0: infinity)."""
    C, w, n = vals.shape
    win, pos = np.nonzero(ends & (keys != 0))
    src = torch.from_numpy(win * n + pos).to(vals.device)
    dst = torch.from_numpy(keys[win, pos] * w + win).to(vals.device)
    out = torch.zeros((C, N_BUCKETS * w), dtype=vals.dtype,
                      device=vals.device)
    out.index_copy_(1, dst, vals.view(C, -1).index_select(1, src))
    return out.view(C, N_BUCKETS, w)


def _k_bucket_reduce(buckets: torch.Tensor, curve: str) -> torch.Tensor:
    """Descending running sum over buckets 255..1, all windows batched:
    sum_d d * S_d per window, (C, W) words."""
    inf_w = CO.ident_words(curve, buckets.shape[2], buckets.device)
    running = total = inf_w
    for d in range(N_BUCKETS - 1, 0, -1):
        running = CO.jac_add(running, buckets[:, d], curve)
        total = CO.jac_add(total, running, curve)
    return total


def _k_double8_add(acc: torch.Tensor, wnd: torch.Tensor,
                   curve: str) -> torch.Tensor:
    """acc := 2^WINDOW_BITS * acc + wnd (the Horner step), one launch."""
    return CO.jac_double(acc, curve, count=WINDOW_BITS, addend=wnd)


# ---------------------------------------------------------------------------
# MSM driver (host orchestration)
# ---------------------------------------------------------------------------


def _window_chunk(n: int) -> int:
    """Windows per device pass: the scan holds a few (C, chunk * n) point
    tensors, so LANE_BUDGET lanes bound its memory (0.2 GB a G2 tensor)."""
    return max(1, min(N_WINDOWS, LANE_BUDGET // max(n, 1)))


def _msm(pool: torch.Tensor, digits_np: np.ndarray,
         curve: str) -> torch.Tensor:
    """pool (VC, N) affine words, digits (W, N) -> the (C, 1) Jacobian
    words of the MSM."""
    dev = pool.device
    n = digits_np.shape[1]
    log_n = max(1, math.ceil(math.log2(n))) if n > 1 else 0

    # host-side sort per window
    order_all = np.argsort(digits_np, axis=1, kind="stable")
    keys_all = np.take_along_axis(digits_np, order_all, axis=1)

    chunk = _window_chunk(n)
    totals_parts = []
    for w0 in range(0, N_WINDOWS, chunk):
        order = order_all[w0:w0 + chunk]
        keys = keys_all[w0:w0 + chunk]
        cw = order.shape[0]
        starts = np.concatenate(
            [np.ones((cw, 1), bool), keys[:, 1:] != keys[:, :-1]], axis=1)
        ends = np.concatenate(
            [keys[:, 1:] != keys[:, :-1], np.ones((cw, 1), bool)], axis=1)
        vals = _k_gather_points(pool, torch.from_numpy(order).to(dev), curve)
        keeps = torch.from_numpy(_scan_keeps(starts, log_n)).to(dev)
        for k in range(log_n):
            vals = _k_seg_scan_step(vals, keeps[k], curve, 1 << k)
        buckets = _k_scatter_buckets(vals, ends, keys)
        totals_parts.append(_k_bucket_reduce(buckets, curve))
    totals = torch.cat(totals_parts, dim=1)

    # Horner across windows, high to low (host loop, single-point batch)
    acc = totals[:, N_WINDOWS - 1:]
    for wdx in range(N_WINDOWS - 2, -1, -1):
        acc = _k_double8_add(acc, totals[:, wdx:wdx + 1], curve)
    return acc


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
