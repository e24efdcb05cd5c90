"""Batched fixed-base scalar multiplication on the card: the keygen engine.

Groth16 setup computes every proving-key query as `scalar * G` for one base
per group. The per-scalar work runs on the device as a balanced tree of
complete projective additions:

  1. The host builds the windowed table once per base:
     table[w * 255 + d - 1] = d * 2^(8w) * G for w < 32, 1 <= d < 256
     (8,160 points), the leaf section of a slot pool whose slot 0 is the
     identity (0 : 1 : 0).
  2. Scalars upload as their 32 bytes each, (8, n) words of the standard
     form. Digits and table slot ids derive on the device; point i's 32
     window slots sit adjacently, so round 0 adds windows 2k and 2k + 1 of
     every point (by slot id) and round r of 1..4 adds outputs 2j and
     2j + 1 of round r-1. The five rounds are one `step` launch
     (curve_kernels.step with rounds=5, one thread per point's subtree),
     and only the n sums are written to the pool after the head. Zero
     digits read the identity slot, so the zero scalar yields the point at
     infinity.
  3. The n projective results come back to the host and go affine with one
     batched inversion in C (r1cs/native_synth.proj_to_affine).

Chunks of FB_CHUNK scalars run one after the other; chunk k+1 is dispatched
before chunk k's host tail runs, so the two overlap.
"""

from __future__ import annotations

import numpy as np
import torch

from ..curves.point_array import PointArray
from ..device import resolve
from ..fields.bn254 import P as FQ_MOD
from ..r1cs.native_synth import proj_to_affine, words32
from . import curve_kernels as CK
from . import limbs as L
from . import staging
from .msm_scan import _JacField

WINDOW_BITS = 8
N_WINDOWS = 32
ROW = (1 << WINDOW_BITS) - 1  # 255 non-zero digits per window
N_TABLE = N_WINDOWS * ROW  # 8160 leaf points
ROUNDS = 5  # log2(N_WINDOWS)
FB_CHUNK = 1 << 15  # scalars per device dispatch


# ---------------------------------------------------------------------------
# host: table construction (once per base point)
# ---------------------------------------------------------------------------


def build_table(base, curve: str) -> list:
    """[w * 255 + (d-1)] = d * 2^(8w) * base as affine points, slot-major
    order: Jacobian sums on the host, then one batched inversion."""
    F = _JacField(curve == "g2")
    one = (1, 0) if curve == "g2" else 1
    jac = []
    step = (base[0], base[1], one)
    for _ in range(N_WINDOWS):
        acc = step
        jac.append(acc)
        for _ in range(ROW - 1):
            acc = F.addp(acc, step)
            jac.append(acc)
        for _ in range(WINDOW_BITS):
            step = F.dbl(step)
    prefix = [one]
    for _, _, z in jac:
        prefix.append(F.mul(prefix[-1], z))
    inv = F.inv(prefix[-1])
    out = [None] * len(jac)
    for i in range(len(jac) - 1, -1, -1):
        x, y, z = jac[i]
        zi = F.mul(inv, prefix[i])
        inv = F.mul(inv, z)
        zi2 = F.sqr(zi)
        out[i] = (F.mul(x, zi2), F.mul(y, F.mul(zi2, zi)))
    return out


def _prepare_table(base, curve: str, comps: int, device):
    """(C, N_TABLE + 1) words: slot 0 the identity, then the table's affine
    points with Z = 1 -- the head of every chunk's slot pool."""
    dev = resolve(device)
    pts = PointArray.from_points(build_table(base, curve), comps)
    C = CK.rows(curve)
    VC = 2 * C // 3
    head = np.zeros((C, N_TABLE + 1), np.uint32)
    one = L.encode_mont([1], L.FQ)[:, 0]
    head[C // 3:C // 3 + L.NWORDS, 0] = one  # identity Y
    for c in range(comps):
        head[8 * c:8 * c + 8, 1:] = L.encode_mont_u64(
            pts.arr[:, 4 * c:4 * c + 4], L.FQ)
    head[VC:VC + L.NWORDS, 1:] = one[:, None]  # Z = 1 (G2: c0 = 1, c1 = 0)
    return (curve, L.to_tensor(head, dev))


def prepare_table_g1(base, device="cuda"):
    """Device-resident table of a G1 base; reuse it across all of that
    base's query arrays (a/b1/h/l share the G1 generator in keygen)."""
    return _prepare_table(base, "g1", 2, device)


def prepare_table_g2(base, device="cuda"):
    return _prepare_table(base, "g2", 4, device)


# ---------------------------------------------------------------------------
# device: 5-round pairwise tree over the window slots
# ---------------------------------------------------------------------------


def _slot_ids(words: torch.Tensor):
    """(8, n) int32 scalar words -> the round-0 operand slot ids: for point
    i, entry 16 i + k reads window 2k (ia) and window 2k + 1 (ib)."""
    digits = torch.stack([(words[k] >> (8 * j)) & 0xFF
                          for k in range(L.NWORDS) for j in range(4)])
    w = torch.arange(N_WINDOWS, dtype=torch.int32,
                     device=words.device)[:, None]
    slots = torch.where(digits == 0, 0, w * ROW + digits).to(torch.int32)
    return (slots[0::2].T.contiguous().view(-1),
            slots[1::2].T.contiguous().view(-1))


def _run_fb(head: torch.Tensor, words: torch.Tensor, curve: str):
    """head: (C, N_TABLE + 1) pool head; words: (8, n) int32 scalars.
    Returns the (C, n) projective words of scalar_i * base."""
    n = words.shape[1]
    pool = torch.empty((head.shape[0], N_TABLE + 1 + n), dtype=torch.int32,
                       device=head.device)
    pool[:, :N_TABLE + 1] = head
    ia, ib = _slot_ids(words)
    CK.step(pool, N_TABLE + 1, n * N_WINDOWS // 2, curve, ia, ib,
            read_hi=N_TABLE + 1, rounds=ROUNDS)
    return pool[:, N_TABLE + 1:]


def _finish_fb(g: np.ndarray, curve: str) -> PointArray:
    """(C, n) uint32 projective words -> affine PointArray, through the
    native batch inversion (raises if the native library cannot be built;
    there is no Python tail)."""
    K = CK.rows(curve) // 3  # word rows per coordinate

    def u64(rows):  # (K, n) u32 words -> (n, K / 2) u64 limbs
        return np.ascontiguousarray(rows.T).view("<u8")

    arr, inf = proj_to_affine(u64(g[:K]), u64(g[K:2 * K]), u64(g[2 * K:]),
                              FQ_MOD, curve == "g2")
    return PointArray(arr, inf, K // 4)


def _scalar_array(scalars) -> np.ndarray:
    if isinstance(scalars, np.ndarray):
        return np.ascontiguousarray(scalars, dtype=np.uint64)
    from ..fields.bn254 import R as FR

    buf = b"".join((int(s) % FR).to_bytes(32, "little") for s in scalars)
    return np.frombuffer(buf, "<u8").reshape(len(scalars), 4)


def fixed_base_msm(table, scalars) -> PointArray:
    """scalar_i * base for each i, as a PointArray (the identity for the zero
    scalar). `table` from prepare_table_g1/g2; scalars are Python ints
    (reduced mod r here) or an (n, 4) u64 little-endian limb array of
    canonical scalars. Chunk k+1 is on the device while chunk k's host tail
    (download, batch inversion) runs."""
    curve, head = table
    limbs = _scalar_array(scalars)
    n = len(limbs)
    comps = 2 if curve == "g1" else 4
    parts, pending = [], None
    for lo in range(0, n, FB_CHUNK):
        words = L.to_tensor(words32(limbs[lo:lo + FB_CHUNK]), head.device)
        nxt = staging.download(_run_fb(head, words, curve))
        if pending is not None:
            parts.append(_finish_fb(staging.fetch(pending), curve))
        pending = nxt
    if pending is not None:
        parts.append(_finish_fb(staging.fetch(pending), curve))
    if not parts:
        return PointArray(np.zeros((0, 4 * comps), np.uint64),
                          np.zeros(0, bool), comps)
    return PointArray(np.concatenate([p.arr for p in parts]),
                      np.concatenate([p.inf for p in parts]), comps)
