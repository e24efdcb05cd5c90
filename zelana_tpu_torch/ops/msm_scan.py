"""Run-scan Pippenger MSM: host schedule, device bucket accumulation.

1. Host: the scalars split into 32 windows of 8-bit digits; the native
   scheduler (csrc/scan_sched.cpp) stably sorts the (window, digit) stream
   and lays it out column-major over lanes x R rows, with a flag where each
   (window, digit) run begins. Zero digits stay in the stream; their buckets
   are never read.
2. Device: run-scan the stream (curve_kernels.runscan): the kernel reads
   each affine point from the pool by its id, and each lane emits its
   finished partial bucket sums.
3. The per-lane partials of each bucket form a second key-sorted stream,
   reduced by a projective run-scan (the level-2 scan, reading the level-1
   emit by position); K2 layers of what is left merge into the dense
   (32 windows x 256 digits) bucket layout by K2-1 complete adds.
4. sum_d d * S_d splits by digit bits into 8 x 32 bit-subset sums: a fixed
   gather and a 7-level pairwise tree. Step 3's merge and step 4 are the
   bucket tail (curve_kernels.bucket_tail), gathers included.
5. Host: bit and window Horner in Jacobian big ints, one inversion
   (_finish_host).

The stream shape is chosen for the H100, not taken from the JAX package
(whose 2,048 G2 lanes were a TPU VMEM limit): LANES = 32,768 level-1 lanes
for G1 and G2 alike, so one schedule set serves all four z MSMs, and a
2^16-point segment has R = 64 rows and 1,024 warps of lanes. The level-2
width comes from the digit histogram (level2_lanes): skewed digits pile
one bucket's partials into a long level-2 run, and a narrower level 2
keeps its merge layers K2 within the native scheduler's KMAX. The emit
buffers depend on the stream shape; the MSM result does not.

MSMs above CHUNK_N points run as segments of at most CHUNK_N (the schedule's
point ids are 16-bit), with at most MAX_INFLIGHT segments queued before the
oldest one is fetched; segment results add up on the host. The segments'
schedules are built at once on a pool of host threads (the native scheduler
releases the GIL), one thread a usable core.

Identity points are stored in the pools as the generator, so the schedule
depends on the scalars only and one schedule set serves every pool with the
same scalars (the Groth16 a, b1, l and b2 queries); the result is corrected
by one host scalar multiply (_inf_correction).
"""

from __future__ import annotations

import concurrent.futures as cf
import contextlib
import os
import threading
from dataclasses import dataclass

import numpy as np
import torch

from ..curves import g1 as G1, g2 as G2
from ..curves.point_array import PointArray
from ..device import resolve
from ..fields.bn254 import P as _P, R as _FR
from ..fields import tower as tw
from ..trace import span
from . import curve_kernels as CK
from . import limbs as L
from . import sched_native

LANES = 32768  # level-1 stream lanes, G1 and G2 (the H100 sweep, PERF.md)
LANES2 = 8192  # level-2 stream lanes at most
LANES2_MIN = 32
K2_BOUND = 8  # dense merge layers the level-2 width aims to stay within
KMAX = 64  # dense merge layers the native scheduler accepts
SCAN_BITS = CK.SUBSET_BITS  # the digit layout the bucket tail is built for
SCAN_WINDOWS = CK.SUBSET_WINDOWS
SCAN_BUCKETS = CK.SUBSET_BUCKETS
CHUNK_N = 1 << 16  # points per segment: ids are 16-bit
MAX_INFLIGHT = 4  # segments queued on the device at once


def scalar_digits(scalars, inf_mask=None) -> np.ndarray:
    """(SCAN_WINDOWS, N) int32 window digits; infinity points get all-zero
    digits. `scalars`: list of ints, or an (N, 4) uint64 little-endian limb
    array."""
    if isinstance(scalars, np.ndarray):
        limbs = np.ascontiguousarray(scalars, dtype=np.uint64)
        n = len(limbs)
    else:
        n = len(scalars)
        buf = b"".join(int(s).to_bytes(32, "little") for s in scalars)
        limbs = np.frombuffer(buf, dtype="<u8").reshape(n, 4)
    digits = np.empty((SCAN_WINDOWS, n), np.int32)
    mask = np.uint64(SCAN_BUCKETS - 1)
    for w in range(SCAN_WINDOWS):
        bit = w * SCAN_BITS
        idx, sh = bit // 64, np.uint64(bit % 64)
        digits[w] = ((limbs[:, idx] >> sh) & mask).astype(np.int32)
    if inf_mask is not None:
        digits[:, inf_mask] = 0
    return digits


def _round_pow2(x: int, lo: int = 1) -> int:
    return max(lo, 1 << (x - 1).bit_length())


# ---------------------------------------------------------------------------
# host schedule
# ---------------------------------------------------------------------------


@dataclass
class Schedule:
    pid: np.ndarray  # (R+1, lanes) int32 point ids, row R the flush row
    flag: np.ndarray  # (R+1, lanes) int32, 1 where a run begins
    pos2: np.ndarray  # (R2+1, lanes2) int32 positions into the level-1 emit
    flag2: np.ndarray  # (R2+1, lanes2) int32
    dense_idx: np.ndarray  # (K, W * 256) int32 positions into the level-2
    # emit; position 0 (row 0 of lane 0) always holds the identity


def level1_shape(nw: int, lanes: int = LANES) -> tuple:
    """(lanes, R) of the level-1 stream of nw window digits: at most
    `lanes` lanes, fewer for a small MSM so that a lane holds 8 rows."""
    lanes0 = min(lanes, _round_pow2(max(nw // 8, 128), 128))
    return lanes0, -(-nw // lanes0)


def _bucket_partials(digits: np.ndarray, R: int) -> np.ndarray:
    """Level-1 partials of each bucket (key w * 256 + digit) on R rows: a
    bucket's stream entries are one contiguous range of the column-major
    stream, and each lane the range touches emits one partial. Zero digits
    emit none."""
    counts = np.stack([np.bincount(row, minlength=SCAN_BUCKETS)
                       for row in digits]).reshape(-1)
    start = np.cumsum(counts) - counts
    parts = np.where(counts > 0, (start + counts - 1) // R - start // R + 1, 0)
    parts[::SCAN_BUCKETS] = 0
    return parts


def level2_layers(parts: np.ndarray, lanes2: int) -> int:
    """K2, the dense merge layers of a level-2 stream of `parts` partials
    per bucket over lanes2 lanes: the most lanes one bucket's run
    touches."""
    nz = parts > 0
    if not nz.any():
        return 1
    R2 = -(-int(parts.sum()) // lanes2)
    start = (np.cumsum(parts) - parts)[nz]
    return int(((start + parts[nz] - 1) // R2 - start // R2 + 1).max())


def level2_lanes(parts: np.ndarray, cap: int = LANES2) -> int:
    """The level-2 width: the widest power of two up to `cap` (and no wider
    than the stream) whose dense merge needs at most K2_BOUND layers, but
    never below LANES2_MIN. Skewed digits (many scalars with one digit, as
    the boolean entries of a witness vector give) make one bucket's partials
    a long run; narrower level-2 lanes make it span fewer of them. At
    LANES2_MIN a bucket spans at most about 34 lanes, within KMAX."""
    widest = 1 << max(int(parts.sum()).bit_length() - 1, 0)
    lanes2 = max(LANES2_MIN, min(cap, widest))
    while lanes2 > LANES2_MIN and level2_layers(parts, lanes2) > K2_BOUND:
        lanes2 //= 2
    return lanes2


def build_schedule(digits: np.ndarray, lanes: int = LANES,
                   lanes2: int = None) -> Schedule:
    """Two-level schedule of one segment; digits: (W, n) int32, n <= 2^16.
    lanes2: the level-2 width, by default level2_lanes of the digits."""
    w, n = digits.shape
    assert n <= 1 << 16, "schedule point ids are 16-bit: segment the MSM"
    lanes0, R0 = level1_shape(w * n, lanes)
    if lanes2 is None:
        lanes2 = level2_lanes(_bucket_partials(digits, R0))
    perm, flag_bits, pos2, dense = sched_native.build_schedule_arrays2(
        digits, SCAN_BUCKETS, lanes0, R0, lanes2, KMAX)
    flag = np.unpackbits(flag_bits.view(np.uint8), axis=1,
                         bitorder="little").astype(np.int32)
    return Schedule(
        pid=perm.astype(np.int32), flag=flag,
        pos2=pos2 & 0x7FFFFFFF,
        flag2=(pos2.view(np.uint32) >> 31).astype(np.int32),
        dense_idx=dense)


def _upload(s: Schedule, device) -> dict:
    arrays = {"pid": s.pid, "flag": s.flag, "pos2": s.pos2,
              "flag2": s.flag2, "dense": s.dense_idx.reshape(-1)}
    to_card = torch.device(device).type == "cuda"
    with (span("msm.upload", bytes=sum(a.nbytes for a in arrays.values()),
               pinned=False) if to_card else contextlib.nullcontext()):
        return {k: torch.from_numpy(np.ascontiguousarray(a)).to(device)
                for k, a in arrays.items()}


# ---------------------------------------------------------------------------
# device program
# ---------------------------------------------------------------------------


def device_merged(pool: torch.Tensor, d: dict, curve: str) -> torch.Tensor:
    """One segment up to its dense buckets: pool (VC, n) affine words, d
    its uploaded schedule -> (C, 8192) words, bucket w * 256 + digit of
    window w (the sharded MSM reduces these across ranks)."""
    C = CK.rows(curve)
    emit = CK.runscan(pool, d["pid"], d["flag"], curve)
    emit2 = CK.runscan(emit.view(C, -1), d["pos2"], d["flag2"], curve,
                       proj_in=True).view(C, -1)
    K = d["dense"].numel() // CK.NB
    return CK.bucket_merge(emit2, d["dense"], K, curve)


def _device_msm(pool: torch.Tensor, d: dict, curve: str) -> torch.Tensor:
    """One segment: pool (VC, n) affine words, d its uploaded schedule ->
    (C, 8 * 32) words of the projective bit-subset sums."""
    return CK.bucket_tree(device_merged(pool, d, curve), curve)


# ---------------------------------------------------------------------------
# host tail
# ---------------------------------------------------------------------------


class _JacField:
    """Host big-int Jacobian arithmetic, generic over Fq / Fq2."""

    def __init__(self, fq2: bool):
        if fq2:
            self.mul, self.add, self.sub = tw.fq2_mul, tw.fq2_add, tw.fq2_sub
            self.sqr, self.inv = tw.fq2_sqr, tw.fq2_inv
            self.zero = (0, 0)
        else:
            self.mul = lambda a, b: a * b % _P
            self.add = lambda a, b: (a + b) % _P
            self.sub = lambda a, b: (a - b) % _P
            self.sqr = lambda a: a * a % _P
            self.inv = lambda a: pow(a, _P - 2, _P)
            self.zero = 0

    def dbl(self, pt):
        x, y, z = pt
        if z == self.zero:
            return pt
        A = self.sqr(x)
        B = self.sqr(y)
        C = self.sqr(B)
        D = self.sub(self.sqr(self.add(x, B)), self.add(A, C))
        D = self.add(D, D)
        E = self.add(self.add(A, A), A)
        F = self.sqr(E)
        x3 = self.sub(F, self.add(D, D))
        c8 = self.add(self.add(C, C), self.add(C, C))
        c8 = self.add(c8, c8)
        y3 = self.sub(self.mul(E, self.sub(D, x3)), c8)
        z3 = self.mul(self.add(y, y), z)
        return (x3, y3, z3)

    def addp(self, p1, p2):
        x1, y1, z1 = p1
        x2, y2, z2 = p2
        if z1 == self.zero:
            return p2
        if z2 == self.zero:
            return p1
        z1z1 = self.sqr(z1)
        z2z2 = self.sqr(z2)
        u1 = self.mul(x1, z2z2)
        u2 = self.mul(x2, z1z1)
        s1 = self.mul(self.mul(y1, z2), z2z2)
        s2 = self.mul(self.mul(y2, z1), z1z1)
        if u1 == u2:
            if s1 == s2:
                return self.dbl(p1)
            return (self.zero, self.zero, self.zero)  # P + (-P)
        h = self.sub(u2, u1)
        i = self.sqr(self.add(h, h))
        j = self.mul(h, i)
        r = self.sub(s2, s1)
        r = self.add(r, r)
        v = self.mul(u1, i)
        x3 = self.sub(self.sub(self.sqr(r), j), self.add(v, v))
        s1j = self.mul(s1, j)
        y3 = self.sub(self.mul(r, self.sub(v, x3)), self.add(s1j, s1j))
        z3 = self.mul(self.sub(self.sub(self.sqr(self.add(z1, z2)), z1z1),
                               z2z2), h)
        return (x3, y3, z3)

    def to_affine(self, pt):
        x, y, z = pt
        if z == self.zero:
            return None
        zi = self.inv(z)
        zi2 = self.sqr(zi)
        return (self.mul(x, zi2), self.mul(self.mul(y, zi2), zi))


def _finish_host(g: np.ndarray, curve: str):
    """g: (C, 8 * 32) uint32 words of projective bit-subset sums (group
    t * 32 + w) -> the affine MSM result. A projective point maps into
    Jacobian coordinates as (X*Z, Y*Z^2, Z)."""
    fq2 = curve == "g2"
    F = _JacField(fq2)
    coords = [L.decode_mont(g[8 * i:8 * (i + 1)], L.FQ)
              for i in range(g.shape[0] // 8)]
    if fq2:
        coords = [list(zip(coords[2 * i], coords[2 * i + 1]))
                  for i in range(3)]
    pts = [
        (F.mul(x, z), F.mul(y, F.sqr(z)), z) if z != F.zero
        else (F.zero, F.zero, F.zero)
        for x, y, z in zip(*coords)
    ]
    windows = []
    for w in range(SCAN_WINDOWS):
        acc = pts[(SCAN_BITS - 1) * SCAN_WINDOWS + w]
        for t in range(SCAN_BITS - 2, -1, -1):
            acc = F.addp(F.dbl(acc), pts[t * SCAN_WINDOWS + w])
        windows.append(acc)
    acc = windows[-1]
    for w in range(SCAN_WINDOWS - 2, -1, -1):
        for _ in range(SCAN_BITS):
            acc = F.dbl(acc)
        acc = F.addp(acc, windows[w])
    return F.to_affine(acc)


# ---------------------------------------------------------------------------
# public API: begin / end for pipelining
# ---------------------------------------------------------------------------


def _prepare(points, comps: int, gen, device):
    dev = resolve(device)
    pa = PointArray.from_points(points, comps)
    arr = pa.arr.copy()
    arr[pa.inf] = PointArray.from_points([gen], comps).arr[0]
    words = np.concatenate([L.encode_mont_u64(arr[:, 4 * c:4 * c + 4], L.FQ)
                            for c in range(comps)])
    return L.to_tensor(words, dev), pa.inf


def prepare_g1(points, device="cuda"):
    """Device-resident (16, n) pool of affine G1 points [X | Y] as Montgomery
    words; `points` a list or a PointArray. Identity (None) points are stored
    as the generator and corrected at msm_end, so the schedule does not
    depend on the pool."""
    return (*_prepare(points, 2, G1.generator(), device), "g1")


def prepare_g2(points, device="cuda"):
    """(32, n) pool of affine G2 points [X.c0 | X.c1 | Y.c0 | Y.c1]."""
    return (*_prepare(points, 4, G2.generator(), device), "g2")


def _inf_correction(digits: np.ndarray, inf) -> int:
    """Combined scalar of the identity slots, sum_i z_i over them (mod r),
    rebuilt from the window digits: the pool holds the generator there, so
    the scan result is off by exactly corr * G."""
    if inf is None or not inf.any():
        return 0
    with span("msm.inf_correction"):
        sums = digits[:, inf].sum(axis=1, dtype=np.int64)
        corr = 0
        for w in range(digits.shape[0] - 1, -1, -1):
            corr = (corr << SCAN_BITS) + int(sums[w])
        return corr % _FR


def _apply_corr(res, curve: str, corr: int):
    if corr == 0:
        return res
    C = G1 if curve == "g1" else G2
    return C.add(res, C.mul(C.generator(), _FR - corr))


class _MultiMsm:
    """Handle of a segmented MSM: segment finals add up at msm_end."""

    def __init__(self):
        self.pending = []  # device finals, dispatch order
        self.done = []  # fetched finals (uint32 numpy)


_POOL = None  # the schedule threads, made at first use
_POOL_LOCK = threading.Lock()


def _schedule_pool() -> cf.ThreadPoolExecutor:
    """The process's one pool of schedule threads, a thread a usable core:
    calls from several threads at once (two proves, a prove's h worker
    beside the next chunk's host stage) share it rather than each taking
    every core. Its tasks build one segment each and submit nothing."""
    global _POOL
    with _POOL_LOCK:
        if _POOL is None:
            _POOL = cf.ThreadPoolExecutor(len(os.sched_getaffinity(0)),
                                          thread_name_prefix="msm-schedule")
        return _POOL


def build_segment_schedules(digits: np.ndarray, lanes: int = LANES,
                            chunk_n: int = None) -> list:
    """Host schedules of each chunk_n-point segment (CHUNK_N by default,
    at most 2^16) of one scalar vector. The list is shareable across MSMs
    with the same scalars: each entry's device copy is uploaded once and
    cached in the entry; "worker" is the ident of the thread that built it.
    Several segments are built at once on the schedule pool, at most one a
    usable core; one segment builds on the calling thread."""
    chunk_n = CHUNK_N if chunk_n is None else chunk_n
    if not 0 < chunk_n <= 1 << 16:
        raise ValueError(f"segments of {chunk_n} points: ids are 16-bit")
    n = digits.shape[1]
    bounds = [(lo, min(lo + chunk_n, n))
              for lo in range(0, max(n, 1), chunk_n)]

    def build(lo: int, hi: int) -> dict:
        return {"lo": lo, "hi": hi,
                "sched": build_schedule(digits[:, lo:hi], lanes=lanes),
                "dev": None, "worker": threading.get_ident()}

    if len(bounds) == 1:
        return [build(*bounds[0])]
    pool = _schedule_pool()
    return [f.result() for f in [pool.submit(build, lo, hi)
                                 for lo, hi in bounds]]


def schedule_counts(segs: list) -> dict:
    """The counts of a schedule build's span: the segments built and the
    threads that built them."""
    return {"segments": len(segs),
            "workers": len({seg["worker"] for seg in segs})}


def upload_segment_schedules(segs: list, device) -> None:
    for seg in segs:
        if seg["dev"] is None:
            seg["dev"] = _upload(seg["sched"], device)


def msm_begin_scheds(prepared, segs: list, corr: int = 0):
    """Dispatch every segment over prebuilt schedules (asynchronous on the
    card). `corr`: the identity-slot correction of this pool."""
    pool, _inf, curve = prepared
    upload_segment_schedules(segs, pool.device)
    multi = _MultiMsm()
    for seg in segs:
        with span("msm.launch"):
            multi.pending.append(
                _device_msm(pool[:, seg["lo"]:seg["hi"]], seg["dev"], curve))
        if len(multi.pending) >= MAX_INFLIGHT:
            with span("msm.wait_device"):
                multi.done.append(L.to_numpy(multi.pending.pop(0)))
    return (multi, curve, corr)


def msm_begin(prepared, scalars, curve: str, digits: np.ndarray = None):
    if digits is None:
        digits = scalar_digits(scalars)
    segs = build_segment_schedules(digits)
    return msm_begin_scheds(prepared, segs,
                            _inf_correction(digits, prepared[1]))


def _finish_multi(finals, curve: str):
    add = G1.add if curve == "g1" else G2.add
    acc = None
    for f in finals:
        acc = add(acc, _finish_host(f, curve))
    return acc


def msm_end_many(handles) -> list:
    out = []
    for multi, curve, corr in handles:
        with span("msm.fetch_finals"):
            finals = multi.done + [L.to_numpy(p) for p in multi.pending]
        with span("msm.finish_host", segments=len(finals)):
            out.append(_apply_corr(_finish_multi(finals, curve), curve, corr))
    return out


def msm_end(handle):
    return msm_end_many([handle])[0]


def msm_g1(points, scalars, device="cuda"):
    if not points:
        return None
    return msm_end(msm_begin(prepare_g1(points, device), scalars, "g1"))


def msm_g2(points, scalars, device="cuda"):
    if not points:
        return None
    return msm_end(msm_begin(prepare_g2(points, device), scalars, "g2"))
