"""Point kernels of the run-scan MSM and of keygen, each beside its plain
version.

- ``runscan(pool, ids, flags, curve, proj_in)``: the bucket run-scan over
  the stream that the (R+1, lanes) ids gather from a words-first pool; the
  kernel reads the pool by id itself, so the stream is never materialised.
  CUDA kernel ``csrc/curve_kernels.cu: runscan_kernel`` (four variants:
  G1/G2 x affine/projective stream); replaces the TPU kernel
  ``pallas_curve.runscan_call``. The emit depends on the stream shape
  (rows x lanes) and is bit-equal to the TPU kernel's at equal shapes.
- ``bucket_tail(emit2, dense, K, curve)``: the MSM's tail after the
  level-2 scan, gathers included: ``bucket_merge`` folds the K dense
  layers into 8,192 buckets, ``bucket_tree`` forms the 256 bit-subset sums
  of them. CUDA kernels ``bucket_merge_kernel`` and ``bucket_tree_kernel``
  (six threads per complete add); they replace the TPU path's
  ``pallas_curve.pairs_add_call`` launches and the XLA gathers around
  them. The sharded MSM runs the two apart, with its reduce-scatter
  between them, and adds bucket arrays column by column with
  ``merge_pairs`` (bucket_merge with K = 2).
- ``step(pool, off, S, curve, ..., rounds)``: ``rounds`` in-place rounds of
  a slot-pool reduction tree in one launch (complete add, or in round 0 the
  9-product mixed add of two affine operands), round-0 operands read from
  the pool by index. CUDA kernel ``step_kernel``; replaces
  ``pallas_curve.step_call``.

Points are words-first packed columns: G1 coordinates are 8 word rows each
(X | Y | Z, C = 24 rows projective, 16 affine), G2 coordinates 16 (c0 then
c1; C = 48 projective, 32 affine). The identity is (0 : one : 0).

The plain versions run the same complete-addition formulas (Renes,
Costello and Batina 2015, Algorithm 7 with a = 0) over the int64 limb
arithmetic of ops/limbs.py; a wrapper takes them only for CPU tensors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields import tower as tw
from . import cuda
from . import limbs as L


def rows(curve: str, proj: bool = True) -> int:
    """Word rows of one point: C (projective) or VC (affine)."""
    return (24 if proj else 16) if curve == "g1" else (48 if proj else 32)


def ident_words(curve: str) -> np.ndarray:
    """(C,) uint32 words of the identity (0 : one : 0)."""
    C = rows(curve)
    out = np.zeros(C, np.uint32)
    out[C // 3:C // 3 + L.NWORDS] = L.encode_mont([1], L.FQ)[:, 0]
    return out


# ---------------------------------------------------------------------------
# the complete additions, generic over a field vtable
# ---------------------------------------------------------------------------


def complete_add(F, P, Q):
    """Renes-Costello-Batina Algorithm 7 (a = 0); P, Q projective."""
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    t0 = F.mul(X1, X2)
    t1 = F.mul(Y1, Y2)
    t2 = F.mul(Z1, Z2)
    t3 = F.add(X1, Y1)
    t4 = F.add(X2, Y2)
    t3 = F.mul(t3, t4)
    t4 = F.add(t0, t1)
    t3 = F.sub(t3, t4)
    t4 = F.add(Y1, Z1)
    X3 = F.add(Y2, Z2)
    t4 = F.mul(t4, X3)
    X3 = F.add(t1, t2)
    t4 = F.sub(t4, X3)
    X3 = F.add(X1, Z1)
    Y3 = F.add(X2, Z2)
    X3 = F.mul(X3, Y3)
    Y3 = F.add(t0, t2)
    Y3 = F.sub(X3, Y3)
    X3 = F.add(t0, t0)
    t0 = F.add(X3, t0)
    t2 = F.mul_b3(t2)
    Z3 = F.add(t1, t2)
    t1 = F.sub(t1, t2)
    Y3 = F.mul_b3(Y3)
    X3 = F.mul(t4, Y3)
    t2 = F.mul(t3, t1)
    X3 = F.sub(t2, X3)
    Y3 = F.mul(Y3, t0)
    t1 = F.mul(t1, Z3)
    Y3 = F.add(t1, Y3)
    t0 = F.mul(t0, t3)
    Z3 = F.mul(Z3, t4)
    Z3 = F.add(Z3, t0)
    return X3, Y3, Z3


def complete_add_z1(F, P, Q):
    """Algorithm 7 with Z2 = 1: P projective, Q = (X2, Y2) affine."""
    X1, Y1, Z1 = P
    X2, Y2 = Q
    t0 = F.mul(X1, X2)
    t1 = F.mul(Y1, Y2)
    t3 = F.sub(F.mul(F.add(X1, Y1), F.add(X2, Y2)), F.add(t0, t1))
    t4 = F.add(F.mul(Y2, Z1), Y1)
    Y3 = F.add(F.mul(X2, Z1), X1)
    t0 = F.add(F.add(t0, t0), t0)
    t2 = F.mul_b3(Z1)
    Z3 = F.add(t1, t2)
    t1 = F.sub(t1, t2)
    Y3 = F.mul_b3(Y3)
    X3 = F.sub(F.mul(t3, t1), F.mul(t4, Y3))
    Y3 = F.add(F.mul(Y3, t0), F.mul(t1, Z3))
    Z3 = F.add(F.mul(Z3, t4), F.mul(t0, t3))
    return X3, Y3, Z3


def complete_add_mixed(F, P, Q):
    """Algorithm 7 with Z1 = Z2 = 1: P = (X1, Y1), Q = (X2, Y2) affine; 9
    products and one mul_b3, projective result. Off-curve inputs give
    garbage, never a fault."""
    X1, Y1 = P
    X2, Y2 = Q
    t0 = F.mul(X1, X2)
    t1 = F.mul(Y1, Y2)
    t3 = F.sub(F.mul(F.add(X1, Y1), F.add(X2, Y2)), F.add(t0, t1))
    t4 = F.add(Y1, Y2)
    Y3 = F.add(X1, X2)
    t0 = F.add(F.add(t0, t0), t0)
    b3 = F.b3_const(t1)
    Z3 = F.add(t1, b3)
    t1 = F.sub(t1, b3)
    Y3 = F.mul_b3(Y3)
    X3 = F.sub(F.mul(t3, t1), F.mul(t4, Y3))
    Y3 = F.add(F.mul(Y3, t0), F.mul(t1, Z3))
    Z3 = F.add(F.mul(Z3, t4), F.mul(t0, t3))
    return X3, Y3, Z3


@functools.lru_cache(maxsize=None)
def _b3_limbs(device: torch.device) -> tuple:
    """3b = 9 of G1 and 3b' of the G2 twist, b' = 3 / (9 + u), as
    Montgomery limb columns (G1, G2 c0, G2 c1)."""
    inv = tw.fq2_inv((9, 1))
    words = L.encode_mont([9, 9 * inv[0] % L.FQ.modulus,
                           9 * inv[1] % L.FQ.modulus], L.FQ)
    limbs = L.unpack(L.to_tensor(words, device))
    return limbs[:, 0:1], limbs[:, 1:2], limbs[:, 2:3]


class PlainFq:
    """Fq over (16, *B) int64 limbs."""

    mul = staticmethod(lambda a, b: L.mul_l(a, b, L.FQ))
    add = staticmethod(lambda a, b: L.add_l(a, b, L.FQ))
    sub = staticmethod(lambda a, b: L.sub_l(a, b, L.FQ))

    @staticmethod
    def mul_b3(x):
        # b = 3 for G1: 3b = 9 = 8x + x
        t = L.add_l(x, x, L.FQ)
        t = L.add_l(t, t, L.FQ)
        t = L.add_l(t, t, L.FQ)
        return L.add_l(t, x, L.FQ)

    @staticmethod
    def b3_const(like):
        return _b3_limbs(like.device)[0].expand(like.shape)


class PlainFq2:
    """Fq2 = Fq[u] / (u^2 + 1) over pairs of (16, *B) int64 limbs."""

    @staticmethod
    def mul(a, b):
        t0 = L.mul_l(a[0], b[0], L.FQ)
        t1 = L.mul_l(a[1], b[1], L.FQ)
        s = L.mul_l(L.add_l(a[0], a[1], L.FQ), L.add_l(b[0], b[1], L.FQ),
                    L.FQ)
        return (L.sub_l(t0, t1, L.FQ),
                L.sub_l(L.sub_l(s, t0, L.FQ), t1, L.FQ))

    add = staticmethod(lambda a, b: (L.add_l(a[0], b[0], L.FQ),
                                     L.add_l(a[1], b[1], L.FQ)))
    sub = staticmethod(lambda a, b: (L.sub_l(a[0], b[0], L.FQ),
                                     L.sub_l(a[1], b[1], L.FQ)))

    @staticmethod
    def b3_const(like):
        _, c0, c1 = _b3_limbs(like[0].device)
        return c0.expand(like[0].shape), c1.expand(like[0].shape)

    @staticmethod
    def mul_b3(x):
        return PlainFq2.mul(x, PlainFq2.b3_const(x))


def _field(curve: str):
    return PlainFq if curve == "g1" else PlainFq2


def _split(limbs: torch.Tensor, curve: str) -> tuple:
    """(16k, *B) limbs -> k/1 Fq coordinates (G1) or k/2 Fq2 pairs (G2)."""
    parts = [limbs[16 * i:16 * (i + 1)] for i in range(limbs.shape[0] // 16)]
    if curve == "g1":
        return tuple(parts)
    return tuple((parts[2 * i], parts[2 * i + 1])
                 for i in range(len(parts) // 2))


def _join(coords, curve: str) -> torch.Tensor:
    flat = coords if curve == "g1" else [c for pair in coords for c in pair]
    return torch.cat(list(flat), dim=0)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def runscan_plain(pool: torch.Tensor, ids: torch.Tensor, flags: torch.Tensor,
                  curve: str, proj_in: bool = False) -> torch.Tensor:
    """pool (VC, n) words, ids and flags (R+1, lanes) -> emit (C, R+1,
    lanes). Stream element (r, l) is pool column ids[r, l]; row r of the
    emit holds each lane's finished run total where flags[r] is set, else
    the identity; a flag restarts the carry from the point."""
    F = _field(curve)
    C = rows(curve)
    nrows, lanes = flags.shape
    vals = pool.index_select(1, ids.reshape(-1)).view(-1, nrows, lanes)
    ident = L.unpack(L.to_tensor(ident_words(curve).reshape(C, 1),
                                 vals.device)).expand(2 * C, lanes)
    one = ident[16:32] if curve == "g1" else ident[32:48]
    zero = torch.zeros_like(one)
    carry = ident
    emit = torch.empty((C, nrows, lanes), dtype=torch.int32,
                       device=vals.device)
    for r in range(nrows):
        f = (flags[r] != 0)[None]
        emit[:, r] = L.pack(torch.where(f, carry, ident))
        P = _split(carry, curve)
        Q = _split(L.unpack(vals[:, r]), curve)
        if proj_in:
            S = complete_add(F, P, Q)
        else:
            S = complete_add_z1(F, P, Q)
            Q = Q + ((one,) if curve == "g1" else ((one, zero),))  # Z = 1
        carry = torch.where(f, _join(Q, curve), _join(S, curve))
    return emit


def pairs_add_plain(a: torch.Tensor, b: torch.Tensor,
                    curve: str) -> torch.Tensor:
    P = _split(L.unpack(a), curve)
    Q = _split(L.unpack(b), curve)
    return L.pack(_join(complete_add(_field(curve), P, Q), curve))


def _step_operands(ia, ib, base: int, S: int, device):
    if ia is None:
        ia = base + 2 * torch.arange(S, dtype=torch.int64, device=device)
        ib = ia + 1
    return ia, ib


def step_plain(pool: torch.Tensor, off: int, S: int, curve: str, ia=None,
               ib=None, base: int = 0, mixed: bool = False,
               rounds: int = 1) -> torch.Tensor:
    """`rounds` single rounds: round 0 adds pool[:, a_i] + pool[:, b_i] for
    i < S, round r >= 1 outputs 2i and 2i + 1 of round r - 1; the last
    round's S / 2^(rounds-1) sums go to pool[:, off + i], in place. See step
    for the contract. Returns pool."""
    ia, ib = _step_operands(ia, ib, base, S, pool.device)
    C = rows(curve)
    nrd = 2 * C // 3 if mixed else C  # mixed reads X | Y only
    P = _split(L.unpack(pool[:nrd].index_select(1, ia)), curve)
    Q = _split(L.unpack(pool[:nrd].index_select(1, ib)), curve)
    add = complete_add_mixed if mixed else complete_add
    out = L.pack(_join(add(_field(curve), P, Q), curve))
    for _ in range(1, rounds):
        out = pairs_add_plain(out[:, 0::2], out[:, 1::2], curve)
    pool[:, off:off + out.shape[1]] = out
    return pool


# the MSM's digit layout, which the bucket-tail kernels are built for:
# 8-bit digits of 32 windows, 8 x 32 bit-subset sums per segment
SUBSET_BITS = 8
SUBSET_WINDOWS = 32  # ceil(254 / 8)
SUBSET_BUCKETS = 1 << SUBSET_BITS


@functools.lru_cache(maxsize=None)
def subset_idx(device: torch.device) -> torch.Tensor:
    """The bit-subset gather of the dense (32 x 256) bucket layout: group
    t * 32 + w holds the 128 buckets of window w whose digit has bit t set,
    in digit order."""
    idx = np.zeros((SUBSET_BITS, SUBSET_WINDOWS, SUBSET_BUCKETS // 2),
                   np.int32)
    for t in range(SUBSET_BITS):
        ds = np.flatnonzero((np.arange(SUBSET_BUCKETS) >> t) & 1)
        for wi in range(SUBSET_WINDOWS):
            idx[t, wi] = wi * SUBSET_BUCKETS + ds
    return torch.from_numpy(idx.reshape(-1)).to(device)


MERGE_ADDS = 32  # buckets a block of bucket_merge_kernel: nb's multiple
NB = SUBSET_WINDOWS * SUBSET_BUCKETS  # the dense bucket layout, 8,192


def bucket_merge_plain(emit: torch.Tensor, dense: torch.Tensor, K: int,
                       curve: str, nb: int = NB) -> torch.Tensor:
    """emit (C, m) projective words, dense (K * nb,) int32 columns of it
    -> (C, nb): bucket b is ((L0 + L1) + L2) + ... over its K layers,
    layer k being column dense[k * nb + b]."""
    C = rows(curve)
    layers = emit.index_select(1, dense).view(C, K, nb)
    merged = layers[:, 0]
    for k in range(1, K):
        merged = pairs_add_plain(merged, layers[:, k], curve)
    return merged


def bucket_tree_plain(merged: torch.Tensor, curve: str) -> torch.Tensor:
    """merged (C, 8192) dense buckets (window w, digit d at w * 256 + d)
    -> (C, 256) projective bit-subset sums, column t * 32 + w: each
    group's 128 buckets (subset_idx) fold pairwise, x[i] += x[i + h] for
    h = 64, ..., 1."""
    C = rows(curve)
    h = SUBSET_BUCKETS // 2
    x = merged.index_select(1, subset_idx(merged.device)).view(C, -1, h)
    while h > 1:
        h //= 2
        x = pairs_add_plain(x[:, :, :h].reshape(C, -1),
                            x[:, :, h:2 * h].reshape(C, -1),
                            curve).view(C, -1, h)
    return x[:, :, 0]


def bucket_tail_plain(emit2: torch.Tensor, dense: torch.Tensor, K: int,
                      curve: str) -> torch.Tensor:
    """emit2 (C, m) level-2 emit words, dense (K * 8192,) int32 columns of
    it -> (C, 256) projective bit-subset sums: bucket_merge_plain, then
    bucket_tree_plain."""
    return bucket_tree_plain(bucket_merge_plain(emit2, dense, K, curve),
                             curve)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def runscan(pool: torch.Tensor, ids: torch.Tensor, flags: torch.Tensor,
            curve: str, proj_in: bool = False) -> torch.Tensor:
    """The bucket run-scan over the stream that ids gathers from pool; see
    runscan_plain for the contract. pool may be a column slice of a wider
    pool (its rows strided, its columns contiguous); every id must lie in
    [0, pool.shape[1])."""
    if all(t.device.type == "cpu" for t in (pool, ids, flags)):
        return runscan_plain(pool, ids, flags, curve, proj_in)
    nrows, lanes = flags.shape
    VC = rows(curve, proj_in)
    dev = cuda.check([ids, flags], [(nrows, lanes)] * 2, "runscan")
    if pool.device != dev or pool.dtype != torch.int32:
        raise ValueError(f"runscan: pool must be int32 words on {dev}, got "
                         f"{pool.dtype} on {pool.device}")
    if pool.dim() != 2 or pool.shape[0] != VC or (
            pool.shape[1] > 1 and pool.stride(1) != 1):
        raise ValueError(f"runscan: pool must be ({VC}, n) words with "
                         f"contiguous columns, got shape {tuple(pool.shape)} "
                         f"strides {pool.stride()}")
    emit = torch.empty((rows(curve), nrows, lanes), dtype=torch.int32,
                       device=dev)
    cuda.launch("curve_kernels", "zt_runscan", 0 if curve == "g1" else 1,
                int(proj_in), pool.data_ptr(), ids.data_ptr(),
                flags.data_ptr(), emit.data_ptr(), nrows, lanes,
                pool.stride(0), device=dev)
    cuda.count("runscan")
    return emit


def bucket_merge(emit: torch.Tensor, dense: torch.Tensor, K: int,
                 curve: str, nb: int = NB) -> torch.Tensor:
    """The K dense layers folded into nb buckets; see bucket_merge_plain.
    emit: (C, m) words with contiguous columns; dense: K * nb int32
    columns of it; nb a multiple of MERGE_ADDS."""
    if emit.device.type == "cpu" and dense.device.type == "cpu":
        return bucket_merge_plain(emit, dense, K, curve, nb)
    if nb % MERGE_ADDS or nb < MERGE_ADDS or K < 1:
        raise ValueError(f"bucket_merge: nb = {nb} is not a positive "
                         f"multiple of {MERGE_ADDS}, or K = {K} < 1")
    C = rows(curve)
    dev = cuda.check([emit, dense], [(C, emit.shape[1]), (K * nb,)],
                     "bucket_merge")
    merged = torch.empty((C, nb), dtype=torch.int32, device=dev)
    cuda.launch("curve_kernels", "zt_bucket_merge", 0 if curve == "g1" else 1,
                emit.data_ptr(), emit.shape[1], dense.data_ptr(), K, nb,
                merged.data_ptr(), device=dev)
    cuda.count("bucket_tail")
    return merged


def bucket_tree(merged: torch.Tensor, curve: str) -> torch.Tensor:
    """The 256 bit-subset sums of the dense buckets; see
    bucket_tree_plain."""
    if merged.device.type == "cpu":
        return bucket_tree_plain(merged, curve)
    C = rows(curve)
    dev = cuda.check([merged], [(C, NB)], "bucket_tree")
    out = torch.empty((C, SUBSET_BITS * SUBSET_WINDOWS), dtype=torch.int32,
                      device=dev)
    cuda.launch("curve_kernels", "zt_bucket_tree", 0 if curve == "g1" else 1,
                merged.data_ptr(), NB, out.data_ptr(), device=dev)
    cuda.count("bucket_tail")
    return out


def bucket_tail(emit2: torch.Tensor, dense: torch.Tensor, K: int,
                curve: str) -> torch.Tensor:
    """The MSM's bucket tail, gathers included: bucket_merge, then
    bucket_tree; see bucket_tail_plain. emit2: (C, m) words with contiguous
    columns (the level-2 run-scan's emit, viewed flat); dense: K * 8192
    int32 columns of it."""
    return bucket_tree(bucket_merge(emit2, dense, K, curve), curve)


def merge_pairs(a: torch.Tensor, b: torch.Tensor, curve: str) -> torch.Tensor:
    """a + b column by column, (C, w) projective words each, w a multiple
    of MERGE_ADDS: bucket_merge with K = 2 over [a | b] (the sharded MSM's
    reduce-scatter adds and its fold of a shard's segments)."""
    w = a.shape[1]
    dense = torch.arange(2 * w, dtype=torch.int32, device=a.device)
    return bucket_merge(torch.cat([a, b], dim=1), dense, 2, curve, nb=w)


STEP_MAX_ROUNDS = 5  # tree levels step_kernel keeps pending operands for


def step(pool: torch.Tensor, off: int, S: int, curve: str, ia=None, ib=None,
         base: int = 0, read_hi: int = None, mixed: bool = False,
         rounds: int = 1):
    """`rounds` in-place rounds of a slot-pool reduction tree over pool
    (C, total) projective words, in one launch. Round 0 adds
    pool[:, a_i] + pool[:, b_i] for i < S (complete add; with mixed, the
    9-product add of two Z = 1 operands, reading X | Y only). Its operands:
    slot ids ia, ib (S int32 each, all below read_hi), or with ia = ib =
    None the pairing a_i = base + 2i, b_i = base + 2i + 1. Round r >= 1 adds
    outputs 2i and 2i + 1 of round r - 1; the last round's S / 2^(rounds-1)
    sums go to pool[:, off + i]. 2^(rounds-1) must divide S, and the slots
    read and the slots written must be disjoint; this raises otherwise.
    Returns pool."""
    total = pool.shape[1]
    if not 1 <= rounds <= STEP_MAX_ROUNDS:
        raise ValueError(f"step: rounds must lie in [1, {STEP_MAX_ROUNDS}], "
                         f"got {rounds}")
    span = 1 << (rounds - 1)
    if S % span:
        raise ValueError(f"step: {rounds} rounds need S a multiple of "
                         f"{span}, got S = {S}")
    nout = S // span
    if off < 0 or off + nout > total:
        raise ValueError(f"step: write block [{off}, {off + nout}) outside "
                         f"the pool of {total} slots")
    if ia is None:
        lo, hi = base, base + 2 * S
        if ib is not None or lo < 0 or hi > total:
            raise ValueError("step: bad pairing operands")
    else:
        lo, hi = 0, read_hi
        if ib is None or read_hi is None:
            raise ValueError("step: index operands need ia, ib and read_hi")
    if lo < off + nout and off < hi:
        raise ValueError(f"step: slots read [{lo}, {hi}) overlap the slots "
                         f"written [{off}, {off + nout})")
    if pool.device.type == "cpu":
        if ia is not None and S and not (
                0 <= min(int(ia.min()), int(ib.min()))
                and max(int(ia.max()), int(ib.max())) < read_hi):
            raise ValueError(f"step: slot ids outside [0, {read_hi})")
        return step_plain(pool, off, S, curve, ia, ib, base, mixed, rounds)
    tensors, shapes = [pool], [(rows(curve), total)]
    if ia is not None:
        tensors += [ia, ib]
        shapes += [(S,), (S,)]
    dev = cuda.check(tensors, shapes, "step")
    cuda.launch("curve_kernels", "zt_step", 0 if curve == "g1" else 1,
                int(mixed), pool.data_ptr(),
                None if ia is None else ia.data_ptr(),
                None if ib is None else ib.data_ptr(), base, off, S, total,
                rounds, device=dev)
    cuda.count("step")
    return pool
