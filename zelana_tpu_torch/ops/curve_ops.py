"""Jacobian point arithmetic of the windowed MSM (ops/msm.py), G1 over Fq
and G2 over Fq2, each beside its kernel.

- ``point_add(F, p, q)`` (add-2007-bl with the mask dispatch: p == q
  doubles, p == -q gives the identity, either operand at infinity gives the
  other) and ``point_double(F, p)`` (dbl-2009-l, a = 0), with
  ``point_inf``, ``point_is_inf``, ``point_select`` and ``point_neg``: the
  plain versions, transcribed from the JAX package's curve_ops.py.
- ``jac_add(p, q, curve)``: p + q over a batch of points; CUDA kernel
  ``csrc/jac_kernels.cu: jac_add_kernel``.
- The MSM's three forms, one launch each: ``jac_scan_step`` (one step of
  the segmented Hillis-Steele scan, its keep mask from run positions;
  ``jac_scan_kernel``), ``jac_bucket_reduce`` (the descending running sum
  over buckets 255..1 of each window, all 510 adds; ``jac_reduce_kernel``)
  and ``jac_horner`` (eight doublings and an add a window, high to low;
  ``jac_horner_kernel``). Each kernel shares its adds and doublings among
  a team of threads (the file's header says how).

The JAX versions are XLA programs (no Pallas kernel stands behind them).
Each form has its plain version here (``*_plain``): the JAX package's
rolls, selects and loops over point_add / point_double, which the wrappers
run on CPU tensors; on CUDA tensors they launch the kernel or raise.

A point is a coordinate triple (X, Y, Z) with Z == 0 encoding infinity;
the identity is (0 : one : 0). In the plain versions coordinates
are (16, *B) int64 limbs of Montgomery forms (G1, ``FqOps``; ops/limbs.py)
or (c0, c1) pairs of them (G2, ``Fq2Ops``). The kernels' wrappers take
words-first (C, ...) int32 tensors, rows X | Y | Z: C = 24 for G1, 48 for
G2 (X.c0, X.c1, Y.c0, ...); ``split`` and ``join`` convert.

A plain field op costs about the same for one element as for a few
hundred, so each field op takes operands stacked along a new batch
dimension, and ``_lockstep`` runs the formulas of point_add and its
fallback doubling side by side, handing the independent products (and
sums) of each round to one stacked call.
"""

from __future__ import annotations

import torch

from . import cuda
from . import curve_kernels as CK
from . import limbs as L


class FqOps:
    """Coordinate ops for G1: Fq elements as (16, *B) int64 limbs of their
    Montgomery forms (ops/limbs.py's plain arithmetic)."""

    @staticmethod
    def mul(a, b):
        return L.mul_l(a, b, L.FQ)

    @staticmethod
    def add(a, b):
        return L.add_l(a, b, L.FQ)

    @staticmethod
    def sub(a, b):
        return L.sub_l(a, b, L.FQ)

    @staticmethod
    def neg(a):
        return L.sub_l(torch.zeros_like(a), a, L.FQ)

    @staticmethod
    def is_zero(a):
        return (a == 0).all(dim=0)

    @staticmethod
    def select(mask, a, b):
        return torch.where(mask[None], a, b)

    @staticmethod
    def zeros_like(a):
        return torch.zeros_like(a)

    @staticmethod
    def one_like(a):
        """One in Montgomery form, in a's shape and device."""
        one = L.unpack(L.broadcast(L.FQ.one_mont, 1, a.device))
        return one.view((L.NLIMBS,) + (1,) * (a.dim() - 1)).expand(a.shape)

    @staticmethod
    def stack(xs):
        return torch.stack(xs, dim=1)

    @staticmethod
    def unstack(x):
        return list(x.unbind(1))


class Fq2Ops:
    """Coordinate ops for G2: Fq2 elements as (c0, c1) pairs of FqOps
    elements, u^2 = -1."""

    @staticmethod
    def mul(a, b):
        # (a0 b0 - a1 b1, a0 b1 + a1 b0): the four Fq products in one
        # stacked call. The kernels' Karatsuba gives the same field values.
        t = FqOps.unstack(FqOps.mul(FqOps.stack([a[0], a[1], a[0], a[1]]),
                                    FqOps.stack([b[0], b[1], b[1], b[0]])))
        return (FqOps.sub(t[0], t[1]), FqOps.add(t[2], t[3]))

    @staticmethod
    def add(a, b):
        return tuple(FqOps.unstack(FqOps.add(FqOps.stack(list(a)),
                                             FqOps.stack(list(b)))))

    @staticmethod
    def sub(a, b):
        return tuple(FqOps.unstack(FqOps.sub(FqOps.stack(list(a)),
                                             FqOps.stack(list(b)))))

    @staticmethod
    def neg(a):
        return (FqOps.neg(a[0]), FqOps.neg(a[1]))

    @staticmethod
    def is_zero(a):
        return FqOps.is_zero(a[0]) & FqOps.is_zero(a[1])

    @staticmethod
    def select(mask, a, b):
        return (FqOps.select(mask, a[0], b[0]), FqOps.select(mask, a[1], b[1]))

    @staticmethod
    def zeros_like(a):
        return (torch.zeros_like(a[0]), torch.zeros_like(a[1]))

    @staticmethod
    def one_like(a):
        return (FqOps.one_like(a[0]), torch.zeros_like(a[1]))

    @staticmethod
    def stack(xs):
        return (FqOps.stack([x[0] for x in xs]),
                FqOps.stack([x[1] for x in xs]))

    @staticmethod
    def unstack(x):
        return list(zip(FqOps.unstack(x[0]), FqOps.unstack(x[1])))


def ops(curve: str):
    return FqOps if curve == "g1" else Fq2Ops


# ---------------------------------------------------------------------------
# the formulas, as programs of field ops run in lockstep
# ---------------------------------------------------------------------------


def _lockstep(F, *programs):
    """Run generator programs side by side. Each yields (op, pairs), op one
    of "mul", "add", "sub", and receives the results; in a round, every
    program waiting on the op of the program that has waited longest has
    its pairs done in one stacked call of that op. Returns the programs'
    return values."""
    reqs = [next(p) for p in programs]
    out = [None] * len(programs)
    waited = [0] * len(programs)
    live = list(range(len(programs)))
    while live:
        op = reqs[max(live, key=lambda i: (waited[i], -i))][0]
        batch = [i for i in live if reqs[i][0] == op]
        for i in live:
            waited[i] = 0 if i in batch else waited[i] + 1
        pairs = [pair for i in batch for pair in reqs[i][1]]
        if len(pairs) == 1:
            res = [getattr(F, op)(*pairs[0])]
        else:
            res = F.unstack(getattr(F, op)(F.stack([a for a, _ in pairs]),
                                           F.stack([b for _, b in pairs])))
        for i in batch:
            k = len(reqs[i][1])
            mine, res = res[:k], res[k:]
            try:
                reqs[i] = programs[i].send(mine)
            except StopIteration as stop:
                out[i] = stop.value
                live.remove(i)
    return out


def _double_program(p):
    """dbl-2009-l (a = 0): 7 products, the field values of the JAX
    point_double's terms."""
    X, Y, Z = p
    A, B, YZ = yield "mul", [(X, X), (Y, Y), (Y, Z)]
    XB, A2, YZ2 = yield "add", [(X, B), (A, A), (YZ, YZ)]  # Z3 = 2 Y Z
    C, t = yield "mul", [(B, B), (XB, XB)]
    E, C2, AC = yield "add", [(A2, A), (C, C), (A, C)]  # E = 3A
    Fv, = yield "mul", [(E, E)]
    u, = yield "sub", [(t, AC)]
    D, C4 = yield "add", [(u, u), (C2, C2)]  # D = 2 ((X + B)^2 - A - C)
    D2, C8 = yield "add", [(D, D), (C4, C4)]
    X3, = yield "sub", [(Fv, D2)]
    DX, = yield "sub", [(D, X3)]
    EDX, = yield "mul", [(E, DX)]
    Y3, = yield "sub", [(EDX, C8)]
    return (X3, Y3, YZ2)


def _add_program(p1, p2):
    """add-2007-bl: 16 products; returns the sum and (H, S2 - S1), whose
    zeros the mask dispatch reads."""
    X1, Y1, Z1 = p1
    X2, Y2, Z2 = p2
    Z1Z1, Z2Z2, Y1Z2, Y2Z1 = yield "mul", [(Z1, Z1), (Z2, Z2), (Y1, Z2),
                                           (Y2, Z1)]
    U1, U2, S1, S2 = yield "mul", [(X1, Z2Z2), (X2, Z1Z1), (Y1Z2, Z2Z2),
                                   (Y2Z1, Z1Z1)]
    H, SS = yield "sub", [(U2, U1), (S2, S1)]
    H2, Rr = yield "add", [(H, H), (SS, SS)]  # r = 2 (S2 - S1)
    I, Rr2, HZ = yield "mul", [(H2, H2), (Rr, Rr), (H2, Z1)]
    J, V, Z3 = yield "mul", [(H, I), (U1, I), (HZ, Z2)]
    V2, = yield "add", [(V, V)]
    X3, = yield "sub", [(Rr2, J)]
    X3, = yield "sub", [(X3, V2)]
    VX, = yield "sub", [(V, X3)]
    RVX, S1J = yield "mul", [(Rr, VX), (S1, J)]
    S1J2, = yield "add", [(S1J, S1J)]
    Y3, = yield "sub", [(RVX, S1J2)]
    return (X3, Y3, Z3), (H, SS)


def point_inf(F, like):
    """The identity (0 : one : 0), in the shape of coordinate `like`."""
    zero = F.zeros_like(like)
    return (zero, F.one_like(like), zero)


def point_is_inf(F, p):
    return F.is_zero(p[2])


def point_select(F, mask, a, b):
    return tuple(F.select(mask, x, y) for x, y in zip(a, b))


def point_double(F, p):
    """dbl-2009-l formulas (a = 0)."""
    return _lockstep(F, _double_program(p))[0]


def point_add(F, p1, p2):
    """Branch-free general Jacobian addition (add-2007-bl + mask dispatch).

    Handles p1 == p2 (falls through to doubling p1), either operand at
    infinity, and p1 == -p2 (returns infinity), all via select masks."""
    (added, (H, SS)), doubled = _lockstep(F, _add_program(p1, p2),
                                          _double_program(p1))
    h_zero = F.is_zero(H)
    r_zero = F.is_zero(SS)
    inf1 = point_is_inf(F, p1)
    inf2 = point_is_inf(F, p2)
    infp = point_inf(F, p1[0])

    # same x: either double (same y) or infinity (opposite y)
    res = point_select(F, h_zero & r_zero, doubled, added)
    res = point_select(F, h_zero & ~r_zero & ~inf1 & ~inf2, infp, res)
    res = point_select(F, inf1, p2, res)
    res = point_select(F, inf2, p1, res)
    return res


def point_neg(F, p):
    return (p[0], F.neg(p[1]), p[2])


# ---------------------------------------------------------------------------
# (C, n) words <-> coordinate triples, and the kernels' plain versions
# ---------------------------------------------------------------------------


def split(words: torch.Tensor, curve: str) -> tuple:
    """(C, *B) words -> (X, Y, Z) in the curve's coordinate ops."""
    limbs = L.unpack(words)
    c = [limbs[16 * i:16 * (i + 1)] for i in range(limbs.shape[0] // 16)]
    if curve == "g1":
        return tuple(c)
    return tuple((c[2 * i], c[2 * i + 1]) for i in range(3))


def join(p, curve: str) -> torch.Tensor:
    """(X, Y, Z) -> (C, *B) words."""
    flat = p if curve == "g1" else [c for pair in p for c in pair]
    return L.pack(torch.cat([c.expand_as(flat[0]) for c in flat], dim=0))


def ident_words(curve: str, n: int, device) -> torch.Tensor:
    """(C, n) words of the identity (0 : one : 0): one copy to `device`."""
    col = CK.ident_words(curve).reshape(CK.rows(curve), 1)
    return L.to_tensor(col, device).expand(CK.rows(curve), n).contiguous()


def jac_add_plain(p: torch.Tensor, q: torch.Tensor,
                  curve: str) -> torch.Tensor:
    F = ops(curve)
    return join(point_add(F, split(p, curve), split(q, curve)), curve)


def jac_double_plain(p: torch.Tensor, curve: str, count: int = 1,
                     addend: torch.Tensor = None) -> torch.Tensor:
    """2^count p (count point_doubles), then + addend (point_add) where one
    is given, of each column of (C, n) Jacobian words."""
    if count < 0:
        raise ValueError(f"jac_double_plain: count must be >= 0, got {count}")
    F = ops(curve)
    acc = split(p, curve)
    for _ in range(count):
        acc = point_double(F, acc)
    if addend is not None:
        acc = point_add(F, acc, split(addend, curve))
    return join(acc, curve)


WINDOW_BITS = 8  # the Horner's doublings a window (ops/msm.py's windows)


def jac_scan_step_plain(src: torch.Tensor, pos: torch.Tensor, offset: int,
                        curve: str) -> torch.Tensor:
    """One Hillis-Steele step of the segmented scan along the rows of (C, W,
    N) words: lane i adds lane i - offset (point_add(lane i, lane i -
    offset)) unless pos < offset, its run position (i - the start of its
    run): the run starts within reach, or i < offset."""
    C = src.shape[0]
    shifted = torch.roll(src, offset, dims=-1)
    summed = jac_add_plain(src.reshape(C, -1), shifted.reshape(C, -1), curve)
    return torch.where((pos < offset)[None], src, summed.view_as(src))


def jac_bucket_reduce_plain(vals: torch.Tensor, ends: torch.Tensor,
                            curve: str) -> torch.Tensor:
    """Descending running sum over buckets B-1..1 of each window, batched
    across the windows: (C, W) words of sum_d d * S_d, S_d the scan's
    words (C, W, N) at the end of digit d's run (ends (W, B) lanes; -1:
    empty, zeros, infinity)."""
    e = ends.long()
    sums = vals.reshape(vals.shape[0], -1)[:, e.clamp(min=0)]
    sums = sums * (e >= 0).to(sums.dtype)
    running = total = ident_words(curve, vals.shape[1], vals.device)
    for d in range(ends.shape[1] - 1, 0, -1):
        running = jac_add_plain(running, sums[:, :, d].contiguous(), curve)
        total = jac_add_plain(total, running, curve)
    return total


def jac_horner_plain(totals: torch.Tensor, curve: str) -> torch.Tensor:
    """(C, W) window totals -> the (C, 1) words of sum_w 2^(8 w) T[w]:
    acc = T[W-1], then WINDOW_BITS doublings and + T[w], w = W-2..0."""
    W = totals.shape[1]
    acc = totals[:, W - 1:]
    for w in range(W - 2, -1, -1):
        acc = jac_double_plain(acc, curve, WINDOW_BITS, totals[:, w:w + 1])
    return acc


MASK_CASES = ("general", "p at infinity", "q at infinity", "both at "
              "infinity", "q = p", "q = p, other coordinates", "q = -p",
              "q = -p, other coordinates")


def seed_mask_cases(p: torch.Tensor, q: torch.Tensor, lam: torch.Tensor,
                    curve: str):
    """(p, q) of (C, n) words with point_add's mask cases seeded in: column
    i takes case MASK_CASES[i % 8]. `lam`: (C / 3, n) words of nonzero
    scalars; "other coordinates" is (X l^2, Y l^3, Z l), the same point."""
    F = ops(curve)
    P, Q = list(split(p, curve)), list(split(q, curve))
    lo = L.unpack(lam)
    lam_c = lo if curve == "g1" else (lo[:L.NLIMBS], lo[L.NLIMBS:])
    L2 = F.mul(lam_c, lam_c)
    scaled = (F.mul(P[0], L2), F.mul(F.mul(P[1], L2), lam_c),
              F.mul(P[2], lam_c))
    case = torch.arange(p.shape[1], device=p.device) % len(MASK_CASES)
    zero = F.zeros_like(P[2])
    P[2] = F.select((case == 1) | (case == 3), zero, P[2])
    Q[2] = F.select((case == 2) | (case == 3), zero, Q[2])
    for k, src in ((4, tuple(P)), (5, scaled), (6, point_neg(F, tuple(P))),
                   (7, point_neg(F, scaled))):
        Q = list(point_select(F, case == k, src, tuple(Q)))
    return join(tuple(P), curve), join(tuple(Q), curve)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check_points(tensors, curve: str, what: str) -> torch.device:
    """Raise unless each tensor is (C, n) int32 words on one CUDA device,
    its columns contiguous (a row stride of its own is allowed)."""
    C, n = CK.rows(curve), tensors[0].shape[-1]
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{what}: all operands must be on one CUDA "
                             f"device, got {t.device} and {dev}")
        if t.dtype != torch.int32:
            raise TypeError(f"{what}: expected int32 words, got {t.dtype}")
        if t.dim() != 2 or tuple(t.shape) != (C, n) or (
                n > 1 and t.stride(1) != 1):
            raise ValueError(f"{what}: points must be ({C}, {n}) words with "
                             f"contiguous columns, got shape "
                             f"{tuple(t.shape)} strides {t.stride()}")
    return dev


def jac_add(p: torch.Tensor, q: torch.Tensor, curve: str) -> torch.Tensor:
    """p + q (point_add) of each column of two (C, n) Jacobian word
    batches; a new contiguous (C, n) tensor."""
    if p.device.type == "cpu" and q.device.type == "cpu":
        return jac_add_plain(p, q, curve)
    dev = _check_points([p, q], curve, "jac_add")
    n = p.shape[1]
    out = torch.empty((CK.rows(curve), n), dtype=torch.int32, device=dev)
    if n:
        cuda.launch("jac_kernels", "zt_jac_add", 0 if curve == "g1" else 1,
                    p.data_ptr(), p.stride(0), q.data_ptr(), q.stride(0),
                    out.data_ptr(), n, device=dev)
        cuda.LAUNCHES["jac_add"] += 1
    return out


def jac_scan_step(src: torch.Tensor, dst: torch.Tensor, pos: torch.Tensor,
                  offset: int, curve: str) -> torch.Tensor:
    """One step of the segmented scan (jac_scan_step_plain) from src into
    dst, two (C, W, N) word buffers; pos (W, N) int32 run positions.
    Returns dst. On either device only the lanes with pos >= offset // 2
    are written: the lanes below are final since an earlier step (or, at
    pos -1, never read), and a scan that swaps the two buffers step by step
    from offset 1 already holds them in both."""
    if offset < 1:
        raise ValueError(f"jac_scan_step: offset must be >= 1, got {offset}")
    if src.device.type == "cpu" and dst.device.type == "cpu":
        w = (pos >= offset // 2)[None].expand_as(dst)
        dst[w] = jac_scan_step_plain(src, pos, offset, curve)[w]
        return dst
    C, W, N = CK.rows(curve), pos.shape[0], pos.shape[-1]
    dev = cuda.check([src, dst, pos], [(C, W, N), (C, W, N), (W, N)],
                     "jac_scan_step")
    if src.data_ptr() == dst.data_ptr():
        raise ValueError("jac_scan_step: src and dst must be two buffers")
    if W * N:
        cuda.launch("jac_kernels", "zt_jac_scan", 0 if curve == "g1" else 1,
                    src.data_ptr(), dst.data_ptr(), pos.data_ptr(), W * N,
                    offset, device=dev)
        cuda.LAUNCHES["jac_scan"] += 1
    return dst


def jac_bucket_reduce(vals: torch.Tensor, ends: torch.Tensor,
                      out: torch.Tensor, curve: str) -> torch.Tensor:
    """jac_bucket_reduce_plain of (C, W, N) scan words and (W, 256) int32
    run-end lanes into out, (C, W) words with a row stride of its own (a
    column slice of the MSM's window totals); one launch, a block a
    window. Returns out."""
    if vals.device.type == "cpu" and out.device.type == "cpu":
        return out.copy_(jac_bucket_reduce_plain(vals, ends, curve))
    C, W, N = CK.rows(curve), ends.shape[0], vals.shape[-1]
    dev = cuda.check([vals, ends], [(C, W, N), (W, 256)],
                     "jac_bucket_reduce")
    _check_points([out], curve, "jac_bucket_reduce out")
    if out.device != dev or out.shape[1] != W:
        raise ValueError(f"jac_bucket_reduce: out must be ({C}, {W}) on "
                         f"{dev}, got {tuple(out.shape)} on {out.device}")
    if W:
        cuda.launch("jac_kernels", "zt_jac_reduce", 0 if curve == "g1" else 1,
                    vals.data_ptr(), W * N, ends.data_ptr(), W,
                    out.data_ptr(), out.stride(0), device=dev)
        cuda.LAUNCHES["jac_reduce"] += 1
    return out


def jac_horner(totals: torch.Tensor, curve: str) -> torch.Tensor:
    """jac_horner_plain of (C, W) window totals (a row stride of its own
    allowed, 1 <= W <= 64): the (C, 1) words of sum_w 2^(8 w) T[w], one
    launch on one team."""
    if totals.device.type == "cpu":
        return jac_horner_plain(totals, curve)
    dev = _check_points([totals], curve, "jac_horner")
    W = totals.shape[1]
    if not 1 <= W <= 64:
        raise ValueError(f"jac_horner: 1 to 64 windows, got {W}")
    out = torch.empty((CK.rows(curve), 1), dtype=torch.int32, device=dev)
    cuda.launch("jac_kernels", "zt_jac_horner", 0 if curve == "g1" else 1,
                totals.data_ptr(), totals.stride(0), W, out.data_ptr(),
                device=dev)
    cuda.LAUNCHES["jac_horner"] += 1
    return out
