"""The port's keygen engine on the CPU against the JAX package: the `step`
kernel's plain version (general and mixed complete adds, in place in a slot
pool; several rounds in one call) against pallas_curve's XLA formulas and
the JAX `_run_fb`, the fixed-base MSM against the JAX host windowed tables,
and a thread-by-thread model of the cooperative complete add of
csrc/curve_kernels.cu against complete_add. Inputs are seeded numpy draws;
equality is exact."""

import numpy as np
import pytest
import torch

from zelana_tpu.curves import g1 as JG1, g2 as JG2
from zelana_tpu.groth16.setup import FixedBase as JFixedBase
from zelana_tpu.ops import fixed_base as JFB
from zelana_tpu.ops import pallas_curve as JPC
from zelana_tpu_torch.curves import g1 as G1, g2 as G2
from zelana_tpu_torch.fields import tower as tw
from zelana_tpu_torch.fields.bn254 import P, R as FR
from zelana_tpu_torch.ops import curve_kernels as CK
from zelana_tpu_torch.ops import fixed_base as FB
from zelana_tpu_torch.ops import limbs as L
from zelana_tpu_torch.r1cs.native_synth import fr_array, words32

torch.set_num_threads(1)  # many small int64 ops: threads only contend

N = 256  # columns of each step check


def _rand_fq(rng, fq2: bool):
    v = [int.from_bytes(rng.bytes(32), "little") % P for _ in range(2)]
    return tuple(v) if fq2 else v[0]


def _proj(pt, z, fq2: bool):
    """Affine point (or None) -> a projective representative (X : Y : Z)."""
    if fq2:
        zero, one, mul = (0, 0), (1, 0), tw.fq2_mul
    else:
        zero, one, mul = 0, 1, (lambda a, b: a * b % P)
    if pt is None:
        return zero, one, zero
    return mul(pt[0], z), mul(pt[1], z), z


def _neg(pt, fq2: bool):
    return (pt[0], tuple((-c) % P for c in pt[1]) if fq2 else (-pt[1]) % P)


def _words(proj_pts, fq2: bool) -> np.ndarray:
    """Projective points -> (C, n) uint32 Montgomery words."""
    cols = []
    for k in range(3):
        vals = [p[k] for p in proj_pts]
        if fq2:
            cols += [L.encode_mont([v[0] for v in vals], L.FQ),
                     L.encode_mont([v[1] for v in vals], L.FQ)]
        else:
            cols.append(L.encode_mont(vals, L.FQ))
    return np.concatenate(cols)


def _operands(curve: str, rng):
    """Two aligned lists of N projective points: random multiples of the
    generator with random Z, plus the identity on either side, doublings
    (the same point under another Z) and P + (-P). For mixed adds every Z is
    one and the identity is the (0, 1) padding slot."""
    fq2 = curve == "g2"
    gen = (G2 if fq2 else G1).generator()
    table = FB.build_table(gen, curve)
    pick = [table[i] for i in rng.integers(0, len(table), 2 * N)]
    a_aff, b_aff = pick[:N], pick[N:]
    a_aff[0] = None
    b_aff[1] = None
    a_aff[2] = b_aff[2] = None
    for i in range(3, 8):  # doubling
        b_aff[i] = a_aff[i]
    for i in range(8, 12):  # P + (-P)
        b_aff[i] = _neg(a_aff[i], fq2)
    return a_aff, b_aff


def _jax_add(A: np.ndarray, B: np.ndarray, curve: str, mixed: bool):
    """JAX pallas_curve formula over (C, n) words -> (C, n) words."""
    import jax.numpy as jnp

    def split(words, k):
        limbs = jnp.asarray(L.limbs16_from_words(words))
        parts = [limbs[16 * i:16 * (i + 1)] for i in range(k)]
        if curve == "g1":
            return tuple(parts)
        return tuple((parts[2 * i], parts[2 * i + 1]) for i in range(k // 2))

    C = CK.rows(curve)
    k = (2 if mixed else 3) * (1 if curve == "g1" else 2)
    if mixed:
        F = JPC.XlaFq if curve == "g1" else JPC.XlaFq2
        out = JPC.complete_add_mixed(F, split(A[:2 * C // 3], k),
                                     split(B[:2 * C // 3], k))
    else:
        out = JPC.proj_add_xla(split(A, k), split(B, k), curve)
    flat = out if curve == "g1" else [c for pair in out for c in pair]
    return L.words_from_limbs16(np.concatenate([np.asarray(c)
                                                for c in flat]))


@pytest.mark.parametrize("curve,mixed", [("g1", False), ("g1", True),
                                         ("g2", False), ("g2", True)])
def test_step_plain_matches_jax(curve, mixed):
    rng = np.random.default_rng(7 + 2 * (curve == "g2") + mixed)
    fq2 = curve == "g2"
    a_aff, b_aff = _operands(curve, rng)
    one = (1, 0) if fq2 else 1

    def rep(pt):
        return _proj(pt, one if mixed else _rand_fq(rng, fq2), fq2)

    A = _words([rep(p) for p in a_aff], fq2)
    B = _words([rep(p) for p in b_aff], fq2)
    want = _jax_add(A, B, curve, mixed)

    # pool: A block [0, N), B block [N, 2N), writes [2N, 3N), guard slots
    # after; operands reach the kernel by shuffled slot ids
    C = CK.rows(curve)
    guard = rng.integers(0, 1 << 32, size=(C, 64), dtype=np.uint64)
    perm = rng.permutation(N)
    pool_np = np.concatenate([A[:, perm], B[:, perm],
                              np.zeros((C, N), np.uint32),
                              guard.astype(np.uint32)], axis=1)
    pool = L.to_tensor(pool_np, "cpu")
    inv = torch.from_numpy(np.argsort(perm).astype(np.int32))
    CK.step(pool, 2 * N, N, curve, inv, inv + N, read_hi=2 * N, mixed=mixed)
    got = L.to_numpy(pool)
    assert np.array_equal(got[:, 2 * N:3 * N], want)
    assert np.array_equal(got[:, :2 * N], pool_np[:, :2 * N])
    assert np.array_equal(got[:, 3 * N:], pool_np[:, 3 * N:])

    # the pairing form: slots 2i and 2i + 1 of an interleaved block
    inter = np.empty((C, 2 * N), np.uint32)
    inter[:, 0::2], inter[:, 1::2] = A, B
    pool = L.to_tensor(np.concatenate([inter, np.zeros((C, N), np.uint32)],
                                      axis=1), "cpu")
    CK.step(pool, 2 * N, N, curve, base=0, mixed=mixed)
    assert np.array_equal(L.to_numpy(pool)[:, 2 * N:], want)


def test_step_refuses_overlap():
    pool = torch.zeros((24, 64), dtype=torch.int32)
    with pytest.raises(ValueError, match="overlap"):
        CK.step(pool, 8, 8, "g1", base=0)  # reads [0, 16), writes [8, 16)
    idx = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="overlap"):
        CK.step(pool, 8, 8, "g1", idx, idx, read_hi=9)
    with pytest.raises(ValueError, match="outside"):
        CK.step(pool, 16, 8, "g1", idx + 20, idx, read_hi=16)


def _rand_pool(rng, C: int, n: int) -> torch.Tensor:
    """(C, n) words of random canonical Fq elements (the adds are
    straight-line formulas: any field elements compare word for word)."""
    vals = [int.from_bytes(rng.bytes(32), "little") % P
            for _ in range(C // 8 * n)]
    return L.to_tensor(np.concatenate(
        [L.encode_mont(vals[k * n:(k + 1) * n], L.FQ)
         for k in range(C // 8)]), "cpu")


@pytest.mark.parametrize("curve,rounds,by_ids,mixed", [
    ("g1", 2, True, False), ("g2", 2, False, False),
    ("g1", 3, False, False), ("g2", 3, True, True)])
def test_step_rounds_match_chained_single_rounds(curve, rounds, by_ids,
                                                 mixed):
    """step(rounds=r) against r single-round steps through a scratch
    block, by slot ids and by pairing; slots outside the write block stay
    untouched."""
    rng = np.random.default_rng(31 + rounds + 2 * by_ids)
    C, S = CK.rows(curve), 32
    pool = _rand_pool(rng, C, 2 * S + S // 2 + 16)
    kw = {"base": 0}
    if by_ids:
        ia, ib = (torch.from_numpy(rng.integers(0, 2 * S, S).astype(
            np.int32)) for _ in range(2))
        kw = {"ia": ia, "ib": ib, "read_hi": 2 * S}
    got = CK.step(pool.clone(), 2 * S, S, curve, mixed=mixed, rounds=rounds,
                  **kw)
    # chained: round 0 into a scratch pool, then pairing rounds after it
    chain = torch.cat([pool, torch.zeros((C, 2 * S), dtype=torch.int32)], 1)
    off = pool.shape[1]
    CK.step(chain, off, S, curve, mixed=mixed, **kw)
    size = S
    for _ in range(1, rounds):
        CK.step(chain, off + size, size // 2, curve, base=off)
        off, size = off + size, size // 2
    nout = S >> (rounds - 1)
    want = pool.clone()
    want[:, 2 * S:2 * S + nout] = chain[:, off:off + nout]
    assert torch.equal(got, want)


def test_step_rounds_refused():
    pool = torch.zeros((24, 64), dtype=torch.int32)
    idx = torch.zeros(12, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 4"):
        CK.step(pool, 32, 14, "g1", base=0, rounds=3)  # 4 does not divide 14
    with pytest.raises(ValueError, match="rounds"):
        CK.step(pool, 32, 16, "g1", base=0, rounds=9)
    with pytest.raises(ValueError, match="rounds"):
        CK.step(pool, 32, 16, "g1", base=0, rounds=0)
    # three rounds write S / 4 slots: [20, 23) overlaps the ids' [0, 21)
    with pytest.raises(ValueError, match="overlap"):
        CK.step(pool, 20, 12, "g1", idx, idx, read_hi=21, rounds=3)
    CK.step(pool, 21, 12, "g1", idx, idx, read_hi=21, rounds=3)


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_step_rounds5_matches_jax_run_fb(curve):
    """Keygen's five rounds in one step_plain call over an 8-scalar chunk
    (128 round-0 adds), against the JAX package's _run_fb (its XLA path on
    the CPU) at bases[4]."""
    import jax.numpy as jnp

    rng = np.random.default_rng(41 if curve == "g1" else 42)
    n = 8
    scalars = _scalars(rng, n)
    J = JG1 if curve == "g1" else JG2
    _, (X, Y) = (JFB.prepare_table_g1 if curve == "g1"
                 else JFB.prepare_table_g2)(J.generator())
    packed = words32(fr_array(scalars))
    _, _, total = JFB._slot_plan(n)
    want = L.words_from_limbs16(JFB._run_fb(X, Y, jnp.asarray(packed), curve,
                                            n, total))
    T = G1 if curve == "g1" else G2
    head = (FB.prepare_table_g1 if curve == "g1"
            else FB.prepare_table_g2)(T.generator(), "cpu")[1]
    pool = torch.cat([head, torch.zeros((head.shape[0], n),
                                        dtype=torch.int32)], 1)
    ia, ib = FB._slot_ids(L.to_tensor(packed, "cpu"))
    CK.step_plain(pool, FB.N_TABLE + 1, 16 * n, curve, ia, ib, rounds=5)
    assert np.array_equal(L.to_numpy(pool[:, FB.N_TABLE + 1:]), want)
    assert torch.equal(pool[:, :FB.N_TABLE + 1], head)


# the cooperative complete add of csrc/curve_kernels.cu (coop_add), thread
# by thread: stage 1 selects coordinate u (j < 3) or the sum of u and v,
# the combine branches on j, stage 2 reads the nibble tables, the final
# stage writes X3 = s1 - s0, Y3 = s3 + s2, Z3 = s5 + s4
COOP_A, COOP_B = 0x435201, 0x104352


def _coop_add_model(F, P, Q, log):
    """Six threads, a shared scratch of 12 slots. Each stage reads only
    what earlier stages wrote; log gets (stage, thread, products) per
    thread and the slot each thread wrote."""
    scr = {}

    def stage(name, fn, threads=range(6)):
        out = {}
        for j in threads:
            count = [0]

            def mul(a, b, count=count):
                count[0] += 1
                return F.mul(a, b)

            slot, val = fn(j, mul)
            assert slot not in out, f"{name}: two threads write slot {slot}"
            out[slot] = val
            log.append((name, j, count[0], slot))
        scr.update(out)  # the barrier: visible from the next stage on

    def s1(j, mul):
        u = j if j < 3 else (1 if j == 4 else 0)
        x, y = P[u], Q[u]
        if j >= 3:
            v = 1 if j == 3 else 2
            x, y = F.add(x, P[v]), F.add(y, Q[v])
        return j, mul(x, y)

    def comb(j, mul):
        t0, t1, t2 = scr[0], scr[1], scr[2]
        b3 = (lambda x: mul(x, F.b3_const(x))) if F is CK.PlainFq2 \
            else F.mul_b3
        r = [lambda: F.sub(scr[3], F.add(t0, t1)),
             lambda: F.sub(scr[4], F.add(t1, t2)),
             lambda: b3(F.sub(scr[5], F.add(t0, t2))),
             lambda: F.add(F.add(t0, t0), t0),
             lambda: F.add(t1, b3(t2)),
             lambda: F.sub(t1, b3(t2))][j]()
        return 6 + j, r

    def s2(j, mul):
        a = 6 + ((COOP_A >> (4 * j)) & 0xF)
        b = 6 + ((COOP_B >> (4 * j)) & 0xF)
        return j, mul(scr[a], scr[b])

    def fin(j, mul):
        hi, lo = scr[2 * j + 1], scr[2 * j]
        return ("out", j), F.sub(hi, lo) if j == 0 else F.add(hi, lo)

    stage("stage 1", s1)
    stage("combine", comb)
    stage("stage 2", s2)
    stage("final", fin, range(3))
    return tuple(scr[("out", c)] for c in range(3))


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_coop_add_model(curve):
    """The six-thread split of the complete add equals complete_add word
    for word on _operands' points (identity either side, doublings,
    P + (-P)) under random Z, and no thread does more than one product a
    stage (G2: one Fq2 product, the 3b' products in the combine)."""
    rng = np.random.default_rng(51 if curve == "g1" else 52)
    fq2 = curve == "g2"
    a_aff, b_aff = _operands(curve, rng)
    A = _words([_proj(p, _rand_fq(rng, fq2), fq2) for p in a_aff], fq2)
    B = _words([_proj(p, _rand_fq(rng, fq2), fq2) for p in b_aff], fq2)
    F = CK._field(curve)
    Pp = CK._split(L.unpack(L.to_tensor(A, "cpu")), curve)
    Qp = CK._split(L.unpack(L.to_tensor(B, "cpu")), curve)
    log = []
    got = L.pack(CK._join(_coop_add_model(F, Pp, Qp, log), curve))
    want = L.pack(CK._join(CK.complete_add(F, Pp, Qp), curve))
    assert torch.equal(got, want)
    assert np.array_equal(L.to_numpy(got), _jax_add(A, B, curve, False))
    products = {}
    for name, j, count, _ in log:
        assert count <= 1, f"thread {j} does {count} products in {name}"
        products[name] = products.get(name, 0) + count
    # critical path: G1 two product stages, G2 three (3b' in the combine)
    assert products == {"stage 1": 6, "combine": 3 if fq2 else 0,
                        "stage 2": 6, "final": 0}


def _scalars(rng, n):
    out = [0, 1, FR - 1]
    out += [int.from_bytes(rng.bytes(32), "little") % FR
            for _ in range(n - 3)]
    return out


@pytest.mark.parametrize("curve,n", [("g1", 24), ("g2", 6)])
def test_fixed_base_msm_matches_jax_host(curve, n):
    rng = np.random.default_rng(11 if curve == "g1" else 12)
    J = JG1 if curve == "g1" else JG2
    T = G1 if curve == "g1" else G2
    fb = JFixedBase(J.generator(), J)
    scalars = _scalars(rng, n)
    want = [fb.mul(s) if s else None for s in scalars]
    prep = (FB.prepare_table_g1 if curve == "g1" else FB.prepare_table_g2)
    table = prep(T.generator(), "cpu")
    assert list(FB.fixed_base_msm(table, scalars)) == want
    if curve == "g1":  # the native keygen input: (n, 4) u64 limbs
        arr = np.frombuffer(b"".join(s.to_bytes(32, "little")
                                     for s in scalars), "<u8").reshape(n, 4)
        got = FB.fixed_base_msm(table, arr)
        assert list(got) == want
        assert got.inf.tolist() == [s == 0 for s in scalars]
