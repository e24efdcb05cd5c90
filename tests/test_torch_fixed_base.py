"""The port's keygen engine on the CPU against the JAX package: the `step`
kernel's plain version (general and mixed complete adds, in place in a slot
pool) against pallas_curve's XLA formulas, and the fixed-base MSM against
the JAX host windowed tables. Inputs are seeded numpy draws; equality is
exact."""

import numpy as np
import pytest
import torch

from zelana_tpu.curves import g1 as JG1, g2 as JG2
from zelana_tpu.groth16.setup import FixedBase as JFixedBase
from zelana_tpu.ops import pallas_curve as JPC
from zelana_tpu_torch.curves import g1 as G1, g2 as G2
from zelana_tpu_torch.fields import tower as tw
from zelana_tpu_torch.fields.bn254 import P, R as FR
from zelana_tpu_torch.ops import curve_kernels as CK
from zelana_tpu_torch.ops import fixed_base as FB
from zelana_tpu_torch.ops import limbs as L

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
