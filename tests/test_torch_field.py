"""The port's field layer (zelana_tpu_torch.ops.limbs, field_kernels) against
the JAX package's ops/limbs on the CPU: same inputs from a numpy seed, exact
equality (integers: no tolerance)."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zelana_tpu_torch
from zelana_tpu.ops import limbs as JL
from zelana_tpu_torch.fields.bn254 import P, R
from zelana_tpu_torch.ops import field_kernels as FK
from zelana_tpu_torch.ops import limbs as TL
from zelana_tpu_torch.ops import ntt as TN

SPECS = [(JL.FQ, TL.FQ), (JL.FR, TL.FR), (JL.BLS_FR, TL.BLS_FR)]
IDS = ["Fq", "Fr", "BLS12-381 Fr"]


def _values(seed: int, n: int, modulus: int) -> list:
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % modulus
            for _ in range(n)]
    vals[:3] = [0, 1, modulus - 1]
    return vals


def _words(limbs16) -> torch.Tensor:
    return TL.to_tensor(TL.words_from_limbs16(np.asarray(limbs16)), "cpu")


@pytest.mark.parametrize("specs", SPECS, ids=IDS)
def test_encode_decode_match_jax(specs):
    jspec, tspec = specs
    vals = _values(1, 300, jspec.modulus)
    j16 = JL.encode_mont(vals, jspec)
    words = TL.encode_mont(vals, tspec)
    assert (words == TL.words_from_limbs16(j16)).all()
    assert (TL.limbs16_from_words(words) == j16).all()
    assert TL.decode_mont(words, tspec) == JL.decode_mont(j16, jspec) == vals
    assert TL.from_words(TL.to_words(vals)) == vals
    t = TL.to_tensor(words, "cpu")
    assert t.dtype == torch.int32 and tuple(t.shape) == (8, 300)
    assert (TL.to_numpy(t) == words).all()
    assert (TL.pack(TL.unpack(t)) == t).all()


@pytest.mark.parametrize("specs", SPECS, ids=IDS)
def test_add_sub_match_jax(specs):
    jspec, tspec = specs
    a = _values(2, 257, jspec.modulus)
    b = _values(3, 257, jspec.modulus)[::-1]
    ja, jb = (jnp.asarray(JL.encode_mont(v, jspec)) for v in (a, b))
    ta, tb = _words(ja), _words(jb)
    for jf, tf in ((JL.add, TL.add), (JL.sub, TL.sub)):
        want = TL.words_from_limbs16(np.asarray(jf(ja, jb, jspec)))
        assert (TL.to_numpy(tf(ta, tb, tspec)) == want).all()


@pytest.mark.parametrize("specs", SPECS, ids=IDS)
def test_mont_mul_matches_jax(specs):
    jspec, tspec = specs
    a = _values(4, 1000, jspec.modulus)
    b = _values(5, 1000, jspec.modulus)[::-1]
    ja, jb = (jnp.asarray(JL.encode_mont(v, jspec)) for v in (a, b))
    want = TL.words_from_limbs16(np.asarray(JL.mont_mul(ja, jb, jspec)))
    got = FK.mont_mul(_words(ja), _words(jb), tspec)
    assert (TL.to_numpy(got) == want).all()
    assert TL.decode_mont(TL.to_numpy(got), tspec) == [
        x * y % jspec.modulus for x, y in zip(a, b)]


def test_butterfly_matches_jax_stage():
    """One DIT stage: (a + w*b, a - w*b) against the JAX field ops."""
    a, b, w = (jnp.asarray(JL.encode_mont(_values(s, 512, R), JL.FR))
               for s in (6, 7, 8))
    bt = JL.mont_mul(b, w, JL.FR)
    even = TL.words_from_limbs16(np.asarray(JL.add(a, bt, JL.FR)))
    odd = TL.words_from_limbs16(np.asarray(JL.sub(a, bt, JL.FR)))
    ge, go = FK.butterfly_plain(_words(a), _words(b), _words(w), TL.FR)
    assert (TL.to_numpy(ge) == even).all()
    assert (TL.to_numpy(go) == odd).all()


def test_wrappers_raise_off_cpu_without_cuda():
    """A tensor that is not on the CPU never reaches the plain version: the
    wrapper wants contiguous int32 CUDA tensors, else it raises."""
    meta = torch.empty((8, 256), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        FK.mont_mul(meta, meta, TL.FR)
    with pytest.raises(ValueError):
        TN.ntt_pass([meta], meta, 0, 8)
    with pytest.raises(ValueError):
        FK.mimc_permute(meta, meta[:, :3].T, TL.FR)
    with pytest.raises(ValueError):
        FK.inv_fwd(meta[:, :1].expand(8, 1024), TL.FR)
    with pytest.raises(ValueError):
        FK.inv_bwd(meta, meta, meta, TL.FR)
    with pytest.raises(ValueError):
        FK.inv_base(meta, TL.FR)


def _cuh_arrays(name: str) -> list:
    path = os.path.join(os.path.dirname(zelana_tpu_torch.__file__), "csrc",
                        "field.cuh")
    with open(path) as f:
        src = f.read()
    body = re.search(name + r"[^=]*=\s*(\{.*?\});", src, re.S).group(1)
    return [int(x, 16) for x in re.findall(r"0x([0-9a-f]+)u", body)]


def test_cuda_constants_match():
    """The constants compiled into csrc/field.cuh are those of BN254 Fq and
    Fr and BLS12-381 Fr, in the order of field_kernels._FIELD_ID."""
    from zelana_tpu_torch.fields import tower as tw

    def words(x):
        return [(x >> (32 * i)) & 0xFFFFFFFF for i in range(8)]

    mods = sorted(FK._FIELD_ID, key=FK._FIELD_ID.get)
    assert mods == [P, R, TL.BLS_FR.modulus]
    assert _cuh_arrays("kP") == sum((words(m) for m in mods), [])
    assert _cuh_arrays("kN0") == [(-pow(m, -1, 1 << 32)) % (1 << 32)
                                  for m in mods]
    assert _cuh_arrays("kOne") == sum((words((1 << 256) % m) for m in mods),
                                      [])
    assert _cuh_arrays("kOne") == sum(
        (TL.FieldSpec(m).one_mont.tolist() for m in mods), [])
    inv = tw.fq2_inv((9, 1))
    b3 = [9 * c % P * (1 << 256) % P for c in inv]
    assert _cuh_arrays("kB3G2") == words(b3[0]) + words(b3[1])


@pytest.mark.parametrize("fid", range(3), ids=IDS)
def test_safegcd_constants_match(fid):
    """field.cuh's constants of the safegcd inverse: the modulus in 30-bit
    limbs (limb 8 the bits from 240 up), its inverse mod 2^30, and R^3 mod
    p, which takes (x R)^-1 back to Montgomery form."""
    p = sorted(FK._FIELD_ID, key=FK._FIELD_ID.get)[fid]
    limbs = _cuh_arrays("kP30")[9 * fid:9 * fid + 9]
    assert limbs == [(p >> (30 * k)) & (2**30 - 1) for k in range(8)] + [
        p >> 240]
    assert sum(v << (30 * k) for k, v in enumerate(limbs)) == p
    assert _cuh_arrays("kPInv30")[fid] * p % 2**30 == 1
    r3 = pow(1 << 256, 3, p)
    assert _cuh_arrays("kR3")[8 * fid:8 * fid + 8] == [
        (r3 >> (32 * j)) & 0xFFFFFFFF for j in range(8)]


class _Ptx:
    """field.cuh's carry-chain primitives over uint64 arrays that hold
    32-bit words, one lane per element; `cf` is the carry flag (CC.CF). An
    instruction without .cc that would carry out asserts instead."""

    M = np.uint64(0xFFFFFFFF)
    S = np.uint64(32)

    def __init__(self, n):
        self.cf = np.zeros(n, np.uint64)

    def _cc(self, s):
        self.cf = s >> self.S
        return s & self.M

    def _nc(self, s):
        assert not (s >> self.S).any(), "carry lost"
        return s & self.M

    def add_cc(self, a, b):
        return self._cc(a + b)

    def addc_cc(self, a, b):
        return self._cc(a + b + self.cf)

    def addc(self, a, b):
        return self._nc(a + b + self.cf)

    def _borrow(self, a, t):
        self.cf = (a < t).astype(np.uint64)
        return (a - t) & self.M

    def sub_cc(self, a, b):
        return self._borrow(a, b)

    def subc_cc(self, a, b):
        return self._borrow(a, b + self.cf)

    def subc(self, a, b):
        return (a - b - self.cf) & self.M

    def mad_lo_cc(self, a, b, c):
        return self._cc(((a * b) & self.M) + c)

    def madc_lo_cc(self, a, b, c):
        return self._cc(((a * b) & self.M) + c + self.cf)

    def madc_hi_cc(self, a, b, c):
        return self._cc(((a * b) >> self.S) + c + self.cf)

    def madc_hi(self, a, b, c):
        return self._nc(((a * b) >> self.S) + c + self.cf)


def _cuh_mul(x, a, b, p, n0):
    """field.cuh's mul<F>, statement for statement. a, b, p: 8 word arrays
    (p broadcast); returns the 8 words of a * b * 2^-256 mod p."""
    M = _Ptx.M

    def mul_n(acc, a, bi):
        for j in range(0, 8, 2):
            acc[j] = (a[j] * bi) & M
            acc[j + 1] = (a[j] * bi) >> _Ptx.S

    def cmad_n(acc, a, bi):
        acc[0] = x.mad_lo_cc(a[0], bi, acc[0])
        acc[1] = x.madc_hi_cc(a[0], bi, acc[1])
        for j in range(2, 8, 2):
            acc[j] = x.madc_lo_cc(a[j], bi, acc[j])
            acc[j + 1] = x.madc_hi_cc(a[j], bi, acc[j + 1])

    def madc_n_rshift(acc, a, bi):
        zero = np.zeros_like(bi)
        for j in range(0, 6, 2):
            acc[j] = x.madc_lo_cc(a[j], bi, acc[j + 2])
            acc[j + 1] = x.madc_hi_cc(a[j], bi, acc[j + 3])
        acc[6] = x.madc_lo_cc(a[6], bi, zero)
        acc[7] = x.madc_hi(a[6], bi, zero)

    def mad_n_redc(ev, od, bi, first):
        zero = np.zeros_like(bi)
        if first:
            mul_n(od, a[1:], bi)
            mul_n(ev, a, bi)
        else:
            ev[0] = x.add_cc(ev[0], od[1])
            madc_n_rshift(od, a[1:], bi)
            cmad_n(ev, a, bi)
            od[7] = x.addc(od[7], zero)
        m = (ev[0] * n0) & M
        cmad_n(od, p[1:], m)
        assert not x.cf.any(), "carry out of O's top word"
        cmad_n(ev, p, m)
        od[7] = x.addc(od[7], zero)
        assert not ev[0].any()

    ev, od = [None] * 8, [None] * 8
    for i in range(0, 8, 2):
        mad_n_redc(ev, od, b[i], i == 0)
        mad_n_redc(od, ev, b[i + 1], False)
    r = [x.add_cc(ev[0], od[1])]
    r += [x.addc_cc(ev[j], od[j + 1]) for j in range(1, 7)]
    r.append(x.addc(ev[7], np.zeros_like(ev[7])))
    return _cuh_csub(x, r, p)


def _cuh_csub(x, r, p):
    """sub256(d, r, p) and the select `bo ? r : d`."""
    d = [x.sub_cc(r[0], p[0])] + [x.subc_cc(r[j], p[j]) for j in range(1, 8)]
    bo = x.subc(np.zeros_like(r[0]), np.zeros_like(r[0])) != 0
    return [np.where(bo, r[j], d[j]) for j in range(8)]


def _cuh_add_sub(x, a, b, p):
    """field.cuh's add<F> and sub<F> over add256 / sub256."""
    z = np.zeros_like(a[0])
    s = [x.add_cc(a[0], b[0])] + [x.addc_cc(a[j], b[j]) for j in range(1, 8)]
    c = x.addc(z, z) != 0
    d = [x.sub_cc(s[0], p[0])] + [x.subc_cc(s[j], p[j]) for j in range(1, 8)]
    bo = x.subc(z, z) != 0
    add = [np.where(c | ~bo, d[j], s[j]) for j in range(8)]
    d = [x.sub_cc(a[0], b[0])] + [x.subc_cc(a[j], b[j]) for j in range(1, 8)]
    bo = x.subc(z, z) != 0
    t = [x.add_cc(d[0], p[0])] + [x.addc_cc(d[j], p[j]) for j in range(1, 8)]
    x.addc(z, z)
    return add, [np.where(bo, t[j], d[j]) for j in range(8)]


@pytest.mark.parametrize("modulus", [P, R, TL.BLS_FR.modulus], ids=IDS)
def test_cuda_mul_chain_model(modulus):
    """The carry chains of csrc/field.cuh, run flag for flag in numpy: 20,000
    random products and every pair of the edges (0, 1, p - 1, p - 2, one in
    Montgomery form) against a * b * 2^-256 mod p; add and sub against
    (a +- b) mod p. No carry the chains drop is ever set."""
    edges = [0, 1, modulus - 1, modulus - 2, (1 << 256) % modulus]
    av = _values(5, 20_000, modulus) + [e for e in edges for _ in edges]
    bv = _values(6, 20_000, modulus) + [e for _ in edges for e in edges]

    def words(vals):
        return [np.array([(v >> (32 * j)) & 0xFFFFFFFF for v in vals],
                         np.uint64) for j in range(8)]

    def ints(ws):
        return [sum(int(ws[j][i]) << (32 * j) for j in range(8))
                for i in range(len(ws[0]))]

    a, b, p = words(av), words(bv), words([modulus])
    n0 = np.uint64((-pow(modulus, -1, 1 << 32)) % (1 << 32))
    rinv = pow(1 << 256, -1, modulus)
    x = _Ptx(len(av))
    assert ints(_cuh_mul(x, a, b, p, n0)) == [
        u * v * rinv % modulus for u, v in zip(av, bv)]
    add, sub = _cuh_add_sub(x, a, b, p)
    assert ints(add) == [(u + v) % modulus for u, v in zip(av, bv)]
    assert ints(sub) == [(u - v) % modulus for u, v in zip(av, bv)]
