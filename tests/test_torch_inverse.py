"""The port's batch inversion (zelana_tpu_torch.ops.limbs.mont_batch_inv_nested
and the plain inv_fwd / inv_bwd / inv_base of ops.field_kernels) against the
JAX package and against Python integers on the CPU: inputs from a numpy
seed, tolerance bit-equal (field elements; every word must match)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zelana_tpu.ops import limbs as JL
from zelana_tpu_torch.fields.bn254 import P, R
from zelana_tpu_torch.ops import field_kernels as FK
from zelana_tpu_torch.ops import limbs as TL

torch.set_num_threads(1)  # many small int64 ops: threads only contend

SPECS = {"Fq": TL.FQ, "Fr": TL.FR, "BLS12-381 Fr": TL.BLS_FR}


def _values(seed: int, n: int, modulus: int, zeros=()) -> list:
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % modulus
            for _ in range(n)]
    for z in zeros:
        vals[z] = 0
    return vals


def _zeros(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    return [0, n - 1, *rng.integers(1, n - 1, size=5).tolist()]


def _inverses(vals, p) -> list:
    return [pow(v, p - 2, p) for v in vals]


@pytest.mark.parametrize("n", [1024, 8192])
def test_batch_inv_matches_jax(n):
    vals = _values(n, n, R, _zeros(n + 1, n))
    j16 = JL.encode_mont(vals, JL.FR)
    want = np.asarray(JL.mont_batch_inv_nested(jnp.asarray(j16), JL.FR))
    got = TL.mont_batch_inv_nested(
        TL.to_tensor(TL.words_from_limbs16(j16), "cpu"), TL.FR)
    assert (TL.to_numpy(got) == TL.words_from_limbs16(want)).all()


def test_zeros_match_jax():
    """The plain recursion (field_kernels.batch_inv, plain inv_fwd /
    inv_bwd counting a zero as one) at 20,480 (a whole tile and a partial
    one of four) on inputs with zeros, the first and the last element and
    a whole chain among them, against the JAX mont_batch_inv_nested; and
    each piece against the same piece on the input with its zeros swapped
    for one, zero where a is zero."""
    n = 20480
    zeros = _zeros(n + 3, n) + list(range(5, FK.INV_TILE, FK.INV_BLOCK))
    vals = _values(n + 5, n, R, zeros)
    j16 = JL.encode_mont(vals, JL.FR)
    want = np.asarray(JL.mont_batch_inv_nested(jnp.asarray(j16), JL.FR))
    a = TL.to_tensor(TL.words_from_limbs16(j16), "cpu")
    got = FK.batch_inv(a, TL.FR, plain=True)
    assert (TL.to_numpy(got) == TL.words_from_limbs16(want)).all()

    zero = TL.is_zero(a)
    safe = TL.select(zero, TL.broadcast(TL.FR.one_mont, n, "cpu"), a)
    prefix, totals = FK.inv_fwd_plain(a, TL.FR)
    want_pre, want_tot = FK.inv_fwd_plain(safe, TL.FR)
    assert torch.equal(prefix, want_pre) and torch.equal(totals, want_tot)
    tinv = FK.inv_base_plain(totals, TL.FR)
    out = FK.inv_bwd_plain(a, prefix, tinv, TL.FR)
    want_out = FK.inv_bwd_plain(safe, prefix, tinv, TL.FR)
    assert torch.equal(out, TL.select(zero, torch.zeros_like(out),
                                      want_out))


@pytest.mark.parametrize("n,field", [(20480, "Fr"), (1000, "Fq"),
                                     (1000, "BLS12-381 Fr")])
def test_batch_inv_matches_pow(n, field):
    """n = 20,480 has a partial last tile of 4,096 (the TPU path's weak
    spot); n = 1,000 is padded to one block of 1,024."""
    spec = SPECS[field]
    vals = _values(n + 7, n, spec.modulus, _zeros(n, n))
    got = TL.mont_batch_inv_nested(
        TL.to_tensor(TL.encode_mont(vals, spec), "cpu"), spec)
    assert TL.decode_mont(TL.to_numpy(got), spec) == _inverses(
        vals, spec.modulus)
    assert TL.mont_batch_inv is TL.mont_batch_inv_logdepth is \
        TL.mont_batch_inv_nested


def _chain_model(vals, p):
    """Python-int model of the chain layout: chain c of tile t holds
    elements 16384 t + 1024 i + c; -> (exclusive prefixes, totals)."""
    n = len(vals)
    prefix = [0] * n
    totals = []
    for t in range(-(-n // FK.INV_TILE)):
        length = min(FK.INV_T, (n - t * FK.INV_TILE) // FK.INV_BLOCK)
        for c in range(FK.INV_BLOCK):
            acc = 1
            for i in range(length):
                idx = t * FK.INV_TILE + i * FK.INV_BLOCK + c
                prefix[idx] = acc
                acc = acc * vals[idx] % p
            totals.append(acc)
    return prefix, totals


@pytest.mark.parametrize("n", [3072, 19456])
def test_chain_pieces_match_int_model(n):
    """inv_fwd, inv_bwd and inv_base, plain, on one tile of three-long chains
    and on a whole tile plus a partial one of three."""
    spec = TL.FR
    vals = _values(n, n, R)
    a = TL.to_tensor(TL.encode_mont(vals, spec), "cpu")
    prefix, totals = FK.inv_fwd(a, spec)
    want_pre, want_tot = _chain_model(vals, R)
    assert TL.decode_mont(TL.to_numpy(prefix), spec) == want_pre
    assert TL.decode_mont(TL.to_numpy(totals), spec) == want_tot
    assert totals.shape[1] == FK.inv_chains(n)
    tinv = FK.inv_base(totals, spec)
    assert TL.decode_mont(TL.to_numpy(tinv), spec) == _inverses(want_tot, R)
    out = FK.inv_bwd(a, prefix, tinv, spec)
    assert TL.decode_mont(TL.to_numpy(out), spec) == _inverses(vals, R)
    with pytest.raises(ValueError):
        FK.inv_fwd(a[:, :1000].contiguous(), spec)


def test_mont_inv_and_edges():
    vals = [0, 1, P - 1, 2, 12345]
    a = TL.to_tensor(TL.encode_mont(vals, TL.FQ), "cpu")
    assert TL.decode_mont(TL.to_numpy(TL.mont_inv(a, TL.FQ)), TL.FQ) == \
        _inverses(vals, P)
    assert TL.decode_mont(TL.to_numpy(
        TL.mont_batch_inv_nested(a, TL.FQ)), TL.FQ) == _inverses(vals, P)
    assert TL.decode_mont(TL.FQ.one_mont.reshape(8, 1), TL.FQ) == [1]
    assert TL.is_zero(a).tolist() == [True] + [False] * 4


def test_mont_inv_bls12_381_edges():
    """limbs.mont_inv over BLS12-381 Fr (the privacy SDK's Poseidon field)
    at 0, 1, 2, p - 1, R mod p and R^2 mod p, against Python integers."""
    spec = TL.BLS_FR
    p = spec.modulus
    vals = [0, 1, 2, p - 1, (1 << 256) % p, (1 << 512) % p]
    a = TL.to_tensor(TL.encode_mont(vals, spec), "cpu")
    assert TL.decode_mont(TL.to_numpy(TL.mont_inv(a, spec)), spec) == \
        _inverses(vals, p)


@pytest.mark.skipif(
    not os.environ.get("ZELANA_SLOW_TESTS"),
    reason="the three TPU kernels in interpret mode at n = 2,048 (~100 s)")
def test_chain_pieces_match_jax_kernels():
    from zelana_tpu.ops.pallas_field import (_fermat_call, _inv_bwd_call,
                                             _inv_fwd_call)

    n = 2048
    vals = _values(5, n, R)
    j16 = JL.encode_mont(vals, JL.FR)
    a = TL.to_tensor(TL.words_from_limbs16(j16), "cpu")
    jpre, jtot = _inv_fwd_call(R, n, True)(
        jnp.asarray(j16).reshape(JL.NLIMBS, n // 128, 128))
    prefix, totals = FK.inv_fwd(a, TL.FR)
    for j, t in ((jpre, prefix), (jtot, totals)):
        want = TL.words_from_limbs16(np.asarray(j).reshape(JL.NLIMBS, -1))
        assert (TL.to_numpy(t) == want).all()
    call, bits = _fermat_call(R, True)
    jtinv = call(jnp.asarray(bits), jtot)
    tinv = FK.inv_base(totals, TL.FR)
    assert (TL.to_numpy(tinv) == TL.words_from_limbs16(
        np.asarray(jtinv).reshape(JL.NLIMBS, -1))).all()
    jout = _inv_bwd_call(R, n, True)(
        jnp.asarray(j16).reshape(JL.NLIMBS, n // 128, 128), jpre, jtinv)
    out = FK.inv_bwd(a, prefix, tinv, TL.FR)
    assert (TL.to_numpy(out) == TL.words_from_limbs16(
        np.asarray(jout).reshape(JL.NLIMBS, -1))).all()
