"""The port's NTT (zelana_tpu_torch.ops.ntt) and witness map against the JAX
package's ops/ntt and groth16/prove on the CPU: same inputs from a numpy
seed, exact equality. On the CPU the transforms run the pass kernel's plain
version (ntt_pass_plain), one pass of every stage or the passes of a forced
split; tests/test_torch_cuda_emulation.py holds the kernel against it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zelana_tpu.groth16 import prove as JP
from zelana_tpu.ops import limbs as JL
from zelana_tpu.ops import ntt as JN
from zelana_tpu.r1cs.system import ConstraintSystem as JCS
from zelana_tpu_torch.groth16 import prove as TP
from zelana_tpu_torch.ops import limbs as TL
from zelana_tpu_torch.ops import ntt as TN
from zelana_tpu_torch.r1cs.system import ConstraintSystem as TCS

torch.set_num_threads(1)  # many small int64 ops: threads only contend

TRANSFORMS = ["ntt", "intt", "coset_ntt", "coset_intt"]


def _inputs(log_n: int):
    """(JAX limbs, port words) of 2^log_n seeded values, 0, 1 and p - 1
    first."""
    n = 1 << log_n
    rng = np.random.default_rng(log_n)
    vals = [int.from_bytes(rng.bytes(32), "little") % JL.FR.modulus
            for _ in range(n)]
    vals[:3] = [0, 1, JL.FR.modulus - 1]
    j16 = jnp.asarray(JL.encode_mont(vals, JL.FR))
    return j16, TL.to_tensor(TL.encode_mont(vals, TL.FR), "cpu")


def _jax_transforms(log_n: int, j16) -> dict:
    jplan = JN.make_plan(1 << log_n)
    return {name: TL.words_from_limbs16(np.asarray(getattr(JN, name)(
        j16, jplan))) for name in TRANSFORMS}


@pytest.mark.parametrize("log_n", [10, 11, 12, 13])
def test_transforms_match_jax(log_n):
    j16, x = _inputs(log_n)
    tplan = TN.make_plan(1 << log_n)
    want = _jax_transforms(log_n, j16)
    for name in TRANSFORMS:
        got = getattr(TN, name)(x, tplan)
        assert (TL.to_numpy(got) == want[name]).all(), name


@pytest.mark.parametrize("log_n,split", [
    (10, [10]), (10, [5, 5]), (10, [4, 3, 3]), (10, [1, 9]),
    (10, None), (11, None), (12, None), (13, None)])
def test_split_transforms_match_jax(log_n, split):
    """The passes of a forced split (None: the card's own, default_split),
    each by ntt_pass_plain, give the JAX transforms exactly and leave the
    input unchanged."""
    j16, x = _inputs(log_n)
    before = x.clone()
    tplan = TN.make_plan(1 << log_n)
    split = split or TN.default_split(log_n)
    assert sum(split) == log_n and max(split) <= TN.TILE_BITS
    want = _jax_transforms(log_n, j16)
    for name in TRANSFORMS:
        got = TN.transform_split(name, [x], tplan, split)
        assert (TL.to_numpy(got) == want[name]).all(), (name, split)
    assert torch.equal(x, before)


def test_default_split():
    """Passes of at least 4 stages, tiles small enough for 32 blocks a pass
    and at most 2^11 elements, the longer passes first; every pass fits a
    tile (the launcher's refusal of one that does not is
    test_torch_cuda_emulation.py's)."""
    assert TN.default_split(1) == [1] and TN.default_split(4) == [4]
    assert TN.default_split(11) == [4, 4, 3]
    assert TN.default_split(13) == [5, 4, 4]
    assert TN.default_split(16) == [8, 8]
    assert TN.default_split(21) == [7, 7, 7]
    assert TN.default_split(22) == [8, 7, 7]
    for log_n in range(1, 25):
        split = TN.default_split(log_n)
        assert max(split) <= TN.TILE_BITS
        assert TN._passes(log_n, split)[-1][1] == log_n
    assert TN._passes(13, [5, 4, 4]) == [(0, 5), (5, 9), (9, 13)]
    with pytest.raises(ValueError):
        TN._passes(13, [7, 5])  # does not cover 13 stages


def test_plan_tables_match_jax():
    """Running-product tables equal the JAX package's per-element pow (1/n
    g^-j its g^-j times its 1/n); the plain gather's permutation equals its
    bit reversal."""
    n = 1 << 9
    jp, tp = JN.make_plan(n), TN.make_plan(n)
    assert (TN._bitrev(n, "cpu").numpy() == jp.bitrev).all()
    assert (tp.coset == TL.words_from_limbs16(jp.coset_pows)).all()
    coset_inv = TL.decode_mont(TL.words_from_limbs16(jp.coset_pows_inv),
                               TL.FR)
    n_inv = TL.decode_mont(TL.words_from_limbs16(jp.n_inv_mont[:, None]),
                           TL.FR)[0]
    assert (tp.coset_inv_n == TL.encode_mont(
        [c * n_inv % JL.FR.modulus for c in coset_inv], TL.FR)).all()
    assert (tp.n_inv == TL.words_from_limbs16(jp.n_inv_mont)).all()
    for s, (fw, inv) in enumerate(zip(jp.stage_twiddles,
                                      jp.stage_twiddles_inv)):
        stride = n >> (s + 1)
        half = 1 << s
        assert (tp.twiddles[:, ::stride][:, :half]
                == TL.words_from_limbs16(fw)).all()
        assert (tp.twiddles_inv[:, ::stride][:, :half]
                == TL.words_from_limbs16(inv)).all()


def _chain(cs_cls, depth: int, x: int):
    """x^(2^depth) by repeated squaring, out public: `depth` constraints."""
    cs = cs_cls()
    v = x
    for _ in range(depth):
        v = v * v % JL.FR.modulus
    out = cs.new_input(v)
    w = cs.new_witness(x)
    for _ in range(depth):
        w = w * w
    w.enforce_equal(out)
    return cs


def test_witness_map_matches_jax():
    for cs_cls in (JCS, TCS):
        cs = _chain(cs_cls, 700, 3)
        assert cs.is_satisfied() is None
    jcs, tcs = _chain(JCS, 700, 3), _chain(TCS, 700, 3)
    jh, jm = JP.witness_map_dispatch(*jcs.matrices(), jcs.full_assignment(),
                                     jcs.num_instance)
    th, tm = TP.witness_map_dispatch(*tcs.matrices(), tcs.full_assignment(),
                                     tcs.num_instance, device="cpu")
    assert tm == jm == 1024
    assert TP.witness_map_collect(th, tm) == JP.witness_map_collect(jh, jm)


def test_witness_map_matches_jax_2_13():
    """The fused chain (three iNTTs, three coset NTTs, the quotient's coset
    iNTT) at a 2^13 domain, the L2 prove's, against the JAX witness map;
    the three inputs come back unchanged."""
    jcs, tcs = _chain(JCS, 4200, 5), _chain(TCS, 4200, 5)
    jh, jm = JP.witness_map_dispatch(*jcs.matrices(), jcs.full_assignment(),
                                     jcs.num_instance)
    A, B, C = tcs.matrices()
    z, ni = tcs.full_assignment(), tcs.num_instance
    th, tm = TP.witness_map_dispatch(A, B, C, z, ni, device="cpu")
    assert tm == jm == 1 << 13
    assert TP.witness_map_collect(th, tm) == JP.witness_map_collect(jh, jm)
    plan = TN.make_plan(tm)
    evals = [TL.to_tensor(TL.encode_mont(TP.matrix_vector_evals(
        M, z, plan.domain, M is A, ni), TL.FR), "cpu") for M in (A, B, C)]
    before = [e.clone() for e in evals]
    assert torch.equal(TP.witness_map(evals, plan), th)
    assert all(torch.equal(e, b) for e, b in zip(evals, before))
