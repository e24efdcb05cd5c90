"""The port's NTT (zelana_tpu_torch.ops.ntt) and witness map against the JAX
package's ops/ntt and groth16/prove on the CPU: same inputs from a numpy
seed, exact equality."""

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


@pytest.mark.parametrize("log_n", [10, 11, 12, 13])
def test_transforms_match_jax(log_n):
    n = 1 << log_n
    rng = np.random.default_rng(log_n)
    vals = [int.from_bytes(rng.bytes(32), "little") % JL.FR.modulus
            for _ in range(n)]
    vals[:3] = [0, 1, JL.FR.modulus - 1]
    j16 = jnp.asarray(JL.encode_mont(vals, JL.FR))
    x = TL.to_tensor(TL.encode_mont(vals, TL.FR), "cpu")
    jplan, tplan = JN.make_plan(n), TN.make_plan(n)
    for name in TRANSFORMS:
        want = TL.words_from_limbs16(np.asarray(getattr(JN, name)(j16,
                                                                  jplan)))
        got = getattr(TN, name)(x, tplan)
        assert (TL.to_numpy(got) == want).all(), name


def test_plan_tables_match_jax():
    """Running-product tables equal the JAX package's per-element pow."""
    n = 1 << 9
    jp, tp = JN.make_plan(n), TN.make_plan(n)
    assert (tp.bitrev == jp.bitrev).all()
    assert (tp.coset == TL.words_from_limbs16(jp.coset_pows)).all()
    assert (tp.coset_inv == TL.words_from_limbs16(jp.coset_pows_inv)).all()
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
