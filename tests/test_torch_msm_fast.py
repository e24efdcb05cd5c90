"""The tape MSM of the port (zelana_tpu_torch.ops.msm_fast; device="cpu",
the step kernel's plain version) against the JAX package's msm_fast and
the host MSMs: the native tapes equal, the slot pool's bit-subset sums
equal the JAX _run_tape's word for word, MSM results equal as points, and
the tape runs as one `step` launch a step, its mixed prefix mixed."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zelana_tpu.ops import msm as JM
from zelana_tpu.ops import msm_fast as JMF
from zelana_tpu_torch.curves import g1 as G1, g2 as G2
from zelana_tpu_torch.fields.bn254 import R
from zelana_tpu_torch.ops import curve_kernels as CK
from zelana_tpu_torch.ops import limbs as L
from zelana_tpu_torch.ops import msm_fast as MF
from zelana_tpu_torch.ops import msm_scan

torch.set_num_threads(1)  # many small int64 ops: threads only contend


@pytest.mark.parametrize("n,skew", [(24, False), (700, False), (3000, True)])
def test_build_tape_matches_jax(n, skew):
    """Seeded digits (skewed: a third of the points with digit 1 in every
    window, the boolean entries of a witness) through both packages'
    native builders."""
    rng = np.random.default_rng(n)
    digits = rng.integers(0, 256, (32, n)).astype(np.int32)
    if skew:
        digits[:, : n // 3] = 1
    digits[:, 5] = 0
    want = JMF.build_tape(digits)
    got = MF.build_tape(digits)
    assert (got.S, got.a0, got.total_slots, got.mixed_steps, got.n_points) \
        == (want.S, want.a0, want.total_slots, want.mixed_steps,
            want.n_points)
    assert np.array_equal(got.idx, want.idx)
    assert np.array_equal(got.finals, want.finals)


def _g1_inputs():
    """tests/test_msm.py:100-114: 24 points, a zero scalar, an identity
    point, P + (-P)."""
    rng = random.Random(99)
    g = G1.generator()
    points = [G1.mul(g, rng.randrange(1, R)) for _ in range(24)]
    scalars = [rng.randrange(R) for _ in range(24)]
    scalars[3] = 0
    points[5] = None
    points[10] = G1.neg(points[9])
    scalars[10] = scalars[9]
    return points, scalars


def _g2_inputs():
    """tests/test_msm.py:117-123: four G2 points."""
    rng = random.Random(98)
    g = G2.generator()
    return ([G2.mul(g, rng.randrange(1, 10**5)) for _ in range(4)],
            [rng.randrange(R) for _ in range(4)])


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_tape_msm_matches_host(curve, monkeypatch):
    """The MSM equals the host MSM, and the tape ran as one step launch a
    step: tape.mixed_steps mixed, the rest general, all rounds=1."""
    points, scalars = _g1_inputs() if curve == "g1" else _g2_inputs()
    G = G1 if curve == "g1" else G2
    want = G.msm([p for p in points if p is not None],
                 [s for p, s in zip(points, scalars) if p is not None])
    calls, tapes = [], []
    step, build = CK.step, MF.build_tape

    def spy_step(*args, **kw):
        calls.append((kw["mixed"], kw.get("rounds", 1)))
        return step(*args, **kw)

    def spy_build(digits):
        tapes.append(build(digits))
        return tapes[-1]

    monkeypatch.setattr(CK, "step", spy_step)
    monkeypatch.setattr(MF, "build_tape", spy_build)
    msm = MF.msm_g1 if curve == "g1" else MF.msm_g2
    assert msm(points, scalars, device="cpu") == want
    tape, = tapes
    steps = tape.idx.shape[0]
    assert calls == [(True, 1)] * tape.mixed_steps + [(False, 1)] * (
        steps - tape.mixed_steps)
    assert 0 < tape.mixed_steps < steps


def test_tape_finals_match_jax_run_tape():
    """One G1 tape (24 points, the edges above): the port's pool[:, finals]
    equals the JAX _run_tape's XLA path, its (48, 256) 16-bit limbs
    converted to words."""
    points, scalars = _g1_inputs()
    coords, inf = JMF.prepare_g1(points)
    digits = JM.scalar_digits(scalars, inf)
    tape = JMF.build_tape(digits)
    buf, mixed16, hi_mode, gen_steps = JMF._pack_tape(tape)
    want = JMF._run_tape(coords[0], coords[1], jnp.asarray(buf), "g1",
                         tape.S, tape.a0, tape.total_slots, tape.mixed_steps,
                         gen_steps, mixed16, hi_mode)
    pool, inf_t, _ = msm_scan.prepare_g1(points, "cpu")
    assert np.array_equal(inf_t, inf)
    got = MF.run_tape(pool, MF.build_tape(digits), "g1")
    assert np.array_equal(L.to_numpy(got),
                          L.words_from_limbs16(np.asarray(want)))


def test_tape_failures_raise(monkeypatch, tmp_path):
    """No numpy fallback: a refused tape (rc != 0) and a failed g++ build
    of csrc/msm_tape.cpp raise."""
    from zelana_tpu_torch import native
    from zelana_tpu_torch.ops import tape_native

    class Refuses:
        @staticmethod
        def zelana_build_tape(*args):
            return -1

    with monkeypatch.context() as m:
        m.setattr(tape_native, "load", lambda: Refuses)
        with pytest.raises(RuntimeError, match="zelana_build_tape failed"):
            MF.build_tape(np.ones((32, 8), np.int32))

    failed = type("Run", (), {"returncode": 1, "stderr": "no compiler"})
    monkeypatch.setattr(native, "_LIBS", {})
    monkeypatch.setattr(native, "BUILD", str(tmp_path))
    monkeypatch.setattr(native.subprocess, "run", lambda *a, **k: failed)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tape_native.load()
