"""The Jacobian point ops and windowed MSM of the port
(zelana_tpu_torch.ops.curve_ops, ops/msm.py; device="cpu", the kernels'
plain versions) against the JAX package's curve_ops, the host MSMs and
the JAX MSM's recorded words. Equality is exact: coordinates word for
word, MSM results as points and as words."""

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zelana_tpu.ops import curve_ops as JC
from zelana_tpu_torch.curves import g1 as G1, g2 as G2
from zelana_tpu_torch.fields.bn254 import P, R
from zelana_tpu_torch.ops import curve_kernels as CK
from zelana_tpu_torch.ops import curve_ops as CO
from zelana_tpu_torch.ops import limbs as L
from zelana_tpu_torch.ops import msm as M

torch.set_num_threads(1)  # many small int64 ops: threads only contend

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(ROOT, "zelana_tpu_torch", "testdata")
sys.path.insert(0, os.path.join(ROOT, "tools"))
from record_service_vectors import jac_msm_inputs  # noqa: E402


def _jacobian_points(curve: str, n: int, rng) -> torch.Tensor:
    """(C, n) words of random curve points in Jacobian coordinates
    (X l^2, Y l^3, l) for random l."""
    G = G1 if curve == "g1" else G2
    pts = [G.mul(G.generator(), int(k))
           for k in rng.integers(1, 1 << 62, n)]
    if curve == "g1":
        coords = [[p[0] for p in pts], [p[1] for p in pts], [1] * n]
    else:
        coords = [[p[i][j] for p in pts] for i in range(2) for j in range(2)]
        coords += [[1] * n, [0] * n]
    words = L.to_tensor(np.concatenate([L.encode_mont(c, L.FQ)
                                        for c in coords]), "cpu")
    F = CO.ops(curve)
    X, Y, Z = CO.split(words, curve)
    lam = CO.split(_rand_words(rng, CK.rows(curve), n), curve)[0]
    lam2 = F.mul(lam, lam)
    return CO.join((F.mul(X, lam2), F.mul(F.mul(Y, lam2), lam),
                    F.mul(Z, lam)), curve)


def _rand_words(rng, C: int, n: int) -> torch.Tensor:
    vals = [int.from_bytes(rng.bytes(32), "little") % P
            for _ in range(C // 8 * n)]
    return L.to_tensor(np.concatenate(
        [L.encode_mont(vals[k * n:(k + 1) * n], L.FQ)
         for k in range(C // 8)]), "cpu")


def _to_jax(words: torch.Tensor, curve: str):
    limbs = L.limbs16_from_words(L.to_numpy(words))
    c = [jnp.asarray(limbs[16 * i:16 * (i + 1)])
         for i in range(limbs.shape[0] // 16)]
    if curve == "g1":
        return tuple(c)
    return tuple((c[2 * i], c[2 * i + 1]) for i in range(3))


def _from_jax(p, curve: str) -> np.ndarray:
    flat = p if curve == "g1" else [x for pair in p for x in pair]
    return np.concatenate([L.words_from_limbs16(np.asarray(x))
                           for x in flat])


@pytest.mark.parametrize("curve,op", [("g1", "add"), ("g1", "double"),
                                      ("g2", "add"), ("g2", "double")])
def test_point_ops_match_jax(curve, op):
    """16 random points a side, two of each mask case of point_add
    (CO.MASK_CASES: infinity on either side or both, P = Q and P = -Q, each
    in the same and in other coordinates); point_double on the same p,
    infinity included."""
    rng = np.random.default_rng(7 + (curve == "g2"))
    n = 2 * len(CO.MASK_CASES)
    C = CK.rows(curve)
    p, q = CO.seed_mask_cases(_jacobian_points(curve, n, rng),
                              _jacobian_points(curve, n, rng),
                              _rand_words(rng, C, n)[:C // 3], curve)
    JF = JC.FqOps if curve == "g1" else JC.Fq2Ops
    if op == "add":
        got = CO.jac_add(p, q, curve)
        want = JC.point_add(JF, _to_jax(p, curve), _to_jax(q, curve))
    else:
        got = CO.jac_double_plain(p, curve)
        want = JC.point_double(JF, _to_jax(p, curve))
    assert np.array_equal(L.to_numpy(got), _from_jax(want, curve))
    # and through the plain formulas on coordinate triples
    F = CO.ops(curve)
    P_, Q_ = CO.split(p, curve), CO.split(q, curve)
    plain = (CO.point_add(F, P_, Q_) if op == "add"
             else CO.point_double(F, P_))
    assert torch.equal(CO.join(plain, curve), got)


def test_jac_double_count_and_addend():
    """jac_double_plain(p, count, addend) = count point_doubles, then
    point_add (the Horner step's plain version); count 0 is a plain add."""
    rng = np.random.default_rng(3)
    p = _jacobian_points("g1", 4, rng)
    q = _jacobian_points("g1", 4, rng)
    want = p
    for _ in range(3):
        want = CO.jac_double_plain(want, "g1")
    assert torch.equal(CO.jac_double_plain(p, "g1", 3, q),
                       CO.jac_add(want, q, "g1"))
    assert torch.equal(CO.jac_double_plain(p, "g1", 0, q),
                       CO.jac_add(p, q, "g1"))
    with pytest.raises(ValueError):
        CO.jac_double_plain(p, "g1", -1)


def _g1_edges():
    """tests/test_msm.py:100-114's inputs: 24 points with a zero scalar,
    an identity point and P + (-P)."""
    return jac_msm_inputs(G1, G2, R)["g1_edges"]


def _g1_single():
    return jac_msm_inputs(G1, G2, R)["g1_single"]


def _g2_small():
    return jac_msm_inputs(G1, G2, R)["g2_small"]


@pytest.mark.parametrize("inputs", [_g1_edges, _g1_single, _g2_small])
def test_jacobian_msm_matches_host(inputs, monkeypatch):
    """ops/msm.py on the inputs of tests/test_msm.py:81-135 (each padded
    to 16 or 32 points) against the host MSM, and its (C, 1) Jacobian
    words, from the same run, against the JAX _msm's on those inputs
    (testdata/jac_msm_words.json, tools/record_service_vectors.py
    jac_msm)."""
    points, scalars = inputs()
    curve = "g2" if isinstance(points[0][0], tuple) else "g1"
    G = G1 if curve == "g1" else G2
    want = G.msm([p for p in points if p is not None],
                 [s for p, s in zip(points, scalars) if p is not None])
    words = []
    run = M._msm
    monkeypatch.setattr(M, "_msm", lambda *a: words.append(run(*a))
                        or words[-1])
    msm = M.msm_g1 if curve == "g1" else M.msm_g2
    assert msm(points, scalars, device="cpu") == want
    with open(os.path.join(TESTDATA, "jac_msm_words.json")) as f:
        vec = json.load(f)[inputs.__name__[1:]]
    assert L.to_numpy(words[0]).reshape(-1).tolist() == vec
