"""The port's run-scan MSM (zelana_tpu_torch.ops.msm_scan, curve_kernels)
against the JAX package's ops/msm_scan on the CPU: the run-scan emit buffer
against _runscan_xla, pairs_add_plain and the bucket tail (the dense-layer
merge and the bit-subset tree) against proj_add_xla, and whole MSMs on the
inputs of tests/test_msm_scan.py. Exact equality (group points)."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zelana_tpu.curves import g1 as G1
from zelana_tpu.curves import g2 as G2
from zelana_tpu.fields.bn254 import R as FR
from zelana_tpu.ops import msm_scan as JMS
from zelana_tpu.ops import pallas_curve as JPC
from zelana_tpu_torch.ops import curve_kernels as CK
from zelana_tpu_torch.ops import limbs as TL
from zelana_tpu_torch.ops import msm_scan as TMS

torch.set_num_threads(1)  # many small int64 ops: threads only contend


def _multiples(G, n):
    g = G.generator()
    pts, acc = [], g
    for _ in range(n):
        pts.append(acc)
        acc = G.add(acc, g)
    return pts


def _stream(curve, rows, lanes, seed):
    """An affine pool of multiples of G with negations, (rows, lanes) ids
    into it with repeats, and a run-flag plane."""
    rng = np.random.default_rng(seed)
    G = G1 if curve == "g1" else G2
    pts = _multiples(G, 24)
    pts += [G.neg(p) for p in pts[:8]]
    pool = (TMS.prepare_g1 if curve == "g1" else TMS.prepare_g2)(pts, "cpu")[0]
    ids = torch.from_numpy(rng.integers(0, len(pts), (rows, lanes)).astype(
        np.int32))
    flags = (rng.random((rows, lanes)) < 0.3).astype(np.int32)
    flags[-1] = 1
    return pool, ids, torch.from_numpy(flags)


def _jax_runscan(pool, ids, flags, curve, proj_in):
    """_runscan_xla on the stream gathered on the host."""
    rows, lanes = flags.shape
    vals = TL.to_numpy(pool)[:, ids.numpy().reshape(-1)].reshape(-1, rows,
                                                                 lanes)
    out = JMS._runscan_xla(jnp.asarray(vals.transpose(1, 0, 2)),
                           jnp.asarray(flags.numpy()), curve, proj_in=proj_in)
    return np.asarray(out).transpose(1, 0, 2)  # (C, R+1, lanes)


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_runscan_matches_jax(curve):
    pool, ids, flags = _stream(curve, 6, 128, seed=1 if curve == "g1" else 2)
    emit = CK.runscan(pool, ids, flags, curve)
    assert (TL.to_numpy(emit) == _jax_runscan(pool, ids, flags, curve,
                                              False)).all()
    # the projective (level-2) stream: the emitted partials, reshuffled
    C = CK.rows(curve)
    rng = np.random.default_rng(3)
    pool2 = emit.reshape(C, -1)
    ids2 = torch.from_numpy(rng.integers(0, pool2.shape[1], (5, 128)).astype(
        np.int32))
    flags2 = torch.from_numpy((rng.random((5, 128)) < 0.4).astype(np.int32))
    emit2 = CK.runscan(pool2, ids2, flags2, curve, proj_in=True)
    assert (TL.to_numpy(emit2) == _jax_runscan(pool2, ids2, flags2, curve,
                                               True)).all()


def test_runscan_raises_off_cpu_without_cuda():
    """Only an all-CPU call takes the plain version: any operand elsewhere
    goes to the kernel's checks, which want int32 CUDA tensors, and
    raise."""
    pool, ids, flags = _stream("g1", 2, 32, seed=5)
    meta = [t.to("meta") for t in (pool, ids, flags)]
    for args in (meta, (pool, meta[1], flags), (pool, ids, meta[2])):
        with pytest.raises(ValueError):
            CK.runscan(*args, "g1")


def _jax_padd(a: np.ndarray, b: np.ndarray, curve: str) -> np.ndarray:
    """The JAX package's XLA pair add (msm_scan._device_msm's padd off the
    TPU) over (C, n) packed words."""
    ny = 3 if curve == "g1" else 6
    P, Q = (JPC._coords(JPC.kernel_unpack(jnp.asarray(x)), curve, ny)
            for x in (a, b))
    return np.asarray(JPC.kernel_pack(JPC._flat(
        JPC.proj_add_xla(P, Q, curve), curve)))


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_pairs_add_matches_jax(curve):
    emit = CK.runscan(*_stream(curve, 6, 128, seed=4), curve)
    # projective points and identities
    C = CK.rows(curve)
    flat = emit.reshape(C, -1)
    a, b = flat[:, :300].contiguous(), flat[:, 300:600].contiguous()
    ny = 3 if curve == "g1" else 6
    want = _jax_padd(TL.to_numpy(a), TL.to_numpy(b), curve)
    assert (TL.to_numpy(CK.pairs_add_plain(a, b, curve)) == want).all()


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_bucket_tail_plain_matches_jax(curve):
    """bucket_tail_plain on a small segment's level-2 emit against the JAX
    package's tail at the same shape: the dense gather, the K-layer fold
    and the subset tree over proj_add_xla, as in its _device_msm."""
    r = random.Random(61)  # a schedule with K = 2
    n = 96
    G = G1 if curve == "g1" else G2
    pts = _multiples(G, n)
    scalars = [r.randrange(FR) for _ in range(n)]
    scalars[5:40] = [scalars[4]] * 35  # one long bucket run: K >= 2
    d = TMS._upload(TMS.build_schedule(TMS.scalar_digits(scalars), 128, 32),
                    "cpu")
    pool = (TMS.prepare_g1 if curve == "g1" else TMS.prepare_g2)(pts,
                                                                 "cpu")[0]
    C = CK.rows(curve)
    emit = CK.runscan(pool, d["pid"], d["flag"], curve)
    emit2 = CK.runscan(emit.view(C, -1), d["pos2"], d["flag2"], curve,
                       proj_in=True).view(C, -1)
    nb = TMS.SCAN_WINDOWS * TMS.SCAN_BUCKETS
    K = d["dense"].numel() // nb
    assert K >= 2
    got = CK.bucket_tail_plain(emit2, d["dense"], K, curve)
    dense = TL.to_numpy(emit2)[:, d["dense"].numpy()].reshape(C, K, nb)
    merged = dense[:, 0]
    for k in range(1, K):
        merged = _jax_padd(merged, dense[:, k], curve)
    h = TMS.SCAN_BUCKETS // 2
    x = merged[:, np.asarray(JMS._subset_idx())].reshape(C, -1, h)
    while h > 1:
        h //= 2
        x = _jax_padd(x[:, :, :h].reshape(C, -1), x[:, :, h:2 * h].reshape(
            C, -1), curve).reshape(C, -1, h)
    assert (TL.to_numpy(got) == x[:, :, 0]).all()
    assert torch.equal(got, CK.bucket_tail(emit2, d["dense"], K, curve))


def test_msm_g1_matches_jax():
    r = random.Random(7)
    n = 50
    pts = _multiples(G1, n)
    scalars = [r.randrange(FR) for _ in range(n)]
    scalars[3] = 0
    scalars[7] = 255
    scalars[9] = scalars[11]
    assert TMS.msm_g1(pts, scalars, device="cpu") == JMS.msm_g1(pts, scalars)


def test_msm_g1_infinity_points_match_jax():
    r = random.Random(11)
    pts = _multiples(G1, 20)
    pts[4] = None
    pts[5] = None
    scalars = [r.randrange(FR) for _ in range(20)]
    assert TMS.msm_g1(pts, scalars, device="cpu") == JMS.msm_g1(pts, scalars)


def test_msm_equal_scalars_level2_matches_jax():
    n = 96
    pts = _multiples(G1, n)
    scalars = [0x1234567890ABCDEF1234567890ABCDEF] * n
    assert TMS.msm_g1(pts, scalars, device="cpu") == JMS.msm_g1(pts, scalars)


def test_msm_segmented_matches_jax(monkeypatch):
    r = random.Random(17)
    n = 300  # segments 128 / 128 / 44
    pts = _multiples(G1, n)
    pts[10] = None
    scalars = [r.randrange(FR) for _ in range(n)]
    scalars[33] = 0
    for mod in (JMS, TMS):
        monkeypatch.setattr(mod, "CHUNK_N", 128)
        monkeypatch.setattr(mod, "MAX_INFLIGHT", 2)
    assert TMS.msm_g1(pts, scalars, device="cpu") == JMS.msm_g1(pts, scalars)


def test_msm_g2_matches_jax_golden():
    """Against the JAX package's host G2 MSM, the reference its own G2 test
    uses (its device G2 MSM costs a minute of XLA compile on the CPU; the
    G2 kernels meet _runscan_xla and proj_add_xla above)."""
    r = random.Random(13)
    pts = _multiples(G2, 12)
    scalars = [r.randrange(FR) for _ in range(12)]
    assert TMS.msm_g2(pts, scalars, device="cpu") == G2.msm(pts, scalars)


def test_shared_schedules_and_prefix_pool_match_jax():
    """One schedule set serves pools with different infinity masks (the
    Groth16 a/b1/l sharing), and an identity-prefixed pool (the l query)."""
    r = random.Random(21)
    n = 40
    base = _multiples(G1, n)
    pool_a = list(base)
    pool_b = list(base)
    for i in (0, 3, 17, 39):
        pool_a[i] = None
    for i in (1, 3, 20):
        pool_b[i] = None
    pool_l = [None] * 5 + base[:n - 5]
    scalars = [r.randrange(FR) for _ in range(n)]
    digits = TMS.scalar_digits(scalars)
    assert (digits == JMS.scalar_digits(scalars)).all()
    segs = TMS.build_segment_schedules(digits)
    preps = [TMS.prepare_g1(p, "cpu") for p in (pool_a, pool_b, pool_l)]
    got = TMS.msm_end_many([
        TMS.msm_begin_scheds(p, segs, TMS._inf_correction(digits, p[1]))
        for p in preps])
    jsegs = JMS.build_segment_schedules(JMS.scalar_digits(scalars))
    jpreps = [JMS.prepare_g1(p) for p in (pool_a, pool_b, pool_l)]
    want = JMS.msm_end_many([
        JMS.msm_begin_scheds(p, jsegs, JMS._inf_correction(digits, p[1]))
        for p in jpreps])
    assert got == want
    assert got[2] == G1.msm(base[:n - 5], scalars[5:])
    assert all(s["dev"] is not None for s in segs)
