"""The port's multi-card path (zelana_tpu_torch/parallel/sharded.py) on gloo
ranks spawned on the CPU (parallel.distributed.run_local, the kernels'
plain versions), against the JAX package's sharded functions on its
virtual 8-device mesh and its single-device and host functions.

Each world size (2 and 4) is spawned once per module: its ranks run every
case of tests/torch_mesh_ranks.py:sharded_checks and hand the results
back; the JAX side runs in this process meanwhile (the longest first).
Every rank must return the same answer, and it must equal the reference
exactly. The four ranks also prove the dryrun chunk through prove_chunks
(about 100 s a rank on the plain kernels), so the module takes about four
minutes; its ranks get 1,200 s."""

import concurrent.futures as cf
import json
import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as R
from zelana_tpu.curves import g1 as JG1, g2 as JG2
from zelana_tpu.fields.bn254 import R as FR
from zelana_tpu.ops import limbs as JL
from zelana_tpu_torch.parallel import distributed as D

torch.set_num_threads(1)  # many small int64 ops: threads only contend

TILE_G1, TILE_G2 = 64, 16
ROOT = os.path.join(os.path.dirname(__file__), "..")
CUBIC_VECTOR = os.path.join(ROOT, "zelana_tpu_torch", "testdata",
                            "cubic_proof.json")
CHUNK_VECTOR = os.path.join(ROOT, "zelana_tpu_torch", "testdata",
                            "chunk_101_d1_proof.json")
KEY_101 = os.path.join(ROOT, "artifacts", "chunk_101_d1_pk.npz")
# shards of 769 points at world 4 in segments of 256: 256 / 256 / 256 / 1,
# the last shard three short; identity points in later segments of several
# shards (shard 2's one-point segment among them) and at the last point
SEG_N = 4 * 769 - 3
SEG_HOLES = {300, 769 + 600, 2 * 769 + 768, 3 * 769 + 520, SEG_N - 1}


def _cases(world: int, key_path: str) -> dict:
    rng = random.Random(10 + world)
    np_rng = np.random.default_rng(3 + world)
    cases = {
        "ntt": [int(v) for v in np_rng.integers(0, 1 << 62, size=1 << 12)],
        # small shards: the narrow lanes of tests/test_sharded.py's sizes
        "msm_scan_g1": (TILE_G1, 256 * world,
                        [rng.randrange(FR) for _ in range(256 * world)]),
        "msm_scan_g2": (TILE_G2, 64 * world,
                        [rng.randrange(FR) for _ in range(64 * world)]),
        # identity points, and n % world != 0: the last shard padded
        "msm_scan_inf": (TILE_G1, 128 * world - 3,
                         [rng.randrange(FR) for _ in range(128 * world - 3)],
                         sorted(rng.sample(range(128 * world - 3), 9))),
    }
    if world == 4:
        g = JG1.generator()
        cases["mimc"] = ([rng.randrange(FR) for _ in range(16)],
                         [rng.randrange(FR) for _ in range(16)])
        cases["msm"] = ([JG1.mul(g, rng.randrange(1, FR)) for _ in range(16)],
                        [rng.randrange(FR) for _ in range(16)])
        for key, curve, tile in (("segments", "g1", TILE_G1),
                                 ("segments_g2", "g2", TILE_G2)):
            cases[key] = (curve, tile, SEG_N,
                          [rng.randrange(FR) for _ in range(SEG_N)], 256,
                          SEG_HOLES)
        with open(CHUNK_VECTOR) as f:
            cases["chunk"] = (KEY_101, json.load(f)["batch_id"])
    if world == 2:
        cases["prove"] = (key_path, 3, 7)
    return cases


@pytest.fixture(scope="module")
def cubic_key(tmp_path_factory):
    from zelana_tpu.groth16.setup import keygen

    path = tmp_path_factory.mktemp("keys") / "cubic_pk.npz"
    pk = keygen(R.Cubic(3), seed=0)
    pk.save_npz(str(path))
    return pk, str(path)


@pytest.fixture(scope="module")
def cases(cubic_key):
    return {w: _cases(w, cubic_key[1]) for w in (2, 4)}


@pytest.fixture(scope="module")
def runs(cases):
    """Both worlds started at once in the background; each test waits for
    the one it reads."""
    with cf.ThreadPoolExecutor(2) as ex:
        yield {w: ex.submit(D.run_local, R.sharded_checks, w, "gloo", "cpu",
                            (cases[w],), 1200.0)
               for w in (2, 4)}


@pytest.fixture(scope="module")
def segment_refs(cases):
    """The JAX package's host MSM of each segment case (about a minute of
    Python in all, while the ranks run)."""
    out = {}
    for key in ("segments", "segments_g2"):
        curve, tile, n, scalars, _, holes = cases[4][key]
        G = JG1 if curve == "g1" else JG2
        base = [G.mul(G.generator(), j + 1) for j in range(tile)]
        out[key] = G.msm([None if i in holes else base[i % tile]
                          for i in range(n)], scalars)
    return out


def _result(runs, world: int, key: str):
    """The ranks' answers for `key`, which must agree."""
    res = runs[world].result()
    assert len(res) == world
    vals = [r[key] for r in res]
    for v in vals[1:]:
        if isinstance(v, tuple) and isinstance(v[0], np.ndarray):
            assert all(np.array_equal(a, b) for a, b in zip(v, vals[0]))
        else:
            assert v == vals[0]
    return vals[0]


def _ints(words_u32: np.ndarray) -> list:
    from zelana_tpu_torch.ops import limbs as L

    return L.decode_mont(words_u32, L.FR)


def test_msm_scan_segments_match_host(runs, segment_refs):
    """msm_scan on one device over five segments of chunk_n = 256
    (build_segment_schedules; the last 76 points) added up on the host,
    identity points in the second, third and last: the closed form and the
    JAX package's host MSM. It asks for the ranks and the segment cases'
    references first, so they run meanwhile."""
    from zelana_tpu_torch.ops import msm_scan as MSM

    rng = random.Random(5)
    n, holes = 4 * 256 + 76, {300, 700, 4 * 256 + 75}
    scalars = [rng.randrange(FR) for _ in range(n)]
    pts = R.tile_points("g1", TILE_G1)
    prep = MSM.prepare_g1([None if i in holes else pts[i % TILE_G1]
                           for i in range(n)], "cpu")
    digits = MSM.scalar_digits(scalars)
    segs = MSM.build_segment_schedules(digits, chunk_n=256)
    assert [s["hi"] - s["lo"] for s in segs] == [256] * 4 + [76]
    got = MSM.msm_end(MSM.msm_begin_scheds(
        prep, segs, MSM._inf_correction(digits, prep[1])))
    want = _closed_form("g1", TILE_G1, n, [0 if i in holes else x
                                           for i, x in enumerate(scalars)])
    base = [JG1.mul(JG1.generator(), j + 1) for j in range(TILE_G1)]
    assert JG1.msm([None if i in holes else base[i % TILE_G1]
                    for i in range(n)], scalars) == want
    assert got == want


def test_sharded_msm_matches_jax(runs, cases):
    from zelana_tpu.ops import msm as JM
    from zelana_tpu.parallel.sharded import make_mesh, sharded_msm

    pts, scalars = cases[4]["msm"]
    coords, inf = JM.g1_points_to_device(pts)
    jac = sharded_msm(coords, jnp.asarray(JM.scalar_digits(scalars, inf)),
                      make_mesh(4), curve="g1")
    want = JM._jac_to_affine_host(jac, fq2=False)
    assert want == JG1.msm(pts, scalars)
    assert _result(runs, 4, "msm") == want


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_ntt_intt_match_jax(runs, cases, world):
    """The block-sharded transform gathered from every rank equals the JAX
    single-device ntt, and (at world 4) the JAX sharded_ntt on the 8-device
    mesh; its sharded_intt gives the input back."""
    from zelana_tpu.ops import ntt as JNTT
    from zelana_tpu.parallel.sharded import make_mesh, sharded_ntt

    vals = cases[world]["ntt"]
    x = jnp.asarray(JL.encode_mont(vals, JL.FR))
    plan = JNTT.make_plan(len(vals))
    want = JL.decode_mont(np.asarray(JNTT.ntt(x, plan)), JL.FR)
    if world == 4:
        mesh8 = JL.decode_mont(np.asarray(sharded_ntt(x, plan, make_mesh(8))),
                               JL.FR)
        assert mesh8 == want
    fwd, back = _result(runs, world, "ntt")
    assert _ints(fwd) == want
    assert _ints(back) == vals


def test_sharded_mimc_hash2_matches_jax(runs, cases):
    from zelana_tpu.parallel.sharded import make_mesh, sharded_mimc_hash2

    a, b = cases[4]["mimc"]
    want = sharded_mimc_hash2(jnp.asarray(JL.encode_mont(a, JL.FR)),
                              jnp.asarray(JL.encode_mont(b, JL.FR)),
                              make_mesh(8))
    assert _result(runs, 4, "mimc") == JL.decode_mont(np.asarray(want), JL.FR)


def _closed_form(curve, tile, n, scalars):
    G = JG1 if curve == "g1" else JG2
    s = sum(x * (1 + i % tile) for i, x in enumerate(scalars)) % FR
    return G.mul(G.generator(), s)


@pytest.mark.parametrize("world,curve", [(2, "g1"), (4, "g1"), (2, "g2"),
                                         (4, "g2")])
def test_sharded_msm_scan_matches_host(runs, cases, world, curve):
    """P_i = (1 + i mod tile) G: the MSM is one scalar multiple of G
    (tests/test_sharded.py:78-106), and the JAX package's host MSM."""
    G = JG1 if curve == "g1" else JG2
    tile, n, scalars = cases[world][f"msm_scan_{curve}"]
    want = _closed_form(curve, tile, n, scalars)
    base = [G.mul(G.generator(), j + 1) for j in range(tile)]
    assert G.msm([base[i % tile] for i in range(n)], scalars) == want
    assert _result(runs, world, f"msm_scan_{curve}") == want


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_msm_scan_identity_points(runs, cases, world):
    """Nine identity points, which the shards hold as the generator and
    one host correction over the global digits takes out, and a last shard
    padded with zero digits: the closed form over the other points, and
    the JAX package's host MSM."""
    tile, n, scalars, holes = cases[world]["msm_scan_inf"]
    want = _closed_form("g1", tile, n, [0 if i in holes else x
                                        for i, x in enumerate(scalars)])
    base = [JG1.mul(JG1.generator(), j + 1) for j in range(tile)]
    pts = [None if i in holes else base[i % tile] for i in range(n)]
    assert JG1.msm(pts, scalars) == want
    assert _result(runs, world, "msm_scan_inf") == want


def _segments(runs, cases, segment_refs, key: str) -> None:
    curve, tile, n, scalars, _, holes = cases[4][key]
    want = _closed_form(curve, tile, n, [0 if i in holes else x
                                         for i, x in enumerate(scalars)])
    assert segment_refs[key] == want
    assert _result(runs, 4, key + "_shard") == 769
    assert _result(runs, 4, key) == want


def test_msm_begin_sharded_segments(runs, cases, segment_refs):
    """G1 at world 4: shards of 769 points in segments of chunk_n = 256
    (256 / 256 / 256 / 1), added up on each rank before the reduction;
    the last shard three short; identity points in later segments of
    several shards, corrected once over the global digits: the closed form
    and the JAX package's host MSM."""
    _segments(runs, cases, segment_refs, "segments")


def test_msm_begin_sharded_segments_g2(runs, cases, segment_refs):
    """The same segment loop in G2."""
    _segments(runs, cases, segment_refs, "segments_g2")


def test_prove_chunks_through_mesh_matches_vector(runs, cases):
    """Groth16ChunkProver.prove_chunks of the dryrun chunk over four gloo
    ranks (the CPU twin of chip_smoke.py's production chunk over the
    ranks): the same proof bytes on every rank, equal to the JAX package's
    proof of this chunk and batch_id (testdata/chunk_101_d1_proof.json),
    and it verifies."""
    from zelana_tpu_torch.groth16.keys import ProvingKey
    from zelana_tpu_torch.runtime.chunk_prover import Groth16ChunkProver
    from zelana_tpu_torch.runtime.coordinator import ChunkProof

    with open(CHUNK_VECTOR) as f:
        vec = json.load(f)
    got = _result(runs, 4, "chunk")
    assert got.hex() == vec["proof_bytes"]
    prover = Groth16ChunkProver(ProvingKey.load_npz(KEY_101), (1, 0, 1), 1,
                                device="cpu")
    assert prover.verify_chunk(ChunkProof(
        0, got, [int(v) for v in vec["public_inputs"]], 0,
        bytes.fromhex(vec["public_witness"])))


def test_prove_through_mesh_matches_jax(runs, cases, cubic_key):
    """prove(..., mesh=) on two ranks: the same proof bytes on every rank,
    equal to the JAX package's prove of this circuit with this key and
    batch_id (recorded in testdata/cubic_proof.json by
    tools/record_service_vectors.py; the key is remade here and must hash
    as recorded), and it verifies."""
    import hashlib

    from zelana_tpu_torch.groth16.keys import Proof, ProvingKey
    from zelana_tpu_torch.groth16.verify import verify

    pk_jax, path = cubic_key
    with open(CUBIC_VECTOR) as f:
        vec = json.load(f)
    assert hashlib.sha256(pk_jax.serialize_compressed()).hexdigest() == \
        vec["key_sha256"]
    _, x, batch_id = cases[2]["prove"]
    assert (x, batch_id) == (vec["x"], vec["batch_id"])
    got = _result(runs, 2, "prove")
    assert got.hex() == vec["proof"]
    pk = ProvingKey.load_npz(path)
    assert verify(pk.vk, Proof.deserialize_compressed(got),
                  [int(v) for v in vec["public_inputs"]])


def test_ranks_exchange_through_host(runs):
    """gloo ranks count their collectives: bytes sent, calls, seconds."""
    for world in (2, 4):
        for r in runs[world].result():
            assert r["comm"]["calls"] > 0 and r["comm"]["bytes"] > 0
