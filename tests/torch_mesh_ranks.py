"""What each rank runs in tests/test_torch_sharded.py and
test_torch_distributed.py: module-level functions (a spawned rank imports
them by name) of the port alone, no JAX. Each runs every check of one world
size on the plain versions (device "cpu", gloo) and returns plain Python
and numpy results for the parent to compare with the JAX package."""

import numpy as np
import torch
import torch.distributed as dist


def tile_points(curve: str, tile: int) -> list:
    """P_j = (j + 1) G for j < tile, as host points."""
    from zelana_tpu_torch.curves import g1 as G1, g2 as G2

    G = G1 if curve == "g1" else G2
    out, acc = [], G.generator()
    for _ in range(tile):
        out.append(acc)
        acc = G.add(acc, G.generator())
    return out


class Cubic:
    """x^3 + x + 5 == out (tests/test_torch_prove.py's circuit)."""

    def __init__(self, x):
        self.x = x

    def generate_constraints(self, cs):
        out = cs.new_input(self.x ** 3 + self.x + 5)
        x = cs.new_witness(self.x)
        ((x * x) * x + x + cs.constant(5)).enforce_equal(out)


def dryrun_chunk():
    """The (1,0,1) depth-1 dryrun chunk of
    zelana_tpu_torch/testdata/chunk_101_d1_proof.json: a transfer and a
    full shielded spend (tests/test_torch_chunk.py's _dryrun_chunks)."""
    from zelana_tpu_torch.runtime.chunk_witness import ChunkWitnessBuilder
    from zelana_tpu_torch.runtime.coordinator import Dispatcher

    b = ChunkWitnessBuilder(1)
    b.fund(1, 100)  # depth-1 SMT: positions pk & 1
    b.fund(2, 0)
    note = b.add_note(spending_key=777, value=9, blinding=42)
    return Dispatcher.build_chunks_with_witness(
        b, [(1, 2, 10)], [], [("full", note, 777, 0xFACE, 9, 7)],
        capacity=(1, 0, 1), pre_shielded_root=b.shielded_root())[0]


def _words(vals):
    from zelana_tpu_torch.ops import limbs as L

    return L.to_tensor(L.encode_mont(vals, L.FR), "cpu")


def sharded_checks(mesh, cases: dict) -> dict:
    """Every sharded case of `cases` on this rank; results by name."""
    from zelana_tpu_torch.ops import limbs as L
    from zelana_tpu_torch.ops import msm as MJ
    from zelana_tpu_torch.ops import msm_scan as MSM
    from zelana_tpu_torch.ops import ntt as NTT
    from zelana_tpu_torch.parallel import comm
    from zelana_tpu_torch.parallel import sharded as SH

    torch.set_num_threads(1)
    out = {}
    if "mimc" in cases:
        a, b = cases["mimc"]
        got = SH.sharded_mimc_hash2(_words(a), _words(b), mesh)
        out["mimc"] = L.decode_mont(L.to_numpy(got), L.FR)
    if "ntt" in cases:
        vals = cases["ntt"]
        x = _words(vals)
        plan = NTT.make_plan(len(vals))
        fwd = comm.all_gather_tiled(SH.sharded_ntt(x, plan, mesh), mesh)
        back = comm.all_gather_tiled(SH.sharded_intt(fwd, plan, mesh), mesh)
        out["ntt"] = (L.to_numpy(fwd), L.to_numpy(back))
    if "msm" in cases:
        pts, scalars = cases["msm"]
        pool, inf, _ = MSM.prepare_g1(pts, "cpu")
        jac = SH.sharded_msm(pool, MSM.scalar_digits(scalars, inf), mesh)
        out["msm"] = MJ._jac_to_affine_host(jac, "g1")
    for curve in ("g1", "g2"):
        key = f"msm_scan_{curve}"
        if key in cases:
            tile, n, scalars = cases[key]
            pts = tile_points(curve, tile)
            out[key] = SH.sharded_msm_scan([pts[i % tile] for i in range(n)],
                                           scalars, mesh, curve)
    if "msm_scan_inf" in cases:
        tile, n, scalars, holes = cases["msm_scan_inf"]
        pts = tile_points("g1", tile)
        out["msm_scan_inf"] = SH.sharded_msm_scan(
            [None if i in holes else pts[i % tile] for i in range(n)],
            scalars, mesh)
    for key in ("segments", "segments_g2"):
        if key in cases:
            curve, tile, n, scalars, chunk_n, holes = cases[key]
            pts = tile_points(curve, tile)
            prep = SH._prepare_sharded(
                [None if i in holes else pts[i % tile] for i in range(n)],
                mesh, curve)
            out[key] = MSM.msm_end(SH.msm_begin_sharded(
                prep, scalars, mesh, chunk_n=chunk_n))
            out[key + "_shard"] = prep.shard
    if "prove" in cases:
        from zelana_tpu_torch.groth16.keys import ProvingKey
        from zelana_tpu_torch.groth16.prove import prove

        path, x, batch_id = cases["prove"]
        pk = ProvingKey.load_npz(path)
        proof = prove(pk, Cubic(x), batch_id=batch_id, device="cpu",
                      mesh=mesh)
        out["prove"] = proof.serialize_compressed()
    if "chunk" in cases:
        from zelana_tpu_torch.groth16.keys import ProvingKey
        from zelana_tpu_torch.runtime.chunk_prover import Groth16ChunkProver

        path, batch_id = cases["chunk"]
        prover = Groth16ChunkProver(ProvingKey.load_npz(path), (1, 0, 1), 1,
                                    device="cpu", mesh=mesh)
        out["chunk"] = prover.prove_chunks([dryrun_chunk()],
                                           batch_id)[0].proof_bytes
    out["comm"] = dict(mesh.comm)
    return out


def distributed_checks(mesh, n_cases) -> dict:
    """The group itself: an all_reduce over global_mesh, the mesh's place,
    and host_point_slice under the group."""
    from zelana_tpu_torch.parallel import distributed as D

    torch.set_num_threads(1)
    g = D.global_mesh("cpu")
    x = torch.tensor([float(g.rank + 1)])
    dist.all_reduce(x, group=g.group)
    return {
        "all_reduce": float(x[0]), "size": g.size, "rank": g.rank,
        "device": str(g.device), "backend": g.backend,
        "slices": [D.host_point_slice(n) for n in n_cases],
        "placement": D.placement("cpu")[1] is not None,
    }


def failing_rank(mesh) -> None:
    """Rank 1 raises: run_local must re-raise it in the parent."""
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return np.zeros(1)
