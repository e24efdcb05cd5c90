"""Groth16 prover on the card (PyTorch + the port's CUDA kernels).

Same pipeline and the same bytes as the JAX package's groth16/prove.py:

  1. synthesize the circuit -> matrices + full assignment z (host)
  2. witness map: A.z, B.z, C.z over the domain, iNTT to coefficients,
     coset NTT, (A.z * B.z - C.z) / Z on the coset, coset iNTT -> h(x)
     coefficients: 7 transforms of P passes each, the scalings and the
     quotient folded into their first and last passes  [ntt_pass kernel]
  3. five run-scan MSMs over the proving-key queries: a, b1, l, h in G1 and
     b2 in G2                           [runscan + bucket_tail kernels]
  4. assembly A = alpha + <a,z> + r*delta, B = beta + <b,z> + s*delta,
     C = <l,w> + <h_query,h> + s*A + r*B - rs*delta        (host, tiny)

r and s come from StdRng seeded by batch_id (stdrng.py), so a proof is
deterministic in batch_id and equals the JAX package's byte for byte.

Every entry point takes `device`, "cuda" by default; with no card it raises
unless the caller asks for "cpu", where the kernels' plain versions run.

Several cards (the mesh path): `prove`, `prove_many` and
`prove_synthesized` take `mesh`, a parallel.distributed.Mesh; with none
given they use the initialized default process group when it has more
than one rank. Every rank runs the witness map itself (replicated), the
five MSMs run sharded over the mesh (parallel/sharded.py, h last), and
every rank assembles and returns the same proof, byte-equal to the
one-device proof.
"""

from __future__ import annotations

import concurrent.futures as _cf
import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..curves import g1 as G1, g2 as G2
from ..device import resolve
from ..fields.bn254 import R as FR
from ..ops import limbs as L
from ..ops import msm_scan as MSM
from ..ops import ntt as NTT
from ..ops import staging
from ..parallel import distributed as D
from ..poly.domain import Domain
from ..trace import carry, span
from .keys import Proof, ProvingKey, prepare_queries
from .qap import matrix_vector_evals
from .stdrng import StdRng, rand_fp


def witness_map(evals, plan: NTT.NttPlan, plain: bool = False):
    """The device chain of the witness map: evals = [A.z, B.z, C.z] as
    (8, n) Montgomery words on one device -> (8, n) words of h(x). Three
    iNTTs (1/n in their last pass), three coset NTTs (g^j in their first),
    then the coset iNTT whose first pass forms (a b - c) / Z and whose last
    scales by 1/n g^-j: 7 P launches of the pass kernel on the card (P
    passes a transform, ntt.default_split) and no other device op but the
    outputs' allocation. The inputs are not written."""
    coeffs = [NTT.intt(x, plan, plain) for x in evals]
    cosets = [NTT.coset_ntt(x, plan, plain) for x in coeffs]
    return NTT.quotient_intt(*cosets, plan, plain)


def witness_map_dispatch(A, B, C, z, num_instance, device="cuda"):
    """Start the h(x) computation on `device` (asynchronous on the card).
    Returns (h coefficient words, domain size) for witness_map_collect."""
    dev = resolve(device)
    domain = Domain.new(len(A) + num_instance)
    plan = NTT.make_plan(domain.size)
    evals = [
        L.to_tensor(L.encode_mont(
            matrix_vector_evals(M, z, domain, M is A, num_instance), L.FR),
            dev)
        for M in (A, B, C)]
    return witness_map(evals, plan), domain.size


def witness_map_collect(h, m: int) -> list:
    """h: a tensor or a staging.download handle -> the m - 1
    coefficients."""
    words = staging.fetch(h if isinstance(h, tuple) else (h, None))
    return L.decode_mont(words, L.FR)[: m - 1]


def prove(pk: ProvingKey, circuit, batch_id: int = 0, check: bool = True,
          device="cuda", mesh=None) -> Proof:
    """check=False skips the satisfaction pre-pass (ark-groth16 semantics:
    an unsatisfied witness just yields a proof that fails verification)."""
    dev, mesh = D.placement(device, mesh)
    return _prove_from_parts(pk, _synthesize_dsl(circuit, check), batch_id,
                             dev, mesh)


def check_fits(pk: ProvingKey, num_instance: int, num_vars: int,
               num_constraints: int) -> None:
    """Raise on the host, before any launch, unless the witness has the
    key's shape: its instance count, variable count (the a, b1, b2 and l
    queries are indexed by witness position) and domain (the h query holds
    m - 1 points). A witness of another length would reach the MSM kernels
    against query pools of the key's length; the JAX package raises an
    IndexError there, after its witness map has run."""
    m = Domain.new(num_constraints + num_instance).size
    got = (num_instance, num_vars, m - 1)
    want = (len(pk.vk.gamma_abc_g1), len(pk.a_query), len(pk.h_query))
    if got != want:
        raise ValueError(
            f"key / witness mismatch: the witness has (instances, "
            f"variables, h terms) = {got}, the key {want}")


def _synthesize_dsl(circuit, check: bool):
    """Host stage of a DSL prove: synthesis, matrices and assignment."""
    from ..r1cs.system import ConstraintSystem

    with span("prove.synthesize_dsl"):
        cs = ConstraintSystem()
        circuit.generate_constraints(cs)
        if check:
            bad = cs.is_satisfied()
            if bad is not None:
                raise ValueError(
                    f"constraint {bad} unsatisfied; witness invalid")
        A, B, C = cs.matrices()
        return A, B, C, cs.full_assignment(), cs.num_instance


def _prove_from_parts(pk: ProvingKey, parts, batch_id: int,
                      dev: torch.device, mesh=None) -> Proof:
    A, B, C, z, num_instance = parts
    check_fits(pk, num_instance, len(z), len(A))

    # ark-groth16 `prove`: r then s, each one `Fr::rand` draw
    rng = StdRng.seed_from_u64(batch_id)
    r = rand_fp(rng, FR)
    s = rand_fp(rng, FR)

    # the h download streams back while this thread dispatches the MSMs
    with span("prove.witness_map"):
        h_dev, m = witness_map_dispatch(A, B, C, z, num_instance, dev)
        h_handle = staging.download(h_dev)
    with span("prove.queries"):
        q = prepare_queries(pk, dev, mesh)
    with span("prove.z_digits"):
        digits_z = MSM.scalar_digits(z)
    return _msms_and_assembly(
        pk, q, r, s, digits_z, None,
        functools.partial(_h_digits, h_handle,
                          lambda w: L.decode_mont(w, L.FR)[:m - 1]),
        dev, mesh)


def _h_digits(h_handle, decode):
    """The h coefficients' digits: wait for their download (a
    staging.download handle), decode the words on the host, take the
    digits."""
    with span("h.fetch"):
        words = staging.fetch(h_handle)
    with span("h.decode"):
        h = decode(words)
    with span("h.digits"):
        return MSM.scalar_digits(h)


def _sharded_msms(q, digits_z, segs_z, h_digits, mesh) -> list:
    """The five MSMs over the mesh, h last: the a/b1/l/b2 MSMs (the scalars
    z, one shared schedule set of this rank's shard, built unless given)
    run while the h coefficients stream back. Handles in the order a, b1,
    h, b2, l."""
    from ..parallel import sharded as SH

    if segs_z is None:
        with span("msm.z_schedules") as sp:
            segs_z = SH.shard_schedules(digits_z, q["a"].n, mesh)
            sp.counts.update(MSM.schedule_counts(segs_z))
    with span("msm.dispatch"):
        t_a, t_b1, t_l, t_b2 = (
            SH.msm_begin_scheds_sharded(
                q[k], segs_z, mesh, MSM._inf_correction(digits_z, q[k].inf))
            for k in ("a", "b1", "l", "b2"))
    with span("h.stage"):
        digits_h = h_digits()
    with span("msm.dispatch"):
        t_h = SH.msm_begin_sharded(q["h"], None, mesh, digits=digits_h)
    return [t_a, t_b1, t_h, t_b2, t_l]


def _msms_and_assembly(pk, q, r, s, digits_z, segs_z, h_digits, dev,
                       mesh=None) -> Proof:
    """The five MSMs (_local_msms on one device, _sharded_msms over a
    mesh) and the host assembly. h_digits() downloads and decodes the h
    coefficients and returns their digits."""
    handles = (_sharded_msms(q, digits_z, segs_z, h_digits, mesh)
               if mesh is not None else
               _local_msms(q, digits_z, segs_z, h_digits, dev))
    with span("msm.end"):
        g_a_sum, g_b1_sum, h_sum, g_b2_sum, l_sum = MSM.msm_end_many(handles)

    with span("prove.assembly"):
        g_a = G1.add(G1.add(pk.vk.alpha_g1, g_a_sum), G1.mul(pk.delta_g1, r))
        g_b1 = G1.add(G1.add(pk.beta_g1, g_b1_sum), G1.mul(pk.delta_g1, s))
        g_b2 = G2.add(G2.add(pk.vk.beta_g2, g_b2_sum),
                      G2.mul(pk.vk.delta_g2, s))

        c_pt = G1.add(l_sum, h_sum)
        c_pt = G1.add(c_pt, G1.mul(g_a, s))
        c_pt = G1.add(c_pt, G1.mul(g_b1, r))
        c_pt = G1.add(c_pt, G1.neg(G1.mul(pk.delta_g1, r * s % FR)))
        return Proof(a=g_a, b=g_b2, c=c_pt)


def _local_msms(q, digits_z, segs_z, h_digits, dev) -> list:
    """The five MSMs on one device. A worker thread runs h_digits() and
    builds and uploads the h schedules while this thread builds (unless
    given) the z schedules and dispatches the a/b1/l and b2 MSMs (one
    shared schedule set: same scalars z, one lane count for G1 and G2).
    Handles in the order a, b1, h, b2, l."""

    def _h_work():
        with span("h.stage"):
            digits_h = h_digits()
            with span("h.schedules") as sp:
                segs_h = MSM.build_segment_schedules(digits_h)
                sp.counts.update(MSM.schedule_counts(segs_h))
            MSM.upload_segment_schedules(segs_h, dev)
            return segs_h, digits_h

    with _cf.ThreadPoolExecutor(1) as ex:
        h_fut = ex.submit(carry(_h_work))
        if segs_z is None:
            with span("msm.z_schedules") as sp:
                segs_z = MSM.build_segment_schedules(digits_z)
                sp.counts.update(MSM.schedule_counts(segs_z))
        with span("msm.dispatch"):
            t_a, t_b1, t_l, t_b2 = (
                MSM.msm_begin_scheds(q[k], segs_z,
                                     MSM._inf_correction(digits_z, q[k][1]))
                for k in ("a", "b1", "l", "b2"))
        with span("prove.wait_h"):
            segs_h, digits_h = h_fut.result()
    with span("msm.dispatch"):
        t_h = MSM.msm_begin_scheds(q["h"], segs_h,
                                   MSM._inf_correction(digits_h, q["h"][1]))
    return [t_a, t_b1, t_h, t_b2, t_l]


def prove_many(pk: ProvingKey, jobs, check: bool = False,
               device="cuda", mesh=None) -> list:
    """Pipelined proves: synthesis of proof k+1 runs on a worker thread
    while proof k's device work is in flight. jobs: [(circuit, batch_id)];
    returns [Proof] in order."""
    dev, mesh = D.placement(device, mesh)
    out = []
    with _cf.ThreadPoolExecutor(1) as ex:
        nxt = ex.submit(_synthesize_dsl, jobs[0][0], check)
        for i, (_circuit, batch_id) in enumerate(jobs):
            cur = nxt
            if i + 1 < len(jobs):
                nxt = ex.submit(_synthesize_dsl, jobs[i + 1][0], check)
            out.append(_prove_from_parts(pk, cur.result(), batch_id, dev,
                                         mesh))
    return out


def public_inputs_of(circuit) -> list:
    """Instance values (excluding the leading ONE) for verification."""
    from ..r1cs.system import ConstraintSystem

    cs = ConstraintSystem()
    circuit.generate_constraints(cs)
    return cs.instance_values[1:]


# ---------------------------------------------------------------------------
# the native (chunk) path: prove_synthesized over a NativeSystem
# ---------------------------------------------------------------------------


@dataclass
class StagedWitnessMap:
    """The three witness-map inputs A.z | instance, B.z, C.z as (8, size)
    Montgomery words on the device, zero-padded to the domain size."""

    words: list
    size: int


def witness_map_stage_native(system, device="cuda") -> StagedWitnessMap:
    """Host half of the native witness map: the sparse A.z/B.z/C.z matvecs
    in C (Montgomery output), then a pinned non_blocking upload of the
    (8, size) words on the current stream. The chunk pipeline runs it on a
    worker thread inside ops.staging.side_stream for chunk k+1 while chunk
    k's kernels run."""
    from ..r1cs.native_synth import words32

    dev = resolve(device)
    nc, ni = system.num_constraints, system.num_instance
    size = Domain.new(nc + ni).size
    # A gets the identity block over the instance assignment appended
    # (input-consistency rows), as matrix_vector_evals(input_rows=True)
    with span("wm.matvec"):
        rows = {
            "A": np.concatenate([words32(system.matvec("A", mont=True)),
                                 L.encode_mont(system.instance_ints(), L.FR)],
                                axis=1),
            "B": words32(system.matvec("B", mont=True)),
            "C": words32(system.matvec("C", mont=True)),
        }
    out = []
    pinned = dev.type == "cuda"
    with span("wm.upload", bytes=3 * L.NWORDS * size * 4, pinned=pinned):
        for k in ("A", "B", "C"):
            host = torch.zeros((L.NWORDS, size), dtype=torch.int32,
                               pin_memory=pinned)
            host[:, :rows[k].shape[1]] = torch.from_numpy(
                np.ascontiguousarray(rows[k], dtype=np.uint32).view(np.int32))
            out.append(host.to(dev, non_blocking=True))
    return StagedWitnessMap(out, size)


def witness_map_dispatch_native(system, staged: StagedWitnessMap = None,
                                device="cuda"):
    """witness_map over a r1cs.native_synth.NativeSystem (asynchronous on
    the card): (h coefficient words (8, size), size). `staged`: the inputs
    from witness_map_stage_native, run earlier; their domain must be the
    system's."""
    size = Domain.new(system.num_constraints + system.num_instance).size
    if staged is None:
        staged = witness_map_stage_native(system, device)
    assert staged.size == size, (
        f"staged witness map of size {staged.size} for a system whose "
        f"domain is {size}")
    return witness_map(staged.words, NTT.make_plan(size)), size


def prove_synthesized(pk: ProvingKey, system, batch_id: int = 0,
                      check: bool = True, precomputed: dict = None,
                      device="cuda", mesh=None) -> Proof:
    """prove() over a natively synthesized system (the production chunk
    path: synthesis, satisfaction check, matvec and digits are C / numpy).

    `precomputed` (optional): {"digits_z", "segs_z", "wm", "uploads"} built ahead by Groth16ChunkProver._synth_chunk on a worker
    thread while the previous chunk's kernels ran; "uploads" is the
    ops.staging handle of its device copies, waited on here before any
    kernel reads them."""
    from ..r1cs.native_synth import from_mont_words

    dev, mesh = D.placement(device, mesh)
    with span("prove.synthesized"):
        if check:
            with span("prove.check"):
                bad = system.check()
            if bad != -1:
                raise ValueError(
                    f"constraint {bad} unsatisfied; witness invalid")
        num_instance = system.num_instance
        check_fits(pk, num_instance, system.num_vars, system.num_constraints)

        rng = StdRng.seed_from_u64(batch_id)
        r = rand_fp(rng, FR)
        s = rand_fp(rng, FR)
        pre = precomputed or {}
        if "uploads" in pre:
            staging.take_over(pre["uploads"], dev)
        with span("prove.witness_map"):
            h_dev, m = witness_map_dispatch_native(system, pre.get("wm"), dev)
            h_handle = staging.download(h_dev)
        with span("prove.queries"):
            q = prepare_queries(pk, dev, mesh)
        if "digits_z" in pre:
            digits_z = pre["digits_z"]
        else:
            with span("prove.z_digits"):
                digits_z = MSM.scalar_digits(system.z)
        return _msms_and_assembly(
            pk, q, r, s, digits_z, pre.get("segs_z"),
            functools.partial(_h_digits, h_handle,
                              lambda w: from_mont_words(w)[:m - 1]),
            dev, mesh)
