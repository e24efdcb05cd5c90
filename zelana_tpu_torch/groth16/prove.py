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
"""

from __future__ import annotations

import concurrent.futures as _cf
import time
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
from ..poly.domain import Domain
from ..trace import phase_log_start, phase_log_take  # noqa: F401
from ..trace import trace as _trace
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
          device="cuda") -> Proof:
    """check=False skips the satisfaction pre-pass (ark-groth16 semantics:
    an unsatisfied witness just yields a proof that fails verification)."""
    dev = resolve(device)
    return _prove_from_parts(pk, _synthesize_dsl(circuit, check), batch_id,
                             dev)


def _synthesize_dsl(circuit, check: bool):
    """Host stage of a DSL prove: synthesis, matrices and assignment."""
    from ..r1cs.system import ConstraintSystem

    cs = ConstraintSystem()
    circuit.generate_constraints(cs)
    if check:
        bad = cs.is_satisfied()
        if bad is not None:
            raise ValueError(f"constraint {bad} unsatisfied; witness invalid")
    A, B, C = cs.matrices()
    return A, B, C, cs.full_assignment(), cs.num_instance


def _prove_from_parts(pk: ProvingKey, parts, batch_id: int,
                      dev: torch.device) -> Proof:
    A, B, C, z, num_instance = parts
    assert len(pk.vk.gamma_abc_g1) == num_instance, "key / circuit mismatch"

    # ark-groth16 `prove`: r then s, each one `Fr::rand` draw
    rng = StdRng.seed_from_u64(batch_id)
    r = rand_fp(rng, FR)
    s = rand_fp(rng, FR)

    # the h download streams back while this thread dispatches the MSMs
    h_dev, m = witness_map_dispatch(A, B, C, z, num_instance, dev)
    h_handle = staging.download(h_dev)
    q = prepare_queries(pk, dev)
    digits_z = MSM.scalar_digits(z)
    return _msms_and_assembly(
        pk, q, r, s, digits_z, None,
        lambda: MSM.scalar_digits(witness_map_collect(h_handle, m)), dev)


def _msms_and_assembly(pk, q, r, s, digits_z, segs_z, h_digits, dev,
                       t0=None) -> Proof:
    """The five MSMs and the host assembly. A worker thread runs
    h_digits() (download and decode of the h coefficients, digits) and
    builds and uploads the h schedules while this thread builds (unless
    given) the z schedules and dispatches the a/b1/l and b2 MSMs (one
    shared schedule set: same scalars z, one lane count for G1 and G2)."""

    def _h_work():
        digits_h = h_digits()
        segs_h = MSM.build_segment_schedules(digits_h)
        MSM.upload_segment_schedules(segs_h, dev)
        return segs_h, digits_h

    with _cf.ThreadPoolExecutor(1) as ex:
        h_fut = ex.submit(_h_work)
        if segs_z is None:
            segs_z = MSM.build_segment_schedules(digits_z)
            _trace("z segment schedules built", t0)
        t_a, t_b1, t_l, t_b2 = (
            MSM.msm_begin_scheds(q[k], segs_z,
                                 MSM._inf_correction(digits_z, q[k][1]))
            for k in ("a", "b1", "l", "b2"))
        _trace("a/b1/l/b2 MSMs in flight (one shared schedule)", t0)
        segs_h, digits_h = h_fut.result()
    _trace("h downloaded + decoded + scheduled (worker thread)", t0)
    t_h = MSM.msm_begin_scheds(q["h"], segs_h,
                               MSM._inf_correction(digits_h, q["h"][1]))
    g_a_sum, g_b1_sum, h_sum, g_b2_sum, l_sum = MSM.msm_end_many(
        [t_a, t_b1, t_h, t_b2, t_l])
    _trace("all five MSMs finished + downloaded", t0)

    g_a = G1.add(G1.add(pk.vk.alpha_g1, g_a_sum), G1.mul(pk.delta_g1, r))
    g_b1 = G1.add(G1.add(pk.beta_g1, g_b1_sum), G1.mul(pk.delta_g1, s))
    g_b2 = G2.add(G2.add(pk.vk.beta_g2, g_b2_sum), G2.mul(pk.vk.delta_g2, s))

    c_pt = G1.add(l_sum, h_sum)
    c_pt = G1.add(c_pt, G1.mul(g_a, s))
    c_pt = G1.add(c_pt, G1.mul(g_b1, r))
    c_pt = G1.add(c_pt, G1.neg(G1.mul(pk.delta_g1, r * s % FR)))
    return Proof(a=g_a, b=g_b2, c=c_pt)


def prove_many(pk: ProvingKey, jobs, check: bool = False,
               device="cuda") -> list:
    """Pipelined proves: synthesis of proof k+1 runs on a worker thread
    while proof k's device work is in flight. jobs: [(circuit, batch_id)];
    returns [Proof] in order."""
    dev = resolve(device)
    out = []
    with _cf.ThreadPoolExecutor(1) as ex:
        nxt = ex.submit(_synthesize_dsl, jobs[0][0], check)
        for i, (_circuit, batch_id) in enumerate(jobs):
            cur = nxt
            if i + 1 < len(jobs):
                nxt = ex.submit(_synthesize_dsl, jobs[i + 1][0], check)
            out.append(_prove_from_parts(pk, cur.result(), batch_id, dev))
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
    rows = {
        "A": np.concatenate([words32(system.matvec("A", mont=True)),
                             L.encode_mont(system.instance_ints(), L.FR)],
                            axis=1),
        "B": words32(system.matvec("B", mont=True)),
        "C": words32(system.matvec("C", mont=True)),
    }
    out = []
    for k in ("A", "B", "C"):
        host = torch.zeros((L.NWORDS, size), dtype=torch.int32,
                           pin_memory=dev.type == "cuda")
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
                      device="cuda") -> Proof:
    """prove() over a natively synthesized system (the production chunk
    path: synthesis, satisfaction check, matvec and digits are C / numpy).

    `precomputed` (optional): {"digits_z", "segs_z", "wm", "uploads"} built ahead by Groth16ChunkProver._synth_chunk on a worker
    thread while the previous chunk's kernels ran; "uploads" is the
    ops.staging handle of its device copies, waited on here before any
    kernel reads them."""
    from ..r1cs.native_synth import from_mont_words

    dev = resolve(device)
    t0 = time.time()
    if check:
        bad = system.check()
        if bad != -1:
            raise ValueError(
                f"constraint {bad} unsatisfied; witness invalid")
    num_instance = system.num_instance
    assert len(pk.vk.gamma_abc_g1) == num_instance, "key / circuit mismatch"

    rng = StdRng.seed_from_u64(batch_id)
    r = rand_fp(rng, FR)
    s = rand_fp(rng, FR)
    pre = precomputed or {}
    if "uploads" in pre:
        staging.take_over(pre["uploads"], dev)
    _trace("witness checked", t0)
    h_dev, m = witness_map_dispatch_native(system, pre.get("wm"), dev)
    h_handle = staging.download(h_dev)
    _trace("witness map dispatched (NTT chain queued)", t0)
    q = prepare_queries(pk, dev)
    _trace("query pools prepared/cached", t0)
    digits_z = (pre["digits_z"] if "digits_z" in pre
                else MSM.scalar_digits(system.z))
    return _msms_and_assembly(
        pk, q, r, s, digits_z, pre.get("segs_z"),
        lambda: MSM.scalar_digits(
            from_mont_words(staging.fetch(h_handle))[:m - 1]),
        dev, t0)
