"""Groth16 prover on the card (PyTorch + the port's CUDA kernels).

Same pipeline and the same bytes as the JAX package's groth16/prove.py:

  1. synthesize the circuit -> matrices + full assignment z (host)
  2. witness map: A.z, B.z, C.z over the domain, iNTT to coefficients,
     coset NTT, (A.z * B.z - C.z) / Z on the coset, coset iNTT -> h(x)
     coefficients                          [mont_mul + butterfly kernels]
  3. five run-scan MSMs over the proving-key queries: a, b1, l, h in G1 and
     b2 in G2                               [runscan + pairs_add kernels]
  4. assembly A = alpha + <a,z> + r*delta, B = beta + <b,z> + s*delta,
     C = <l,w> + <h_query,h> + s*A + r*B - rs*delta        (host, tiny)

r and s come from StdRng seeded by batch_id (stdrng.py), so a proof is
deterministic in batch_id and equals the JAX package's byte for byte.

Every entry point takes `device`, "cuda" by default; with no card it raises
unless the caller asks for "cpu", where the kernels' plain versions run.
"""

from __future__ import annotations

import concurrent.futures as _cf

import torch

from ..curves import g1 as G1, g2 as G2
from ..device import resolve
from ..fields.bn254 import R as FR
from ..ops import field_kernels as FK
from ..ops import limbs as L
from ..ops import msm_scan as MSM
from ..ops import ntt as NTT
from ..poly.domain import Domain
from .keys import Proof, ProvingKey, prepare_queries
from .qap import matrix_vector_evals
from .stdrng import StdRng, rand_fp


def witness_map(evals, plan: NTT.NttPlan, plain: bool = False):
    """The device chain of the witness map: evals = [A.z, B.z, C.z] as
    (8, n) Montgomery words on one device -> (8, n) words of h(x)."""
    mul = FK.mont_mul_plain if plain else FK.mont_mul
    coeffs = [NTT.intt(x, plan, plain) for x in evals]
    cosets = [NTT.coset_ntt(x, plan, plain) for x in coeffs]
    ab = mul(cosets[0], cosets[1], L.FR)
    num = L.sub(ab, cosets[2], L.FR)
    z_inv = pow(plan.domain.evaluate_vanishing_on_coset(), FR - 2, FR)
    z_inv_b = L.broadcast(L.encode_mont([z_inv], L.FR)[:, 0], plan.n,
                          num.device)
    return NTT.coset_intt(mul(num, z_inv_b, L.FR), plan, plain)


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


def _h_async(h_dev: torch.Tensor):
    """Start the h download: on the card a non_blocking copy into pinned
    memory plus an event, so it streams back while the main thread
    dispatches the other MSMs."""
    if h_dev.device.type != "cuda":
        return h_dev, None
    host = torch.empty(h_dev.shape, dtype=h_dev.dtype, pin_memory=True)
    host.copy_(h_dev, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def witness_map_collect(h, m: int) -> list:
    """h: a tensor or an _h_async handle -> the m - 1 coefficients."""
    host, done = h if isinstance(h, tuple) else (h, None)
    if done is not None:
        done.synchronize()
    return L.decode_mont(L.to_numpy(host), L.FR)[: m - 1]


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

    # the witness map goes to the device first; a worker thread downloads
    # and decodes h and builds its schedules while this thread dispatches
    # the a/b1/l MSMs (one shared schedule set: same scalars z) and b2
    h_dev, m = witness_map_dispatch(A, B, C, z, num_instance, dev)
    h_handle = _h_async(h_dev)
    q = prepare_queries(pk, dev)
    digits_z = MSM.scalar_digits(z)

    def _h_work():
        digits_h = MSM.scalar_digits(witness_map_collect(h_handle, m))
        segs_h = MSM.build_segment_schedules(digits_h)
        MSM.upload_segment_schedules(segs_h, dev)
        return segs_h, digits_h

    with _cf.ThreadPoolExecutor(1) as ex:
        h_fut = ex.submit(_h_work)
        segs_z = MSM.build_segment_schedules(digits_z)
        segs_b2 = MSM.build_segment_schedules(digits_z, lanes=MSM.LANES_G2)
        t_a, t_b1, t_l = (
            MSM.msm_begin_scheds(q[k], segs_z,
                                 MSM._inf_correction(digits_z, q[k][1]))
            for k in ("a", "b1", "l"))
        t_b2 = MSM.msm_begin_scheds(
            q["b2"], segs_b2, MSM._inf_correction(digits_z, q["b2"][1]))
        segs_h, digits_h = h_fut.result()
    t_h = MSM.msm_begin_scheds(q["h"], segs_h,
                               MSM._inf_correction(digits_h, q["h"][1]))
    g_a_sum, g_b1_sum, h_sum, g_b2_sum, l_sum = MSM.msm_end_many(
        [t_a, t_b1, t_h, t_b2, t_l])

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
