"""Groth16 circuit-specific setup (keygen), on the card.

Produces the same proving and verifying keys as the JAX package's
groth16/setup.py (ark-groth16 =0.5.0 structure), for the same circuit and
seed: the same StdRng draw order, the same QAP evaluation, and the same
affine points. Query layout:

    a_query[i]    = a_i(t) * G1                 (all variables)
    b_g1_query[i] = b_i(t) * G1,  b_g2_query[i] = b_i(t) * G2
    h_query[j]    = (t^j * Z(t) / delta) * G1,  j < m - 1
    l_query[i]    = (beta*a_i + alpha*b_i + c_i) / delta * G1   (witnesses)
    gamma_abc[i]  = (beta*a_i + alpha*b_i + c_i) / gamma * G1   (instances)

Zero evaluations yield points at infinity. From num_vars + m >= 4096 the
query arrays come from the device fixed-base engine (ops/fixed_base.py, the
`step` kernel) as PointArrays; below, from host windowed tables.
"""

from __future__ import annotations

import numpy as np

from ..curves import g1 as G1, g2 as G2
from ..device import resolve
from ..fields.bn254 import R as FR
from ..poly.domain import Domain
from ..trace import span
from .keys import ProvingKey, VerifyingKey
from .qap import evaluate_qap_at
from .stdrng import StdRng, rand_fp, rand_g1, rand_g2

WINDOW = 4
DEVICE_MIN = 4096  # num_vars + m from which the queries go to the device


class FixedBase:
    """Host windowed fixed-base scalar multiplication table."""

    def __init__(self, base, curve):
        self.curve = curve
        n_windows = (254 + WINDOW - 1) // WINDOW
        self.tables = []
        cur = base
        for _ in range(n_windows):
            row = [None]  # 0 * base
            acc = None
            for _ in range((1 << WINDOW) - 1):
                acc = curve.add(acc, cur)
                row.append(acc)
            self.tables.append(row)
            # advance base by 2^WINDOW
            for _ in range(WINDOW):
                cur = curve.add(cur, cur)

    def mul(self, scalar: int):
        scalar %= FR
        acc = None
        w = 0
        while scalar:
            digit = scalar & ((1 << WINDOW) - 1)
            if digit:
                acc = self.curve.add(acc, self.tables[w][digit])
            scalar >>= WINDOW
            w += 1
        return acc


def keygen(circuit, seed: int = 0, device="cuda") -> ProvingKey:
    """Deterministic circuit-specific setup of a DSL circuit (seed 0 is the
    reference keygen.rs discipline)."""
    from ..r1cs.system import ConstraintSystem

    dev = resolve(device)
    with span("keygen"):
        with span("keygen.synthesize"):
            cs = ConstraintSystem()
            circuit.generate_constraints(cs)
            A, B, C = cs.matrices()
        num_instance = cs.num_instance
        num_vars = num_instance + cs.num_witness
        return _keygen_impl(A, B, C, num_instance, num_vars, seed, None, dev)


def keygen_synthesized(system, seed: int = 0, device="cuda") -> ProvingKey:
    """keygen over a r1cs.native_synth.NativeSystem: the QAP evaluation at t
    and the keygen scalar combines run in C, and the scalars stay (n, 4)
    u64 arrays end to end."""
    dev = resolve(device)
    with span("keygen"):
        return _keygen_impl(None, None, None, system.num_instance,
                            system.num_vars, seed, system, dev)


def _qap_at_native(system, t: int, domain):
    """evaluate_qap_at over the native CSR system: (a, b, c, zt) with a/b/c
    as (num_vars, 4) u64 canonical limb arrays."""
    from ..r1cs.native_synth import fr_array, fr_ints, lagrange_at

    u, zt = lagrange_at(domain.group_gen, domain.size_inv, t, domain.size)
    a = system.qap_accumulate("A", u)
    b = system.qap_accumulate("B", u)
    c = system.qap_accumulate("C", u)
    ni, nc = system.num_instance, system.num_constraints
    u_tail = fr_ints(u[nc:nc + ni])
    a_head = fr_ints(a[:ni])
    a[:ni] = fr_array([(a_head[i] + u_tail[i]) % FR for i in range(ni)])
    return a, b, c, zt


def _keygen_impl(A, B, C, num_instance, num_vars, seed, system,
                 dev) -> ProvingKey:
    # rand 0.8 StdRng stream, sampled in ark-groth16's exact order
    # (generator.rs: alpha, beta, gamma, delta, G1::rand, G2::rand, then
    # sample_element_outside_domain for t)
    with span("keygen.qap"):
        rng = StdRng.seed_from_u64(seed)
        alpha = rand_fp(rng, FR)
        beta = rand_fp(rng, FR)
        gamma = rand_fp(rng, FR)
        delta = rand_fp(rng, FR)
        g1_gen = rand_g1(rng)
        g2_gen = rand_g2(rng)

        num_constraints = (system.num_constraints if system is not None
                           else len(A))
        domain = Domain.new(num_constraints + num_instance)
        while True:
            t = rand_fp(rng, FR)
            if domain.evaluate_vanishing_polynomial(t) != 0:
                break

        gamma_inv = pow(gamma, FR - 2, FR)
        delta_inv = pow(delta, FR - 2, FR)
        m = domain.size
        ni = num_instance

        if system is not None:
            from ..r1cs.native_synth import (abc_combine, fr_ints,
                                             powers_scaled)

            a, b, c, zt = _qap_at_native(system, t, domain)
            h_s = powers_scaled(t, zt * delta_inv % FR, m - 1)
            l_s = abc_combine(a[ni:], b[ni:], c[ni:], beta, alpha, delta_inv)
            abc_scalars = fr_ints(
                abc_combine(a[:ni], b[:ni], c[:ni], beta, alpha, gamma_inv))
        else:
            a, b, c, zt, domain = evaluate_qap_at(
                A, B, C, num_instance, num_vars, t)
            h_s = []
            tj = 1
            for _ in range(m - 1):
                h_s.append(tj * zt % FR * delta_inv % FR)
                tj = tj * t % FR
            l_s = [(beta * a[i] + alpha * b[i] + c[i]) % FR * delta_inv % FR
                   for i in range(num_instance, num_vars)]
            abc_scalars = [(beta * a[i] + alpha * b[i] + c[i]) % FR
                           * gamma_inv % FR for i in range(num_instance)]

    with span("keygen.host_tables"):
        fb1 = FixedBase(g1_gen, G1)
        fb2 = FixedBase(g2_gen, G2)

    if num_vars + m >= DEVICE_MIN:
        from ..ops.fixed_base import (fixed_base_msm, prepare_table_g1,
                                      prepare_table_g2)

        with span("keygen.device_tables"):
            tg1 = prepare_table_g1(g1_gen, dev)
            tg2 = prepare_table_g2(g2_gen, dev)

        def msm1(scalars):
            return fixed_base_msm(tg1, scalars)

        def msm2(scalars):
            return fixed_base_msm(tg2, scalars)
    else:
        from ..r1cs.native_synth import fr_ints

        def _ints(s):
            return fr_ints(s) if isinstance(s, np.ndarray) else s

        def msm1(scalars):
            return [fb1.mul(s) if s else None for s in _ints(scalars)]

        def msm2(scalars):
            return [fb2.mul(s) if s else None for s in _ints(scalars)]

    queries = {}
    for name, fn, scalars in (("a", msm1, a), ("b1", msm1, b),
                              ("b2", msm2, b), ("h", msm1, h_s),
                              ("l", msm1, l_s)):
        with span(f"keygen.query_{name}", points=len(scalars)):
            queries[name] = fn(scalars)
    with span("keygen.vk"):
        vk = VerifyingKey(
            alpha_g1=fb1.mul(alpha),
            beta_g2=fb2.mul(beta),
            gamma_g2=fb2.mul(gamma),
            delta_g2=fb2.mul(delta),
            gamma_abc_g1=[fb1.mul(s) if s else None for s in abc_scalars],
        )
        beta_g1, delta_g1 = fb1.mul(beta), fb1.mul(delta)
    return ProvingKey(
        vk=vk,
        beta_g1=beta_g1,
        delta_g1=delta_g1,
        a_query=queries["a"],
        b_g1_query=queries["b1"],
        b_g2_query=queries["b2"],
        h_query=queries["h"],
        l_query=queries["l"],
    )
