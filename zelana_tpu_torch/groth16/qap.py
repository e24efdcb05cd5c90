"""R1CS -> QAP reduction (libsnark-style, matching ark-groth16 =0.5.0).

Domain size is num_constraints + num_instance; the extra rows append an
identity block over the instance variables to the A matrix (input
consistency), exactly as ark-groth16's LibsnarkReduction does. Setup
evaluates the variable polynomials at a secret point t via Lagrange
coefficients; proving evaluates A.z/B.z/C.z over a coset to obtain h(x).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from ..fields.bn254 import R as FR
from ..poly.domain import Domain


def lagrange_coeffs_at(domain: Domain, t: int) -> List[int]:
    """u_r(t) for all r: u_r(t) = Z(t) * w^r / (m * (t - w^r))."""
    m = domain.size
    zt = domain.evaluate_vanishing_polynomial(t)
    if zt == 0:
        # t inside the domain: u_r(t) = kronecker delta
        out = [0] * m
        for r, w in enumerate(domain.elements()):
            if w == t:
                out[r] = 1
        return out
    minv = domain.size_inv
    # batch inversion of (t - w^r)
    diffs = []
    for w in domain.elements():
        diffs.append((t - w) % FR)
    invs = _batch_inv(diffs)
    out = []
    w = 1
    for r in range(m):
        out.append(zt * minv % FR * w % FR * invs[r] % FR)
        w = w * domain.group_gen % FR
    return out


def _batch_inv(values: List[int]) -> List[int]:
    n = len(values)
    prefix = [1] * (n + 1)
    for i, v in enumerate(values):
        prefix[i + 1] = prefix[i] * v % FR
    inv_total = pow(prefix[n], FR - 2, FR)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = inv_total * prefix[i] % FR
        inv_total = inv_total * values[i] % FR
    return out


def evaluate_qap_at(
    A: List[Dict[int, int]],
    B: List[Dict[int, int]],
    C: List[Dict[int, int]],
    num_instance: int,
    num_vars: int,
    t: int,
) -> Tuple[List[int], List[int], List[int], int, Domain]:
    """Evaluate all variable polynomials a_i(t), b_i(t), c_i(t) and Z(t)."""
    num_constraints = len(A)
    domain = Domain.new(num_constraints + num_instance)
    u = lagrange_coeffs_at(domain, t)

    a = [0] * num_vars
    b = [0] * num_vars
    c = [0] * num_vars
    for r in range(num_constraints):
        ur = u[r]
        for i, coeff in A[r].items():
            a[i] = (a[i] + coeff * ur) % FR
        for i, coeff in B[r].items():
            b[i] = (b[i] + coeff * ur) % FR
        for i, coeff in C[r].items():
            c[i] = (c[i] + coeff * ur) % FR
    # input consistency rows: A[num_constraints + i][i] = 1
    for i in range(num_instance):
        a[i] = (a[i] + u[num_constraints + i]) % FR

    zt = domain.evaluate_vanishing_polynomial(t)
    return a, b, c, zt, domain


def matrix_vector_evals(
    M: List[Dict[int, int]], z: List[int], domain: Domain,
    input_rows: bool, num_instance: int,
) -> List[int]:
    """Evaluations of M.z over the domain, padded; A gets the identity block
    over the instance assignment in rows [num_constraints, +num_instance)."""
    evals = []
    for row in M:
        evals.append(sum(coeff * z[i] for i, coeff in row.items()) % FR)
    if input_rows:
        evals.extend(z[:num_instance])
    evals.extend([0] * (domain.size - len(evals)))
    return evals
