"""R1CS constraint system + FpVar gadget layer (arkworks-semantics).

Models the subset of ark-relations / ark-r1cs-std behavior the reference
circuits rely on (prover/src/l2_circuit.rs), with identical variable/witness
allocation discipline:

- variable 0 is the constant ONE; instance variables follow, then witnesses
- linear combinations are kept inlined (equivalent to arkworks'
  OptimizationGoal::Constraints + inline_all_lcs, which is what ark-groth16
  uses before matrix extraction)
- FpVar is Constant | Var(lc); add/sub/scale are free, mul/square allocate a
  product witness plus one constraint; constants propagate without
  constraints (this matters: the Poseidon gadget over partially-constant
  state emits fewer constraints, exactly as in arkworks)

Witness values are computed during synthesis, so one pass yields both the
matrices and the full assignment.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..fields.bn254 import R as FR

LC = Dict[int, int]  # var index -> coefficient (mod FR)


class ConstraintSystem:
    def __init__(self):
        self.num_instance = 1  # the constant ONE at index 0
        self.instance_values: List[int] = [1]
        self.witness_values: List[int] = []
        # constraints: (A_lc, B_lc, C_lc), variables indexed globally:
        # [0] = one, [1..num_instance) = inputs, then witnesses offset by
        # num_instance at matrix-build time.
        self.constraints: List[Tuple[LC, LC, LC]] = []

    # -- allocation ---------------------------------------------------------

    def new_input(self, value: int) -> "FpVar":
        idx = self.num_instance
        self.num_instance += 1
        self.instance_values.append(value % FR)
        if self.witness_values:
            raise RuntimeError(
                "all instance variables must be allocated before witnesses "
                "(arkworks indexing discipline)"
            )
        return FpVar(self, lc={("i", idx): 1}, value=value % FR)

    def new_witness(self, value: int) -> "FpVar":
        idx = len(self.witness_values)
        self.witness_values.append(value % FR)
        return FpVar(self, lc={("w", idx): 1}, value=value % FR)

    def constant(self, value: int) -> "FpVar":
        return FpVar(self, lc=None, value=value % FR)

    def enforce(self, a: "FpVar", b: "FpVar", c: "FpVar"):
        self.constraints.append((a.as_lc(), b.as_lc(), c.as_lc()))

    # -- finalize -----------------------------------------------------------

    @property
    def num_witness(self) -> int:
        return len(self.witness_values)

    @property
    def num_constraints(self) -> int:
        return len(self.constraints)

    def var_index(self, key) -> int:
        kind, idx = key
        if kind == "i":
            return idx
        return self.num_instance + idx

    def matrices(self):
        """Returns (A, B, C) as lists of sparse rows {global_var: coeff}."""

        def conv(lc: LC) -> Dict[int, int]:
            return {self.var_index(k): v % FR for k, v in lc.items() if v % FR}

        A = [conv(a) for a, _, _ in self.constraints]
        B = [conv(b) for _, b, _ in self.constraints]
        C = [conv(c) for _, _, c in self.constraints]
        return A, B, C

    def full_assignment(self) -> List[int]:
        return self.instance_values + self.witness_values

    def is_satisfied(self) -> Optional[int]:
        """Returns index of first violated constraint, or None."""
        z = self.full_assignment()
        A, B, C = self.matrices()
        for r, (a, b, c) in enumerate(zip(A, B, C)):
            av = sum(coeff * z[i] for i, coeff in a.items()) % FR
            bv = sum(coeff * z[i] for i, coeff in b.items()) % FR
            cv = sum(coeff * z[i] for i, coeff in c.items()) % FR
            if av * bv % FR != cv:
                return r
        return None


@dataclass
class FpVar:
    cs: ConstraintSystem
    lc: Optional[Dict] = None  # None => constant; keys ("i"|"w", idx)
    value: int = 0

    # -- helpers ------------------------------------------------------------

    @property
    def is_constant(self) -> bool:
        return self.lc is None

    def as_lc(self) -> LC:
        if self.lc is None:
            return {("i", 0): self.value % FR} if self.value % FR else {}
        return self.lc

    @staticmethod
    def _merge(a: Optional[Dict], b: Optional[Dict], bscale: int = 1) -> Dict:
        out = dict(a or {})
        for k, v in (b or {}).items():
            out[k] = (out.get(k, 0) + v * bscale) % FR
        return {k: v for k, v in out.items() if v}

    # -- linear ops (free) --------------------------------------------------

    def __add__(self, other: "FpVar") -> "FpVar":
        if self.is_constant and other.is_constant:
            return FpVar(self.cs, None, (self.value + other.value) % FR)
        lc = self._merge(self.as_lc(), other.as_lc())
        return FpVar(self.cs, lc, (self.value + other.value) % FR)

    def __sub__(self, other: "FpVar") -> "FpVar":
        if self.is_constant and other.is_constant:
            return FpVar(self.cs, None, (self.value - other.value) % FR)
        lc = self._merge(self.as_lc(), other.as_lc(), bscale=FR - 1)
        return FpVar(self.cs, lc, (self.value - other.value) % FR)

    def scale(self, k: int) -> "FpVar":
        k %= FR
        if self.is_constant:
            return FpVar(self.cs, None, self.value * k % FR)
        lc = {key: v * k % FR for key, v in self.lc.items() if v * k % FR}
        return FpVar(self.cs, lc, self.value * k % FR)

    def add_constant(self, k: int) -> "FpVar":
        if self.is_constant:
            return FpVar(self.cs, None, (self.value + k) % FR)
        lc = dict(self.lc)
        key = ("i", 0)
        c = (lc.get(key, 0) + k) % FR
        if c:
            lc[key] = c
        else:
            lc.pop(key, None)
        return FpVar(self.cs, lc, (self.value + k) % FR)

    @staticmethod
    def combine(cs: "ConstraintSystem", terms) -> "FpVar":
        """Sigma k_j * var_j in ONE dict pass.

        The Poseidon gadget's MDS rows dominated synthesis time when built
        as scale() + __add__() chains (each a full-dict rebuild; partial-
        round LCs grow every round). Identical semantics, one merge."""
        out: dict = {}
        val = 0
        all_const = True
        for var, k in terms:
            k %= FR
            if k == 0:
                continue
            val += var.value * k
            if var.lc is None:
                if var.value % FR:
                    key = ("i", 0)
                    out[key] = (out.get(key, 0) + var.value * k) % FR
            else:
                all_const = False
                for key, v in var.lc.items():
                    out[key] = (out.get(key, 0) + v * k) % FR
        if all_const:
            # constants stay constants (lc=None) -- s-boxes on constant
            # state cost zero constraints, exactly as scale()+__add__()
            # chains behaved; the circuit SHAPE must not change
            return FpVar(cs, None, val % FR)
        out = {k2: v2 for k2, v2 in out.items() if v2}
        return FpVar(cs, out, val % FR)

    # -- nonlinear ops (allocate + constrain) -------------------------------

    def __mul__(self, other: "FpVar") -> "FpVar":
        if self.is_constant:
            return other.scale(self.value)
        if other.is_constant:
            return self.scale(other.value)
        product = self.cs.new_witness(self.value * other.value % FR)
        self.cs.enforce(self, other, product)
        return product

    def square(self) -> "FpVar":
        return self * self

    def pow5(self) -> "FpVar":
        """x^5 via square, square, multiply (the arkworks pow_by_constant
        path for alpha = 5: 3 constraints on a variable, 0 on a constant)."""
        if self.is_constant:
            return FpVar(self.cs, None, pow(self.value, 5, FR))
        x2 = self.square()
        x4 = x2.square()
        return x4 * self

    def pow7(self) -> "FpVar":
        """x^7 = ((x^2)^2 * x^2) * x -- the MiMC round exponent."""
        if self.is_constant:
            return FpVar(self.cs, None, pow(self.value, 7, FR))
        x2 = self.square()
        x4 = x2.square()
        x6 = x4 * x2
        return x6 * self

    # -- constraints --------------------------------------------------------

    def enforce_equal(self, other: "FpVar"):
        """(a - b) * 1 = 0, matching AllocatedFp::conditional_enforce_equal
        with Boolean::TRUE."""
        if self.is_constant and other.is_constant:
            assert self.value == other.value, "constant equality violated"
            return
        diff = self - other
        one = FpVar(self.cs, {("i", 0): 1}, 1)
        zero = self.cs.constant(0)
        self.cs.enforce(diff, one, zero)

    def to_bits_le(self, num_bits: int = 254) -> List["FpVar"]:
        """Allocate a little-endian bit decomposition.

        Enforces booleanity per bit, the packing identity, and canonicality
        (value < modulus), mirroring arkworks to_bits_le = non-unique bits +
        enforce_in_field_le.
        """
        bits = []
        v = self.value
        for i in range(num_bits):
            bit = self.cs.new_witness((v >> i) & 1)
            bits.append(bit)
        # booleanity: b * (b - 1) = 0
        for b in bits:
            self.cs.enforce(b, b - self.cs.constant(1), self.cs.constant(0))
        # packing: sum b_i 2^i == self
        acc = self.cs.constant(0)
        for i, b in enumerate(bits):
            acc = acc + b.scale(pow(2, i, FR))
        acc.enforce_equal(self)
        # canonical: bits represent a value <= p - 1
        enforce_bits_leq_constant(self.cs, bits, FR - 1)
        return bits


def enforce_bits_leq_constant(cs: ConstraintSystem, bits_le: List[FpVar], c: int):
    """Enforce that the LE bit vector is <= the constant c.

    MSB-down sweep with an "equal so far" indicator: at a 1-bit of c the
    indicator multiplies by the variable bit; at a 0-bit of c, indicator *
    bit must be zero. n constraints for n bits.
    """
    n = len(bits_le)
    eq_so_far = cs.constant(1)
    for i in range(n - 1, -1, -1):
        b = bits_le[i]
        if (c >> i) & 1:
            eq_so_far = eq_so_far * b
        else:
            cs.enforce(eq_so_far, b, cs.constant(0))


def enforce_cmp_geq(cs: ConstraintSystem, left: FpVar, right: FpVar):
    """Enforce left >= right (the reference's
    `enforce_cmp(&amount, Ordering::Greater, true)` at l2_circuit.rs:277-279).

    Same construction family as arkworks: restrict both operands to
    [0, (p-1)/2] via bit decomposition, then use the parity trick --
    2*(right - (left+1)) mod p is odd iff right < left + 1, i.e. left >= right.
    """
    half = (FR - 1) // 2
    lplus = left + cs.constant(1)
    rb = right.to_bits_le()
    lb = lplus.to_bits_le()
    enforce_bits_leq_constant(cs, rb, half)
    enforce_bits_leq_constant(cs, lb, half)
    # d = 2 * (right - (left + 1)); right < left+1  <=>  d odd
    d = (right - lplus).scale(2)
    dbits = d.to_bits_le()
    dbits[0].enforce_equal(cs.constant(1))
