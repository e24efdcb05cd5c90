"""An R1CS that keeps, for each constraint, only what a Groth16 proof needs
of it: the three linear combinations evaluated at the assignment, and the
part of each that falls on the instance columns (the constant ONE and the
public inputs).

The allocation discipline is arkworks' (ark-relations with every linear
combination inlined), the one the circuits are written against: an input
or a witness is a new column; add, sub, scale and constants are free; a
product of two non-constant values allocates a witness and one constraint;
a constant times anything is a scale. Which values count as constants
decides which products cost a constraint, so `const` follows the rules of
the circuits' gadget layer exactly, including combinations that cancel to
an empty, but not constant, expression.

A proof depends on the constraint order and on the instance columns only:
sum_i z_i u_i(t) = sum_j (A z)_j L_j(t) whatever the witness columns'
order. So a row is (A z, B z, C z) with its instance parts.
"""

from __future__ import annotations

from .bn254 import R as FR


class ConstraintSystem:
    def __init__(self, check: bool = True):
        self.inputs = [1]  # instance column values, ONE first
        self.num_witness = 0
        self.rows = ([], [], [])  # A z, B z, C z a constraint
        self.inst = ([], [], [])  # their instance parts
        self.check = check
        self.first_bad = None

    @property
    def num_constraints(self) -> int:
        return len(self.rows[0])

    def new_input(self, value: int) -> "Var":
        if self.num_witness:
            raise RuntimeError("inputs come before witnesses")
        value %= FR
        self.inputs.append(value)
        return Var(self, value, value, False)

    def new_witness(self, value: int) -> "Var":
        self.num_witness += 1
        return Var(self, value % FR, 0, False)

    def constant(self, value: int) -> "Var":
        value %= FR
        return Var(self, value, value, True)

    def enforce(self, a: "Var", b: "Var", c: "Var") -> None:
        ra, rb, rc = self.rows
        ia, ib, ic = self.inst
        ra.append(a.v)
        rb.append(b.v)
        rc.append(c.v)
        ia.append(a.i)
        ib.append(b.i)
        ic.append(c.i)
        if self.check and self.first_bad is None and a.v * b.v % FR != c.v:
            self.first_bad = len(ra) - 1


class Var:
    """v: the value; i: the instance part of its linear combination at the
    assignment; const: a constant (no linear combination at all)."""

    __slots__ = ("cs", "v", "i", "const")

    def __init__(self, cs, v, i, const):
        self.cs, self.v, self.i, self.const = cs, v, i, const

    def __add__(self, o: "Var") -> "Var":
        v = (self.v + o.v) % FR
        if self.const and o.const:
            return Var(self.cs, v, v, True)
        return Var(self.cs, v, (self.i + o.i) % FR, False)

    def __sub__(self, o: "Var") -> "Var":
        v = (self.v - o.v) % FR
        if self.const and o.const:
            return Var(self.cs, v, v, True)
        return Var(self.cs, v, (self.i - o.i) % FR, False)

    def scale(self, k: int) -> "Var":
        v = self.v * k % FR
        if self.const:
            return Var(self.cs, v, v, True)
        return Var(self.cs, v, self.i * k % FR, False)

    def add_constant(self, k: int) -> "Var":
        v = (self.v + k) % FR
        if self.const:
            return Var(self.cs, v, v, True)
        return Var(self.cs, v, (self.i + k) % FR, False)

    def __mul__(self, o: "Var") -> "Var":
        if self.const:
            return o.scale(self.v)
        if o.const:
            return self.scale(o.v)
        p = self.cs.new_witness(self.v * o.v)
        self.cs.enforce(self, o, p)
        return p

    def pow7(self) -> "Var":
        if self.const:
            return self.cs.constant(pow(self.v, 7, FR))
        x2 = self * self
        x4 = x2 * x2
        x6 = x4 * x2
        return x6 * self

    def enforce_equal(self, o: "Var") -> None:
        """(a - b) * ONE = 0; ONE here is the column, not a constant."""
        if self.const and o.const:
            if self.v != o.v:
                raise ValueError("constant equality violated")
            return
        self.cs.enforce(self - o, Var(self.cs, 1, 1, False),
                        self.cs.constant(0))

    def to_bits_le(self, num_bits: int = 254) -> list:
        """Bits, their booleanity, the packing and v <= p - 1."""
        cs = self.cs
        bits = [cs.new_witness((self.v >> k) & 1) for k in range(num_bits)]
        for b in bits:
            cs.enforce(b, b - cs.constant(1), cs.constant(0))
        acc = cs.constant(0)
        for k, b in enumerate(bits):
            acc = acc + b.scale(pow(2, k, FR))
        acc.enforce_equal(self)
        enforce_bits_leq_constant(cs, bits, FR - 1)
        return bits


def enforce_bits_leq_constant(cs, bits_le: list, c: int) -> None:
    eq = cs.constant(1)
    for k in range(len(bits_le) - 1, -1, -1):
        if (c >> k) & 1:
            eq = eq * bits_le[k]
        else:
            cs.enforce(eq, bits_le[k], cs.constant(0))


def enforce_cmp_geq(cs, left: Var, right: Var) -> None:
    """left >= right: both below (p - 1) / 2, and 2 (right - left - 1) odd."""
    half = (FR - 1) // 2
    lplus = left + cs.constant(1)
    rb = right.to_bits_le()
    lb = lplus.to_bits_le()
    enforce_bits_leq_constant(cs, rb, half)
    enforce_bits_leq_constant(cs, lb, half)
    dbits = (right - lplus).scale(2).to_bits_le()
    dbits[0].enforce_equal(cs.constant(1))
