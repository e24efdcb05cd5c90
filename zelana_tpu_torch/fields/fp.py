"""Prime-field helpers over Python ints (golden / host-side layer).

These mirror the semantics of arkworks `ark-ff =0.5.0` Fp operations that the
reference prover relies on (reference: prover/Cargo.toml:20), including the
byte-order conventions used throughout the reference:

- ``from_le_bytes_mod_order`` / ``to_bytes_le``: little-endian, used by the
  circuits and proof serialization (prover/src/l2_circuit.rs:188,
  core/src/sequencer/settlement/prover.rs:304-334).
- ``from_be_bytes_mod_order`` / ``to_bytes_be``: big-endian, used by the MiMC
  account tree (core/src/sequencer/storage/account_tree.rs:188-204) and the
  on-chain verifier inputs (onchain_verifier/src/lib.rs:479-495).

The device compute path never touches these scalars one at a time — batched
limb arithmetic lives in :mod:`zelana_tpu_torch.ops.limbs`. This module is for witnesses,
golden tests and serialization glue.
"""

from __future__ import annotations


def inv_mod(a: int, p: int) -> int:
    """Modular inverse; raises ZeroDivisionError on a == 0 (mod p)."""
    a %= p
    if a == 0:
        raise ZeroDivisionError("inverse of zero")
    return pow(a, p - 2, p)


def legendre(a: int, p: int) -> int:
    """Legendre symbol: 1 if QR, -1 if non-residue, 0 if zero."""
    a %= p
    if a == 0:
        return 0
    ls = pow(a, (p - 1) // 2, p)
    return -1 if ls == p - 1 else 1


def sqrt_mod(a: int, p: int):
    """Tonelli-Shanks square root mod an odd prime. Returns None if no root."""
    a %= p
    if a == 0:
        return 0
    if legendre(a, p) != 1:
        return None
    if p % 4 == 3:
        return pow(a, (p + 1) // 4, p)
    # general Tonelli-Shanks
    q, s = p - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    z = 2
    while legendre(z, p) != -1:
        z += 1
    m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
    while t != 1:
        t2i = t
        i = 0
        for i in range(1, m):
            t2i = t2i * t2i % p
            if t2i == 1:
                break
        b = pow(c, 1 << (m - i - 1), p)
        m, c = i, b * b % p
        t = t * c % p
        r = r * b % p
    return r


def from_le_bytes_mod_order(data: bytes, p: int) -> int:
    return int.from_bytes(data, "little") % p


def from_be_bytes_mod_order(data: bytes, p: int) -> int:
    return int.from_bytes(data, "big") % p


def to_bytes_le(x: int, n: int = 32) -> bytes:
    return int(x).to_bytes(n, "little")


def to_bytes_be(x: int, n: int = 32) -> bytes:
    return int(x).to_bytes(n, "big")
