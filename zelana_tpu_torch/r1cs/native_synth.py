"""ctypes binding for the native chunk-circuit synthesizer
(the repo's ``csrc/chunk_synth.cpp``, built by ``zelana_tpu_torch.native``
into ``build/zelana_tpu_torch/libzelana_chunk.so``).

Produces the same (A, B, C, z) system as running
circuits/batch_mimc.BatchCircuitMiMC.generate_constraints over the Python
ConstraintSystem, in CSR/numpy form and ~100x faster, which makes the
production 8/4/4 depth-32 chunk shape (~1.1M constraints) practical to prove
per batch. Also binds the stateless helpers of the prove and keygen host
paths: matvec, satisfaction check, QAP Lagrange accumulation, the keygen
scalar combines, the Montgomery batch encoder and the batch projective ->
affine conversion of keygen's query points.

A missing compiler or a failed build raises; there is no Python fallback.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np

from .. import native
from ..fields.bn254 import R as FR

_p = ctypes.c_void_p
_i64 = ctypes.c_int64


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    lib = native.load("chunk_synth.cpp", "zelana_chunk")
    lib.zelana_chunk_synth.argtypes = [_p] * 5 + [ctypes.c_int] * 4
    lib.zelana_chunk_synth.restype = _p
    lib.zelana_chunk_sizes.argtypes = [_p, _p]
    lib.zelana_chunk_export.argtypes = [_p] * 12
    lib.zelana_chunk_free.argtypes = [_p]
    lib.zelana_csr_matvec.argtypes = [
        _p, _p, _p, _p, _i64, _p, _i64, _i64, _p, ctypes.c_int32]
    lib.zelana_powers_scaled.argtypes = [_p, _p, _i64, _p]
    lib.zelana_from_mont_batch.argtypes = [_p, _i64, _p]
    lib.zelana_mont_encode_any.argtypes = [
        _p, _i64, _p, _p, ctypes.c_uint64, _p]
    lib.zelana_proj_affine_any.argtypes = [
        _p, _p, _p, _i64, _p, _p, ctypes.c_uint64, _p, _p]
    lib.zelana_proj_affine_fq2.argtypes = [
        _p, _p, _p, _i64, _p, _p, ctypes.c_uint64, _p, _p]
    lib.zelana_abc_combine.argtypes = [_p] * 6 + [_i64, _p]
    lib.zelana_csr_check.argtypes = [_p] * 10 + [_i64, _p, _i64, _i64]
    lib.zelana_csr_check.restype = _i64
    lib.zelana_qap_accumulate.argtypes = [
        _p, _p, _p, _p, _i64, _p, _i64, _i64, _p]
    lib.zelana_lagrange_at.argtypes = [_p, _p, _p, _i64, _p, _p]
    return lib


def fr_array(values) -> np.ndarray:
    """list of ints -> (n, 4) u64 canonical little-endian limbs."""
    n = len(values)
    buf = b"".join((int(v) % FR).to_bytes(32, "little") for v in values)
    return np.frombuffer(buf, dtype="<u8").reshape(n, 4).copy()


def fr_ints(arr: np.ndarray) -> list:
    """(n, 4) u64 limbs -> list of ints."""
    a = np.ascontiguousarray(arr, dtype=np.uint64)
    return [
        int(r[0]) | int(r[1]) << 64 | int(r[2]) << 128 | int(r[3]) << 192
        for r in a
    ]


def limbs16(arr: np.ndarray) -> np.ndarray:
    """(n, 4) u64 limbs -> (16, n) u32 16-bit limb planes (the JAX package's
    limb layout). Pure bit repacking."""
    a = np.ascontiguousarray(arr, dtype="<u8")
    return a.view("<u2").reshape(len(a), 16).T.astype(np.uint32)


def words32(arr: np.ndarray) -> np.ndarray:
    """(n, 4) u64 limbs -> (8, n) u32 words (ops/limbs.py layout). Pure bit
    repacking: the input must already be in the wanted domain."""
    a = np.ascontiguousarray(arr, dtype="<u8")
    return np.ascontiguousarray(a.view("<u4").reshape(len(a), 8).T)


@dataclass
class CsrMatrix:
    indptr: np.ndarray  # (rows+1,) i64
    indices: np.ndarray  # (nnz,) i32 global variable ids
    coeffs: np.ndarray  # (nnz,) i32 pool ids


class NativeSystem:
    """Synthesized R1CS in CSR/numpy form, with native helpers."""

    def __init__(self, lib, z, mats, pool, num_instance):
        self._lib = lib
        self.z = z  # (nvars, 4) u64 canonical
        self.A, self.B, self.C = mats
        self.pool = pool  # (npool, 4) u64 canonical
        self.num_instance = num_instance

    @property
    def num_constraints(self) -> int:
        return len(self.A.indptr) - 1

    @property
    def num_vars(self) -> int:
        return len(self.z)

    def instance_ints(self) -> list:
        return fr_ints(self.z[: self.num_instance])

    def check(self) -> int:
        """-1 if satisfied, else the first violated constraint row."""
        return int(self._lib.zelana_csr_check(
            *(m_.ctypes.data for m_ in (
                self.A.indptr, self.A.indices, self.A.coeffs,
                self.B.indptr, self.B.indices, self.B.coeffs,
                self.C.indptr, self.C.indices, self.C.coeffs,
                self.pool)),
            len(self.pool), self.z.ctypes.data, len(self.z),
            self.num_constraints,
        ))

    def matvec(self, which: str, mont: bool = False) -> np.ndarray:
        """M.z as (rows, 4) u64, canonical (or Montgomery with mont=True)."""
        m = {"A": self.A, "B": self.B, "C": self.C}[which]
        rows = self.num_constraints
        out = np.empty((rows, 4), np.uint64)
        self._lib.zelana_csr_matvec(
            m.indptr.ctypes.data, m.indices.ctypes.data,
            m.coeffs.ctypes.data, self.pool.ctypes.data, len(self.pool),
            self.z.ctypes.data, len(self.z), rows, out.ctypes.data,
            1 if mont else 0,
        )
        return out

    def qap_accumulate(self, which: str, u: np.ndarray) -> np.ndarray:
        """sum_r coeff[r,i] * u[r] per variable i, (num_vars, 4) u64."""
        m = {"A": self.A, "B": self.B, "C": self.C}[which]
        u = np.ascontiguousarray(u, dtype=np.uint64)
        out = np.zeros((self.num_vars, 4), np.uint64)
        self._lib.zelana_qap_accumulate(
            m.indptr.ctypes.data, m.indices.ctypes.data,
            m.coeffs.ctypes.data, self.pool.ctypes.data, len(self.pool),
            u.ctypes.data, self.num_constraints, self.num_vars,
            out.ctypes.data,
        )
        return out


def synthesize_chunk(circuit) -> NativeSystem:
    """Native synthesis of a circuits/batch_mimc.BatchCircuitMiMC instance."""
    lib = load()
    d = circuit.tree_depth
    transfers, withdrawals, shielded = circuit._pad()

    pub = fr_array([
        circuit.pre_state_root, circuit.post_state_root,
        circuit.pre_shielded_root, circuit.post_shielded_root,
        circuit.withdrawal_root, circuit.batch_hash, circuit.batch_id,
    ])

    tvals = []
    for t in transfers:
        tvals += [1 if t.is_valid else 0, t.sender_pubkey, t.sender_balance,
                  t.sender_nonce, t.receiver_pubkey, t.receiver_balance,
                  t.receiver_nonce, t.amount, t.signature]
        tvals += list(t.sender_path) + list(t.sender_path_indices)
        tvals += list(t.receiver_path) + list(t.receiver_path_indices)
    wvals = []
    for w in withdrawals:
        wvals += [1 if w.is_valid else 0, w.sender_pubkey, w.sender_balance,
                  w.sender_nonce, w.l1_recipient, w.amount, w.signature]
        wvals += list(w.sender_path) + list(w.sender_path_indices)
    svals = []
    for s in shielded:
        svals += [1 if s.is_valid else 0, 1 if s.skip_verification else 0,
                  s.input_owner, s.input_value, s.input_blinding,
                  s.input_position, s.spending_key, s.output_owner,
                  s.output_value, s.output_blinding, s.output_commitment,
                  s.nullifier]
        svals += list(s.input_path) + list(s.input_path_indices)
    finals = fr_array([circuit.num_transfers, circuit.num_withdrawals,
                       circuit.num_shielded])

    ta = fr_array(tvals) if tvals else np.zeros((0, 4), np.uint64)
    wa = fr_array(wvals) if wvals else np.zeros((0, 4), np.uint64)
    sa = fr_array(svals) if svals else np.zeros((0, 4), np.uint64)

    h = lib.zelana_chunk_synth(
        pub.ctypes.data, ta.ctypes.data, wa.ctypes.data, sa.ctypes.data,
        finals.ctypes.data, circuit.max_transfers, circuit.max_withdrawals,
        circuit.max_shielded, d,
    )
    if not h:
        raise RuntimeError("zelana_chunk_synth failed")
    try:
        sizes = np.zeros(7, np.int64)
        lib.zelana_chunk_sizes(h, sizes.ctypes.data)
        ni, nw, nc, nnza, nnzb, nnzc, npool = (int(x) for x in sizes)
        z = np.empty((ni + nw, 4), np.uint64)
        pool = np.empty((max(npool, 1), 4), np.uint64)

        def alloc(nnz):
            return (np.empty(nc + 1, np.int64), np.empty(nnz, np.int32),
                    np.empty(nnz, np.int32))

        aptr, aidx, acoe = alloc(nnza)
        bptr, bidx, bcoe = alloc(nnzb)
        cptr, cidx, ccoe = alloc(nnzc)
        lib.zelana_chunk_export(
            h, z.ctypes.data, aptr.ctypes.data, aidx.ctypes.data,
            acoe.ctypes.data, bptr.ctypes.data, bidx.ctypes.data,
            bcoe.ctypes.data, cptr.ctypes.data, cidx.ctypes.data,
            ccoe.ctypes.data, pool.ctypes.data,
        )
    finally:
        lib.zelana_chunk_free(h)
    pool = pool[:npool]
    return NativeSystem(
        lib, z,
        (CsrMatrix(aptr, aidx, acoe), CsrMatrix(bptr, bidx, bcoe),
         CsrMatrix(cptr, cidx, ccoe)),
        pool, ni,
    )


def from_mont_limbs16(arr: np.ndarray) -> np.ndarray:
    """(16, n) u32 Montgomery limb planes -> (n, 4) u64 canonical."""
    n = arr.shape[1]
    u64s = np.ascontiguousarray(
        arr.T.astype(np.uint16)).view("<u8").reshape(n, 4).copy()
    load().zelana_from_mont_batch(u64s.ctypes.data, n, u64s.ctypes.data)
    return u64s


def from_mont_words(words: np.ndarray) -> np.ndarray:
    """(8, n) u32 Montgomery words (Fr) -> (n, 4) u64 canonical."""
    n = words.shape[1]
    u64s = np.ascontiguousarray(
        np.asarray(words, np.uint32).T).view("<u8").reshape(n, 4).copy()
    load().zelana_from_mont_batch(u64s.ctypes.data, n, u64s.ctypes.data)
    return u64s


def powers_scaled(t: int, scale: int, m: int) -> np.ndarray:
    """out[j] = scale * t^j for j < m, (m, 4) u64 canonical."""
    tv = fr_array([t])
    sv = fr_array([scale])
    out = np.empty((m, 4), np.uint64)
    load().zelana_powers_scaled(tv.ctypes.data, sv.ctypes.data, m,
                                out.ctypes.data)
    return out


def abc_combine(a: np.ndarray, b: np.ndarray, c: np.ndarray, beta: int,
                alpha: int, scale: int) -> np.ndarray:
    """out[i] = (beta*a[i] + alpha*b[i] + c[i]) * scale, canonical."""
    n = len(a)
    bv = fr_array([beta])
    av = fr_array([alpha])
    sv = fr_array([scale])
    a = np.ascontiguousarray(a, dtype=np.uint64)
    b = np.ascontiguousarray(b, dtype=np.uint64)
    c = np.ascontiguousarray(c, dtype=np.uint64)
    out = np.empty((n, 4), np.uint64)
    load().zelana_abc_combine(a.ctypes.data, b.ctypes.data, c.ctypes.data,
                              bv.ctypes.data, av.ctypes.data, sv.ctypes.data,
                              n, out.ctypes.data)
    return out


def lagrange_at(group_gen: int, size_inv: int, t: int, m: int):
    """Native Lagrange coefficients u_r(t) over the radix-2 domain.
    Returns ((m, 4) u64 canonical, Z(t) int)."""
    g = fr_array([group_gen])
    mi = fr_array([size_inv])
    tv = fr_array([t])
    u = np.empty((m, 4), np.uint64)
    zt = np.empty((1, 4), np.uint64)
    load().zelana_lagrange_at(g.ctypes.data, mi.ctypes.data, tv.ctypes.data,
                              m, u.ctypes.data, zt.ctypes.data)
    return u, fr_ints(zt)[0]


def _modulus_args(modulus: int):
    mod = np.frombuffer(int(modulus).to_bytes(32, "little"), "<u8").copy()
    r2 = np.frombuffer(int(pow(2, 512, modulus)).to_bytes(32, "little"),
                       "<u8").copy()
    inv64 = ctypes.c_uint64((-pow(modulus, -1, 1 << 64)) % (1 << 64))
    return mod, r2, inv64


def mont_encode(vals: np.ndarray, modulus: int) -> np.ndarray:
    """(n, 4) u64 values below 2^256 -> (n, 4) u64 of their Montgomery forms
    v * 2^256 mod `modulus` (any odd modulus below 2^255)."""
    vals = np.ascontiguousarray(vals, dtype=np.uint64)
    mod, r2, inv64 = _modulus_args(modulus)
    out = np.empty((len(vals), 4), np.uint64)
    load().zelana_mont_encode_any(vals.ctypes.data, len(vals), mod.ctypes.data,
                                  r2.ctypes.data, inv64, out.ctypes.data)
    return out


def proj_to_affine(xs: np.ndarray, ys: np.ndarray, zs: np.ndarray,
                   modulus: int, fq2: bool):
    """Batch projective -> affine with one inversion. Inputs: Montgomery
    (n, 4) u64 coordinates (G1) or (n, 8) u64 (G2, c0 then c1). Returns
    ((n, 8) or (n, 16) u64 canonical affine [x | y], (n,) bool infinity
    mask); the infinity rows are zero."""
    n = len(zs)
    xs, ys, zs = (np.ascontiguousarray(a, dtype=np.uint64)
                  for a in (xs, ys, zs))
    mod, r2, inv64 = _modulus_args(modulus)
    out = np.empty((n, 16 if fq2 else 8), np.uint64)
    inf = np.empty(n, np.uint8)
    fn = (load().zelana_proj_affine_fq2 if fq2
          else load().zelana_proj_affine_any)
    fn(xs.ctypes.data, ys.ctypes.data, zs.ctypes.data, n, mod.ctypes.data,
       r2.ctypes.data, inv64, out.ctypes.data, inf.ctypes.data)
    return out, inf.astype(bool)
