"""Tape MSM: host-scheduled bucket pair-reduction run as a tape of
slot-pool steps on the card.

The JAX package's fast Pippenger MSM (zelana_tpu/ops/msm_fast.py), over the
port's step kernel:

1. Scalars decompose into W = 32 windows of 8-bit digits (host).
2. The native builder (csrc/msm_tape.cpp, ops/tape_native.py) schedules
   every addition: the points of each (window, digit) bucket are
   pair-reduced, then the buckets whose digit has bit t set are summed per
   (t, window), all as a tape of uniform steps of S (slot a, slot b) pairs.
   Step t writes its S sums to pool slots [a0 + t S, a0 + (t + 1) S) and
   reads only slots written before it.
3. The card runs the tape: one ``curve_kernels.step`` launch a step
   (``rounds=1``: a tape step pairs arbitrary slots, not a tree), the 9-product
   mixed add of two affine operands over the first ``mixed_steps`` steps
   (bucket round 0 pairs original points only), the complete projective add
   after. The pool is one words-first (C, total_slots) tensor: slot 0 holds
   the identity (0 : one : 0), input point i slot i + 1 with Z = one.
4. The 256 bit-subset sums (``pool[:, finals]``, group t * 32 + w) go to
   the host, where msm_scan._finish_host runs the bit and window Horner in
   Jacobian big ints with one inversion.

The tape goes to the card as one pinned copy per MSM (its two index planes
and the finals). The JAX package's byte packing of it (``_pack_tape``,
``_decode_tape``) served a TPU relay's per-transfer cost and has no
counterpart here, nor has its numpy tape builder.

Reference counterpart: the rayon-parallel MSMs inside ark-groth16's
`Groth16::prove` (invoked at core/src/sequencer/settlement/prover.rs:408).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import curve_kernels as CK
from . import curve_ops as CO
from . import limbs as L
from . import msm_scan, staging, tape_native
from .msm import N_BUCKETS, N_WINDOWS, WINDOW_BITS

ROWS = 8  # the JAX kernel's sublane rows; S and slot bases align to ROWS*128
ALIGN = ROWS * 128


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclass
class Tape:
    idx: np.ndarray  # (steps, 2, S) int32 slot ids; slot 0 = identity
    S: int
    a0: int  # first output slot; step t writes slots [a0 + t*S, a0 + (t+1)*S)
    total_slots: int  # pool width (power of two)
    finals: np.ndarray  # (WINDOW_BITS * N_WINDOWS,) int32 bit-subset slots
    n_points: int
    mixed_steps: int  # tape prefix whose operand pairs are ALL original
    # input points (Z = 1): bucket round 0, run by the mixed add


def _step_size(n_points: int) -> int:
    """Uniform step width: a function of the MSM size only, balancing the
    per-step fixed cost against padding waste on the small tail rounds."""
    lanes = N_WINDOWS * n_points
    s = 1024
    while s < 8192 and s * 48 < lanes:
        s *= 2
    return s


def build_tape(digits: np.ndarray) -> Tape:
    """digits: (W, N) int32. Input point i lives at slot i + 1; slot 0 is
    the identity. Returns the uniform-step addition tape (native builder;
    it raises where the build or the tape fails)."""
    w, n = digits.shape
    S = _step_size(n)
    a0 = _round_up(n + 1, ALIGN)
    idx, finals, _steps, mixed, base = tape_native.build_tape_arrays(
        digits, N_BUCKETS, WINDOW_BITS, S, a0)
    total = 1 << (base - 1).bit_length()
    return Tape(idx=idx, S=S, a0=a0, total_slots=total, finals=finals,
                n_points=n, mixed_steps=mixed)


def _upload_tape(tape: Tape, device: torch.device):
    """The tape's index planes and finals in one copy: ((steps, 2, S)
    slot ids, finals) on `device`."""
    buf = staging.upload(np.concatenate([tape.idx.reshape(-1),
                                         tape.finals]), device)
    idx = buf[:tape.idx.size].view(tape.idx.shape)
    return idx, buf[tape.idx.size:]


def _pool(affine: torch.Tensor, tape: Tape, curve: str) -> torch.Tensor:
    """The (C, total_slots) slot pool: the identity at slot 0, the (VC, n)
    affine points at slots 1..n with Z = one, zeros elsewhere."""
    C, VC, n = CK.rows(curve), CK.rows(curve, False), affine.shape[1]
    pool = torch.zeros((C, tape.total_slots), dtype=torch.int32,
                       device=affine.device)
    ident = CO.ident_words(curve, 1, affine.device)
    pool[:, :1] = ident
    pool[:VC, 1:n + 1] = affine
    pool[VC:VC + L.NWORDS, 1:n + 1] = ident[C // 3:C // 3 + L.NWORDS]
    return pool


def run_tape(affine: torch.Tensor, tape: Tape, curve: str) -> torch.Tensor:
    """affine: (VC, n) Montgomery words of the input points -> (C, 256)
    projective words of the bit-subset sums, group t * 32 + w."""
    pool = _pool(affine, tape, curve)
    idx, finals = _upload_tape(tape, pool.device)
    S, a0 = tape.S, tape.a0
    for t in range(tape.idx.shape[0]):
        CK.step(pool, a0 + t * S, S, curve, idx[t, 0], idx[t, 1],
                read_hi=a0 + t * S, mixed=t < tape.mixed_steps)
    return pool.index_select(1, finals)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


# device-resident point sets: reuse one across MSMs with the same basis
prepare_g1 = msm_scan.prepare_g1
prepare_g2 = msm_scan.prepare_g2


def msm_begin(prepared, scalars, curve: str, digits: np.ndarray = None):
    """Build and upload the tape and queue its steps (asynchronous on the
    card); returns a handle for msm_end. `digits` optionally supplies a
    precomputed msm_scan.scalar_digits matrix. Identity points get zero
    digits, so the tape never reads their slots."""
    pool, inf, _curve = prepared
    if digits is None:
        digits = msm_scan.scalar_digits(scalars, inf)
    elif inf is not None and inf.any():
        digits = digits.copy()
        digits[:, inf] = 0
    return (staging.download(run_tape(pool, build_tape(digits), curve)),
            curve)


def msm_end(handle):
    """Wait for the bit-subset sums and run the host Horner tail."""
    finals, curve = handle
    return msm_scan._finish_host(staging.fetch(finals), curve)


def _msm(prepared, scalars, curve: str):
    return msm_end(msm_begin(prepared, scalars, curve))


def msm_g1_prepared(prepared, scalars):
    return _msm(prepared, scalars, "g1")


def msm_g2_prepared(prepared, scalars):
    return _msm(prepared, scalars, "g2")


def msm_g1(points, scalars, device="cuda"):
    if not points:
        return None
    return msm_g1_prepared(prepare_g1(points, device), scalars)


def msm_g2(points, scalars, device="cuda"):
    if not points:
        return None
    return msm_g2_prepared(prepare_g2(points, device), scalars)
