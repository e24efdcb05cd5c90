"""ctypes binding for the native run-scan scheduler.

The C++ source is the repo's ``csrc/scan_sched.cpp``, built by
``zelana_tpu_torch.native`` into ``build/zelana_tpu_torch/libzelana_sched.so``.
Without a C++ compiler this raises: the port has no numpy scheduler.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from .. import native


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    lib = native.load("scan_sched.cpp", "zelana_sched")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.zelana_build_scan_schedule2.argtypes = [
        p, i, i, i, i, i, i, i, i, p, p, p, p, i, p]
    lib.zelana_build_scan_schedule2.restype = ctypes.c_int
    return lib


def build_schedule_arrays2(digits: np.ndarray, nb: int, lanes: int, R: int,
                           lanes2: int, kmax: int = 64):
    """Two-level run-scan schedule. Returns (pid u16 (R+1, lanes), flag_bits
    u32 (R+1, lanes/32), pos2 i32 (R2+1, lanes2), dense_idx2 i32 (K2, w*nb)).
    pos2 holds positions into the level-1 emit buffer, run flag in bit 31."""
    w, n = digits.shape
    digits_c = np.ascontiguousarray(digits, dtype=np.int32)
    perm = np.empty((R + 1, lanes), np.uint16)
    flag_bits = np.zeros((R + 1, lanes // 32), np.uint32)
    # level-2 stream bound: one partial per bucket plus one per level-1
    # lane-boundary crossing
    bound = w * nb + lanes + lanes2
    r2cap = -(-bound // lanes2) + 1
    pos2 = np.zeros((r2cap + 1, lanes2), np.int32)
    dense2 = np.zeros((kmax, w * nb), np.int32)
    meta = np.zeros(2, np.int64)
    rc = load().zelana_build_scan_schedule2(
        digits_c.ctypes.data, w, n, nb, lanes, R, 0, lanes2, r2cap,
        perm.ctypes.data, flag_bits.ctypes.data, pos2.ctypes.data,
        dense2.ctypes.data, kmax, meta.ctypes.data)
    if rc != 0:
        raise RuntimeError(f"zelana_build_scan_schedule2 failed (code {rc})")
    K2, R2 = int(meta[0]), int(meta[1])
    return perm, flag_bits, pos2[:R2 + 1], dense2[:K2]
