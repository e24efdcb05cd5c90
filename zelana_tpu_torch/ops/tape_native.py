"""ctypes binding of the native MSM tape builder (csrc/msm_tape.cpp).

The library is built with g++ into build/zelana_tpu_torch/ at first use
(``native.load``). A failed build, or a tape that exceeds its step bound,
raises: the port has no numpy builder. The JAX package's numpy fallback
pairs equal keys differently, so only the native builder gives tapes equal
to the JAX package's.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .. import native


def load() -> ctypes.CDLL:
    lib = native.load("msm_tape.cpp", "zelana_tape")
    lib.zelana_build_tape.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.zelana_build_tape.restype = ctypes.c_int
    return lib


def build_tape_arrays(digits: np.ndarray, n_buckets: int, window_bits: int,
                      S: int, a0: int):
    """Run the native builder; returns (idx, finals, steps, mixed, base):
    the (steps, 2, S) int32 slot ids, the window_bits * W finals, the step
    counts and the first slot past the tape."""
    lib = load()
    w, n = digits.shape
    max_steps = (w * n + w * window_bits * n_buckets // 2) // S + 96
    digits_c = np.ascontiguousarray(digits, dtype=np.int32)
    idx = np.empty((max_steps, 2, S), np.int32)
    finals = np.empty(window_bits * w, np.int32)
    meta = np.empty(3, np.int64)
    rc = lib.zelana_build_tape(
        digits_c.ctypes.data, w, n, n_buckets, window_bits, S, a0,
        idx.ctypes.data, max_steps, finals.ctypes.data, meta.ctypes.data,
    )
    if rc != 0:
        raise RuntimeError(f"zelana_build_tape failed (rc {rc}): the tape "
                           f"of a ({w}, {n}) digit matrix exceeds "
                           f"{max_steps} steps of {S}")
    steps, mixed, base = (int(v) for v in meta)
    return idx[:steps], finals, steps, mixed, base
