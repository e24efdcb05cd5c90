"""Phase timestamps of a prove or a keygen.

``phase_log_start()`` begins collecting (abs_time, seconds since the phase
origin, label) triples from every ``trace`` call, and ``phase_log_take()``
returns them, so a tool reports the phases of the same run as its headline
number. With ``ZELANA_PROVE_TRACE=1`` each phase is printed on stderr too.
Off, a ``trace`` call is one comparison.
"""

from __future__ import annotations

import os
import sys
import time

_PHASE_LOG = None


def phase_log_start() -> None:
    global _PHASE_LOG
    _PHASE_LOG = []


def phase_log_take() -> list:
    global _PHASE_LOG
    out, _PHASE_LOG = _PHASE_LOG, None
    return out or []


def trace(label: str, t0) -> None:
    """Record `label` at +(now - t0) seconds; t0 None records nothing."""
    if t0 is None:
        return
    now = time.time()
    if _PHASE_LOG is not None:
        _PHASE_LOG.append((round(now, 3), round(now - t0, 3), label))
    if os.environ.get("ZELANA_PROVE_TRACE") == "1":
        print(f"    [+{now - t0:7.1f}s] {label}", file=sys.stderr, flush=True)
