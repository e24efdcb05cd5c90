"""Phase timestamps of a prove or a keygen.

``phase_log_start()`` opens a log for the calling thread and
``phase_log_take()`` closes it and returns its entries, so a tool reports
the phases of the same run as its headline number. While a log is open it
collects one (abs_time, seconds since the phase origin, label, thread
name) entry from every ``trace`` call, on any thread: a log taken while
two proves ran holds both, and a reader splits them by thread. Several
threads may hold open logs at once; opening one leaves the others as they
are. With ``ZELANA_PROVE_TRACE=1`` each phase is printed on stderr too.
Off, a ``trace`` call is one comparison.
"""

from __future__ import annotations

import os
import sys
import threading
import time

_LOGS: dict = {}  # thread ident -> the log that thread opened
_LOCK = threading.Lock()


def phase_log_start() -> None:
    with _LOCK:
        _LOGS[threading.get_ident()] = []


def phase_log_take() -> list:
    with _LOCK:
        return _LOGS.pop(threading.get_ident(), None) or []


def trace(label: str, t0) -> None:
    """Record `label` at +(now - t0) seconds; t0 None records nothing."""
    if t0 is None:
        return
    now = time.time()
    if _LOGS:
        entry = (round(now, 3), round(now - t0, 3), label,
                 threading.current_thread().name)
        with _LOCK:
            for log in _LOGS.values():
                log.append(entry)
    if os.environ.get("ZELANA_PROVE_TRACE") == "1":
        print(f"    [+{now - t0:7.1f}s] {label}", file=sys.stderr, flush=True)
