"""Host C++ libraries of the port: the repo's ``csrc/*.cpp`` sources compiled
with g++ into ``build/zelana_tpu_torch/`` at first use (a library newer than
its source is reused) and loaded with ctypes. Nothing is written beside the
sources. Without a C++ compiler, or when a build fails, this raises: the
port has no Python fallback for what these libraries do.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

from .ops.cuda import BUILD, ROOT

_LIBS: dict = {}
_LOCK = threading.Lock()


def load(source: str, name: str) -> ctypes.CDLL:
    """The library `name` built from ``csrc/<source>`` (loaded once)."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        src = os.path.join(ROOT, "csrc", source)
        lib = os.path.join(BUILD, f"lib{name}.so")
        if not os.path.exists(lib) or os.path.getmtime(lib) < os.path.getmtime(
                src):
            os.makedirs(BUILD, exist_ok=True)
            tmp = f"{lib}.tmp{os.getpid()}"
            out = subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, src],
                capture_output=True, text=True)
            if out.returncode != 0:
                raise RuntimeError(f"g++ failed for {source}:\n{out.stderr}")
            os.replace(tmp, lib)
        _LIBS[name] = ctypes.CDLL(lib)
        return _LIBS[name]
