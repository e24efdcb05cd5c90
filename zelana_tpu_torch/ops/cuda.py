"""Build, load and count the port's CUDA kernels.

Every kernel source in ``zelana_tpu_torch/csrc/*.cu`` compiles with nvcc for
``sm_90a`` into its own shared library with a plain C interface, loaded with
ctypes. The build runs at first use, one nvcc process per source, all started
together, into ``build/zelana_tpu_torch/`` at the repo root; a library newer
than every source is reused. Nothing here runs when a module is imported:
the CPU tests import every module on machines with no nvcc.

``LAUNCHES`` counts, per kernel, the launches the wrappers made; a wrapper
calls ``count`` where it launches its kernel and nowhere else. Proves on
several threads launch at once, so ``count`` adds under a lock.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time

import torch

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PKG)  # the repo checkout
CSRC = os.path.join(PKG, "csrc")
BUILD = os.path.join(ROOT, "build", "zelana_tpu_torch")
SOURCES = ("field_kernels", "curve_kernels", "ntt_kernels", "jac_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES = {"mont_mul": 0, "ntt_pass": 0, "ntt_cross": 0, "runscan": 0,
            "bucket_tail": 0, "step": 0, "mimc_permute": 0, "poseidon": 0,
            "inv_fwd": 0, "inv_bwd": 0, "inv_base": 0, "jac_add": 0,
            "jac_scan": 0, "jac_reduce": 0, "jac_horner": 0}
BUILD_LOG: dict = {}  # source -> {"seconds": s, "ptxas": text}

_LIBS: dict = {}
_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def count(name: str) -> None:
    """Add one launch of kernel `name` to LAUNCHES."""
    with _COUNT_LOCK:
        LAUNCHES[name] += 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = shutil.which("nvcc") or (
        os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None)
    if not cand or not os.path.exists(cand):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return cand


def _stale(lib: str) -> bool:
    if not os.path.exists(lib):
        return True
    newest = max(os.path.getmtime(f) for f in
                 glob.glob(os.path.join(CSRC, "*.cu*")))
    return os.path.getmtime(lib) < newest


def build_all() -> dict:
    """Build every stale kernel library in parallel; returns BUILD_LOG."""
    os.makedirs(BUILD, exist_ok=True)
    procs = {}
    for name in SOURCES:
        lib = os.path.join(BUILD, f"lib{name}.so")
        if not _stale(lib):
            continue
        tmp = f"{lib}.tmp{os.getpid()}"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib, time.time())
    failed = []
    for name, (proc, tmp, lib, t0) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOG[name] = {"seconds": time.time() - t0, "ptxas": out}
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return BUILD_LOG


def lib(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed."""
    with _LOCK:
        if name not in _LIBS:
            build_all()
            cdll = ctypes.CDLL(os.path.join(BUILD, f"lib{name}.so"))
            _declare(cdll)
            _LIBS[name] = cdll
        return _LIBS[name]


def _declare(cdll) -> None:
    p, i, l = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    sigs = {
        "zt_mont_mul": [i, p, p, p, l, p],
        "zt_ntt_pass": [p, p, p, p, p, p, p, p, p, l, i, i, i, i, p],
        "zt_ntt_cross": [p, p, p, l, l, p, l, i, p, p],
        "zt_runscan": [i, i, p, p, p, p, i, i, l, p],
        "zt_bucket_merge": [i, p, l, p, i, i, p, p],
        "zt_bucket_tree": [i, p, i, p, p],
        "zt_step": [i, i, p, p, p, l, l, l, l, i, p],
        "zt_mimc_permute": [p, p, p, l, i, p],
        "zt_poseidon": [i, p, i, p, p, l, p, i, i, p],
        "zt_inv_fwd": [i, p, p, p, l, i, p],
        "zt_inv_bwd": [i, p, p, p, p, l, i, p],
        "zt_inv_base": [i, p, p, l, p],
        "zt_inv_scan_below": [i],
        "zt_jac_add": [i, p, l, p, l, p, l, p],
        "zt_jac_scan": [i, p, p, p, l, i, p],
        "zt_jac_reduce": [i, p, l, p, i, p, l, p],
        "zt_jac_horner": [i, p, l, i, p, p],
    }
    for fn, args in sigs.items():
        if hasattr(cdll, fn):
            getattr(cdll, fn).argtypes = args
            getattr(cdll, fn).restype = ctypes.c_int


def check(tensors, shapes, what: str) -> torch.device:
    """Raise unless every tensor is a contiguous int32 CUDA tensor of the
    given shape on one device; returns that device."""
    dev = tensors[0].device
    for t, shape in zip(tensors, shapes):
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{what}: all operands must be on one CUDA "
                             f"device, got {t.device} and {dev}")
        if t.dtype != torch.int32:
            raise TypeError(f"{what}: expected int32 words, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: shape {tuple(t.shape)}, expected "
                             f"{tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous")
    return dev


def launch(name: str, fn: str, *args, device: torch.device) -> None:
    """Call launcher `fn` of library `name` on `device`'s current stream;
    raise on a non-zero cudaGetLastError()."""
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = getattr(lib(name), fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA error {rc}")
