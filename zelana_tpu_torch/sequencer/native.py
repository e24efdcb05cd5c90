"""ctypes bindings for the native MiMC engine (csrc/mimc.cpp).

The sequencer's account tree hashes on the host, as the JAX package's does.
The library is built with g++ into the port's build directory at first use
(``zelana_tpu_torch/native.py``); a failed build raises. Where the JAX
package falls back to the pure-Python MiMC, the port has no fallback.

The library fills its round constants at its first hash behind a plain
flag, and ctypes drops the GIL, so two threads that hash first would race
on them. ``load`` therefore binds the library and runs that first hash
under one lock before any caller gets it.
"""

from __future__ import annotations

import ctypes
import functools
import threading

from .. import native

_C = ctypes.c_char_p
_LOCK = threading.Lock()


def load() -> ctypes.CDLL:
    """The MiMC library, built, bound and warmed once."""
    with _LOCK:
        return _bound()


@functools.lru_cache(maxsize=1)
def _bound() -> ctypes.CDLL:
    lib = native.load("mimc.cpp", "zelana_mimc")
    lib.zelana_mimc_hash_n.argtypes = [_C, ctypes.c_int, _C]
    lib.zelana_mimc_account_leaf.argtypes = [
        _C, ctypes.c_uint64, ctypes.c_uint64, _C]
    lib.zelana_mimc_merkle_root.argtypes = [_C, _C, _C, ctypes.c_int, _C]
    for fn in (lib.zelana_mimc_hash_n, lib.zelana_mimc_account_leaf,
               lib.zelana_mimc_merkle_root):
        fn.restype = None
    _warm(lib)
    return lib


def _warm(lib) -> None:
    """One hash, which fills the library's round constants."""
    lib.zelana_mimc_hash_n(bytes(32), 1, ctypes.create_string_buffer(32))


load.cache_clear = _bound.cache_clear


def hash_n_be(*values_be32: bytes) -> bytes:
    out = ctypes.create_string_buffer(32)
    load().zelana_mimc_hash_n(b"".join(values_be32), len(values_be32), out)
    return out.raw


def hash2_be(a: bytes, b: bytes) -> bytes:
    return hash_n_be(a, b)


def account_leaf_be(pubkey_be32: bytes, balance: int, nonce: int) -> bytes:
    out = ctypes.create_string_buffer(32)
    load().zelana_mimc_account_leaf(pubkey_be32, balance, nonce, out)
    return out.raw


def merkle_root_be(leaf: bytes, siblings: list, dirs: list) -> bytes:
    out = ctypes.create_string_buffer(32)
    load().zelana_mimc_merkle_root(
        leaf, b"".join(siblings), bytes(dirs), len(siblings), out)
    return out.raw
