"""The port's field layer (zelana_tpu_torch.ops.limbs, field_kernels) against
the JAX package's ops/limbs on the CPU: same inputs from a numpy seed, exact
equality (integers: no tolerance)."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zelana_tpu_torch
from zelana_tpu.ops import limbs as JL
from zelana_tpu_torch.fields.bn254 import P, R
from zelana_tpu_torch.ops import field_kernels as FK
from zelana_tpu_torch.ops import limbs as TL

SPECS = [(JL.FQ, TL.FQ), (JL.FR, TL.FR), (JL.BLS_FR, TL.BLS_FR)]
IDS = ["Fq", "Fr", "BLS12-381 Fr"]


def _values(seed: int, n: int, modulus: int) -> list:
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % modulus
            for _ in range(n)]
    vals[:3] = [0, 1, modulus - 1]
    return vals


def _words(limbs16) -> torch.Tensor:
    return TL.to_tensor(TL.words_from_limbs16(np.asarray(limbs16)), "cpu")


@pytest.mark.parametrize("specs", SPECS, ids=IDS)
def test_encode_decode_match_jax(specs):
    jspec, tspec = specs
    vals = _values(1, 300, jspec.modulus)
    j16 = JL.encode_mont(vals, jspec)
    words = TL.encode_mont(vals, tspec)
    assert (words == TL.words_from_limbs16(j16)).all()
    assert (TL.limbs16_from_words(words) == j16).all()
    assert TL.decode_mont(words, tspec) == JL.decode_mont(j16, jspec) == vals
    assert TL.from_words(TL.to_words(vals)) == vals
    t = TL.to_tensor(words, "cpu")
    assert t.dtype == torch.int32 and tuple(t.shape) == (8, 300)
    assert (TL.to_numpy(t) == words).all()
    assert (TL.pack(TL.unpack(t)) == t).all()


@pytest.mark.parametrize("specs", SPECS, ids=IDS)
def test_add_sub_match_jax(specs):
    jspec, tspec = specs
    a = _values(2, 257, jspec.modulus)
    b = _values(3, 257, jspec.modulus)[::-1]
    ja, jb = (jnp.asarray(JL.encode_mont(v, jspec)) for v in (a, b))
    ta, tb = _words(ja), _words(jb)
    for jf, tf in ((JL.add, TL.add), (JL.sub, TL.sub)):
        want = TL.words_from_limbs16(np.asarray(jf(ja, jb, jspec)))
        assert (TL.to_numpy(tf(ta, tb, tspec)) == want).all()


@pytest.mark.parametrize("specs", SPECS, ids=IDS)
def test_mont_mul_matches_jax(specs):
    jspec, tspec = specs
    a = _values(4, 1000, jspec.modulus)
    b = _values(5, 1000, jspec.modulus)[::-1]
    ja, jb = (jnp.asarray(JL.encode_mont(v, jspec)) for v in (a, b))
    want = TL.words_from_limbs16(np.asarray(JL.mont_mul(ja, jb, jspec)))
    got = FK.mont_mul(_words(ja), _words(jb), tspec)
    assert (TL.to_numpy(got) == want).all()
    assert TL.decode_mont(TL.to_numpy(got), tspec) == [
        x * y % jspec.modulus for x, y in zip(a, b)]


def test_butterfly_matches_jax_stage():
    """One DIT stage: (a + w*b, a - w*b) against the JAX field ops."""
    a, b, w = (jnp.asarray(JL.encode_mont(_values(s, 512, R), JL.FR))
               for s in (6, 7, 8))
    bt = JL.mont_mul(b, w, JL.FR)
    even = TL.words_from_limbs16(np.asarray(JL.add(a, bt, JL.FR)))
    odd = TL.words_from_limbs16(np.asarray(JL.sub(a, bt, JL.FR)))
    ge, go = FK.butterfly(_words(a), _words(b), _words(w), TL.FR)
    assert (TL.to_numpy(ge) == even).all()
    assert (TL.to_numpy(go) == odd).all()


def test_wrappers_raise_off_cpu_without_cuda():
    """A tensor that is not on the CPU never reaches the plain version: the
    wrapper wants contiguous int32 CUDA tensors, else it raises."""
    meta = torch.empty((8, 256), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        FK.mont_mul(meta, meta, TL.FR)
    with pytest.raises(ValueError):
        FK.butterfly(meta, meta, meta, TL.FR)
    with pytest.raises(ValueError):
        FK.mimc_permute(meta, meta[:, :3].T, TL.FR)
    with pytest.raises(ValueError):
        FK.inv_fwd(meta[:, :1].expand(8, 1024), TL.FR)
    with pytest.raises(ValueError):
        FK.inv_bwd(meta, meta, meta, TL.FR)
    with pytest.raises(ValueError):
        FK.fermat(meta, TL.FR)


def _cuh_arrays(name: str) -> list:
    path = os.path.join(os.path.dirname(zelana_tpu_torch.__file__), "csrc",
                        "field.cuh")
    with open(path) as f:
        src = f.read()
    body = re.search(name + r"[^=]*=\s*(\{.*?\});", src, re.S).group(1)
    return [int(x, 16) for x in re.findall(r"0x([0-9a-f]+)u", body)]


def test_cuda_constants_match():
    """The constants compiled into csrc/field.cuh are those of BN254 Fq and
    Fr and BLS12-381 Fr, in the order of field_kernels._FIELD_ID."""
    from zelana_tpu_torch.fields import tower as tw

    def words(x):
        return [(x >> (32 * i)) & 0xFFFFFFFF for i in range(8)]

    mods = sorted(FK._FIELD_ID, key=FK._FIELD_ID.get)
    assert mods == [P, R, TL.BLS_FR.modulus]
    assert _cuh_arrays("kP") == sum((words(m) for m in mods), [])
    assert _cuh_arrays("kN0") == [(-pow(m, -1, 1 << 32)) % (1 << 32)
                                  for m in mods]
    assert _cuh_arrays("kOne") == sum((words((1 << 256) % m) for m in mods),
                                      [])
    assert _cuh_arrays("kOne") == sum(
        (TL.FieldSpec(m).one_mont.tolist() for m in mods), [])
    inv = tw.fq2_inv((9, 1))
    b3 = [9 * c % P * (1 << 256) % P for c in inv]
    assert _cuh_arrays("kB3G2") == words(b3[0]) + words(b3[1])
