"""The port's Poseidon permutation and sponge, the plain versions of the
Poseidon kernel (zelana_tpu_torch.ops.field_kernels poseidon_permute_plain
and poseidon_sponge_plain, and hashes.poseidon_batch over them), against
the JAX package's poseidon_jax on the CPU and the host sponge, in every
configuration the reference uses: BN254 Fr 8/56 and 8/57, BLS12-381 Fr
8/57. Sponges over 1, 2, 3 and 5 columns (three columns and more take more
than one permutation) and the bare permutation; inputs from a numpy seed
with 0, 1 and p - 1 among them. Tolerance: bit-equal (field elements; every
word must match). The kernel itself is held to these plain versions in
tests/test_torch_cuda_emulation.py and on the card by chip_smoke.py."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zelana_tpu.hashes import poseidon as JP
from zelana_tpu.hashes import poseidon_jax
from zelana_tpu.ops import limbs as JL
from zelana_tpu_torch.hashes import poseidon as TP
from zelana_tpu_torch.hashes import poseidon_batch as PB
from zelana_tpu_torch.ops import field_kernels as FK
from zelana_tpu_torch.ops import limbs as TL

torch.set_num_threads(1)  # many small int64 ops: threads only contend

CONFIGS = {"bn254_8_56": "bn254_config", "bn254_8_57": "bn254_config_57",
           "bls12_381_8_57": "bls12_381_config"}
N = 6  # elements a column
KS = (1, 2, 3, 5)


def _values(seed: int, modulus: int) -> list:
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % modulus
            for _ in range(N)]
    vals[:3] = [0, 1, modulus - 1]
    return vals


@functools.lru_cache(maxsize=None)
def _case(name: str):
    """One configuration's inputs and JAX results, made once per module:
    5 columns and a 3-lane state of N elements each (seeded; the edges 0,
    1 and p - 1 in the first three elements), the JAX sponge over the
    first k columns for each k in KS and the JAX permutation of the
    state."""
    jcfg = getattr(JP, CONFIGS[name])()
    tcfg = getattr(TP, CONFIGS[name])()
    jspec, tspec = JL.FieldSpec(jcfg.modulus), TL.FieldSpec(tcfg.modulus)
    vals = [_values(40 + 3 * i + len(name), jcfg.modulus) for i in range(8)]
    j16 = [JL.encode_mont(v, jspec) for v in vals]  # (16, N) each
    jax_hash = {k: np.asarray(poseidon_jax.poseidon_hash_batch(
        jcfg, [jnp.asarray(c) for c in j16[:k]])) for k in KS}
    jax_perm = np.asarray(poseidon_jax.poseidon_permute_batch(
        jnp.asarray(np.stack(j16[5:])), jcfg))
    words = [TL.to_tensor(TL.words_from_limbs16(c), "cpu") for c in j16]
    return tcfg, tspec, vals, words, jax_hash, jax_perm


def _consts(cfg):
    return PB._device_tables(cfg, torch.device("cpu"))


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_plain_sponge_matches_jax(name, k):
    """poseidon_hash_batch over the first k columns on the CPU (the
    wrapper's plain version, poseidon_sponge_plain) equal to the JAX
    poseidon_hash_batch word for word and to the host sponge's
    poseidon_hash on every row."""
    cfg, spec, vals, words, jax_hash, _ = _case(name)
    got = PB.poseidon_hash_batch(cfg, words[:k])
    assert (TL.to_numpy(got) == TL.words_from_limbs16(jax_hash[k])).all()
    rows = list(zip(*vals[:k]))
    assert TL.decode_mont(TL.to_numpy(got), spec) == [
        TP.poseidon_hash(cfg, list(r)) for r in rows]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_plain_permute_matches_jax(name):
    """poseidon_permute_batch on the CPU (poseidon_permute_plain) of a
    (3, 8, 2, 3) state, the batch dims kept, equal to the JAX permutation
    of the same (3, 8, N) state word for word and to the host permute on
    every element."""
    cfg, spec, vals, words, _, jax_perm = _case(name)
    batched = PB.poseidon_permute_batch(
        torch.stack(words[5:]).reshape(3, 8, 2, 3), cfg)
    assert batched.shape == (3, 8, 2, 3)
    got = batched.reshape(3, 8, N)
    want = np.stack([TL.words_from_limbs16(jax_perm[i]) for i in range(3)])
    assert (TL.to_numpy(got) == want).all()
    host = [TP.permute([vals[5 + l][e] for l in range(3)], cfg)
            for e in range(N)]
    lanes = [TL.decode_mont(TL.to_numpy(got[l]), spec) for l in range(3)]
    assert [list(t) for t in zip(*lanes)] == host


def test_poseidon_refusals():
    """The sponge takes 1 to 16 columns (the kernel's cap) on every device;
    an odd count of full rounds and a configuration of another width or
    alpha are refused before any work."""
    cfg, spec, _, words, _, _ = _case("bn254_8_56")
    consts = _consts(cfg)
    for cols in ([], words[:1] * (FK.POSEIDON_MAX_COLS + 1)):
        with pytest.raises(ValueError):
            FK.poseidon_sponge(cols, consts, 8, 56, spec)
    with pytest.raises(ValueError):
        FK.poseidon_permute(torch.stack(words[5:]), consts, 7, 57, spec)
    wide = TP.PoseidonConfig(cfg.modulus, 8, 56, 5, cfg.ark, cfg.mds, rate=3,
                             capacity=1)
    odd_alpha = TP.PoseidonConfig(cfg.modulus, 8, 56, 3, cfg.ark, cfg.mds,
                                  rate=2, capacity=1)
    for bad in (wide, odd_alpha):
        with pytest.raises(ValueError):
            PB.poseidon_hash_batch(bad, words[:2])
