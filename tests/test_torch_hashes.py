"""The port's batched hashes (zelana_tpu_torch.hashes.mimc_batch,
poseidon_batch) and the plain mimc_permute against the JAX package on the
CPU: the same inputs from a numpy seed, tolerance bit-equal (the outputs are
field elements; every word must match)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zelana_tpu.hashes import mimc_jax, poseidon_jax
from zelana_tpu.hashes import poseidon as JP
from zelana_tpu.ops import limbs as JL
from zelana_tpu_torch.fields.bn254 import R
from zelana_tpu_torch.hashes import mimc as TM
from zelana_tpu_torch.hashes import mimc_batch as MB
from zelana_tpu_torch.hashes import poseidon as TP
from zelana_tpu_torch.hashes import poseidon_batch as PB
from zelana_tpu_torch.ops import field_kernels as FK
from zelana_tpu_torch.ops import limbs as TL

torch.set_num_threads(1)  # many small int64 ops: threads only contend


def _values(seed: int, n: int, modulus: int) -> list:
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % modulus
            for _ in range(n)]
    vals[:3] = [0, 1, modulus - 1]
    return vals


def _pair(vals, jspec, tspec):
    """(JAX (16, n) limbs, port (8, n) words) of the same Montgomery forms."""
    j16 = JL.encode_mont(vals, jspec)
    return jnp.asarray(j16), TL.to_tensor(TL.words_from_limbs16(j16), "cpu")


def _same(jout, tout) -> None:
    want = TL.words_from_limbs16(np.asarray(jout))
    assert (TL.to_numpy(tout) == want).all()


def test_mimc_permute_plain_matches_jax_kernel():
    """The plain mimc_permute at 3 rounds against the TPU kernel
    (mimc_permute_call in interpret mode) at the JAX test's size."""
    from zelana_tpu.ops.pallas_field import mimc_permute_call

    n = 1024
    consts = [7, 12345, 0xDEADBEEF]
    vals = _values(3, n, R)
    jx, tx = _pair(vals, JL.FR, TL.FR)
    rc16 = JL.encode_mont(consts, JL.FR)  # (16, 3)
    want = mimc_permute_call(JL.FR.modulus, n, 3, True)(
        jnp.asarray(rc16.T.copy()), jx.reshape(JL.NLIMBS, n // 128, 128))
    rc = TL.to_tensor(TL.words_from_limbs16(rc16).T.copy(), "cpu")  # (3, 8)
    got = FK.mimc_permute(tx, rc, TL.FR)
    _same(np.asarray(want).reshape(JL.NLIMBS, n), got)

    def permute(v):
        for c in consts:
            v = pow((v + c) % R, 7, R)
        return v

    assert TL.decode_mont(TL.to_numpy(got), TL.FR)[:8] == [
        permute(v) for v in vals[:8]]
    with pytest.raises(ValueError):
        FK.mimc_permute(tx, rc, TL.FQ)


def test_hash2_batch_matches_jax():
    a, b = (_pair(_values(s, 16, R), JL.FR, TL.FR) for s in (4, 5))
    _same(mimc_jax.hash2_batch(a[0], b[0]), MB.hash2_batch(a[1], b[1]))


@pytest.mark.parametrize("k", [3, 5])
def test_hash_n_batch_matches_jax(k):
    cols = [_pair(_values(10 + i, 16, R), JL.FR, TL.FR) for i in range(k)]
    got = MB.hash_n_batch([c[1] for c in cols])
    _same(mimc_jax.hash_n_batch([c[0] for c in cols]), got)
    rows = list(zip(*(TL.decode_mont(TL.to_numpy(c[1]), TL.FR)
                      for c in cols)))
    assert TL.decode_mont(TL.to_numpy(got), TL.FR)[:4] == [
        TM.hash_n(*r) for r in rows[:4]]


def test_hash2_many_matches_jax():
    pairs = [(i * 7 + 1, i * 13 + 2) for i in range(16)]
    assert MB.hash2_many(pairs, device="cpu") == mimc_jax.hash2_many(pairs)


CONFIGS = [("bn254_8_56", 2), ("bn254_8_56", 3), ("bn254_8_57", 2),
           ("bls12_381_8_57", 2)]
_CFG = {"bn254_8_56": "bn254_config", "bn254_8_57": "bn254_config_57",
        "bls12_381_8_57": "bls12_381_config"}


@pytest.mark.parametrize("name,k", CONFIGS,
                         ids=[f"{n}-{k}cols" for n, k in CONFIGS])
def test_poseidon_hash_batch_matches_jax(name, k):
    jcfg = getattr(JP, _CFG[name])()
    tcfg = getattr(TP, _CFG[name])()
    jspec, tspec = JL.FieldSpec(jcfg.modulus), TL.FieldSpec(tcfg.modulus)
    cols = [_pair(_values(20 + i, 8, jcfg.modulus), jspec, tspec)
            for i in range(k)]
    got = PB.poseidon_hash_batch(tcfg, [c[1] for c in cols])
    _same(poseidon_jax.poseidon_hash_batch(jcfg, [c[0] for c in cols]), got)
    rows = [tuple(r) for r in zip(*(TL.decode_mont(TL.to_numpy(c[1]), tspec)
                                    for c in cols))]
    assert PB.hash_many(tcfg, rows, device="cpu") == \
        poseidon_jax.hash_many(jcfg, rows)


def test_poseidon_permute_batch_matches_jax():
    """One permutation of a (width, 8, 2, 4) state: the batch dims kept."""
    jcfg, tcfg = JP.bn254_config(), TP.bn254_config()
    vals = _values(30, 3 * 8, jcfg.modulus)
    j16 = JL.encode_mont(vals, JL.FR).reshape(JL.NLIMBS, 3, 2, 4)
    jstate = jnp.asarray(j16.transpose(1, 0, 2, 3))
    tstate = TL.to_tensor(TL.words_from_limbs16(j16).transpose(1, 0, 2, 3),
                          "cpu")
    got = PB.poseidon_permute_batch(tstate, tcfg)
    assert got.shape == tstate.shape
    want = np.asarray(poseidon_jax.poseidon_permute_batch(jstate, jcfg))
    assert (TL.to_numpy(got).swapaxes(0, 1) ==
            TL.words_from_limbs16(want.swapaxes(0, 1))).all()
