"""The chunk circuit the benchmark proves, over the reference's
ConstraintSystem, constraint for constraint in the order the circuit emits
them: forge/circuits/zelana_batch/src/main.nr (the 8/4/4 MiMC batch),
frozen from zelana_tpu_torch/circuits/batch_mimc.py.

A slot is a plain dict (see chunk_batch.py).
"""

from __future__ import annotations

from .bn254 import R as FR
from .cs import ConstraintSystem, Var, enforce_cmp_geq
from .hashes import MIMC_CONSTANTS

# ---------------------------------------------------------------- MiMC ----


def mimc_permute_var(x: Var) -> Var:
    for c in MIMC_CONSTANTS:
        x = x.add_constant(c).pow7()
    return x


def mimc_sponge_var(cs, inputs) -> Var:
    state = cs.constant(0)
    for v in inputs:
        state = mimc_permute_var(state + v)
    return state


def hash_var(cs, *values) -> Var:
    return mimc_sponge_var(cs, [cs.constant(len(values)), *values])


def account_leaf_var(cs, pk, balance, nonce) -> Var:
    return mimc_sponge_var(cs, [cs.constant(4), cs.constant(1), pk, balance,
                                nonce])


def merkle_root_var(cs, leaf, path, bits) -> Var:
    cur = leaf
    for sib, b in zip(path, bits):
        left = b * (sib - cur) + cur
        right = b * (cur - sib) + sib
        cur = hash_var(cs, left, right)
    return cur


def select(cond, a, b) -> Var:
    return cond * (a - b) + b


def gated_eq(cs, valid, a, b) -> None:
    cs.enforce(valid, a - b, cs.constant(0))


def gated_geq(cs, valid, balance, amount, bits: int = 64) -> None:
    diff = valid * (balance - amount)
    acc = cs.constant(0)
    for k in range(bits):
        bit = cs.new_witness((diff.v >> k) & 1 if diff.v < (1 << bits) else 0)
        cs.enforce(bit, bit - cs.constant(1), cs.constant(0))
        acc = acc + bit.scale(1 << k)
    acc.enforce_equal(diff)


def chunk_circuit(cs: ConstraintSystem, ch: dict) -> None:
    """ch: the seven public values ("public": pre state, post state, pre
    shielded, post shielded, withdrawal root, batch hash, batch id), the
    slots padded to capacity ("transfers", "withdrawals", "shielded") and
    the valid counts ("counts")."""
    pub = [cs.new_input(v) for v in ch["public"]]
    pre_state, post_state, pre_sh, post_sh, wd_root, batch_hash, bid = pub
    state, shielded = pre_state, pre_sh
    batch_acc = hash_var(cs, cs.constant(4), bid)
    wd_acc = hash_var(cs, cs.constant(5), bid)
    zero, one = cs.constant(0), cs.constant(1)

    def boolean(flag) -> Var:
        b = cs.new_witness(1 if flag else 0)
        cs.enforce(b, b - one, zero)
        return b

    def path(sibs, bits):
        pv = [cs.new_witness(x) for x in sibs]
        bv = []
        for x in bits:
            b = cs.new_witness(x)
            cs.enforce(b, b - one, zero)
            bv.append(b)
        return pv, bv

    def inv(x: int) -> int:
        return pow(x, FR - 2, FR) if x else 0

    for t in ch["transfers"]:
        valid = boolean(t["is_valid"])
        s_pk, s_bal, s_nonce, r_pk, r_bal, r_nonce, amount, sig = (
            cs.new_witness(t[k]) for k in (
                "sender_pubkey", "sender_balance", "sender_nonce",
                "receiver_pubkey", "receiver_balance", "receiver_nonce",
                "amount", "signature"))
        sp, sb = path(t["sender_path"], t["sender_path_indices"])
        rp, rb = path(t["receiver_path"], t["receiver_path_indices"])
        root = merkle_root_var(cs, account_leaf_var(cs, s_pk, s_bal, s_nonce),
                               sp, sb)
        gated_eq(cs, valid, root, state)
        gated_geq(cs, valid, s_bal, amount)
        tx_hash = hash_var(cs, s_pk, r_pk, amount, s_nonce)
        sig_inv = cs.new_witness(inv(t["signature"]))
        gated_eq(cs, valid, sig * sig_inv, one)
        debited = merkle_root_var(
            cs, account_leaf_var(cs, s_pk, s_bal - amount, s_nonce + one),
            sp, sb)
        r_root = merkle_root_var(cs, account_leaf_var(cs, r_pk, r_bal,
                                                      r_nonce), rp, rb)
        gated_eq(cs, valid, r_root, debited)
        credited = merkle_root_var(
            cs, account_leaf_var(cs, r_pk, r_bal + amount, r_nonce), rp, rb)
        state = select(valid, credited, state)
        batch_acc = select(valid, hash_var(cs, batch_acc, tx_hash, amount),
                           batch_acc)

    for w in ch["withdrawals"]:
        valid = boolean(w["is_valid"])
        s_pk, s_bal, s_nonce, l1, amount, sig = (
            cs.new_witness(w[k]) for k in (
                "sender_pubkey", "sender_balance", "sender_nonce",
                "l1_recipient", "amount", "signature"))
        sp, sb = path(w["sender_path"], w["sender_path_indices"])
        root = merkle_root_var(cs, account_leaf_var(cs, s_pk, s_bal, s_nonce),
                               sp, sb)
        gated_eq(cs, valid, root, state)
        gated_geq(cs, valid, s_bal, amount)
        sig_inv = cs.new_witness(inv(w["signature"]))
        gated_eq(cs, valid, sig * sig_inv, one)
        new_root = merkle_root_var(
            cs, account_leaf_var(cs, s_pk, s_bal - amount, s_nonce + one),
            sp, sb)
        state = select(valid, new_root, state)
        wd_hash = hash_var(cs, l1, amount, s_pk)
        wd_acc = select(valid, hash_var(cs, wd_acc, wd_hash), wd_acc)
        batch_acc = select(valid, hash_var(cs, batch_acc, wd_hash, amount),
                           batch_acc)

    for s in ch["shielded"]:
        valid = boolean(s["is_valid"])
        skip = boolean(s["skip_verification"])
        owner, value, blinding, position, sk, o_owner, o_value, o_blinding, \
            o_cm_given, nf = (cs.new_witness(s[k]) for k in (
                "input_owner", "input_value", "input_blinding",
                "input_position", "spending_key", "output_owner",
                "output_value", "output_blinding", "output_commitment",
                "nullifier"))
        ip, ib = path(s["input_path"], s["input_path_indices"])
        full = valid * (one - skip)
        in_cm = hash_var(cs, owner, value, blinding)
        gated_eq(cs, full, merkle_root_var(cs, in_cm, ip, ib), shielded)
        gated_eq(cs, full, mimc_sponge_var(cs, [cs.constant(4), cs.constant(3),
                                                sk, in_cm, position]), nf)
        gated_eq(cs, full, value, o_value)
        out_cm = select(skip, o_cm_given,
                        hash_var(cs, o_owner, o_value, o_blinding))
        shielded = select(valid, hash_var(cs, shielded, out_cm), shielded)
        batch_acc = select(valid, hash_var(cs, batch_acc, nf, out_cm),
                           batch_acc)

    n_t, n_w, n_s = (cs.new_witness(n) for n in ch["counts"])
    final_batch = hash_var(cs, batch_acc, n_t, n_w, n_s)
    final_wd = hash_var(cs, wd_acc, n_w)
    state.enforce_equal(post_state)
    shielded.enforce_equal(post_sh)
    final_wd.enforce_equal(wd_root)
    final_batch.enforce_equal(batch_hash)
