"""Fixed-shape MiMC batch circuit (the zelana_batch Noir circuit).

Re-implements forge/circuits/zelana_batch/src/main.nr over our R1CS layer:
7 public inputs (same ordering as L2BlockCircuit), fixed slots of
MAX_TRANSFERS=8 / MAX_WITHDRAWALS=4 / MAX_SHIELDED=4 gated by is_valid
booleans (main.nr:27-29, :151, :224, :272), MiMC-91 hashes with
numeric-arity domains (zelana_lib/poseidon.nr), depth-32 SMT inclusion +
sequential root updates (zelana_lib/merkle.nr), accumulator finalization
hash_4(acc, n_t, n_w, n_s) / hash_2(wd_acc, n_w) (main.nr:329-343).

Because the slot layout is fixed, ONE proving key serves every batch -- the
property the reference's chunked prover network relies on (each worker
proves an 8/4/4 chunk; coordinator chains pre/post roots across chunks,
prover-coordinator/src/dispatcher.rs).

Noir's `if is_valid { ... }` compiles to gated constraints; here each gated
assert becomes `enforce(valid, computed - expected, 0)` and each state
update becomes a select `root' = valid ? updated : root`. Invalid slots
carry all-zero witnesses, which satisfy every gated constraint.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dfield
from typing import List, Optional

from ..fields.bn254 import R as FR
from ..hashes import mimc
from ..r1cs.system import ConstraintSystem, FpVar

MAX_TRANSFERS = 8
MAX_WITHDRAWALS = 4
MAX_SHIELDED = 4
TREE_DEPTH = 32


# --------------------------------------------------------------------------
# in-circuit MiMC gadgets (zelana_lib/poseidon.nr semantics)
# --------------------------------------------------------------------------


def mimc_permute_var(cs: ConstraintSystem, x: FpVar) -> FpVar:
    state = x
    for c in mimc.round_constants():
        t = state.add_constant(c)
        state = t.pow7()
    return state  # key = 0: no final key addition


def mimc_sponge_var(cs: ConstraintSystem, inputs: List[FpVar]) -> FpVar:
    state = cs.constant(0)
    for inp in inputs:
        state = mimc_permute_var(cs, state + inp)
    return state


def hash2_var(cs, a, b):
    return mimc_sponge_var(cs, [cs.constant(2), a, b])


def hash3_var(cs, a, b, c):
    return mimc_sponge_var(cs, [cs.constant(3), a, b, c])


def hash4_var(cs, a, b, c, d):
    return mimc_sponge_var(cs, [cs.constant(4), a, b, c, d])


def account_leaf_var(cs, pk, balance, nonce):
    """mimc_sponge([4, 1, pk, balance, nonce]) (zelana_lib/account.nr)."""
    return mimc_sponge_var(cs, [cs.constant(4), cs.constant(1), pk, balance, nonce])


def merkle_root_var(cs, leaf: FpVar, path: List[FpVar],
                    indices: List[FpVar]) -> FpVar:
    """Recompute the root from a leaf; indices are 0/1 FpVars (booleanity
    enforced by the caller)."""
    current = leaf
    for sib, idx in zip(path, indices):
        left = idx * (sib - current) + current
        right = idx * (current - sib) + sib
        current = hash2_var(cs, left, right)
    return current


def select(cond: FpVar, a: FpVar, b: FpVar) -> FpVar:
    """cond ? a : b for boolean cond."""
    return cond * (a - b) + b


def gated_assert_eq(cs: ConstraintSystem, valid: FpVar, a: FpVar, b: FpVar):
    """valid * (a - b) == 0."""
    cs.enforce(valid, a - b, cs.constant(0))


def gated_range_check_geq(cs: ConstraintSystem, valid: FpVar,
                          balance: FpVar, amount: FpVar, bits: int = 64):
    """valid => balance >= amount, via a gated 64-bit decomposition of the
    difference (the Noir circuit casts both to u64, main.nr:164-166)."""
    diff = valid * (balance - amount)
    value = diff.value
    acc = cs.constant(0)
    for i in range(bits):
        bit = cs.new_witness((value >> i) & 1 if value < (1 << bits) else 0)
        cs.enforce(bit, bit - cs.constant(1), cs.constant(0))
        acc = acc + bit.scale(1 << i)
    acc.enforce_equal(diff)


# --------------------------------------------------------------------------
# witness slots
# --------------------------------------------------------------------------


def _zero_path():
    return [0] * TREE_DEPTH, [0] * TREE_DEPTH


@dataclass
class TransferSlot:
    sender_pubkey: int = 0
    sender_balance: int = 0
    sender_nonce: int = 0
    sender_path: List[int] = dfield(default_factory=lambda: [0] * TREE_DEPTH)
    sender_path_indices: List[int] = dfield(default_factory=lambda: [0] * TREE_DEPTH)
    receiver_pubkey: int = 0
    receiver_balance: int = 0
    receiver_nonce: int = 0
    receiver_path: List[int] = dfield(default_factory=lambda: [0] * TREE_DEPTH)
    receiver_path_indices: List[int] = dfield(default_factory=lambda: [0] * TREE_DEPTH)
    amount: int = 0
    signature: int = 0
    is_valid: bool = False


@dataclass
class WithdrawalSlot:
    sender_pubkey: int = 0
    sender_balance: int = 0
    sender_nonce: int = 0
    sender_path: List[int] = dfield(default_factory=lambda: [0] * TREE_DEPTH)
    sender_path_indices: List[int] = dfield(default_factory=lambda: [0] * TREE_DEPTH)
    l1_recipient: int = 0
    amount: int = 0
    signature: int = 0
    is_valid: bool = False


@dataclass
class ShieldedSlot:
    input_owner: int = 0
    input_value: int = 0
    input_blinding: int = 0
    input_position: int = 0
    input_path: List[int] = dfield(default_factory=lambda: [0] * TREE_DEPTH)
    input_path_indices: List[int] = dfield(default_factory=lambda: [0] * TREE_DEPTH)
    spending_key: int = 0
    output_owner: int = 0
    output_value: int = 0
    output_blinding: int = 0
    output_commitment: int = 0
    nullifier: int = 0
    is_valid: bool = False
    skip_verification: bool = False


@dataclass
class BatchCircuitMiMC:
    pre_state_root: int = 0
    post_state_root: int = 0
    pre_shielded_root: int = 0
    post_shielded_root: int = 0
    withdrawal_root: int = 0
    batch_hash: int = 0
    batch_id: int = 0
    transfers: List[TransferSlot] = dfield(default_factory=list)
    withdrawals: List[WithdrawalSlot] = dfield(default_factory=list)
    shielded: List[ShieldedSlot] = dfield(default_factory=list)
    num_transfers: int = 0
    num_withdrawals: int = 0
    num_shielded: int = 0
    # slot capacity (the Noir circuit fixes 8/4/4; configurable for tests)
    max_transfers: int = MAX_TRANSFERS
    max_withdrawals: int = MAX_WITHDRAWALS
    max_shielded: int = MAX_SHIELDED
    # SMT depth (the Noir circuit fixes 32; smaller depths keep CI-proved
    # chunk circuits small -- the constraint count is dominated by
    # depth x MiMC-91 Merkle recomputations)
    tree_depth: int = TREE_DEPTH

    def _empty_path(self):
        return [0] * self.tree_depth

    def _pad(self):
        d = self.tree_depth

        def t_slot():
            return TransferSlot(
                sender_path=[0] * d, sender_path_indices=[0] * d,
                receiver_path=[0] * d, receiver_path_indices=[0] * d,
            )

        def w_slot():
            return WithdrawalSlot(
                sender_path=[0] * d, sender_path_indices=[0] * d,
            )

        def s_slot():
            return ShieldedSlot(
                input_path=[0] * d, input_path_indices=[0] * d,
            )

        t = list(self.transfers) + [t_slot() for _ in range(
            self.max_transfers - len(self.transfers))]
        w = list(self.withdrawals) + [w_slot() for _ in range(
            self.max_withdrawals - len(self.withdrawals))]
        s = list(self.shielded) + [s_slot() for _ in range(
            self.max_shielded - len(self.shielded))]
        return t, w, s

    def generate_constraints(self, cs: ConstraintSystem):
        pre_state = cs.new_input(self.pre_state_root)
        post_state = cs.new_input(self.post_state_root)
        pre_shielded = cs.new_input(self.pre_shielded_root)
        post_shielded = cs.new_input(self.post_shielded_root)
        wd_root_pub = cs.new_input(self.withdrawal_root)
        batch_hash_pub = cs.new_input(self.batch_hash)
        batch_id = cs.new_input(self.batch_id)

        transfers, withdrawals, shielded = self._pad()

        current_state = pre_state
        current_shielded = pre_shielded
        batch_acc = hash2_var(cs, cs.constant(4), batch_id)
        wd_acc = hash2_var(cs, cs.constant(5), batch_id)

        def bool_witness(flag: bool) -> FpVar:
            b = cs.new_witness(1 if flag else 0)
            cs.enforce(b, b - cs.constant(1), cs.constant(0))
            return b

        def path_vars(path, indices):
            pvars = [cs.new_witness(x) for x in path]
            ivars = []
            for x in indices:
                iv = cs.new_witness(x)
                cs.enforce(iv, iv - cs.constant(1), cs.constant(0))
                ivars.append(iv)
            return pvars, ivars

        # -- transfers (main.nr:148-217) --
        for tx in transfers:
            valid = bool_witness(tx.is_valid)
            sender_pk = cs.new_witness(tx.sender_pubkey)
            sender_bal = cs.new_witness(tx.sender_balance)
            sender_nonce = cs.new_witness(tx.sender_nonce)
            recv_pk = cs.new_witness(tx.receiver_pubkey)
            recv_bal = cs.new_witness(tx.receiver_balance)
            recv_nonce = cs.new_witness(tx.receiver_nonce)
            amount = cs.new_witness(tx.amount)
            signature = cs.new_witness(tx.signature)
            spath, sidx = path_vars(tx.sender_path, tx.sender_path_indices)
            rpath, ridx = path_vars(tx.receiver_path, tx.receiver_path_indices)

            sender_leaf = account_leaf_var(cs, sender_pk, sender_bal, sender_nonce)
            computed_root = merkle_root_var(cs, sender_leaf, spath, sidx)
            gated_assert_eq(cs, valid, computed_root, current_state)

            gated_range_check_geq(cs, valid, sender_bal, amount)

            tx_hash = hash4_var(cs, sender_pk, recv_pk, amount, sender_nonce)
            # signature != 0 when valid: valid * (sig * sig_inv - 1) == 0
            sig_inv = cs.new_witness(
                pow(tx.signature, FR - 2, FR) if tx.signature else 0)
            gated_assert_eq(cs, valid, signature * sig_inv, cs.constant(1))

            new_sender_leaf = account_leaf_var(
                cs, sender_pk, sender_bal - amount,
                sender_nonce + cs.constant(1))
            root_after_debit = merkle_root_var(cs, new_sender_leaf, spath, sidx)

            recv_leaf = account_leaf_var(cs, recv_pk, recv_bal, recv_nonce)
            recv_root = merkle_root_var(cs, recv_leaf, rpath, ridx)
            gated_assert_eq(cs, valid, recv_root, root_after_debit)

            new_recv_leaf = account_leaf_var(
                cs, recv_pk, recv_bal + amount, recv_nonce)
            root_after_credit = merkle_root_var(cs, new_recv_leaf, rpath, ridx)

            current_state = select(valid, root_after_credit, current_state)
            batch_acc = select(
                valid, hash3_var(cs, batch_acc, tx_hash, amount), batch_acc)

        # -- withdrawals (main.nr:221-265) --
        for wd in withdrawals:
            valid = bool_witness(wd.is_valid)
            sender_pk = cs.new_witness(wd.sender_pubkey)
            sender_bal = cs.new_witness(wd.sender_balance)
            sender_nonce = cs.new_witness(wd.sender_nonce)
            l1_recipient = cs.new_witness(wd.l1_recipient)
            amount = cs.new_witness(wd.amount)
            signature = cs.new_witness(wd.signature)
            spath, sidx = path_vars(wd.sender_path, wd.sender_path_indices)

            sender_leaf = account_leaf_var(cs, sender_pk, sender_bal, sender_nonce)
            computed_root = merkle_root_var(cs, sender_leaf, spath, sidx)
            gated_assert_eq(cs, valid, computed_root, current_state)

            gated_range_check_geq(cs, valid, sender_bal, amount)

            sig_inv = cs.new_witness(
                pow(wd.signature, FR - 2, FR) if wd.signature else 0)
            gated_assert_eq(cs, valid, signature * sig_inv, cs.constant(1))

            new_leaf = account_leaf_var(
                cs, sender_pk, sender_bal - amount,
                sender_nonce + cs.constant(1))
            new_root = merkle_root_var(cs, new_leaf, spath, sidx)
            current_state = select(valid, new_root, current_state)

            wd_hash = hash3_var(cs, l1_recipient, amount, sender_pk)
            wd_acc = select(valid, hash2_var(cs, wd_acc, wd_hash), wd_acc)
            batch_acc = select(
                valid, hash3_var(cs, batch_acc, wd_hash, amount), batch_acc)

        # -- shielded (main.nr:269-324) --
        for sh in shielded:
            valid = bool_witness(sh.is_valid)
            skip = bool_witness(sh.skip_verification)
            in_owner = cs.new_witness(sh.input_owner)
            in_value = cs.new_witness(sh.input_value)
            in_blinding = cs.new_witness(sh.input_blinding)
            in_position = cs.new_witness(sh.input_position)
            spending_key = cs.new_witness(sh.spending_key)
            out_owner = cs.new_witness(sh.output_owner)
            out_value = cs.new_witness(sh.output_value)
            out_blinding = cs.new_witness(sh.output_blinding)
            out_cm_given = cs.new_witness(sh.output_commitment)
            nullifier = cs.new_witness(sh.nullifier)
            ipath, iidx = path_vars(sh.input_path, sh.input_path_indices)

            # full-verification leg (checked when valid && !skip)
            full = valid * (cs.constant(1) - skip)
            input_cm = hash3_var(cs, in_owner, in_value, in_blinding)
            computed_root = merkle_root_var(cs, input_cm, ipath, iidx)
            gated_assert_eq(cs, full, computed_root, current_shielded)

            computed_nf = mimc_sponge_var(
                cs, [cs.constant(4), cs.constant(3), spending_key, input_cm,
                     in_position])
            gated_assert_eq(cs, full, computed_nf, nullifier)
            gated_assert_eq(cs, full, in_value, out_value)

            out_cm_full = hash3_var(cs, out_owner, out_value, out_blinding)
            out_cm = select(skip, out_cm_given, out_cm_full)

            new_shielded = hash2_var(cs, current_shielded, out_cm)
            current_shielded = select(valid, new_shielded, current_shielded)
            batch_acc = select(
                valid, hash3_var(cs, batch_acc, nullifier, out_cm), batch_acc)

        # -- finalize (main.nr:329-343) --
        n_t = cs.new_witness(self.num_transfers)
        n_w = cs.new_witness(self.num_withdrawals)
        n_s = cs.new_witness(self.num_shielded)
        final_batch = hash4_var(cs, batch_acc, n_t, n_w, n_s)
        final_wd = hash2_var(cs, wd_acc, n_w)

        current_state.enforce_equal(post_state)
        current_shielded.enforce_equal(post_shielded)
        final_wd.enforce_equal(wd_root_pub)
        final_batch.enforce_equal(batch_hash_pub)
