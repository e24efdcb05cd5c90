"""Chunk witness building with intermediate SMT Merkle paths.

The `build_witness_with_proofs` analogue
(core/src/sequencer/settlement/prover.rs:580-786): the batch circuit
verifies each transfer's sender inclusion against the CURRENT root, debits,
then verifies the receiver against the intermediate root-after-debit -- so
the witness builder must clone the tree and simulate every update in
circuit order, recording the Merkle path BEFORE each access.

The tree here is the circuit-side MiMC SMT (zelana_lib/merkle.nr
semantics): leaf = mimc_sponge([4, 1, pk, balance, nonce]), node =
hash_2(left, right), configurable depth (the Noir circuit fixes 32).
Leaf position is the low `depth` bits of the pk field element -- the same
rule on both the witness and circuit side (the circuit only checks path
consistency; the reference coordinator likewise owns its position rule,
forge/crates/prover-coordinator/src/dispatcher.rs).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from ..circuits.batch_mimc import ShieldedSlot, TransferSlot, WithdrawalSlot
from ..hashes import mimc


def account_leaf(pk: int, balance: int, nonce: int) -> int:
    return int(mimc.compute_account_leaf(pk, balance, nonce))


class CircuitSMT:
    """Sparse MiMC Merkle tree over integer leaves, configurable depth."""

    def __init__(self, depth: int = 32):
        self.depth = depth
        self.empties = [0]
        for _ in range(depth):
            self.empties.append(
                int(mimc.hash_2(self.empties[-1], self.empties[-1]))
            )
        self.nodes: Dict[Tuple[int, int], int] = {}

    def _get(self, level: int, idx: int) -> int:
        return self.nodes.get((level, idx), self.empties[level])

    def root(self) -> int:
        return self._get(self.depth, 0)

    def path(self, pos: int) -> Tuple[List[int], List[int]]:
        """(siblings, index bits), leaf level first; bit 1 = leaf on the
        right at that level (matches merkle_root_var's select)."""
        sibs, bits = [], []
        idx = pos
        for level in range(self.depth):
            sibs.append(self._get(level, idx ^ 1))
            bits.append(idx & 1)
            idx >>= 1
        return sibs, bits

    def update(self, pos: int, leaf: int):
        idx = pos
        self.nodes[(0, idx)] = leaf
        cur = leaf
        for level in range(self.depth):
            sib = self._get(level, idx ^ 1)
            if idx & 1:
                cur = int(mimc.hash_2(sib, cur))
            else:
                cur = int(mimc.hash_2(cur, sib))
            idx >>= 1
            self.nodes[(level + 1, idx)] = cur


@dataclass
class AccountInfo:
    pk: int
    balance: int = 0
    nonce: int = 0


class ChunkWitnessBuilder:
    """Owns the circuit SMT + account map; produces circuit slots whose
    Merkle paths reflect the exact sequential update order the circuit
    enforces (sender before debit, receiver after debit)."""

    def __init__(self, depth: int = 32):
        self.depth = depth
        self.tree = CircuitSMT(depth)
        self.accounts: Dict[int, AccountInfo] = {}
        # shielded note commitment SMT for FULL-verification spends
        # (main.nr:283-321): the circuit proves input-commitment inclusion
        # against the chunk's pre_shielded_root, so the builder owns the
        # commitment tree and note store
        self.shielded_tree = CircuitSMT(depth)
        self.notes: Dict[int, Tuple[int, int, int]] = {}
        self._next_note_pos = 0

    def pos(self, pk: int) -> int:
        return pk & ((1 << self.depth) - 1)

    def fund(self, pk: int, balance: int, nonce: int = 0):
        """Establish an account's pre-batch state (deposits/genesis)."""
        info = AccountInfo(pk, balance, nonce)
        self.accounts[pk] = info
        self.tree.update(self.pos(pk), account_leaf(pk, balance, nonce))

    def _touch(self, pk: int) -> AccountInfo:
        if pk not in self.accounts:
            self.accounts[pk] = AccountInfo(pk)
        return self.accounts[pk]

    def root(self) -> int:
        return self.tree.root()

    def transfer_slot(self, sender_pk: int, receiver_pk: int, amount: int,
                      signature: int = 1) -> TransferSlot:
        sender = self._touch(sender_pk)
        if sender.balance < amount:
            raise ValueError("insufficient balance")
        spath, sbits = self.tree.path(self.pos(sender_pk))
        slot = TransferSlot(
            sender_pubkey=sender_pk,
            sender_balance=sender.balance,
            sender_nonce=sender.nonce,
            sender_path=spath,
            sender_path_indices=sbits,
            amount=amount,
            signature=signature,
            is_valid=True,
        )
        # debit (nonce+1), then snapshot the receiver against the
        # INTERMEDIATE root (circuit order, main.nr:177-211)
        sender.balance -= amount
        sender.nonce += 1
        self.tree.update(
            self.pos(sender_pk),
            account_leaf(sender_pk, sender.balance, sender.nonce),
        )
        if receiver_pk not in self.accounts:
            # an absent account's SMT slot holds the EMPTY leaf (0), not
            # account_leaf(pk, 0, 0) -- the circuit's receiver-inclusion
            # check (main.nr:196-203) can only pass for materialized
            # accounts, so demand an explicit fund(pk, 0) (deposit/genesis)
            raise ValueError(
                f"receiver {receiver_pk:#x} has no tree leaf; "
                "fund(pk, 0) it before building the chunk witness")
        receiver = self._touch(receiver_pk)
        rpath, rbits = self.tree.path(self.pos(receiver_pk))
        slot.receiver_pubkey = receiver_pk
        slot.receiver_balance = receiver.balance
        slot.receiver_nonce = receiver.nonce
        slot.receiver_path = rpath
        slot.receiver_path_indices = rbits
        receiver.balance += amount
        self.tree.update(
            self.pos(receiver_pk),
            account_leaf(receiver_pk, receiver.balance, receiver.nonce),
        )
        return slot

    def withdrawal_slot(self, sender_pk: int, l1_recipient: int,
                        amount: int, signature: int = 1) -> WithdrawalSlot:
        sender = self._touch(sender_pk)
        if sender.balance < amount:
            raise ValueError("insufficient balance")
        spath, sbits = self.tree.path(self.pos(sender_pk))
        slot = WithdrawalSlot(
            sender_pubkey=sender_pk,
            sender_balance=sender.balance,
            sender_nonce=sender.nonce,
            sender_path=spath,
            sender_path_indices=sbits,
            l1_recipient=l1_recipient,
            amount=amount,
            signature=signature,
            is_valid=True,
        )
        sender.balance -= amount
        sender.nonce += 1
        self.tree.update(
            self.pos(sender_pk),
            account_leaf(sender_pk, sender.balance, sender.nonce),
        )
        return slot

    def shielded_slot_skip(self, output_commitment: int) -> ShieldedSlot:
        """Pass-through shielded slot (skip_verification mode,
        main.nr:272-277): only folds the output commitment into the
        shielded root."""
        return ShieldedSlot(
            output_commitment=output_commitment,
            is_valid=True,
            skip_verification=True,
            input_path=[0] * self.depth,
            input_path_indices=[0] * self.depth,
        )

    # -- full-verification shielded (main.nr:283-321) ----------------------

    def add_note(self, spending_key: int, value: int,
                 blinding: int) -> int:
        """Insert a note commitment into the shielded SMT pre-batch (the
        analogue of a prior shield/deposit). Returns the note position.
        owner = derive_public_key(spending_key) (ownership-prover
        lib.rs:48-50)."""
        owner = int(mimc.derive_public_key(spending_key))
        cm = int(mimc.compute_commitment(owner, value, blinding))
        pos = self._next_note_pos
        self._next_note_pos += 1
        self.shielded_tree.update(pos, cm)
        self.notes[pos] = (owner, value, blinding)
        return pos

    def shielded_root(self) -> int:
        return self.shielded_tree.root()

    def shielded_slot_full(self, position: int, spending_key: int,
                           output_owner: int, output_value: int,
                           output_blinding: int) -> ShieldedSlot:
        """Full-verification spend: input-commitment Merkle inclusion in
        the shielded root, nullifier = hash_4(3, sk, cm, pos), value
        conservation input == output (main.nr:283-321). The circuit folds
        the shielded root by hash_2 after the FIRST spend, so a chunk's
        full-mode slot must come before any other shielded slot (the
        reference circuit shares this property)."""
        owner, value, blinding = self.notes[position]
        if output_value != value:
            raise ValueError("value conservation: input != output")
        cm = int(mimc.compute_commitment(owner, value, blinding))
        path, bits = self.shielded_tree.path(position)
        return ShieldedSlot(
            input_owner=owner,
            input_value=value,
            input_blinding=blinding,
            input_position=position,
            input_path=path,
            input_path_indices=bits,
            spending_key=spending_key,
            output_owner=output_owner,
            output_value=output_value,
            output_blinding=output_blinding,
            output_commitment=int(mimc.compute_commitment(
                output_owner, output_value, output_blinding)),
            nullifier=int(mimc.compute_nullifier(spending_key, cm,
                                                 position)),
            is_valid=True,
            skip_verification=False,
        )


# --------------------------------------------------------------------------
# chunk accumulator math (the circuit's public-input values, host-side)
# --------------------------------------------------------------------------


def chunk_accumulators(batch_id: int, transfers: List[TransferSlot],
                       withdrawals: List[WithdrawalSlot],
                       shielded: List[ShieldedSlot]) -> Tuple[int, int]:
    """(withdrawal_root, batch_hash) for one chunk, mirroring the circuit's
    accumulator folds (main.nr:141-144, :214, :255-260, :318-323,
    :329-343)."""
    batch_acc = int(mimc.hash_2(4, batch_id))
    wd_acc = int(mimc.hash_2(5, batch_id))
    for t in transfers:
        if not t.is_valid:
            continue
        tx_hash = int(mimc.hash_4(t.sender_pubkey, t.receiver_pubkey,
                                  t.amount, t.sender_nonce))
        batch_acc = int(mimc.hash_3(batch_acc, tx_hash, t.amount))
    for w in withdrawals:
        if not w.is_valid:
            continue
        wd_hash = int(mimc.hash_3(w.l1_recipient, w.amount, w.sender_pubkey))
        wd_acc = int(mimc.hash_2(wd_acc, wd_hash))
        batch_acc = int(mimc.hash_3(batch_acc, wd_hash, w.amount))
    for s in shielded:
        if not s.is_valid:
            continue
        out_cm = s.output_commitment if s.skip_verification else int(
            mimc.hash_3(s.output_owner, s.output_value, s.output_blinding))
        batch_acc = int(mimc.hash_3(batch_acc, s.nullifier, out_cm))
    n_t = sum(1 for t in transfers if t.is_valid)
    n_w = sum(1 for w in withdrawals if w.is_valid)
    n_s = sum(1 for s in shielded if s.is_valid)
    batch_hash = int(mimc.hash_4(batch_acc, n_t, n_w, n_s))
    wd_root = int(mimc.hash_2(wd_acc, n_w))
    return wd_root, batch_hash


def fold_shielded_root(pre_root: int, shielded: List[ShieldedSlot]) -> int:
    root = pre_root
    for s in shielded:
        if not s.is_valid:
            continue
        out_cm = s.output_commitment if s.skip_verification else int(
            mimc.hash_3(s.output_owner, s.output_value, s.output_blinding))
        root = int(mimc.hash_2(root, out_cm))
    return root
