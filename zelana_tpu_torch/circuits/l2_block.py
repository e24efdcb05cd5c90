"""L2 block circuit: the batch state-transition relation.

Re-implements the reference `L2BlockCircuit::generate_constraints`
(prover/src/l2_circuit.rs:179-505) over our R1CS layer, preserving the exact
relation and witness semantics:

Public inputs (order matters, verifier side at onchain_verifier lib.rs:479-494):
  1. pre_state_root   2. post_state_root   3. pre_shielded_root
  4. post_shielded_root   5. withdrawal_root   6. batch_hash   7. batch_id

Constraints:
  - transfers: sender balance >= amount (enforce_cmp semantics), balance flow
  - post_state_root = Poseidon fold over final accounts (BTreeMap order) with
    domain separator "zelana:accounts-fold:v1", finalized with account count
  - shielded: pre == post when no commitments, else fold of commitments
  - withdrawal root: ds "zelana:withdrawals:v1", leaves P(recipient, amount),
    finalized with count
  - batch hash: ds "zelana:batch-hash:v1" + batch_id, P(sender, recipient,
    amount) per tx, finalized with count
  - pre_state_root anchored by an identical fold over the initial balances

All 32-byte roots enter the field via from_le_bytes_mod_order, as in the
reference.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dfield
from typing import Dict, List, Optional, Tuple

from ..fields.bn254 import R as FR
from ..fields.fp import from_le_bytes_mod_order
from ..hashes.poseidon import PoseidonConfig, bn254_config
from ..r1cs.system import ConstraintSystem, FpVar, enforce_cmp_geq
from ..r1cs.sponge_gadget import PoseidonSpongeVar

DS_ACCOUNTS = from_le_bytes_mod_order(b"zelana:accounts-fold:v1", FR)
DS_WITHDRAWALS = from_le_bytes_mod_order(b"zelana:withdrawals:v1", FR)
DS_BATCH = from_le_bytes_mod_order(b"zelana:batch-hash:v1", FR)


@dataclass
class TransactionWitness:
    sender_pk: bytes  # 32 bytes
    recipient_pk: bytes
    amount: int


@dataclass
class WithdrawalWitness:
    recipient: bytes  # 32-byte L1 address
    amount: int


@dataclass
class L2BlockCircuit:
    pre_state_root: bytes = b"\x00" * 32
    post_state_root: bytes = b"\x00" * 32
    pre_shielded_root: bytes = b"\x00" * 32
    post_shielded_root: bytes = b"\x00" * 32
    withdrawal_root: bytes = b"\x00" * 32
    batch_hash: bytes = b"\x00" * 32
    batch_id: int = 0
    transactions: List[TransactionWitness] = dfield(default_factory=list)
    initial_accounts: Dict[bytes, int] = dfield(default_factory=dict)
    shielded_commitments: List[bytes] = dfield(default_factory=list)
    withdrawals: List[WithdrawalWitness] = dfield(default_factory=list)
    poseidon_config: Optional[PoseidonConfig] = None

    @classmethod
    def dummy(cls) -> "L2BlockCircuit":
        """Keygen circuit shape (l2_circuit.rs:147-170): 2 accounts, 1 tx."""
        return cls(
            batch_id=0,
            transactions=[
                TransactionWitness(b"\x01" * 32, b"\x02" * 32, 100)
            ],
            initial_accounts={b"\x01" * 32: 1000, b"\x02" * 32: 0},
        )

    # ------------------------------------------------------------------

    def generate_constraints(self, cs: ConstraintSystem):
        cfg = self.poseidon_config or bn254_config()

        def P2(a: FpVar, b: FpVar) -> FpVar:
            s = PoseidonSpongeVar(cs, cfg)
            s.absorb([a, b])
            return s.squeeze(1)[0]

        def fle(data: bytes) -> int:
            return from_le_bytes_mod_order(data, FR)

        # -- public inputs (order matters) --
        pre_state = cs.new_input(fle(self.pre_state_root))
        expected_post_state = cs.new_input(fle(self.post_state_root))
        pre_shielded = cs.new_input(fle(self.pre_shielded_root))
        expected_post_shielded = cs.new_input(fle(self.post_shielded_root))
        expected_withdrawal_root = cs.new_input(fle(self.withdrawal_root))
        expected_batch_hash = cs.new_input(fle(self.batch_hash))
        batch_id = cs.new_input(self.batch_id)

        # -- witness: initial account balances (BTreeMap order = sorted pk) --
        sorted_pks = sorted(self.initial_accounts.keys())
        account_vars: Dict[bytes, FpVar] = {}
        for pk in sorted_pks:
            account_vars[pk] = cs.new_witness(self.initial_accounts[pk])

        # -- transfers --
        current: Dict[bytes, FpVar] = dict(account_vars)
        for tx in self.transactions:
            amount = cs.new_witness(tx.amount)
            sender = current[tx.sender_pk]
            recipient = current.get(tx.recipient_pk, cs.constant(0))
            # sender.balance >= amount
            enforce_cmp_geq(cs, sender, amount)
            current[tx.sender_pk] = sender - amount
            current[tx.recipient_pk] = recipient + amount

        ds_var = cs.constant(DS_ACCOUNTS)

        def accounts_fold(balances: Dict[bytes, FpVar]) -> FpVar:
            state = P2(ds_var, batch_id)
            for pk in sorted(balances.keys()):
                pk_var = cs.new_witness(fle(pk))
                leaf = P2(pk_var, balances[pk])
                state = P2(state, leaf)
            count = cs.new_witness(len(balances))
            return P2(state, count)

        # -- post state root --
        computed_post = accounts_fold(current)
        computed_post.enforce_equal(expected_post_state)

        # -- shielded root --
        if not self.shielded_commitments:
            pre_shielded.enforce_equal(expected_post_shielded)
        else:
            s = PoseidonSpongeVar(cs, cfg)
            s.absorb([pre_shielded])
            shielded_state = s.squeeze(1)[0]
            for cm in self.shielded_commitments:
                cm_var = cs.new_witness(fle(cm))
                shielded_state = P2(shielded_state, cm_var)
            shielded_state.enforce_equal(expected_post_shielded)

        # -- withdrawal root --
        wd_sponge = PoseidonSpongeVar(cs, cfg)
        wd_sponge.absorb([cs.constant(DS_WITHDRAWALS)])
        wd_state = wd_sponge.squeeze(1)[0]
        for wd in self.withdrawals:
            recipient = cs.new_witness(fle(wd.recipient))
            amount = cs.new_witness(wd.amount)
            leaf = P2(recipient, amount)
            wd_state = P2(wd_state, leaf)
        wd_count = cs.new_witness(len(self.withdrawals))
        computed_wd = P2(wd_state, wd_count)
        computed_wd.enforce_equal(expected_withdrawal_root)

        # -- batch hash --
        bh_sponge = PoseidonSpongeVar(cs, cfg)
        bh_sponge.absorb([cs.constant(DS_BATCH), batch_id])
        batch_state = bh_sponge.squeeze(1)[0]
        for tx in self.transactions:
            sender = cs.new_witness(fle(tx.sender_pk))
            recipient = cs.new_witness(fle(tx.recipient_pk))
            amount = cs.new_witness(tx.amount)
            tx_sponge = PoseidonSpongeVar(cs, cfg)
            tx_sponge.absorb([sender, recipient, amount])
            tx_hash = tx_sponge.squeeze(1)[0]
            batch_state = P2(batch_state, tx_hash)
        tx_count = cs.new_witness(len(self.transactions))
        computed_bh = P2(batch_state, tx_count)
        computed_bh.enforce_equal(expected_batch_hash)

        # -- anchor pre state root --
        computed_pre = accounts_fold(account_vars)
        computed_pre.enforce_equal(pre_state)


# ---------------------------------------------------------------------------
# native (off-circuit) computation of the public values, mirroring
# calculate_new_root_offchain (prover/src/main.rs.bak:114-154) and the
# in-circuit folds -- used by the sequencer to build public inputs.
# ---------------------------------------------------------------------------


def compute_state_root(batch_id: int, accounts: Dict[bytes, int],
                       cfg: Optional[PoseidonConfig] = None) -> bytes:
    from ..hashes.poseidon import poseidon_hash

    cfg = cfg or bn254_config()
    state = poseidon_hash(cfg, [DS_ACCOUNTS, batch_id])
    for pk in sorted(accounts.keys()):
        leaf = poseidon_hash(cfg, [from_le_bytes_mod_order(pk, FR), accounts[pk]])
        state = poseidon_hash(cfg, [state, leaf])
    final = poseidon_hash(cfg, [state, len(accounts)])
    return int(final).to_bytes(32, "little")


def compute_shielded_root(pre_root: bytes, commitments: List[bytes],
                          cfg: Optional[PoseidonConfig] = None) -> bytes:
    from ..hashes.poseidon import PoseidonSponge, poseidon_hash

    if not commitments:
        return pre_root
    cfg = cfg or bn254_config()
    sponge = PoseidonSponge(cfg)
    sponge.absorb([from_le_bytes_mod_order(pre_root, FR)])
    state = sponge.squeeze_field_elements(1)[0]
    for cm in commitments:
        state = poseidon_hash(cfg, [state, from_le_bytes_mod_order(cm, FR)])
    return int(state).to_bytes(32, "little")


def compute_withdrawal_root(withdrawals: List[WithdrawalWitness],
                            cfg: Optional[PoseidonConfig] = None) -> bytes:
    from ..hashes.poseidon import PoseidonSponge, poseidon_hash

    cfg = cfg or bn254_config()
    sponge = PoseidonSponge(cfg)
    sponge.absorb([DS_WITHDRAWALS])
    state = sponge.squeeze_field_elements(1)[0]
    for wd in withdrawals:
        leaf = poseidon_hash(
            cfg, [from_le_bytes_mod_order(wd.recipient, FR), wd.amount]
        )
        state = poseidon_hash(cfg, [state, leaf])
    final = poseidon_hash(cfg, [state, len(withdrawals)])
    return int(final).to_bytes(32, "little")


def compute_batch_hash(batch_id: int, transactions: List[TransactionWitness],
                       cfg: Optional[PoseidonConfig] = None) -> bytes:
    from ..hashes.poseidon import poseidon_hash

    cfg = cfg or bn254_config()
    state = poseidon_hash(cfg, [DS_BATCH, batch_id])
    for tx in transactions:
        tx_hash = poseidon_hash(cfg, [
            from_le_bytes_mod_order(tx.sender_pk, FR),
            from_le_bytes_mod_order(tx.recipient_pk, FR),
            tx.amount,
        ])
        state = poseidon_hash(cfg, [state, tx_hash])
    final = poseidon_hash(cfg, [state, len(transactions)])
    return int(final).to_bytes(32, "little")


def apply_transfers(accounts: Dict[bytes, int],
                    transactions: List[TransactionWitness]) -> Dict[bytes, int]:
    out = dict(accounts)
    for tx in transactions:
        out[tx.sender_pk] = out.get(tx.sender_pk, 0) - tx.amount
        out[tx.recipient_pk] = out.get(tx.recipient_pk, 0) + tx.amount
    return out
