"""A coordinator's batch cut into chunks, with every slot's witness, worked
out from the batch's transactions alone.

The state is the circuit-side sparse Merkle tree (zelana_lib/merkle.nr):
leaf = mimc_sponge([4, 1, pk, balance, nonce]), node = hash_2(left, right),
an account at the low `depth` bits of its pk; shielded notes sit in a
second tree of that kind at consecutive positions. A chunk takes up to its
capacity of transfers, then withdrawals, then shielded slots, and every
Merkle path is read just before the access it proves (a sender before its
debit, a receiver after the debit), as the circuit checks them. This is the
semantics of zelana_tpu_torch/runtime/chunk_witness.py and
coordinator.Dispatcher.build_chunks_with_witness, re-derived here so that
the reference takes no state from the program.

A batch spec is a dict: "funds" [(pk, balance)], "notes" [(spending_key,
value, blinding)], "transfers" [(sender, receiver, amount)], "withdrawals"
[(sender, l1_recipient, amount)], "shielded" [commitment | ["full", note
position, spending_key, out_owner, out_value, out_blinding]].
"""

from __future__ import annotations

from .hashes import (account_leaf, commitment, derive_public_key, hash_n,
                     nullifier)


class SMT:
    def __init__(self, depth: int):
        self.depth = depth
        self.empty = [0]
        for _ in range(depth):
            self.empty.append(hash_n(self.empty[-1], self.empty[-1]))
        self.nodes = {}

    def _get(self, level: int, idx: int) -> int:
        return self.nodes.get((level, idx), self.empty[level])

    def root(self) -> int:
        return self._get(self.depth, 0)

    def path(self, pos: int) -> tuple:
        sibs, bits = [], []
        for level in range(self.depth):
            sibs.append(self._get(level, pos ^ 1))
            bits.append(pos & 1)
            pos >>= 1
        return sibs, bits

    def update(self, pos: int, leaf: int) -> None:
        self.nodes[(0, pos)] = leaf
        cur = leaf
        for level in range(self.depth):
            sib = self._get(level, pos ^ 1)
            cur = hash_n(sib, cur) if pos & 1 else hash_n(cur, sib)
            pos >>= 1
            self.nodes[(level + 1, pos)] = cur


def _transfer_pad(depth):
    return {"sender_pubkey": 0, "sender_balance": 0, "sender_nonce": 0,
            "sender_path": [0] * depth, "sender_path_indices": [0] * depth,
            "receiver_pubkey": 0, "receiver_balance": 0, "receiver_nonce": 0,
            "receiver_path": [0] * depth,
            "receiver_path_indices": [0] * depth, "amount": 0,
            "signature": 0, "is_valid": False}


def _withdrawal_pad(depth):
    return {"sender_pubkey": 0, "sender_balance": 0, "sender_nonce": 0,
            "sender_path": [0] * depth, "sender_path_indices": [0] * depth,
            "l1_recipient": 0, "amount": 0, "signature": 0,
            "is_valid": False}


def _shielded_pad(depth):
    return {"input_owner": 0, "input_value": 0, "input_blinding": 0,
            "input_position": 0, "input_path": [0] * depth,
            "input_path_indices": [0] * depth, "spending_key": 0,
            "output_owner": 0, "output_value": 0, "output_blinding": 0,
            "output_commitment": 0, "nullifier": 0, "is_valid": False,
            "skip_verification": False}


class Batch:
    """Replays a batch spec; `chunks` holds each chunk's roots and padded
    slots."""

    def __init__(self, spec: dict, capacity, depth: int):
        self.depth = depth
        self.tree, self.notes_tree = SMT(depth), SMT(depth)
        self.accounts = {}  # pk -> [balance, nonce]
        self.notes = []
        for pk, balance in spec["funds"]:
            self.accounts[pk] = [balance, 0]
            self.tree.update(self._pos(pk), account_leaf(pk, balance, 0))
        for sk, value, blinding in spec["notes"]:
            owner = derive_public_key(sk)
            self.notes_tree.update(len(self.notes),
                                   commitment(owner, value, blinding))
            self.notes.append((owner, value, blinding))
        self.chunks = self._cut(spec, capacity)

    def _pos(self, pk: int) -> int:
        return pk & ((1 << self.depth) - 1)

    def _debit(self, pk: int, amount: int) -> dict:
        bal, nonce = self.accounts[pk]
        if bal < amount:
            raise ValueError("insufficient balance")
        sibs, bits = self.tree.path(self._pos(pk))
        slot = {"sender_pubkey": pk, "sender_balance": bal,
                "sender_nonce": nonce, "sender_path": sibs,
                "sender_path_indices": bits, "amount": amount,
                "signature": 1, "is_valid": True}
        self.accounts[pk] = [bal - amount, nonce + 1]
        self.tree.update(self._pos(pk), account_leaf(pk, bal - amount,
                                                     nonce + 1))
        return slot

    def _transfer(self, sender: int, receiver: int, amount: int) -> dict:
        slot = self._debit(sender, amount)
        bal, nonce = self.accounts[receiver]
        sibs, bits = self.tree.path(self._pos(receiver))
        slot.update(receiver_pubkey=receiver, receiver_balance=bal,
                    receiver_nonce=nonce, receiver_path=sibs,
                    receiver_path_indices=bits)
        self.accounts[receiver] = [bal + amount, nonce]
        self.tree.update(self._pos(receiver),
                         account_leaf(receiver, bal + amount, nonce))
        return slot

    def _withdrawal(self, sender: int, l1: int, amount: int) -> dict:
        slot = self._debit(sender, amount)
        slot["l1_recipient"] = l1
        return slot

    def _shielded(self, spec) -> dict:
        slot = _shielded_pad(self.depth)
        if isinstance(spec, int):
            slot.update(output_commitment=spec, is_valid=True,
                        skip_verification=True)
            return slot
        _kind, pos, sk, o_owner, o_value, o_blinding = spec
        owner, value, blinding = self.notes[pos]
        if o_value != value:
            raise ValueError("value conservation: input != output")
        cm = commitment(owner, value, blinding)
        sibs, bits = self.notes_tree.path(pos)
        slot.update(input_owner=owner, input_value=value,
                    input_blinding=blinding, input_position=pos,
                    input_path=sibs, input_path_indices=bits,
                    spending_key=sk, output_owner=o_owner,
                    output_value=o_value, output_blinding=o_blinding,
                    output_commitment=commitment(o_owner, o_value,
                                                 o_blinding),
                    nullifier=nullifier(sk, cm, pos), is_valid=True)
        return slot

    def _cut(self, spec, capacity) -> list:
        mt, mw, ms = capacity
        tx, wd, sh = spec["transfers"], spec["withdrawals"], spec["shielded"]
        shielded_root = self.notes_tree.root()
        chunks = []
        for k in range(max(1, -(-len(tx) // mt) if mt else 0,
                           -(-len(wd) // mw) if mw else 0,
                           -(-len(sh) // ms) if ms else 0)):
            pre_state = self.tree.root()
            t = [self._transfer(*x) for x in tx[k * mt:(k + 1) * mt]]
            w = [self._withdrawal(*x) for x in wd[k * mw:(k + 1) * mw]]
            s = [self._shielded(x) for x in sh[k * ms:(k + 1) * ms]]
            post_sh = shielded_root
            for slot in s:
                out_cm = (slot["output_commitment"]
                          if slot["skip_verification"] else
                          commitment(slot["output_owner"],
                                     slot["output_value"],
                                     slot["output_blinding"]))
                post_sh = hash_n(post_sh, out_cm)
            chunks.append({
                "index": k,
                "transfers": ([{**_transfer_pad(self.depth), **x} for x in t]
                              + [_transfer_pad(self.depth)] * (mt - len(t))),
                "withdrawals": ([{**_withdrawal_pad(self.depth), **x}
                                 for x in w]
                                + [_withdrawal_pad(self.depth)]
                                * (mw - len(w))),
                "shielded": s + [_shielded_pad(self.depth)] * (ms - len(s)),
                "counts": (len(t), len(w), len(s)),
                "roots": (pre_state, self.tree.root(), shielded_root,
                          post_sh)})
            shielded_root = post_sh
        return chunks


def accumulators(chunk: dict, batch_id: int) -> tuple:
    """(withdrawal root, batch hash) of a chunk for a batch id: main.nr's
    folds over the valid slots."""
    batch_acc = hash_n(4, batch_id)
    wd_acc = hash_n(5, batch_id)
    for t in chunk["transfers"]:
        if t["is_valid"]:
            tx_hash = hash_n(t["sender_pubkey"], t["receiver_pubkey"],
                             t["amount"], t["sender_nonce"])
            batch_acc = hash_n(batch_acc, tx_hash, t["amount"])
    for w in chunk["withdrawals"]:
        if w["is_valid"]:
            wd_hash = hash_n(w["l1_recipient"], w["amount"],
                             w["sender_pubkey"])
            wd_acc = hash_n(wd_acc, wd_hash)
            batch_acc = hash_n(batch_acc, wd_hash, w["amount"])
    for s in chunk["shielded"]:
        if s["is_valid"]:
            out_cm = (s["output_commitment"] if s["skip_verification"] else
                      commitment(s["output_owner"], s["output_value"],
                                 s["output_blinding"]))
            batch_acc = hash_n(batch_acc, s["nullifier"], out_cm)
    n_t, n_w, n_s = chunk["counts"]
    return hash_n(wd_acc, n_w), hash_n(batch_acc, n_t, n_w, n_s)


def public_values(chunk: dict, batch_id: int) -> list:
    wd_root, batch_hash = accumulators(chunk, batch_id)
    return [*chunk["roots"], wd_root, batch_hash, batch_id]


def circuit_input(chunk: dict, batch_id: int) -> dict:
    """The chunk circuit's instance for circuits.chunk_circuit."""
    return {**chunk, "public": public_values(chunk, batch_id)}
