"""Account state sparse Merkle tree (MiMC, depth 32).

Semantics mirror the reference AccountTree
(core/src/sequencer/storage/account_tree.rs):

- leaf = mimc_sponge([4, 1, pubkey, balance, nonce])   (:109-124)
- inner = hash_2(left, right) = mimc_sponge([2, l, r]) (:93-96)
- position = u32 big-endian of the first 4 bytes of the account id (:315-331)
- empty leaf = 32 zero bytes; empty roots chained hash_2(e, e) (:295-307)
- all hashes over 32-byte BIG-endian field encodings (:188-204)

Hashing goes through the native C++ engine on the host
(sequencer/native.py), as in the JAX package; bulk rebuilds can use the
batched MiMC kernel (hashes/mimc_batch.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from . import native

TREE_DEPTH = 32
ZERO32 = b"\x00" * 32


def _empty_roots() -> List[bytes]:
    roots = [ZERO32]
    for _ in range(TREE_DEPTH):
        prev = roots[-1]
        roots.append(native.hash2_be(prev, prev))
    return roots


_EMPTY_ROOTS: Optional[List[bytes]] = None


def empty_roots() -> List[bytes]:
    global _EMPTY_ROOTS
    if _EMPTY_ROOTS is None:
        _EMPTY_ROOTS = _empty_roots()
    return _EMPTY_ROOTS


@dataclass
class AccountMerklePath:
    siblings: List[bytes]  # 32 x 32-byte BE
    path_indices: List[int]  # 0 = left, 1 = right
    position: int

    def compute_root(self, leaf: bytes) -> bytes:
        return native.merkle_root_be(leaf, self.siblings, self.path_indices)

    def verify(self, leaf: bytes, root: bytes) -> bool:
        return self.compute_root(leaf) == root

    def siblings_hex(self) -> List[str]:
        return [s.hex() for s in self.siblings]


@dataclass
class AccountState:
    balance: int = 0
    nonce: int = 0


class AccountTree:
    def __init__(self):
        self.nodes: Dict[Tuple[int, int], bytes] = {}
        self.positions: Dict[bytes, int] = {}
        self._root = empty_roots()[TREE_DEPTH]

    def clone(self) -> "AccountTree":
        t = AccountTree()
        t.nodes = dict(self.nodes)
        t.positions = dict(self.positions)
        t._root = self._root
        return t

    def root(self) -> bytes:
        return self._root

    def _get_or_create_position(self, account_id: bytes) -> int:
        pos = self.positions.get(account_id)
        if pos is None:
            pos = int.from_bytes(account_id[:4], "big")
            self.positions[account_id] = pos
        return pos

    def get_position(self, account_id: bytes) -> Optional[int]:
        return self.positions.get(account_id)

    def insert(self, account_id: bytes, state: AccountState) -> int:
        position = self._get_or_create_position(account_id)
        leaf = native.account_leaf_be(account_id, state.balance, state.nonce)
        self._insert_leaf_at(position, leaf)
        return position

    def _insert_leaf_at(self, position: int, leaf: bytes):
        self.nodes[(0, position)] = leaf
        idx = position
        cur = leaf
        er = empty_roots()
        for level in range(TREE_DEPTH):
            is_right = idx & 1 == 1
            sib_idx = idx - 1 if is_right else idx + 1
            sib = self.nodes.get((level, sib_idx), er[level])
            cur = native.hash2_be(sib, cur) if is_right else native.hash2_be(cur, sib)
            idx //= 2
            self.nodes[(level + 1, idx)] = cur
        self._root = cur

    def path(self, account_id: bytes) -> Optional[AccountMerklePath]:
        pos = self.positions.get(account_id)
        if pos is None:
            return None
        return self.path_at_position(pos)

    def path_at_position(self, position: int) -> AccountMerklePath:
        sibs, dirs = [], []
        idx = position
        er = empty_roots()
        for level in range(TREE_DEPTH):
            is_right = idx & 1 == 1
            dirs.append(1 if is_right else 0)
            sib_idx = idx - 1 if is_right else idx + 1
            sibs.append(self.nodes.get((level, sib_idx), er[level]))
            idx //= 2
        return AccountMerklePath(sibs, dirs, position)

    def leaf(self, account_id: bytes) -> Optional[bytes]:
        pos = self.positions.get(account_id)
        if pos is None:
            return None
        return self.nodes.get((0, pos))

    def contains(self, account_id: bytes) -> bool:
        return account_id in self.positions

    def __len__(self) -> int:
        return len(self.positions)


# --- withdrawal root / batch hash accumulators (account_tree.rs:142-185) ---


def compute_withdrawal_root_mimc(batch_id: int, withdrawals=()) -> bytes:
    """hash_2(hash_2(5, batch_id) folded with wd hashes, count)."""
    from ..hashes import mimc

    acc = mimc.hash_2(5, batch_id)
    for recipient, amount, sender in withdrawals:
        wd_hash = mimc.hash_3(recipient, amount, sender)
        acc = mimc.hash_2(acc, wd_hash)
    root = mimc.hash_2(acc, len(withdrawals))
    return int(root).to_bytes(32, "big")


def compute_batch_hash_mimc(batch_id: int, num_transfers: int,
                            num_withdrawals: int, num_shielded: int,
                            items=()) -> bytes:
    from ..hashes import mimc

    acc = mimc.hash_2(4, batch_id)
    for a, b in items:
        acc = mimc.hash_3(acc, a, b)
    h = mimc.hash_4(acc, num_transfers, num_withdrawals, num_shielded)
    return int(h).to_bytes(32, "big")
