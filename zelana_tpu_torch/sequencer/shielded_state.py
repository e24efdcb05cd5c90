"""Shielded commitment tree + nullifier set.

Mirrors core/src/sequencer/storage/shielded_state.rs and the privacy SDK
tree it builds on (sdk/privacy/src/merkle.rs):

- depth-32 append-only tree over BLS12-381 Poseidon (8/57, rate 2)
- empty leaf = Poseidon(0); empty roots chained hash_pair(e, e)
- little-endian 32-byte leaf/root encoding (merkle.rs:87-91)
- ring of the last 100 roots so clients can prove against slightly stale
  roots (shielded_state.rs:24)
- frontier-based persistence: O(depth) data reconstructs the tree after a
  restart (shielded_state.rs:29-80)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from ..hashes.poseidon import PoseidonSponge, bls12_381_config, poseidon_hash

TREE_DEPTH = 32
ROOT_HISTORY_SIZE = 100

_CFG = None


def _cfg():
    global _CFG
    if _CFG is None:
        _CFG = bls12_381_config()
    return _CFG


def _fle(data: bytes) -> int:
    return int.from_bytes(data, "little") % _cfg().modulus


def _to_bytes(v: int) -> bytes:
    return int(v).to_bytes(32, "little")


def hash_pair(left: bytes, right: bytes) -> bytes:
    return _to_bytes(poseidon_hash(_cfg(), [_fle(left), _fle(right)]))


_EMPTY: Optional[List[bytes]] = None


def empty_roots() -> List[bytes]:
    global _EMPTY
    if _EMPTY is None:
        leaf = _to_bytes(poseidon_hash(_cfg(), [0]))
        roots = [leaf]
        for _ in range(TREE_DEPTH):
            roots.append(hash_pair(roots[-1], roots[-1]))
        _EMPTY = roots
    return _EMPTY


@dataclass
class MerklePath:
    siblings: List[bytes]
    path_bits: List[bool]
    position: int

    def compute_root(self, leaf: bytes) -> bytes:
        cur = leaf
        for sib, is_right in zip(self.siblings, self.path_bits):
            cur = hash_pair(sib, cur) if is_right else hash_pair(cur, sib)
        return cur

    def verify(self, leaf: bytes, root: bytes) -> bool:
        return self.compute_root(leaf) == root


@dataclass
class TreeFrontier:
    """Rightmost-path snapshot: enough to resume appends after restart."""

    next_index: int
    filled: List[Optional[bytes]]  # per level: left sibling if index odd


class CommitmentTree:
    def __init__(self):
        self.nodes: Dict[tuple, bytes] = {}
        self.next_index = 0
        self._root = empty_roots()[TREE_DEPTH]

    def root(self) -> bytes:
        return self._root

    def insert(self, commitment: bytes) -> int:
        pos = self.next_index
        self.insert_at(pos, commitment)
        self.next_index = pos + 1
        return pos

    def insert_at(self, position: int, commitment: bytes):
        self.nodes[(0, position)] = commitment
        idx = position
        cur = commitment
        er = empty_roots()
        for level in range(TREE_DEPTH):
            is_right = idx & 1 == 1
            sib_idx = idx - 1 if is_right else idx + 1
            sib = self.nodes.get((level, sib_idx), er[level])
            cur = hash_pair(sib, cur) if is_right else hash_pair(cur, sib)
            idx //= 2
            self.nodes[(level + 1, idx)] = cur
        self._root = cur
        self.next_index = max(self.next_index, position + 1)

    def path(self, position: int) -> Optional[MerklePath]:
        if position >= self.next_index:
            return None
        sibs, bits = [], []
        idx = position
        er = empty_roots()
        for level in range(TREE_DEPTH):
            is_right = idx & 1 == 1
            bits.append(is_right)
            sib_idx = idx - 1 if is_right else idx + 1
            sibs.append(self.nodes.get((level, sib_idx), er[level]))
            idx //= 2
        return MerklePath(sibs, bits, position)

    def get(self, position: int) -> Optional[bytes]:
        return self.nodes.get((0, position))

    def frontier(self) -> TreeFrontier:
        filled: List[Optional[bytes]] = []
        idx = self.next_index
        for level in range(TREE_DEPTH):
            if idx & 1 == 1:
                filled.append(self.nodes.get((level, idx - 1)))
            else:
                filled.append(None)
            idx //= 2
        return TreeFrontier(self.next_index, filled)


class RootHistory:
    def __init__(self, max_size: int = ROOT_HISTORY_SIZE):
        self.roots: List[bytes] = []
        self.max_size = max_size

    def push(self, root: bytes):
        self.roots.insert(0, root)
        if len(self.roots) > self.max_size:
            self.roots.pop()

    def is_valid(self, root: bytes) -> bool:
        return root in self.roots

    def current(self) -> Optional[bytes]:
        return self.roots[0] if self.roots else None


@dataclass
class ShieldedStateDiff:
    new_commitments: List[bytes] = field(default_factory=list)
    new_nullifiers: List[bytes] = field(default_factory=list)
    pre_root: bytes = b""
    post_root: bytes = b""


class ShieldedState:
    """Commitment tree + nullifier set + root ring (shielded_state.rs)."""

    def __init__(self):
        self.tree = CommitmentTree()
        self.nullifiers: Set[bytes] = set()
        self.history = RootHistory()
        self.history.push(self.tree.root())

    def root(self) -> bytes:
        return self.tree.root()

    def is_spent(self, nullifier: bytes) -> bool:
        return nullifier in self.nullifiers

    def is_known_root(self, root: bytes) -> bool:
        return self.history.is_valid(root)

    def apply(self, diff: ShieldedStateDiff):
        for nf in diff.new_nullifiers:
            self.nullifiers.add(nf)
        for cm in diff.new_commitments:
            self.tree.insert(cm)
        self.history.push(self.tree.root())

    def execute(self, nullifier: Optional[bytes], commitment: Optional[bytes]):
        """Single shielded spend: check + record nullifier, add commitment."""
        if nullifier is not None:
            if nullifier in self.nullifiers:
                raise ValueError("double spend: nullifier already used")
            self.nullifiers.add(nullifier)
        pos = None
        if commitment is not None:
            pos = self.tree.insert(commitment)
        self.history.push(self.tree.root())
        return pos
