"""Merkle-Patricia trie over a partial node witness.

The stateless-execution state backend (sbv's partial-trie analog): the
witness supplies the keccak-addressed RLP nodes along the access paths;
reads resolve through the node store, writes rebuild the affected path
and recompute the root. Nodes the witness didn't supply raise
MissingNode — a witness-completeness failure, exactly how sbv surfaces
missing proof nodes.

Standard Ethereum MPT: hex-prefix (compact) encoding, 17-ary branch
nodes, nodes < 32 bytes inlined, keccak-256 hashing. Secure tries hash
the key first (account/storage tries use keccak(address/slot)).

A copy of the reference's `zkvm_prover_tpu/execution/mpt.py`.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..ops.keccak import keccak256
from . import rlp

EMPTY_ROOT = keccak256(rlp.encode(b""))  # 0x56e81f17...


class MissingNode(Exception):
    """A node on the access path was not supplied by the witness."""


def nibbles(key: bytes) -> List[int]:
    out = []
    for b in key:
        out.append(b >> 4)
        out.append(b & 0xF)
    return out


def compact_encode(nibs: List[int], is_leaf: bool) -> bytes:
    flag = 2 if is_leaf else 0
    if len(nibs) % 2:
        arr = [flag + 1] + nibs
    else:
        arr = [flag, 0] + nibs
    return bytes(
        (arr[i] << 4) | arr[i + 1] for i in range(0, len(arr), 2)
    )


def compact_decode(b: bytes):
    nibs = nibbles(b)
    flag = nibs[0]
    is_leaf = flag >= 2
    out = nibs[2:] if flag % 2 == 0 else nibs[1:]
    return out, is_leaf


class Mpt:
    """Partial MPT over a node store {keccak(node_rlp): node_rlp}."""

    def __init__(self, root: bytes, nodes: Optional[Dict[bytes, bytes]] = None):
        self.root = root
        # NOTE: shared by reference — storage tries and the account trie
        # deliberately use one node store so writes through either are
        # visible to both (WorldState.state_root relies on this).
        self.nodes: Dict[bytes, bytes] = nodes if nodes is not None else {}

    # -- node access --------------------------------------------------------
    def add_witness_node(self, node_rlp: bytes) -> None:
        self.nodes[keccak256(node_rlp)] = node_rlp

    def _resolve(self, ref) -> list:
        """A node reference is either a 32-byte hash or an inlined list."""
        if isinstance(ref, list):
            return ref
        if ref == b"":
            return []
        if len(ref) == 32:
            raw = self.nodes.get(bytes(ref))
            if raw is None:
                raise MissingNode(bytes(ref).hex())
            return rlp.decode(raw)
        # < 32 bytes: inlined RLP
        return rlp.decode(ref)

    # -- read ---------------------------------------------------------------
    def get(self, key: bytes) -> Optional[bytes]:
        if self.root == EMPTY_ROOT:
            return None
        return self._get(self.root, nibbles(key))

    def _get(self, ref, path: List[int]) -> Optional[bytes]:
        node = self._resolve(ref)
        if not node:
            return None
        if len(node) == 17:
            if not path:
                return bytes(node[16]) or None
            nxt = node[path[0]]
            if nxt == b"":
                return None
            return self._get(nxt, path[1:])
        if len(node) == 2:
            nibs, is_leaf = compact_decode(bytes(node[0]))
            if is_leaf:
                return bytes(node[1]) if path == nibs else None
            if path[: len(nibs)] == nibs:
                return self._get(node[1], path[len(nibs):])
            return None
        raise ValueError("malformed trie node")

    # -- write --------------------------------------------------------------
    def update(self, key: bytes, value: bytes) -> None:
        """Insert/overwrite (value=b'' deletes)."""
        path = nibbles(key)
        if value == b"":
            root_node = self._delete_ref(
                self.root if self.root != EMPTY_ROOT else None, path
            )
        else:
            cur = None if self.root == EMPTY_ROOT else self.root
            root_node = self._insert_ref(cur, path, value)
        self.root = self._commit_root(root_node)

    def _commit_root(self, node) -> bytes:
        if node is None:
            return EMPTY_ROOT
        enc = rlp.encode(node)
        h = keccak256(enc)
        self.nodes[h] = enc
        return h

    def _node_ref(self, node):
        """Reference for embedding in a parent: inline if < 32 bytes."""
        if node is None:
            return b""
        enc = rlp.encode(node)
        if len(enc) < 32:
            return node
        h = keccak256(enc)
        self.nodes[h] = enc
        return h

    def _insert_ref(self, ref, path: List[int], value: bytes) -> list:
        node = self._resolve(ref) if ref is not None else []
        return self._insert_node(node, path, value)

    def _insert_node(self, node: list, path: List[int],
                     value: bytes) -> list:
        if not node:
            return [compact_encode(path, True), value]
        if len(node) == 17:
            node = list(node)
            if not path:
                node[16] = value
                return node
            child = node[path[0]]
            new_child = self._insert_ref(
                child if child != b"" else None, path[1:], value
            )
            node[path[0]] = self._node_ref(new_child)
            return node
        # extension or leaf
        nibs, is_leaf = compact_decode(bytes(node[0]))
        common = 0
        while (common < len(nibs) and common < len(path)
               and nibs[common] == path[common]):
            common += 1
        if is_leaf and common == len(nibs) and common == len(path):
            return [node[0], value]  # overwrite
        if not is_leaf and common == len(nibs):
            new_child = self._insert_ref(node[1], path[common:], value)
            return [node[0], self._node_ref(new_child)]
        # split
        branch: list = [b""] * 17
        if is_leaf:
            if common == len(nibs):
                branch[16] = node[1]
            else:
                rest = nibs[common:]
                sub = [compact_encode(rest[1:], True), node[1]]
                branch[rest[0]] = self._node_ref(sub)
        else:
            rest = nibs[common:]
            if len(rest) == 1:
                branch[rest[0]] = node[1]
            else:
                sub = [compact_encode(rest[1:], False), node[1]]
                branch[rest[0]] = self._node_ref(sub)
        if common == len(path):
            branch[16] = value
        else:
            rest_p = path[common:]
            sub = [compact_encode(rest_p[1:], True), value]
            branch[rest_p[0]] = self._node_ref(sub)
        if common:
            return [compact_encode(path[:common], False),
                    self._node_ref(branch)]
        return branch

    # -- delete -------------------------------------------------------------
    def _delete_ref(self, ref, path: List[int]):
        if ref is None:
            return None
        node = self._resolve(ref)
        if not node:
            return None
        out = self._delete_node(node, path)
        return out

    def _delete_node(self, node: list, path: List[int]):
        if len(node) == 17:
            node = list(node)
            if not path:
                node[16] = b""
            else:
                child = node[path[0]]
                if child == b"":
                    return node  # nothing to delete
                new_child = self._delete_ref(child, path[1:])
                node[path[0]] = (b"" if new_child is None
                                 else self._node_ref(new_child))
            return self._collapse_branch(node)
        nibs, is_leaf = compact_decode(bytes(node[0]))
        if is_leaf:
            return None if path == nibs else node
        if path[: len(nibs)] != nibs:
            return node
        new_child = self._delete_ref(node[1], path[len(nibs):])
        if new_child is None:
            return None
        if len(new_child) == 2:
            cn, cl = compact_decode(bytes(new_child[0]))
            return [compact_encode(nibs + cn, cl), new_child[1]]
        return [node[0], self._node_ref(new_child)]

    def _collapse_branch(self, node: list):
        children = [(i, c) for i, c in enumerate(node[:16]) if c != b""]
        has_val = node[16] != b""
        if len(children) + (1 if has_val else 0) > 1:
            return node
        if has_val and not children:
            return [compact_encode([], True), node[16]]
        if not children:
            return None
        idx, ref = children[0]
        child = self._resolve(ref)
        if len(child) == 17:
            return [compact_encode([idx], False), self._node_ref(child)]
        cn, cl = compact_decode(bytes(child[0]))
        return [compact_encode([idx] + cn, cl), child[1]]

    # -- witness collection --------------------------------------------------
    def collect_path_nodes(self, key: bytes) -> List[bytes]:
        """All node RLPs touched reading `key` (for witness building)."""
        out: List[bytes] = []
        if self.root == EMPTY_ROOT:
            return out

        def walk(ref, path):
            if isinstance(ref, (bytes, bytearray)) and len(ref) == 32:
                raw = self.nodes.get(bytes(ref))
                if raw is None:
                    raise MissingNode(bytes(ref).hex())
                out.append(raw)
                node = rlp.decode(raw)
            else:
                node = self._resolve(ref)
            if not node:
                return
            if len(node) == 17:
                if path and node[path[0]] != b"":
                    walk(node[path[0]], path[1:])
                return
            nibs, is_leaf = compact_decode(bytes(node[0]))
            if not is_leaf and path[: len(nibs)] == nibs:
                walk(node[1], path[len(nibs):])

        walk(self.root, nibbles(key))
        return out


def secure_key(raw: bytes) -> bytes:
    """Secure-trie key: keccak of the raw key (address / storage slot)."""
    return keccak256(raw)
