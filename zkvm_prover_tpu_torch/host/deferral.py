"""Deferral data: Merkle commitments over per-child input_commits.

The envelope-parity analog of the reference's deferral machinery
(compute_deferral_data at crates/integration/src/lib.rs:461-514;
`deferral_merkle_proofs` attached to StarkProof at
crates/prover/src/prover/mod.rs:392-397): every aggregated child's
input_commit becomes a leaf of a Poseidon2 Merkle tree; the root plus one
membership path per child ride in the envelope's
`deferral_merkle_proofs` field, so external coordinators can check which
deferred child results a proof carries without decoding the machine proof.

Design divergence (documented): in this framework child proof VALIDITY is
established in-circuit (the reference's recursion/aggregation.py), so the
deferral tree binds *identities* (input_commits), not deferred
verification results — it is coordination metadata, not a soundness
dependency. The port's copy hashes with the port's host Poseidon2.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..models.poseidon2_air import permute_canonical

DIGEST_WORDS = 8


def _words(data: bytes) -> np.ndarray:
    assert len(data) == 32
    return np.frombuffer(data, dtype="<u4").astype(np.uint32)


def _compress(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    state = np.concatenate([left, right])[None, :].astype(np.uint32)
    return permute_canonical(state)[0, :DIGEST_WORDS]


def _leaves(input_commits: List[bytes]) -> List[np.ndarray]:
    n = max(1, len(input_commits))
    size = 1 << (n - 1).bit_length()
    leaves = [_words(c) for c in input_commits]
    leaves += [np.zeros(DIGEST_WORDS, dtype=np.uint32)] * (
        size - len(leaves)
    )
    return leaves


def deferral_tree(input_commits: List[bytes]
                  ) -> Tuple[bytes, List[List[bytes]]]:
    """Returns (root, per-leaf sibling paths bottom-up)."""
    level = _leaves(input_commits)
    paths: List[List[bytes]] = [[] for _ in level]
    pos = list(range(len(level)))  # current index of each original leaf
    while len(level) > 1:
        for leaf_i, p in enumerate(pos):
            paths[leaf_i].append(level[p ^ 1].tobytes())
            pos[leaf_i] = p // 2
        level = [
            _compress(level[2 * j], level[2 * j + 1])
            for j in range(len(level) // 2)
        ]
    root = level[0].tobytes()
    return root, paths[: len(input_commits)]


def verify_deferral_path(root: bytes, leaf_index: int, commit: bytes,
                         path: List[bytes]) -> bool:
    d = _words(commit)
    idx = leaf_index
    for sib_bytes in path:
        sib = np.frombuffer(sib_bytes, dtype="<u4").astype(np.uint32)
        if idx % 2 == 0:
            d = _compress(d, sib)
        else:
            d = _compress(sib, d)
        idx //= 2
    return d.tobytes() == root


# -- envelope codec ---------------------------------------------------------


def encode_deferral(input_commits: List[bytes]) -> bytes:
    """root || n || per-leaf (depth || siblings...) — the envelope bytes."""
    if not input_commits:
        return b""
    root, paths = deferral_tree(input_commits)
    out = [root, len(input_commits).to_bytes(4, "little")]
    for path in paths:
        out.append(len(path).to_bytes(2, "little"))
        out += path
    return b"".join(out)


def decode_and_verify(blob: bytes, input_commits: List[bytes]) -> bool:
    """Check an envelope's deferral bytes against its input_commits."""
    if not input_commits:
        return blob == b""
    if len(blob) < 36:
        return False
    root = blob[:32]
    n = int.from_bytes(blob[32:36], "little")
    if n != len(input_commits):
        return False
    off = 36
    for i, commit in enumerate(input_commits):
        if off + 2 > len(blob):
            return False
        depth = int.from_bytes(blob[off : off + 2], "little")
        off += 2
        path = []
        for _ in range(depth):
            if off + 32 > len(blob):
                return False
            path.append(blob[off : off + 32])
            off += 32
        if not verify_deferral_path(root, i, commit, path):
            return False
    return off == len(blob)
