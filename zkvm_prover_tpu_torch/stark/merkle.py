"""Mixed-height Merkle commitment (MMCS) with Poseidon2, on tensors.

The reference's `zkvm_prover_tpu/stark/merkle.py`: leaf layers are batched
row sponges and the levels between two heights at which matrices join are
built by one `compress_levels` call (kernel K2 on the card, up to ten levels
per launch).

  - matrices: (h_i, w_i) int32 (Montgomery), h_i powers of two, h_max = max.
  - leaf level: D = hash_rows(the height-h_max rows, concatenated).
  - from size 2s to s: D'[i] = compress(D[2i], D[2i+1]); if matrices of
    height s exist, D'[i] <- compress(D'[i], hash_rows(their rows)[i]).
  - root = the single digest at size 1.

Openings are gathered on the device for all queried indices of a tree at
once (one `index_select` per level) and copied to the host in one transfer.
Verification is host numpy (`verify_openings`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch

from ..fields import babybear as bb
from ..ops import poseidon2 as p2

DIGEST = p2.DIGEST


@dataclass
class MerkleTree:
    """Commitment: per-level digest tensors, tallest first; levels[0] is
    (h_max, 8), levels[-1] is (1, 8). The matrices stay for openings."""

    matrices: List[torch.Tensor]
    levels: List[torch.Tensor]

    @property
    def root(self) -> torch.Tensor:
        return self.levels[-1][0]

    def root_np(self) -> np.ndarray:
        return bb.to_numpy(self.root)


def _rows_digest(mats: Sequence[torch.Tensor]) -> torch.Tensor:
    cat = mats[0] if len(mats) == 1 else torch.cat(list(mats), dim=1)
    return p2.hash_rows(cat.contiguous())


def commit(matrices: Sequence[torch.Tensor]) -> MerkleTree:
    by_height = {}
    for m in matrices:
        h = int(m.shape[0])
        if h & (h - 1) or h == 0:
            raise ValueError("matrix heights must be powers of two")
        by_height.setdefault(h, []).append(m)
    heights = sorted(set(by_height) | {1}, reverse=True)
    d = _rows_digest(by_height[heights[0]])
    levels = [d]
    s = heights[0]
    for stop in heights[1:]:  # each height below h_max that joins, then 1
        levels += p2.compress_levels(d, (s // stop).bit_length() - 1)
        d, s = levels[-1], stop
        if s in by_height:
            d = levels[-1] = p2.compress(d, _rows_digest(by_height[s]))
    return MerkleTree(matrices=list(matrices), levels=levels)


@dataclass
class Opening:
    """Host-side opening for one leaf index: per-matrix rows + digest path."""

    index: int
    rows: List[np.ndarray]          # in the order the matrices were committed
    siblings: List[np.ndarray]      # sibling digest per level, bottom-up


def open_indices(tree: MerkleTree, indices: Sequence[int]) -> List[Opening]:
    """Openings of many leaf indices: gathered on the device per matrix and
    per level, then copied to the host once."""
    indices = [int(i) for i in indices]
    if not indices:
        return []
    h_max = int(tree.levels[0].shape[0])
    dev = tree.levels[0].device
    idx = torch.tensor(indices, dtype=torch.int64, device=dev)
    parts = []
    for m in tree.matrices:
        shift = (h_max // int(m.shape[0])).bit_length() - 1
        parts.append(m.index_select(0, idx >> shift))
    for k in range(len(tree.levels) - 1):
        parts.append(tree.levels[k].index_select(0, (idx >> k) ^ 1))
    host = bb.to_numpy(torch.cat(parts, dim=1))
    widths = [int(p.shape[1]) for p in parts]
    cuts = np.cumsum([0] + widths)
    n_mat = len(tree.matrices)
    out = []
    for q, index in enumerate(indices):
        row = host[q]
        pieces = [row[cuts[j]:cuts[j + 1]].copy() for j in range(len(parts))]
        out.append(Opening(index=index, rows=pieces[:n_mat],
                           siblings=pieces[n_mat:]))
    return out


def _stack(arrays, width=None):
    """Stack host rows; None if any is ragged or has the wrong width."""
    rows = [np.asarray(a) for a in arrays]
    w = rows[0].shape if width is None else (width,)
    if any(r.shape != w for r in rows):
        return None
    return np.stack(rows).astype(np.uint32)


def verify_openings(root: np.ndarray, openings: Sequence[Opening],
                    heights: Sequence[int]) -> bool:
    """Batch-verify the openings of ONE tree (same heights, same root): each
    level is one numpy compression over (Q, 8) digests. Malformed openings
    (wrong counts, ragged rows or siblings, bad indices) return False."""
    if not openings:
        return True
    n_sib = len(openings[0].siblings)
    if any(len(op.siblings) != n_sib or len(op.rows) != len(heights)
           for op in openings):
        return False
    by_height = {}
    for j, h in enumerate(heights):
        stacked = _stack([op.rows[j] for op in openings])
        if stacked is None or stacked.ndim != 2:
            return False
        by_height.setdefault(int(h), []).append(stacked)
    h_max = max(by_height)
    if h_max.bit_length() - 1 != n_sib:
        return False

    def digest_of(hh):
        mats = by_height[hh]
        cat = mats[0] if len(mats) == 1 else np.concatenate(mats, axis=1)
        return p2.hash_rows_np(np.ascontiguousarray(cat, dtype=np.uint32))

    d = digest_of(h_max)
    idx = np.asarray([op.index for op in openings], dtype=np.int64)
    if ((idx < 0) | (idx >= h_max)).any():
        return False
    s = h_max
    k = 0
    while s > 1:
        sib = _stack([op.siblings[k] for op in openings], DIGEST)
        if sib is None:
            return False
        left_is_d = (idx % 2 == 0)[:, None]
        left = np.where(left_is_d, d, sib)
        right = np.where(left_is_d, sib, d)
        d = p2.compress_np(left, right)
        idx >>= 1
        s //= 2
        k += 1
        if s in by_height:
            d = p2.compress_np(d, digest_of(s))
    root = np.asarray(root)
    if root.shape != (DIGEST,):
        return False
    return bool((d == root[None, :].astype(np.uint32)).all())
