"""Row-sharded Poseidon2 Merkle root (the reference's
`parallel/merkle_sharded.py`): leaves hashed on each shard, each shard's
subtree folded to one digest, the D digests gathered and the top of the
tree finished on shard 0's device.

The root equals `stark.merkle.commit([matrix]).root` bit for bit, because
contiguous row shards of a power-of-two height are whole subtrees. Each
shard's leaves and levels go through kernel K2 (`hash_rows`,
`compress_levels`) on a CUDA shard.
"""

from __future__ import annotations

import torch

from ..ops import poseidon2 as p2
from .mesh import Mesh, Sharded, all_gather, on, shard_rows


def _fold(digests: torch.Tensor) -> torch.Tensor:
    """(s, 8) digests, s a power of two -> the (1, 8) subtree root."""
    levels = digests.shape[0].bit_length() - 1
    return digests if levels == 0 else p2.compress_levels(digests, levels)[-1]


def commit_root_sharded(matrix, mesh: Mesh) -> torch.Tensor:
    """Merkle root of one (h, w) matrix with rows sharded over the mesh:
    the (8,) digest on shard 0's device."""
    parts = matrix if isinstance(matrix, Sharded) and matrix.axis == 0 \
        else shard_rows(mesh, matrix)
    h = parts.shape[0]
    d = mesh.shape["shard"]
    if h % d or (h // d) & (h // d - 1):
        raise ValueError(f"{h} rows do not split into {d} power-of-two subtrees")
    devs = mesh.devices()
    tops = []
    for blk, dev in zip(parts.parts, devs):
        with on(dev):
            tops.append(_fold(p2.hash_rows(blk.reshape(blk.shape[0], -1))))
    with on(devs[0]):
        return _fold(torch.cat(all_gather(tops, devs[0]), dim=0))[0]
