"""Sharded FRI fold (the reference's `parallel/fri_sharded.py`).

One fold pairs row i of the first half with row i + m/2. With the codeword
row-sharded contiguously over D shards, the partners live on shards d and
d + D/2: fold output block o needs half a block from shard o//2 and half a
block from shard D/2 + o//2, so the fold runs as four routed copies
(`ppermute`: lo/hi x even/odd output halves) and a local combine. Equal to
`stark.fri.fold_round` bit for bit. The fold is plain torch, as the
single-device one is.
"""

from __future__ import annotations

from ..fields import babybear as bb
from ..stark.fri import fold_halves, inv_denoms_np
from .mesh import Mesh, Sharded, ext_on, on, ppermute, shard_rows


def fold_round_sharded(codeword, log_m: int, shift_int: int, beta,
                       mesh: Mesh) -> Sharded:
    """codeword: (m, 4), rows sharded (a tensor is sharded first); beta:
    (4,) ext Montgomery. Returns the folded (m/2, 4), rows sharded."""
    D = mesh.shape["shard"]
    m = 1 << log_m
    if m % (2 * D) or D & (D - 1):
        raise ValueError("need a power-of-two mesh axis and >= 2 rows per shard")
    parts = codeword if isinstance(codeword, Sharded) and codeword.axis == 0 \
        else shard_rows(mesh, codeword)
    devs = mesh.devices()
    piece = m // (2 * D)          # rows each output shard takes from each side
    inv_d = inv_denoms_np(log_m, shift_int % bb.P)   # (m/2,)
    b0 = [p[:piece] for p in parts.parts]
    b1 = [p[piece:] for p in parts.parts]
    if D == 1:
        lo, hi = b0, b1
    else:
        half = D // 2
        ra = ppermute(b0, devs, [(s, 2 * s) for s in range(half)])
        rb = ppermute(b1, devs, [(s, 2 * s + 1) for s in range(half)])
        rc = ppermute(b0, devs, [(half + s, 2 * s) for s in range(half)])
        rd = ppermute(b1, devs, [(half + s, 2 * s + 1) for s in range(half)])
        lo = [a if a is not None else b for a, b in zip(ra, rb)]
        hi = [c if c is not None else e for c, e in zip(rc, rd)]
    out = []
    for o, dev in enumerate(devs):
        with on(dev):
            inv_o = bb.as_tensor(inv_d[o * piece:(o + 1) * piece], dev)
            out.append(fold_halves(lo[o], hi[o], inv_o, ext_on(beta, dev)))
    return Sharded(out, 0, (m // 2, 4))
