"""The prover core sharded over a mesh (the reference's
`parallel/pipeline_sharded.py`): `stark.pipeline.make_prover_core`'s stages
with rows sharded, bit-identical to it.

  - interpolation and LDE: four-step transforms with one all_to_all each
    (`ntt_sharded.py`, K1 on every shard);
  - Merkle roots: leaves and subtrees per shard, the D tops gathered
    (`merkle_sharded.py`, K2);
  - constraint eval and quotient: per row shard, the AIR's next-row view
    extended by a `blowup`-row halo from the next shard (`ppermute`);
  - out-of-domain openings: each shard's partial sum is a base x ext
    product (K3) against its bit-reversed power ladder of z^D scaled by
    z^bitrev_d(s); the D partials are gathered and summed;
  - DEEP combination: row-local, per shard (K3 for its column sums);
  - first FRI fold: `fri_sharded.py`.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..fields import babybear as bb
from ..fields import ext4
from ..models.air import Air, LdeBuilder, LOG_QUOTIENT_DEGREE
from ..ops import mont_matmul as mm
from ..ops import ntt
from ..stark import domain
from ..stark.config import StarkConfig
from ..stark.pipeline import ext_np_of, monty_ints
from ..stark.prover import _deep_combine, zeta_next_of
from .fri_sharded import fold_round_sharded
from .merkle_sharded import commit_root_sharded
from .mesh import Mesh, Sharded, all_gather, ext_on, on, ppermute, shard_rows
from .ntt_sharded import eval_coset_from_rev_sharded, interpolate_coset_rev_sharded


def _pow2k(z, k: int):
    for _ in range(k):
        z = ext4.mul(z, z)
    return z


def eval_poly_at_points_ext_sharded(coeffs_rev, points, mesh: Mesh) -> List[torch.Tensor]:
    """Sharded `ops.ntt.eval_poly_at_points_ext`: (W, 4) per point, on shard
    0's device.

    coeffs_rev: (n, W) bit-reversed base coefficients, rows sharded. For
    j = s*(n/D) + t, bitrev(j) = bitrev_k(t)*D + bitrev_d(s): shard s
    takes the ladder of (z^D)^bitrev_k(t) scaled by z^bitrev_d(s), one K3
    product over its rows for all points at once, and the D partial sums
    are gathered and added."""
    rows = coeffs_rev if isinstance(coeffs_rev, Sharded) and coeffs_rev.axis == 0 \
        else shard_rows(mesh, coeffs_rev)
    n = rows.shape[0]
    devs = mesh.devices()
    D = len(devs)
    d = D.bit_length() - 1
    log_k = ntt._log2(n) - d
    parts = []
    for s, (blk, dev) in enumerate(zip(rows.parts, devs)):
        with on(dev):
            ladders = []
            for z in points:
                z = ext_on(z, dev)
                zs = ntt.powers_bitrev_ext(z, d)[s]
                ladders.append(ext4.mul(ntt.powers_bitrev_ext(_pow2k(z, d), log_k), zs))
            parts.append(mm.mont_matmul(blk.reshape(blk.shape[0], -1),
                                        torch.cat(ladders, dim=1), transpose_a=True))
    gathered = all_gather(parts, devs[0])
    total = gathered[0]
    for p in gathered[1:]:
        total = bb.add(total, p)
    return [total[:, 4 * i:4 * i + 4] for i in range(len(points))]


def eval_poly_at_point_ext_sharded(coeffs_rev, point_ext, mesh: Mesh) -> torch.Tensor:
    """Sharded `ops.ntt.eval_poly_at_point_ext`: (W, 4)."""
    return eval_poly_at_points_ext_sharded(coeffs_rev, [point_ext], mesh)[0]


class _ShardBuilder(LdeBuilder):
    """`LdeBuilder` over one row block with an explicit next-row view: the
    block's rows from `blowup` on, then the halo (the next shard's first
    `blowup` rows) in place of the global roll."""

    def __init__(self, block, halo, sels, public_values, alpha):
        super().__init__(block, halo.shape[0], sels, public_values, alpha=alpha)
        self._halo = halo.t().contiguous()

    def next(self, col):
        return torch.cat([self._cols[col, self._blowup:], self._halo[col]])

    def preprocessed(self, col):
        raise NotImplementedError(
            "make_prover_core_sharded has no halo-extended preprocessed LDE; "
            "AIRs with preprocessed columns (program ROM, range tables) use "
            "the single-device core")

    def preprocessed_next(self, col):
        self.preprocessed(col)


def _shard_sels(sels: dict, mesh: Mesh) -> List[dict]:
    """Each shard's rows of the selector vectors."""
    devs = mesh.devices()
    split = {k: shard_rows(mesh, v).parts for k, v in sels.items()}
    return [{k: split[k][s] for k in sels} for s in range(len(devs))]


def quotient_sharded(air: Air, trace_lde: Sharded, sels, pvs_m, alpha, mesh: Mesh,
                     log_blowup: int) -> Sharded:
    """Constraint eval folded by alpha and divided by Z_H, rows sharded.

    The next-row view is a global roll by `blowup`: each shard sends its
    first `blowup` rows to the previous shard (cyclically, as the roll
    wraps). sels: the single-device selector dict, or a list of per-shard
    dicts."""
    blowup = 1 << log_blowup
    devs = mesh.devices()
    D = len(devs)
    lde = trace_lde if isinstance(trace_lde, Sharded) and trace_lde.axis == 0 \
        else shard_rows(mesh, trace_lde)
    sels_local = sels if isinstance(sels, list) else _shard_sels(sels, mesh)
    halos = ppermute([p[:blowup] for p in lde.parts], devs,
                     [(s, (s - 1) % D) for s in range(D)])
    pvs = monty_ints(pvs_m)
    out = []
    for blk, halo, sl, dev in zip(lde.parts, halos, sels_local, devs):
        with on(dev):
            builder = _ShardBuilder(blk, halo, sl, pvs, ext_on(alpha, dev))
            air.eval(builder)
            folded = builder.folded
            if folded is None:
                folded = torch.zeros((blk.shape[0], 4), dtype=bb.DTYPE, device=dev)
            del builder
            out.append(bb.mul(folded, sl["inv_zh"][:, None]))
    return Sharded(out, 0, (lde.shape[0], 4))


def make_prover_core_sharded(air: Air, log_n: int, config, mesh: Mesh):
    """`stark.pipeline.make_prover_core` over `mesh`: the same call
    core(trace_m, pvs_m, alpha, zeta, gamma) and the same (trace_root,
    quotient_root, codeword, folded) values, bit for bit. The roots are (8,)
    tensors on shard 0's device; codeword and folded are row-sharded
    (`Sharded`, `.gather()` joins them)."""
    config = config or StarkConfig()
    log_blowup = config.log_blowup
    g = config.coset_shift % bb.P
    w_m_int = bb.two_adic_generator_int(log_n + log_blowup)
    n_chunks = 1 << LOG_QUOTIENT_DEGREE
    devs = mesh.devices()
    sels = domain.selectors_on_coset(log_n, log_blowup, g, devs[0])
    sels_local = _shard_sels(sels, mesh)

    def core(trace_m, pvs_m, alpha, zeta, gamma):
        alpha, zeta, gamma = (ext_np_of(v) for v in (alpha, zeta, gamma))
        c_rev = interpolate_coset_rev_sharded(trace_m, mesh, 1)
        trace_lde = eval_coset_from_rev_sharded(c_rev, log_blowup, g, mesh)
        trace_root = commit_root_sharded(trace_lde, mesh)

        q = quotient_sharded(air, trace_lde, sels_local, pvs_m, alpha, mesh,
                             log_blowup)
        chunk_crevs, chunk_ldes = [], []
        for r in range(n_chunks):
            s_r = (g * pow(w_m_int, r, bb.P)) % bb.P
            # q[r::n_chunks] is row-sharded as q is: shard s holds its rows r::n_chunks
            chunk = Sharded([p[r::n_chunks] for p in q.parts], 0, (q.shape[0] // n_chunks, 4))
            cr = interpolate_coset_rev_sharded(chunk, mesh, s_r)
            chunk_crevs.append(cr)
            chunk_ldes.append(eval_coset_from_rev_sharded(cr, log_blowup, g, mesh))
        chunk_lde = Sharded([torch.cat([c.parts[s] for c in chunk_ldes], dim=1)
                             for s in range(len(devs))], 0, (q.shape[0], 4 * n_chunks))
        q_root = commit_root_sharded(chunk_lde, mesh)

        zeta_next = zeta_next_of(zeta, log_n)
        t_at_z, t_at_zn = (bb.to_numpy(t) for t in eval_poly_at_points_ext_sharded(
            c_rev, [zeta, zeta_next], mesh))
        q_at_z = np.concatenate([bb.to_numpy(eval_poly_at_point_ext_sharded(
            cr, zeta, mesh)) for cr in chunk_crevs], axis=0)
        parts = []
        for s, dev in enumerate(devs):
            with on(dev):
                parts.append(_deep_combine(trace_lde.parts[s], chunk_lde.parts[s],
                                           sels_local[s]["x"], zeta, zeta_next,
                                           t_at_z, t_at_zn, q_at_z, gamma))
        codeword = Sharded(parts, 0, (q.shape[0], 4))
        folded = fold_round_sharded(codeword, log_n + log_blowup, g, zeta, mesh)
        return trace_root, q_root, codeword, folded

    return core
