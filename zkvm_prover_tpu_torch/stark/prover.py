"""Single-AIR STARK prover (uni-stark) on torch tensors.

The reference's `zkvm_prover_tpu/stark/prover.py`, same transcript order:

  trace -> coset LDE -> Poseidon2 Merkle commit -> alpha -> constraint /
  quotient pass -> chunk split + commit -> zeta -> out-of-domain openings
  -> gamma -> DEEP combination -> FRI commit/fold/query + PoW -> openings.

The quotient q = (sum_i alpha^i c_i) / Z_H has degree < 2n; it is split into
2 chunks (its restrictions to the two size-n cosets of the LDE domain),
re-extended and committed as 8 base columns. The verifier rebuilds q(zeta)
from the chunk openings.

Kernels on this path: K1 (NTT butterflies) in every LDE, K2 (Poseidon2) in
every commitment and the PoW grind, K3 (exact base x ext products) in the
out-of-domain openings and the DEEP column sums. The rest is plain torch on
the same device. `prove` runs on the card unless given `device="cpu"`.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..fields import babybear as bb
from ..fields import ext4
from ..models.air import Air, LdeBuilder, LOG_QUOTIENT_DEGREE
from ..ops import mont_matmul as mm
from ..ops import ntt
from ..utils import ext_np
from . import domain, fri, merkle
from .challenger import Challenger
from .config import StarkConfig, resolve_device


@dataclass
class QueryOpening:
    """Merkle openings of the trace/quotient trees at one LDE index."""

    index: int
    trace: merkle.Opening
    quotient: merkle.Opening


@dataclass
class StarkProof:
    log_n: int
    width: int
    public_values: List[int]                 # canonical ints
    trace_root: np.ndarray                   # (8,) Montgomery uint32
    quotient_root: np.ndarray
    opened_trace_zeta: np.ndarray            # (w, 4) Montgomery
    opened_trace_zeta_next: np.ndarray       # (w, 4)
    opened_quotient: np.ndarray              # (2, 4, 4): chunk, basecol, extcoord
    fri_proof: fri.FriProof
    query_openings: Dict[int, QueryOpening] = field(default_factory=dict)
    stat: Dict[str, float] = field(default_factory=dict)


def _observe_opened(challenger: Challenger, *arrays):
    for a in arrays:
        challenger.observe_slice(np.asarray(a, dtype=np.uint32).reshape(-1))


# The stages between the Fiat-Shamir interactions, shared by `prove` (with
# sampled challenges) and `stark.pipeline.make_prover_core` (with given ones).


def trace_lde_of(trace: torch.Tensor, log_blowup: int, g: int, canonical: bool = False):
    """Interpolate the (n, w) trace over H and extend it to the coset g*D:
    (c_rev, trace_lde), the bit-reversed coefficients and the (n << log_blowup,
    w) evaluations. A canonical trace becomes Montgomery in the INTT's last
    pass."""
    c_rev = ntt.interpolate_coset_rev(trace, 1, canonical=canonical)
    return c_rev, ntt.eval_coset_from_rev(c_rev, log_blowup, g)


def quotient_chunks(air: Air, trace_lde: torch.Tensor, sels: dict, pvs_m, alpha,
                    log_n: int, log_blowup: int, g: int):
    """The constraints folded by powers of alpha as they arrive, divided by
    Z_H, split into per-coset chunks and each re-extended: (chunk_crevs,
    chunk_lde), chunk_lde (m, 4 * chunks). pvs_m: Montgomery ints; alpha:
    (4,) ext Montgomery."""
    dev = trace_lde.device
    m = int(trace_lde.shape[0])
    builder = LdeBuilder(trace_lde, 1 << log_blowup, sels, pvs_m,
                         alpha=bb.as_tensor(alpha, dev))
    air.eval(builder)
    c_folded = builder.folded
    if c_folded is None:
        c_folded = torch.zeros((m, 4), dtype=bb.DTYPE, device=dev)
    del builder
    q = bb.mul(c_folded, sels["inv_zh"][:, None])
    del c_folded

    n_chunks = 1 << LOG_QUOTIENT_DEGREE
    w_m_int = bb.two_adic_generator_int(log_n + log_blowup)
    chunk_crevs = []
    chunk_lde = torch.empty((m, 4 * n_chunks), dtype=bb.DTYPE, device=dev)
    for r in range(n_chunks):
        s_r = (g * pow(w_m_int, r, bb.P)) % bb.P
        # q[r::n_chunks]: the (n, 4) evals on (g w_m^r) H, read in place
        cr = ntt.interpolate_coset_rev(q[r::n_chunks], s_r)
        chunk_crevs.append(cr)
        ntt.eval_coset_from_rev(cr, log_blowup, g, out=chunk_lde[:, 4 * r:4 * r + 4])
    return chunk_crevs, chunk_lde


def zeta_next_of(zeta: np.ndarray, log_n: int) -> np.ndarray:
    """zeta * g_H, Montgomery (4,)."""
    g_h = bb.two_adic_generator_int(log_n)
    return bb.to_monty_np(np.asarray(ext_np.scale(ext_np.from_monty(zeta), g_h),
                                     dtype=np.uint64))


def ood_openings(c_rev: torch.Tensor, chunk_crevs, zeta: np.ndarray, log_n: int):
    """The out-of-domain openings: (zeta_next, t_at_z (w, 4), t_at_zn (w, 4),
    q_at_z (4 * chunks, 4)), numpy Montgomery."""
    dev = c_rev.device
    zeta_next = zeta_next_of(zeta, log_n)
    zeta_t = bb.as_tensor(zeta, dev)
    # zeta and zeta * g_H from one read of the coefficients
    t_at_z, t_at_zn = (bb.to_numpy(t) for t in ntt.eval_poly_at_points_ext(
        c_rev, [zeta_t, bb.as_tensor(zeta_next, dev)]))
    q_at_z = np.concatenate(
        [bb.to_numpy(ntt.eval_poly_at_point_ext(cr, zeta_t)) for cr in chunk_crevs], axis=0)
    return zeta_next, t_at_z, t_at_zn, q_at_z


def _deep_combine(trace_lde, chunk_lde, x, zeta, zeta_next,
                  t_at_z, t_at_zn, q_at_z, gamma):
    """The DEEP codeword on the LDE domain:
        F(x) = sum_j g^j (t_j(x) - t_j(z)) / (x - z)
             + sum_j g^(w+j) (t_j(x) - t_j(z g_H)) / (x - z g_H)
             + sum_k g^(2w+k) (q_k(x) - q_k(z)) / (x - z).
    Each column sum splits into a base x ext product over the LDE (kernel
    K3; the two trace sums share one read of trace_lde) minus a constant sum
    over the opened values (python ints).
    trace_lde (m, w), chunk_lde (m, 8); zeta etc. numpy (4,) Montgomery;
    t_at_z / t_at_zn (w, 4), q_at_z (8, 4) numpy Montgomery."""
    dev = trace_lde.device
    w = trace_lde.shape[1]
    n_q = chunk_lde.shape[1]
    gammas_c = ext_np.powers(ext_np.from_monty(gamma), 2 * w + n_q)
    gammas = bb.as_tensor(bb.to_monty_np(np.asarray(gammas_c, dtype=np.uint64)), dev)

    def const_sum(opened, gs):
        acc = [0, 0, 0, 0]
        for o, g in zip(ext_np.from_monty(opened), gs):
            acc = ext_np.add(acc, ext_np.mul(o, g))
        return acc

    k1 = const_sum(t_at_z, gammas_c[:w])
    k2 = const_sum(t_at_zn, gammas_c[w:2 * w])
    k3 = const_sum(q_at_z, gammas_c[2 * w:])

    x_ext = ext4.from_base(x)
    inv_xz = ext4.inv(ext4.sub(x_ext, bb.as_tensor(zeta, dev)))
    inv_xzn = ext4.inv(ext4.sub(x_ext, bb.as_tensor(zeta_next, dev)))
    # both opened points' sums from one read of the trace: (m, w) @ (w, 8)
    s12 = mm.mont_matmul(trace_lde, torch.cat([gammas[:w], gammas[w:2 * w]], dim=1))
    s1, s2 = s12[:, :4], s12[:, 4:]
    s3 = mm.mont_matmul(chunk_lde, gammas[2 * w:].contiguous())
    a = ext4.sub(ext4.add(s1, s3), ext4.from_ints(ext_np.add(k1, k3), dev))
    b = ext4.sub(s2, ext4.from_ints(k2, dev))
    return ext4.add(ext4.mul(a, inv_xz), ext4.mul(b, inv_xzn))


class _Phases:
    """Wall-clock per phase; each phase ends in a device synchronize, and a
    name marked again (a phase run once per AIR) adds up. On the card each
    mark also reads the running peak of allocated bytes
    (`torch.cuda.max_memory_allocated`, never reset here): the phase where
    it rises is where the peak was reached."""

    def __init__(self, device):
        self.device = device
        self.times = {}
        self.peaks = {}
        self._t = time.perf_counter()

    def mark(self, name):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            self.peaks[name] = torch.cuda.max_memory_allocated(self.device)
        now = time.perf_counter()
        self.times[name] = self.times.get(name, 0.0) + (now - self._t) * 1e3
        self._t = now

    def stat(self):
        out = {f"{k}_ms": v for k, v in self.times.items()}
        out.update({f"{k}_peak_bytes": v for k, v in self.peaks.items()})
        return out


def prove(
    air: Air,
    trace: np.ndarray,
    public_values: List[int],
    config: Optional[StarkConfig] = None,
    device=None,
) -> StarkProof:
    """Prove one AIR over a power-of-two-height trace.

    trace: (n, w) canonical uint32 host array. device: None (the card) or an
    explicit torch device. `stat` holds per-phase wall-clock in ms."""
    t_start = time.perf_counter()
    dev = resolve_device(device)
    config = config or StarkConfig()
    n, w = int(trace.shape[0]), int(trace.shape[1])
    if n & (n - 1) or n < 2:
        raise ValueError("trace height must be a power of two >= 2")
    log_n = n.bit_length() - 1
    log_blowup = config.log_blowup
    if log_blowup != 1:
        raise ValueError("the quotient split assumes blowup 2")
    m = n << log_blowup
    g = config.coset_shift % bb.P
    phases = _Phases(dev)

    challenger = Challenger()
    challenger.observe_canonical_u32(log_n)
    challenger.observe_canonical_u32(w)
    for pv in public_values:
        challenger.observe_canonical_u32(int(pv))

    # 1. trace LDE and commitment
    # the trace is canonical: the INTT's last pass converts it to Montgomery
    c_rev, trace_lde = trace_lde_of(bb.as_tensor(trace, dev), log_blowup, g, canonical=True)
    phases.mark("lde")
    tree_t = merkle.commit([trace_lde])
    challenger.observe_slice(tree_t.root_np())
    alpha = challenger.sample_ext()
    phases.mark("trace_commit")

    # 2-3. constraints folded by alpha, / Z_H, split into chunks, re-extended
    sels = domain.selectors_on_coset(log_n, log_blowup, g, dev)
    pvs_m = [bb.to_monty_int(int(v) % bb.P) for v in public_values]
    chunk_crevs, chunk_lde = quotient_chunks(air, trace_lde, sels, pvs_m, alpha,
                                             log_n, log_blowup, g)
    phases.mark("constraints_quotient")
    tree_q = merkle.commit([chunk_lde])
    challenger.observe_slice(tree_q.root_np())
    zeta = challenger.sample_ext()
    phases.mark("quotient_commit")

    # 4. out-of-domain openings
    zeta_next, t_at_z, t_at_zn, q_at_z = ood_openings(c_rev, chunk_crevs, zeta, log_n)
    del c_rev, chunk_crevs
    _observe_opened(challenger, t_at_z, t_at_zn, q_at_z)
    gamma = challenger.sample_ext()
    phases.mark("ood")

    # 5. DEEP combination + FRI
    codeword = _deep_combine(trace_lde, chunk_lde, sels["x"], zeta, zeta_next,
                             t_at_z, t_at_zn, q_at_z, gamma)
    phases.mark("deep")
    fri_proof = fri.prove(codeword, log_n + log_blowup, g, config.fri,
                          challenger, mark=phases.mark)
    del codeword

    # 6. open both trees at all queried positions and their siblings
    half = m // 2
    positions = set()
    for q0 in fri_proof.query_indices:
        qq = q0 % half
        positions.add(qq)
        positions.add(qq + half)
    positions = sorted(positions)
    t_ops = merkle.open_indices(tree_t, positions)
    q_ops = merkle.open_indices(tree_q, positions)
    query_openings = {
        pos: QueryOpening(index=pos, trace=to, quotient=qo)
        for pos, to, qo in zip(positions, t_ops, q_ops)
    }
    phases.mark("openings")

    stat = {"proving_time_mills": (time.perf_counter() - t_start) * 1e3,
            "trace_height": n, "trace_width": w}
    stat.update(phases.stat())
    return StarkProof(
        log_n=log_n,
        width=w,
        public_values=[int(v) for v in public_values],
        trace_root=tree_t.root_np(),
        quotient_root=tree_q.root_np(),
        opened_trace_zeta=t_at_z,
        opened_trace_zeta_next=t_at_zn,
        opened_quotient=q_at_z.reshape(1 << LOG_QUOTIENT_DEGREE, 4, 4),
        fri_proof=fri_proof,
        query_openings=query_openings,
        stat=stat,
    )
