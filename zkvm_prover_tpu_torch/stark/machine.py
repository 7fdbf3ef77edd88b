"""Multi-AIR machine proofs: many AIRs with mixed trace heights under one
transcript, logUp bus interactions, per-height commitments and one FRI with
per-height codeword injection.

The reference's `zkvm_prover_tpu/stark/machine.py` on tensors, same
transcript and same proof:

- Matrices are grouped by LDE height; each height gets one trace
  commitment, one permutation commitment (if an AIR at that height has
  interactions), one quotient commitment and, where AIRs have preprocessed
  columns, one preprocessed commitment.
- A height-2^l matrix lives on the coset shift(l) = g^(2^(L - l)), L the
  largest log-height: the coset the FRI fold chain reaches at that size, so
  lower codewords are injected into the fold as they are.
- Transcript: meta -> preprocessed roots -> trace roots -> (beta, z) ->
  perm roots + claimed sums -> alpha -> quotient roots -> zeta -> openings
  -> gamma -> FRI.
- Global logUp soundness: the per-AIR claimed sums add up to 0.

Kernels: K1 in every LDE (traces, permutation traces, preprocessed columns,
quotient chunks), K2 in every commitment and the PoW grind, K3 in the
out-of-domain openings (both points of a matrix from one read) and the DEEP
column sums (one call per matrix). The interaction columns, the constraint
pass with its alpha fold, the logUp constraints and the FRI fold with its
injections are plain torch on the same device. `prove_machine` runs on the
card unless given `device="cpu"`; `verify_machine` replays on the host and
recomputes the preprocessed commitments on the same default device.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..fields import babybear as bb
from ..fields import ext4
from ..models.air import (Air, LdeBuilder, PointBuilder, TraceBuilder,
                          LOG_QUOTIENT_DEGREE)
from ..ops import mont_matmul as mm
from ..ops import ntt
from ..utils import ext_np
from . import domain, fri, merkle, wellformed
from . import interactions as ilib
from .challenger import Challenger
from .config import StarkConfig, resolve_device
from .prover import _Phases, _observe_opened
from .verifier import fold_at_point, quotient_at_point

P = bb.P
N_CHUNKS = 1 << LOG_QUOTIENT_DEGREE


@dataclass
class AirInstance:
    air: Air
    trace: np.ndarray              # (n, w) canonical uint32
    public_values: List[int]


@dataclass
class OpenedValues:
    trace_zeta: np.ndarray         # (w, 4) Montgomery
    trace_zeta_next: np.ndarray    # (w, 4)
    quotient: np.ndarray           # (N_CHUNKS*4, 4)
    perm_zeta: Optional[np.ndarray] = None       # (4k+4, 4)
    perm_zeta_next: Optional[np.ndarray] = None
    pre_zeta: Optional[np.ndarray] = None        # (pw, 4)
    pre_zeta_next: Optional[np.ndarray] = None


@dataclass
class QueryOpening:
    trace: merkle.Opening
    quotient: merkle.Opening
    perm: Optional[merkle.Opening] = None
    pre: Optional[merkle.Opening] = None


@dataclass
class MachineProof:
    meta: List[Tuple[int, int, List[int]]]   # per AIR: (log_n, width, pvs)
    trace_roots: Dict[int, np.ndarray]       # log_m -> (8,)
    quotient_roots: Dict[int, np.ndarray]
    perm_roots: Dict[int, np.ndarray]        # heights with interactions only
    # heights with preprocessed columns only; the verifier recomputes these
    # from the Air definitions (verification-key material)
    pre_roots: Dict[int, np.ndarray] = field(default_factory=dict)
    claimed_sums: List[Optional[np.ndarray]] = field(default_factory=list)
    opened: List[OpenedValues] = field(default_factory=list)
    fri_proof: fri.FriProof = None
    query_openings: Dict[int, Dict[int, QueryOpening]] = field(
        default_factory=dict
    )
    stat: Dict[str, float] = field(default_factory=dict)


def _shift_for(log_m: int, log_max: int, g: int) -> int:
    return pow(g, 1 << (log_max - log_m), P)


def _ext_powers_host(x_monty_4, n: int) -> List[List[int]]:
    """[1, x, ..., x^(n-1)], canonical extension values."""
    return ext_np.powers(ext_np.from_monty(x_monty_4), n)


def _extract_interactions(air: Air, trace_m, pvs_m, pre_m=None):
    tb = TraceBuilder(trace_m, pvs_m, pre_m=pre_m)
    air.eval(tb)
    return tb.interactions


def _perm_ext_groups(perm_mat, k: int):
    """Split an (m, 4k+4) base matrix into k+1 ext-valued (m, 4) groups."""
    return [perm_mat[:, 4 * j:4 * j + 4] for j in range(k + 1)]


def _zeta_next(zeta, log_n: int) -> np.ndarray:
    g_h = bb.two_adic_generator_int(log_n)
    return bb.to_monty_np(np.asarray(
        ext_np.scale(ext_np.from_monty(zeta), g_h), dtype=np.uint64))


def _const_sum(opened, gammas_c) -> List[int]:
    """sum_j gamma_j * opened_j, canonical (opened: Montgomery (w, 4))."""
    acc = [0, 0, 0, 0]
    for o, gm in zip(ext_np.from_monty(opened), gammas_c):
        acc = ext_np.add(acc, ext_np.mul(o, gm))
    return acc


def _deep_terms(pairs, chunk_lde, q_open, gammas_c, gammas, gidx: int):
    """One AIR's DEEP column sums on its LDE domain, before the division:

        acc_z  = sum_i gamma^i (M_i(x) - M_i(zeta))       over the matrices
        acc_zn = sum_i gamma^i (M_i(x) - M_i(zeta g_H))   opened at each point

    pairs: (lde (m, w), opened at zeta, opened at zeta g_H) for the trace,
    permutation and preprocessed matrices, in that order; then the quotient
    chunks chunk_lde (m, 8), opened q_open (8, 4) at zeta alone. The gamma
    ladder runs matrix by matrix, zeta's powers before zeta g_H's. Each
    matrix is read once by kernel K3: one rows call with both points'
    powers side by side (k = 2), one call at k = 1 for the quotient.
    Returns (acc_z, acc_zn, next gamma index)."""
    dev = chunk_lde.device
    acc_z = acc_zn = None
    k_z, k_zn = [0, 0, 0, 0], [0, 0, 0, 0]
    for lde, o_z, o_zn in pairs:
        w = lde.shape[1]
        s = mm.mont_matmul(lde, torch.cat([gammas[gidx:gidx + w],
                                           gammas[gidx + w:gidx + 2 * w]], dim=1))
        acc_z = s[:, :4] if acc_z is None else ext4.add(acc_z, s[:, :4])
        acc_zn = s[:, 4:] if acc_zn is None else ext4.add(acc_zn, s[:, 4:])
        k_z = ext_np.add(k_z, _const_sum(o_z, gammas_c[gidx:gidx + w]))
        k_zn = ext_np.add(k_zn, _const_sum(o_zn, gammas_c[gidx + w:gidx + 2 * w]))
        gidx += 2 * w
    nq = chunk_lde.shape[1]
    acc_z = ext4.add(acc_z, mm.mont_matmul(chunk_lde, gammas[gidx:gidx + nq].contiguous()))
    k_z = ext_np.add(k_z, _const_sum(q_open, gammas_c[gidx:gidx + nq]))
    acc_z = ext4.sub(acc_z, ext4.from_ints(k_z, dev))
    acc_zn = ext4.sub(acc_zn, ext4.from_ints(k_zn, dev))
    return acc_z, acc_zn, gidx + nq


def _monty_columns(canon, block: int = 64):
    """The Montgomery form of a canonical (n, w) tensor, held as a (w, n)
    contiguous buffer (the builders' column layout, so a builder takes it
    without a copy) and returned as its (n, w) view. Converted a block of
    columns at a time: the int64 products of one conversion of the whole
    trace would take four times the trace's size."""
    n, w = canon.shape
    cols = torch.empty((w, n), dtype=bb.DTYPE, device=canon.device)
    for c0 in range(0, w, block):
        cols[c0:c0 + block] = bb.to_monty(canon[:, c0:c0 + block].t())
    return cols.t()


def _lde(evals, shift: int, log_blowup: int, canonical: bool = False):
    """(coefficients in bit-reversed order, LDE on shift * G_m)."""
    c_rev = ntt.interpolate_coset_rev(evals, 1, canonical=canonical)
    return c_rev, ntt.eval_coset_from_rev(c_rev, log_blowup, shift)


def _commit_by_height(ldes, log_ms, heights, ch: Challenger):
    """One tree per height over the matrices present there (None skipped),
    each root observed in height order."""
    trees = {}
    for lm in heights:
        mats = [x for x, l in zip(ldes, log_ms) if l == lm and x is not None]
        if mats:
            trees[lm] = merkle.commit(mats)
            ch.observe_slice(trees[lm].root_np())
    return trees


def prove_machine(
    instances: Sequence[AirInstance],
    config: Optional[StarkConfig] = None,
    device=None,
) -> MachineProof:
    """Prove several AIRs, each over a power-of-two-height trace (canonical
    uint32 host arrays), under one transcript. device: None (the card) or
    an explicit torch device. `stat` holds per-phase wall-clock in ms."""
    t_start = time.perf_counter()
    dev = resolve_device(device)
    config = config or StarkConfig()
    log_blowup = config.log_blowup
    if log_blowup != 1:
        raise ValueError("the quotient split assumes blowup 2")
    blowup = 1 << log_blowup
    g = config.coset_shift % P
    phases = _Phases(dev)

    metas, log_ms = [], []
    for inst in instances:
        n, w = int(inst.trace.shape[0]), int(inst.trace.shape[1])
        if n & (n - 1) or n < 2:
            raise ValueError("trace heights must be powers of two >= 2")
        metas.append((n.bit_length() - 1, w, [int(v) for v in inst.public_values]))
        log_ms.append(n.bit_length() - 1 + log_blowup)
    log_max = max(log_ms)
    heights = sorted(set(log_ms), reverse=True)
    shifts = [_shift_for(lm, log_max, g) for lm in log_ms]
    n_airs = len(instances)

    ch = Challenger()
    ch.observe_canonical_u32(n_airs)
    for (log_n, w, pvs) in metas:
        ch.observe_canonical_u32(log_n)
        ch.observe_canonical_u32(w)
        for pv in pvs:
            ch.observe_canonical_u32(pv)
    pvs_ms = [[bb.to_monty_int(v % P) for v in pvs] for (_, _, pvs) in metas]

    # ---- phase 0: preprocessed (verifier-known) columns -------------------
    pre_ms, pre_crevs, pre_ldes = [None] * n_airs, [None] * n_airs, [None] * n_airs
    for i, inst in enumerate(instances):
        pre_np = inst.air.preprocessed_trace()
        if pre_np is None:
            continue
        if pre_np.shape[0] != 1 << metas[i][0]:
            raise ValueError("preprocessed height must equal trace height")
        pre_t = bb.as_tensor(pre_np, dev)
        pre_ms[i] = _monty_columns(pre_t)
        pre_crevs[i], pre_ldes[i] = _lde(pre_t, shifts[i], log_blowup, canonical=True)
    pre_trees = _commit_by_height(pre_ldes, log_ms, heights, ch)
    phases.mark("preprocessed")

    # ---- phase 1: main trace LDEs, commit per height ----------------------
    trace_ms, trace_crevs, trace_ldes = [], [], []
    for i, inst in enumerate(instances):
        trace_t = bb.as_tensor(inst.trace, dev)
        cr, lde = _lde(trace_t, shifts[i], log_blowup, canonical=True)
        trace_crevs.append(cr)
        trace_ldes.append(lde)
        trace_ms.append(_monty_columns(trace_t))  # for the interaction pass
        del trace_t
    phases.mark("lde")
    trace_trees = _commit_by_height(trace_ldes, log_ms, heights, ch)
    phases.mark("trace_commit")

    # ---- phase 2: logUp permutation traces --------------------------------
    beta = bb.as_tensor(ch.sample_ext(), dev)
    z = bb.as_tensor(ch.sample_ext(), dev)
    inters_per_air, perm_crevs, perm_ldes = [], [None] * n_airs, [None] * n_airs
    claimed: List[Optional[torch.Tensor]] = [None] * n_airs
    for i, inst in enumerate(instances):
        inters = _extract_interactions(inst.air, trace_ms[i], pvs_ms[i], pre_ms[i])
        trace_ms[i] = None
        inters_per_air.append(len(inters))
        phases.mark("interactions")
        if not inters:
            continue
        perm, claimed[i] = ilib.build_perm_trace(inters, z, beta)
        del inters
        phases.mark("perm_trace")
        perm_crevs[i], perm_ldes[i] = _lde(perm, shifts[i], log_blowup)
        phases.mark("perm_lde")
    del pre_ms, trace_ms
    perm_trees = _commit_by_height(perm_ldes, log_ms, heights, ch)
    claimed_sums = [None if c is None else bb.to_numpy(c) for c in claimed]
    for cs in claimed_sums:
        if cs is not None:
            ch.observe_slice(cs)
    phases.mark("perm_commit")

    # ---- phase 3: quotients ----------------------------------------------
    alpha = bb.as_tensor(ch.sample_ext(), dev)
    chunk_crevs, chunk_ldes = [], []
    for i, inst in enumerate(instances):
        log_n, lm, shift = metas[i][0], log_ms[i], shifts[i]
        m = 1 << lm
        sels = domain.selectors_on_coset(log_n, log_blowup, shift, dev)
        builder = LdeBuilder(trace_ldes[i], blowup, sels, pvs_ms[i], alpha=alpha,
                             pre_lde=pre_ldes[i])
        inst.air.eval(builder)
        phases.mark("constraints")
        k = inters_per_air[i]
        if k:
            groups = _perm_ext_groups(perm_ldes[i], k)
            groups_next = [torch.roll(gp, -blowup, dims=0) for gp in groups]
            for c in ilib.perm_constraints(builder.interactions, groups, groups_next,
                                           sels, z, beta, claimed[i]):
                builder.assert_zero_ext(c)
            del groups, groups_next
            phases.mark("perm_constraints")
        c_folded = builder.folded
        if c_folded is None:
            c_folded = torch.zeros((m, 4), dtype=bb.DTYPE, device=dev)
        del builder
        q = bb.mul(c_folded, sels["inv_zh"][:, None])
        del c_folded
        # split into per-coset chunks (q[r::2], read in place), re-extend
        w_m_int = bb.two_adic_generator_int(lm)
        crs = []
        chunk_lde = torch.empty((m, 4 * N_CHUNKS), dtype=bb.DTYPE, device=dev)
        for r in range(N_CHUNKS):
            cr = ntt.interpolate_coset_rev(q[r::N_CHUNKS], (shift * pow(w_m_int, r, P)) % P)
            crs.append(cr)
            ntt.eval_coset_from_rev(cr, log_blowup, shift,
                                    out=chunk_lde[:, 4 * r:4 * r + 4])
        del q
        chunk_crevs.append(crs)
        chunk_ldes.append(chunk_lde)
        phases.mark("quotient_chunks")
    quotient_trees = _commit_by_height(chunk_ldes, log_ms, heights, ch)
    zeta = ch.sample_ext()
    phases.mark("quotient_commit")

    # ---- phase 4: openings ------------------------------------------------
    zeta_t = bb.as_tensor(zeta, dev)
    opened: List[OpenedValues] = []
    for i in range(n_airs):
        zeta_next_t = bb.as_tensor(_zeta_next(zeta, metas[i][0]), dev)

        def at_both(c_rev):  # zeta and zeta * g_H from one read
            return tuple(bb.to_numpy(t) for t in
                         ntt.eval_poly_at_points_ext(c_rev, [zeta_t, zeta_next_t]))

        t_z, t_zn = at_both(trace_crevs[i])
        q_z = np.concatenate([bb.to_numpy(ntt.eval_poly_at_point_ext(cr, zeta_t))
                              for cr in chunk_crevs[i]], axis=0)
        ov = OpenedValues(trace_zeta=t_z, trace_zeta_next=t_zn, quotient=q_z)
        _observe_opened(ch, t_z, t_zn, q_z)
        if perm_crevs[i] is not None:
            ov.perm_zeta, ov.perm_zeta_next = at_both(perm_crevs[i])
            _observe_opened(ch, ov.perm_zeta, ov.perm_zeta_next)
        if pre_crevs[i] is not None:
            ov.pre_zeta, ov.pre_zeta_next = at_both(pre_crevs[i])
            _observe_opened(ch, ov.pre_zeta, ov.pre_zeta_next)
        opened.append(ov)
    del trace_crevs, chunk_crevs, perm_crevs, pre_crevs
    gamma = ch.sample_ext()
    phases.mark("ood")

    # ---- phase 5: per-height DEEP codewords + FRI ------------------------
    pre_ws = [0 if x is None else int(x.shape[1]) for x in pre_ldes]
    n_terms = sum(2 * w + 4 * N_CHUNKS + (2 * (4 * inters_per_air[i] + 4)
                                          if inters_per_air[i] else 0) + 2 * pre_ws[i]
                  for i, (_, w, _) in enumerate(metas))
    gammas_c = _ext_powers_host(gamma, max(n_terms, 1))
    gammas = bb.as_tensor(bb.to_monty_np(np.asarray(gammas_c, dtype=np.uint64)), dev)
    gidx = 0
    sums = {}
    for i in range(n_airs):
        ov = opened[i]
        pairs = [(trace_ldes[i], ov.trace_zeta, ov.trace_zeta_next)]
        if perm_ldes[i] is not None:
            pairs.append((perm_ldes[i], ov.perm_zeta, ov.perm_zeta_next))
        if pre_ldes[i] is not None:
            pairs.append((pre_ldes[i], ov.pre_zeta, ov.pre_zeta_next))
        acc_z, acc_zn, gidx = _deep_terms(pairs, chunk_ldes[i], ov.quotient,
                                          gammas_c, gammas, gidx)
        lm = log_ms[i]
        if lm in sums:
            acc_z = ext4.add(sums[lm][0], acc_z)
            acc_zn = ext4.add(sums[lm][1], acc_zn)
        sums[lm] = (acc_z, acc_zn, metas[i][0], shifts[i])
    # one domain-wide inverse per distinct point and height
    codewords = {}
    for lm, (acc_z, acc_zn, log_n, shift) in sums.items():
        x_ext = ext4.from_base(domain.selectors_on_coset(log_n, log_blowup, shift, dev)["x"])
        inv_xz = ext4.inv(ext4.sub(x_ext, zeta_t))
        inv_xzn = ext4.inv(ext4.sub(x_ext, bb.as_tensor(_zeta_next(zeta, log_n), dev)))
        codewords[lm] = ext4.add(ext4.mul(acc_z, inv_xz), ext4.mul(acc_zn, inv_xzn))
    del sums
    phases.mark("deep")
    injected = {lm: cw for lm, cw in codewords.items() if lm != log_max}
    fri_proof = fri.prove(codewords[log_max], log_max, g, config.fri, ch,
                          mark=phases.mark, injected=injected)
    del codewords, injected

    # ---- phase 6: query openings per height ------------------------------
    query_openings: Dict[int, Dict[int, QueryOpening]] = {}
    for lm in heights:
        m_l = 1 << lm
        positions = set()
        for q0 in fri_proof.query_indices:
            if lm == log_max:
                qq = q0 % (m_l // 2)
                positions.update((qq, qq + m_l // 2))
            else:
                positions.add(q0 % m_l)
        positions = sorted(positions)

        def open_all(trees):
            return (merkle.open_indices(trees[lm], positions) if lm in trees
                    else [None] * len(positions))

        query_openings[lm] = {
            pos: QueryOpening(trace=t, quotient=q, perm=pm, pre=pr)
            for pos, t, q, pm, pr in zip(positions, open_all(trace_trees),
                                         open_all(quotient_trees), open_all(perm_trees),
                                         open_all(pre_trees))
        }
    phases.mark("openings")

    stat = {"proving_time_mills": (time.perf_counter() - t_start) * 1e3,
            "n_airs": n_airs}
    stat.update(phases.stat())
    return MachineProof(
        meta=metas,
        trace_roots={lm: trace_trees[lm].root_np() for lm in heights},
        quotient_roots={lm: quotient_trees[lm].root_np() for lm in heights},
        perm_roots={lm: t.root_np() for lm, t in perm_trees.items()},
        pre_roots={lm: t.root_np() for lm, t in pre_trees.items()},
        claimed_sums=claimed_sums,
        opened=opened,
        fri_proof=fri_proof,
        query_openings=query_openings,
        stat=stat,
    )


# ---------------------------------------------------------------------------
# Verifier (host)
# ---------------------------------------------------------------------------


def _acc_cols(row_canon, opened_canon, gammas_np, gidx):
    """sum_j gammas[gidx + j] * (row[j] - opened[j]), vectorised over the
    columns; row: canonical base values, opened: canonical (w, 4)."""
    w = len(row_canon)
    if w == 0:
        return [0, 0, 0, 0], gidx
    a = gammas_np[gidx:gidx + w]                          # (w, 4) uint64
    oc = np.asarray(opened_canon, dtype=np.int64)         # (w, 4)
    # ext difference of a BASE row value: only coefficient 0 carries row[j]
    d = (-oc) % P
    d[:, 0] = (np.asarray(row_canon, dtype=np.int64) - oc[:, 0]) % P
    d = d.astype(np.uint64)
    c = np.zeros((7, w), dtype=np.uint64)
    for i in range(4):
        for j in range(4):
            # each term < p after the reduction; <= 4 terms a slot < 2^33
            c[i + j] += (a[:, i] * d[:, j]) % P
    for k in range(6, 3, -1):
        c[k - 4] = (c[k - 4] + ext4.W_INT * (c[k] % P)) % P
    return [int(c[k].sum() % P) for k in range(4)], gidx + w


def _structure(air: Air):
    """(interaction count, preprocessed trace or None), from the AIR's
    definition: a TraceBuilder pass over a 2-row zero trace."""
    pre_np = air.preprocessed_trace()
    zero = torch.zeros((2, air.width), dtype=bb.DTYPE)
    zero_pre = (None if pre_np is None
                else torch.zeros((2, pre_np.shape[1]), dtype=bb.DTYPE))
    tb = TraceBuilder(zero, [0] * air.num_public_values, pre_m=zero_pre)
    air.eval(tb)
    return len(tb.interactions), pre_np


def preprocessed_roots(pre_traces, log_ms: Sequence[int], config: StarkConfig,
                       device) -> Dict[int, np.ndarray]:
    """The preprocessed commitments per LDE height (Montgomery roots), as
    `prove_machine` makes them: verification-key material, a function of
    the AIRs' fixed columns (canonical numpy arrays, None where an AIR has
    none) alone. The LDEs and trees run on `device`."""
    dev = resolve_device(device)
    log_max = max(log_ms)
    g = config.coset_shift % P
    pre_ldes = [None if pre is None else
                _lde(bb.as_tensor(pre, dev), _shift_for(lm, log_max, g), config.log_blowup,
                     canonical=True)[1]
                for pre, lm in zip(pre_traces, log_ms)]
    roots = {}
    for lm in sorted(set(log_ms), reverse=True):
        mats = [x for x, l in zip(pre_ldes, log_ms) if l == lm and x is not None]
        if mats:
            roots[lm] = merkle.commit(mats).root_np()
    return roots


def verify_machine(
    airs: Sequence[Air],
    proof,
    config: Optional[StarkConfig] = None,
    device=None,
) -> bool:
    """Check a machine proof for `airs`. A proof that is not well formed
    (`stark/wellformed.py`) returns False before the replay. The replay is
    host code; the preprocessed commitments are recomputed on `device`
    (None: the card, as for `prove_machine`)."""
    config = config or StarkConfig()
    log_blowup = config.log_blowup
    g = config.coset_shift % P
    structure = [_structure(air) for air in airs]
    inter_counts = [k for k, _ in structure]
    pre_traces = [pre for _, pre in structure]
    pre_widths = [0 if pre is None else int(pre.shape[1]) for pre in pre_traces]
    if not wellformed.machine_proof_ok(proof, airs, config, inter_counts, pre_widths):
        return False
    metas = [(int(log_n), int(w), [int(v) for v in pvs])
             for (log_n, w, pvs) in proof.meta]
    n_airs = len(metas)
    log_ms = [log_n + log_blowup for (log_n, _, _) in metas]
    log_max = max(log_ms)
    heights = sorted(set(log_ms), reverse=True)
    shifts = [_shift_for(lm, log_max, g) for lm in log_ms]

    # ---- recompute preprocessed commitments (verification-key material) ---
    for i, pre_np in enumerate(pre_traces):
        if pre_np is not None and pre_np.shape[0] != 1 << metas[i][0]:
            return False
    expected_pre_roots = preprocessed_roots(pre_traces, log_ms, config, device)
    for lm, root in expected_pre_roots.items():
        if not (np.asarray(proof.pre_roots[lm]) == root).all():
            return False

    # ---- transcript replay ------------------------------------------------
    ch = Challenger()
    ch.observe_canonical_u32(n_airs)
    for (log_n, w, pvs) in metas:
        ch.observe_canonical_u32(log_n)
        ch.observe_canonical_u32(w)
        for pv in pvs:
            ch.observe_canonical_u32(pv)
    for lm in heights:
        if lm in expected_pre_roots:
            ch.observe_slice(expected_pre_roots[lm])
    for lm in heights:
        ch.observe_slice(proof.trace_roots[lm])
    beta = ch.sample_ext()
    z = ch.sample_ext()
    for lm in heights:
        if lm in proof.perm_roots:
            ch.observe_slice(proof.perm_roots[lm])
    for cs in proof.claimed_sums:
        if cs is not None:
            ch.observe_slice(cs)
    alpha = ch.sample_ext()
    for lm in heights:
        ch.observe_slice(proof.quotient_roots[lm])
    zeta = ch.sample_ext()

    # ---- global logUp balance --------------------------------------------
    total = [0, 0, 0, 0]
    for cs in proof.claimed_sums:
        if cs is not None:
            total = ext_np.add(total, ext_np.from_monty(cs))
    if any(total):
        return False

    zeta_c, alpha_c = ext_np.from_monty(zeta), ext_np.from_monty(alpha)
    beta_c, z_c = ext_np.from_monty(beta), ext_np.from_monty(z)
    canon = []
    for ov in proof.opened:
        canon.append({name: None if getattr(ov, name) is None
                      else ext_np.from_monty(getattr(ov, name))
                      for name in ("trace_zeta", "trace_zeta_next", "quotient",
                                   "perm_zeta", "perm_zeta_next", "pre_zeta",
                                   "pre_zeta_next")})

    # ---- per-AIR out-of-domain constraint check --------------------------
    for i, (air, (log_n, w, pvs)) in enumerate(zip(airs, metas)):
        cv = canon[i]
        sels_z = domain.selectors_at_point(log_n, zeta_c)
        pb = PointBuilder(cv["trace_zeta"], cv["trace_zeta_next"], sels_z, pvs,
                          pre_ext=cv["pre_zeta"], pre_next_ext=cv["pre_zeta_next"])
        air.eval(pb)
        constraints = list(pb.constraints)
        k = inter_counts[i]
        if k:
            perm_local = [ext_np.from_base_cols(cv["perm_zeta"][4 * j:4 * j + 4])
                          for j in range(k + 1)]
            perm_next = [ext_np.from_base_cols(cv["perm_zeta_next"][4 * j:4 * j + 4])
                         for j in range(k + 1)]
            constraints += ilib.perm_constraints(
                pb.interactions, perm_local, perm_next, sels_z, z_c, beta_c,
                ext_np.from_monty(proof.claimed_sums[i]), point_mode=True)
        q_expected = ext_np.mul(fold_at_point(constraints, alpha_c), sels_z["inv_zh"])
        q_zeta = quotient_at_point(cv["quotient"], shifts[i], log_n, log_ms[i], zeta_c)
        if not ext_np.eq(q_expected, q_zeta):
            return False

    # ---- the openings enter the transcript -------------------------------
    # (after the checks above, which need no later challenge: a proof they
    # reject is rejected before the longest part of the replay)
    for i, ov in enumerate(proof.opened):
        _observe_opened(ch, ov.trace_zeta, ov.trace_zeta_next, ov.quotient)
        if inter_counts[i]:
            _observe_opened(ch, ov.perm_zeta, ov.perm_zeta_next)
        if pre_traces[i] is not None:
            _observe_opened(ch, ov.pre_zeta, ov.pre_zeta_next)
    gamma = ch.sample_ext()

    # ---- Merkle openings, one batched walk per tree ----------------------
    for lm in heights:
        here = [i for i in range(n_airs) if log_ms[i] == lm]
        n_perm = sum(1 for i in here if inter_counts[i])
        n_pre = sum(1 for i in here if pre_traces[i] is not None)
        qos = list(proof.query_openings[lm].items())
        for pos, qo in qos:
            if qo.trace.index != pos or qo.quotient.index != pos:
                return False
            if n_perm and qo.perm.index != pos:
                return False
            if n_pre and qo.pre.index != pos:
                return False
        for root, name, count in ((proof.trace_roots, "trace", len(here)),
                                  (proof.quotient_roots, "quotient", len(here)),
                                  (proof.perm_roots, "perm", n_perm),
                                  (proof.pre_roots, "pre", n_pre)):
            if count and not merkle.verify_openings(
                    root[lm], [getattr(qo, name) for _, qo in qos], [1 << lm] * count):
                return False

    # ---- derived DEEP values per height, then FRI ------------------------
    n_terms = sum(2 * w + 4 * N_CHUNKS + (2 * (4 * inter_counts[i] + 4)
                                          if inter_counts[i] else 0) + 2 * pre_widths[i]
                  for i, (_, w, _) in enumerate(metas))
    gammas_np = np.asarray(_ext_powers_host(gamma, max(n_terms, 1)), dtype=np.uint64)
    offsets, off = [], 0
    for i, (_, w, _) in enumerate(metas):
        offsets.append(off)
        off += 2 * w + 4 * N_CHUNKS + 2 * pre_widths[i]
        if inter_counts[i]:
            off += 2 * (4 * inter_counts[i] + 4)

    def make_derived(lm):
        here = [i for i in range(n_airs) if log_ms[i] == lm]
        shift = _shift_for(lm, log_max, g)
        w_m_int = bb.two_adic_generator_int(lm)
        zeta_g = ext_np.scale(zeta_c, bb.two_adic_generator_int(lm - log_blowup))

        def derived(idx: int):
            qo = proof.query_openings[lm].get(idx)
            if qo is None:
                raise KeyError(f"missing opening at height {lm} pos {idx}")
            x = ext_np.from_base((shift * pow(w_m_int, idx, P)) % P)
            inv_xz = ext_np.inv(ext_np.sub(x, zeta_c))
            inv_xzg = ext_np.inv(ext_np.sub(x, zeta_g))
            total = [0, 0, 0, 0]
            perm_slot = pre_slot = 0
            for slot, i in enumerate(here):
                cv = canon[i]
                groups = [(qo.trace.rows[slot], "trace_zeta", "trace_zeta_next")]
                if inter_counts[i]:
                    groups.append((qo.perm.rows[perm_slot], "perm_zeta", "perm_zeta_next"))
                    perm_slot += 1
                if pre_widths[i]:
                    groups.append((qo.pre.rows[pre_slot], "pre_zeta", "pre_zeta_next"))
                    pre_slot += 1
                gidx = offsets[i]
                a_z, a_zn = [0, 0, 0, 0], [0, 0, 0, 0]
                for row, at_z, at_zn in groups:
                    row_c = bb.from_monty_np(np.asarray(row, dtype=np.uint32))
                    s, gidx = _acc_cols(row_c, cv[at_z], gammas_np, gidx)
                    a_z = ext_np.add(a_z, s)
                    s, gidx = _acc_cols(row_c, cv[at_zn], gammas_np, gidx)
                    a_zn = ext_np.add(a_zn, s)
                qrow = bb.from_monty_np(np.asarray(qo.quotient.rows[slot], dtype=np.uint32))
                s, gidx = _acc_cols(qrow, cv["quotient"], gammas_np, gidx)
                a_z = ext_np.add(a_z, s)
                total = ext_np.add(total, ext_np.add(ext_np.mul(a_z, inv_xz),
                                                     ext_np.mul(a_zn, inv_xzg)))
            return np.array(total, dtype=np.uint64)

        return derived

    try:
        return fri.verify(proof.fri_proof, log_max, g, config.fri, ch,
                          {lm: make_derived(lm) for lm in heights})
    except KeyError:
        return False
