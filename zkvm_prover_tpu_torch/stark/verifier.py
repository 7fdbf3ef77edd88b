"""Single-AIR STARK verifier.

Host code, as in the reference (`zkvm_prover_tpu/stark/verifier.py`): the
openings are tiny, so the verifier replays the transcript and checks the
out-of-domain constraint identity (DEEP-ALI), the Merkle paths (numpy
Poseidon2) and the FRI folds with exact python-int arithmetic. No tensor and
no device is involved. It accepts any proof object with the reference's
attribute names, the reference's own proofs included. A proof that is not
well formed (`stark/wellformed.py`: shapes, integer ranges, counts) is
rejected before the transcript replay.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..fields import babybear as bb
from ..models.air import Air, PointBuilder, LOG_QUOTIENT_DEGREE
from ..utils import ext_np
from . import domain, fri, merkle, wellformed
from .challenger import Challenger
from .config import StarkConfig
from .prover import _observe_opened

P = bb.P
_canon_ext = ext_np.from_monty


def fold_at_point(constraints, alpha_c):
    """sum_i alpha^i c_i over canonical extension values."""
    acc = [0, 0, 0, 0]
    apow = ext_np.from_base(1)
    for cons in constraints:
        acc = ext_np.add(acc, ext_np.mul(apow, cons))
        apow = ext_np.mul(apow, alpha_c)
    return acc


def quotient_at_point(q_at_z, shift: int, log_n: int, log_m: int, zeta_c):
    """q(zeta) from the chunk openings (canonical, 4 per chunk, one per
    base column): sum_r L_r(zeta) chunk_r(zeta) with
    L_r = (zeta^n - v_{1-r}) / (v_r - v_{1-r}), v_r = (shift w_m^r)^n."""
    n = 1 << log_n
    w_m_int = bb.two_adic_generator_int(log_m)
    n_chunks = 1 << LOG_QUOTIENT_DEGREE
    v = [pow((shift * pow(w_m_int, r, P)) % P, n, P) for r in range(n_chunks)]
    zeta_n = ext_np.exp(zeta_c, n)
    q_zeta = [0, 0, 0, 0]
    for r in range(n_chunks):
        other = 1 - r
        l_num = ext_np.sub(zeta_n, ext_np.from_base(v[other]))
        l_r = ext_np.scale(l_num, pow((v[r] - v[other]) % P, P - 2, P))
        chunk_val = ext_np.from_base_cols(q_at_z[4 * r:4 * r + 4])
        q_zeta = ext_np.add(q_zeta, ext_np.mul(l_r, chunk_val))
    return q_zeta


def verify(air: Air, proof, config: Optional[StarkConfig] = None) -> bool:
    config = config or StarkConfig()
    if not wellformed.stark_proof_ok(proof, air, config):
        return False
    log_n = int(proof.log_n)
    n = 1 << log_n
    log_blowup = config.log_blowup
    m = n << log_blowup
    w = int(proof.width)
    g = config.coset_shift % P
    w_m_int = bb.two_adic_generator_int(log_n + log_blowup)
    n_chunks = 1 << LOG_QUOTIENT_DEGREE

    t_z = np.asarray(proof.opened_trace_zeta)
    t_zn = np.asarray(proof.opened_trace_zeta_next)
    opened_q = np.asarray(proof.opened_quotient)

    # ---- transcript replay ------------------------------------------------
    ch = Challenger()
    ch.observe_canonical_u32(log_n)
    ch.observe_canonical_u32(w)
    for pv in proof.public_values:
        ch.observe_canonical_u32(int(pv))
    ch.observe_slice(proof.trace_root)
    alpha = ch.sample_ext()
    ch.observe_slice(proof.quotient_root)
    zeta = ch.sample_ext()
    _observe_opened(ch, t_z, t_zn, opened_q.reshape(-1, 4))
    gamma = ch.sample_ext()

    zeta_c = _canon_ext(zeta)
    gamma_c = _canon_ext(gamma)
    alpha_c = _canon_ext(alpha)
    t_at_z = _canon_ext(t_z)
    t_at_zn = _canon_ext(t_zn)
    q_at_z = _canon_ext(opened_q.reshape(n_chunks * 4, 4))

    # ---- out-of-domain constraint check (DEEP-ALI) ------------------------
    sels_z = domain.selectors_at_point(log_n, zeta_c)
    pb = PointBuilder(t_at_z, t_at_zn, sels_z,
                      [int(v) % P for v in proof.public_values])
    air.eval(pb)
    q_expected = ext_np.mul(fold_at_point(pb.constraints, alpha_c), sels_z["inv_zh"])
    q_zeta = quotient_at_point(q_at_z, g, log_n, log_n + log_blowup, zeta_c)
    if not ext_np.eq(q_expected, q_zeta):
        return False

    # ---- query openings: Merkle paths + derived DEEP values ---------------
    gammas = ext_np.powers(gamma_c, 2 * w + 4 * n_chunks)
    g_h = bb.two_adic_generator_int(log_n)
    zeta_g = ext_np.scale(zeta_c, g_h)
    k1 = [0, 0, 0, 0]
    k2 = [0, 0, 0, 0]
    k3 = [0, 0, 0, 0]
    for j in range(w):
        k1 = ext_np.add(k1, ext_np.mul(gammas[j], t_at_z[j]))
        k2 = ext_np.add(k2, ext_np.mul(gammas[w + j], t_at_zn[j]))
    for k in range(4 * n_chunks):
        k3 = ext_np.add(k3, ext_np.mul(gammas[2 * w + k], q_at_z[k]))
    k13 = ext_np.add(k1, k3)

    qos = list(proof.query_openings.items())
    for pos, qo in qos:
        if qo.trace.index != pos or qo.quotient.index != pos:
            return False
    if not merkle.verify_openings(proof.trace_root,
                                  [qo.trace for _, qo in qos], [m]):
        return False
    if not merkle.verify_openings(proof.quotient_root,
                                  [qo.quotient for _, qo in qos], [m]):
        return False

    # the base x ext column sums, one numpy pass per opened row
    gam = np.asarray(gammas, dtype=object)

    def row_sum(row, gs):
        vals = np.asarray(bb.from_monty_np(np.asarray(row, np.uint32)),
                          dtype=object)
        return [int(s) % P for s in vals @ gs]

    def initial_values(idx: int):
        qo = proof.query_openings.get(idx)
        if qo is None:
            raise KeyError(f"missing query opening at {idx}")
        trow, qrow = qo.trace.rows[0], qo.quotient.rows[0]
        x = (g * pow(w_m_int, idx, P)) % P
        inv_xz = ext_np.inv(ext_np.sub(ext_np.from_base(x), zeta_c))
        inv_xzg = ext_np.inv(ext_np.sub(ext_np.from_base(x), zeta_g))
        s1 = ext_np.add(row_sum(trow, gam[:w]), row_sum(qrow, gam[2 * w:]))
        s2 = row_sum(trow, gam[w:2 * w])
        return ext_np.add(ext_np.mul(ext_np.sub(s1, k13), inv_xz),
                          ext_np.mul(ext_np.sub(s2, k2), inv_xzg))

    # ---- FRI --------------------------------------------------------------
    try:
        return fri.verify(proof.fri_proof, log_n + log_blowup, g, config.fri,
                          ch, initial_values)
    except KeyError:
        return False
