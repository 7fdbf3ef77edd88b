"""FRI low-degree test over BabyBear^4, natural-order domains.

The reference's `zkvm_prover_tpu/stark/fri.py` on tensors:

- The codeword lives on a natural-order coset s*G (|G| = m). One fold
  combines the two contiguous halves (x at j, -x at j + m/2):
      E'(x^2) = (E(x) + E(-x))/2 + beta * (E(x) - E(-x)) / (2x).
- Round 0's codeword is NOT committed: it is the DEEP combination the
  verifier re-derives at every queried position from the outer openings.
- Every later round's codeword is Merkle-committed as an (m_i, 4) matrix;
  queries open index and sibling index + m_i/2.
- Multi-height proofs inject lower codewords: when the fold reaches size
  m', the codeword of height m' (on the coset the fold chain gives that
  size) is added to the folded one before it is committed.

The fold is plain torch; the commitments run through kernel K2. The
verifier is host code (python ints and numpy).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import List

import numpy as np

from ..fields import babybear as bb
from ..fields import ext4
from ..utils import ext_np
from . import merkle
from .challenger import Challenger
from .config import FriConfig


@dataclass
class FriRoundProof:
    openings: List[tuple]  # per query: (Opening at q, Opening at q + m/2)


@dataclass
class FriProof:
    commitments: List[np.ndarray]        # per committed round: Merkle root
    final_poly: np.ndarray               # (blowup << log_final_poly_len, 4)
    pow_witness: int
    rounds: List[FriRoundProof] = field(default_factory=list)
    query_indices: List[int] = field(default_factory=list)


@functools.lru_cache(maxsize=None)
def inv_denoms_np(log_m: int, shift_int: int) -> np.ndarray:
    """1/(2 * shift * w^j) for j < m/2, Montgomery uint32."""
    w = bb.two_adic_generator_int(log_m)
    inv2s = pow(2 * shift_int % bb.P, bb.P - 2, bb.P)
    winv = pow(w, bb.P - 2, bb.P)
    return bb.to_monty_np(bb.mulmod_np(bb.powers_np(winv, (1 << log_m) // 2),
                                       inv2s))


INV2 = bb.to_monty_int(pow(2, bb.P - 2, bb.P))


def fold_halves(lo, hi, inv_d, beta):
    """The fold of paired rows: (lo + hi)/2 + beta * (lo - hi) * inv_d, with
    inv_d the rows' 1/(2x)."""
    g = bb.mul(bb.add(lo, hi), INV2)
    h = bb.mul(bb.sub(lo, hi), inv_d[:, None])
    return bb.add(g, ext4.mul(h, beta))


def fold_round(codeword, log_m: int, shift_int: int, beta):
    """One FRI fold. codeword: (m, 4) ext Montgomery; beta: (4,) ext."""
    half = (1 << log_m) // 2
    inv_d = bb.as_tensor(inv_denoms_np(log_m, shift_int % bb.P), codeword.device)
    return fold_halves(codeword[:half], codeword[half:], inv_d, beta)


def prove(codeword, log_m: int, shift_int: int, config: FriConfig,
          challenger: Challenger, mark=None, injected=None) -> FriProof:
    """FRI commit + query phases; codeword (m, 4) on the coset shift*G.
    injected: optional {log_m': (m', 4) codeword}, each added into the fold
    when the round size reaches m'; it must live on the coset
    shift^(2^(log_m - log_m')) * G_m'. mark(name), if given, is called as
    the fold, grind and query phases end."""
    mark = mark or (lambda name: None)
    injected = injected or {}
    commits: List[merkle.MerkleTree] = []
    roots: List[np.ndarray] = []
    cw = codeword
    lm = log_m
    sh = shift_int % bb.P
    # fold until the domain reaches blowup << log_final_poly_len, so the
    # final codeword keeps its rate and the degree check means something
    log_final_domain = config.log_final_poly_len + config.log_blowup
    first = True
    while lm > log_final_domain:
        if first:
            first = False  # round 0 is derived by the verifier, not committed
        else:
            tree = merkle.commit([cw])
            commits.append(tree)
            root = tree.root_np()
            roots.append(root)
            challenger.observe_slice(root)
        beta = bb.as_tensor(challenger.sample_ext(), cw.device)
        cw = fold_round(cw, lm, sh, beta)
        sh = (sh * sh) % bb.P
        lm -= 1
        if lm in injected:
            cw = bb.add(cw, injected[lm])

    final_vals = bb.to_numpy(cw)
    challenger.observe_slice(final_vals)
    mark("fri_fold")
    pow_witness = challenger.grind(config.proof_of_work_bits, codeword.device)
    mark("grind")

    # commits[k] holds the round-(k+1) codeword
    indices = [challenger.sample_bits(log_m) for _ in range(config.num_queries)]
    rounds: List[FriRoundProof] = []
    for k, tree in enumerate(commits):
        m_r = 1 << (log_m - 1 - k)
        half = m_r // 2
        qq = [(q0 % m_r) % half for q0 in indices]
        ops = merkle.open_indices(tree, qq + [q + half for q in qq])
        nq = len(indices)
        rounds.append(FriRoundProof(openings=list(zip(ops[:nq], ops[nq:]))))
    mark("fri_openings")

    return FriProof(commitments=roots, final_poly=final_vals,
                    pow_witness=pow_witness, rounds=rounds,
                    query_indices=indices)


# ---------------------------------------------------------------------------
# Verifier (host)
# ---------------------------------------------------------------------------

P = bb.P


def verify(proof: FriProof, log_m: int, shift_int: int, config: FriConfig,
           challenger: Challenger, initial_values) -> bool:
    """Verify a FRI proof. initial_values is either a callable, q ->
    canonical (4,) value of the round-0 (derived, uncommitted) codeword at
    index q, or a dict {log_m': callable}: its log_m entry is the round-0
    codeword (mandatory) and every other entry a codeword injected into the
    fold at size 2^log_m', as the prover did."""
    derived = ({log_m: initial_values} if callable(initial_values)
               else dict(initial_values or {}))
    if log_m not in derived:
        return False
    log_final_domain = config.log_final_poly_len + config.log_blowup
    n_rounds = log_m - log_final_domain
    if len(proof.commitments) != max(n_rounds - 1, 0):
        return False
    final = np.asarray(proof.final_poly)
    if final.size != 4 << log_final_domain:
        return False
    if len(proof.rounds) != max(n_rounds - 1, 0):
        return False
    betas = []
    if n_rounds > 0:
        betas.append(ext_np.from_monty(challenger.sample_ext()))
    for root in proof.commitments:
        challenger.observe_slice(np.asarray(root, dtype=np.uint32))
        betas.append(ext_np.from_monty(challenger.sample_ext()))
    challenger.observe_slice(final)
    if not challenger.check_witness(config.proof_of_work_bits,
                                    int(proof.pow_witness)):
        return False
    indices = [challenger.sample_bits(log_m) for _ in range(config.num_queries)]
    if indices != [int(i) for i in proof.query_indices]:
        return False

    final_canon = ext_np.from_monty(final.reshape(-1, 4))

    # final low-degree check: coefficients of degree >= 2^log_final_poly_len
    # of the final codeword's interpolant must vanish
    fd = 1 << log_final_domain
    w_f = bb.two_adic_generator_int(log_final_domain)
    for j in range(1 << config.log_final_poly_len, fd):
        coeff = [0, 0, 0, 0]
        for t in range(fd):
            wjt = pow(w_f, (-j * t) % fd, P)
            coeff = [(c + v * wjt) % P for c, v in zip(coeff, final_canon[t])]
        if any(coeff):
            return False

    inv2 = pow(2, P - 2, P)
    for r in range(1, n_rounds):
        lm = log_m - r
        m_r = 1 << lm
        half = m_r // 2
        ops = []
        round_ops = proof.rounds[r - 1].openings
        if len(round_ops) != len(indices):
            return False
        for qi, q0 in enumerate(indices):
            qq = (q0 % m_r) % half
            op_lo, op_hi = round_ops[qi]
            if op_lo.index != qq or op_hi.index != qq + half:
                return False
            ops += [op_lo, op_hi]
        if not merkle.verify_openings(proof.commitments[r - 1], ops, [m_r]):
            return False
    for qi, q0 in enumerate(indices):
        sh = shift_int % P
        value = None
        q = q0
        for r in range(n_rounds):
            lm = log_m - r
            m_r = 1 << lm
            half = m_r // 2
            q %= m_r
            qq = q % half
            if r == 0:
                lo = [int(v) % P for v in derived[lm](qq)]
                hi = [int(v) % P for v in derived[lm](qq + half)]
            else:
                op_lo, op_hi = proof.rounds[r - 1].openings[qi]
                lo = ext_np.from_monty(np.asarray(op_lo.rows[0]).reshape(-1))
                hi = ext_np.from_monty(np.asarray(op_hi.rows[0]).reshape(-1))
                if len(lo) != 4 or len(hi) != 4:
                    return False
                if lm in derived:  # a codeword was injected at this size
                    value = ext_np.add(value, derived[lm](q))
                if value != (lo if q < half else hi):
                    return False
            w = bb.two_adic_generator_int(lm)
            x = (sh * pow(w, qq, P)) % P
            inv2x = pow(2 * x % P, P - 2, P)
            g = [(a + b) * inv2 % P for a, b in zip(lo, hi)]
            h = [(a - b) * inv2x % P for a, b in zip(lo, hi)]
            value = [(u + v) % P for u, v in zip(g, ext_np.mul(betas[r], h))]
            q = qq
            sh = (sh * sh) % P
        if value != final_canon[q]:
            return False
    return True
