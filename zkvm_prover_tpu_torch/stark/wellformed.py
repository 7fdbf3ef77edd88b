"""Well-formedness of untrusted proofs, checked before the transcript replay.

A proof comes from outside: its arrays may have any shape and its integers
any size. The verifiers cast them to uint32 and int64 as they go, so an
entry of 2^70 would raise there and an entry v + 2^32 would wrap to v and
pass. These checks run first and make the verifier return False instead:

- every array has its expected shape;
- every field entry is an integer in [0, p);
- every index, query key, query index and PoW witness is an integer in its
  range, and every count (rounds, queries, openings, rows, siblings) is the
  one the statement fixes.

Honest proofs from either package are canonical and pass. Each function
returns a bool and raises nothing.
"""

from __future__ import annotations

import functools

import numpy as np

from ..fields import babybear as bb

P = bb.P
DIGEST = 8
_MALFORMED = (AttributeError, TypeError, ValueError, OverflowError, KeyError,
              IndexError)


def _is_int(v) -> bool:
    return isinstance(v, (int, np.integer)) and not isinstance(v, (bool, np.bool_))


def index_ok(v, bound: int) -> bool:
    """v is an integer in [0, bound)."""
    return _is_int(v) and 0 <= int(v) < bound


def field_ok(x, shape) -> bool:
    """x is an array of `shape` whose entries are integers in [0, p)."""
    try:
        a = np.asarray(x)
    except _MALFORMED:
        return False
    if a.shape != tuple(shape):
        return False
    if a.dtype.kind in "iu":
        return a.size == 0 or (int(a.min()) >= 0 and int(a.max()) < P)
    if a.dtype.kind == "O":
        return all(index_ok(v, P) for v in a.reshape(-1).tolist())
    return False


def opening_ok(op, height: int, widths) -> bool:
    """A Merkle opening of a tree of `height` leaves whose matrices have
    `widths` columns: an index in range, one row per matrix, one digest per
    level."""
    rows, sibs = list(op.rows), list(op.siblings)
    return (index_ok(op.index, height) and len(rows) == len(widths)
            and all(field_ok(r, (w,)) for r, w in zip(rows, widths))
            and len(sibs) == height.bit_length() - 1
            and all(field_ok(s, (DIGEST,)) for s in sibs))


def _guarded(check):
    """A structure that cannot even be walked (a missing attribute, a value
    that is not a sequence) is malformed too."""
    @functools.wraps(check)
    def wrapped(*args):
        try:
            return bool(check(*args))
        except _MALFORMED:
            return False
    return wrapped


@_guarded
def fri_ok(fp, log_m: int, config) -> bool:
    """A FRI proof over a codeword of 2^log_m rows: one root and one round
    of opening pairs per committed round, the final codeword, the PoW
    witness and the query indices."""
    log_final = config.log_final_poly_len + config.log_blowup
    n_committed = max(log_m - log_final - 1, 0)
    commitments, rounds = list(fp.commitments), list(fp.rounds)
    indices = list(fp.query_indices)
    if (len(commitments) != n_committed or len(rounds) != n_committed
            or not all(field_ok(c, (DIGEST,)) for c in commitments)
            or not field_ok(fp.final_poly, (1 << log_final, 4))
            or not index_ok(fp.pow_witness, P)
            or len(indices) != config.num_queries
            or not all(index_ok(q, 1 << log_m) for q in indices)):
        return False
    for r, rnd in enumerate(rounds, start=1):
        pairs = list(rnd.openings)
        if len(pairs) != config.num_queries:
            return False
        for pair in pairs:
            pair = list(pair)
            if len(pair) != 2 or not all(opening_ok(op, 1 << (log_m - r), [4])
                                         for op in pair):
                return False
    return True


@_guarded
def stark_proof_ok(proof, air, config) -> bool:
    """A single-AIR proof (`stark/prover.py::StarkProof`) for `air`."""
    log_n, w = proof.log_n, proof.width
    if not (_is_int(log_n) and 1 <= log_n <= bb.TWO_ADICITY - config.log_blowup
            and _is_int(w) and w == air.width):
        return False
    m = 1 << (int(log_n) + config.log_blowup)
    pvs = list(proof.public_values)
    if (len(pvs) != air.num_public_values or not all(index_ok(v, P) for v in pvs)
            or not field_ok(proof.trace_root, (DIGEST,))
            or not field_ok(proof.quotient_root, (DIGEST,))
            or not field_ok(proof.opened_trace_zeta, (w, 4))
            or not field_ok(proof.opened_trace_zeta_next, (w, 4))
            or not field_ok(proof.opened_quotient, (2, 4, 4))
            or not fri_ok(proof.fri_proof, int(log_n) + config.log_blowup, config.fri)):
        return False
    for pos, qo in dict(proof.query_openings).items():
        if not (index_ok(pos, m) and opening_ok(qo.trace, m, [w])
                and opening_ok(qo.quotient, m, [8])):
            return False
    return True


@_guarded
def machine_proof_ok(proof, airs, config, inter_counts, pre_widths) -> bool:
    """A machine proof (`stark/machine.py::MachineProof`) for `airs`, whose
    interaction counts and preprocessed widths the verifier derived from the
    AIR definitions (0 where an AIR has none)."""
    metas = list(proof.meta)
    if len(metas) != len(airs) or not metas:
        return False
    log_ms = []
    for air, meta in zip(airs, metas):
        log_n, w, pvs = meta
        pvs = list(pvs)
        if not (_is_int(log_n) and 1 <= log_n <= bb.TWO_ADICITY - config.log_blowup
                and _is_int(w) and w == air.width
                and len(pvs) == air.num_public_values
                and all(index_ok(v, P) for v in pvs)):
            return False
        log_ms.append(int(log_n) + config.log_blowup)
    heights = set(log_ms)
    n = len(metas)
    here = {lm: [i for i in range(n) if log_ms[i] == lm] for lm in heights}
    perm_heights = {lm for lm, ids in here.items() if any(inter_counts[i] for i in ids)}
    pre_heights = {lm for lm, ids in here.items() if any(pre_widths[i] for i in ids)}
    for roots, keys in ((proof.trace_roots, heights), (proof.quotient_roots, heights),
                        (proof.perm_roots, perm_heights), (proof.pre_roots, pre_heights)):
        roots = dict(roots)
        if set(roots) != keys or not all(field_ok(r, (DIGEST,)) for r in roots.values()):
            return False

    sums, opened = list(proof.claimed_sums), list(proof.opened)
    if len(sums) != n or len(opened) != n:
        return False
    for i, (cs, ov) in enumerate(zip(sums, opened)):
        w, k, pw = metas[i][1], inter_counts[i], pre_widths[i]
        if (cs is None) != (k == 0) or (cs is not None and not field_ok(cs, (4,))):
            return False
        if not (field_ok(ov.trace_zeta, (w, 4)) and field_ok(ov.trace_zeta_next, (w, 4))
                and field_ok(ov.quotient, (8, 4))):
            return False
        pk = 4 * k + 4 if k else 0
        for arr, rows in ((ov.perm_zeta, pk), (ov.perm_zeta_next, pk),
                          (ov.pre_zeta, pw), (ov.pre_zeta_next, pw)):
            if not (arr is None if rows == 0 else field_ok(arr, (rows, 4))):
                return False
    if not fri_ok(proof.fri_proof, max(log_ms), config.fri):
        return False

    qos = dict(proof.query_openings)
    if set(qos) != heights:
        return False
    for lm, ids in here.items():
        m = 1 << lm
        widths = {
            "trace": [metas[i][1] for i in ids],
            "quotient": [8] * len(ids),
            "perm": [4 * inter_counts[i] + 4 for i in ids if inter_counts[i]],
            "pre": [pre_widths[i] for i in ids if pre_widths[i]],
        }
        for pos, qo in dict(qos[lm]).items():
            if not index_ok(pos, m):
                return False
            for name, ws in widths.items():
                op = getattr(qo, name)
                if not ws:
                    if op is not None:
                        return False
                elif not opening_ok(op, m, ws):
                    return False
    return True
