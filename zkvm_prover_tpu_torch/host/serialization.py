"""Machine-proof (de)serialization: a deterministic, versioned binary codec.

The reference's `zkvm_prover_tpu/host/serialization.py` for the port's
`MachineProof`, with the same bytes: JSON (sorted keys) with base64 numpy
payloads, zlib-compressed. Every array is written as uint32, the dtype the
reference writes, so an envelope from either package decodes in the other.
`stat` (wall-clock phase timings) stays out of the bytes: embedding it
would make proof bytes differ between runs of the same proof.
"""

from __future__ import annotations

import base64
import json
import zlib

import numpy as np

from ..stark import fri, machine, merkle

CODEC_VERSION = 3

_OPENED = ("trace_zeta", "trace_zeta_next", "quotient", "perm_zeta",
           "perm_zeta_next", "pre_zeta", "pre_zeta_next")


def _enc_arr(a) -> dict:
    a = np.asarray(a, dtype=np.uint32)
    return {
        "__nd__": base64.b64encode(a.tobytes()).decode(),
        "dtype": str(a.dtype),
        "shape": list(a.shape),
    }


def _dec_arr(d) -> np.ndarray:
    buf = base64.b64decode(d["__nd__"])
    return np.frombuffer(buf, dtype=np.dtype(d["dtype"])).reshape(d["shape"]).copy()


def _opt(x, fn):
    return None if x is None else fn(x)


def _enc_opening(o: merkle.Opening) -> dict:
    return {
        "index": int(o.index),
        "rows": [_enc_arr(r) for r in o.rows],
        "siblings": [_enc_arr(s) for s in o.siblings],
    }


def _dec_opening(d) -> merkle.Opening:
    return merkle.Opening(
        index=int(d["index"]),
        rows=[_dec_arr(r) for r in d["rows"]],
        siblings=[_dec_arr(s) for s in d["siblings"]],
    )


def _enc_fri(p: fri.FriProof) -> dict:
    return {
        "commitments": [_enc_arr(c) for c in p.commitments],
        "final_poly": _enc_arr(p.final_poly),
        "pow_witness": int(p.pow_witness),
        "query_indices": [int(q) for q in p.query_indices],
        "rounds": [
            [[_enc_opening(a), _enc_opening(b)] for (a, b) in r.openings]
            for r in p.rounds
        ],
    }


def _dec_fri(d) -> fri.FriProof:
    return fri.FriProof(
        commitments=[_dec_arr(c) for c in d["commitments"]],
        final_poly=_dec_arr(d["final_poly"]),
        pow_witness=int(d["pow_witness"]),
        query_indices=[int(q) for q in d["query_indices"]],
        rounds=[
            fri.FriRoundProof(
                openings=[(_dec_opening(a), _dec_opening(b)) for a, b in r]
            )
            for r in d["rounds"]
        ],
    )


def machine_proof_to_dict(p: machine.MachineProof) -> dict:
    def roots(d):
        return {str(k): _enc_arr(v) for k, v in d.items()}

    return {
        "codec_version": CODEC_VERSION,
        "meta": [[int(ln), int(w), [int(v) for v in pvs]] for (ln, w, pvs) in p.meta],
        "trace_roots": roots(p.trace_roots),
        "quotient_roots": roots(p.quotient_roots),
        "perm_roots": roots(p.perm_roots),
        "pre_roots": roots(p.pre_roots),
        "claimed_sums": [_opt(cs, _enc_arr) for cs in p.claimed_sums],
        "opened": [{name: _opt(getattr(ov, name), _enc_arr) for name in _OPENED}
                   for ov in p.opened],
        "fri": _enc_fri(p.fri_proof),
        "query_openings": {
            str(lm): {
                str(pos): {
                    "trace": _enc_opening(qo.trace),
                    "quotient": _enc_opening(qo.quotient),
                    "perm": _opt(qo.perm, _enc_opening),
                    "pre": _opt(qo.pre, _enc_opening),
                }
                for pos, qo in by_pos.items()
            }
            for lm, by_pos in p.query_openings.items()
        },
    }


def machine_proof_from_dict(d) -> machine.MachineProof:
    if d.get("codec_version") != CODEC_VERSION:
        raise ValueError(f"codec version {d.get('codec_version')!r}, expected {CODEC_VERSION}")

    def roots(r):
        return {int(k): _dec_arr(v) for k, v in r.items()}

    return machine.MachineProof(
        meta=[(int(ln), int(w), [int(v) for v in pvs]) for ln, w, pvs in d["meta"]],
        trace_roots=roots(d["trace_roots"]),
        quotient_roots=roots(d["quotient_roots"]),
        perm_roots=roots(d["perm_roots"]),
        pre_roots=roots(d.get("pre_roots", {})),
        claimed_sums=[_opt(cs, _dec_arr) for cs in d["claimed_sums"]],
        opened=[machine.OpenedValues(**{name: _opt(ov.get(name), _dec_arr)
                                        for name in _OPENED})
                for ov in d["opened"]],
        fri_proof=_dec_fri(d["fri"]),
        query_openings={
            int(lm): {
                int(pos): machine.QueryOpening(
                    trace=_dec_opening(qo["trace"]),
                    quotient=_dec_opening(qo["quotient"]),
                    perm=_opt(qo.get("perm"), _dec_opening),
                    pre=_opt(qo.get("pre"), _dec_opening),
                )
                for pos, qo in by_pos.items()
            }
            for lm, by_pos in d["query_openings"].items()
        },
        stat=dict(d.get("stat", {})),
    )


def encode_machine_proof(p: machine.MachineProof) -> bytes:
    raw = json.dumps(machine_proof_to_dict(p), sort_keys=True).encode()
    return zlib.compress(raw, level=6)


def decode_machine_proof(b: bytes) -> machine.MachineProof:
    return machine_proof_from_dict(json.loads(zlib.decompress(b)))
