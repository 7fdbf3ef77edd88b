"""State carried across from the reference package.

The system has no weights. What crosses between the two packages is the
Poseidon2 round-constant tables, the traces (plain numpy, shared as they
are), the proofs (a deferred envelope crosses as JSON, like every other
envelope; a continuation segment's proof as a machine proof), the chunk
(with its block witnesses), batch and bundle witnesses, and the SNARK wrapper's SRS, PLONK keys and
EvmProofs (python ints and bytes, so one reference key build serves both
packages' tests). Nothing here imports
the reference: proofs are read by duck typing, from any object with the
reference's attribute names and numpy-valued fields, and witnesses are
rebuilt field by field as the port's classes of the same names.
"""

from __future__ import annotations

import dataclasses
import enum
import importlib

import numpy as np

from .ops import poseidon2 as p2
from .stark import fri, machine, merkle
from .stark.prover import QueryOpening, StarkProof


def load_reference_constants(external, internal, diag) -> None:
    """Install Poseidon2 round constants (canonical numpy arrays): external
    (ROUNDS_F, width), internal (ROUNDS_P[width],), diag (width,). The same
    tables passed to the reference's `load_constants` make both packages
    hash alike."""
    external = np.asarray(external)
    width = external.shape[-1]
    p2.load_constants(width, external, internal, diag)


def _u32(a) -> np.ndarray:
    return np.array(np.asarray(a), dtype=np.uint32)


def _opening(obj) -> merkle.Opening:
    return merkle.Opening(index=int(obj.index),
                          rows=[_u32(r) for r in obj.rows],
                          siblings=[_u32(s) for s in obj.siblings])


def fri_proof_from_numpy(f) -> fri.FriProof:
    """The port's FriProof from a reference-shaped one."""
    return fri.FriProof(
        commitments=[_u32(c) for c in f.commitments],
        final_poly=_u32(f.final_poly),
        pow_witness=int(f.pow_witness),
        rounds=[fri.FriRoundProof(openings=[(_opening(a), _opening(b))
                                            for a, b in r.openings])
                for r in f.rounds],
        query_indices=[int(i) for i in f.query_indices],
    )


def proof_from_numpy(obj) -> StarkProof:
    """The port's StarkProof from a reference-shaped proof object."""
    fri_proof = fri_proof_from_numpy(obj.fri_proof)
    return StarkProof(
        log_n=int(obj.log_n),
        width=int(obj.width),
        public_values=[int(v) for v in obj.public_values],
        trace_root=_u32(obj.trace_root),
        quotient_root=_u32(obj.quotient_root),
        opened_trace_zeta=_u32(obj.opened_trace_zeta),
        opened_trace_zeta_next=_u32(obj.opened_trace_zeta_next),
        opened_quotient=_u32(obj.opened_quotient),
        fri_proof=fri_proof,
        query_openings={
            int(pos): QueryOpening(index=int(qo.index),
                                   trace=_opening(qo.trace),
                                   quotient=_opening(qo.quotient))
            for pos, qo in obj.query_openings.items()
        },
        stat=dict(getattr(obj, "stat", {}) or {}),
    )


def _optional(x, fn):
    return None if x is None else fn(x)


def machine_proof_from_numpy(obj) -> machine.MachineProof:
    """The port's MachineProof from a reference-shaped machine proof."""
    def roots(d):
        return {int(lm): _u32(r) for lm, r in d.items()}

    return machine.MachineProof(
        meta=[(int(log_n), int(w), [int(v) for v in pvs]) for log_n, w, pvs in obj.meta],
        trace_roots=roots(obj.trace_roots),
        quotient_roots=roots(obj.quotient_roots),
        perm_roots=roots(obj.perm_roots),
        pre_roots=roots(obj.pre_roots),
        claimed_sums=[_optional(c, _u32) for c in obj.claimed_sums],
        opened=[machine.OpenedValues(**{
            name: _optional(getattr(ov, name), _u32)
            for name in machine.OpenedValues.__dataclass_fields__}) for ov in obj.opened],
        fri_proof=fri_proof_from_numpy(obj.fri_proof),
        query_openings={
            int(lm): {int(pos): machine.QueryOpening(
                trace=_opening(qo.trace), quotient=_opening(qo.quotient),
                perm=_optional(qo.perm, _opening), pre=_optional(qo.pre, _opening))
                for pos, qo in by_pos.items()}
            for lm, by_pos in obj.query_openings.items()},
        stat=dict(getattr(obj, "stat", {}) or {}),
    )


# the port's modules whose dataclasses and enums make up the witnesses
_WITNESS_MODULES = (
    "types.base.fork_name", "types.base.version", "types.base.aggregation",
    "types.base.chunk", "types.base.batch", "types.base.bundle",
    "types.chunk.types", "types.chunk.witness", "types.batch.header",
    "types.batch.witness", "types.bundle.witness", "circuits.batch_circuit",
    "execution.block",
)


def witness_classes() -> dict:
    """The port's witness dataclasses and enums, by class name."""
    out = {}
    for name in _WITNESS_MODULES:
        module = importlib.import_module(f"{__package__}.{name}")
        for obj in vars(module).values():
            if isinstance(obj, type) and obj.__module__ == module.__name__ and (
                    dataclasses.is_dataclass(obj) or issubclass(obj, enum.Enum)):
                out[obj.__name__] = obj
    return out


def rebuild(obj, classes: dict):
    """`obj` rebuilt with `classes[type name]` for every dataclass and enum
    in it, field by field; lists, tuples, dicts, bytes, ints, strings and
    None are carried as they are. A class or field missing on either side
    raises."""
    if isinstance(obj, enum.Enum) or dataclasses.is_dataclass(obj):
        name = type(obj).__name__
        if name not in classes:
            raise TypeError(f"no class named {name} to rebuild")
        cls = classes[name]
        if isinstance(obj, enum.Enum):
            return cls(obj.value)
        src = sorted(f.name for f in dataclasses.fields(obj))
        dst = sorted(f.name for f in dataclasses.fields(cls))
        if src != dst:
            raise TypeError(f"{name}: fields differ: {src} != {dst}")
        return cls(**{k: rebuild(getattr(obj, k), classes) for k in dst})
    if obj is None or isinstance(obj, (bool, int, str, bytes)):
        return obj
    if isinstance(obj, (list, tuple)):
        return type(obj)(rebuild(x, classes) for x in obj)
    if isinstance(obj, dict):
        return {rebuild(k, classes): rebuild(v, classes) for k, v in obj.items()}
    raise TypeError(f"cannot rebuild a {type(obj).__name__}")


def witness_from_reference(obj):
    """A reference witness object (a batch or bundle witness, or anything
    made of the witness dataclasses and enums) as the port's classes."""
    return rebuild(obj, witness_classes())


def srs_from_reference(srs):
    """The port's KzgSrs from a reference-shaped one (G1 powers and
    [tau]G2 as python ints)."""
    from .fields import bn254 as bn

    return bn.KzgSrs(list(srs.g1_powers), srs.tau_g2)


def plonk_vk_from_reference(vk):
    from .snark import plonk

    return plonk.PlonkVk(log_n=int(vk.log_n), n_public=int(vk.n_public),
                         q_comms=list(vk.q_comms), sigma_comms=list(vk.sigma_comms),
                         tau_g2=vk.tau_g2)


def plonk_pk_from_reference(pk, srs):
    """The port's PlonkPk from a reference-shaped one, on `srs`, the port's
    copy of the SRS it was made on."""
    from .snark import plonk

    return plonk.PlonkPk(vk=plonk_vk_from_reference(pk.vk),
                         q_polys=[list(p) for p in pk.q_polys],
                         sigma_polys=[list(p) for p in pk.sigma_polys],
                         sigma_maps=[list(m) for m in pk.sigma_maps],
                         srs=srs)


def wrapper_keys_from_reference(keys):
    """The port's WrapperKeys from the reference's (its SRS converted once,
    shared by the proving key)."""
    from .snark import wrapper

    srs = srs_from_reference(keys.srs)
    return wrapper.WrapperKeys(pk=plonk_pk_from_reference(keys.pk, srs), srs=srs)


def evm_proof_from_reference(proof):
    from .host.proof_types import EvmProof

    return EvmProof(proof=bytes(proof.proof), instances=bytes(proof.instances))
