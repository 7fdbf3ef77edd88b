"""Host verifier API (parity with reference `UniversalVerifier` at
crates/verifier/src/verifier.rs:17-141): the reference's
`zkvm_prover_tpu/host/verifier.py` over the port's `verify_machine`.

The vk guard, the PI-hash binding, the in-circuit aggregation claims
(`agg_children`: the wire verifier rebuilt from the claimed children, its
digest pinned) and the machine verification are here. The replay is host
code; the preprocessed commitments it recomputes (vk material, which for a
wire verifier has millions of rows) are made on `device`: the card unless
the caller passes `device="cpu"`, as for the prover. An envelope with a
deferral discharge proof goes, after the vk guard, to
`host/deferred.py::verify_deferred` on the same device. `verify_evm_proof`
checks the BN254 SNARK wrapper's EvmProof, its MSMs on the same device.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np

from ..recursion.aggregation import (
    TAG_LEAF,
    ChildSlot,
    child_verification_airs,
    digest_bytes,
    input_commit,
    node_digest_words,
)
from ..stark import machine
from ..stark.config import StarkConfig
from . import serialization
from .app import app_for_vk, get_app
from .deferral import decode_and_verify
from .proof_types import EvmProof, StarkProof


class UniversalVerifier:
    def __init__(self, app_name: str, stark: Optional[StarkConfig] = None,
                 device=None):
        self.app = get_app(app_name)
        self.stark = stark or StarkConfig()
        self.device = device

    @classmethod
    def setup(cls, assets_dir: str) -> "UniversalVerifier":
        """Load from a release-assets dir containing app_vk.json
        (release-asset layout analog, verifier.rs:94-108)."""
        meta = json.loads((Path(assets_dir) / "app_vk.json").read_text())
        v = cls(meta["app_name"])
        if v.app.vk_bytes() != bytes.fromhex(meta["vk"]):
            raise ValueError("vk mismatch vs release assets")
        return v

    def verify_stark_proof(self, proof: StarkProof) -> bool:
        return self.verify_stark_proof_with_vk(
            self.app.vk_bytes(), proof, self.stark, app=self.app, device=self.device)

    @staticmethod
    def verify_stark_proof_with_vk(
        vk: bytes, proof: StarkProof, stark: Optional[StarkConfig] = None,
        app=None, device=None,
    ) -> bool:
        # commitment guard (verifier.rs:77-80): baseline must carry the
        # expected app vk
        if proof.baseline != vk:
            return False
        if app is None:
            app = app_for_vk(vk)
            if app is None:
                return False
        # Everything below operates on the untrusted proof envelope: a
        # malformed or hostile encoding must yield a clean False, never an
        # assertion/index error escaping to the caller (the reference
        # verifier returns Result the same way, verifier.rs:60-92).
        try:
            return UniversalVerifier._verify_decoded(proof, stark or StarkConfig(), app, device)
        except Exception:
            return False

    @staticmethod
    def _verify_decoded(proof: StarkProof, stark: StarkConfig, app, device) -> bool:
        if proof.deferral_discharge:
            # deferred aggregation: the guest deferred child verification
            # and the envelope carries a discharge proof
            from .deferred import verify_deferred

            return verify_deferred(proof, stark, device)
        mproof = serialization.decode_machine_proof(proof.proof)
        airs = app.airs_for_meta(mproof.meta)
        n_app = len(airs)
        # bind the revealed PI hash to the public values inside the proof
        if app.pi_hash_from_meta(mproof.meta[:n_app]) != proof.user_pvs_proof:
            return False

        # verifier-in-circuit aggregation: rebuild the wire verification
        # program from the claimed children (registered app circuits at the
        # claimed heights) and pin the digest over (child vk, child PVs).
        # Everything in agg_children is an untrusted hint: a mismatch in
        # app, heights, or PVs fails either the digest pin or the machine
        # verification against the rebuilt preprocessed program.
        if proof.agg_children:
            slots, children, commits = [], [], []
            for rec in proof.agg_children:
                child_app = app_for_vk(rec.vk)
                if child_app is None:
                    return False
                # rebuild the child's AIR list at its claimed heights
                # (VM apps have height-dependent preprocessed schedules)
                meta_like = [(int(ln), None, []) for ln in rec.log_ns]
                slot = ChildSlot(child_app.airs_for_meta(meta_like), rec.log_ns, stark, device)
                slots.append(slot)
                children.append((slot.vk_words, rec.pvs))
                commits.append(input_commit(slot.vk_words, rec.pvs))
            # input_commits + deferral Merkle data must match the children
            if proof.input_commits != commits:
                return False
            if not decode_and_verify(proof.deferral_merkle_proofs, commits):
                return False
            airs = airs + child_verification_airs(TAG_LEAF, slots)
            if len(mproof.meta) != len(airs):
                return False
            # PublicBindAir is the third wire AIR (n_app + 2)
            (_, _, digest_pvs) = mproof.meta[n_app + 2]
            expected = digest_bytes(node_digest_words(TAG_LEAF, children))
            if digest_bytes(np.array(digest_pvs, dtype=np.uint32)) != expected:
                return False

        return machine.verify_machine(airs, mproof, stark, device=device)

    def verify_evm_proof(self, proof: EvmProof) -> bool:
        """EvmProof verification (verify_evm_proof analog,
        crates/verifier/src/evm.rs:38-43): PLONK verify (host + generated
        EVM bytecode under the mini-EVM simulator), instance/vk binding,
        and the deferred KZG accumulator pairing."""
        from ..snark import wrapper as snark_wrapper

        return snark_wrapper.verify_evm_proof(self.app.vk_bytes(), proof, device=self.device)

    def dump_vk(self, assets_dir: str) -> None:
        Path(assets_dir).mkdir(parents=True, exist_ok=True)
        (Path(assets_dir) / "app_vk.json").write_text(
            json.dumps({"app_name": self.app.name, "vk": self.app.vk_bytes().hex()}))
