"""Host verifier API (parity with reference `UniversalVerifier` at
crates/verifier/src/verifier.rs:17-141): the reference's
`zkvm_prover_tpu/host/verifier.py` over the port's `verify_machine`.

The vk guard, the PI-hash binding and the machine verification are here.
Three paths wait, and raise `NotImplementedError` before any check so that
none is reported as an invalid proof: an envelope with a deferral
discharge proof or with in-circuit aggregated children (both need
`recursion/`, ROADMAP Queue 1 item 9), and `verify_evm_proof` (the BN254
SNARK wrapper, item 10).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

from ..stark import machine
from ..stark.config import StarkConfig
from . import serialization
from .app import app_for_vk, get_app
from .proof_types import EvmProof, StarkProof

_NO_RECURSION = ("ROADMAP Queue 1 item 9: verifying {} needs recursion/ "
                 "(the in-circuit STARK verifier)")


class UniversalVerifier:
    def __init__(self, app_name: str, stark: Optional[StarkConfig] = None):
        self.app = get_app(app_name)
        self.stark = stark or StarkConfig()

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
            self.app.vk_bytes(), proof, self.stark, app=self.app)

    @staticmethod
    def verify_stark_proof_with_vk(
        vk: bytes, proof: StarkProof, stark: Optional[StarkConfig] = None,
        app=None,
    ) -> bool:
        if proof.deferral_discharge:
            raise NotImplementedError(_NO_RECURSION.format("a deferral discharge proof"))
        if proof.agg_children:
            raise NotImplementedError(_NO_RECURSION.format("aggregated children"))
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
            return UniversalVerifier._verify_decoded(proof, stark or StarkConfig(), app)
        except Exception:
            return False

    @staticmethod
    def _verify_decoded(proof: StarkProof, stark: StarkConfig, app) -> bool:
        mproof = serialization.decode_machine_proof(proof.proof)
        airs = app.airs_for_meta(mproof.meta)
        # bind the revealed PI hash to the public values inside the proof
        if app.pi_hash_from_meta(mproof.meta[:len(airs)]) != proof.user_pvs_proof:
            return False
        return machine.verify_machine(airs, mproof, stark)

    def verify_evm_proof(self, proof: EvmProof) -> bool:
        raise NotImplementedError(
            "ROADMAP Queue 1 item 10: verifying an EvmProof needs snark/ "
            "(the BN254 PLONK wrapper)")

    def dump_vk(self, assets_dir: str) -> None:
        Path(assets_dir).mkdir(parents=True, exist_ok=True)
        (Path(assets_dir) / "app_vk.json").write_text(
            json.dumps({"app_name": self.app.name, "vk": self.app.vk_bytes().hex()}))
