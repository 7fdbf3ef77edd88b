"""Circuit "apps": the host-side analog of the reference's guest programs.

The reference's `zkvm_prover_tpu/host/app.py` over the port's AIRs. A
CircuitApp converts a ProvingTask's serialized witness into AIR instances
and produces the 32-byte PI hash revealed as user public values
(reveal_pi_hash at crates/types/circuit/src/lib.rs:14-17; NUM_PUBLIC_VALUES
= 32 bytes-as-u32 at crates/types/base/src/aggregation.rs:22-25). An app's
identity is its 64-byte vk, equal in both packages.
"""

from __future__ import annotations

import hashlib
import json
from typing import Dict, List, Tuple

import numpy as np

from ..models.doubling import DoublingAir
from ..models.fibonacci import FibonacciAir
from ..models.symbolic import serialize_air
from ..ops.keccak import keccak256
from ..stark.machine import AirInstance
from .task import ProvingTask


class CircuitApp:
    """Interface every provable program implements."""

    name: str = ""

    def execute(self, task: ProvingTask) -> Tuple[List[AirInstance], bytes]:
        """'Guest execution': witness -> AIR instances + 32-byte PI hash."""
        raise NotImplementedError

    def airs(self) -> list:
        """AIR definitions, in instance order (the verifier's 'program')."""
        raise NotImplementedError

    def airs_for_meta(self, meta) -> list:
        """AIR list for verifying a proof with the given per-AIR meta
        (apps whose preprocessed schedules depend on trace heights
        override this)."""
        return self.airs()

    # commitments: the app "vk" (exe/vm commitment analog,
    # crates/prover/src/prover/mod.rs:129-174). exe_commit binds the
    # verifier-known program content (preprocessed traces — the ROM);
    # vm_commit binds the constraint system structure (every constraint,
    # constant, selector, and bus interaction, via the symbolic serializer).
    # Changing any constraint or ROM word changes the vk.
    def exe_commit(self) -> bytes:
        h = hashlib.sha256(f"zkvm-prover-tpu/exe/{self.name}".encode())
        for air in self.airs():
            pre = air.preprocessed_trace()
            if pre is None:
                h.update(b"\x00")
            else:
                h.update(np.ascontiguousarray(np.asarray(pre, dtype=np.uint32)).tobytes())
        return h.digest()

    def vm_commit(self) -> bytes:
        h = hashlib.sha256(f"zkvm-prover-tpu/vm/{self.name}".encode())
        for air in self.airs():
            felts = serialize_air(air)
            h.update(len(felts).to_bytes(4, "little"))
            for v in felts:
                h.update(int(v).to_bytes(4, "little"))
        return h.digest()

    def vk_bytes(self) -> bytes:
        """64-byte app vk: exe commit || vm commit (serialize_vk analog,
        crates/types/src/utils.rs:51-85). Cached per app class."""
        cls = type(self)
        cached = cls.__dict__.get("_vk_cached")
        if cached is None:
            cached = self.exe_commit() + self.vm_commit()
            cls._vk_cached = cached
        return cached

    def pi_hash_from_meta(self, metas) -> bytes:
        """Recompute the revealed PI hash from the per-AIR public values
        bound inside the machine proof — binds the envelope's
        user_pvs_proof to the proven statement."""
        raise NotImplementedError


def _pi_hash(pvs) -> bytes:
    return keccak256(b"".join(int(v).to_bytes(4, "big") for v in pvs))


class FibonacciApp(CircuitApp):
    """Stand-in guest program: witness = {"log_n", "x0", "x1"}."""

    name = "fibonacci"

    def airs(self):
        return [FibonacciAir()]

    def execute(self, task: ProvingTask):
        w = json.loads(task.serialized_witness[0].decode())
        air = FibonacciAir()
        trace, pvs = air.generate_trace(
            int(w["log_n"]), int(w.get("x0", 0)), int(w.get("x1", 1)))
        return [AirInstance(air, trace, pvs)], _pi_hash(pvs)

    def pi_hash_from_meta(self, metas) -> bytes:
        (_, _, pvs) = metas[0]
        return _pi_hash(pvs)


class FibDoubleApp(CircuitApp):
    """Two-AIR app exercising mixed heights under the host API."""

    name = "fib-double"

    def airs(self):
        return [FibonacciAir(), DoublingAir()]

    def execute(self, task: ProvingTask):
        w = json.loads(task.serialized_witness[0].decode())
        fib = FibonacciAir()
        dbl = DoublingAir()
        t1, pv1 = fib.generate_trace(int(w["log_n_fib"]))
        t2, pv2 = dbl.generate_trace(int(w["log_n_dbl"]))
        return ([AirInstance(fib, t1, pv1), AirInstance(dbl, t2, pv2)],
                _pi_hash(pv1 + pv2))

    def pi_hash_from_meta(self, metas) -> bytes:
        return _pi_hash([v for (_, _, pvs) in metas for v in pvs])


_REGISTRY: Dict[str, type] = {
    FibonacciApp.name: FibonacciApp,
    FibDoubleApp.name: FibDoubleApp,
}


def register_app(cls) -> None:
    _REGISTRY[cls.name] = cls


def _register_scroll_apps() -> None:
    """The chunk, batch and bundle apps register when `scroll_apps` is
    imported; it imports this module, so it is imported here on first use."""
    from . import scroll_apps  # noqa: F401


def get_app(name: str) -> CircuitApp:
    _register_scroll_apps()
    return _REGISTRY[name]()


_VK_CACHE: Dict[bytes, str] = {}


def app_for_vk(vk: bytes):
    """Resolve a registered app from its 64-byte vk (None if unknown)."""
    if vk in _VK_CACHE:
        return get_app(_VK_CACHE[vk])
    _register_scroll_apps()
    for name in _REGISTRY:
        cand = get_app(name)
        if cand.vk_bytes() == vk:
            _VK_CACHE[vk] = name
            return cand
    return None
