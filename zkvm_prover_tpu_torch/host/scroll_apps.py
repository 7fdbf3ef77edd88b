"""Scroll circuit apps through the host Prover, with the PI hash computed
INSIDE the rv32 VM: the reference's `zkvm_prover_tpu/host/scroll_apps.py`
over the port's machine.

Each app (chunk, batch, bundle) executes the hash-reveal guest
(vm/guests.py) on the native rv32 executor and proves the full v2 machine
— CPU chips, keccak syscall chips (KeccakVmAir + KeccakfAir), program
ROM, offline-checked registers/RAM, byte/xor tables — with the witness's
PI preimage entering through the hint stream and the keccak-256 digest
revealed as the proof's public values (reference flow:
crates/circuits/chunk-circuit/src/main.rs:14-29, read -> compute ->
reveal_pi_hash). The witness -> PI-preimage computation (block summaries,
the blob's zstd decoding and KZG check, the batch fold) runs host-side, as
in the reference.

The batch and bundle witnesses arrive pickled. They are read through
`_WitnessUnpickler`, which builds only the port's own witness classes: a
pickle that names any other module, the reference package's included,
raises `pickle.UnpicklingError`.
"""

from __future__ import annotations

import io
import pickle

from ..circuits.batch_circuit import BatchCircuit, BatchCircuitWitness
from ..circuits.bundle_circuit import BundleCircuit
from ..circuits.chunk_circuit import ChunkCircuit
from ..models import rv32_v2
from ..models.keccak_air import KeccakfAir
from ..models.keccak_vm import KeccakVmAir
from ..models.rv32_v0 import ByteTableAir, MemoryBoundaryAir
from ..ops.keccak import keccak256
from ..stark.machine import AirInstance
from ..vm import guests
from ..vm.executor import HALTED, Rv32Executor
from .app import CircuitApp, register_app
from .task import ProvingTask

# positions in the instance order that rv32_v2.generate_traces produces for
# a keccak-using guest, which `_VmHashApp.airs_for_meta` follows
KECCAKF_IDX = 9
PV_IDX = 11


class _VmHashApp(CircuitApp):
    """App whose machine is the rv32 VM running the hash-reveal guest."""

    circuit = None  # subclass sets
    MAX_CYCLES = 1 << 16
    # cap on the claimed keccak-table height: 2^20 rows (~43k permutations)
    # is far beyond any hash-reveal guest; an unvalidated claim would let a
    # hostile envelope allocate a 2^claimed-row preprocessed trace before
    # any check fails (memory DoS).
    MAX_KECCAK_LOG_N = 20

    def _witness_from_task(self, task: ProvingTask):
        raise NotImplementedError

    def program(self):
        cls = type(self)
        prog = cls.__dict__.get("_prog_cached")
        if prog is None:
            prog = guests.hash_reveal_program()
            cls._prog_cached = prog
        return prog

    def airs(self):
        return self.airs_for_meta(None)

    def airs_for_meta(self, meta):
        """AIR list in generate_traces' order; KeccakfAir's preprocessed
        schedule depends on its height, read from `meta`. A longer `meta`
        is an app machine whose in-circuit child verifiers follow its 18
        AIRs. `meta` is untrusted: a short list or a keccak height out of
        bounds raises ValueError (the host verifier maps that to a clean
        False)."""
        kec_log_n = 5
        if meta is not None:
            if len(meta) <= max(KECCAKF_IDX, PV_IDX):
                raise ValueError("not a VM machine proof")
            kec_log_n = int(meta[KECCAKF_IDX][0])
            if not 5 <= kec_log_n <= self.MAX_KECCAK_LOG_N:
                raise ValueError(f"claimed keccak table height 2^{kec_log_n} out of bounds")
        airs = [
            rv32_v2.AluAir(), rv32_v2.ShiftAir(), rv32_v2.BranchAir(),
            rv32_v2.JumpAir(), rv32_v2.LoadStoreAir(), rv32_v2.MulAir(),
            rv32_v2.DivRemAir(), rv32_v2.SystemAir(),
            KeccakVmAir(), KeccakfAir(log_n=kec_log_n),
            rv32_v2.ProgramAirV2(self.program()),
            rv32_v2.PublicValuesAir(),
            rv32_v2.ExecBoundaryAirV2(), rv32_v2.RamBoundaryAirV2(),
            MemoryBoundaryAir(), ByteTableAir(), rv32_v2.XorTableAir(),
            rv32_v2.Range16TableAir(),
        ]
        if meta is not None and len(meta) < len(airs):
            raise ValueError(f"not a VM machine proof: {len(meta)} AIRs, expected {len(airs)}")
        return airs

    def execute(self, task: ProvingTask):
        witness = self._witness_from_task(task)
        pi, version = self.circuit.validate(witness)
        preimage = pi.pi_by_version(version)

        prog = self.program()
        ex = Rv32Executor()
        ex.load_program(prog)
        ex.set_hints(guests.hash_hints(preimage))
        state = ex.run(self.MAX_CYCLES)
        if state != HALTED:
            raise RuntimeError(f"guest did not halt (state={state})")
        air_traces = rv32_v2.generate_traces(prog, ex.records(), data_base=guests.DATA_BASE)
        instances = [AirInstance(a, t, p) for a, t, p in air_traces]

        pi_hash = b"".join(int(w).to_bytes(4, "little") for w in ex.public_values())
        if pi_hash != keccak256(preimage):
            raise RuntimeError("guest/host digest mismatch")
        return instances, pi_hash

    def pi_hash_from_meta(self, metas) -> bytes:
        (_, _, pvs) = metas[PV_IDX]
        n = rv32_v2.N_PV_WORDS
        if len(pvs) < 5 * n or list(pvs[4 * n:5 * n]) != [1] * n:
            raise ValueError("all PV words must be revealed")
        return bytes(int(v) & 0xFF for v in pvs[:4 * n])


class ChunkApp(_VmHashApp):
    name = "chunk"
    circuit = ChunkCircuit

    def _witness_from_task(self, task: ProvingTask):
        return ChunkCircuit.deserialize_witness(task.serialized_witness[0])


_WITNESS_MODULES = ("zkvm_prover_tpu_torch.circuits.batch_circuit",)
_WITNESS_PACKAGE = "zkvm_prover_tpu_torch.types."


class _WitnessUnpickler(pickle.Unpickler):
    """Admits only classes defined in the port's witness modules."""

    def find_class(self, module, name):
        if not (module in _WITNESS_MODULES or module.startswith(_WITNESS_PACKAGE)) \
                or "." in name:
            raise pickle.UnpicklingError(f"witness may not name {module}.{name}")
        try:
            obj = super().find_class(module, name)
        except (ImportError, AttributeError) as e:
            raise pickle.UnpicklingError(f"no witness class {module}.{name}") from e
        if not isinstance(obj, type) or obj.__module__ != module:
            raise pickle.UnpicklingError(f"{module}.{name} is not a witness class")
        return obj


def load_witness(data: bytes):
    """A pickled batch or bundle witness, read by `_WitnessUnpickler`."""
    return _WitnessUnpickler(io.BytesIO(data)).load()


class BatchApp(_VmHashApp):
    name = "batch"
    circuit = BatchCircuit

    def _witness_from_task(self, task: ProvingTask):
        inner, chunk_proofs = load_witness(task.serialized_witness[0])
        return BatchCircuitWitness(inner=inner, chunk_proofs=chunk_proofs)


class BundleApp(_VmHashApp):
    name = "bundle"
    circuit = BundleCircuit

    def _witness_from_task(self, task: ProvingTask):
        return load_witness(task.serialized_witness[0])


for _cls in (ChunkApp, BatchApp, BundleApp):
    register_app(_cls)
