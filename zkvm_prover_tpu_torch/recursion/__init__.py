"""Verifier-in-circuit recursion (SURVEY.md §7 Phase 5): the reference's
`zkvm_prover_tpu/recursion/` on the port's machine prover.

TPU-native re-design of openvm's native recursion stack (the
`openvm-native-recursion` verifier programs executed by the native field VM;
reference drives them via `AggregationTreeConfig` at
crates/prover/src/prover/mod.rs:47-60, with the in-guest deferred variant at
crates/types/circuit/src/lib.rs:138-154).

Instead of a RISC-V interpreter running a verifier program, the verifier is
compiled to a *wire circuit*: a straight-line SSA program over BabyBear^4
wires (add/sub/mul/bool/const/witness + Poseidon2 permutations), executed by
a three-chip machine (`WireAluAir`, `WirePoseidonAir`, `PublicBindAir` +
the shared `Poseidon2Air` table). The program is preprocessed (vk material);
the child proof is the witness. The program builds on the host; its
machine proof runs K1-K3 on the card like any other.
"""

from .wire_air import WIRE_BUS, PublicBindAir, WireAluAir, WirePoseidonAir
from .builder import CircuitBuilder, Wire
