"""BN254 SNARK wrapper layer: the reference's `zkvm_prover_tpu/snark/`.

The analog of the reference system's halo2/snark-verifier outer layer
(crates/prover/src/prover/mod.rs:419-432, crates/verifier/src/evm.rs): a
PLONK proof system over BN254 with KZG commitments, a wrapper circuit
binding the root STARK proof's (vk, public values) into the on-chain
EvmProof instance layout, a generated EVM-bytecode verifier, and a mini
EVM simulator to execute it (the revm-simulation analog). Host python
ints, as in the reference; the commitments' MSMs run on K4 on the card
(`ops/msm.py`) or the host engine on the CPU.
"""
