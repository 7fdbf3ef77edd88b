"""zkvm_prover_tpu_torch — the STARK prover on PyTorch and CUDA.

A port of `zkvm_prover_tpu` (the JAX reference, which stays beside it) to
PyTorch tensors on an NVIDIA H100. Field elements are BabyBear residues in
Montgomery form, stored as canonical values in [0, p) in `torch.int32`
tensors, so every tensor is bit-identical to the reference's `uint32` arrays.

Layout (the reference's module names, PyTorch inside):
  fields/    BabyBear and its quartic extension (plain torch arithmetic);
             BN254 with its pairing and KZG, and BLS12-381 (host ints)
  ops/       NTT / coset LDE, Poseidon2, exact base-by-ext products, the
             BN254 Fq field and MSM; each hand-written CUDA kernel sits
             beside its plain torch version
  csrc/      the CUDA C++ sources (sm_90a), built by `_build.py`
  stark/     config, Merkle commitments, challenger, FRI, prover, verifier,
             the multi-AIR machine prover and verifier
  models/    AIR interface and builders, the Fibonacci / Poseidon2 / lookup
             AIRs, the rv32 machine's RV32IM and keccak chips (and the
             earlier v0 and v1 chipsets), the vk stream
  vm/        RV32IM assembler, native executor binding, benchmark and
             hash-reveal guests
  host/      the entry point: proving tasks, apps, Prover (disk cache,
             self-verify), UniversalVerifier, the proof envelope and codec
  types/, circuits/, integration/
             Scroll public-input types (with the chunk's secp256k1 / P-256,
             ECIES and validium crypto), the chunk circuit, the chunk task
             generator
  execution/ stateless re-execution of a chunk's block witnesses: RLP, the
             partial Merkle-Patricia trie, the EVM, blocks (host python)
  snark/     the BN254 PLONK wrapper: the EvmProof, its verifier bytecode and
             the mini-EVM that runs it (host ints; MSMs on the card)
  utils/     python-int extension arithmetic for the host verifier
  convert.py state carried across from the reference (constants, proofs)

Device rule: a kernel wrapper runs its plain version only for a CPU tensor;
for a CUDA tensor it launches the kernel or raises. The provers and the
verifiers (`stark.prover.prove`, `stark.machine.prove_machine` and
`verify_machine`, `host.Prover`, `host.UniversalVerifier`) and the BN254
MSM (`fields.bn254.msm_jac`, and through it the SNARK wrapper) run on the
card unless the caller passes `device="cpu"`.
"""

__version__ = "0.1.0"
