"""Command-line entry points (the reference's `zkvm_prover_tpu/bin/`), each
run as `python -m zkvm_prover_tpu_torch.bin.<name>`:

  chunk_benchmark  execute and prove a chunk task, with metrics
  chunk_scanner    execute chunk tasks without proving; a cycles CSV
  build_guest      the release assets: commitments, vks, verifier.bin
"""
