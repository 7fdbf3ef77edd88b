"""Scale-out: sharded proving over a device mesh and proving pools (the
reference's `zkvm_prover_tpu/parallel/`).

  mesh.py              the ("data", "shard") mesh of torch devices, sharded
                       arrays and the shard-axis collectives
  ntt_sharded.py       four-step NTTs and the coset LDE over the mesh
  merkle_sharded.py    a Merkle root with leaves sharded
  fri_sharded.py       the FRI fold with its routed halves
  pipeline_sharded.py  the whole prover core sharded (`stark/pipeline.py`)
  pool.py              independent proofs in a spawn process pool
"""
