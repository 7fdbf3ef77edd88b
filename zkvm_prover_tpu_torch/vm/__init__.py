"""The guest side: the RV32IM assembler, the native executor's binding and
the benchmark guest."""
