#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`zkvm_prover_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py [--log-n 18] [--seed 0] [--out build/chip_smoke.json]

Phases (any failure exits non-zero; nothing is caught or skipped). From
phase 6 on, a path checks the kernel shapes of its proofs that no earlier
check of the run covered (`CHECKED`), and every C call of the path must be
at a shape some check of the run covered:
  1. card and build: nvidia-smi's name and power limit, torch's CUDA
     version, the kernels' build time (nvcc, sm_90a, from csrc/); what the
     compiler made of them and the card's integer issue rates
     (zkvm_prover_tpu_torch/kernel_report.py);
  2. every kernel against its plain torch version on the card, at the
     shapes the main path gives it: mismatches (must be 0), time per launch
     (CUDA events), the plain version's time and the bound; K1 per pass,
     per whole transform and as the fused coset LDE (interpolation plus two
     cosets), each with the bound of that whole function;
  3. the main path: a Poseidon2Air trace of 2^log_n rows x 495 columns from
     --seed, proven on cuda at default_config() (100 queries, 16 PoW bits,
     blowup 2) with the launch counts zeroed just before and read just
     after; per-phase wall-clock, peak memory, verify (True) and a tampered
     proof (False); then a second (warm) proof, and a third under
     torch.profiler: device ms and launches per kernel and per shape, the
     device's idle share over the proof, the plain torch kernels that run
     in the LDE (from the proof's start to its first row hash), at most 3
     compress launches per Merkle tree and at most 2 K1 launches per
     transform;
  4. the machine cell: one `prove_machine` / `verify_machine` at
     default_config() over Poseidon2Air (the phase-3 trace, its two bus
     multiplicity columns set to 0), RangeCheckedAir (2^log_n values from
     --seed in [0, 2^(log_n-2))) and RangeTableAir (2^(log_n-2) rows, which
     receives them on the range bus), with the launch counts zeroed just
     before and read just after: wall-clock, per-phase ms, peak memory,
     launches per kernel (every kernel launched; at most one K3 rows launch
     per (AIR, matrix) and one transposed call per (AIR, matrix or quotient
     chunk)), verify (True) and a tampered claimed sum (False); then a warm
     and a profiled machine proof;
  5. cross-device identity: a 2^10-row proof at fast_test_config(), a
     small machine proof (four AIRs, three heights, a logUp bus) and a
     fibonacci envelope from `Prover.gen_proof_stark` on cuda and on cpu,
     each equal in every field but `stat` (the small rv32 proof on cuda and
     cpu, 47 s here, is tests/test_torch_gpu.py::
     test_small_rv32_proof_cuda_equals_cpu, and its kernel census, a
     profile that took 50-77 s, test_small_rv32_kernel_census);
  6. the rv32 machine path: the native executor built (g++), the benchmark
     guest bench_guest_program(8, 256) run (24,729 cycles) and traced (18
     AIRs); the kernel shapes of its proof checked against their plain
     versions; then `prove_machine` at default_config() with the launch
     counts zeroed just before and read just after, and every C call of
     the proof at a checked shape: guest_cycles, tracegen_s, proof_wall_s,
     proving_khz, per-phase ms, peak memory, the values `ood` observed,
     verify_wall_s (True) and a tampered public value (False);
  7. the host entry point: ChunkTaskGenerator(stark=chain_config()), that
     is default_config() at 25 FRI queries (`CHAIN_QUERIES`; phases 8, 12
     and 13 prove at it too), with
     its proof cache in a fresh build/chip_smoke_chunk/; the chunk
     machine's new kernel shapes (18 AIRs, from its executed traces)
     checked against their plain versions; `Prover.gen_proof_stark` on chunk 0
     (execute the hash-reveal guest, prove on the card, self-verify) with
     the launch counts zeroed just before and read just after, every C
     call at a checked shape: execute, prove and self-verify ms, launches
     per kernel (each nonzero), peak memory, the envelope's size and the
     values `ood` observed; a flipped `user_pvs_proof` byte (False); a
     second call answered from the cache with no launch and an equal
     envelope;
  8. the batch and bundle layers: the batch through
     `Prover(ProverConfig("batch", stark=chain_config()))`, whose default
     child verification is in-circuit, over BatchTaskGenerator's task 0 (1
     chunk a batch, over phase 7's chunk 0 envelope after a JSON round
     trip): with the launch counts zeroed just before, `gen_proof_stark`
     executes (the blob's zstd decode and KZG check), makes chunk 0's
     preprocessed commitments on the card, builds the wire verifier of
     chunk 0 on the host, checks the new kernel shapes of the batch-plus-wire
     machine against their plain versions just before proving it on the card
     (the check's launches taken back out), and self-verifies (the wire
     program rebuilt from the claimed child); every C call at a checked
     shape, every counter nonzero; the wire AIRs' rows, the build, pre-root,
     prove (with its phase split) and self-verify times and the peak are
     printed with the card's name and power limit; the envelope through
     `UniversalVerifier` (True) and with a forged child record (False).
     Then BundleTaskGenerator (1 batch a bundle, children verified on the
     host: its check of the batch goes through the verifier's in-circuit
     branch): its new shapes checked, `gen_proof_stark`, the envelope
     through `UniversalVerifier` (True) and with a flipped `user_pvs_proof`
     byte (False); a batch task whose KZG proof is tampered raises in
     execute with no launch; a second bundle call answered from the cache;
  9. the ext guest: one secp256k1 ECDSA verification from --seed over
     64-bit scalars (`ECDSA_SCALAR_BITS`; w = 1/s by modop DIV, u1 and u2
     by modop MUL mod n, about 126 ec_double and 61 ec_add, x(R)
     revealed), keccak of the 64-byte Q, sha256 of 150 bytes, fp2 MUL /
     ADD / SUB over BN254 Fq and two defer calls: every extension syscall
     family. x(R) mod n == r, the digests in RAM and
     DeferralVmAir's public values (the chain digest of the leaves) are
     checked on the host; the AIRs' heights and widths and the cells are
     printed; then, as in phase 6, the new kernel shapes of the proof
     checked against their plain versions, the proof at default_config() (launch
     counts zeroed just before, every C call at a checked shape), verify
     (True) and a tampered public value (False);
 10. deferred aggregation: two fibonacci children (log_n 3) from
     `Prover.gen_proof_stark` at default_config(); then
     `DeferredProver(default_config()).prove(children)` with the launch
     counts zeroed just before and read just after: the deferred-agg guest
     executed (it defers each child and reveals keccak of the leaves), its
     20-AIR machine proven, the discharge leaf node (the wire verifier of
     both children) built and proven, the envelope self-verified; each
     proof's kernel shapes that no earlier phase checked are checked
     against their plain versions just before it (`CHECKED`; the check's
     launches taken back out), every C call at a checked shape, every
     counter nonzero; the parent's AIRs and heights, the discharge's wire
     rows, the build, prove and self-verify seconds, the phase splits and
     the peak; `UniversalVerifier` with the deferred-agg vk (True), a child
     record's public value flipped (False), a discharge byte flipped
     (False);
 11. continuations: phase 6's guest through `execute_segments` in
     2^14-cycle segments over the default depth-17 memory tree (2
     segments, one boundary), each traced (19 AIRs: the rv32 chips with
     ExecBoundaryAirV3, MemoryBoundaryAirV3, MemoryMerkleAir and
     Poseidon2Air); their new kernel shapes checked; `prove_segments` at
     default_config() with the launch counts zeroed just before and read
     just after, every C call at a checked shape, every counter nonzero;
     `verify_chain` (True); the chain's revealed public values equal to
     phase 6's unsegmented run; the chain with its segments swapped,
     without its halting segment and against a wrong initial root (each
     False); per segment the cycles, AIRs, cells, MemoryMerkleAir and
     Poseidon2Air rows, prove and verify seconds, and the peak;
 12. the SNARK wrapper (BN254 PLONK, KZG commitments on kernel K4): K4's
     Fq product on 2^20 words (and its rate) and a whole MSM of 2^9 points
     (a run of one point longer than a chunk, opposite pairs across chunk
     edges, infinity, zero digits, scalars >= r) against their plain
     versions on the card and the host engine; then, with the launch
     counts zeroed just before and read just after, phase 8's bundle
     Prover `gen_proof_universal(task, with_snark=True)`: its STARK from
     the prover's disk cache (no STARK launch), the wrapper keys (an SRS
     of 2^13 powers, `plonk.setup`), the accumulator over the proof bytes,
     `plonk.prove`, every MSM of eight or more points on K4 (the chunk and
     window-sum entries once per MSM, the reduction once a level); the
     split (SRS, setup, accumulator, keccak, prove, K4 device ms and
     launches) and the seconds; every MSM of the wrap against the host
     engine with its n, c, occupied buckets, longest run per window, host
     ms (pack, digits and sort, combine) and device ms per K4 entry;
     `UniversalVerifier.verify_evm_proof` True, and False for a flipped
     instance byte, a flipped proof byte and another app's vk; last K4 on
     the path's largest and its most skewed MSM (each entry against its
     plain version as affine points, level by level, the bucket step
     against the reference's combine, the whole against the host engine),
     with each entry's ms, plain ms and bound, and uniform scalars on the
     path's points at each size beside the wrap's MSMs;
 13. a chunk of real transactions: a chain built from --seed with the
     port's `execution/` (a genesis of 1,024 funded EOAs, a token contract,
     a contract that calls each precompile 0x01-0x08, the withdraw-queue
     predeploy and the L1 gas-price oracle with its Curie scalars; three
     blocks of 30 transactions, chained by parent hash: legacy and EIP-1559
     transfers, token transfers, an L1 message a block, one contract
     creation, one reverting call, the precompile call; each block sealed
     by an oracle run over the full trie, its witness the partial trie that
     run read); the precompiles' outputs against the host; its block
     witnesses in a JSON chunk task at phase 7's version through phase 7's
     Prover with the launch counts zeroed just before and read just after
     (re-execution, timed apart from the guest, inside execute; the proof
     on the card at chain_config(); the self-verify), every C call at a
     checked shape, every counter nonzero; the ChunkInfo against the
     headers, `UniversalVerifier` True; a header's gas_used + 1, a claimed
     post state root that execution contradicts and a transaction's claimed
     sender changed each raise in execute with no launch;
 14. parallel/ on a mesh of 4 logical shards of cuda:0: (a)
     `make_prover_core` and `make_prover_core_sharded` on phase 3's
     Poseidon2Air trace at default_config() with three challenges from
     --seed, each run once to collect its C calls, the shapes new to the
     run checked against their plain versions (`check_calls`), then run
     again with the launch counts zeroed just before and read just after
     (wall-clock, peak, launches; every C call at a checked shape); their
     four outputs equal bit for bit; (b) the sharded four-step NTT at
     (2^20, 8) and (2^22, 2), `commit_root_sharded` at (2^19, 495) and
     `fold_round_sharded` at 2^20 rows against their single-device
     functions; (c) two fibonacci children (log_n 3) and one leaf node over
     them proved here at fast_test_config() with the counts zeroed, then
     `RecursiveAggregationProver.aggregate([p1, p2, p1, p2], workers=2)`:
     two leaf nodes proved by two spawned workers on cuda:0, each
     byte-equal to the serial one, each worker reporting the launches and
     C calls of its own task (counters zeroed at its start): every call at
     a checked shape, its proving launches equal to the serial leaf's;
     the root proved here, verified, its digest the node digest over the
     two leaves; the pool's leaf level against the serial leaf's seconds;
 15. (a) the width-24 Poseidon2 permutation (`permute24_kernel`), each of
     its two instances called once through `ops.poseidon2.permute` on
     (2^18, 24) states from --seed with the launch counts zeroed just
     before and read just after (one launch of that instance's counter, no
     other): the shift-form diagonal under the derived constants, the
     general one under a diagonal from --seed; each against its plain
     version: ms, plain ms, bound (each from its own products: 852 a
     permutation with the shift-form diagonal, 1,356 with products);
     registers, SASS instructions and wide multiplies (phase 1's) and
     spills (ptxas; a spill fails) of both and of the three width-16
     kernels; (b) the
     rv32 v1 chipset (branches, loops, word RAM) at its largest run, 4,096
     cycles (timestamp differences are 16-bit range-checked): a
     fibonacci loop of 799 iterations (4,000 cycles) and an LW/SW
     array-sum loop over 400 words above 0x1000 (4,008 cycles), each
     executed and traced (6 AIRs), its registers checked on the host, its
     new kernel shapes checked against their plain versions, proved at
     default_config() with the launch counts zeroed just before and read
     just after (every C call at a checked shape, every counter nonzero),
     verified (True) and with a tampered claimed sum (False);
 16. the seconds of each phase, the kernels line (JSON; launches summed
     over every path, and per path; the pool path's are its workers'),
     the card line, and last the result line.
The port imports no JAX; this script imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
# 32-bit integer multiplies per second: the float32 rate of 67 TFLOP/s counts
# an FMA as 2 operations (33.5 T FMA/s); Hopper issues integer multiply-adds
# at half its FP32 FMA rate.
INT_MULS_PER_S = 16.75e12
MULS_PER_MODMUL = 3           # 32x32->64 product, m = lo * NP, m * p
MODMULS_PER_PERM = 772        # Poseidon2-16: 8*16*4 (S-box) + 13*(4 + 16)
MODMULS_PER_PERM24 = 1356     # Poseidon2-24: 8*24*4 (S-box) + 21*(4 + 24)


# the permutation entries' state widths
PERMUTE_WIDTHS = {"p2_permute": 16, "p2_permute24": 24}


def _permute_shape(entry: str):
    return lambda a: f"({a[2]},{PERMUTE_WIDTHS[entry]})"


# C entry point -> (launch counter, or the counter from the scalar
# arguments, and the shape from them)
ENTRY_SHAPES = {
    "ntt_pass": ("ntt_pass", lambda a: f"n={a[4]} W={a[5]} a={a[6]} L={a[7]}"
                 f"{' dit' if a[8] else ''}{'' if a[1] == a[5] else f' ld_x={a[1]}'}"
                 f"{'' if a[3] == a[5] else f' ld_y={a[3]}'}"
                 f"{'' if a[10] is None else ' pre'}{'' if a[11] is None else ' post'}"),
    "p2_permute": ("poseidon2_permute", _permute_shape("p2_permute")),
    "p2_permute24": (lambda a: "poseidon2_permute24" if a[3] else "poseidon2_permute24_general",
                     _permute_shape("p2_permute24")),
    "p2_hash_rows": ("poseidon2_hash_rows", lambda a: f"({a[1]},{a[2]})"),
    "p2_compress": ("poseidon2_compress", lambda a: f"{a[1]} digests, {a[2]} levels"),
    "mont_matmul_rows": ("mont_matmul_rows", lambda a: f"({a[2]},{a[3]}) k={a[4]}"),
    "mont_matmul_cols": ("mont_matmul_cols", lambda a: f"({a[2]},{a[3]})^T k={a[4]}"),
}


def entry_counter(entry: str, args) -> str:
    """The launch counter of a C call (`ENTRY_SHAPES`)."""
    counter = ENTRY_SHAPES[entry][0]
    return counter(args) if callable(counter) else counter


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    return out.splitlines()[0]


def bound_ms(nbytes: float, muls: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = muls / INT_MULS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, reps: int = 3, warmup: bool = True) -> float:
    import torch

    if warmup:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def max_err(a, b) -> int:
    import torch

    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def random_field(gen, shape, device):
    """Residues mod p, uniform, drawn by `gen` on `device`, its own device
    (drawn on the host and copied, the inputs of the 2^25-row shapes took
    most of a shape check's time)."""
    import torch

    from zkvm_prover_tpu_torch.fields import babybear as bb

    return torch.randint(0, bb.P, shape, generator=gen, dtype=bb.DTYPE, device=device)


def check_kernels(log_n: int, width: int, seed: int):
    """Phase 2: each kernel vs its plain version at the main path's shapes."""
    import torch

    from zkvm_prover_tpu_torch.fields import babybear as bb
    from zkvm_prover_tpu_torch.ops import mont_matmul as mm
    from zkvm_prover_tpu_torch.ops import ntt, ntt_fused
    from zkvm_prover_tpu_torch.ops import poseidon2 as p2

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    n, m = 1 << log_n, 2 << log_n
    rows = []

    def record(name, source, replaces, shape, err, ms, plain_ms, nbytes, muls,
               counter=None):
        b_ms, b_by = bound_ms(nbytes, muls)
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "shape": shape, "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None, "bytes": nbytes,
                     "counter": counter or name})
        print(f"  {name:20s} {shape:28s} err={err} ms={ms:.4f} "
              f"plain_ms={plain_ms:.3f} bound_ms={b_ms:.4f} ({b_by})", flush=True)
        if err != 0:
            raise AssertionError(f"{name} disagrees with its plain version")

    src_ntt = "zkvm_prover_tpu_torch/csrc/ntt.cu"
    rep_ntt = "zkvm_prover_tpu/ops/ntt_pallas.py:66"
    sizes = ntt_fused.pass_sizes(log_n)

    def transforms(ln, w):
        """Whole transforms: the LDE's inverse DIF and forward DIT."""
        x = random_field(gen, (1 << ln, w), dev)
        for inverse, dit in ((True, False), (False, True)):
            fn, plain = (ntt_fused.dit, ntt_fused.dit_plain) if dit else \
                (ntt_fused.dif, ntt_fused.dif_plain)
            err = max_err(fn(x, ln, inverse), plain(x, ln, inverse))
            record("ntt_transform", src_ntt, rep_ntt,
                   f"({1 << ln},{w}) {'dit' if dit else 'dif inv'}, "
                   f"{len(ntt_fused.pass_sizes(ln))} passes",
                   err, time_ms(lambda: fn(x, ln, inverse)),
                   time_ms(lambda: plain(x, ln, inverse), reps=1, warmup=False),
                   2 * (1 << ln) * w * 4 + (1 << ln) * 4,
                   ln * (1 << (ln - 1)) * w * MULS_PER_MODMUL, counter="ntt_pass")

    for w in (width, 4):
        transforms(log_n, w)
        x = random_field(gen, (n, w), dev)
        # each pass of the inverse DIF alone
        a = log_n
        for L in sizes:
            a -= L
            err = max_err(ntt_fused.ntt_pass(x, a, L, True),
                          ntt_fused.ntt_pass_plain(x, a, L, True))
            record("ntt_pass", src_ntt, rep_ntt, f"({n},{w}) dif inv a={a} L={L}", err,
                   time_ms(lambda: ntt_fused.ntt_pass(x, a, L, True)),
                   time_ms(lambda: ntt_fused.ntt_pass_plain(x, a, L, True),
                           reps=1, warmup=False),
                   2 * n * w * 4 + (1 << (a + L)) * 4,
                   L * (n // 2) * w * MULS_PER_MODMUL)
        del x

    # the fused LDE as the prover runs it: canonical trace -> c_rev -> 2 cosets
    x = random_field(gen, (n, width), dev)
    shift = bb.GENERATOR

    def lde():
        c = ntt.interpolate_coset_rev(x, 1, canonical=True)
        return ntt.eval_coset_from_rev(c, 1, shift)

    def lde_plain():
        c = bb.mul(ntt_fused.dif_plain(bb.to_monty(x), log_n, True),
                   ntt.n_inv_monty(log_n))
        w_m = bb.two_adic_generator_int(log_n + 1)
        cosets = [ntt_fused.dit_plain(bb.mul(c, ntt.powers_bitrev(
            shift * pow(w_m, r, bb.P) % bb.P, log_n, dev)[:, None]), log_n, False)
                  for r in range(2)]
        return torch.stack(cosets, dim=1).reshape(2 * n, width)

    record("ntt_lde", src_ntt, rep_ntt, f"({n},{width}) -> ({m},{width})",
           max_err(lde(), lde_plain()), time_ms(lde),
           time_ms(lde_plain, reps=1, warmup=False), 4 * n * width * 4 + 3 * n * 4,
           (3 * log_n * (n // 2) + 3 * n) * width * MULS_PER_MODMUL, counter="ntt_pass")
    del x
    # the machine cell's narrow matrices (phase 4): RangeCheckedAir's trace
    # and permutation trace, Poseidon2Air's permutation trace at 2^log_n;
    # RangeTableAir's trace, permutation trace and quotient chunks below
    for ln, w in MACHINE_K1:
        transforms(log_n + ln, w)
    torch.cuda.empty_cache()

    src_p2 = "zkvm_prover_tpu_torch/csrc/poseidon2.cu"
    # the trace, the quotient chunks and the largest FRI codeword; then the
    # machine cell's leaves (matrices of one height side by side)
    for r, c in ((m, width), (m, 8), (n, 4)) + tuple(
            (2 << (log_n + ln), c) for ln, c in MACHINE_LEAVES):
        mat = random_field(gen, (r, c), dev)
        blocks = max(1, -(-c // p2.RATE))
        record("poseidon2_hash_rows", src_p2, "zkvm_prover_tpu/ops/poseidon2.py:225",
               f"({r},{c})", max_err(p2.hash_rows(mat), p2.hash_rows_plain(mat)),
               time_ms(lambda: p2.hash_rows(mat)),
               time_ms(lambda: p2.hash_rows_plain(mat), reps=1, warmup=False),
               r * c * 4 + r * 32, r * blocks * MODMULS_PER_PERM * MULS_PER_MODMUL)
        del mat
    # one level; at 2^(log_n - 1) it is where the machine cell's lower tree joins
    for s_ in (n, n >> 1):
        pairs = random_field(gen, (s_, 16), dev)
        record("poseidon2_compress", src_p2, "zkvm_prover_tpu/ops/poseidon2.py:248",
               f"({s_},16)", max_err(p2.compress16(pairs), p2.permute_plain(pairs)[:, :8]),
               time_ms(lambda: p2.compress16(pairs)),
               time_ms(lambda: p2.permute_plain(pairs)[:, :8], reps=1, warmup=False),
               s_ * 96, s_ * MODMULS_PER_PERM * MULS_PER_MODMUL)
    # every level of a tree over the trace's 2^(log_n+1) leaf digests
    lm = log_n + 1
    leaves = random_field(gen, (m, 8), dev)
    err = max(max_err(a, b) for a, b in zip(p2.compress_levels(leaves, lm),
                                             p2.compress_levels_plain(leaves, lm)))
    record("poseidon2_compress", src_p2, "zkvm_prover_tpu/ops/poseidon2.py:248",
           f"2^{lm} leaves, {lm} levels", err,
           time_ms(lambda: p2.compress_levels(leaves, lm)),
           time_ms(lambda: p2.compress_levels_plain(leaves, lm), reps=1, warmup=False),
           m * 32 + (m - 1) * 32, (m - 1) * MODMULS_PER_PERM * MULS_PER_MODMUL)
    del leaves
    grind_batch = 1 << 18
    states = random_field(gen, (grind_batch, 16), dev)
    record("poseidon2_permute", src_p2, "zkvm_prover_tpu/ops/poseidon2.py:182",
           f"({grind_batch},16)", max_err(p2.permute(states), p2.permute_plain(states)),
           time_ms(lambda: p2.permute(states)),
           time_ms(lambda: p2.permute_plain(states), reps=1, warmup=False),
           grind_batch * 128, grind_batch * MODMULS_PER_PERM * MULS_PER_MODMUL)
    del pairs, states

    # K3 at the proof's calls: the trace's two DEEP sums fused (k = 2) and the
    # quotient chunks' (k = 1); the OOD trace call fused (k = 2) and each
    # quotient chunk's (k = 1); k = 1 at the trace's width for comparison
    src_mm = "zkvm_prover_tpu_torch/csrc/mont_matmul.cu"
    for transpose, r, c, k in ((False, m, width, 2), (False, m, width, 1),
                               (False, m, 8, 1), (True, n, width, 2),
                               (True, n, width, 1), (True, n, 4, 1)) + tuple(
            (t, (1 if t else 2) << (log_n + ln), c, k) for t, ln, c, k in MACHINE_K3):
        a = random_field(gen, (r, c), dev)
        b = random_field(gen, (r if transpose else c, 4 * k), dev)
        name = "mont_matmul_cols" if transpose else "mont_matmul_rows"
        record(name, src_mm, "zkvm_prover_tpu/ops/ntt.py:367" if transpose
               else "zkvm_prover_tpu/stark/prover.py:81",
               f"({r},{c}){'^T' if transpose else ''} k={k}",
               max_err(mm.mont_matmul(a, b, transpose),
                       mm.mont_matmul_plain(a, b, transpose)),
               time_ms(lambda: mm.mont_matmul(a, b, transpose)),
               time_ms(lambda: mm.mont_matmul_plain(a, b, transpose), reps=1,
                       warmup=False),
               r * c * 4 + 16 * k * (r + c), 4 * k * r * c)
        del a, b
    # the accumulator's carry path: every entry p - 1
    for transpose, r, c in ((False, m, width), (True, n, width)):
        a = torch.full((r, c), bb.P - 1, dtype=bb.DTYPE, device=dev)
        b = torch.full((r if transpose else c, 8), bb.P - 1, dtype=bb.DTYPE, device=dev)
        err = max_err(mm.mont_matmul(a, b, transpose), mm.mont_matmul_plain(a, b, transpose))
        print(f"  {'mont_matmul_cols' if transpose else 'mont_matmul_rows':20s} "
              f"({r},{c}) k=2, every entry p-1: err={err}", flush=True)
        if err != 0:
            raise AssertionError("K3 disagrees with its plain version at p - 1")
    del a, b
    torch.cuda.empty_cache()
    return rows


# The machine cell's new shapes, as offsets from log_n (phase 4): Poseidon2Air
# (495 columns, 2 interactions: 12 permutation columns) and RangeCheckedAir
# (1 column, 1 interaction: 8) at 2^log_n rows, RangeTableAir (2 columns, 1
# interaction: 8) at 2^(log_n - 2).
MACHINE_K1 = ((0, 1), (0, 12), (0, 8), (-2, 2), (-2, 8), (-2, 4))   # (rows, W)
MACHINE_LEAVES = ((0, 496), (0, 20), (0, 16), (-2, 2), (-2, 8))     # LDE rows, W
# (transposed, rows, W, k): DEEP sums (rows over the LDE, k = 2 for both
# opened points, k = 1 for the quotient) and OOD openings (transposed, over
# the coefficients)
MACHINE_K3 = ((False, 0, 1, 2), (False, 0, 12, 2), (False, 0, 8, 2),
              (False, -2, 2, 2), (False, -2, 8, 2), (False, -2, 8, 1),
              (True, 0, 1, 2), (True, 0, 12, 2), (True, 0, 8, 2),
              (True, -2, 2, 2), (True, -2, 8, 2), (True, -2, 4, 1))


def launch_counts():
    """The STARK kernels' launches by counter (K1's whole transforms are not
    launches: they are read from `ntt_fused.transforms`; K4's are
    `snark_counts()`, the width-24 permutation's `p2.launches_w24`)."""
    from zkvm_prover_tpu_torch.ops import mont_matmul as mm
    from zkvm_prover_tpu_torch.ops import ntt_fused
    from zkvm_prover_tpu_torch.ops import poseidon2 as p2

    return {**ntt_fused.launches, **p2.launches, **mm.launches}


def _counters():
    from zkvm_prover_tpu_torch.ops import mont_matmul as mm
    from zkvm_prover_tpu_torch.ops import msm, ntt_fused
    from zkvm_prover_tpu_torch.ops import poseidon2 as p2

    return (ntt_fused.launches, ntt_fused.transforms, p2.launches, p2.launches_w24,
            mm.launches, msm.launches)


def reset_counts():
    for d in _counters():
        for key in d:
            d[key] = 0


def counts_snapshot() -> list:
    return [(d, dict(d)) for d in _counters()]


def restore_counts(snapshot) -> None:
    """Set every counter back to its value in `counts_snapshot()`."""
    for d, saved in snapshot:
        d.update(saved)


def log_calls():
    """Log every kernel entry point's C call, (entry, args), in order, into
    the list it yields (`_build.log_calls` over `ENTRY_SHAPES`)."""
    from zkvm_prover_tpu_torch import _build

    return _build.log_calls(ENTRY_SHAPES)


def call_key(entry: str, args) -> tuple:
    """One C call's launch shape and code path (K1: with its row pitches and
    its optional row tables)."""
    return entry, ENTRY_SHAPES[entry][1](args)


# Every kernel shape checked against its plain version so far in this run
# (by `rv32_shapes` key) and the C calls that checked them: a later path
# checks only its new shapes, and its C calls must be among these.
CHECKED = {"shapes": {}, "calls": set()}


def remember_checked(shapes: dict, calls) -> None:
    for key, values in shapes.items():
        CHECKED["shapes"].setdefault(key, set()).update(values)
    CHECKED["calls"].update(call_key(e, a) for e, a in calls)


def new_shapes(shapes: dict) -> dict:
    """The shapes of `shapes` that no earlier check of this run covered."""
    return {key: sorted(set(values) - CHECKED["shapes"].get(key, set()))
            for key, values in shapes.items()}


def unchecked_calls(used, tag: str) -> None:
    """Fail if a C call of `used` is at a shape no check of this run ran."""
    unchecked = sorted(set(call_key(e, a) for e, a in used) - CHECKED["calls"])
    if unchecked:
        raise AssertionError(f"the {tag} path launched unchecked kernel shapes: {unchecked}")


def profile_proof(prove, trace_path: str) -> dict:
    """One proof under torch.profiler (CPU and CUDA activity): device ms and
    launches per kernel and per shape, the device's idle share over the
    proof, and the compress launches of each Merkle tree. Shapes come from
    the kernels' C calls, logged in order and matched one to one with the
    trace's launches of those kernels (one stream, so the orders agree)."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from zkvm_prover_tpu_torch.kernel_report import ENTRY_KERNELS, short_name

    with log_calls() as calls:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function("prove"):
                prove()
                torch.cuda.synchronize()
        prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    win = next(e for e in events if e["name"] == "prove" and e.get("cat") == "user_annotation")
    w0, w1 = win["ts"], win["ts"] + win["dur"]
    dev = sorted((e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")),
                 key=lambda e: e["ts"])
    busy, end = 0.0, w0
    for e in dev:
        a, b = max(e["ts"], end), min(e["ts"] + e["dur"], w1)
        if b > a:
            busy += b - a
        end = max(end, min(e["ts"] + e["dur"], w1))
    ours = set(k for ks in ENTRY_KERNELS.values() for k in ks)
    per_kernel = collections.defaultdict(lambda: [0, 0.0])
    mine = []
    for e in dev:
        name = short_name(e["name"])
        if e["cat"] != "kernel":
            name = e["cat"]
        elif name.split("<")[0] not in ours:
            name = "other kernels (plain torch)"
        else:
            mine.append(e)
        per_kernel[name][0] += 1
        per_kernel[name][1] += e["dur"] / 1e3
    expected = [(entry_counter(entry, args), k, ENTRY_SHAPES[entry][1](args))
                for entry, args in calls for k in ENTRY_KERNELS[entry]]
    per_shape = collections.defaultdict(lambda: [0, 0.0])
    matched = len(expected) == len(mine) and all(
        k in e["name"] for (_, k, _), e in zip(expected, mine))
    if matched:
        for (counter, k, shape), e in zip(expected, mine):
            key = (counter + ("/finish" if k == "mm_cols_finish" else ""), shape)
            per_shape[key][0] += 1
            per_shape[key][1] += e["dur"] / 1e3
    # the LDE: from the proof's start to the first row hash (the trace commit)
    t_hash = next((e["ts"] for e in mine if "hash_rows_kernel" in e["name"]), w1)
    lde = collections.defaultdict(lambda: [0, 0.0])
    for e in dev:
        if w0 <= e["ts"] < t_hash:
            name = short_name(e["name"]) if e["cat"] == "kernel" else e["cat"]
            if e["cat"] == "kernel" and name.split("<")[0] not in ours:
                name = "plain torch: " + e["name"][:60]
            lde[name][0] += 1
            lde[name][1] += e["dur"] / 1e3
    trees = []
    for entry, _ in calls:
        if entry == "p2_hash_rows":
            trees.append(0)
        elif entry == "p2_compress" and trees:
            trees[-1] += 1
    return {"window_ms": (w1 - w0) / 1e3, "device_busy_ms": busy / 1e3,
            "idle_share": 1 - busy / (w1 - w0),
            "per_kernel": {k: {"launches": n, "ms": ms} for k, (n, ms) in
                           sorted(per_kernel.items(), key=lambda kv: -kv[1][1])},
            "shapes_matched": matched,
            "per_shape": [{"kernel": k, "shape": sh, "launches": n, "ms": ms}
                          for (k, sh), (n, ms) in sorted(per_shape.items(),
                                                         key=lambda kv: -kv[1][1])],
            "compress_launches_per_tree": trees,
            "lde_window": {k: {"launches": n, "ms": ms} for k, (n, ms) in lde.items()}}


def poseidon2_trace(log_n: int, seed: int):
    import numpy as np

    from zkvm_prover_tpu_torch.fields import babybear as bb
    from zkvm_prover_tpu_torch.models.poseidon2_air import Poseidon2Air

    rng = np.random.default_rng(seed)
    inputs = rng.integers(0, bb.P, size=(1 << log_n, 16), dtype=np.uint64)
    return Poseidon2Air.generate_trace(inputs.astype(np.uint32),
                                       np.ones(1 << log_n, dtype=np.uint32))


def proofs_equal(a, b, path="proof"):
    """Field-by-field equality of two proofs, `stat` excepted."""
    import numpy as np

    if hasattr(a, "__dataclass_fields__"):
        for f in a.__dataclass_fields__:
            if f != "stat":
                proofs_equal(getattr(a, f), getattr(b, f), f"{path}.{f}")
    elif isinstance(a, dict):
        if sorted(a) != sorted(b):
            raise AssertionError(f"{path}: keys differ")
        for key in a:
            proofs_equal(a[key], b[key], f"{path}[{key}]")
    elif isinstance(a, (list, tuple)):
        if len(a) != len(b):
            raise AssertionError(f"{path}: lengths differ")
        for i, (x, y) in enumerate(zip(a, b)):
            proofs_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        x, y = np.asarray(a), np.asarray(b)
        if x.shape != y.shape or x.dtype != y.dtype or not (x == y).all():
            raise AssertionError(f"{path}: arrays differ")
    elif a != b:
        raise AssertionError(f"{path}: {a!r} != {b!r}")


def machine_instances(trace, log_n: int, seed: int):
    """The machine cell: Poseidon2Air on `trace` with its two bus
    multiplicity columns set to 0 (in place; no AIR that sends on those
    buses is ported), RangeCheckedAir on 2^log_n values from `seed` and
    RangeTableAir at 2^(log_n - 2) rows receiving them."""
    import numpy as np

    from zkvm_prover_tpu_torch.models.lookup import RangeCheckedAir, RangeTableAir
    from zkvm_prover_tpu_torch.models.poseidon2_air import MULT, MULT_FULL, Poseidon2Air
    from zkvm_prover_tpu_torch.stark.machine import AirInstance

    trace[:, MULT] = 0
    trace[:, MULT_FULL] = 0
    log_table = log_n - 2
    values = np.random.default_rng(seed).integers(0, 1 << log_table, size=1 << log_n)
    airs = [Poseidon2Air(), RangeCheckedAir(), RangeTableAir()]
    traces = [trace, airs[1].generate_trace(values),
              airs[2].generate_trace(log_table, values)]
    return airs, [AirInstance(a, t, []) for a, t in zip(airs, traces)]


def machine_cell(trace, log_n: int, seed: int, out_dir: str) -> dict:
    """Phase 4: the machine cell proven, verified, tampered, warm, profiled."""
    import torch

    from zkvm_prover_tpu_torch.stark import machine
    from zkvm_prover_tpu_torch.stark.config import default_config

    cfg = default_config()
    airs, insts = machine_instances(trace, log_n, seed)
    print(f"[4] machine cell: {[(type(a).__name__, i.trace.shape) for a, i in zip(airs, insts)]}",
          flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    proof = machine.prove_machine(insts, cfg)
    torch.cuda.synchronize()
    prove_s = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    phases = {k: v for k, v in proof.stat.items() if k.endswith("_ms")}
    proof_peaks = {k: v for k, v in proof.stat.items() if k.endswith("_peak_bytes")}
    print(f"[4] proved in {prove_s:.3f} s, peak {peak} bytes ({peak / 2**30:.2f} GiB)",
          flush=True)
    for key, val in phases.items():
        print(f"      {key:24s} {val:10.1f} ms, running peak "
              f"{proof.stat[key[:-3] + '_peak_bytes']} bytes")
    print(f"[4] launches: {counts}", flush=True)
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the machine path: {missing}")
    # K3: one rows launch per (AIR, matrix) -- trace, perm, quotient -- and
    # one transposed call per (AIR, matrix or quotient chunk)
    n_mats = sum(2 + (ov.perm_zeta is not None) + (ov.pre_zeta is not None)
                 for ov in proof.opened)
    n_cols = n_mats + len(proof.opened)  # + the second quotient chunk
    k3_rows, k3_cols = counts["mont_matmul_rows"], counts["mont_matmul_cols"] // 2
    print(f"[4] K3: {k3_rows} rows launches (at most {n_mats}), {k3_cols} transposed "
          f"calls (at most {n_cols})", flush=True)
    if k3_rows > n_mats or k3_cols > n_cols:
        raise AssertionError("K3 read a matrix more than once per opened point set")
    t0 = time.perf_counter()
    ok = machine.verify_machine(airs, proof, cfg)
    verify_s = time.perf_counter() - t0
    bad = tampered_claimed_sum(airs, proof)
    tampered = machine.verify_machine(airs, bad, cfg)
    print(f"[4] verify: {ok} in {verify_s:.3f} s; tampered claimed sum: {tampered}",
          flush=True)
    if not ok or tampered:
        raise AssertionError("machine verification phase failed")
    del proof, bad

    t0 = time.perf_counter()
    warm = machine.prove_machine(insts, cfg)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warm_phases = {k: v for k, v in warm.stat.items() if k.endswith("_ms")}
    print(f"[4] warm proof in {warm_s:.3f} s: "
          + ", ".join(f"{k[:-3]} {v:.1f}" for k, v in warm_phases.items()), flush=True)
    del warm
    prof = profile_proof(lambda: machine.prove_machine(insts, cfg),
                         os.path.join(out_dir, "chip_smoke_machine_trace.json"))
    print(f"[4] profiled machine proof: window {prof['window_ms']:.1f} ms, device busy "
          f"{prof['device_busy_ms']:.1f} ms, idle share {prof['idle_share']:.4f}")
    for name, row in prof["per_kernel"].items():
        print(f"      {name:30s} launches {row['launches']:6d}  device ms {row['ms']:9.3f}")
    print(f"[4] per shape (matched to the C calls: {prof['shapes_matched']}):")
    for row in prof["per_shape"]:
        print(f"      {row['kernel']:24s} {row['shape']:26s} launches {row['launches']:4d}"
              f"  device ms {row['ms']:8.3f}")
    print(f"[4] compress launches per Merkle tree: {prof['compress_launches_per_tree']}",
          flush=True)
    torch.cuda.empty_cache()
    return {"prove_s": prove_s, "verify_s": verify_s, "peak_bytes": peak,
            "phases_ms": phases,
            "phase_peak_bytes": proof_peaks, "launches": counts, "k3_rows": k3_rows,
            "k3_cols_calls": k3_cols, "tampered_claimed_sum": tampered,
            "warm_prove_s": warm_s, "warm_phases_ms": warm_phases,
            "profile": {k: v for k, v in prof.items() if k != "lde_window"}}


def small_machine_cuda_equals_cpu(seed: int):
    """Four AIRs at three heights with a logUp bus, at fast_test_config(),
    proven on cuda and on cpu: equal in every field but `stat`."""
    import numpy as np

    from zkvm_prover_tpu_torch.models.doubling import DoublingAir
    from zkvm_prover_tpu_torch.models.fibonacci import FibonacciAir
    from zkvm_prover_tpu_torch.models.lookup import RangeCheckedAir, RangeTableAir
    from zkvm_prover_tpu_torch.stark import machine
    from zkvm_prover_tpu_torch.stark.config import fast_test_config

    values = np.random.default_rng(seed).integers(0, 1 << 6, size=1 << 7)
    fib, dbl = FibonacciAir(), DoublingAir()
    (t_fib, pv_fib), (t_dbl, pv_dbl) = fib.generate_trace(5), dbl.generate_trace(4)
    airs = [RangeTableAir(), RangeCheckedAir(), fib, dbl]
    insts = [machine.AirInstance(airs[0], airs[0].generate_trace(6, values), []),
             machine.AirInstance(airs[1], airs[1].generate_trace(values), []),
             machine.AirInstance(fib, t_fib, pv_fib), machine.AirInstance(dbl, t_dbl, pv_dbl)]
    p_cuda = machine.prove_machine(insts, fast_test_config(), device="cuda")
    p_cpu = machine.prove_machine(insts, fast_test_config(), device="cpu")
    proofs_equal(p_cuda, p_cpu)
    if not machine.verify_machine(airs, p_cuda, fast_test_config()):
        raise AssertionError("the small machine proof does not verify")


RV32_GUEST = (8, 256)          # bench_guest_program(n_outer, n_inner): 24,729 cycles
RV32_DATA_BASE = 0x3000


def rv32_air_traces(n_outer: int, n_inner: int) -> tuple:
    """The benchmark guest executed by the native executor (built first)
    and its traces: (AIR, trace, public values) triples and host timings."""
    from zkvm_prover_tpu_torch.models import rv32_v2
    from zkvm_prover_tpu_torch.vm import executor, guests

    t0 = time.perf_counter()
    executor.build_native()
    build_s = time.perf_counter() - t0
    prog = guests.bench_guest_program(n_outer, n_inner)
    ex = executor.Rv32Executor()
    ex.load_program(prog)
    t0 = time.perf_counter()
    state = ex.run(1 << 18)
    exec_s = time.perf_counter() - t0
    if state != executor.HALTED or ex.exit_code != 0:
        raise AssertionError(f"guest did not halt cleanly: state {state}")
    t0 = time.perf_counter()
    air_traces = rv32_v2.generate_traces(prog, ex.records(), data_base=RV32_DATA_BASE)
    tracegen_s = time.perf_counter() - t0
    return air_traces, {"executor_build_s": build_s, "guest_cycles": ex.cycles,
                        "execution_mhz": ex.cycles / 1e6 / max(exec_s, 1e-9),
                        "tracegen_s": tracegen_s}


def rv32_shapes(air_traces) -> dict:
    """The kernel shapes of an rv32 machine proof, from its AIRs' heights,
    widths, interaction counts and preprocessed widths, grouped as the
    prover groups them (one commitment per LDE height and kind; FRI commits
    every folded codeword below the largest height)."""
    from zkvm_prover_tpu_torch.stark import machine

    ldes, chunks, leaves, k3_rows, k3_cols = set(), set(), {}, set(), set()
    for air, trace, _ in air_traces:
        n, w = (int(v) for v in trace.shape)
        log_n, m = n.bit_length() - 1, 2 * n
        k, pre = machine._structure(air)
        mats = [("trace", w, True)]
        if k:
            mats.append(("perm", 4 * k + 4, False))
        if pre is not None:
            mats.append(("pre", int(pre.shape[1]), True))
        for kind, width, canonical in mats:
            ldes.add((log_n, width, canonical))
            leaves.setdefault((m, kind), 0)
            leaves[(m, kind)] += width
            k3_rows.add((m, width, 2))
            k3_cols.add((n, width, 2))
        chunks.add(log_n)
        leaves[(m, "quotient")] = leaves.get((m, "quotient"), 0) + 8
        k3_rows.add((m, 8, 1))
        k3_cols.add((n, 4, 1))
    log_max = max(lm for lm, _, _ in ldes) + 1
    hash_rows = {(m, c) for (m, _), c in leaves.items()}
    hash_rows |= {(1 << j, 4) for j in range(2, log_max)}      # FRI codewords
    trees = {m for m, _ in hash_rows}
    return {"lde": sorted(ldes), "chunks": sorted(chunks), "hash_rows": sorted(hash_rows),
            "trees": sorted(trees), "k3_rows": sorted(k3_rows), "k3_cols": sorted(k3_cols)}


PLAIN_ELEMS = 1 << 26   # elements a plain version takes at a time (int64 temporaries)


def lde_plain(x, log_n: int, shift: int, canonical: bool, shift_in: int = 1):
    """Plain torch on the card: the prover's LDE (bit-reversed coefficients
    of x on shift_in * H, then its values on the two cosets of shift * G)."""
    import torch

    from zkvm_prover_tpu_torch.fields import babybear as bb
    from zkvm_prover_tpu_torch.ops import ntt, ntt_fused

    n = 1 << log_n
    factor = pow(n, bb.P - 2, bb.P) * (bb.R if canonical else 1) % bb.P
    table = ntt.powers_bitrev(pow(shift_in, bb.P - 2, bb.P), log_n, x.device, factor)
    c = bb.mul(ntt_fused.dif_plain(x.contiguous(), log_n, True), table[:, None])
    w_m = bb.two_adic_generator_int(log_n + 1)
    cosets = [ntt_fused.dit_plain(bb.mul(c, ntt.powers_bitrev(
        shift * pow(w_m, r, bb.P) % bb.P, log_n, x.device)[:, None]), log_n, False)
              for r in range(2)]
    return c, torch.stack(cosets, dim=1).reshape(2 * n, x.shape[1])


def check_rv32_shapes(shapes: dict, seed: int) -> list:
    """Every kernel shape of the rv32 proof against its plain version on the
    card, through the functions the prover calls: K1 as the prover's LDE
    (trace, permutation and preprocessed matrices) and as its quotient
    chunk path (strided input and output), K2 as row hashes and Merkle
    trees, K3 as the DEEP sums (rows) and the OOD openings (transposed)."""
    import torch

    from zkvm_prover_tpu_torch.fields import babybear as bb
    from zkvm_prover_tpu_torch.ops import mont_matmul as mm
    from zkvm_prover_tpu_torch.ops import ntt
    from zkvm_prover_tpu_torch.ops import poseidon2 as p2
    from zkvm_prover_tpu_torch.stark import machine

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    shift = bb.GENERATOR
    rows, clock = [], [time.perf_counter()]

    def record(name, shape, err):
        # `s`: the shape's inputs, kernel, plain version and comparison
        now = time.perf_counter()
        rows.append({"name": name, "shape": shape, "max_abs_err": err, "s": now - clock[0]})
        clock[0] = now
        if err != 0:
            raise AssertionError(f"{name} {shape} disagrees with its plain version")

    for log_n, w, canonical in shapes["lde"]:
        x = random_field(gen, (1 << log_n, w), dev)
        c_rev, lde = machine._lde(x, shift, 1, canonical=canonical)
        err = 0
        # the columns are independent: the plain version takes a few at a
        # time (its int64 temporaries at 2^24 rows)
        step = max(1, PLAIN_ELEMS >> log_n)
        for c0 in range(0, w, step):
            c_p, lde_p = lde_plain(x[:, c0:c0 + step], log_n, shift, canonical)
            err = max(err, max_err(c_rev[:, c0:c0 + step], c_p),
                      max_err(lde[:, c0:c0 + step], lde_p))
        record("ntt_lde", f"({1 << log_n},{w}){' canonical' if canonical else ''}", err)
        del x, c_rev, lde
    for log_n in shapes["chunks"]:
        n = 1 << log_n
        q = random_field(gen, (2 * n, 4), dev)
        out = torch.empty((2 * n, 8), dtype=bb.DTYPE, device=dev)
        out_p = torch.empty_like(out)
        err = 0
        w_m = bb.two_adic_generator_int(log_n + 1)
        for r in range(2):
            s_r = shift * pow(w_m, r, bb.P) % bb.P
            cr = ntt.interpolate_coset_rev(q[r::2], s_r)
            ntt.eval_coset_from_rev(cr, 1, shift, out=out[:, 4 * r:4 * r + 4])
            cr_p, out_p[:, 4 * r:4 * r + 4] = lde_plain(q[r::2], log_n, shift, False, s_r)
            err = max(err, max_err(cr, cr_p))
        record("ntt_quotient_chunks", f"({2 * n},4) -> ({2 * n},8)", max(err, max_err(out, out_p)))
    for r_, c_ in shapes["hash_rows"]:
        mat = random_field(gen, (r_, c_), dev)
        step = max(1, PLAIN_ELEMS // max(c_, 16))  # rows the plain version takes at a time
        out = p2.hash_rows(mat)
        record("poseidon2_hash_rows", f"({r_},{c_})",
               max(max_err(out[r0:r0 + step], p2.hash_rows_plain(mat[r0:r0 + step]))
                   for r0 in range(0, r_, step)))
        del mat, out
    for m in shapes["trees"]:
        leaves = random_field(gen, (m, 8), dev)
        lm = m.bit_length() - 1
        record("poseidon2_compress", f"2^{lm} leaves, {lm} levels",
               max(max_err(a, b) for a, b in zip(p2.compress_levels(leaves, lm),
                                                  p2.compress_levels_plain(leaves, lm))))
    states = random_field(gen, (1 << 18, 16), dev)
    record("poseidon2_permute", "(262144,16)", max_err(p2.permute(states), p2.permute_plain(states)))
    for transpose, key in ((False, "k3_rows"), (True, "k3_cols")):
        for r_, c_, k in shapes[key]:
            a = random_field(gen, (r_, c_), dev)
            b = random_field(gen, (r_ if transpose else c_, 4 * k), dev)
            record("mont_matmul_cols" if transpose else "mont_matmul_rows",
                   f"({r_},{c_}){'^T' if transpose else ''} k={k}",
                   max_err(mm.mont_matmul(a, b, transpose), mm.mont_matmul_plain(a, b, transpose)))
    torch.cuda.empty_cache()
    return rows


def observed_values(proof) -> int:
    """Field elements the out-of-domain openings put into the transcript."""
    import numpy as np

    return sum(int(np.asarray(getattr(ov, name)).size) for ov in proof.opened
               for name in ("trace_zeta", "trace_zeta_next", "quotient", "perm_zeta",
                            "perm_zeta_next", "pre_zeta", "pre_zeta_next")
               if getattr(ov, name) is not None)


def tampered_public_value(airs, proof):
    """A copy of the proof with PublicValuesAir's first public value (a byte
    of a revealed word) changed."""
    bad = copy.deepcopy(proof)
    i = next(j for j, a in enumerate(airs) if type(a).__name__ == "PublicValuesAir")
    log_n, w, pvs = bad.meta[i]
    bad.meta[i] = (log_n, w, [(pvs[0] + 1) % 256] + list(pvs[1:]))
    return bad


def tampered_claimed_sum(airs, proof):
    """A copy of the proof with the first AIR's claimed logUp sum off by 1."""
    bad = copy.deepcopy(proof)
    cs = next(i for i, c in enumerate(bad.claimed_sums) if c is not None)
    bad.claimed_sums[cs] = bad.claimed_sums[cs].copy()
    bad.claimed_sums[cs][0] = (int(bad.claimed_sums[cs][0]) + 1) % 2013265921
    return bad


def checked_machine_proof(tag: str, air_traces, seed: int,
                          tamper=("public value", tampered_public_value)) -> dict:
    """Every kernel shape of the machine's proof that no earlier check of
    the run covered checked against its plain version; then the proof at
    default_config() with the launch counts zeroed just before (cold),
    every C call at a checked shape and every counter nonzero; verify
    (True) and a proof tampered by `tamper` = (what, fn(airs, proof))
    (False)."""
    import torch

    from zkvm_prover_tpu_torch.ops import ntt_fused
    from zkvm_prover_tpu_torch.stark import machine
    from zkvm_prover_tpu_torch.stark.config import default_config

    cfg = default_config()
    airs = [a for a, _, _ in air_traces]
    insts = [machine.AirInstance(a, t, p) for a, t, p in air_traces]
    shapes = rv32_shapes(air_traces)
    t0 = time.perf_counter()
    with log_calls() as checked:
        rows = check_rv32_shapes(new_shapes(shapes), seed)
    check_s = time.perf_counter() - t0
    remember_checked(shapes, checked)
    n_checked = len(set(call_key(e, a) for e, a in checked))
    print(f"[{tag}] {len(rows)} kernel shapes new to the run exact against their plain "
          f"versions ({n_checked} distinct C calls) in {check_s:.1f} s", flush=True)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with log_calls() as used:
        t0 = time.perf_counter()
        proof = machine.prove_machine(insts, cfg)
        torch.cuda.synchronize()
        prove_s = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    unchecked_calls(used, f"[{tag}]")
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the [{tag}] path: {missing}")
    phases = {k: v for k, v in proof.stat.items() if k.endswith("_ms")}
    n_obs = observed_values(proof)
    print(f"[{tag}] proof_wall_s {prove_s:.3f}, peak {peak} bytes ({peak / 2**30:.3f} GiB)",
          flush=True)
    for key, val in phases.items():
        print(f"      {key:24s} {val:10.1f} ms, running peak "
              f"{proof.stat[key[:-3] + '_peak_bytes']} bytes")
    print(f"[{tag}] ood observed {n_obs} values ({-(-n_obs // 8)} duplexes)")
    print(f"[{tag}] launches: {counts}; K1 transforms {dict(ntt_fused.transforms)}", flush=True)
    t0 = time.perf_counter()
    ok = machine.verify_machine(airs, proof, cfg)
    verify_s = time.perf_counter() - t0
    what, forge = tamper
    t0 = time.perf_counter()
    tampered = machine.verify_machine(airs, forge(airs, proof), cfg)
    tampered_s = time.perf_counter() - t0
    print(f"[{tag}] verify_wall_s {verify_s:.3f}: {ok}; tampered {what}: {tampered} "
          f"in {tampered_s:.3f} s", flush=True)
    if not ok or tampered:
        raise AssertionError(f"[{tag}] verification phase failed")
    del proof
    torch.cuda.empty_cache()
    return {"proof_wall_s": prove_s, "verify_wall_s": verify_s, "shape_checks": rows,
            "shape_check_s": check_s, "checked_calls": n_checked, "peak_bytes": peak,
            "phases_ms": phases, "ood_observed_values": n_obs, "launches": counts,
            "tamper": what, "tampered": tampered, "tampered_verify_s": tampered_s}


def print_airs(air_traces) -> int:
    """Each AIR's height, width and public values; returns the cells."""
    for a, t, p in air_traces:
        print(f"      {type(a).__name__:20s} {str(t.shape):14s} pvs {len(p)}")
    return sum(int(t.size) for _, t, _ in air_traces)


def rv32_cell(seed: int) -> dict:
    """Phase 6: the rv32 machine path. The executor built, the benchmark
    guest run and traced; every kernel shape of its proof checked against
    its plain version; then the proof at default_config() with the launch
    counts zeroed just before (cold), verify (True) and a tampered public
    value (False)."""
    air_traces, info = rv32_air_traces(*RV32_GUEST)
    print(f"[6] rv32 guest {RV32_GUEST}: {info['guest_cycles']} cycles, executor built in "
          f"{info['executor_build_s']:.2f} s, traces in {info['tracegen_s']:.2f} s: "
          f"{len(air_traces)} AIRs", flush=True)
    cells = print_airs(air_traces)
    print(f"[6] {cells} cells", flush=True)
    out = checked_machine_proof("6", air_traces, seed)
    prove_s = out["proof_wall_s"]
    bench_names = {"guest_cycles": info["guest_cycles"], "tracegen_s": info["tracegen_s"],
                   "proof_wall_s": prove_s, "verify_wall_s": out["verify_wall_s"],
                   "proving_khz": info["guest_cycles"] / 1e3 / prove_s}
    print(f"[6] {json.dumps(bench_names)}", flush=True)
    return {**info, **out, **bench_names,
            "airs": [[type(a).__name__, list(t.shape), len(p)] for a, t, p in air_traces],
            "trace_cells": cells,
            "public_values": next([int(v) for v in p] for a, _, p in air_traces
                                  if type(a).__name__ == "PublicValuesAir")}


# phase 9's ECDSA scalars: 64 bits, not 256, for the script's time (every
# syscall family still runs; ~126 ec_double and ~61 ec_add, not ~510 and ~241)
ECDSA_SCALAR_BITS = 64


def ecdsa_cell(seed: int, scalar_bits: int = ECDSA_SCALAR_BITS) -> dict:
    """Phase 9: the ext guest, one secp256k1 ECDSA verification (key,
    digest and nonce from `seed`, scalars of `scalar_bits` bits; modop DIV
    and MUL mod n, about 2 ec_double and 1 ec_add a bit) and then keccak of
    Q, sha256 of 150 bytes, fp2 MUL / ADD / SUB over BN254 Fq and two defer
    calls: every extension syscall family. Executed and traced; x(R) mod
    n == r, the keccak and sha256 digests in RAM and DeferralVmAir's public
    values against the host; then the checked proof at default_config()."""
    import hashlib

    from zkvm_prover_tpu_torch.models import rv32_v2
    from zkvm_prover_tpu_torch.models.deferral_vm import DeferralVmAir, chain_digest_from_leaves
    from zkvm_prover_tpu_torch.ops.keccak import keccak256
    from zkvm_prover_tpu_torch.vm import executor, guests

    executor.build_native()
    words, info = guests.ecdsa_verify_program(seed, scalar_bits=scalar_bits)
    ex = executor.Rv32Executor()
    ex.load_program(words)
    if ex.run(1 << 20) != executor.HALTED or ex.exit_code != 0:
        raise AssertionError(f"the ECDSA guest did not halt cleanly (exit code {ex.exit_code})")
    t0 = time.perf_counter()
    air_traces = rv32_v2.generate_traces(words, ex.records(), data_base=guests.ECDSA_BASE)
    tracegen_s = time.perf_counter() - t0
    x_r = sum(w << (32 * i) for i, w in enumerate(ex.public_values()))
    a = info["addr"]

    def ram(addr, n_words):
        return b"".join(ex.load_mem32(addr + 4 * i).to_bytes(4, "little") for i in range(n_words))

    q_bytes = b"".join(v.to_bytes(32, "little") for v in info["Q"])
    defer_pvs = next(p for air, _, p in air_traces if isinstance(air, DeferralVmAir))
    checks = {
        "x(R) mod n == r": x_r % guests.SECP256K1_N == info["r"],
        "keccak(Q) in RAM": ram(a["keccak"], 8) == keccak256(q_bytes),
        "sha256(msg) in RAM": ram(a["sha"], 8) == hashlib.sha256(info["msg"]).digest(),
        "deferral digest": ([int(v) for v in defer_pvs]
                            == [int(v) for v in chain_digest_from_leaves(info["leaves"])]),
    }
    print(f"[9] ECDSA guest (seed {seed}, {scalar_bits}-bit scalars): {ex.cycles} cycles, "
          f"{len(words)} words, {info['ec_doubles']} ec_double, {info['ec_adds']} ec_add; "
          f"traces in "
          f"{tracegen_s:.2f} s: {len(air_traces)} AIRs", flush=True)
    cells = print_airs(air_traces)
    print(f"[9] {cells} cells; {checks}", flush=True)
    if not all(checks.values()):
        raise AssertionError(f"the ECDSA guest's results are wrong: {checks}")
    out = checked_machine_proof("9", air_traces, seed)
    names = {"guest_cycles": ex.cycles, "tracegen_s": tracegen_s,
             "proof_wall_s": out["proof_wall_s"], "verify_wall_s": out["verify_wall_s"]}
    print(f"[9] {json.dumps(names)}", flush=True)
    return {**out, **names, "checks": checks, "trace_cells": cells,
            "airs": [[type(a).__name__, list(t.shape), len(p)] for a, t, p in air_traces]}


def fibonacci_envelope_cuda_equals_cpu():
    """The fibonacci app's envelope (log_n 4, fast_test_config()) from
    `Prover.gen_proof_stark` on cuda and on cpu: equal but for `stat`."""
    from zkvm_prover_tpu_torch.host import Prover, ProverConfig, ProvingTask
    from zkvm_prover_tpu_torch.stark.config import fast_test_config

    task = ProvingTask(serialized_witness=[json.dumps({"log_n": 4, "x0": 1, "x1": 1}).encode()])
    cuda, cpu = (Prover(ProverConfig("fibonacci", stark=fast_test_config(), device=d))
                 .gen_proof_stark(task) for d in ("cuda", "cpu"))
    for name in ("proof", "user_pvs_proof", "baseline", "deferral_merkle_proofs"):
        if getattr(cuda, name) != getattr(cpu, name):
            raise AssertionError(f"fibonacci envelopes differ in {name}")


@contextlib.contextmanager
def timed_calls(owner, name: str, describe=None, keep: bool = False):
    """Time every call of `owner.name` (a module's function or a class's
    static or class method) while the block runs: the list it yields holds each
    call's seconds, its result where that is a bool (any result under "out"
    with `keep`), and what `describe(args, kwargs)` adds."""
    original = owner.__dict__[name]
    kind = type(original) if isinstance(original, (staticmethod, classmethod)) else None
    fn = original.__func__ if kind else original
    calls = []

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        calls.append({"s": time.perf_counter() - t0,
                      "result": out if isinstance(out, bool) else None,
                      **({"out": out} if keep else {}),
                      **(describe(args, kwargs) if describe else {})})
        return out

    setattr(owner, name, kind(timed) if kind else timed)
    try:
        yield calls
    finally:
        setattr(owner, name, original)


def timed_verifications():
    """`timed_calls` on `UniversalVerifier.verify_stark_proof_with_vk`: a
    prover's host child verifications and its self-verify, each with the
    app its vk names."""
    from zkvm_prover_tpu_torch.host.app import app_for_vk
    from zkvm_prover_tpu_torch.host.verifier import UniversalVerifier

    def app_named(args, kwargs):
        app = kwargs.get("app", args[3] if len(args) > 3 else None) or app_for_vk(args[0])
        return {"app": app.name if app else None}

    return timed_calls(UniversalVerifier, "verify_stark_proof_with_vk", app_named)


def executed_machine(tag: str, name: str, prover, task) -> list:
    """The app's machine for `task`: (AIR, trace, public values) triples."""
    instances, _ = prover.app.execute(task)
    air_traces = [(i.air, i.trace, i.public_values) for i in instances]
    cells = sum(int(t.size) for _, t, _ in air_traces)
    print(f"[{tag}] {name}: {len(air_traces)} AIRs, {cells} cells", flush=True)
    for a, t, p in air_traces:
        print(f"      {type(a).__name__:20s} {str(t.shape):14s} pvs {len(p)}")
    return air_traces


def checked_shapes(tag: str, name: str, shapes: dict, seed: int) -> list:
    """`check_rv32_shapes`, its shapes and C calls remembered in CHECKED."""
    with log_calls() as calls:
        rows = check_rv32_shapes(shapes, seed)
    remember_checked(shapes, calls)
    print(f"[{tag}] {len(rows)} {name} kernel shapes exact against their plain versions "
          f"({len(set(call_key(e, a) for e, a in calls))} distinct C calls)", flush=True)
    return rows


def prove_task(tag: str, prover, task) -> tuple:
    """One `Prover.gen_proof_stark` of `task` (execute, host child
    verification, prove on the card, self-verify) with the launch counts
    zeroed just before and read just after; every C call at a shape that a
    check of this run covered, every counter nonzero. Returns (envelope,
    measurements)."""
    import torch

    from zkvm_prover_tpu_torch.host import serialization

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with log_calls() as used, timed_verifications() as verifications:
        t0 = time.perf_counter()
        env = prover.gen_proof_stark(task)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    unchecked_calls(used, prover.app.name)
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the {prover.app.name} path: {missing}")
    *children, self_check = verifications
    if len(children) != len(task.aggregated_proofs) or not all(
            c["result"] for c in verifications) or self_check["app"] != prover.app.name:
        raise AssertionError(f"unexpected verifications in the {prover.app.name} proof: "
                             f"{verifications}")
    exec_ms, prove_ms = env.stat.execution_time_mills, env.stat.proving_time_mills
    env_bytes = len(json.dumps(env.to_dict()))
    n_obs = observed_values(serialization.decode_machine_proof(env.proof))
    child_text = "".join(f", child {c['app']} verified: {c['result']} in {c['s'] * 1e3:.0f} ms"
                         for c in children)
    print(f"[{tag}] {prover.app.name} gen_proof_stark {wall_s:.3f} s: execute {exec_ms} ms"
          f"{child_text}, prove {prove_ms} ms, self-verify {self_check['s'] * 1e3:.0f} ms; "
          f"peak {peak} bytes; envelope {env_bytes} bytes of JSON ({len(env.proof)} proof "
          f"bytes); ood observed {n_obs} values", flush=True)
    print(f"[{tag}] launches: {counts}", flush=True)
    return env, {"gen_proof_stark_s": wall_s, "execute_ms": exec_ms, "prove_ms": prove_ms,
                 "child_verifications": children, "self_verify_ms": self_check["s"] * 1e3,
                 "peak_bytes": peak, "envelope_json_bytes": env_bytes,
                 "proof_bytes": len(env.proof), "ood_observed_values": n_obs,
                 "launches": counts}


def tampered_envelope(verifier, env) -> tuple:
    """The verifier's answer on `env` with one `user_pvs_proof` byte
    flipped, and its seconds."""
    from zkvm_prover_tpu_torch.host import StarkProof

    bad = StarkProof.from_dict(env.to_dict())
    bad.user_pvs_proof = bytes([bad.user_pvs_proof[0] ^ 1]) + bad.user_pvs_proof[1:]
    t0 = time.perf_counter()
    return verifier.verify_stark_proof(bad), time.perf_counter() - t0


def answered_from_cache(tag: str, prover, task, env) -> float:
    """A second call for `task`: no launch and the same envelope."""
    reset_counts()
    t0 = time.perf_counter()
    cached = prover.gen_proof_stark(task)
    cached_s = time.perf_counter() - t0
    launches = sum(launch_counts().values())
    print(f"[{tag}] second {prover.app.name} call from the cache in {cached_s:.3f} s, "
          f"{launches} launches, equal envelope: {cached.to_dict() == env.to_dict()}",
          flush=True)
    if launches or cached.to_dict() != env.to_dict():
        raise AssertionError(f"the second {prover.app.name} call was not answered from the cache")
    return cached_s


# phases 7, 8, 12 and 13 (the chunk -> batch -> bundle chain, its SNARK wrap
# and the re-executed chunk) prove at default_config() with 25 FRI queries,
# not 100: phase 8's batch verifies chunk 0's proof in-circuit, and that wire
# program grows with the child's queries (8,605,046 ALU rows in use, 2^24
# rows, at 100). Every other path keeps 100, and phase 10's discharge node
# still verifies two 100-query children in-circuit.
CHAIN_QUERIES = 25


def chain_config():
    """default_config() with CHAIN_QUERIES FRI queries."""
    import dataclasses

    from zkvm_prover_tpu_torch.stark.config import default_config

    cfg = default_config()
    return dataclasses.replace(cfg, fri=dataclasses.replace(cfg.fri, num_queries=CHAIN_QUERIES))


def chunk_cell(seed: int):
    """Phase 7: the host entry point. Chunk 0 of ChunkTaskGenerator at
    chain_config(): its kernel shapes checked first, then one
    `Prover.gen_proof_stark` on a fresh cache (execute, prove on the card,
    self-verify) with the launch counts zeroed just before, a tampered PI
    hash, and a second call that the cache answers. Returns (report,
    generator); the generator holds the envelope, after a JSON round trip,
    as its chunk 0 proof, which phase 8's batch verifies in-circuit."""
    import shutil

    import torch

    from zkvm_prover_tpu_torch.host import StarkProof, UniversalVerifier
    from zkvm_prover_tpu_torch.integration import ChunkTaskGenerator

    cfg = chain_config()
    run_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_chunk")
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    os.environ["OUTPUT_DIR"] = run_dir
    gen = ChunkTaskGenerator(stark=cfg)
    task = gen.task(0)
    air_traces = executed_machine("7", f"chunk 0 ({gen.blocks_per_chunk} blocks)",
                                  gen.prover, task)
    rows = checked_shapes("7", "chunk", new_shapes(rv32_shapes(air_traces)), seed)
    env, measured = prove_task("7", gen.prover, task)
    tampered, tampered_s = tampered_envelope(UniversalVerifier("chunk", cfg), env)
    print(f"[7] flipped user_pvs_proof byte: {tampered} in {tampered_s:.3f} s", flush=True)
    if tampered:
        raise AssertionError("the chunk verifier accepted a tampered envelope")
    cached_s = answered_from_cache("7", gen.prover, task, env)
    torch.cuda.empty_cache()
    # phase 8's batch takes this proof as its child (memoized here, so the
    # generator does not prove it again)
    gen._proofs[0] = StarkProof.from_dict(json.loads(json.dumps(env.to_dict())))
    return {"airs": [[type(a).__name__, list(t.shape), len(p)] for a, t, p in air_traces],
            "trace_cells": sum(int(t.size) for _, t, _ in air_traces), "shape_checks": rows,
            **measured, "tampered_pi_hash": tampered, "tampered_verify_s": tampered_s,
            "cached_s": cached_s}, gen


def tampered_kzg_task(task, how: str):
    """The batch task with its KZG opening proof changed: one byte of y
    flipped (the point leaves the curve) or y replaced by Q - y (the
    negated point: on the curve, so the pairing check decides)."""
    import pickle

    from zkvm_prover_tpu_torch.fields import bls12_381 as bls
    from zkvm_prover_tpu_torch.host import ProvingTask
    from zkvm_prover_tpu_torch.host.scroll_apps import load_witness

    inner, children = load_witness(task.serialized_witness[0])
    pe = inner.point_eval_witness
    if how == "flipped byte":
        pe.kzg_proof_y = pe.kzg_proof_y[:-1] + bytes([pe.kzg_proof_y[-1] ^ 1])
    else:
        pe.kzg_proof_y = (bls.Q - int.from_bytes(pe.kzg_proof_y, "big")).to_bytes(48, "big")
    return ProvingTask(serialized_witness=[pickle.dumps((inner, children))],
                       aggregated_proofs=task.aggregated_proofs, fork_name=task.fork_name,
                       identifier=None, vk=task.vk)


@contextlib.contextmanager
def in_circuit_probes(used: list, seed: int):
    """Observe a prover's in-circuit child verification while the block
    runs, into the dict it yields: each `compute_pre_roots` call (device ms,
    ending in a synchronize), each wire program build (host s, the wire
    AIRs' rows and the ALU rows in use: the prover's build with the real
    oracle, then the self-verify's rebuild with the dummy one), and each
    `prove_machine`, which first checks the kernel shapes of the machine it
    is given that no earlier check of the run covered against their plain
    versions (`rv32_shapes`, `new_shapes`; the check's launches are taken
    back out of the counters, its C calls out of `used`, and the peak
    memory statistic is reset after it) and keeps the proof's own
    wall-clock, phase split, peak and AIRs."""
    import torch

    from zkvm_prover_tpu_torch.host import prover as host_prover
    from zkvm_prover_tpu_torch.recursion import aggregation
    from zkvm_prover_tpu_torch.recursion.wire_air import N_OPS, WireAluAir
    from zkvm_prover_tpu_torch.stark import machine

    probes = {"pre_roots_ms": [], "builds": [], "proofs": [], "shape_checks": [],
              "shape_check_s": 0.0}
    originals = (aggregation.compute_pre_roots, host_prover.build_child_verification,
                 aggregation.build_child_verification, machine.prove_machine)

    def pre_roots(airs, shape, device=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = originals[0](airs, shape, device)
        torch.cuda.synchronize()
        probes["pre_roots_ms"].append((time.perf_counter() - t0) * 1e3)
        return out

    def timed_build(original):
        def build(tag, slots, oracles):
            t0 = time.perf_counter()
            insts = original(tag, slots, oracles)
            build_s = time.perf_counter() - t0
            prog = next(i.air.program for i in insts if isinstance(i.air, WireAluAir))
            probes["builds"].append({
                "oracle": type(oracles[0]).__name__, "s": build_s,
                "alu_rows_used": int(prog[:, :N_OPS].any(axis=1).sum()),
                "rows": {type(i.air).__name__: int(i.trace.shape[0]) for i in insts}})
            return insts
        return build

    def prove(instances, config=None, device=None):
        air_traces = [(i.air, i.trace, i.public_values) for i in instances]
        snapshot, n0 = counts_snapshot(), len(used)
        t0 = time.perf_counter()
        shapes = rv32_shapes(air_traces)
        probes["shape_checks"] += check_rv32_shapes(new_shapes(shapes), seed)
        probes["shape_check_s"] += time.perf_counter() - t0
        remember_checked(shapes, used[n0:])
        del used[n0:]
        restore_counts(snapshot)
        probes["airs"] = [[type(a).__name__, list(t.shape), len(p)] for a, t, p in air_traces]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        proof = originals[3](instances, config, device)
        torch.cuda.synchronize()
        probes["proofs"].append({"s": time.perf_counter() - t0, "stat": dict(proof.stat),
                                 "peak_bytes": torch.cuda.max_memory_allocated(),
                                 "airs": probes["airs"]})
        return proof

    aggregation.compute_pre_roots = pre_roots
    host_prover.build_child_verification = timed_build(originals[1])
    aggregation.build_child_verification = timed_build(originals[2])
    machine.prove_machine = prove
    try:
        yield probes
    finally:
        (aggregation.compute_pre_roots, host_prover.build_child_verification,
         aggregation.build_child_verification, machine.prove_machine) = originals


def batch_in_circuit(prover, task, seed: int) -> tuple:
    """One `Prover.gen_proof_stark` of the batch task with the child verified
    in-circuit: the launch counts zeroed just before and read just after;
    the machine's kernel shapes (the batch's 18 AIRs and the wire AIRs)
    that no earlier check of the run covered checked against their plain
    versions just before its proof; every C call of the path at a checked
    shape (the child's preprocessed commitments at shapes phase 7 checked)
    and every counter nonzero. Returns (envelope, measurements)."""
    import torch

    from zkvm_prover_tpu_torch.host import serialization

    torch.cuda.synchronize()
    reset_counts()
    with log_calls() as used, timed_verifications() as verifications, \
            in_circuit_probes(used, seed) as probes:
        t0 = time.perf_counter()
        env = prover.gen_proof_stark(task)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    # the entry point's own time: the wall-clock less the shape check that
    # the probe runs inside it
    entry_s = wall_s - probes["shape_check_s"]
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    builds = probes["builds"]
    proof = probes["proofs"][0]
    n_obs = observed_values(serialization.decode_machine_proof(env.proof))
    rows = builds[0]["rows"]
    card = card_line()
    print(f"[8] in-circuit batch ({card}): wire rows {rows}, ALU rows in use "
          f"{builds[0]['alu_rows_used']}", flush=True)
    print(f"[8] gen_proof_stark {entry_s:.3f} s (the wall-clock {wall_s:.3f} s less the "
          f"shape check): execute {env.stat.execution_time_mills} ms; compute_pre_roots "
          f"{[round(t, 1) for t in probes['pre_roots_ms']]} ms; wire build "
          f"(real oracle) {builds[0]['s']:.3f} s; shape check (not the entry point's) "
          f"{probes['shape_check_s']:.3f} s "
          f"({len(probes['shape_checks'])} shapes); prove {proof['s'] * 1e3:.0f} ms; self-verify "
          f"{verifications[0]['s']:.3f} s, of which the rebuild (dummy oracle) "
          f"{builds[1]['s']:.3f} s; peak over prove and self-verify {peak} bytes; "
          f"{len(env.proof)} proof bytes; ood observed {n_obs} values", flush=True)
    for key, val in proof["stat"].items():
        if key.endswith("_ms"):
            print(f"      {key:24s} {val:10.1f} ms, running peak "
                  f"{proof['stat'].get(key[:-3] + '_peak_bytes')} bytes")
    print(f"[8] launches: {counts}", flush=True)
    unchecked_calls(used, "in-circuit batch")
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the in-circuit batch path: {missing}")
    if ([b["oracle"] for b in builds] != ["RealOracle", "DummyOracle"]
            or builds[0]["rows"] != builds[1]["rows"] or len(probes["proofs"]) != 1
            or [(v["app"], v["result"]) for v in verifications] != [("batch", True)]
            or len(env.agg_children) != 1):
        raise AssertionError(f"unexpected in-circuit batch path: builds {builds}, "
                             f"verifications {verifications}")
    return env, {"card": card, "gen_proof_stark_s": entry_s,
                 "wall_s_with_shape_check": wall_s,
                 "execute_ms": env.stat.execution_time_mills,
                 "pre_roots_ms": probes["pre_roots_ms"], "wire_builds": builds,
                 "shape_check_s": probes["shape_check_s"], "shape_checks": probes["shape_checks"],
                 "airs": probes["airs"], "prove_ms": proof["s"] * 1e3,
                 "phases_ms": {k: v for k, v in proof["stat"].items() if k.endswith("_ms")},
                 "self_verify_s": verifications[0]["s"], "peak_bytes": peak,
                 "proof_bytes": len(env.proof), "ood_observed_values": n_obs,
                 "launches": counts}


def chain_cell(chunks, seed: int) -> dict:
    """Phase 8: the batch and bundle layers over phase 7's chunk 0 proof.
    The batch through `Prover(ProverConfig("batch", stark=chain_config()))`
    with its default in-circuit child verification, over BatchTaskGenerator's
    task 0 (1 chunk a batch): the wire verifier of chunk 0 built, proven
    beside the batch on the card and rebuilt by the self-verify; its
    envelope through `UniversalVerifier` (True) and with a forged child
    record (False). Then BundleTaskGenerator (1 batch a bundle, children
    verified on the host: the batch's check goes through the verifier's
    in-circuit branch), its envelope through `UniversalVerifier` (True) and
    with a flipped PI byte (False); a batch task with a tampered KZG proof
    raises in execute with no launch; a second bundle call answered from
    the cache. Returns (report, bundle generator, bundle task): phase 12
    wraps that bundle."""
    import torch

    from zkvm_prover_tpu_torch.fields import babybear as bb
    from zkvm_prover_tpu_torch.host import Prover, ProverConfig, StarkProof, UniversalVerifier
    from zkvm_prover_tpu_torch.integration import BatchTaskGenerator, BundleTaskGenerator

    cfg = chunks.stark
    batches = BatchTaskGenerator(chunks=chunks, chunks_per_batch=1)
    bundles = BundleTaskGenerator(batches=batches, batches_per_bundle=1)
    prover = Prover(ProverConfig("batch", stark=cfg))
    report = {}

    task = batches.task(0)
    env, measured = batch_in_circuit(prover, task, seed)
    batches.add_proof(0, task, env)
    report["batch"] = measured

    verifier = UniversalVerifier("batch", cfg)
    carried = StarkProof.from_dict(json.loads(json.dumps(env.to_dict())))
    t0 = time.perf_counter()
    ok = verifier.verify_stark_proof(carried)
    verify_s = time.perf_counter() - t0
    forged = StarkProof.from_dict(carried.to_dict())
    forged.agg_children[0].pvs[0] = (forged.agg_children[0].pvs[0] + 1) % bb.P
    t0 = time.perf_counter()
    forged_ok = verifier.verify_stark_proof(forged)
    forged_s = time.perf_counter() - t0
    print(f"[8] batch UniversalVerifier: {ok} in {verify_s:.3f} s; forged child record: "
          f"{forged_ok} in {forged_s:.3f} s", flush=True)
    if not ok or forged_ok:
        raise AssertionError("batch verification phase failed")
    report.update(batch_verify_s=verify_s, forged_child_record=forged_ok,
                  forged_verify_s=forged_s)

    bundle_task = bundles.task()
    air_traces = executed_machine("8", "the bundle (1 batch)", bundles.prover, bundle_task)
    new = new_shapes(rv32_shapes(air_traces))
    rows = []
    if any(new.values()):
        rows = checked_shapes("8", "new bundle", new, seed + 1)
    bundle_env, measured = prove_task("8", bundles.prover, bundle_task)
    report["bundle"] = {"airs": [[type(a).__name__, list(t.shape), len(p)]
                                 for a, t, p in air_traces],
                        "trace_cells": sum(int(t.size) for _, t, _ in air_traces),
                        "new_shape_checks": rows, **measured}

    verifier = UniversalVerifier("bundle", cfg)
    t0 = time.perf_counter()
    ok = verifier.verify_stark_proof(
        StarkProof.from_dict(json.loads(json.dumps(bundle_env.to_dict()))))
    verify_s = time.perf_counter() - t0
    tampered, tampered_s = tampered_envelope(verifier, bundle_env)
    print(f"[8] bundle UniversalVerifier: {ok} in {verify_s:.3f} s; flipped user_pvs_proof "
          f"byte: {tampered} in {tampered_s:.3f} s", flush=True)
    if not ok or tampered:
        raise AssertionError("bundle verification phase failed")
    report.update(bundle_verify_s=verify_s, tampered_pi_hash=tampered,
                  tampered_verify_s=tampered_s)

    expected = {"flipped byte": "not a BLS12-381 G1 point",
                "negated point": "verify_kzg_proof fail"}
    for how, message in expected.items():
        reset_counts()
        t0 = time.perf_counter()
        raised = None
        try:
            prover.gen_proof_stark(tampered_kzg_task(task, how))
        except AssertionError as e:
            raised = str(e)
        launches = sum(launch_counts().values())
        print(f"[8] batch task with its KZG proof's y {how}: raised {raised!r} in "
              f"{time.perf_counter() - t0:.3f} s, {launches} launches", flush=True)
        if raised is None or message not in raised or launches:
            raise AssertionError(f"a KZG proof with y {how} was not rejected in execute")
        report[f"tampered_kzg_{how.replace(' ', '_')}"] = raised
    report["cached_s"] = answered_from_cache("8", bundles.prover, bundle_task, bundle_env)
    torch.cuda.empty_cache()
    return report, bundles, bundle_task


# each fibonacci child of phase 10: log_n 3, not the reference test's 5, for
# the script's time (the discharge's WireAluAir 2^19 rows, not 2^20)
DEFER_CHILD_WITNESS = b'{"log_n": 3}'


def deferred_cell(seed: int) -> dict:
    """Phase 10: deferred aggregation. Two fibonacci children
    (`DEFER_CHILD_WITNESS`) from
    `Prover.gen_proof_stark` at default_config(); then
    `DeferredProver(default_config()).prove(children)` with the launch
    counts zeroed just before and read just after: the deferred-agg guest
    executed (it defers each child and reveals keccak of the leaves), its
    20-AIR machine proven, the discharge leaf node (the wire verifier of
    both children) built and proven, and the envelope self-verified (the
    node rebuilt); each proof's new kernel shapes checked against their
    plain versions just before it (the check's launches taken back out),
    every C call at a checked shape, every counter nonzero. Then
    `UniversalVerifier` with the deferred-agg vk (True), a child record's
    public value flipped (False) and a byte of the discharge flipped
    (False)."""
    import torch

    from zkvm_prover_tpu_torch.host import (DeferredAggApp, DeferredProver, Prover,
                                            ProverConfig, ProvingTask, StarkProof,
                                            UniversalVerifier)
    from zkvm_prover_tpu_torch.host import deferred
    from zkvm_prover_tpu_torch.stark.config import default_config

    cfg = default_config()
    children_prover = Prover(ProverConfig("fibonacci", stark=cfg))
    torch.cuda.synchronize()
    with log_calls() as used, in_circuit_probes(used, seed) as probes:
        t0 = time.perf_counter()
        children = [children_prover.gen_proof_stark(ProvingTask(
            identifier=f"defer-child-{i}", serialized_witness=[DEFER_CHILD_WITNESS]))
            for i in range(2)]
        children_s = time.perf_counter() - t0 - probes["shape_check_s"]
    unchecked_calls(used, "fibonacci child")
    print(f"[10] two fibonacci children ({DEFER_CHILD_WITNESS.decode()}) in {children_s:.3f} s "
          f"(less {probes['shape_check_s']:.1f} s of shape checks)", flush=True)

    prover = DeferredProver(cfg)
    torch.cuda.synchronize()
    reset_counts()
    with log_calls() as used, in_circuit_probes(used, seed) as probes, \
            timed_calls(deferred, "verify_deferred") as self_checks:
        t0 = time.perf_counter()
        env = prover.prove(children, identifier="chip-smoke-deferred")
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    entry_s = wall_s - probes["shape_check_s"]
    counts = launch_counts()
    peak = max(p["peak_bytes"] for p in probes["proofs"])
    unchecked_calls(used, "deferred aggregation")
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the deferred path: {missing}")
    builds = probes["builds"]
    if (len(probes["proofs"]) != 2 or [b["oracle"] for b in builds]
            != ["DummyOracle", "RealOracle", "DummyOracle"]
            or [c["result"] for c in self_checks] != [True]):
        raise AssertionError(f"unexpected deferred path: builds {builds}, "
                             f"self-verify {self_checks}")
    parent, discharge = probes["proofs"]
    card = card_line()
    print(f"[10] deferred parent ({card}): {len(parent['airs'])} AIRs, heights "
          f"{[a[1][0] for a in parent['airs']]}", flush=True)
    print(f"[10] discharge node: wire rows {builds[1]['rows']}, ALU rows in use "
          f"{builds[1]['alu_rows_used']}", flush=True)
    print(f"[10] DeferredProver.prove {entry_s:.3f} s (the wall-clock {wall_s:.3f} s less "
          f"{probes['shape_check_s']:.3f} s of shape checks, {len(probes['shape_checks'])} "
          f"new shapes): execute {env.stat.execution_time_mills} ms; parent prove "
          f"{parent['s'] * 1e3:.0f} ms; compute_pre_roots "
          f"{[round(t, 1) for t in probes['pre_roots_ms']]} ms; builds (dummy, real, dummy) "
          f"{[round(b['s'], 3) for b in builds]} s; discharge prove {discharge['s'] * 1e3:.0f} "
          f"ms; self-verify {self_checks[0]['s']:.3f} s; peak {peak} bytes", flush=True)
    for tag, proof in (("parent", parent), ("discharge", discharge)):
        print(f"      {tag}: " + ", ".join(f"{k[:-3]} {v:.0f}" for k, v in proof["stat"].items()
                                          if k.endswith("_ms")), flush=True)
    print(f"[10] launches: {counts}", flush=True)

    verify = UniversalVerifier.verify_stark_proof_with_vk
    vk = DeferredAggApp().vk_bytes()
    carried = StarkProof.from_dict(json.loads(json.dumps(env.to_dict())))
    t0 = time.perf_counter()
    ok = verify(vk, carried, cfg)
    verify_s = time.perf_counter() - t0
    bad_pv = StarkProof.from_dict(carried.to_dict())
    bad_pv.agg_children[0].pvs[0] = bad_pv.agg_children[0].pvs[0] ^ 1
    t0 = time.perf_counter()
    pv_ok = verify(vk, bad_pv, cfg)
    pv_s = time.perf_counter() - t0
    bad_discharge = StarkProof.from_dict(carried.to_dict())
    raw = bytearray(bad_discharge.deferral_discharge)
    raw[len(raw) // 2] ^= 1
    bad_discharge.deferral_discharge = bytes(raw)
    t0 = time.perf_counter()
    discharge_ok = verify(vk, bad_discharge, cfg)
    discharge_s = time.perf_counter() - t0
    print(f"[10] UniversalVerifier (deferred-agg vk): {ok} in {verify_s:.3f} s; a child "
          f"record's PV flipped: {pv_ok} in {pv_s:.3f} s; a discharge byte flipped: "
          f"{discharge_ok} in {discharge_s:.3f} s", flush=True)
    if not ok or pv_ok or discharge_ok:
        raise AssertionError("deferred verification phase failed")
    torch.cuda.empty_cache()
    return {"card": card, "children_s": children_s, "prove_s": entry_s,
            "wall_s_with_shape_check": wall_s, "execute_ms": env.stat.execution_time_mills,
            "parent_airs": parent["airs"], "parent_prove_ms": parent["s"] * 1e3,
            "parent_phases_ms": {k: v for k, v in parent["stat"].items() if k.endswith("_ms")},
            "discharge_airs": discharge["airs"], "discharge_prove_ms": discharge["s"] * 1e3,
            "discharge_phases_ms": {k: v for k, v in discharge["stat"].items()
                                    if k.endswith("_ms")},
            "pre_roots_ms": probes["pre_roots_ms"], "builds": builds,
            "self_verify_s": self_checks[0]["s"], "shape_check_s": probes["shape_check_s"],
            "shape_checks": probes["shape_checks"], "peak_bytes": peak, "launches": counts,
            "proof_bytes": len(env.proof), "discharge_bytes": len(env.deferral_discharge),
            "verify_s": verify_s, "tampered_child_pv": pv_ok, "tampered_child_pv_s": pv_s,
            "tampered_discharge": discharge_ok, "tampered_discharge_s": discharge_s}


SEGMENT_CYCLES = 1 << 14      # phase 11: the bench guest in two segments


def merged_chain_pvs(bundles) -> list:
    """The user public values a segment chain reveals, merged: each word's
    limbs from the segment that revealed it, then the per-word counts."""
    from zkvm_prover_tpu_torch.models import rv32_v2
    from zkvm_prover_tpu_torch.models.rv32_continuations import _seg_pvs

    n = rv32_v2.N_PV_WORDS
    limbs, counts = [0] * (4 * n), [0] * n
    for bundle in bundles:
        pvs = _seg_pvs(bundle)[2]
        for w in range(n):
            if pvs[4 * n + w]:
                limbs[4 * w:4 * w + 4] = pvs[4 * w:4 * w + 4]
                counts[w] += int(pvs[4 * n + w])
    return [int(v) for v in limbs + counts]


def continuation_cell(seed: int, unsegmented_pvs) -> dict:
    """Phase 11: continuations. Phase 6's guest run by `execute_segments` in
    2^14-cycle segments (two segments, one boundary) over the default
    depth-17 memory tree; each segment traced (the segment machine: the
    rv32 chips with ExecBoundaryAirV3, MemoryBoundaryAirV3,
    MemoryMerkleAir and Poseidon2Air); the segments' new kernel shapes
    checked against their plain versions; `prove_segments` at
    default_config() with the launch counts zeroed just before and read
    just after, every C call at a checked shape, every counter nonzero;
    `verify_chain` (True); the chain's public values against phase 6's
    unsegmented run of the same guest; the chain with its segments swapped,
    without its halting segment and against a wrong initial root (each
    False)."""
    import numpy as np
    import torch

    from zkvm_prover_tpu_torch.models import rv32_continuations as cont
    from zkvm_prover_tpu_torch.stark import machine
    from zkvm_prover_tpu_torch.stark.config import default_config
    from zkvm_prover_tpu_torch.vm import guests

    cfg = default_config()
    prog = guests.bench_guest_program(*RV32_GUEST)
    t0 = time.perf_counter()
    segs = cont.execute_segments(prog, SEGMENT_CYCLES, data_base=RV32_DATA_BASE)
    exec_s = time.perf_counter() - t0
    per_seg, shapes = [], {}
    for i, seg in enumerate(segs):
        t0 = time.perf_counter()
        triples = cont.generate_segment_traces(prog, seg, RV32_DATA_BASE)
        tracegen_s = time.perf_counter() - t0
        rows = {type(a).__name__: int(t.shape[0]) for a, t, _ in triples}
        merkle_tr = next(t for a, t, _ in triples if isinstance(a, cont.MemoryMerkleAir))
        real = {"MemoryMerkleAir": int(merkle_tr[:, cont.MemoryMerkleAir.IS_REAL].sum()),
                "MemoryBoundaryAirV3": int(next(
                    t for a, t, _ in triples if isinstance(a, cont.MemoryBoundaryAirV3)
                )[:, cont.MemoryBoundaryAirV3.IS_REAL].sum())}
        cells = sum(int(t.size) for _, t, _ in triples)
        per_seg.append({"cycles": int(len(seg.records)), "halted": seg.halted,
                        "init_pc": seg.init_pc, "final_pc": seg.final_pc,
                        "touched_ram_words": int(len(seg.touched_ram)), "airs": len(triples),
                        "rows": rows, "real_rows": real, "cells": cells,
                        "tracegen_s": tracegen_s})
        print(f"[11] segment {i}: {len(seg.records)} cycles, pc {seg.init_pc} -> "
              f"{seg.final_pc}, halted {seg.halted}, {len(seg.touched_ram)} RAM words touched; "
              f"{len(triples)} AIRs, {cells} cells, traces in {tracegen_s:.2f} s; "
              f"MemoryMerkleAir {rows['MemoryMerkleAir']} rows ({real['MemoryMerkleAir']} "
              f"real), Poseidon2Air {rows['Poseidon2Air']} rows", flush=True)
        for key, values in rv32_shapes(triples).items():
            shapes.setdefault(key, set()).update(values)
    shapes = {k: sorted(v) for k, v in shapes.items()}
    if len(segs) != 2:
        raise AssertionError(f"expected 2 segments, got {len(segs)}")
    rows = checked_shapes("11", "new segment", new_shapes(shapes), seed)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with log_calls() as used, timed_calls(machine, "prove_machine") as proofs:
        t0 = time.perf_counter()
        bundles = cont.prove_segments(prog, segs, cfg, data_base=RV32_DATA_BASE)
        torch.cuda.synchronize()
        prove_s = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    unchecked_calls(used, "segment")
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the segment path: {missing}")
    card = card_line()
    print(f"[11] prove_segments ({card}) {prove_s:.3f} s: per segment "
          f"{[round(p['s'], 3) for p in proofs]} s; peak {peak} bytes", flush=True)
    print(f"[11] launches: {counts}", flush=True)

    with timed_calls(machine, "verify_machine") as verifications:
        t0 = time.perf_counter()
        ok = cont.verify_chain(bundles, cfg)
        verify_s = time.perf_counter() - t0
    chain_pvs = merged_chain_pvs(bundles)
    pvs_equal = chain_pvs == [int(v) for v in unsegmented_pvs]
    tampers = {}
    for how, args, kwargs in (
            ("segments swapped", (bundles[::-1],), {}),
            ("halting segment dropped", (bundles[:-1],), {}),
            ("wrong initial root", (bundles,),
             {"initial_root": cont.MemState().root() ^ np.uint32(1)})):
        t0 = time.perf_counter()
        tampers[how] = (cont.verify_chain(*args, cfg, **kwargs), time.perf_counter() - t0)
    print(f"[11] verify_chain: {ok} in {verify_s:.3f} s (per segment "
          f"{[round(v['s'], 3) for v in verifications]} s); public values equal phase 6's "
          f"unsegmented run: {pvs_equal}; "
          + "; ".join(f"{how}: {r} in {s:.3f} s" for how, (r, s) in tampers.items()), flush=True)
    if not ok or not pvs_equal or any(r for r, _ in tampers.values()):
        raise AssertionError("continuation verification phase failed")
    torch.cuda.empty_cache()
    return {"card": card, "segment_cycles": SEGMENT_CYCLES, "depth": cont.DEPTH,
            "execute_s": exec_s, "segments": per_seg, "shape_checks": rows,
            "prove_s": prove_s, "prove_s_per_segment": [p["s"] for p in proofs],
            "phases_ms_per_segment": [{k: v for k, v in b.proof.stat.items()
                                       if k.endswith("_ms")} for b in bundles],
            "peak_bytes": peak, "launches": counts, "verify_s": verify_s,
            "verify_s_per_segment": [v["s"] for v in verifications],
            "chain_pvs_equal_unsegmented": pvs_equal,
            "tampered": {how: {"result": r, "s": t} for how, (r, t) in tampers.items()}}

# K4's bound: one CIOS product of 8-word Fq elements issues 136 IMAD (64
# lo(a b_i), 64 lo(m q), 8 m) and 128 IMAD.HI, which issue at half the IMAD
# rate (INT_MULS_PER_S): 392 IMAD slots. Products per point operation as
# csrc/bn254.cuh forms them.
MULS_PER_FQ_PRODUCT = 136 + 2 * 128
FQ_PRODUCTS = {"madd": 11, "add": 16, "dbl": 7}
K4_SOURCE = "zkvm_prover_tpu_torch/csrc/bn254_msm.cu"
K4_REPLACES = {"bn254_msm_chunks": "zkvm_prover_tpu/ops/msm.py:171",
               "bn254_msm_reduce": "zkvm_prover_tpu/ops/msm.py:171",
               "bn254_msm_window_sums": "zkvm_prover_tpu/ops/msm.py:261"}
K4_SMALL_N = 1 << 9           # the whole MSM against its plain version, with edge cases
K4_SKEW_LIMIT = 3.0           # a wrap MSM's bucket kernels against a uniform one at its size


def snark_counts() -> dict:
    from zkvm_prover_tpu_torch.ops import msm

    return {k: msm.launches[k] for k in K4_REPLACES}


def k4_products(dig, points_at_infinity, c: int, plan=None) -> dict:
    """Fq products this run's digits need, counted as K4's first version
    counted them whatever split the kernels use: the bucket step a madd
    per point added into a bucket that already holds one; the window sums
    per window the running sums over every bucket slot (an add each for
    run and acc where a bucket is occupied, acc's add otherwise), and the
    3S adds and log2(L) doublings of a combine of S = 2^min(8, c/2)
    segments. With a plan, the bucket step's count is shared between its
    kernels by the additions each makes: the chunks' (a point into a run
    that holds one), the reduction's (one per run beyond a bucket's
    first); the reduction's full adds and the pieces' slots are overhead."""
    import torch

    W = dig.shape[0]
    live = (dig != 0) & ~points_at_infinity[None, :]
    occupied = torch.zeros(W, 1 << c, dtype=torch.bool, device=dig.device)
    occupied.scatter_(1, torch.where(live, dig, 0), live)
    occupied[:, 0] = False
    n_occ = int(occupied.sum())
    log_s = min(8, c // 2)
    out = {"bucket_step": FQ_PRODUCTS["madd"] * (int(live.sum()) - n_occ),
           "bn254_msm_window_sums": (
               FQ_PRODUCTS["add"] * (n_occ + W * ((1 << c) + 3 * (1 << log_s)))
               + FQ_PRODUCTS["dbl"] * W * (c - log_s))}
    if plan is not None:
        key = plan.key
        group = torch.arange(key.shape[0], device=key.device) // plan.m
        runs = int(key.shape[0] > 0) + int(((key[1:] != key[:-1])
                                            | (group[1:] != group[:-1])).sum())
        out["bn254_msm_chunks"] = FQ_PRODUCTS["madd"] * (key.shape[0] - runs)
        out["bn254_msm_reduce"] = FQ_PRODUCTS["madd"] * (runs - n_occ)
    return out


def affine_err(got: list, want: list) -> int:
    """The largest coordinate difference between two lists of affine points
    (None at infinity counts as (0, 0))."""
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} points against {len(want)}")
    err = 0
    for a, b in zip(got, want):
        a, b = a or (0, 0), b or (0, 0)
        err = max(err, abs(a[0] - b[0]), abs(a[1] - b[1]))
    return err


def point_err(a, b) -> int:
    """Two (..., 24) arrays of Jacobian Montgomery words as affine points:
    X1 Z2^2 = X2 Z1^2 and Y1 Z2^3 = Y2 Z1^3 (or both at infinity) on the
    device with the plain Fq product, then `affine_err` (`msm.to_affine`)
    over the points that differ, so 0 when all agree."""
    import torch

    from zkvm_prover_tpu_torch.ops import msm
    from zkvm_prover_tpu_torch.ops.bigint import BN254_FQ as F

    a, b = a.reshape(-1, 24), b.reshape(-1, 24)
    if a.shape != b.shape:
        raise AssertionError(f"{tuple(a.shape)} points against {tuple(b.shape)}")
    if a.shape[0] == 0:
        return 0
    (X1, Y1, Z1), (X2, Y2, Z2) = msm._jacobian(a), msm._jacobian(b)
    inf1, inf2 = F.is_zero(Z1), F.is_zero(Z2)
    Z1s, Z2s = F.square(Z1), F.square(Z2)
    same = (F.eq(F.mul(X1, Z2s), F.mul(X2, Z1s))
            & F.eq(F.mul(Y1, F.mul(Z2s, Z2)), F.mul(Y2, F.mul(Z1s, Z1))))
    ok = (inf1 & inf2) | (~inf1 & ~inf2 & same)
    bad = (~ok).nonzero().squeeze(1)
    if not bad.numel():
        return 0
    return max(1, affine_err(msm.to_affine(a[bad]), msm.to_affine(b[bad])))


def k4_launches(pts, plan, stages, buckets, c: int) -> dict:
    """Each K4 entry's C call on these inputs with its outputs allocated
    beforehand (scratch buckets; every reduction level of `stages` in
    turn), for `time_ms`: back-to-back launches keep the host's torch calls
    out of the device time. Not counted in `msm.launches`."""
    import torch

    from zkvm_prover_tpu_torch import _build
    from zkvm_prover_tpu_torch.ops import msm

    lib, stream = _build.lib(), _build.stream(pts.device)
    scratch = torch.zeros_like(buckets)
    pieces = torch.empty_like(stages[0][4])
    levels = [(p_in, k_in, torch.empty_like(out), torch.empty_like(k_out))
              for _, (p_in, k_in, _), k_out, _, out in stages[1:]]
    sums = torch.empty((buckets.shape[0], 24), dtype=torch.int32, device=pts.device)

    def chunks():
        _build.check(lib.bn254_msm_chunks(
            pts.data_ptr(), plan.idx.data_ptr(), plan.key.data_ptr(), plan.key.shape[0], plan.m,
            plan.piece_key.data_ptr(), pieces.data_ptr(), scratch.data_ptr(), stream),
            "bn254_msm_chunks")

    def reduce():
        for p_in, k_in, out, k_out in levels:
            _build.check(lib.bn254_msm_reduce(
                p_in.data_ptr(), k_in.data_ptr(), k_in.shape[0], out.data_ptr(),
                k_out.data_ptr(), scratch.data_ptr(), stream), "bn254_msm_reduce")

    def window_sums():
        _build.check(lib.bn254_msm_window_sums(
            buckets.data_ptr(), buckets.shape[0], c, msm.sum_bits(c), sums.data_ptr(), stream),
            "bn254_msm_window_sums")

    return {"bn254_msm_chunks": chunks, "bn254_msm_reduce": reduce,
            "bn254_msm_window_sums": window_sums}


def synced_s(fn):
    """fn() and its host seconds up to a device synchronise."""
    import torch

    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def k4_shape(points, scalars) -> dict:
    """An MSM's shape on K4: n, c, the host ms of the pack and of the digit
    split with the sort, the occupied buckets (digit > 0) and each window's
    longest run."""
    from zkvm_prover_tpu_torch.ops import msm

    import torch

    dev = torch.device("cuda")
    n, c = len(points), msm.window_bits(len(points))
    pts, pack_s = synced_s(lambda: msm.words_tensor(msm.affine_words(points), dev))
    (dig, (order, offsets)), sort_s = synced_s(lambda: (lambda d: (d, msm.sort_by_digit(d, c)))(
        msm.digits(msm.words_tensor(msm.scalar_words(scalars), dev), c)))
    counts = (offsets[:, 2:] - offsets[:, 1:-1])
    return {"n": n, "c": c, "windows": dig.shape[0], "occupied": int((counts > 0).sum()),
            "longest_run": counts.max(1).values.tolist(), "pack_ms": pack_s * 1e3,
            "sort_ms": sort_s * 1e3, "pts": pts, "dig": dig, "order": order, "offsets": offsets}


def k4_check(tag: str, points, scalars, plain: bool, edge: bool = False) -> dict:
    """K4 on the card at n = len(points): each kernel's entry on the plan
    of these inputs against its plain version on the card (`plain`): the
    chunk partials, every level of the reduction (pieces, their buckets
    and the buckets written) and the window sums, as affine points (their
    Jacobian bits are free); the bucket step against the reference's
    segmented combine, the whole MSM against the host engine
    (`native/bn254`). Each entry's device ms per call (`k4_launches`, CUDA
    events), the bucket step's ms (CUDA events, with the sort and the
    plan), the plain versions' ms and each bound. `edge`: the chunk edges must cut a
    run of a repeated point and an opposite pair."""
    import torch

    from zkvm_prover_tpu_torch.fields import bn254 as bn
    from zkvm_prover_tpu_torch.fields import bn254_native
    from zkvm_prover_tpu_torch.ops import msm

    dev = torch.device("cuda")
    shape = k4_shape(points, scalars)
    n, c = shape["n"], shape["c"]
    pts, dig, order, offsets = (shape.pop(k) for k in ("pts", "dig", "order", "offsets"))
    infinity = (pts == 0).all(-1)
    plan, plan_s = synced_s(lambda: msm.chunk_plan(order, offsets, infinity, c))
    W, nb = dig.shape[0], 1 << c

    # the kernels once more, every level's inputs and outputs kept
    before = dict(msm.launches)
    buckets = torch.zeros((W, nb, 24), dtype=torch.int32, device=dev)
    pieces = msm.chunk_partials(pts, plan, buckets)
    stages = [("chunks", None, plan.piece_key, buckets.clone(), pieces)]
    keys = plan.piece_key
    while keys.shape[0] > 2:
        prev = buckets.clone()
        nxt, nkeys = msm.reduce_segments(pieces, keys, buckets)
        stages.append(("reduce", (pieces, keys, prev), nkeys, buckets.clone(), nxt))
        pieces, keys = nxt, nkeys
    sums = msm.window_sums(buckets, c)
    got, combine_s = synced_s(lambda: msm.combine_windows(sums, c))
    launched = {k: msm.launches[k] - before[k] for k in K4_REPLACES}
    t0 = time.perf_counter()
    want = bn254_native.msm(points, scalars)
    host_s = time.perf_counter() - t0
    whole, whole_s = synced_s(lambda: msm.msm_device(points, scalars, dev))
    err_host = affine_err([got, whole], [want, want])
    products = k4_products(dig, infinity, c, plan)
    row = {**shape, "live": plan.key.shape[0], "m": plan.m,
           "chunks": plan.piece_key.shape[0] // 2,
           "levels": [st[1][1].shape[0] for st in stages[1:]], "plan_ms": plan_s * 1e3,
           "combine_ms": combine_s * 1e3, "host_engine_s": host_s, "msm_device_s": whole_s,
           "err_vs_host_engine": err_host, "fq_products": products, "launches": launched,
           "steps": {}}
    if edge:
        # a chunk edge inside a run of one repeated point, and one between
        # a point and its negative
        cut = torch.arange(plan.m, plan.key.shape[0], plan.m, device=dev)
        same_bucket = plan.key[cut] == plan.key[cut - 1]
        left, right = plan.idx[cut - 1].long(), plan.idx[cut].long()
        pl, pr = pts[left], pts[right]
        row["edges_in_a_repeat"] = int((same_bucket & (pl == pr).all(-1)).sum())
        row["edges_in_an_opposite_pair"] = int((same_bucket & (pl[:, :8] == pr[:, :8]).all(-1)
                                                & (pl[:, 8:] != pr[:, 8:]).any(-1)).sum())
        if not (row["edges_in_a_repeat"] and row["edges_in_an_opposite_pair"]):
            raise AssertionError(f"the edge case's chunk edges miss its repeats or pairs: {row}")
    for name, launch in k4_launches(pts, plan, stages, buckets, c).items():
        step = {"ms": time_ms(launch, reps=20), "launches": launched[name],
                "fq_products": products[name]}
        step["bound_ms"], step["bound_by"] = bound_ms(0, products[name] * MULS_PER_FQ_PRODUCT)
        row["steps"][name] = step
    b_ms, b_by = bound_ms(0, products["bucket_step"] * MULS_PER_FQ_PRODUCT)
    row["bucket_step"] = {"ms": time_ms(lambda: msm.window_buckets(pts, dig, c), reps=5),
                          "kernel_ms": row["steps"]["bn254_msm_chunks"]["ms"]
                          + row["steps"]["bn254_msm_reduce"]["ms"],
                          "bound_ms": b_ms, "bound_by": b_by,
                          "fq_products": products["bucket_step"]}
    if plain:
        err = {}
        t0 = time.perf_counter()
        ref_buckets = torch.zeros_like(buckets)
        ref_pieces = msm.chunk_partials_plain(pts, plan, ref_buckets)
        torch.cuda.synchronize()
        row["steps"]["bn254_msm_chunks"]["plain_ms"] = (time.perf_counter() - t0) * 1e3
        _, _, k_keys, k_buckets, k_pieces = stages[0]
        live = k_keys >= 0
        err["bn254_msm_chunks"] = max(point_err(k_pieces[live], ref_pieces[live]),
                                      point_err(k_buckets, ref_buckets))
        plain_ms, e = 0.0, 0
        for _, (p_in, k_in, b_in), k_keys, k_buckets, k_pieces in stages[1:]:
            t0 = time.perf_counter()
            ref_buckets = b_in.clone()
            ref_pieces, ref_keys = msm.reduce_level_plain(p_in, k_in, ref_buckets)
            torch.cuda.synchronize()
            plain_ms += (time.perf_counter() - t0) * 1e3
            live = ref_keys >= 0
            e = max(e, int(not torch.equal(ref_keys, k_keys)),
                    point_err(k_pieces[live], ref_pieces[live]), point_err(k_buckets, ref_buckets))
        err["bn254_msm_reduce"] = e
        row["steps"]["bn254_msm_reduce"]["plain_ms"] = plain_ms
        ref_sums, s = synced_s(lambda: msm.window_sums_plain(buckets, c))
        row["steps"]["bn254_msm_window_sums"]["plain_ms"] = s * 1e3
        err["bn254_msm_window_sums"] = point_err(sums, ref_sums)
        for name, e in err.items():
            row["steps"][name]["max_abs_err"] = e
        ref_combine, s = synced_s(lambda: msm.window_buckets_plain(pts, dig, c))
        row["bucket_step"].update(plain_ms=s * 1e3, max_abs_err=point_err(buckets, ref_combine),
                                  wrapper_err=point_err(msm.window_buckets(pts, dig, c),
                                                        ref_combine))
        row["err_plain_total"] = affine_err([msm.combine_windows(ref_sums, c)], [want])
    print(f"[{tag}] K4 at n={n} (c={c}, {W} windows, {row['live']} live entries, m={plan.m}, "
          f"{row['chunks']} chunks, reduction levels of {row['levels']} slots; longest run "
          f"{max(row['longest_run'])}): vs host engine err={err_host} (host engine "
          f"{host_s * 1e3:.1f} ms, msm_device {whole_s * 1e3:.1f} ms wall; pack "
          f"{row['pack_ms']:.1f}, digits+sort {row['sort_ms']:.1f}, plan {row['plan_ms']:.1f}, "
          f"combine {row['combine_ms']:.1f} ms); bucket step {row['bucket_step']['ms']:.4f} ms "
          f"(events, with sort and plan; kernels {row['bucket_step']['kernel_ms']:.4f} ms) bound "
          f"{b_ms:.4f} ms"
          + (f", against the reference's combine err={row['bucket_step']['max_abs_err']} "
             f"(plain {row['bucket_step']['plain_ms']:.1f} ms)" if plain else "")
          + "".join(f"; {k} {v['ms']:.4f} ms x{v['launches']}"
                    + (f" (plain {v['plain_ms']:.1f} ms, err={v['max_abs_err']})" if plain else "")
                    + f" bound {v['bound_ms']:.4f} ms" for k, v in row["steps"].items())
          + (f"; plain whole err={row['err_plain_total']}" if plain else "")
          + (f"; chunk edges in a repeat {row['edges_in_a_repeat']}, in an opposite pair "
             f"{row['edges_in_an_opposite_pair']}" if edge else ""), flush=True)
    if err_host or row.get("err_plain_total", 0) or any(
            v.get("max_abs_err", 0) for v in row["steps"].values()) or \
            row["bucket_step"].get("max_abs_err", 0) or row["bucket_step"].get("wrapper_err", 0):
        raise AssertionError(f"K4 disagrees at n={n}")
    return row


def k4_edge_case(n: int, seed: int):
    """n points and scalars with K4's edge cases: points repeated (a run of
    one point longer than a chunk, a pair in one bucket), opposite pairs
    side by side with equal scalars (some of them across a chunk edge),
    infinity; scalars 0, small (zero digits in every upper window), r - 1,
    r, r + 1 and the rest uniform below 2^256 (mostly >= r)."""
    import random

    from zkvm_prover_tpu_torch.fields import bn254 as bn

    rng = random.Random(seed)
    p = bn.g1_mul(bn.G1_GEN, rng.randrange(1, bn.R))
    step = bn.g1_mul(bn.G1_GEN, rng.randrange(1, bn.R))
    points = []
    for _ in range(n):
        points.append(p)
        p = bn.g1_add(p, step)
    scalars = [rng.randrange(1 << 256) for _ in range(n)]
    points[8:40] = [points[8]] * 32
    scalars[8:40] = [scalars[8]] * 32
    points[3] = points[4]
    points[5] = None
    for i in [6] + list(range(41, 73, 2)):
        points[i] = bn.g1_neg(points[i + 1])
        scalars[i] = scalars[i + 1]
    scalars[:5] = [0, 5, bn.R - 1, bn.R, bn.R + 1]
    return points, scalars


def fq_check(seed: int) -> dict:
    """K4's Fq core alone (`bn254_fq_mul`) on 2^20 products against the
    plain Fq product on the card (`ops/bigint.py`), edge values included;
    its time and its rate against the 42.7 G products/s that the bound
    assumes (16.75 T IMAD/s over 392 IMAD slots a product)."""
    import numpy as np
    import torch

    from zkvm_prover_tpu_torch.fields import bn254 as bn
    from zkvm_prover_tpu_torch.ops import bigint, msm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = 1 << 20
    # residues below q: the top word drawn below q's top word
    a, b = (torch.randint(-(1 << 31), 1 << 31, (n, 8), generator=gen, dtype=torch.int32,
                          device=dev) for _ in range(2))
    top = bn.Q >> 224
    a[:, 7] = torch.randint(0, top, (n,), generator=gen, device=dev).to(torch.int32)
    b[:, 7] = torch.randint(0, top, (n,), generator=gen, device=dev).to(torch.int32)
    edges = msm.words_tensor(np.frombuffer(b"".join(
        x.to_bytes(32, "little") for x in (0, 1, bn.Q - 1, bn.Q - 2, (1 << 256) % bn.Q)),
        dtype=np.uint32), dev).reshape(5, 8)
    a[:5], b[:5], b[5:10] = edges, edges.flip(0), edges
    ms = time_ms(lambda: msm.fq_mul(a, b), reps=20)
    got = msm.fq_mul(a, b)
    t0 = time.perf_counter()
    want = bigint.to_words(bigint.BN254_FQ.mul(bigint.from_words(a), bigint.from_words(b)))
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max_err(got, want)
    b_ms, b_by = bound_ms(3 * n * 32, n * MULS_PER_FQ_PRODUCT)
    rate = n / ms / 1e6
    peak = INT_MULS_PER_S / MULS_PER_FQ_PRODUCT / 1e9
    print(f"[12] K4 Fq product (bn254_fq_mul) on ({n}, 8) words: err={err} ms={ms:.4f} "
          f"plain_ms={plain_ms:.1f} bound_ms={b_ms:.4f} ({b_by}); {rate:.2f} G products/s "
          f"against {peak:.2f} ({rate / peak:.3f} of the rate the bound assumes)", flush=True)
    if err:
        raise AssertionError("K4's Fq product disagrees with the plain version")
    return {"n": n, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "g_products_per_s": rate, "share_of_assumed_rate": rate / peak}


@contextlib.contextmanager
def k4_recorder():
    """Every `msm.msm_device` call while the block runs: its inputs, its
    result, its wall seconds, and the device ms (CUDA events) of its bucket
    step (`window_buckets`, with the sort and the plan) and of each K4 entry
    it calls, with their calls. The events are read once the MSM has
    returned (its combine waits for the device), so that timing adds no
    synchronisation inside it."""
    import torch

    from zkvm_prover_tpu_torch.ops import msm

    records = []
    entries = {"window_buckets": "bucket_step", "chunk_partials": "bn254_msm_chunks",
               "reduce_segments": "bn254_msm_reduce", "window_sums": "bn254_msm_window_sums"}
    originals = {name: getattr(msm, name) for name in ("msm_device", *entries)}
    pending = []

    def msm_device(points, scalars, device, c=None):
        rec = {"n": len(points), "points": list(points), "scalars": list(scalars),
               "ms": {k: 0.0 for k in entries.values()}, "calls": {k: 0 for k in entries.values()}}
        records.append(rec)
        t0 = time.perf_counter()
        rec["result"] = originals["msm_device"](points, scalars, device, c)
        rec["s"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        for key, start, stop in pending:
            rec["ms"][key] += start.elapsed_time(stop)
            rec["calls"][key] += 1
        pending.clear()
        return rec["result"]

    def timed(name):
        def call(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = originals[name](*args, **kwargs)
            stop.record()
            pending.append((entries[name], start, stop))
            return out
        return call

    msm.msm_device = msm_device
    for name in entries:
        setattr(msm, name, timed(name))
    try:
        yield records
    finally:
        for name, fn in originals.items():
            setattr(msm, name, fn)


def k4_wrap_msms(records: list) -> list:
    """Phase 12's MSMs after the wrap: each result against the host engine,
    and its shape (`k4_shape`) with the host ms of its window combine."""
    import torch

    from zkvm_prover_tpu_torch.fields import bn254_native
    from zkvm_prover_tpu_torch.ops import msm

    rows = []
    for i, rec in enumerate(records):
        t0 = time.perf_counter()
        want = bn254_native.msm(rec["points"], rec["scalars"])
        host_s = time.perf_counter() - t0
        shape = k4_shape(rec["points"], rec["scalars"])
        pts, dig, c = shape.pop("pts"), shape.pop("dig"), shape["c"]
        for k in ("order", "offsets"):
            shape.pop(k)
        sums = msm.window_sums(msm.window_buckets(pts, dig, c), c)
        torch.cuda.synchronize()
        _, combine_s = synced_s(lambda: msm.combine_windows(sums, c))
        row = {**shape, "combine_ms": combine_s * 1e3, "host_engine_s": host_s,
               "equal_to_host_engine": rec["result"] == want, "wall_s": rec["s"],
               "device_ms": rec["ms"], "calls": rec["calls"]}
        rows.append(row)
        longest = max(row["longest_run"])
        print(f"[12] MSM {i}: n={row['n']} c={c} occupied {row['occupied']} of "
              f"{row['windows'] * ((1 << c) - 1)} buckets, longest run {longest} (window "
              f"{row['longest_run'].index(longest)}; per window {row['longest_run']}); host "
              f"ms: pack {row['pack_ms']:.2f}, digits+sort {row['sort_ms']:.2f}, combine "
              f"{row['combine_ms']:.2f}; K4 device ms: "
              + ", ".join(f"{k} {v:.4f}" + (f" ({row['calls'][k]} calls)"
                                            if k == "bn254_msm_reduce" else "")
                          for k, v in row["device_ms"].items())
              + f"; equal to the host engine: {row['equal_to_host_engine']}", flush=True)
    if not all(r["equal_to_host_engine"] for r in rows):
        raise AssertionError("a wrap MSM on K4 disagrees with the host engine")
    return rows


@contextlib.contextmanager
def device_timed(owner, name: str):
    """The device ms (CUDA events, synchronised) of every call of
    `owner.name` while the block runs."""
    import torch

    original = getattr(owner, name)
    times = []

    def timed(*args, **kwargs):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = original(*args, **kwargs)
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
        return out

    setattr(owner, name, timed)
    try:
        yield times
    finally:
        setattr(owner, name, original)


def flipped(raw: bytes, at: int) -> bytes:
    return raw[:at] + bytes([raw[at] ^ 1]) + raw[at + 1:]


def snark_cell(bundles, bundle_task, seed: int) -> dict:
    """Phase 12: the SNARK wrapper over phase 8's bundle. K4's Fq core on
    2^20 products and a whole MSM of 2^9 points with its edge cases against
    their plain versions; then, with the launch counts zeroed just before,
    the bundle Prover's `gen_proof_universal(task, with_snark=True)`: the
    STARK from its disk cache (no STARK launch), the wrapper keys (SRS,
    `plonk.setup`), the accumulator, `plonk.prove`, every MSM of eight or
    more points on K4; the split printed. Every MSM of the wrap against the
    host engine, with its shape, skew and host and device split.
    `UniversalVerifier.verify_evm_proof` True, and False for a flipped
    instance byte, a flipped blob byte and another app's vk. Last, K4 on
    the path's largest and its most skewed MSM against the plain versions,
    and uniform scalars on the path's points at each size beside them."""
    import random

    import torch

    from zkvm_prover_tpu_torch.fields import bn254 as bn
    from zkvm_prover_tpu_torch.host import EvmProof, UniversalVerifier
    from zkvm_prover_tpu_torch.ops import msm
    from zkvm_prover_tpu_torch.snark import plonk, wrapper

    report = {"fq_mul": fq_check(seed)}
    report["msm_edge_cases"] = k4_check("12", *k4_edge_case(K4_SMALL_N, seed), plain=True,
                                        edge=True)

    prover = bundles.prover
    if prover.cache_dir is None or prover._cache_path(bundle_task) is None \
            or not prover._cache_path(bundle_task).exists():
        raise AssertionError("the bundle proof is not in the prover's disk cache")

    torch.cuda.synchronize()
    reset_counts()
    with contextlib.ExitStack() as stack:
        srs_calls, setup_calls, acc_calls, keccak_calls, transcript_calls, prove_calls = (
            stack.enter_context(timed_calls(*a)) for a in (
                (bn.KzgSrs, "generate_insecure"), (plonk, "setup"), (wrapper, "_accumulator"),
                (wrapper, "keccak256"), (plonk, "keccak256"), (plonk, "prove")))
        records = stack.enter_context(k4_recorder())
        t0 = time.perf_counter()
        ep = prover.gen_proof_universal(bundle_task, with_snark=True)
        torch.cuda.synchronize()
        wrap_s = time.perf_counter() - t0
    stark_launches = sum(launch_counts().values())
    counts = snark_counts()
    n_msm = len(records)
    k4_ms = {k: sum(r["ms"][k] for r in records) for k in records[0]["ms"]} if records else {}
    print(f"[12] {prover.app.name} gen_proof_universal(with_snark=True) {wrap_s:.3f} s: SRS "
          f"{sum(c['s'] for c in srs_calls):.3f} s, plonk.setup "
          f"{sum(c['s'] for c in setup_calls):.3f} s, accumulator "
          f"{sum(c['s'] for c in acc_calls):.3f} s (wrapper keccak "
          f"{sum(c['s'] for c in keccak_calls):.3f} s over {len(keccak_calls)} calls), "
          f"plonk.prove {sum(c['s'] for c in prove_calls):.3f} s (transcript keccak "
          f"{sum(c['s'] for c in transcript_calls):.3f} s); {n_msm} MSMs "
          f"({sorted(set(r['n'] for r in records))} points) in "
          f"{sum(r['s'] for r in records):.3f} s wall, K4 device ms (CUDA events): "
          + ", ".join(f"{k} {v:.3f}" for k, v in k4_ms.items())
          + f"; launches {counts}, STARK kernel launches {stark_launches}", flush=True)
    if stark_launches or not n_msm or counts["bn254_msm_chunks"] != n_msm \
            or counts["bn254_msm_window_sums"] != n_msm or counts["bn254_msm_reduce"] < n_msm:
        raise AssertionError("the wrap did not take its STARK from the cache, or an MSM "
                             "missed K4")
    report.update(
        wrap_s=wrap_s, srs_s=sum(c["s"] for c in srs_calls),
        setup_s=sum(c["s"] for c in setup_calls), accumulator_s=sum(c["s"] for c in acc_calls),
        wrapper_keccak_s=sum(c["s"] for c in keccak_calls),
        transcript_keccak_s=sum(c["s"] for c in transcript_calls),
        prove_s=sum(c["s"] for c in prove_calls), msm_sizes=[r["n"] for r in records],
        msm_wall_s=sum(r["s"] for r in records), k4_device_ms=k4_ms,
        k4_kernel_device_ms=sum(v for k, v in k4_ms.items() if k != "bucket_step"),
        launches=counts, proof_bytes=len(ep.proof), instance_bytes=len(ep.instances))
    report["msms"] = k4_wrap_msms(records)

    cfg = prover.config.stark
    verifier = UniversalVerifier(prover.app.name, cfg)
    carried = EvmProof.from_dict(json.loads(json.dumps(ep.to_dict())))
    with timed_calls(msm, "msm_device") as verify_msms:
        t0 = time.perf_counter()
        ok = verifier.verify_evm_proof(carried)
        verify_s = time.perf_counter() - t0
    pi_at = (wrapper.N_ACC + wrapper.N_DIGEST) * 32 + 31
    tampers = {
        "instance byte": verifier.verify_evm_proof(
            EvmProof(proof=ep.proof, instances=flipped(ep.instances, pi_at))),
        "blob byte": verifier.verify_evm_proof(  # the low byte of the first evaluation
            EvmProof(proof=flipped(ep.proof, 9 * 64 + 31), instances=ep.instances)),
        "another app's vk": UniversalVerifier(
            "batch" if prover.app.name != "batch" else "bundle", cfg).verify_evm_proof(carried),
    }
    print(f"[12] UniversalVerifier.verify_evm_proof: {ok} in {verify_s:.3f} s "
          f"({len(verify_msms)} MSM on K4); tampered: {tampers}", flush=True)
    if not ok or any(tampers.values()):
        raise AssertionError("EvmProof verification phase failed")
    report.update(verify_s=verify_s, tampered=tampers)

    # K4 on the path's own inputs, each kernel against its plain version:
    # the largest MSM and the most skewed one (the longest run of a window)
    largest = max(range(n_msm), key=lambda i: records[i]["n"])
    skewed = max(range(n_msm), key=lambda i: (max(report["msms"][i]["longest_run"]),
                                               records[i]["n"]))
    report["msm_path"] = [k4_check("12", records[largest]["points"],
                                   records[largest]["scalars"], plain=True)]
    report["msm_skewed_index"] = skewed
    if skewed != largest:
        report["msm_path"].append(k4_check("12", records[skewed]["points"],
                                           records[skewed]["scalars"], plain=True))
    # uniform scalars below r on the points of the path's first MSM of each
    # size, through msm_device as the wrap ran it, beside the wrap's MSMs
    rng = random.Random(seed)
    report["msm_uniform"] = {}
    for n in sorted(set(r["n"] for r in records)):
        pts = next(r["points"] for r in records if r["n"] == n)
        sc = [rng.randrange(bn.R) for _ in range(n)]
        with k4_recorder() as uniform:
            for _ in range(3):
                msm.msm_device(pts, sc, torch.device("cuda"))
        steps = {k: sum(u["ms"][k] for u in uniform) / len(uniform) for k in uniform[0]["ms"]}
        kernels = steps["bn254_msm_chunks"] + steps["bn254_msm_reduce"]
        worst = max((r["device_ms"]["bn254_msm_chunks"] + r["device_ms"]["bn254_msm_reduce"]) /
                    kernels for r in report["msms"] if r["n"] == n)
        report["msm_uniform"][n] = {"device_ms": steps, "bucket_kernels_ms": kernels,
                                    "worst_wrap_ratio": worst}
        print(f"[12] uniform scalars at n={n}: K4 device ms (CUDA events, mean of 3) "
              + ", ".join(f"{k} {v:.4f}" for k, v in steps.items())
              + f"; the wrap's MSMs of {n} points take up to {worst:.2f}x its bucket kernels "
              f"(limit {K4_SKEW_LIMIT})", flush=True)
    torch.cuda.empty_cache()
    return report


# ---------------------------------------------------------------------------
# 13. a re-executed chunk: real blocks, sealed and re-executed from witnesses
# ---------------------------------------------------------------------------

REEXEC_ACCOUNTS = 1024        # funded EOAs in the genesis
REEXEC_SIGNERS = 32           # of which the chain holds the keys
REEXEC_BLOCKS = 3
REEXEC_TXS = 30               # transactions a block
REEXEC_CHAIN_ID = 534352
REEXEC_COINBASE = b"\xfe" * 20
TOKEN_ADDRESS = b"\xc0\xde" + b"\x00" * 17 + b"\x01"
PRECOMPILES_ADDRESS = b"\xc0\xde" + b"\x00" * 17 + b"\x02"
# transfer(to: word 0, amount: word 1) over balances at slot = address:
# revert if the caller's balance is short, else move the amount and LOG3
# Transfer(caller, to) with the amount as data (the revert block sits at 3)
TOKEN_PROLOGUE = bytes.fromhex("600756" "5b5f5ffd" "5b")
TOKEN_BODY = bytes.fromhex(
    "3354" "602035" "808210" "600357" "808203" "3355" "5f35" "8054" "8201" "9055" "5f52"
    "5f35" "33" "7f")
TOKEN_EPILOGUE = bytes.fromhex("60205f" "a3" "00")
# the oracle's Curie-era slots (l1 base fee, blob base fee, commit and blob
# scalars: the values of the reference's Curie test) and its pre-Curie ones
ORACLE_SLOTS = {1: 10**9, 2: 2100, 3: 10**9, 5: 5 * 10**8, 6: 230_759_955_285,
                7: 417_565_260}


def execution_api(package: str = "zkvm_prover_tpu_torch"):
    """The modules that build and re-execute blocks, from `package` (the
    port by default; the CPU tests pass the JAX package's name to build the
    same chain there)."""
    import importlib
    import types

    names = {"blk": "execution.block", "mpt": "execution.mpt", "rlp": "execution.rlp",
             "state": "execution.state", "keccak": "ops.keccak", "bn": "fields.bn254",
             "curve": "types.chunk.crypto.weierstrass"}
    return types.SimpleNamespace(**{k: importlib.import_module(f"{package}.{v}")
                                    for k, v in names.items()})


def address_of(api, priv: int) -> bytes:
    c = api.curve.SECP256K1
    q = c.mul(priv, c.generator())
    return api.keccak.keccak256(q[0].to_bytes(32, "big") + q[1].to_bytes(32, "big"))[12:]


def ecdsa_sign(api, digest: bytes, priv: int) -> tuple:
    """(r, s, recovery id) with a deterministic nonce and low s."""
    c = api.curve.SECP256K1
    z = int.from_bytes(digest, "big") % c.n
    k = int.from_bytes(api.keccak.keccak256(digest + priv.to_bytes(32, "big")), "big") % c.n
    while True:
        pt = c.mul(k, c.generator())
        r = pt[0] % c.n
        s = pow(k, c.n - 2, c.n) * (z + r * priv) % c.n
        if r and s:
            break
        k += 1
    rec = pt[1] & 1
    if s > c.n // 2:
        s, rec = c.n - s, rec ^ 1
    return r, s, rec


def sign_tx(api, tx, priv: int):
    r, s, rec = ecdsa_sign(api, tx.sign_hash(), priv)
    if tx.tx_type == 0:
        tx.v = rec + 35 + 2 * tx.chain_id if tx.chain_id else rec + 27
    else:
        tx.v = rec
    tx.r, tx.s = r, s
    return tx


def token_code(api) -> bytes:
    topic = api.keccak.keccak256(b"Transfer(address,address,uint256)")
    return TOKEN_PROLOGUE + TOKEN_BODY + topic + TOKEN_EPILOGUE


def deploy_code(runtime: bytes) -> bytes:
    """Initcode that returns `runtime`: CODECOPY it from offset 12, RETURN."""
    n = len(runtime).to_bytes(2, "big")
    return b"\x61" + n + b"\x60\x0c\x5f\x39\x61" + n + b"\x5f\xf3" + runtime


def g1_bytes(p) -> bytes:
    return p[0].to_bytes(32, "big") + p[1].to_bytes(32, "big")


def precompile_cases(api, rng, signer: int) -> list:
    """(address, input, expected output) for precompiles 0x01-0x08, the
    output computed on the host another way than the precompile does."""
    import hashlib

    bn = api.bn
    digest = rng.bytes(32)
    r, s, rec = ecdsa_sign(api, digest, signer)
    ecrec_in = digest + (27 + rec).to_bytes(32, "big") + r.to_bytes(32, "big") + s.to_bytes(32, "big")
    blob = rng.bytes(100)
    try:
        ripemd = hashlib.new("ripemd160", blob).digest()
    except ValueError:       # an OpenSSL without it: the port's own
        from zkvm_prover_tpu_torch.types.chunk.crypto.ripemd160 import ripemd160
        ripemd = ripemd160(blob)
    b, e, m = (int.from_bytes(rng.bytes(32), "big") | 1 for _ in range(3))
    a1, a2, k = (int.from_bytes(rng.bytes(16), "big") + 1 for _ in range(3))
    p1, p2 = bn.g1_mul(bn.G1_GEN, a1), bn.g1_mul(bn.G1_GEN, a2)
    q2 = bn.g2_mul(bn.G2_GEN, a2)

    def g2_bytes(q):       # EIP-197: x_im, x_re, y_im, y_re
        (xr, xi), (yr, yi) = q
        return b"".join(v.to_bytes(32, "big") for v in (xi, xr, yi, yr))

    pairing_in = (g1_bytes(p1) + g2_bytes(q2)
                  + g1_bytes(bn.g1_neg(bn.g1_mul(bn.G1_GEN, a1 * a2 % bn.R)))
                  + g2_bytes(bn.G2_GEN))
    return [
        (1, ecrec_in, bytes(12) + address_of(api, signer)),
        (2, blob, hashlib.sha256(blob).digest()),
        (3, blob, bytes(12) + ripemd),
        (4, blob, blob),
        (5, b"".join(v.to_bytes(32, "big") for v in (32, 32, 32, b, e, m)),
         pow(b, e, m).to_bytes(32, "big")),
        (6, g1_bytes(p1) + g1_bytes(p2), g1_bytes(bn.g1_mul(bn.G1_GEN, a1 + a2))),
        (7, g1_bytes(p1) + k.to_bytes(32, "big"), g1_bytes(bn.g1_mul(bn.G1_GEN, a1 * k % bn.R))),
        (8, pairing_in, (1).to_bytes(32, "big")),
    ]


def precompile_code(cases: list) -> bytes:
    """For each case: CODECOPY its input to memory 0, STATICCALL the
    precompile, store the success flag at slot 0x10 + address and keccak of
    the return data at slot address; then STOP, then the inputs."""
    def push2(v: int) -> bytes:
        return b"\x61" + v.to_bytes(2, "big")

    step = 31
    offset = step * len(cases) + 1
    code, data = b"", b""
    for addr, inp, _ in cases:
        n = len(inp)
        code += (push2(n) + push2(offset + len(data)) + b"\x5f\x39"     # CODECOPY
                 + b"\x5f\x5f" + push2(n) + b"\x5f\x60" + bytes([addr]) + b"\x5a\xfa"
                 + b"\x60" + bytes([0x10 + addr]) + b"\x55"              # flag
                 + b"\x3d\x5f\x5f\x3e\x3d\x5f\x20\x60" + bytes([addr]) + b"\x55")
        data += inp
    assert len(code) == step * len(cases)
    return code + b"\x00" + data


def build_chain(api, seed: int, accounts: int = REEXEC_ACCOUNTS, signers: int = REEXEC_SIGNERS,
                blocks: int = REEXEC_BLOCKS, txs: int = REEXEC_TXS) -> dict:
    """A genesis and `blocks` blocks of `txs` transactions each, all from
    `seed`, built with `api` (`execution_api`). The genesis holds `accounts`
    funded EOAs (the first `signers` with keys), the token contract with a
    balance for each signer, the precompile contract, the withdraw-queue
    predeploy with a nonzero slot 0 and the L1 gas-price oracle with its
    Curie scalars set. Each block holds an L1 message, legacy (EIP-155) and
    EIP-1559 transfers and token transfers; the chain holds one contract
    creation, one reverting token call and the precompile call. Each block
    is sealed by an oracle run over the full trie; its witness is the
    partial trie of the accounts and slots that run read. Returns the
    genesis root, the block witnesses, the oracle's receipts, the precompile
    cases, the oracle's final state and the seconds of each step."""
    import numpy as np

    blk, mpt, rlp, st = api.blk, api.mpt, api.rlp, api.state
    keccak256 = api.keccak.keccak256
    rng = np.random.default_rng([seed, accounts, blocks, txs])
    n_curve = api.curve.SECP256K1.n
    t0 = time.perf_counter()
    keys = [int.from_bytes(rng.bytes(32), "big") % n_curve or 1 for _ in range(signers)]
    senders = [address_of(api, k) for k in keys]
    others = [keccak256(b"eoa" + rng.bytes(8))[12:] for _ in range(accounts - signers)]
    funded = senders + others
    cases = precompile_cases(api, rng, keys[0])
    codes = {}
    trie = mpt.Mpt(mpt.EMPTY_ROOT)

    def put(addr, acct):
        trie.update(mpt.secure_key(addr), acct.rlp())

    def storage_root(slots: dict) -> bytes:
        t = mpt.Mpt(mpt.EMPTY_ROOT, trie.nodes)
        for slot, val in slots.items():
            t.update(mpt.secure_key(slot.to_bytes(32, "big")), rlp.encode_int(val))
        return t.root

    def contract(code: bytes, slots: dict):
        h = keccak256(code)
        codes[h] = code
        return st.Account(nonce=1, code_hash=h, storage_root=storage_root(slots))

    for addr in funded:
        put(addr, st.Account(balance=10**18 + int(rng.integers(1 << 40))))
    put(TOKEN_ADDRESS, contract(token_code(api), {int.from_bytes(a, "big"): 10**6
                                                  for a in senders}))
    put(PRECOMPILES_ADDRESS, contract(precompile_code(cases), {}))
    # the predeploys at nonce 1: an account of storage alone counts as empty,
    # and the first block's flush would delete it from the trie while the
    # next block's re-execution still read its slots from the cache
    put(blk.WITHDRAW_QUEUE_ADDRESS, st.Account(nonce=1, storage_root=storage_root(
        {0: int.from_bytes(rng.bytes(32), "big") | 1})))
    put(blk.L1_GAS_PRICE_ORACLE_ADDRESS,
        st.Account(nonce=1, storage_root=storage_root(ORACLE_SLOTS)))
    genesis_root = trie.root
    genesis_s = time.perf_counter() - t0

    nonces = [0] * signers
    specials = ["create", "precompiles", "revert"]
    witnesses, receipts_by_block = [], []
    seconds = {"genesis_s": genesis_s, "signing_s": 0.0, "sealing_s": 0.0, "witness_s": 0.0}
    parent = rng.bytes(32)
    state_root, nodes = genesis_root, trie.nodes
    for b in range(blocks):
        t0 = time.perf_counter()
        number = 1000 + b
        plan = ["l1"] + [s for i, s in enumerate(specials) if i % blocks == b]
        plan += [("legacy", "eip1559", "token")[i % 3] for i in range(txs - len(plan))]
        block_txs = []
        for j, kind in enumerate(plan):
            if kind == "l1":
                block_txs.append(blk.Tx(tx_type=blk.L1_MSG_TX_TYPE, nonce=b, gas_limit=100_000,
                                        to=funded[int(rng.integers(accounts))], value=0,
                                        data=rng.bytes(8),
                                        sender=keccak256(b"l1" + rng.bytes(8))[12:]))
                continue
            i = (b * txs + j) % signers
            to = (funded[int(rng.integers(accounts))] if rng.integers(4)
                  else keccak256(b"new" + rng.bytes(8))[12:])
            tx = blk.Tx(tx_type=2, nonce=nonces[i], gas_limit=100_000, to=to,
                        value=int(rng.integers(1, 10**9)), data=b"", max_fee=100,
                        max_priority_fee=2, chain_id=REEXEC_CHAIN_ID)
            if kind == "legacy":
                tx = blk.Tx(tx_type=0, nonce=nonces[i], gas_limit=21_000, to=to,
                            value=int(rng.integers(1, 10**9)), data=b"", gas_price=10,
                            chain_id=REEXEC_CHAIN_ID)
            elif kind == "eip1559":
                tx.gas_limit = 21_000
            elif kind in ("token", "revert"):
                amount = 10**30 if kind == "revert" else int(rng.integers(1, 1000))
                tx.to, tx.value = TOKEN_ADDRESS, 0
                tx.data = bytes(12) + to + amount.to_bytes(32, "big")
            elif kind == "create":
                tx.to, tx.value, tx.gas_limit = None, 0, 500_000
                tx.data = deploy_code(token_code(api))
            elif kind == "precompiles":
                tx.to, tx.value, tx.gas_limit = PRECOMPILES_ADDRESS, 0, 1_500_000
            block_txs.append(sign_tx(api, tx, keys[i]))
            # a creation moves the sender's nonce twice: once for the
            # transaction, once for CREATE (as the reference's interpreter does)
            nonces[i] += 2 if kind == "create" else 1
        t1 = time.perf_counter()
        seconds["signing_s"] += t1 - t0

        state = st.WorldState(state_root, dict(nodes), dict(codes))
        ctx = api.blk.BlockCtx(number=number, timestamp=1_700_000_000 + number,
                               coinbase=REEXEC_COINBASE, gas_limit=30_000_000, base_fee=1,
                               chain_id=REEXEC_CHAIN_ID,
                               block_hashes={number - 1: parent})
        receipts, gas = [], 0
        for tx in block_txs:
            receipt, used = blk.execute_tx(state, ctx, tx, gas)
            gas += used
            receipts.append(receipt)
        post_root = state.state_root()
        header = blk.Header(
            parent_hash=parent, coinbase=REEXEC_COINBASE, state_root=post_root,
            transactions_root=blk._ordered_trie_root([t.encode() for t in block_txs]),
            receipts_root=blk._ordered_trie_root([r.encode() for r in receipts]),
            number=number, gas_limit=30_000_000, gas_used=gas,
            timestamp=1_700_000_000 + number, base_fee_per_gas=1)
        t2 = time.perf_counter()
        seconds["sealing_s"] += t2 - t1

        # the witness: every trie path the oracle run read, in the pre-state,
        # and the withdraw root's, which the chunk reads after its last block
        pre = mpt.Mpt(state_root, nodes)
        witness_nodes = {}
        for addr in dict.fromkeys([*state.accounts, blk.WITHDRAW_QUEUE_ADDRESS]):
            for n in pre.collect_path_nodes(mpt.secure_key(addr)):
                witness_nodes[keccak256(n)] = n
        for addr, slot in dict.fromkeys([*state.storage, (blk.WITHDRAW_QUEUE_ADDRESS,
                                                          blk.WITHDRAW_ROOT_SLOT)]):
            raw = pre.get(mpt.secure_key(addr))
            if raw is None:
                continue
            storage = mpt.Mpt(st.Account.from_rlp(raw).storage_root, nodes)
            for n in storage.collect_path_nodes(mpt.secure_key(slot.to_bytes(32, "big"))):
                witness_nodes[keccak256(n)] = n
        receipts_by_block.append(receipts)
        witnesses.append(blk.BlockWitness(header=header, txs=block_txs,
                                          state_nodes=witness_nodes, codes=dict(codes),
                                          chain_id=REEXEC_CHAIN_ID))
        seconds["witness_s"] += time.perf_counter() - t2
        parent, state_root = header.block_hash(), post_root
        nodes, codes = state.trie.nodes, state.codes
    return {"genesis_root": genesis_root, "witnesses": witnesses, "receipts": receipts_by_block,
            "cases": cases, "state": state, "funded": funded, "senders": senders, **seconds}


def precompile_results(api, chain) -> dict:
    """Each precompile's flag and output hash in the final state against the
    host's output."""
    state = chain["state"]
    return {addr: (state.get_storage(PRECOMPILES_ADDRESS, 0x10 + addr) == 1
                   and state.get_storage(PRECOMPILES_ADDRESS, addr)
                   == int.from_bytes(api.keccak.keccak256(out), "big"))
            for addr, _, out in chain["cases"]}


def reexec_task(chunks, chain, tag: str, doc: dict = None):
    """The chunk task of `chain`'s block witnesses at phase 7's version
    (`Version.galileo_v2()`), or of `doc`, its witness JSON, as given."""
    from zkvm_prover_tpu_torch.circuits.chunk_circuit import ChunkCircuit
    from zkvm_prover_tpu_torch.host import ProvingTask
    from zkvm_prover_tpu_torch.types.chunk.witness import ChunkWitness

    if doc is None:
        w = ChunkWitness(version=chunks.version.as_version_byte(), blocks=[],
                         prev_msg_queue_hash=b"\x00" * 32, fork_name=chunks.version.fork,
                         prev_state_root=chain["genesis_root"], chain_id=REEXEC_CHAIN_ID,
                         block_witnesses=chain["witnesses"])
        raw = ChunkCircuit.serialize_witness(w)
    else:
        raw = json.dumps(doc, sort_keys=True).encode()
    return ProvingTask(serialized_witness=[raw], fork_name=chunks.version.fork.value,
                       identifier=f"reexec-{tag}", vk=chunks.prover.get_app_vk())


def reexec_cell(chunks, seed: int) -> dict:
    """Phase 13: a chunk of real transactions. The chain of `build_chain`
    (a 1,024-account genesis, three sealed blocks of 30 transactions) from
    `seed`, with the port's modules; its witnesses in a JSON chunk task at
    phase 7's version through phase 7's Prover with the launch counts zeroed
    just before and read just after: re-execution (timed apart from the
    guest) inside execute, the proof on the card at chain_config(), the
    self-verify; every C call at a checked shape, every counter nonzero.
    The ChunkInfo against the headers, the precompiles' outputs against the
    host, `UniversalVerifier` True; a header's gas_used + 1, a claimed post
    state root that execution contradicts and a signed transaction's
    claimed sender changed to another funded account each raise in execute
    with no launch."""
    import torch

    from zkvm_prover_tpu_torch.circuits.chunk_circuit import ChunkCircuit
    from zkvm_prover_tpu_torch.execution.block import ExecutionError
    from zkvm_prover_tpu_torch.host import UniversalVerifier

    api = execution_api()
    chain = build_chain(api, seed)
    ws = chain["witnesses"]
    n_txs = sum(len(w.txs) for w in ws)
    n_nodes = sum(len(w.state_nodes) for w in ws)
    n_bytes = sum(len(n) for w in ws for n in w.state_nodes.values())
    precompiles = precompile_results(api, chain)
    print(f"[13] chain from seed {seed}: genesis of {REEXEC_ACCOUNTS} funded EOAs in "
          f"{chain['genesis_s']:.2f} s; {len(ws)} blocks, {n_txs} transactions (signed in "
          f"{chain['signing_s']:.2f} s), sealed in {chain['sealing_s']:.2f} s; witnesses of "
          f"{n_nodes} trie nodes, {n_bytes} bytes (collected in {chain['witness_s']:.2f} s); "
          f"precompile outputs equal to the host's: {precompiles}", flush=True)
    if not all(precompiles.values()):
        raise AssertionError(f"a precompile's output differs from the host's: {precompiles}")

    task = reexec_task(chunks, chain, "chunk")
    with timed_calls(ChunkCircuit, "validate", keep=True) as validated:
        env, measured = prove_task("13", chunks.prover, task)
    (run,) = validated
    info, version = run["out"]
    reexec_s = run["s"]
    guest_s = measured["execute_ms"] / 1e3 - reexec_s
    last = ws[-1].header
    checks = {"prev state root": info.prev_state_root == chain["genesis_root"],
              "post state root": info.post_state_root == last.state_root,
              "post block hash": info.post_blockhash == last.block_hash(),
              "transactions": [c.num_txs for c in info.block_ctxs] == [len(w.txs) for w in ws],
              "L1 messages": [c.num_l1_msgs for c in info.block_ctxs] == [1] * len(ws),
              "pi hash": env.user_pvs_proof == info.pi_hash_by_version(version)}
    cfg = chunks.stark
    t0 = time.perf_counter()
    ok = UniversalVerifier("chunk", cfg).verify_stark_proof(env)
    verify_s = time.perf_counter() - t0
    print(f"[13] re-execution {reexec_s:.3f} s, guest (execute less re-execution) "
          f"{guest_s:.3f} s; ChunkInfo checks {checks}; UniversalVerifier: {ok} in "
          f"{verify_s:.3f} s", flush=True)
    if not ok or not all(checks.values()):
        raise AssertionError("the re-executed chunk's phase failed")

    doc = json.loads(task.serialized_witness[0])
    first = doc["block_witnesses"][0]
    signed = next(t for t in first["txs"] if t["tx_type"] != 0x7E)
    other = next(a for a in chain["senders"] if a.hex() != signed["sender"])
    tampers = {"header gas_used + 1": (ExecutionError, "gas_used mismatch"),
               "claimed post state root": (ValueError, "claimed post_state_root"),
               "claimed sender": (ValueError, "claimed sender")}
    report_tampers = {}
    for name, (kind, message) in tampers.items():
        bad = copy.deepcopy(doc)
        if name == "header gas_used + 1":
            bad["block_witnesses"][0]["header"]["gas_used"] += 1
        elif name == "claimed post state root":
            bad["post_state_root"] = ws[0].header.state_root.hex()
        else:
            tx = next(t for t in bad["block_witnesses"][0]["txs"] if t["tx_type"] != 0x7E)
            tx["sender"] = other.hex()
        reset_counts()
        t0 = time.perf_counter()
        raised = None
        try:
            chunks.prover.gen_proof_stark(reexec_task(chunks, chain, name.replace(" ", "-"), bad))
        except kind as e:
            raised = str(e)
        launches = sum(launch_counts().values())
        print(f"[13] {name}: raised {raised!r} in {time.perf_counter() - t0:.3f} s, "
              f"{launches} launches", flush=True)
        if raised is None or message not in raised or launches:
            raise AssertionError(f"the chunk with its {name} changed was not rejected in execute")
        report_tampers[name] = raised
    torch.cuda.empty_cache()
    return {"blocks": len(ws), "transactions": n_txs, "witness_nodes": n_nodes,
            "witness_bytes": n_bytes, **{k: chain[k] for k in (
                "genesis_s", "signing_s", "sealing_s", "witness_s")},
            "reexecution_s": reexec_s, "guest_s": guest_s, **measured,
            "verify_s": verify_s, "checks": checks, "precompiles": precompiles,
            "tampers": report_tampers}


# ---------------------------------------------------------------------------
# phase 14: parallel/ (the sharded core and its parts on a mesh of logical
# shards of the one card; sibling leaf nodes in a spawn pool)
# ---------------------------------------------------------------------------

MESH_SHARDS = 4     # logical shards: cuda:0 four times
POOL_WORKERS = 2    # spawned leaf provers, both on cuda:0
# the aggregation tree's node config: fast_test_config(), not default_config()
# (its internal node re-verifies two leaf proofs in-circuit; at 100 queries
# that wire program alone outgrows the phase's time)
POOL_CHILD_LOG_N = 3


def check_calls(calls, seed: int) -> list:
    """Every distinct C call of `calls` at a shape no check of this run
    covered, run on fresh inputs from the card's generator through the
    wrapper the path calls and held against its plain version: K1
    `ntt_pass` at the call's row pitches and row tables (forward and
    inverse), K2 `hash_rows`, `compress_levels` (one launch of that many
    levels) and `permute`, K3 rows and transposed. The check's calls join
    CHECKED; returns its rows, each with its seconds."""
    import torch

    from zkvm_prover_tpu_torch.fields import babybear as bb
    from zkvm_prover_tpu_torch.ops import mont_matmul as mm
    from zkvm_prover_tpu_torch.ops import ntt_fused
    from zkvm_prover_tpu_torch.ops import poseidon2 as p2

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    todo = {}
    for e, a in calls:
        if call_key(e, a) not in CHECKED["calls"]:
            todo.setdefault(call_key(e, a), a)
    rows = []
    with log_calls() as checked:
        for (entry, shape), a in sorted(todo.items()):
            t0 = time.perf_counter()
            if entry == "ntt_pass":
                ld_x, ld_y, n, w, lo, L, dit = a[1], a[3], a[4], a[5], a[6], a[7], bool(a[8])
                x = random_field(gen, (n, ld_x), dev)[:, :w]
                pre = random_field(gen, (n,), dev) if a[10] is not None else None
                post = random_field(gen, (n,), dev) if a[11] is not None else None
                step, err = max(1, PLAIN_ELEMS // n), 0
                for inverse in (False, True):
                    out = torch.empty((n, ld_y), dtype=bb.DTYPE, device=dev)[:, :w]
                    ntt_fused.ntt_pass(x, lo, L, inverse, dit, pre=pre, post=post, out=out)
                    err = max([err] + [max_err(out[:, c0:c0 + step], ntt_fused.ntt_pass_plain(
                        x[:, c0:c0 + step], lo, L, inverse, dit, pre, post))
                        for c0 in range(0, w, step)])
            elif entry == "p2_hash_rows":
                r_, c_ = a[1], a[2]
                mat = random_field(gen, (r_, c_), dev)
                out = p2.hash_rows(mat)
                step = max(1, PLAIN_ELEMS // max(c_, 16))
                err = max(max_err(out[r0:r0 + step], p2.hash_rows_plain(mat[r0:r0 + step]))
                          for r0 in range(0, r_, step))
            elif entry == "p2_compress":
                digests = random_field(gen, (a[1], 8), dev)
                err = max(max_err(u, v) for u, v in zip(
                    p2.compress_levels(digests, a[2]), p2.compress_levels_plain(digests, a[2])))
            elif entry in PERMUTE_WIDTHS:
                states = random_field(gen, (a[2], PERMUTE_WIDTHS[entry]), dev)
                err = max_err(p2.permute(states), p2.permute_plain(states))
            else:
                transpose = entry == "mont_matmul_cols"
                r_, c_, k = a[2], a[3], a[4]
                lhs = random_field(gen, (r_, c_), dev)
                rhs = random_field(gen, (r_ if transpose else c_, 4 * k), dev)
                err = max_err(mm.mont_matmul(lhs, rhs, transpose),
                              mm.mont_matmul_plain(lhs, rhs, transpose))
            rows.append({"entry": entry, "shape": shape, "max_abs_err": err,
                         "s": time.perf_counter() - t0})
            if err != 0:
                raise AssertionError(f"{entry} {shape} disagrees with its plain version")
    CHECKED["calls"].update(call_key(e, a) for e, a in checked)
    missed = sorted(set(todo) - CHECKED["calls"])
    if missed:
        raise AssertionError(f"the checks did not reproduce the C calls {missed}")
    torch.cuda.empty_cache()
    return rows


def sharded_core_cell(trace, log_n: int, seed: int, mesh) -> dict:
    """Phase 14 (a): `make_prover_core` on the card and
    `make_prover_core_sharded` over the mesh, at default_config() on phase
    3's Poseidon2Air trace and three challenges from --seed. Each core runs
    once (cold) to collect its C calls; the shapes new to the run are
    checked against their plain versions; then it runs again with the
    launch counts zeroed just before and read just after (wall-clock, peak
    memory, launches per kernel; every C call at a checked shape, every
    counter but the grind's nonzero). The four outputs must be equal bit
    for bit."""
    import numpy as np
    import torch

    from zkvm_prover_tpu_torch.fields import babybear as bb
    from zkvm_prover_tpu_torch.models.poseidon2_air import Poseidon2Air
    from zkvm_prover_tpu_torch.parallel.mesh import Sharded
    from zkvm_prover_tpu_torch.parallel.pipeline_sharded import make_prover_core_sharded
    from zkvm_prover_tpu_torch.stark.config import default_config
    from zkvm_prover_tpu_torch.stark.pipeline import make_prover_core

    cfg, air = default_config(), Poseidon2Air()
    rng = np.random.default_rng(seed)
    challenges = [bb.to_monty_np(rng.integers(0, bb.P, size=4, dtype=np.uint64))
                  for _ in range(3)]
    trace_m = bb.to_monty(bb.as_tensor(trace, "cuda"))
    cores = {"core": make_prover_core(air, log_n, cfg),
             "sharded_core": make_prover_core_sharded(air, log_n, cfg, mesh)}
    report, outs = {}, {}
    for name, core in cores.items():
        torch.cuda.synchronize()
        with log_calls() as first:
            t0 = time.perf_counter()
            core(trace_m, [], *challenges)
            torch.cuda.synchronize()
            cold_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        checks = check_calls(first, seed)
        check_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with log_calls() as used:
            t0 = time.perf_counter()
            out = core(trace_m, [], *challenges)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        unchecked_calls(used, name)
        missing = [k for k, v in counts.items() if v == 0 and k != "poseidon2_permute"]
        if missing:
            raise AssertionError(f"kernels not launched by the {name}: {missing}")
        outs[name] = [bb.to_numpy(o.gather() if isinstance(o, Sharded) else o) for o in out]
        del out
        print(f"[14] {name}: {wall_s:.3f} s (cold {cold_s:.3f} s), peak {peak} bytes; "
              f"{len(checks)} new C call shapes exact against their plain versions in "
              f"{check_s:.1f} s; launches {counts}", flush=True)
        report[name] = {"wall_s": wall_s, "cold_s": cold_s, "peak_bytes": peak,
                        "launches": counts, "shape_checks": checks, "shape_check_s": check_s,
                        "distinct_calls": len(set(call_key(e, a) for e, a in used))}
        torch.cuda.empty_cache()
    names = ("trace_root", "quotient_root", "codeword", "folded")
    for what, a, b in zip(names, outs["core"], outs["sharded_core"]):
        if a.shape != b.shape or not np.array_equal(a, b):
            raise AssertionError(f"the sharded core's {what} differs from make_prover_core's")
    print(f"[14] sharded core over {mesh.shape['shard']} shards of cuda:0 equals "
          f"make_prover_core bit for bit in {', '.join(names)} "
          f"({', '.join(str(tuple(o.shape)) for o in outs['core'])})", flush=True)
    return report


def sharded_parts_cell(seed: int, mesh) -> list:
    """Phase 14 (b): each sharded part on the mesh against its
    single-device function, on the card's random inputs: the four-step NTT
    at (2^20, 8) and (2^22, 2), `commit_root_sharded` at (2^19, 495),
    `fold_round_sharded` at 2^20 rows; C call shapes new to the run checked
    against their plain versions first; each side timed (CUDA events)."""
    import torch

    from zkvm_prover_tpu_torch.fields import babybear as bb
    from zkvm_prover_tpu_torch.ops import ntt
    from zkvm_prover_tpu_torch.parallel.fri_sharded import fold_round_sharded
    from zkvm_prover_tpu_torch.parallel.merkle_sharded import commit_root_sharded
    from zkvm_prover_tpu_torch.parallel.ntt_sharded import ntt_natural_to_rev_sharded
    from zkvm_prover_tpu_torch.stark import fri, merkle

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = []

    def part(name, shape, sharded, single):
        t0 = time.perf_counter()
        with log_calls() as calls:
            got, want = sharded(), single()
        checks = check_calls(calls, seed)
        equal = bool(got.shape == want.shape and torch.equal(got, want))
        row = {"name": name, "shape": shape, "equal": equal,
               "sharded_ms": time_ms(sharded), "single_ms": time_ms(single),
               "new_shapes_checked": len(checks), "s": time.perf_counter() - t0}
        rows.append(row)
        print(f"[14] {name} {shape}: sharded == single-device: {equal}; sharded "
              f"{row['sharded_ms']:.3f} ms, single {row['single_ms']:.3f} ms (events); "
              f"{len(checks)} new C call shapes checked", flush=True)
        if not equal:
            raise AssertionError(f"sharded {name} {shape} differs from its single-device function")

    for log_n, w in ((20, 8), (22, 2)):
        x = random_field(gen, (1 << log_n, w), dev)
        part("ntt_natural_to_rev", f"(2^{log_n},{w})",
             lambda: ntt_natural_to_rev_sharded(x, mesh).gather(),
             lambda: ntt.ntt_natural_to_rev(x))
        del x
    mat = random_field(gen, (1 << 19, 495), dev)
    part("commit_root", "(2^19,495)", lambda: commit_root_sharded(mat, mesh),
         lambda: merkle.commit([mat]).root)
    del mat
    cw, beta = random_field(gen, (1 << 20, 4), dev), random_field(gen, (4,), dev)
    part("fold_round", "(2^20,4)",
         lambda: fold_round_sharded(cw, 20, bb.GENERATOR, beta, mesh).gather(),
         lambda: fri.fold_round(cw, 20, bb.GENERATOR, beta))
    torch.cuda.empty_cache()
    return rows


def pool_cell(seed: int) -> dict:
    """Phase 14 (c): two fibonacci children (log_n 3) from
    `Prover.gen_proof_stark` on the card; the child slot and one leaf
    program built here (their C calls' new shapes checked); one leaf node
    over the two children proved serially here with the launch counts
    zeroed just before; then
    `RecursiveAggregationProver(..., AggregationTreeConfig(num_children_leaf=2))
    .aggregate([p1, p2, p1, p2], workers=2)` with its device None: the two
    leaf nodes proved by two spawned workers on cuda:0, the root (an
    internal node over both) here. Each worker zeroes its own counters at
    the start of its task and reports its launches (building its slot and
    program, then proving) and its C calls: every call must be at a checked
    shape, and each worker's proving launches must equal the serial leaf's,
    every counter nonzero. The pool path's launches are the workers' own,
    summed. Each pooled leaf must be byte-equal to the serial one, the root
    must verify and its digest must be the node digest over the two leaves.
    Shapes new to the run are checked before each proof in this process
    (`in_circuit_probes`)."""
    import torch

    from zkvm_prover_tpu_torch.host import Prover, ProverConfig, ProvingTask, serialization
    from zkvm_prover_tpu_torch.host.app import get_app
    from zkvm_prover_tpu_torch.models.fibonacci import FibonacciAir
    from zkvm_prover_tpu_torch.recursion import aggregation as agg
    from zkvm_prover_tpu_torch.stark.config import fast_test_config

    cfg = fast_test_config()
    children_prover = Prover(ProverConfig("fibonacci", stark=cfg))
    with log_calls() as used, in_circuit_probes(used, seed):
        envs = [children_prover.gen_proof_stark(ProvingTask(
            identifier=f"pool-child-{i}", serialized_witness=[json.dumps(
                {"log_n": POOL_CHILD_LOG_N, "x0": 0, "x1": i + 1}).encode()]))
            for i in range(2)]
    unchecked_calls(used, "pool child")
    kids = [serialization.decode_machine_proof(e.proof) for e in envs]
    with log_calls() as setup_used:
        slot = agg.ChildSlot([FibonacciAir()], [POOL_CHILD_LOG_N], cfg)
        prog = agg.AggNodeProgram(agg.TAG_LEAF, [slot, slot], cfg)
    check_calls(setup_used, seed)
    torch.cuda.synchronize()
    reset_counts()
    with log_calls() as used, in_circuit_probes(used, seed) as probes:
        t0 = time.perf_counter()
        leaf_proof, _ = prog.prove(kids)
        torch.cuda.synchronize()
        serial_s = time.perf_counter() - t0 - probes["shape_check_s"]
    leaf_counts = launch_counts()
    unchecked_calls(used, "serial leaf")
    missing = [k for k, v in leaf_counts.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched by the serial leaf: {missing}")
    leaf_bytes = serialization.encode_machine_proof(leaf_proof)

    tree = agg.RecursiveAggregationProver(
        slot, cfg, agg.AggregationTreeConfig(num_children_leaf=POOL_WORKERS))
    with log_calls() as used, in_circuit_probes(used, seed) as probes, \
            timed_calls(agg, "_prove_leaf_nodes_pool") as pooled:
        t0 = time.perf_counter()
        levels = tree.aggregate([kids[0], kids[1], kids[0], kids[1]], workers=POOL_WORKERS,
                                app_vk=get_app("fibonacci").vk_bytes())
        torch.cuda.synchronize()
        tree_s = time.perf_counter() - t0 - probes["shape_check_s"]
    unchecked_calls(used, "aggregation root")
    leaves, root = levels[0], levels[-1][0]
    equal = [serialization.encode_machine_proof(l.proof) == leaf_bytes for l in leaves]
    t0 = time.perf_counter()
    root_ok = root.program.verify(root.proof, expected_digest=root.pi_hash)
    verify_s = time.perf_counter() - t0
    want = agg.digest_bytes(agg.node_digest_words(agg.TAG_INTERNAL, [
        (s.vk_words, [v for (_, _, p) in l.proof.meta for v in p])
        for s, l in zip(root.program.slots, leaves)]))
    pool_counts = {k: 0 for k in leaf_counts}
    for i, l in enumerate(leaves):
        stray = {e for e, _ in l.stat["calls"]} - set(ENTRY_SHAPES) - {"p2_set_constants"}
        if stray:
            raise AssertionError(f"pool worker {i} called entries off the STARK path: {stray}")
        unchecked_calls([c for c in l.stat["calls"] if c[0] in ENTRY_SHAPES],
                        f"pool worker {i}")
        if l.stat["launches"] != leaf_counts:
            raise AssertionError(f"pool worker {i} launched {l.stat['launches']} proving its "
                                 f"leaf, the serial leaf {leaf_counts}")
        for k in pool_counts:
            pool_counts[k] += l.stat["setup_launches"][k] + l.stat["launches"][k]
    pool_s = pooled[0]["s"]
    print(f"[14] pool ({card_line()}): leaf level {pool_s:.3f} s in {POOL_WORKERS} spawned "
          f"workers on cuda:0 (spawn, CUDA start and library load included) against "
          f"{serial_s:.3f} s for one leaf proved here; whole tree {tree_s:.3f} s with the "
          f"root here; leaves byte-equal to the serial leaf: {equal}; root verifies: "
          f"{root_ok} in {verify_s:.3f} s; root digest = digest over the two leaves: "
          f"{root.pi_hash == want}; serial leaf launches {leaf_counts}; each worker's "
          f"proving launches equal them, its {len(leaves[0].stat['calls'])} C calls at checked "
          f"shapes; the pool's launches (both workers, slot and program builds included) "
          f"{pool_counts}", flush=True)
    if len(leaves) != POOL_WORKERS or not all(equal) or not root_ok or root.pi_hash != want \
            or len(levels) != 2:
        raise AssertionError("the pooled aggregation tree phase failed")
    torch.cuda.empty_cache()
    return {"node_config": "fast_test_config", "child_log_n": POOL_CHILD_LOG_N,
            "workers": POOL_WORKERS, "pool_leaf_level_s": pool_s, "serial_leaf_s": serial_s,
            "tree_s": tree_s, "root_verify_s": verify_s, "leaf_proof_bytes": len(leaf_bytes),
            "launches": leaf_counts, "pool_launches": pool_counts,
            "worker_setup_launches": [l.stat["setup_launches"] for l in leaves],
            "root_airs": probes.get("airs")}


def parallel_cell(trace, log_n: int, seed: int) -> dict:
    """Phase 14: the sharded core, the sharded parts and the leaf pool."""
    import torch

    from zkvm_prover_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(MESH_SHARDS, devices=[torch.device("cuda", 0)] * MESH_SHARDS)
    t0 = time.perf_counter()
    cores = sharded_core_cell(trace, log_n, seed, mesh)
    t1 = time.perf_counter()
    parts = sharded_parts_cell(seed + 1, mesh)
    t2 = time.perf_counter()
    pool = pool_cell(seed + 2)
    t3 = time.perf_counter()
    print(f"[14] cores {t1 - t0:.1f} s, parts {t2 - t1:.1f} s, pool {t3 - t2:.1f} s", flush=True)
    return {"card": card_line(), "mesh": f"{MESH_SHARDS} x cuda:0", **cores, "parts": parts,
            "pool": pool, "split_s": {"cores": t1 - t0, "parts": t2 - t1, "pool": t3 - t2}}


# phase 15: the width-24 Poseidon2 kernel, and the rv32 v1 chipset at its
# largest run (5 * 4096 < 2^16: timestamp differences are 16-bit
# range-checked, so `rv32_v1.execute_and_trace` stops at 4,096 cycles)
P2_WIDE_BATCH = 1 << 18
P2_WIDE_SOURCE = "zkvm_prover_tpu_torch/csrc/poseidon2.cu"
P2_WIDE_REPLACES = "zkvm_prover_tpu/ops/poseidon2.py:182"
# launch counter -> (kernel instance, Montgomery products a permutation):
# the standard diagonal by shifts leaves the S-boxes' 8*24*4 + 21*4; any
# installed diagonal by products adds 21*24
P2_WIDE_KERNELS = {"poseidon2_permute24": ("permute24_kernel<true>", 852),
                   "poseidon2_permute24_general": ("permute24_kernel<false>",
                                                   MODMULS_PER_PERM24)}
P2_NARROW_KERNELS = ("permute_kernel", "hash_rows_kernel", "compress_kernel")
V1_FIB_ITERS = 799            # 3 + 5 * 799 + 2 = 4,000 cycles
V1_RAM_WORDS = 400            # 4 + 10 * 400 + 4 = 4,008 cycles
V1_DATA = 0x1000


def permute24_cell(seed: int, resources: dict) -> dict:
    """Phase 15 (a): `ops.poseidon2.permute` on (2^18, 24) states from
    `seed`, once for each kernel instance with the counts zeroed (one launch
    of that instance's counter, no other): the shift instance under the
    derived constants, the general one under the derived round constants
    and a diagonal from `seed`; each against its plain version, timed, and
    its bound from its own products. Registers, SASS instructions and wide
    multiplies (`resources`, phase 1's `kernel_resources`) and spills
    (ptxas) of both instances and of the three width-16 kernels; a spill
    fails."""
    import numpy as np
    import torch

    from zkvm_prover_tpu_torch import _build, kernel_report
    from zkvm_prover_tpu_torch.fields import babybear as bb
    from zkvm_prover_tpu_torch.ops import poseidon2 as p2

    ptxas = kernel_report.ptxas_resources(_build.ptxas_log())
    kernels = {}
    for name in (*(k for k, _ in P2_WIDE_KERNELS.values()), *P2_NARROW_KERNELS):
        row = {**resources.get(name, {}), "ptxas": ptxas.get(name, {})}
        if row["ptxas"].get("spill_stores", 1) or row["ptxas"].get("spill_loads", 1):
            raise AssertionError(f"{name} spills or was not reported: {row}")
        kernels[name] = row
        print(f"[15] {name:24s} registers {row.get('registers')}, SASS {row.get('instructions')}, "
              f"wide multiplies {row.get('wide_muls')}; ptxas {row['ptxas']}", flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    states = random_field(gen, (P2_WIDE_BATCH, 24), dev)
    ext, internal, _ = (bb.from_monty_np(t) for t in p2.constants(24))
    rows = []
    nbytes = P2_WIDE_BATCH * 24 * 4 * 2
    saved = dict(p2._OVERRIDES)
    try:
        for counter, (kernel, modmuls) in P2_WIDE_KERNELS.items():
            if kernel.endswith("<false>"):
                p2.load_constants(24, ext, internal,
                                  np.random.default_rng(seed).integers(0, bb.P, 24))
            torch.cuda.synchronize()
            reset_counts()
            with log_calls() as used:
                out = p2.permute(states)
                torch.cuda.synchronize()
            launched = p2.launches_w24[counter]
            others = {k: v for k, v in {**launch_counts(), **p2.launches_w24}.items()
                      if v and k != counter}
            entries = [e for e, _ in used]
            if launched != 1 or others or entries != ["p2_permute24"]:
                raise AssertionError(f"permute on (2^18, 24) launched {launched} of {counter}, "
                                     f"{others}, {entries}")
            err = max_err(out, p2.permute_plain(states))
            ms = time_ms(lambda: p2.permute(states), reps=20)
            plain_ms = time_ms(lambda: p2.permute_plain(states), reps=1, warmup=False)
            b_ms, b_by = bound_ms(nbytes, P2_WIDE_BATCH * modmuls * MULS_PER_MODMUL)
            print(f"[15] {counter} ({P2_WIDE_BATCH},24) err={err} ms={ms:.4f} "
                  f"plain_ms={plain_ms:.3f} bound_ms={b_ms:.4f} ({b_by}, {modmuls} products "
                  f"a permutation); launches {launched}", flush=True)
            if err != 0:
                raise AssertionError(f"{counter} disagrees with its plain version")
            rows.append({"name": counter, "route": "cuda", "source": P2_WIDE_SOURCE,
                         "replaces": P2_WIDE_REPLACES, "shape": f"({P2_WIDE_BATCH},24)",
                         "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                         "bound_by": b_by, "library_ms": None, "bytes": nbytes,
                         "launches": launched, "kernel": kernel, "modmuls": modmuls})
            p2.reset_constants()
            p2._OVERRIDES.update(saved)
    finally:
        p2.reset_constants()
        p2._OVERRIDES.update(saved)
    del states, out
    return {"instances": rows, "kernels": kernels}


def v1_programs() -> dict:
    """Phase 15 (b)'s programs, with the registers each must end with."""
    from zkvm_prover_tpu_torch.vm import asm

    fib = asm.assemble([
        asm.addi("s0", "zero", 0),
        asm.addi("s1", "zero", 1),
        asm.addi("t0", "zero", V1_FIB_ITERS),
        ("label", "loop"),
        asm.add("t1", "s0", "s1"),
        asm.add("s0", "s1", "zero"),
        asm.add("s1", "t1", "zero"),
        asm.addi("t0", "t0", -1),
        ("branch", asm.bne, "t0", "zero", "loop"),
        asm.halt(0),
    ])
    a, b = 0, 1
    for _ in range(V1_FIB_ITERS):
        a, b = b, (a + b) % (1 << 32)
    # word i of the array holds 1 + 7 i; the second loop loads and sums them
    ram = asm.assemble([
        asm.lui("s2", V1_DATA >> 12),
        asm.addi("t0", "zero", 1),
        asm.addi("t1", "zero", 0),
        asm.addi("t2", "zero", 4 * V1_RAM_WORDS),
        ("label", "fill"),
        asm.add("t6", "s2", "t1"),
        asm.sw("t0", "t6", 0),
        asm.addi("t0", "t0", 7),
        asm.addi("t1", "t1", 4),
        ("branch", asm.bne, "t1", "t2", "fill"),
        asm.addi("s0", "zero", 0),
        asm.addi("t1", "zero", 0),
        ("label", "sum"),
        asm.add("t6", "s2", "t1"),
        asm.lw("t3", "t6", 0),
        asm.add("s0", "s0", "t3"),
        asm.addi("t1", "t1", 4),
        ("branch", asm.bne, "t1", "t2", "sum"),
        asm.halt(0),
    ])
    return {"fib_loop": (fib, {"s0": a}),
            "array_sum": (ram, {"s0": sum(1 + 7 * i for i in range(V1_RAM_WORDS))})}


def v1_cell(seed: int) -> dict:
    """Phase 15 (b): each of `v1_programs()` executed by the native
    executor and traced by `models/rv32_v1.py`, its registers checked,
    then `checked_machine_proof` at default_config() with a tampered
    claimed sum."""
    from zkvm_prover_tpu_torch.models import rv32_v1
    from zkvm_prover_tpu_torch.vm import asm, executor

    executor.build_native()
    out = {}
    for k, (name, (words, regs)) in enumerate(v1_programs().items()):
        t0 = time.perf_counter()
        ex, state, air_traces = rv32_v1.execute_and_trace(words)
        tracegen_s = time.perf_counter() - t0
        got = {r: ex.get_reg(asm.REGS[r]) for r in regs}
        cycles = int(air_traces[0][1][:, rv32_v1.CpuAirV1.IS_REAL].sum())
        print(f"[15] rv32 v1 {name}: {len(words)} words, {cycles} cycles, executed and traced "
              f"in {tracegen_s:.2f} s; registers {got} (want {regs})", flush=True)
        if state != executor.HALTED or got != regs:
            raise AssertionError(f"the v1 {name} program did not halt with {regs}")
        triples = [(a, t, []) for a, t in air_traces]
        cells = print_airs(triples)
        res = checked_machine_proof(f"15 {name}", triples, seed + k,
                                    tamper=("claimed sum", tampered_claimed_sum))
        out[name] = {"words": len(words), "cycles": cycles, "tracegen_s": tracegen_s,
                     "trace_cells": cells, "registers": got,
                     "airs": [[type(a).__name__, list(t.shape)] for a, t in air_traces], **res}
    out["launches"] = {key: sum(out[n]["launches"][key] for n in ("fib_loop", "array_sum"))
                       for key in out["fib_loop"]["launches"]}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log-n", type=int, default=18,
                    help="log2 of the main path's trace height")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="build/chip_smoke.json")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    from zkvm_prover_tpu_torch import _build, kernel_report
    from zkvm_prover_tpu_torch.ops import ntt_fused
    from zkvm_prover_tpu_torch.models.poseidon2_air import NUM_COLS, Poseidon2Air
    from zkvm_prover_tpu_torch.stark import prover, verifier
    from zkvm_prover_tpu_torch.stark.config import default_config, fast_test_config

    t_all = time.perf_counter()
    report = {"log_n": args.log_n, "seed": args.seed, "phase_s": {}}
    t_phase = [t_all]

    def phase_done(n: int) -> None:
        now = time.perf_counter()
        report["phase_s"][n] = now - t_phase[0]
        t_phase[0] = now
        print(f"[{n}] phase {n} took {report['phase_s'][n]:.1f} s", flush=True)

    # 1. card and build
    card = card_line()
    print(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    t0 = time.perf_counter()
    _build.lib()
    report["build_s"] = time.perf_counter() - t0
    report["card"] = card
    print(f"[1] kernels built and loaded in {report['build_s']:.1f} s", flush=True)
    probe_dir = str(_build.BUILD_DIR / "probe")
    report["sass_per_op"] = kernel_report.op_counts(str(_build.CSRC), probe_dir)
    for op, row in report["sass_per_op"].items():
        print(f"[1] SASS per bb::{op}: {row['instructions']:g} {row['opcodes']}")
    report["kernel_resources"] = kernel_report.kernel_resources(str(_build.build()))
    for name, row in report["kernel_resources"].items():
        print(f"[1] {name:24s} {row}")
    if any(row.get("calls") for name, row in report["kernel_resources"].items()
           if name.startswith("mm_")):
        raise AssertionError("a K3 kernel calls a routine (a 64-bit division?)")
    report["pipe_rates"] = kernel_report.pipe_rates(probe_dir)
    for row in report["pipe_rates"]:
        print(f"[1] {row['op']:16s} {row['per_clock_per_sm']:7.2f} per clock per SM "
              f"{row['sass']}", flush=True)

    phase_done(1)

    # 2. kernels against their plain versions
    print("[2] kernels vs plain torch on the card; tolerance 0 (exact modular "
          "arithmetic: any mismatch fails)", flush=True)
    rows = check_kernels(args.log_n, NUM_COLS, args.seed)
    report["kernel_checks"] = rows
    phase_done(2)

    # 3. the main path
    t0 = time.perf_counter()
    trace = poseidon2_trace(args.log_n, args.seed)
    report["trace_gen_s"] = time.perf_counter() - t0
    print(f"[3] Poseidon2Air trace {trace.shape} generated in "
          f"{report['trace_gen_s']:.1f} s", flush=True)
    air = Poseidon2Air()
    cfg = default_config()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    proof = prover.prove(air, trace, [], cfg)
    torch.cuda.synchronize()
    prove_s = time.perf_counter() - t0
    counts = launch_counts()
    n_transforms = sum(ntt_fused.transforms.values())
    peak = torch.cuda.max_memory_allocated()
    print(f"[3] proved in {prove_s:.3f} s, peak {peak / 2**30:.2f} GiB", flush=True)
    for key, val in proof.stat.items():
        if key.endswith("_ms"):
            print(f"      {key:24s} {val:10.1f}")
    print(f"[3] launches: {counts}", flush=True)
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    print(f"[3] K1: {counts['ntt_pass']} launches for {n_transforms} transforms "
          f"({ntt_fused.transforms})", flush=True)
    if args.log_n <= 2 * ntt_fused.K_MAX and counts["ntt_pass"] > 2 * n_transforms:
        raise AssertionError("a transform took more than 2 K1 launches")
    # K3: one rows call reads the trace for both DEEP sums, one the quotient
    # chunks; one transposed call reads c_rev for both OOD points, one each
    # quotient chunk (a transposed call is two launches)
    k3_rows, k3_cols = counts["mont_matmul_rows"], counts["mont_matmul_cols"] // 2
    print(f"[3] K3: {k3_rows} rows launches, {k3_cols} transposed calls", flush=True)
    if k3_rows > 2 or k3_cols > 3:
        raise AssertionError("K3 read a matrix more than once per opened point set")
    t0 = time.perf_counter()
    ok = verifier.verify(air, proof, cfg)
    verify_s = time.perf_counter() - t0
    bad = copy.deepcopy(proof)
    bad.opened_trace_zeta[0, 0] ^= 1
    rejected = not verifier.verify(air, bad, cfg)
    print(f"[3] verify: {ok} in {verify_s:.3f} s; tampered opening rejected: "
          f"{rejected}", flush=True)
    if not ok or not rejected:
        raise AssertionError("verification phase failed")
    report.update(prove_s=prove_s, verify_s=verify_s, peak_bytes=peak,
                  phases_ms={k: v for k, v in proof.stat.items() if k.endswith("_ms")},
                  launches=counts, transforms=dict(ntt_fused.transforms))
    del proof, bad

    # the same proof again in this process (warm), then once more profiled
    t0 = time.perf_counter()
    warm = prover.prove(air, trace, [], cfg)
    torch.cuda.synchronize()
    report["warm_prove_s"] = time.perf_counter() - t0
    report["warm_phases_ms"] = {k: v for k, v in warm.stat.items() if k.endswith("_ms")}
    print(f"[3] warm proof in {report['warm_prove_s']:.3f} s: "
          + ", ".join(f"{k[:-3]} {v:.1f}" for k, v in report["warm_phases_ms"].items()),
          flush=True)
    del warm
    trace_path = os.path.join(os.path.dirname(args.out) or ".", "chip_smoke_trace.json")
    prof = profile_proof(lambda: prover.prove(air, trace, [], cfg), trace_path)
    report["profile"] = prof
    print(f"[3] profiled proof: window {prof['window_ms']:.1f} ms, device busy "
          f"{prof['device_busy_ms']:.1f} ms, idle share {prof['idle_share']:.4f}")
    for name, row in prof["per_kernel"].items():
        print(f"      {name:30s} launches {row['launches']:6d}  device ms {row['ms']:9.3f}")
    print(f"[3] per shape (matched to the C calls: {prof['shapes_matched']}):")
    for row in prof["per_shape"]:
        print(f"      {row['kernel']:24s} {row['shape']:26s} launches {row['launches']:4d}"
              f"  device ms {row['ms']:8.3f}")
    print("[3] device work in the LDE (proof start to the first row hash):")
    for name, row in prof["lde_window"].items():
        print(f"      {name:60s} launches {row['launches']:4d}  device ms {row['ms']:8.3f}")
    k3 = {k: r for k, r in prof["per_kernel"].items() if k.startswith("mm_")}
    print(f"[3] K3 device ms per proof: {sum(r['ms'] for r in k3.values()):.3f} "
          f"({ {k: r['launches'] for k, r in k3.items()} } launches)", flush=True)
    if (sum(r["launches"] for k, r in k3.items() if k.startswith("mm_rows")) > 2
            or sum(r["launches"] for k, r in k3.items()
                   if k.startswith("mm_cols_kernel")) > 3):
        raise AssertionError("too many K3 launches in the profiled proof")
    plain_lde = sum(r["ms"] for k, r in prof["lde_window"].items()
                    if k.startswith("plain torch"))
    print(f"[3] plain torch device ms in the LDE: {plain_lde:.3f}", flush=True)
    per_tree = prof["compress_launches_per_tree"]
    print(f"[3] compress launches per Merkle tree: {per_tree}", flush=True)
    if not per_tree or max(per_tree) > 3:
        raise AssertionError("a Merkle tree took more than 3 compress launches")
    torch.cuda.empty_cache()
    phase_done(3)

    # 4. the machine cell, on the same Poseidon2 inputs
    report["machine"] = machine_cell(trace, args.log_n, args.seed,
                                     os.path.dirname(args.out) or ".")
    torch.cuda.empty_cache()
    phase_done(4)

    # 5. cross-device identity
    small = poseidon2_trace(10, args.seed + 1)
    p_cuda = prover.prove(air, small, [], fast_test_config(), device="cuda")
    p_cpu = prover.prove(air, small, [], fast_test_config(), device="cpu")
    proofs_equal(p_cuda, p_cpu)
    if not verifier.verify(air, p_cuda, fast_test_config()):
        raise AssertionError("2^10 proof does not verify")
    print("[5] 2^10-row proofs on cuda and cpu are identical", flush=True)
    small_machine_cuda_equals_cpu(args.seed + 2)
    print("[5] small machine proofs (4 AIRs, 3 heights, a logUp bus) on cuda and cpu "
          "are identical", flush=True)
    fibonacci_envelope_cuda_equals_cpu()
    print("[5] fibonacci envelopes from Prover.gen_proof_stark on cuda and cpu are identical",
          flush=True)
    phase_done(5)

    # 6. the rv32 machine path
    report["rv32"] = rv32_cell(args.seed + 3)
    phase_done(6)

    # 7. the host entry point
    report["chunk"], chunks = chunk_cell(args.seed + 4)
    phase_done(7)

    # 8. the batch and bundle layers over chunk 0
    report["chain"], bundles, bundle_task = chain_cell(chunks, args.seed + 5)
    phase_done(8)

    # 9. the ext guest: ECDSA verify and every other extension syscall
    report["ecdsa"] = ecdsa_cell(args.seed + 6)
    phase_done(9)

    # 10. deferred aggregation over two fibonacci children
    report["deferred"] = deferred_cell(args.seed + 7)
    phase_done(10)

    # 11. continuations: phase 6's guest in two segments
    report["continuations"] = continuation_cell(args.seed + 8, report["rv32"]["public_values"])
    phase_done(11)

    # 12. the SNARK wrapper over phase 8's bundle
    report["snark"] = snark_cell(bundles, bundle_task, args.seed + 9)
    phase_done(12)

    # 13. a chunk of real transactions, re-executed and proved through phase
    # 7's Prover
    report["reexec"] = reexec_cell(chunks, args.seed + 10)
    phase_done(13)

    # 14. parallel/: the sharded core on phase 3's trace, the sharded parts,
    # the leaf pool
    report["parallel"] = parallel_cell(trace, args.log_n, args.seed + 11)
    del trace
    phase_done(14)

    # 15. the width-24 permutation, and the rv32 v1 chipset at full size
    report["permute24"] = permute24_cell(args.seed + 12, report["kernel_resources"])
    report["rv32_v1"] = v1_cell(args.seed + 13)
    phase_done(15)

    # 16. the kernels line: per kernel, its largest main-path shape; launches
    # summed over the fifteen STARK paths (single-AIR proof, machine cell,
    # rv32, chunk, batch, bundle, ext guest, deferred aggregation,
    # continuations, the re-executed chunk, the prover core, the sharded
    # core, the serial leaf, the pooled leaf level counted by its workers,
    # the two v1 programs), then the width-24 permutation, which only its
    # own call of phase 15 launches, and K4's three entries, which only the
    # SNARK path launches
    kernels = {}
    for row in rows:
        best = kernels.get(row["name"])
        if best is None or row["bytes"] > best["bytes"]:
            kernels[row["name"]] = row
    line = []
    for name, row in kernels.items():
        entry = {key: row[key] for key in (
            "name", "route", "source", "replaces")}
        by_path = {"single_air": counts[row["counter"]],
                   "machine": report["machine"]["launches"][row["counter"]],
                   "rv32": report["rv32"]["launches"][row["counter"]],
                   "chunk": report["chunk"]["launches"][row["counter"]],
                   "batch": report["chain"]["batch"]["launches"][row["counter"]],
                   "bundle": report["chain"]["bundle"]["launches"][row["counter"]],
                   "ecdsa": report["ecdsa"]["launches"][row["counter"]],
                   "deferred": report["deferred"]["launches"][row["counter"]],
                   "continuations": report["continuations"]["launches"][row["counter"]],
                   "reexec": report["reexec"]["launches"][row["counter"]],
                   "core": report["parallel"]["core"]["launches"][row["counter"]],
                   "sharded_core": report["parallel"]["sharded_core"]["launches"][row["counter"]],
                   "leaf": report["parallel"]["pool"]["launches"][row["counter"]],
                   "pool": report["parallel"]["pool"]["pool_launches"][row["counter"]],
                   "rv32_v1": report["rv32_v1"]["launches"][row["counter"]],
                   "permute24": 0, "snark": 0}
        entry.update(launches=sum(by_path.values()), launches_by_path=by_path,
                     max_abs_err=max(r["max_abs_err"] for r in rows if r["name"] == name),
                     ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                     bound_by=row["bound_by"], library_ms=None,
                     shape=row["shape"], bytes=row["bytes"])
        line.append(entry)
    for wide in report["permute24"]["instances"]:
        line.append({**{key: wide[key] for key in (
            "name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "shape", "bytes")},
            "launches_by_path": {"permute24": wide["launches"]}})
    path = report["snark"]["msm_path"][0]
    checks = [report["snark"]["msm_edge_cases"], *report["snark"]["msm_path"]]
    for name, step in path["steps"].items():
        launched = report["snark"]["launches"][name]
        line.append({"name": name, "route": "cuda", "source": K4_SOURCE,
                     "replaces": K4_REPLACES[name], "launches": launched,
                     "launches_by_path": {"snark": launched},
                     "max_abs_err": max(c["steps"][name]["max_abs_err"] for c in checks),
                     "ms": step["ms"], "plain_ms": step["plain_ms"], "bound_ms": step["bound_ms"],
                     "bound_by": step["bound_by"], "library_ms": None,
                     "shape": f"n={path['n']} c={path['c']} W={path['windows']} m={path['m']}",
                     "fq_products": path["fq_products"][name]})
    report["total_s"] = time.perf_counter() - t_all
    print(f"[16] seconds by phase: "
          + ", ".join(f"{n}: {t:.1f}" for n, t in report["phase_s"].items())
          + f"; total {report['total_s']:.1f} s", flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"kernels": line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
