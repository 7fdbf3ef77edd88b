// Exact base-by-extension products over BabyBear (kernel K3), for k = 1 or 2
// extension right-hand sides side by side (BW = 4k words in a row of B and
// of out):
//   rows: out[r, e] = (sum_c A[r, c] * B[c, e]) * 2^-32 mod p,  A (R, C), B (C, BW)
//   cols: out[c, e] = (sum_r A[r, c] * B[r, e]) * 2^-32 mod p,  A (R, C), B (R, BW)
// Montgomery in and out: the sum of the Montgomery products the reference
// forms one by one, canonical, so bit-identical to any exact reduction.
//
// Replaces: the XLA code of zkvm_prover_tpu/ops/ntt.py
// `eval_poly_at_point_ext` ((W, n) @ (n, 4), the out-of-domain openings:
// cols) and of stark/prover.py `_deep_combine` (its column sums, (m, w) @
// (w, 4) per opened point: rows), which materialise an (m, w, 4) product and
// field_sum it; torch.matmul has no int64 on the card. With k = 2 one read of
// A serves both opened points (zeta and zeta * g_H).
//
// Bound: device-memory bytes (A read once). The 32x32->64 products (4k per
// element of A, IMAD.WIDE at half the IMAD rate) come close at k = 2, so each
// costs one IMAD.WIDE.U32 and nothing else: four products chain into one
// 64-bit word (4 p^2 < 2^64), which a 3-op carry chain adds into a 96-bit
// accumulator (bb::Acc96), and one redc-based reduction ends each sum. There
// is no 64-bit division and no per-product compare. On an H100 (PERF.md) the
// k = 2 kernels still run at 55-60% of the bytes bound: the products alone
// fill the multiply pipe for about 80% of it, and the broadcasts of B's rows
// from shared memory take issue slots beside them.
//
// mm_rows_kernel: a CTA takes MR_ROWS rows of A, one thread a row, and
// double-buffers chunks of 32 columns of them (4-byte cp.async: at odd C rows
// start only 4-byte aligned; odd shared pitch; ragged edge zero-filled) with
// the matching rows of B (16-byte cp.async) in shared memory. A thread's
// reads of its row are conflict-free, and the warp reads B's rows as
// broadcasts. Narrow widths stage 4, 8 or 16 columns: no lane idles.
// mm_cols_kernel: a CTA takes cp columns (32, or 16 when C <= 16) and a
// chunk of rows, and streams it through shared memory in tiles (4-byte
// cp.async, a warp reading 128-byte row segments; the tile's rows of B by
// 16-byte cp.async), two tiles in flight while one is summed; each thread
// sums 8 rows of one column per tile, and the CTA adds its threads' reduced
// sums in shared memory into one partial per (chunk, column, e);
// mm_cols_finish adds the partials of each output.

#include "babybear.cuh"

namespace {

constexpr int MR_ROWS = 64;             // rows of A per CTA in mm_rows_kernel
constexpr int MR_CHUNK = 32;            // columns of A staged per step
constexpr int MR_PITCH = MR_CHUNK + 1;  // odd: thread t's row starts in bank t
static_assert(2 * MR_CHUNK <= MR_ROWS, "one 16-byte quarter of B a thread at k = 2");
constexpr int MC_THREADS = 256;         // threads per CTA in mm_cols_kernel
constexpr int MC_LG_TILE = 11;          // 2^11 words of A per staged tile: 8 a thread
constexpr int MC_TILE = 1 << MC_LG_TILE;
constexpr int MC_STAGES = 3;            // tiles in shared memory (2 in flight)
constexpr int MC_MIN_LG_CP = 4;         // at least 16 columns a CTA: B's tile
                                        // (MC_TILE / cp rows) stays small
static_assert((MC_TILE >> MC_MIN_LG_CP) * 2 <= MC_THREADS, "one B quarter a thread");

__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t* dst, const uint32_t* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src)
               : "memory");
}

// log2 of the staged width of chunk k: its columns rounded up to 4, 8, 16, 32.
__device__ __forceinline__ int chunk_lg(int C, int k) {
  const int need = min(MR_CHUNK, C - k * MR_CHUNK);
  return need <= 4 ? 2 : need <= 8 ? 3 : need <= 16 ? 4 : 5;
}

// Columns [c0, c0 + 2^LG) of the CTA's rows into `tile` (row r at
// r * MR_PITCH) and rows [c0, c0 + 2^LG) of B into `bt`, as one cp.async
// group; words past either matrix become 0. Thread t stages column
// t % 2^LG of rows t / 2^LG + i * DR: a warp reads whole row segments, and
// the addresses advance by adds (a 64-bit index product would take the
// multiply pipe that the sums need).
template <int K, int LG>
__device__ __forceinline__ void stage_rows(uint32_t* tile, uint32_t* bt,
                                           const uint32_t* A, const uint32_t* B,
                                           int64_t R, int C, int64_t row0, int c0) {
  constexpr int W = 1 << LG, DR = MR_ROWS >> LG;
  const int col = c0 + (threadIdx.x & (W - 1));
  const int64_t row = row0 + (threadIdx.x >> LG);
  const uint32_t* src = A + row * C + col;
  const int64_t step = static_cast<int64_t>(DR) * C;
  uint32_t* dst = tile + (threadIdx.x >> LG) * MR_PITCH + (threadIdx.x & (W - 1));
  if (row0 + MR_ROWS <= R && c0 + W <= C) {  // a whole tile: nothing to check
#pragma unroll 8
    for (int i = 0; i < W; ++i, src += step) cp_async4(dst + i * DR * MR_PITCH, src);
  } else {
#pragma unroll 4
    for (int i = 0; i < W; ++i, src += step) {
      if (row + i * DR < R && col < C)
        cp_async4(dst + i * DR * MR_PITCH, src);
      else
        dst[i * DR * MR_PITCH] = 0u;
    }
  }
  if (threadIdx.x < (K << LG)) {  // one 16-byte quarter of a row of B each
    uint32_t* d = bt + threadIdx.x * 4;
    if (c0 + static_cast<int>(threadIdx.x) / K < C)
      cp_async16(d, B + static_cast<int64_t>(c0) * 4 * K + threadIdx.x * 4);
    else
      d[0] = d[1] = d[2] = d[3] = 0u;
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int K>
__device__ __forceinline__ void stage_rows_lg(int lg, uint32_t* tile, uint32_t* bt,
                                              const uint32_t* A, const uint32_t* B,
                                              int64_t R, int C, int64_t row0, int c0) {
  switch (lg) {
    case 5: stage_rows<K, 5>(tile, bt, A, B, R, C, row0, c0); break;
    case 4: stage_rows<K, 4>(tile, bt, A, B, R, C, row0, c0); break;
    case 3: stage_rows<K, 3>(tile, bt, A, B, R, C, row0, c0); break;
    default: stage_rows<K, 2>(tile, bt, A, B, R, C, row0, c0); break;
  }
}

// acc[e] += sum_j a[j] * b[j][e] over 4 terms: one IMAD.WIDE per product.
template <int K>
__device__ __forceinline__ void mac4(bb::Acc96 (&acc)[4 * K], const uint32_t* a,
                                     const uint4 (*b)[K]) {
  uint64_t t[4 * K];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const uint32_t bw[4] = {b[j][q].x, b[j][q].y, b[j][q].z, b[j][q].w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        t[4 * q + i] = bb::mad_wide(a[j], bw[i], j ? t[4 * q + i] : 0ull);
    }
  }
#pragma unroll
  for (int e = 0; e < 4 * K; ++e) acc[e].add(t[e]);
}

// The staged chunk, 4G columns: the thread's row against 4G rows of B.
template <int K, int G>
__device__ __forceinline__ void rows_chunk(bb::Acc96 (&acc)[4 * K], const uint32_t* row,
                                           const uint32_t* bt) {
  const uint4* b4 = reinterpret_cast<const uint4*>(bt);
#pragma unroll
  for (int g = 0; g < G; ++g) {
    uint32_t a[4];
    uint4 b[4][K];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a[j] = row[4 * g + j];
#pragma unroll
      for (int q = 0; q < K; ++q) b[j][q] = b4[(4 * g + j) * K + q];
    }
    mac4<K>(acc, a, b);
  }
}

template <int K>
__global__ void __launch_bounds__(MR_ROWS)
mm_rows_kernel(const uint32_t* __restrict__ A, const uint32_t* __restrict__ B,
               int64_t R, int C, uint32_t* __restrict__ out) {
  __shared__ uint32_t tiles[2][MR_ROWS * MR_PITCH];
  __shared__ __align__(16) uint32_t bts[2][MR_CHUNK * 4 * K];
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * MR_ROWS;
  const int n_chunks = (C + MR_CHUNK - 1) / MR_CHUNK;
  stage_rows_lg<K>(chunk_lg(C, 0), tiles[0], bts[0], A, B, R, C, row0, 0);
  bb::Acc96 acc[4 * K];
  for (int k = 0; k < n_chunks; ++k) {
    if (k + 1 < n_chunks) {
      // buffer (k+1)&1 was last read in step k-1, which ended in a barrier
      stage_rows_lg<K>(chunk_lg(C, k + 1), tiles[(k + 1) & 1], bts[(k + 1) & 1], A, B,
                       R, C, row0, (k + 1) * MR_CHUNK);
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();
    const uint32_t* row = tiles[k & 1] + threadIdx.x * MR_PITCH;
    switch (chunk_lg(C, k)) {
      case 5: rows_chunk<K, 8>(acc, row, bts[k & 1]); break;
      case 4: rows_chunk<K, 4>(acc, row, bts[k & 1]); break;
      case 3: rows_chunk<K, 2>(acc, row, bts[k & 1]); break;
      default: rows_chunk<K, 1>(acc, row, bts[k & 1]); break;
    }
    __syncthreads();
  }
  const int64_t r = row0 + threadIdx.x;
  if (r < R) {
    uint4* dst = reinterpret_cast<uint4*>(out + r * 4 * K);
#pragma unroll
    for (int q = 0; q < K; ++q)
      dst[q] = make_uint4(acc[4 * q].mont(), acc[4 * q + 1].mont(),
                          acc[4 * q + 2].mont(), acc[4 * q + 3].mont());
  }
}

// Rows [rt, rt + MC_TILE / cp) of the CTA's cp columns into `at` (row i at
// i * cp) and the same rows of B into `bt`, as one cp.async group; rows past
// r1 and columns past C become 0. Thread t stages word t + 256 i.
template <int K>
__device__ __forceinline__ void stage_cols(uint32_t* at, uint32_t* bt,
                                           const uint32_t* A, const uint32_t* B,
                                           int C, int lg_cp, int c0, int64_t rt,
                                           int64_t r1) {
  constexpr int PER = MC_TILE / MC_THREADS;  // words of A a thread stages
  const int dr = MC_THREADS >> lg_cp;
  const int col = c0 + (threadIdx.x & ((1 << lg_cp) - 1));
  const int64_t row = rt + (threadIdx.x >> lg_cp);
  const uint32_t* src = A + row * C + col;
  const int64_t step = static_cast<int64_t>(dr) * C;
  uint32_t* dst = at + threadIdx.x;
  if (rt + (dr * PER) <= r1) {  // all the tile's rows exist: check the column once
    if (col < C) {
#pragma unroll
      for (int i = 0; i < PER; ++i, src += step) cp_async4(dst + i * MC_THREADS, src);
    } else {
#pragma unroll
      for (int i = 0; i < PER; ++i) dst[i * MC_THREADS] = 0u;
    }
  } else {
#pragma unroll
    for (int i = 0; i < PER; ++i, src += step) {
      if (row + i * dr < r1 && col < C)
        cp_async4(dst + i * MC_THREADS, src);
      else
        dst[i * MC_THREADS] = 0u;
    }
  }
  // B: one 16-byte quarter of one of the tile's rows each ((MC_TILE / cp) * K
  // quarters, at most MC_THREADS)
  if (threadIdx.x < ((MC_TILE >> lg_cp) * K)) {
    uint32_t* d = bt + threadIdx.x * 4;
    if (rt + threadIdx.x / K < r1)
      cp_async16(d, B + rt * 4 * K + threadIdx.x * 4);
    else
      d[0] = d[1] = d[2] = d[3] = 0u;
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// partial[chunk, col, e] = (sum over the chunk's rows of A[row, col] B[row, e])
// * 2^-32 mod p. The chunk goes through shared memory in tiles of
// MC_TILE / cp rows, MC_STAGES - 1 of them in flight; thread t takes column
// t % cp and rows t / cp + i * 256 / cp of each tile (MC_TILE / 256 of them).
template <int K>
__global__ void __launch_bounds__(MC_THREADS, 3)  // 3 CTAs an SM: <= 85 registers
mm_cols_kernel(const uint32_t* __restrict__ A, const uint32_t* __restrict__ B,
               int64_t R, int C, int lg_cp, int64_t chunk_rows,
               uint32_t* __restrict__ partial) {
  constexpr int BW = 4 * K;
  __shared__ uint32_t ats[MC_STAGES][MC_TILE];
  __shared__ __align__(16) uint32_t bts[MC_STAGES][(MC_TILE >> MC_MIN_LG_CP) * BW];
  __shared__ uint32_t red[BW][MC_THREADS];
  const int cp = 1 << lg_cp, dr = MC_THREADS >> lg_cp, tr = MC_TILE >> lg_cp;
  const int c0 = blockIdx.x * cp;
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * chunk_rows;
  const int64_t r1 = (r0 + chunk_rows < R) ? r0 + chunk_rows : R;
  // a shift, not a division by a variable (a called routine in 64 bits)
  const int n_tiles = static_cast<int>((r1 - r0 + tr - 1) >> (MC_LG_TILE - lg_cp));
#pragma unroll
  for (int t = 0; t < MC_STAGES - 1; ++t) {
    if (t < n_tiles)
      stage_cols<K>(ats[t], bts[t], A, B, C, lg_cp, c0, r0 + t * tr, r1);
    else
      asm volatile("cp.async.commit_group;" ::: "memory");
  }
  const int sub = threadIdx.x >> lg_cp;
  bb::Acc96 acc[BW];
  for (int t = 0; t < n_tiles; ++t) {
    // buffer (t-1) % MC_STAGES was last read in step t-1, which ended in a barrier
    const int nt = t + MC_STAGES - 1;
    if (nt < n_tiles)
      stage_cols<K>(ats[nt % MC_STAGES], bts[nt % MC_STAGES], A, B, C, lg_cp, c0,
                    r0 + static_cast<int64_t>(nt) * tr, r1);
    else
      asm volatile("cp.async.commit_group;" ::: "memory");  // keeps the count
    asm volatile("cp.async.wait_group %0;" ::"n"(MC_STAGES - 1) : "memory");
    __syncthreads();
    const uint32_t* at = ats[t % MC_STAGES];
    const uint4* bt4 = reinterpret_cast<const uint4*>(bts[t % MC_STAGES]);
#pragma unroll
    for (int h = 0; h < MC_TILE / MC_THREADS; h += 4) {
      uint32_t a[4];
      uint4 b[4][K];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        a[j] = at[threadIdx.x + (h + j) * MC_THREADS];
#pragma unroll
        for (int q = 0; q < K; ++q) b[j][q] = bt4[(sub + (h + j) * dr) * K + q];
      }
      mac4<K>(acc, a, b);
    }
    __syncthreads();
  }
#pragma unroll
  for (int e = 0; e < BW; ++e) red[e][threadIdx.x] = acc[e].mont();
  __syncthreads();
  if (threadIdx.x < (BW << lg_cp)) {
    const int e = threadIdx.x >> lg_cp, lc = threadIdx.x & (cp - 1);
    const int c = c0 + lc;
    if (c < C) {
      uint64_t s = 0;  // below 256 p
      for (int i = lc; i < MC_THREADS; i += cp) s += red[e][i];
      partial[(static_cast<int64_t>(blockIdx.y) * C + c) * BW + e] = bb::mod_p(s);
    }
  }
}

// out[t] = sum over chunks of partial[chunk, t] mod p, t < n = C * BW.
__global__ void mm_cols_finish(const uint32_t* __restrict__ partial, int chunks,
                               int n, uint32_t* __restrict__ out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  uint64_t s = 0;  // below chunks * p < p * 2^32
  for (int k = 0; k < chunks; ++k) s += partial[static_cast<int64_t>(k) * n + t];
  out[t] = bb::mod_p(s);
}

}  // namespace

// out (R, 4k) = A (R, C) @ B (C, 4k), k in {1, 2}; R, C >= 1.
extern "C" int mont_matmul_rows(const uint32_t* A, const uint32_t* B, int64_t R,
                                int C, int k, uint32_t* out, void* stream) {
  const unsigned blocks = static_cast<unsigned>((R + MR_ROWS - 1) / MR_ROWS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == 1)
    mm_rows_kernel<1><<<blocks, MR_ROWS, 0, s>>>(A, B, R, C, out);
  else if (k == 2)
    mm_rows_kernel<2><<<blocks, MR_ROWS, 0, s>>>(A, B, R, C, out);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// out (C, 4k) = A (R, C)^T @ B (R, 4k), k in {1, 2}; R, C >= 1. partial
// holds chunks * C * 4k words, chunks = ceil(R / chunk_rows) <= 65535.
extern "C" int mont_matmul_cols(const uint32_t* A, const uint32_t* B, int64_t R,
                                int C, int k, int64_t chunk_rows, uint32_t* partial,
                                uint32_t* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int lg_cp = C > 16 ? 5 : MC_MIN_LG_CP;  // columns per CTA: 32 or 16
  const int chunks = static_cast<int>((R + chunk_rows - 1) / chunk_rows);
  dim3 grid((C + (1 << lg_cp) - 1) >> lg_cp, chunks);
  if (k == 1)
    mm_cols_kernel<1><<<grid, MC_THREADS, 0, s>>>(A, B, R, C, lg_cp, chunk_rows, partial);
  else if (k == 2)
    mm_cols_kernel<2><<<grid, MC_THREADS, 0, s>>>(A, B, R, C, lg_cp, chunk_rows, partial);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n = C * 4 * k;
  mm_cols_finish<<<(n + 255) / 256, 256, 0, s>>>(partial, chunks, n, out);
  return static_cast<int>(cudaGetLastError());
}
