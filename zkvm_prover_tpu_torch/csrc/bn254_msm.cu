// Pippenger MSM over BN254 G1 (kernel K4): sum_i s_i P_i for affine P_i.
//
// Replaces: the XLA code of zkvm_prover_tpu/ops/msm.py, `window_buckets`
// (:171, one jax.jit over the sorted digits at :201) with `pt_add` (:81) and
// `pt_double` (:62) on ops/bigint.py's Fq (`Field.mul/add/sub`, :166, :73,
// :118), and `_weighted_bucket_sum` (:261): the commitments of the BN254
// SNARK wrapper. No function of the reference reaches pl.pallas_call here.
//
// The caller splits each scalar into W windows of c bits, sorts each
// window's point indices by digit and lists the live entries of all windows
// in (window, digit) order: the point index `idx` and the bucket
// `key` = w 2^c + digit of each, the digit-0 heads and the points at
// infinity left out (ops/msm.py::chunk_plan, torch). Then:
//   msm_chunks_kernel: thread t sums the chunk [t m, t m + m) of that list
//     with madd, one run of equal keys after the other. A run that both
//     starts and ends inside the chunk is a whole bucket: it is written to
//     the bucket array. A run that a chunk edge cuts is a piece: the
//     chunk's first run goes to slot 2t, its last to slot 2t + 1 (a run
//     cut at both edges takes slot 2t and leaves infinity in 2t + 1). The
//     plan gives each slot's bucket, -1 for an empty slot, so that every
//     bucket's pieces lie side by side.
//   msm_reduce_kernel: one CTA per tile of 128 slots sums each bucket's
//     slots in the tile by a tree in shared memory (log2 of the run's
//     length levels, one add each). A run inside the tile is a whole
//     bucket and is written; a run the tile's edge cuts becomes a piece of
//     the next level, under the same slot rule. The host launches levels
//     until one tile holds the rest (3 levels for 2^17 pieces).
//   msm_window_sums_kernel: per window sum_k k B_k. S leaves of L buckets
//     (thread s: A_s = sum_j j B_{sL+j}, T_s = sum_j B_{sL+j} by the
//     top-down running sum), then a tree over the leaves in shared memory
//     whose node holds A, V = sum_s (s - first) T_s and D = size * T:
//     V = V_l + V_r + D_r and D = 2 (D_l + D_r) on two warp groups, so a
//     level costs two or three point operations; sum_k k B_k = A + L V.
//     One CTA of S <= 512 leaves a window (c = 10: S = 512, L = 2).
// The host combines the W window sums (sum_w 2^(c w) S_w), as the reference
// does (msm.py:303-310).
//
// Bound: the Fq products (CIOS, 8 limbs: 128 32x32->64 multiplies, each an
// IMAD and an IMAD.HI, on the multiply pipe); the points and buckets are a
// few MB. A product is one serial carry chain, so a thread's point
// operation takes microseconds and the kernels are set by how many chains
// run at once and by the longest chain of dependent point operations:
//   - load balance: a chunk holds m points whatever their digits (at
//     least 8, at most one chunk per resident thread: 512 an SM;
//     ops/msm.py::chunk_size), so one bucket of thousands of points (a
//     selector polynomial's MSM, or the top window of uniform scalars) is
//     summed by hundreds of threads and a tree of log2(n / m) levels, not
//     walked by one thread;
//   - gather: the next point and the index after it are fetched into
//     registers while the current madd runs;
//   - critical path of the window sum: about L + 3 log2(S) + log2(L)
//     point operations (2c at L = 1; c = 10 takes L = 2, S = 512, one CTA
//     a window), not the 2L + 3S + log2(L) of one CTA of S = 2^(c/2)
//     threads that thread 0 joins serially.
// Every sum is deterministic: no atomics, the same tree for the same plan.
//
// Layouts (uint32 words): points (n, 16) = Montgomery x, y of each affine
// point, (0, 0) for infinity; buckets (W, 2^c, 24), pieces (slots, 24) and
// sums (W, 24) = Jacobian Montgomery (X, Y, Z), Z = 0 at infinity.

#include "bn254.cuh"

namespace {

constexpr int CHUNK_THREADS = 128;
constexpr int CHUNK_MIN_BLOCKS = 4;  // at most 128 registers: 512 threads an SM
constexpr int TILE = 128;            // slots a CTA of msm_reduce_kernel sums
constexpr int TILE_MIN_BLOCKS = 4;
constexpr int SUM_THREADS = 512;     // leaves a CTA of msm_window_sums_kernel takes
constexpr int NODE = 72;             // words of a tree node: A, V, D

__device__ __forceinline__ void store_infinity(uint32_t* p) {
#pragma unroll
  for (int i = 0; i < 24; ++i) p[i] = 0;
}

__device__ __forceinline__ void load_affine(bn::Fq& x, bn::Fq& y, const uint32_t* __restrict__ points,
                                            int32_t i) {
  const uint32_t* p = points + 16 * static_cast<int64_t>(i);
  bn::load(x, p);
  bn::load(y, p + 8);
}

// Where a finished run's sum goes: the chunk's (or tile's) head slot if the
// run is its first and began earlier, else its tail slot if the run is its
// last and goes on later, else its bucket.
__device__ __forceinline__ void emit(const bn::Pt& acc, int32_t key, bool first, bool last,
                                     bool head, bool tail, int64_t t, uint32_t* pieces,
                                     uint32_t* buckets) {
  if (first && head) {
    bn::store(pieces + 24 * (2 * t), acc);
    if (last && tail) store_infinity(pieces + 24 * (2 * t + 1));
  } else if (last && tail) {
    bn::store(pieces + 24 * (2 * t + 1), acc);
  } else {
    bn::store(buckets + 24 * static_cast<int64_t>(key), acc);
  }
}

__global__ void __launch_bounds__(CHUNK_THREADS, CHUNK_MIN_BLOCKS)
    msm_chunks_kernel(const uint32_t* __restrict__ points, const int32_t* __restrict__ idx,
                      const int32_t* __restrict__ key, int64_t live, int m,
                      const int32_t* __restrict__ piece_key, uint32_t* __restrict__ pieces,
                      uint32_t* __restrict__ buckets) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t j0 = t * m;
  if (j0 >= live) return;
  const int64_t j1 = j0 + m < live ? j0 + m : live;
  const bool head = piece_key[2 * t] >= 0;
  const bool tail = piece_key[2 * t + 1] >= 0;
  bn::Pt acc;
  bn::set_infinity(acc);
  bool first = true;
  int32_t cur = key[j0];
  // register double buffer: point j + 1 and index j + 2 are in flight
  // while point j is added
  bn::Fq nx, ny;
  int32_t nk = cur, ni2 = 0, nk2 = 0;
  load_affine(nx, ny, points, idx[j0]);
  if (j0 + 1 < j1) {
    ni2 = idx[j0 + 1];
    nk2 = key[j0 + 1];
  }
  for (int64_t j = j0; j < j1; ++j) {
    const bn::Fq x = nx, y = ny;
    const int32_t k = nk;
    if (j + 1 < j1) {
      load_affine(nx, ny, points, ni2);
      nk = nk2;
      if (j + 2 < j1) {
        ni2 = idx[j + 2];
        nk2 = key[j + 2];
      }
    }
    if (k != cur) {
      emit(acc, cur, first, false, head, tail, t, pieces, buckets);
      bn::set_infinity(acc);
      first = false;
      cur = k;
    }
    if (!(bn::is_zero(x) && bn::is_zero(y))) bn::pt_add_affine(acc, acc, x, y);
  }
  emit(acc, cur, first, true, head, tail, t, pieces, buckets);
}

__global__ void __launch_bounds__(TILE, TILE_MIN_BLOCKS)
    msm_reduce_kernel(const uint32_t* __restrict__ in, const int32_t* __restrict__ in_key,
                      int64_t len, uint32_t* __restrict__ out, int32_t* __restrict__ out_key,
                      uint32_t* __restrict__ buckets) {
  __shared__ uint32_t sp[TILE * 24];
  __shared__ int32_t sk[TILE];
  __shared__ int32_t rs[TILE];
  const int i = threadIdx.x;
  const int64_t tile = blockIdx.x;
  const int64_t b0 = tile * TILE;
  const int n = len - b0 < TILE ? static_cast<int>(len - b0) : TILE;
  const int32_t k = i < n ? in_key[b0 + i] : -1;
  sk[i] = k;
  if (k >= 0) {
#pragma unroll
    for (int w = 0; w < 24; ++w) sp[24 * i + w] = in[24 * (b0 + i) + w];
  }
  __syncthreads();
  // the start of each run in the tile: an inclusive max-scan of run heads
  rs[i] = k >= 0 && (i == 0 || sk[i - 1] != k) ? i : -1;
  __syncthreads();
  for (int d = 1; d < TILE; d <<= 1) {
    const int v = i >= d ? rs[i - d] : -1;
    __syncthreads();
    if (v > rs[i]) rs[i] = v;
    __syncthreads();
  }
  const int rank = i - rs[i];
  // the tree: at distance d, rank 0 mod 2d adds rank + d of its run
  for (int d = 1; d < n; d <<= 1) {
    if (k >= 0 && (rank & (2 * d - 1)) == 0 && i + d < n && sk[i + d] == k) {
      bn::Pt a, b;
      bn::load(a, sp + 24 * i);
      bn::load(b, sp + 24 * (i + d));
      bn::pt_add(a, a, b);
      bn::store(sp + 24 * i, a);
    }
    __syncthreads();
  }
  const bool head = sk[0] >= 0 && b0 > 0 && in_key[b0 - 1] == sk[0];
  const bool tail = sk[n - 1] >= 0 && b0 + n < len && in_key[b0 + n] == sk[n - 1];
  if (i == 0) {
    out_key[2 * tile] = head ? sk[0] : -1;
    out_key[2 * tile + 1] = tail ? sk[n - 1] : -1;
  }
  if (k >= 0 && rank == 0) {
    bn::Pt acc;
    bn::load(acc, sp + 24 * i);
    emit(acc, k, i == 0, sk[n - 1] == k, head, tail, tile, out, buckets);
  }
}

// The window-sum tree over the block's nodes in shared memory, a level at
// a time: nodes 2hq and 2hq + h merge into 2hq. Threads [0, S/2) take V of
// merge q = t, threads [S/2, S) take D and A of merge q = t - S/2, so that
// from 64 leaves on a warp runs one path. One call site per point
// operation (loops not unrolled) keeps the kernel's code small.
__device__ void tree(uint32_t* node, int t) {
  const int count = blockDim.x, half = count >> 1;
  const bool v_job = t < half;
  const int q = v_job ? t : t - half;
  for (int h = 1; h < count; h <<= 1) {
    if (q < count / (2 * h)) {
      uint32_t* l = node + NODE * (2 * h * q);
      const uint32_t* r = l + NODE * h;
      bn::Pt a, b;
      // V: a = V_l, += V_r, += D_r. D then A: a = D_l, += D_r, doubled;
      // a = A_l, += A_r.
#pragma unroll 1
      for (int k = 0; k < 2; ++k) {
        const int dst = v_job ? 24 : (k == 0 ? 48 : 0);
        if (k == 0 || !v_job) bn::load(a, l + dst);
        bn::load(b, r + (v_job ? (k == 0 ? 24 : 48) : dst));
        bn::pt_add(a, a, b);
        if (!v_job && k == 0) bn::pt_dbl(a, a);
        if (k == 1 || !v_job) bn::store(l + dst, a);
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(SUM_THREADS, 1)
    msm_window_sums_kernel(const uint32_t* __restrict__ buckets, int nb, int log_l,
                           uint32_t* __restrict__ sums) {
  extern __shared__ uint32_t node[];  // blockDim.x nodes
  const int w = blockIdx.x;
  const int s = threadIdx.x;
  const int L = 1 << log_l;
  const uint32_t* b = buckets + 24 * (static_cast<int64_t>(w) * nb + static_cast<int64_t>(s) * L);
  bn::Pt run, acc, bk;
  bn::set_infinity(run);
  bn::set_infinity(acc);
  for (int j = L - 1; j >= 0; --j) {
    bn::pt_add(acc, acc, run);
    bn::load(bk, b + 24 * j);
    bn::pt_add(run, run, bk);
  }
  uint32_t* me = node + NODE * s;
  bn::store(me, acc);       // A
  store_infinity(me + 24);  // V
  bn::store(me + 48, run);  // D = 1 * T
  __syncthreads();
  tree(node, s);
  if (s != 0) return;
  // sum_k k B_k = A + L V
  bn::load(run, node + 24);
  for (int i = 0; i < log_l; ++i) bn::pt_dbl(run, run);
  bn::load(acc, node);
  bn::pt_add(run, run, acc);
  bn::store(sums + 24 * static_cast<int64_t>(w), run);
}

__global__ void fq_mul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                              int64_t n, uint32_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  bn::Fq x, y, r;
  bn::load(x, a + 8 * i);
  bn::load(y, b + 8 * i);
  bn::mul(r, x, y);
  bn::store(out + 8 * i, r);
}

}  // namespace

// Chunk partials: the chunks of m entries of (idx, key) (`live` of them),
// piece_key (2 * chunks) from the plan; writes the pieces (2 * chunks, 24)
// and every bucket a chunk holds whole into buckets (W, 2^c, 24).
extern "C" int bn254_msm_chunks(const uint32_t* points, const int32_t* idx, const int32_t* key,
                                int64_t live, int m, const int32_t* piece_key, uint32_t* pieces,
                                uint32_t* buckets, void* stream) {
  if (live < 1 || m < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t chunks = (live + m - 1) / m;
  const unsigned blocks = static_cast<unsigned>((chunks + CHUNK_THREADS - 1) / CHUNK_THREADS);
  msm_chunks_kernel<<<blocks, CHUNK_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      points, idx, key, live, m, piece_key, pieces, buckets);
  return static_cast<int>(cudaGetLastError());
}

// One reduction level: pieces `in` (len, 24) with their buckets in_key
// (-1: empty) -> the next level's pieces out (2 * tiles, 24) and out_key
// (2 * tiles), every bucket a tile holds whole written into buckets; tiles =
// ceil(len / 128), and at one tile every bucket is written.
extern "C" int bn254_msm_reduce(const uint32_t* in, const int32_t* in_key, int64_t len,
                                uint32_t* out, int32_t* out_key, uint32_t* buckets,
                                void* stream) {
  if (len < 1) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned tiles = static_cast<unsigned>((len + TILE - 1) / TILE);
  msm_reduce_kernel<<<tiles, TILE, 0, static_cast<cudaStream_t>(stream)>>>(
      in, in_key, len, out, out_key, buckets);
  return static_cast<int>(cudaGetLastError());
}

// sums (W, 24) from buckets (W, 2^c, 24): 2^log_s leaves of 2^(c - log_s)
// buckets a window, one CTA a window; 1 <= c <= 16, 0 <= log_s <= min(c, 9).
extern "C" int bn254_msm_window_sums(const uint32_t* buckets, int W, int c, int log_s,
                                     uint32_t* sums, void* stream) {
  if (c < 1 || c > 16 || W < 1 || log_s < 0 || log_s > c || (1 << log_s) > SUM_THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  // above 48 KB of dynamic shared memory (512 nodes: 147,456 bytes) a
  // kernel must be allowed it first
  const int S = 1 << log_s;
  const size_t shared = static_cast<size_t>(S) * NODE * sizeof(uint32_t);
  const cudaError_t err = cudaFuncSetAttribute(
      msm_window_sums_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shared));
  if (err != cudaSuccess) return static_cast<int>(err);
  msm_window_sums_kernel<<<W, S, shared, static_cast<cudaStream_t>(stream)>>>(buckets, 1 << c,
                                                                            c - log_s, sums);
  return static_cast<int>(cudaGetLastError());
}

// out (n, 8) = a * b * 2^-256 mod q elementwise (the Fq core alone, for tests).
extern "C" int bn254_fq_mul(const uint32_t* a, const uint32_t* b, int64_t n, uint32_t* out,
                            void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((n + 255) / 256);
  fq_mul_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(a, b, n, out);
  return static_cast<int>(cudaGetLastError());
}
