// Poseidon2 over BabyBear: the width-16 permutation, row sponge and Merkle
// compression, and the width-24 permutation.
//
// Replaces: zkvm_prover_tpu/ops/poseidon2.py `permute` (widths 16 and 24),
// `hash_rows` and `compress`, and the level loop of stark/merkle.py
// `_commit_levels`: the XLA code behind every Merkle leaf layer and level,
// and the proof-of-work nonce batch (stark/challenger.py `grind`).
//
// Bound: the wide integer multiplies. One permutation is 772 Montgomery
// products (8 external rounds x 16 lanes x 4 for the x^7 S-box, 13 internal
// rounds x (4 + 16 for the diagonal)) against 64 bytes in and 32 out, and
// on Hopper each product's two 32x32->64 halves (IMAD.WIDE, IMAD.HI) issue
// at a quarter of the ALU rate on the one multiply pipe. So that pipe, not
// memory, is the limit.
//
// Design, shared core (`permute`): one state per thread, the 16 lanes in
// registers; round constants and the internal diagonal are run-time data in
// __constant__ memory (one broadcast per warp-uniform read), copied in by
// `p2_set_constants` at first use and after `load_constants`. The core keeps
// the multiply pipe for the products: each product is the signed Montgomery
// form of babybear.cuh (one ALU op besides the three multiplies); the round
// constant add before an S-box is one 3-input add into (-p, p), which the
// signed product takes as it is; x^7 = (x^2)^2 * (x^2 * x), depth 3; only
// the S-box and diagonal outputs are made canonical, with an add-and-min.
// The internal round sums lanes 1..15 as a tree while lane 0 goes through
// its S-box. The sums of the external layer are issued as IMAD a*1+b
// (`add_mp`): the ALU pipe carries the reductions and the internal layer,
// and the split measured fastest on the card.
//
// Width 24 (`permute24_kernel`) is the same core templated on the width
// (`Width<W>`), with its own tables (8 x 24 external, 21 internal, 24
// diagonal; `p2_set_constants24`), six groups of 4 in the external layer
// and 23 lanes summed as a tree in the internal one; a thread holds its 24
// lanes in registers, and rows of 96 bytes are read and written as six
// 16-byte vectors. It has two instances, which the wrapper chooses from the
// installed constants. The general one reads any diagonal from its table:
// 1,356 products a permutation (8 x 24 x 4 + 21 x (4 + 24)). The shift
// instance computes the standard diagonal, whose entries are +-1..4 and
// +-2^-n (`ShiftDiag<24>`), with shifts, IMADs and adds (`add_diag_term`),
// leaving the 852 S-box products on the multiply pipe. The two instances
// issue different adds as IMADs (`permute24_kernel`). At most 64
// registers, 8 resident CTAs of 128 threads per SM, make (2^18, 24) 1.94
// waves on 132 SMs.
//
// hash_rows: a CTA owns HR_ROWS rows (one per thread) and walks the columns
// in chunks of HR_CHUNK words. Each chunk is copied to shared memory with
// 4-byte cp.async (row starts are only 4-byte aligned: C is often odd) so
// that consecutive lanes read consecutive words of one row; the copy of
// chunk k+1 runs while the permutations of chunk k run (two buffers). The
// row pitch HR_CHUNK + 1 is odd, so the 32 lanes of a warp reading their
// own rows hit 32 banks. Words past the row end are zero-filled: the sponge
// overwrites the 8 rate lanes with each block, the last one zero-padded, as
// the reference's padding-free sponge does. Every width takes this path;
// a chunk narrower than HR_CHUNK copies only the columns its blocks need.
//
// compress: one launch builds up to CP_MAX_LEVELS levels of a tree. A CTA
// takes 2 * CP_THREADS consecutive digests of the input level; thread t
// compresses digests 2t and 2t+1, and each level is kept in shared memory
// for the next, with a barrier between levels, and written to its slice of
// the output. A level-by-level launch paid a host call per level; a 2^19
// leaf tree now takes two launches. One level (`compress16`) is the same
// kernel with levels = 1.

#include "babybear.cuh"

namespace {

constexpr int WIDTH = 16;
constexpr int RATE = 8;
constexpr int ROUNDS_F = 8;
constexpr int ROUNDS_P = 13;
constexpr int ROUNDS_P24 = 21;
constexpr int THREADS = 128;

constexpr int HR_ROWS = 128;
constexpr int HR_CHUNK = 32;
constexpr int HR_PITCH = HR_CHUNK + 1;

constexpr int CP_THREADS = 512;
constexpr int CP_MAX_LEVELS = 10;  // log2(2 * CP_THREADS)

__constant__ uint32_t c_ext[ROUNDS_F * WIDTH];
__constant__ uint32_t c_int[ROUNDS_P];
__constant__ uint32_t c_diag[WIDTH];
__constant__ uint32_t c_ext24[ROUNDS_F * 24];
__constant__ uint32_t c_int24[ROUNDS_P24];
__constant__ uint32_t c_diag24[24];
__constant__ uint32_t c_one;  // 1, set at run time so the compiler cannot fold it

// The round count and constant tables of a width.
template <int W>
struct Width;

template <>
struct Width<16> {
  static constexpr int rounds_p = ROUNDS_P;
  __device__ static uint32_t ext(int i) { return c_ext[i]; }
  __device__ static uint32_t internal(int r) { return c_int[r]; }
  __device__ static uint32_t diag(int i) { return c_diag[i]; }
};

template <>
struct Width<24> {
  static constexpr int rounds_p = ROUNDS_P24;
  __device__ static uint32_t ext(int i) { return c_ext24[i]; }
  __device__ static uint32_t internal(int r) { return c_int24[r]; }
  __device__ static uint32_t diag(int i) { return c_diag24[i]; }
};

// a + b mod p with the sum issued on the multiply pipe as a * 1 + b.
__device__ __forceinline__ uint32_t add_mp(uint32_t a, uint32_t b) {
  uint32_t s;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(s) : "r"(a), "r"(c_one), "r"(b));
  return bb::reduce(s);
}

// a + b mod p: on the multiply pipe (`add_mp`) with kMp, else where the
// compiler puts it (`bb::add`).
template <bool kMp>
__device__ __forceinline__ uint32_t add_on(uint32_t a, uint32_t b) {
  if constexpr (kMp) return add_mp(a, b);
  else return bb::add(a, b);
}

// The standard width-24 diagonal (Plonky3's, ops/poseidon2.py `_DIAG24`)
// as lane i's entry = k[i] * 2^-n[i]: `SHIFT_PLAN24` of ops/poseidon2.py,
// which a CPU test holds equal to these tables.
template <int W>
struct ShiftDiag;

template <>
struct ShiftDiag<24> {
  static constexpr int k[24] = {-2, 1, 2, 1, 3, 4, -1, -3, -4, 1, 1, 1,
                                1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1, 1};
  static constexpr int n[24] = {0, 0, 0, 1, 0, 0, 1, 0, 0, 8, 2, 3,
                                4, 5, 6, 27, 8, 2, 3, 4, 5, 6, 27, 2};
};

// sum + d * x mod p for canonical sum and x and d = K * 2^-N (N = 0 and
// K in +-{1, 2, 3, 4}, or K = +-1 and N in [1, 27]), with no Montgomery
// product. Since 15 * 2^27 = p - 1, 2^-N = -15 * 2^(27 - N) mod p, so with
// x = hi * 2^N + lo, x * 2^-N = hi - 15 * 2^(27 - N) * lo, which lies in
// (-p, p / 2^N]: the same 32-bit word as hi * p - 15 * 2^(27 - N) * x mod
// 2^32, two IMADs beside the shift. kMp: the pipe of the adds.
template <int K, int N, bool kMp>
__device__ __forceinline__ uint32_t add_diag_term(uint32_t sum, uint32_t x) {
  static_assert((N == 0 && K != 0 && K >= -4 && K <= 4) ||
                    (N > 0 && N <= 27 && (K == 1 || K == -1)),
                "a diagonal entry is +-1..4 or +-2^-N");
  if constexpr (N == 0) {
    constexpr int A = K < 0 ? -K : K;
    uint32_t m = x;  // |K| x
    if constexpr (A >= 2) m = add_on<kMp>(x, x);
    if constexpr (A == 3) m = add_on<kMp>(m, x);
    if constexpr (A == 4) m = add_on<kMp>(m, m);
    if constexpr (K > 0) return add_on<kMp>(sum, m);
    else return bb::reduce(sum + (bb::P - m));  // sum + p - m in (0, 2p)
  } else {
    const uint32_t hi = x >> N;
    const int32_t r = static_cast<int32_t>(hi * bb::P - x * (15u << (27 - N)));
    return add_on<kMp>(sum, bb::canon(K > 0 ? r : -r));
  }
}

// Every lane I.. of the internal layer: s[i] = sum + diag_i * s[i].
template <int W, bool kMp, int I = 0>
__device__ __forceinline__ void shift_diag(uint32_t s[W], uint32_t sum) {
  if constexpr (I < W) {
    s[I] = add_diag_term<ShiftDiag<W>::k[I], ShiftDiag<W>::n[I], kMp>(sum, s[I]);
    shift_diag<W, kMp, I + 1>(s, sum);
  }
}

// (s + c)^7 for canonical s and c.
__device__ __forceinline__ uint32_t sbox(uint32_t s, uint32_t c) {
  const int32_t x = static_cast<int32_t>(s + c - bb::P);  // [-p, p)
  const int32_t x2 = bb::smul(x, x);
  const int32_t x3 = bb::smul(x2, x);
  const int32_t x4 = bb::smul(x2, x2);
  return bb::canon(bb::smul(x4, x3));
}

// M_E = circ(2 M4, M4, ..., M4): M4 on each group of 4, then each lane adds
// the sum of its position across the W / 4 groups. kMp: the adds' pipe.
template <int W, bool kMp>
__device__ __forceinline__ void external_linear(uint32_t s[W]) {
  static_assert(W == 16 || W == 24, "Poseidon2 widths are 16 and 24");
#pragma unroll
  for (int g = 0; g < W; g += 4) {
    const uint32_t a = s[g], b = s[g + 1], c = s[g + 2], d = s[g + 3];
    const uint32_t t01 = add_on<kMp>(a, b);
    const uint32_t t23 = add_on<kMp>(c, d);
    const uint32_t t0123 = add_on<kMp>(t01, t23);
    const uint32_t t01123 = add_on<kMp>(t0123, b);
    const uint32_t t01233 = add_on<kMp>(t0123, d);
    s[g] = add_on<kMp>(t01123, t01);                    // 2a + 3b + c + d
    s[g + 1] = add_on<kMp>(t01123, add_on<kMp>(c, c));  // a + 2b + 3c + d
    s[g + 2] = add_on<kMp>(t01233, t23);                // a + b + 2c + 3d
    s[g + 3] = add_on<kMp>(t01233, add_on<kMp>(a, a));  // 3a + b + c + 2d
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint32_t acc =
        add_on<kMp>(add_on<kMp>(s[k], s[4 + k]), add_on<kMp>(s[8 + k], s[12 + k]));
    if constexpr (W == 24) acc = add_on<kMp>(acc, add_on<kMp>(s[16 + k], s[20 + k]));
#pragma unroll
    for (int g = 0; g < W; g += 4) s[g + k] = add_on<kMp>(s[g + k], acc);
  }
}

template <int W, bool kMp>
__device__ __forceinline__ void external_round(uint32_t s[W], int r) {
#pragma unroll
  for (int i = 0; i < W; ++i) s[i] = sbox(s[i], Width<W>::ext(r * W + i));
  external_linear<W, kMp>(s);
}

// S-box on lane 0, then M_I = 1 + diag(v): every lane gets the lane sum
// plus diag_i * x_i. Lanes 1..W-1 are summed while lane 0's S-box runs.
// kShiftDiag: the standard diagonal (`ShiftDiag<W>`) by shifts and adds,
// not from the diagonal table by products; kMp: the adds' pipe.
template <int W, bool kShiftDiag, bool kMp>
__device__ __forceinline__ void internal_round(uint32_t s[W], int r) {
  const uint32_t x0 = sbox(s[0], Width<W>::internal(r));
  constexpr int H = W / 2;
  uint32_t t[H];
#pragma unroll
  for (int i = 0; i < H - 1; ++i) t[i] = add_on<kMp>(s[2 * i + 1], s[2 * i + 2]);
  t[H - 1] = s[W - 1];
#pragma unroll
  for (int i = 0; i < H / 2; ++i) t[i] = add_on<kMp>(t[2 * i], t[2 * i + 1]);
  uint32_t sum;
  if constexpr (W == 16) {
    sum = add_on<kMp>(add_on<kMp>(add_on<kMp>(t[0], t[1]), add_on<kMp>(t[2], t[3])), x0);
  } else {
#pragma unroll
    for (int i = 0; i < 3; ++i) t[i] = add_on<kMp>(t[2 * i], t[2 * i + 1]);
    sum = add_on<kMp>(add_on<kMp>(add_on<kMp>(t[0], t[1]), t[2]), x0);
  }
  if constexpr (kShiftDiag) {
    s[0] = x0;
    shift_diag<W, kMp>(s, sum);
  } else {
    s[0] = add_on<kMp>(sum, bb::mul(Width<W>::diag(0), x0));
#pragma unroll
    for (int i = 1; i < W; ++i) s[i] = add_on<kMp>(sum, bb::mul(Width<W>::diag(i), s[i]));
  }
}

// The permutation of one state. Width 16 takes the defaults: the diagonal
// from its table, the external layer's adds on the multiply pipe, the
// internal layer's where the compiler puts them.
template <int W, bool kShiftDiag = false, bool kExtMp = true, bool kIntMp = false>
__device__ void permute(uint32_t s[W]) {
  external_linear<W, kExtMp>(s);
#pragma unroll 1
  for (int r = 0; r < ROUNDS_F / 2; ++r) external_round<W, kExtMp>(s, r);
#pragma unroll 1
  for (int r = 0; r < Width<W>::rounds_p; ++r) internal_round<W, kShiftDiag, kIntMp>(s, r);
#pragma unroll 1
  for (int r = ROUNDS_F / 2; r < ROUNDS_F; ++r) external_round<W, kExtMp>(s, r);
}

// W words from 16-byte-aligned src into s, and back.
template <int W>
__device__ __forceinline__ void load_lanes(uint32_t s[W], const uint4* src) {
#pragma unroll
  for (int q = 0; q < W / 4; ++q) {
    const uint4 v = src[q];
    s[4 * q] = v.x; s[4 * q + 1] = v.y; s[4 * q + 2] = v.z; s[4 * q + 3] = v.w;
  }
}

template <int W>
__device__ __forceinline__ void store_lanes(uint4* dst, const uint32_t s[W]) {
#pragma unroll
  for (int q = 0; q < W / 4; ++q)
    dst[q] = make_uint4(s[4 * q], s[4 * q + 1], s[4 * q + 2], s[4 * q + 3]);
}

// One state of W lanes per thread; the template arguments are `permute`'s.
template <int W, bool kShiftDiag = false, bool kExtMp = true, bool kIntMp = false>
__device__ __forceinline__ void permute_rows(const uint32_t* __restrict__ in,
                                             uint32_t* __restrict__ out, int64_t S) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= S) return;
  uint32_t s[W];
  load_lanes<W>(s, reinterpret_cast<const uint4*>(in + t * W));
  permute<W, kShiftDiag, kExtMp, kIntMp>(s);
  store_lanes<W>(reinterpret_cast<uint4*>(out + t * W), s);
}

__global__ void __launch_bounds__(THREADS)
permute_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
               int64_t S) {
  permute_rows<WIDTH>(in, out, S);
}

// The width-24 kernels' geometry: one state per thread, 8 resident CTAs of
// THREADS per SM (at most 64 registers), so (2^18, 24) is 1.94 waves on 132
// SMs where 40 registers and 12 CTAs made 1.29.
constexpr int P24_MIN_BLOCKS = 8;

// kShiftDiag: the standard diagonal by shifts; otherwise the installed
// diagonal table (any constants of `load_constants`) by products. The adds
// each instance issues as IMADs (`add_mp`) rather than leaving to the ALU
// are the placement that measured fastest (PERF.md, the width-24
// findings), not one the pipes' loads predict: the shift instance's
// internal layer's, the general one's external layer's, as width 16 does.
template <bool kShiftDiag>
__global__ void __launch_bounds__(THREADS, P24_MIN_BLOCKS)
permute24_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                 int64_t S) {
  permute_rows<24, kShiftDiag, !kShiftDiag, kShiftDiag>(in, out, S);
}

__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src)
               : "memory");
}

// Columns [col0, col0 + 2^lg) of the CTA's rows into `tile` (row r at
// r * HR_PITCH), as one cp.async group; words past the matrix become 0.
__device__ __forceinline__ void stage_chunk(uint32_t* tile, const uint32_t* mat,
                                            int64_t S, int C, int64_t row0,
                                            int col0, int lg) {
  const int mask = (1 << lg) - 1;
  for (int e = threadIdx.x; e < (HR_ROWS << lg); e += HR_ROWS) {
    const int r = e >> lg;
    const int col = col0 + (e & mask);
    const int64_t row = row0 + r;
    uint32_t* dst = tile + r * HR_PITCH + (e & mask);
    if (row < S && col < C)
      cp_async4(dst, mat + row * C + col);
    else
      *dst = 0u;
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// log2 of the staged width of chunk k: its blocks' columns, rounded up to
// 8, 16 or HR_CHUNK.
__device__ __forceinline__ int chunk_lg(int n_blocks, int k) {
  const int need = min(HR_CHUNK, (n_blocks - k * (HR_CHUNK / RATE)) * RATE);
  return need <= 8 ? 3 : need <= 16 ? 4 : 5;
}

__global__ void __launch_bounds__(HR_ROWS)
hash_rows_kernel(const uint32_t* __restrict__ mat, int64_t S, int C,
                 uint32_t* __restrict__ out) {
  __shared__ uint32_t tiles[2][HR_ROWS * HR_PITCH];
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * HR_ROWS;
  const int n_blocks = C > 0 ? (C + RATE - 1) / RATE : 1;
  const int n_chunks = (n_blocks * RATE + HR_CHUNK - 1) / HR_CHUNK;
  stage_chunk(tiles[0], mat, S, C, row0, 0, chunk_lg(n_blocks, 0));
  uint32_t s[WIDTH];
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) s[i] = 0u;
  for (int k = 0; k < n_chunks; ++k) {
    if (k + 1 < n_chunks) {
      // buffer (k+1)&1 was last read in step k-1, which ended in a barrier
      stage_chunk(tiles[(k + 1) & 1], mat, S, C, row0, (k + 1) * HR_CHUNK,
                  chunk_lg(n_blocks, k + 1));
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();
    const uint32_t* row = tiles[k & 1] + threadIdx.x * HR_PITCH;
    const int nb = min(HR_CHUNK / RATE, n_blocks - k * (HR_CHUNK / RATE));
    for (int b = 0; b < nb; ++b) {
#pragma unroll
      for (int i = 0; i < RATE; ++i) s[i] = row[b * RATE + i];
      permute<WIDTH>(s);
    }
    __syncthreads();
  }
  const int64_t t = row0 + threadIdx.x;
  if (t < S) {
    uint4* dst = reinterpret_cast<uint4*>(out + t * RATE);
    dst[0] = make_uint4(s[0], s[1], s[2], s[3]);
    dst[1] = make_uint4(s[4], s[5], s[6], s[7]);
  }
}

// in: n_in digests of 8 words; out: `levels` levels back to back, level j
// (1-based) holding n_in >> j digests, D_j[i] = compress(D_{j-1}[2i],
// D_{j-1}[2i+1]). n_in is a multiple of 2^levels.
__global__ void __launch_bounds__(CP_THREADS)
compress_kernel(const uint32_t* __restrict__ in, int64_t n_in, int levels,
                uint32_t* __restrict__ out) {
  __shared__ uint4 level[2 * CP_THREADS];  // this CTA's digests, 2 x uint4 each
  const int64_t base = static_cast<int64_t>(blockIdx.x) * (2 * CP_THREADS);
  const int span = static_cast<int>(
      n_in - base < 2 * CP_THREADS ? n_in - base : 2 * CP_THREADS);
  const int t = threadIdx.x;
  int64_t off = 0;  // first digest of level j in `out`
  for (int j = 1; j <= levels; ++j) {
    const int m = span >> j;
    uint32_t s[WIDTH];
    if (t < m) {
      load_lanes<WIDTH>(s, j == 1 ? reinterpret_cast<const uint4*>(in + (base + 2 * t) * RATE)
                                  : &level[4 * t]);
      permute<WIDTH>(s);
    }
    __syncthreads();  // the previous level is read before it is overwritten
    if (t < m) {
      const uint4 lo = make_uint4(s[0], s[1], s[2], s[3]);
      const uint4 hi = make_uint4(s[4], s[5], s[6], s[7]);
      level[2 * t] = lo;
      level[2 * t + 1] = hi;
      uint4* dst = reinterpret_cast<uint4*>(out + (off + (base >> j) + t) * RATE);
      dst[0] = lo;
      dst[1] = hi;
    }
    __syncthreads();
    off += n_in >> j;
  }
}

unsigned blocks_for(int64_t n, int per_block) {
  return static_cast<unsigned>((n + per_block - 1) / per_block);
}

}  // namespace

// Host tables (Montgomery form): external (8, 16), internal (13,), diag (16,).
extern "C" int p2_set_constants(const uint32_t* ext, const uint32_t* internal,
                                const uint32_t* diag) {
  const uint32_t one = 1;
  cudaError_t e = cudaMemcpyToSymbol(c_one, &one, sizeof(c_one));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_ext, ext, sizeof(c_ext));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_int, internal, sizeof(c_int));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_diag, diag, sizeof(c_diag));
  return static_cast<int>(e);
}

extern "C" int p2_permute(const uint32_t* in, uint32_t* out, int64_t S,
                          void* stream) {
  permute_kernel<<<blocks_for(S, THREADS), THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(in, out, S);
  return static_cast<int>(cudaGetLastError());
}

// Host tables of width 24 (Montgomery form): external (8, 24), internal
// (21,), diag (24,).
extern "C" int p2_set_constants24(const uint32_t* ext, const uint32_t* internal,
                                  const uint32_t* diag) {
  const uint32_t one = 1;
  cudaError_t e = cudaMemcpyToSymbol(c_one, &one, sizeof(c_one));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_ext24, ext, sizeof(c_ext24));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_int24, internal, sizeof(c_int24));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_diag24, diag, sizeof(c_diag24));
  return static_cast<int>(e);
}

// (S, 24) states, rows 16-byte aligned; shift_diag: the installed diagonal
// is the standard one (ops/poseidon2.py `shift_diag24`).
extern "C" int p2_permute24(const uint32_t* in, uint32_t* out, int64_t S,
                            int shift_diag, void* stream) {
  const unsigned blocks = blocks_for(S, THREADS);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (shift_diag)
    permute24_kernel<true><<<blocks, THREADS, 0, st>>>(in, out, S);
  else
    permute24_kernel<false><<<blocks, THREADS, 0, st>>>(in, out, S);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int p2_hash_rows(const uint32_t* mat, int64_t S, int C,
                            uint32_t* out, void* stream) {
  hash_rows_kernel<<<blocks_for(S, HR_ROWS), HR_ROWS, 0,
                     static_cast<cudaStream_t>(stream)>>>(mat, S, C, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int p2_compress(const uint32_t* in, int64_t n_in, int levels,
                           uint32_t* out, void* stream) {
  if (levels < 1 || levels > CP_MAX_LEVELS || n_in <= 0 ||
      n_in % (int64_t{1} << levels))
    return static_cast<int>(cudaErrorInvalidValue);
  compress_kernel<<<blocks_for(n_in, 2 * CP_THREADS), CP_THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(in, n_in, levels, out);
  return static_cast<int>(cudaGetLastError());
}
