// Radix-2 NTT butterflies over BabyBear for an (n, W) matrix of Montgomery
// residues whose rows may lie at any pitch: the transform runs down axis 0,
// one column each.
//
// Replaces: zkvm_prover_tpu/ops/ntt_pallas.py, `fused_final_stages` (the
// Pallas kernel `_fused_stages_kernel`) and the XLA stages of `dif_fused`;
// with the DIT mirror it also replaces ops/ntt.py `_dif` / `_dit`, and the
// per-row scalings of `intt_*`, `interpolate_coset_rev` and
// `eval_coset_from_rev`, and the interleaving copy of the coset LDE.
//
// Bound: device-memory bytes and the multiply pipe, about evenly. A pass
// reads and writes the matrix once (n * W * 8 bytes); each butterfly is one
// Montgomery product, three wide multiplies on the one multiply pipe (5/64
// of an SM clock), so a whole transform at (2^18, 495) has a bytes floor of
// 0.31 ms for one pass and a multiply floor of about 0.35 ms. Both sides of
// a pass take longer than their floors (unaligned 128-byte segments, rows
// 2^a apart spread over the whole matrix, index and reduction instructions
// beside the products), and they overlap.
//
// Design: one kernel runs any run of L consecutive stages, half-sizes
// 2^a .. 2^(a+L-1). Those stages act independently on each group of 2^L rows
// {base + i * 2^a}, base ranging over the low a bits and the bits from a+L
// up, so a CTA takes one group for a tile of 32 columns, runs the L stages
// and stores it. A whole transform of 2^log_n rows is ceil(log_n / L)
// passes (two at log_n = 18): DIF takes the groups from the top half-size
// down, DIT from the bottom up. a = 0 is the block pass of the Pallas
// kernel; a > 0 is the four-step decomposition done in place without a
// transpose.
//
// The stages go in rounds of up to three (radix 8): a lane takes 8 rows of
// its column into registers, runs three stages on them and puts them back.
// The first round loads from device memory, the last stores to it, and the
// rounds between go through a 2^L x 32-word shared tile, so a pass of 9
// stages touches each shared word 4 times and waits at 2 barriers, where a
// stage per shared round trip would take 20 and 10. A warp takes one row
// segment of 32 columns, so device accesses are 128-byte segments (W = 495
// is odd: rows start only 4-byte aligned, and 16-byte vectors or TMA do not
// apply) and shared accesses are 32 consecutive words, free of bank
// conflicts. A matrix narrower than 17 columns packs up to 32 / TC groups
// side by side (TC, the column count rounded up to a power of two), so a
// narrow transform still fills the lanes. Lanes in the ragged last column
// tile or past the last group do nothing. Each CTA first copies the 2^L - 1
// twiddles its groups use into shared memory (a > 0 gives each group its
// own), so a twiddle costs one shared read and no address arithmetic.
//
// Fused per-row multipliers (Montgomery, one product per element): `pre`,
// indexed by input row, at the load of the pass; `post`, indexed by output
// row, at the store. The LDE's 1/n and coset scalings ride on them. The
// output row pitch is free, so the DIT of coset r writes rows r, r + blowup,
// ... of the interleaved LDE directly. Twiddles are the per-stage tables
// concatenated (stage with half-size h at offset h - 1), read through the
// read-only cache; stage h uses w_{2h}^(row mod h). Every stored value is
// canonical; a pass may run in place (x == y, same pitch): each CTA reads
// exactly the elements it writes.

#include <algorithm>

#include "babybear.cuh"

namespace {

constexpr int VC = 32;            // virtual columns of a tile: one per lane
constexpr int MAX_L = 10;         // 2^10 rows x 32 words = 128 KB of shared memory
constexpr int THREADS = 512;      // 2 CTAs of a 2^9-row tile per SM (registers)
constexpr size_t SMEM_MAX = 232448;  // dynamic shared memory a CTA may have

struct Pass {
  const uint32_t* x;
  uint32_t* y;
  int64_t ld_x, ld_y;   // row pitches in words
  int64_t groups;       // n >> L
  int W, a, L;
  int lg_tc;            // log2 of the columns per group in a tile
  int lg_g;             // log2 of the groups side by side in a tile
  int col_tiles;
  int tw_sets;          // twiddle tables in shared memory (one per group, or 1 if a = 0)
  const uint32_t* tw;
  const uint32_t* pre;  // per input row, or null
  const uint32_t* post; // per output row, or null
};

// (a - b) mod p for canonical a, b: the difference lies in (-p, p).
__device__ __forceinline__ uint32_t sub(uint32_t a, uint32_t b) {
  return bb::canon(static_cast<int32_t>(a - b));
}

// ONE: the twiddle is 1 (half-size 1), so the product is skipped.
template <bool DIT, bool ONE>
__device__ __forceinline__ void butterfly(uint32_t& lo, uint32_t& hi, uint32_t w) {
  if (DIT) {
    const uint32_t bw = ONE ? hi : bb::mul(hi, w);
    hi = sub(lo, bw);
    lo = bb::add(lo, bw);
  } else if (ONE) {
    const uint32_t d = sub(lo, hi);
    lo = bb::add(lo, hi);
    hi = d;
  } else {
    // lo - hi lies in (-p, p), which the signed product takes as it is
    const int32_t d = static_cast<int32_t>(lo - hi);
    lo = bb::add(lo, hi);
    hi = bb::canon(bb::smul(d, static_cast<int32_t>(w)));
  }
}

// One round of one lane: the group-local stages s0 .. s0+R-1 (half-sizes
// 2^s) in registers, for the lane's column. A unit is the 2^R group rows
// ib + t * 2^s0 (t < 2^R), ib having bits s0 .. s0+R-1 clear; a warp takes
// one unit, so its shared accesses are 32 consecutive words. The first
// round reads device memory (through `pre`), the last writes it (through
// `post`); the others read and write the tile. Addresses advance by adds: a
// 64-bit index product would take the multiply pipe, which the butterflies
// need. row_b: the device row of the lane's group row 0; twl: the lane's
// twiddle table minus one word, so stage s, index jl is twl[2^s + jl].
template <bool DIT, int R>
__device__ __forceinline__ void round(const Pass& p, uint32_t* tile,
                                      const uint32_t* twl, int64_t row_b, int col,
                                      int s0, bool first, bool last) {
  constexpr int N = 1 << R;
  const int units = 1 << (p.L - R);
  const int v = threadIdx.x & (VC - 1);
  const int lg_step = s0 + p.a;  // group rows 2^s0 apart are 2^lg_step device rows apart
  const int t_step = VC << s0;   // ... and t_step tile words
  for (int u = threadIdx.x >> 5; u < units; u += blockDim.x >> 5) {
    const int u_low = u & ((1 << s0) - 1);
    const int ib = u_low + ((u >> s0) << (s0 + R));
    const int64_t row0 = row_b + (static_cast<int64_t>(ib) << p.a);
    uint32_t x[N];
    if (first) {
      const uint32_t* src = p.x + row0 * p.ld_x + col;
      const int64_t step = p.ld_x << lg_step;
#pragma unroll
      for (int t = 0; t < N; ++t, src += step) x[t] = *src;
      if (p.pre) {
        const uint32_t* m = p.pre + row0;
#pragma unroll
        for (int t = 0; t < N; ++t, m += (int64_t{1} << lg_step)) x[t] = bb::mul(x[t], __ldg(m));
      }
    } else {
      const uint32_t* src = tile + ib * VC + v;
#pragma unroll
      for (int t = 0; t < N; ++t, src += t_step) x[t] = *src;
    }
    // stage s = s0 + e at local index jl = u_low + (t mod 2^e) * 2^s0
    const uint32_t* tq = twl + u_low;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int e = DIT ? k : R - 1 - k;
      const int d = 1 << e;
      if (p.a + s0 + e == 0) {  // half-size 1: every twiddle is 1
#pragma unroll
        for (int t = 0; t < N; ++t)
          if (!(t & d)) butterfly<DIT, true>(x[t], x[t + d], 0u);
        continue;
      }
      uint32_t w[N / 2];
      const uint32_t* q = tq + (1 << (s0 + e));
#pragma unroll
      for (int j = 0; j < d; ++j) w[j] = q[j << s0];
#pragma unroll
      for (int t = 0; t < N; ++t)
        if (!(t & d)) butterfly<DIT, false>(x[t], x[t + d], w[t & (d - 1)]);
    }
    if (last) {
      uint32_t* dst = p.y + row0 * p.ld_y + col;
      const int64_t step = p.ld_y << lg_step;
      if (p.post) {
        const uint32_t* m = p.post + row0;
#pragma unroll
        for (int t = 0; t < N; ++t, dst += step, m += (int64_t{1} << lg_step))
          *dst = bb::mul(x[t], __ldg(m));
      } else {
#pragma unroll
        for (int t = 0; t < N; ++t, dst += step) *dst = x[t];
      }
    } else {
      uint32_t* dst = tile + ib * VC + v;
#pragma unroll
      for (int t = 0; t < N; ++t, dst += t_step) *dst = x[t];
    }
  }
}

// Shared memory: the tile (2^L x VC words, when there is more than one
// round), then tw_sets twiddle tables of 2^L + 1 words (odd, so that lanes
// of different groups read different banks).
template <bool DIT>
__global__ void __launch_bounds__(THREADS)
ntt_pass_kernel(const Pass p) {
  extern __shared__ uint32_t smem[];
  const int rounds = (p.L + 2) / 3;
  uint32_t* tile = smem;
  uint32_t* tws = smem + (rounds > 1 ? VC << p.L : 0);
  const int tw_pitch = (1 << p.L) + 1;
  const int col0 = (blockIdx.x % p.col_tiles) << p.lg_tc;
  const int64_t beta0 = static_cast<int64_t>(blockIdx.x / p.col_tiles) << p.lg_g;
  const int amask = (1 << p.a) - 1;

  // Twiddles of this CTA's groups: set g, stage s (half-size 2^(a+s)), local
  // index jl < 2^s at g * tw_pitch + 2^s - 1 + jl. Row base + (i << a) with
  // i mod 2^s = jl takes w_{2h}^(row mod h), row mod h = base_low + (jl << a).
  for (int i = threadIdx.x; i < p.tw_sets * tw_pitch; i += blockDim.x) {
    const int g = i / tw_pitch, k = i - g * tw_pitch + 1;  // k = 2^s + jl
    if (k >= (1 << p.L)) continue;
    const int s = 31 - __clz(k);
    const int base_low = static_cast<int>(beta0 + g) & amask;
    tws[i] = __ldg(p.tw + ((1 << (p.a + s)) - 1) + base_low + ((k - (1 << s)) << p.a));
  }
  __syncthreads();

  // The lane's column and group stay the same through the pass.
  const int v = threadIdx.x & (VC - 1);
  const int g = v >> p.lg_tc;
  const int64_t beta = beta0 + g;
  const int col = col0 + (v & ((1 << p.lg_tc) - 1));
  const bool live = g < (1 << p.lg_g) && beta < p.groups && col < p.W;
  const int64_t row_b = (beta & amask) + ((beta >> p.a) << (p.a + p.L));
  const uint32_t* twl = tws + (p.tw_sets > 1 ? g * tw_pitch : 0) - 1;

  // rounds of at most 3 stages, as even as can be (3 + 3 + 3 at L = 9)
  int done = 0;
  for (int k = 0; k < rounds; ++k) {
    const int r = (p.L - done + rounds - k - 1) / (rounds - k);
    const int s0 = DIT ? done : p.L - done - r;
    const bool first = k == 0, last = k == rounds - 1;
    if (live) {
      if (r == 3)
        round<DIT, 3>(p, tile, twl, row_b, col, s0, first, last);
      else if (r == 2)
        round<DIT, 2>(p, tile, twl, row_b, col, s0, first, last);
      else
        round<DIT, 1>(p, tile, twl, row_b, col, s0, first, last);
    }
    done += r;
    if (!last) __syncthreads();
  }
}

}  // namespace

// Stages with half-sizes 2^a .. 2^(a+L-1) (DIF from the top down, DIT from
// the bottom up) of the transform down the n rows of x (pitch ld_x words)
// into y (pitch ld_y), with optional per-row multipliers pre (input rows)
// and post (output rows). tw: the stage tables of at least 2^(a+L) - 1
// words. Returns a cudaError_t.
extern "C" int ntt_pass(const uint32_t* x, int64_t ld_x, uint32_t* y, int64_t ld_y,
                        int64_t n, int W, int a, int L, int dit,
                        const uint32_t* tw, const uint32_t* pre,
                        const uint32_t* post, void* stream) {
  if (L < 1 || L > MAX_L || a < 0 || W < 1 || n < (int64_t{1} << (a + L)) ||
      (n & (n - 1)) || ld_x < W || ld_y < W)
    return static_cast<int>(cudaErrorInvalidValue);
  Pass p{x, y, ld_x, ld_y, n >> L, W, a, L, 5, 0, 1, 1, tw, pre, post};
  if (W <= 16) {  // narrow: 32 / TC groups side by side
    p.lg_tc = 0;
    while ((1 << p.lg_tc) < W) ++p.lg_tc;
    p.lg_g = 5 - p.lg_tc;
  } else {
    p.col_tiles = (W + VC - 1) / VC;
  }
  const size_t tile = L > 3 ? (static_cast<size_t>(VC) << L) * 4 : 0;  // one round needs none
  const size_t table = ((static_cast<size_t>(1) << L) + 1) * 4;
  // groups with a > 0 have twiddle tables of their own: fewer side by side
  // where those would not fit
  while (a > 0 && tile + (table << p.lg_g) > SMEM_MAX) --p.lg_g;
  p.tw_sets = a > 0 ? 1 << p.lg_g : 1;
  const size_t smem = tile + table * p.tw_sets;
  const int64_t per_cta = int64_t{1} << p.lg_g;
  const int64_t blocks = ((p.groups + per_cta - 1) / per_cta) * p.col_tiles;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = static_cast<int>(
      std::min<int64_t>(THREADS, std::max<int64_t>(32, int64_t{4} << L)));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = dit ? ntt_pass_kernel<true> : ntt_pass_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<static_cast<unsigned>(blocks), threads, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}
