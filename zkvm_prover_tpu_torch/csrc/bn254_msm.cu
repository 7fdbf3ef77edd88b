// Pippenger MSM over BN254 G1 (kernel K4): sum_i s_i P_i for affine P_i.
//
// Replaces: the XLA code of zkvm_prover_tpu/ops/msm.py, `window_buckets`
// (:171, one jax.jit over the sorted digits at :201) with `pt_add` (:81) and
// `pt_double` (:62) on ops/bigint.py's Fq (`Field.mul/add/sub`, :166, :73,
// :118), and `_weighted_bucket_sum` (:261): the commitments of the BN254
// SNARK wrapper. No function of the reference reaches pl.pallas_call here.
//
// The caller splits each scalar into W windows of c bits (digits in
// [0, 2^c)), sorts each window's point indices by digit (`order`, W x n) and
// gives each window's bucket boundaries in that order (`offsets`, W x
// (2^c + 1)); ops/msm.py does both with torch. Then:
//   msm_buckets_kernel: one thread per (window, bucket k > 0) adds the
//     affine points of its run of `order` into a Jacobian sum (madd), the
//     segmented reduction of the sorted points; bucket 0 is infinity.
//   msm_window_sums_kernel: one CTA per window, S threads; thread s takes
//     buckets [sL, sL + L) (L = 2^c / S) and forms, from the top down with a
//     running sum, A_s = sum_j j B_{sL+j} and T_s = sum_j B_{sL+j}; thread 0
//     then forms sum_s s T_s the same way, doubles it log2(L) times and adds
//     every A_s: sum_k k B_k = sum_s A_s + L sum_s s T_s.
// The host combines the W window sums (sum_w 2^(c w) S_w), as the reference
// does (msm.py:303-310).
//
// Bound: the Fq products (CIOS, 8 limbs: 128 32x32->64 multiplies, each an
// IMAD and an IMAD.HI, on the multiply pipe); the points and buckets are a
// few MB. The design is the simple one: a thread per bucket walks its run of
// points serially, and thread 0 of each window walks 3S points, so the
// kernels leave most of the card idle at n = 2^13 (PERF.md).
//
// Layouts (uint32 words): points (n, 16) = Montgomery x, y of each affine
// point, (0, 0) for infinity; buckets (W, 2^c, 24) and sums (W, 24) =
// Jacobian Montgomery (X, Y, Z).

#include "bn254.cuh"

namespace {

constexpr int MSM_THREADS = 128;

__global__ void msm_buckets_kernel(const uint32_t* __restrict__ points,
                                   const int32_t* __restrict__ order,
                                   const int32_t* __restrict__ offsets, int64_t n, int c,
                                   int W, uint32_t* __restrict__ buckets) {
  const int nb = 1 << c;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;  // W * nb < 2^21
  if (idx >= W * nb) return;
  const int w = idx >> c;
  const int k = idx & (nb - 1);
  bn::Pt acc;
  bn::set_infinity(acc);
  if (k != 0) {
    const int32_t* off = offsets + static_cast<int64_t>(w) * (nb + 1);
    const int32_t* ord = order + static_cast<int64_t>(w) * n;
    for (int32_t j = off[k]; j < off[k + 1]; ++j) {
      const uint32_t* p = points + 16 * static_cast<int64_t>(ord[j]);
      bn::Fq x, y;
      bn::load(x, p);
      bn::load(y, p + 8);
      if (bn::is_zero(x) && bn::is_zero(y)) continue;  // infinity
      bn::pt_add_affine(acc, acc, x, y);
    }
  }
  bn::store(buckets + 24 * static_cast<int64_t>(idx), acc);
}

__global__ void msm_window_sums_kernel(const uint32_t* __restrict__ buckets, int nb,
                                       int log_l, uint32_t* __restrict__ sums) {
  extern __shared__ uint32_t shared[];  // A_s then T_s, 24 words each
  const int w = blockIdx.x;
  const int s = threadIdx.x;
  const int S = blockDim.x;
  const int L = 1 << log_l;
  const uint32_t* b = buckets + (static_cast<int64_t>(w) * nb + static_cast<int64_t>(s) * L) * 24;
  bn::Pt run, acc, bk;
  bn::set_infinity(run);
  bn::set_infinity(acc);
  for (int j = L - 1; j >= 0; --j) {
    bn::pt_add(acc, acc, run);
    bn::load(bk, b + 24 * j);
    bn::pt_add(run, run, bk);
  }
  bn::store(shared + 24 * s, acc);
  bn::store(shared + 24 * (S + s), run);
  __syncthreads();
  if (s != 0) return;
  bn::Pt run2, acc2;
  bn::set_infinity(run2);
  bn::set_infinity(acc2);
  for (int t = S - 1; t >= 0; --t) {
    bn::pt_add(acc2, acc2, run2);
    bn::load(bk, shared + 24 * (S + t));
    bn::pt_add(run2, run2, bk);
  }
  for (int i = 0; i < log_l; ++i) bn::pt_dbl(acc2, acc2);
  for (int t = 0; t < S; ++t) {
    bn::load(bk, shared + 24 * t);
    bn::pt_add(acc2, acc2, bk);
  }
  bn::store(sums + 24 * static_cast<int64_t>(w), acc2);
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

// buckets (W, 2^c, 24) from points (n, 16), order (W, n) and offsets
// (W, 2^c + 1); 1 <= c <= 16, W <= 254.
extern "C" int bn254_msm_buckets(const uint32_t* points, const int32_t* order,
                                 const int32_t* offsets, int64_t n, int c, int W,
                                 uint32_t* buckets, void* stream) {
  if (c < 1 || c > 16 || W < 1 || W > 254 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = W << c;
  const unsigned blocks = static_cast<unsigned>((threads + MSM_THREADS - 1) / MSM_THREADS);
  msm_buckets_kernel<<<blocks, MSM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      points, order, offsets, n, c, W, buckets);
  return static_cast<int>(cudaGetLastError());
}

// sums (W, 24) from buckets (W, 2^c, 24), 2^log_s threads a window,
// 0 <= log_s <= min(c, 8) (at most 48 KB of shared memory).
extern "C" int bn254_msm_window_sums(const uint32_t* buckets, int W, int c, int log_s,
                                     uint32_t* sums, void* stream) {
  if (c < 1 || c > 16 || W < 1 || log_s < 0 || log_s > c || log_s > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const int S = 1 << log_s;
  const size_t shared = static_cast<size_t>(2 * S * 24) * sizeof(uint32_t);
  msm_window_sums_kernel<<<W, S, shared, static_cast<cudaStream_t>(stream)>>>(
      buckets, 1 << c, c - log_s, sums);
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
