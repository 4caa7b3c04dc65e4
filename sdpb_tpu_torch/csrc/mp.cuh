// Multi-limb (MP) arithmetic inside the CUDA kernels: the error-free
// transforms and renormalization shared by both representations, and the
// classic float64 representation (namespace mpk).
//
// The CUDA counterpart of sdpb_tpu/ops/mplist.py, classic path: a value is
// an unevaluated sum of K float64 limbs.  Every function performs the same
// sequence of IEEE operations as mplist.py (and as the plain PyTorch
// versions in ops/kernels.py), so results agree limb for limb.  That rests
// on the build rules: -fmad=false (no multiply-add contraction anywhere;
// a contracted TwoProd or TwoSum silently loses the error term),
// -prec-div=true -prec-sqrt=true (correctly rounded seeds) and -ftz=false
// (subnormals kept, as torch keeps them on the CPU).  Never build with
// --use_fast_math.
//
// The kernels are written once against a representation namespace `ar`:
// mpk here (-DMP_SCALED=0), mps of mp_scaled.cuh (-DMP_SCALED=1).  Both
// offer Limb, Val<K>, zero, load, store, add, sub, mul, rsqrt and
// reciprocal; a value is stored limb-major (limb k of element idx at
// x[k * stride + idx]) with, when scaled, its exponent at e[idx].
#pragma once

#include <cuda_runtime.h>

#ifndef MP_K
#error "build with -DMP_K=<limbs>, 2 <= MP_K <= 13 (scaled: 9)"
#endif
#ifndef MP_SCALED
#define MP_SCALED 0
#endif
// Classic limbs to K = 13 (681 bits, above the scaled path's 648): a
// limb lies 53 (K - 1) binary digits below the first, and past K ~ 17 the
// last goes subnormal even for values near 1.  Scaled words stop at 9
// limbs: their float32 ladder must stay inside float32's normal range.
#if MP_SCALED
static_assert(MP_K >= 2 && MP_K <= 9, "scaled MP_K must lie in 2..9");
#else
static_assert(MP_K >= 2 && MP_K <= 13, "classic MP_K must lie in 2..13");
#endif

namespace mpk {

// Knuth TwoSum: s + e == a + b exactly.
template <typename T>
__device__ __forceinline__ void two_sum(T a, T b, T& s, T& e) {
  s = a + b;
  T v = s - a;
  e = (a - (s - v)) + (b - v);
}

// Fast TwoSum: requires |a| >= |b| or a == 0.
template <typename T>
__device__ __forceinline__ void quick_two_sum(T a, T b, T& s, T& e) {
  s = a + b;
  e = b - (s - a);
}

// Dekker split in the contraction-immune form t = fl(2^s a + a), s = 27 for
// float64 and 12 for float32 (sdpb_tpu/ops/eft.py:20-66).
__device__ __forceinline__ void split(double a, double& hi, double& lo) {
  double w = 134217728.0 * a;
  double t = w + a;
  hi = t - (t - a);
  lo = a - hi;
}

__device__ __forceinline__ void split(float a, float& hi, float& lo) {
  float w = 4096.0f * a;
  float t = w + a;
  hi = t - (t - a);
  lo = a - hi;
}

// The two quick-two-sum compaction passes that end a renorm, over xs[0..K]:
// top-down, then bottom-up.
template <int K, int M, typename T>
__device__ __forceinline__ void compact(T (&xs)[M]) {
#pragma unroll
  for (int i = 0; i < K; ++i) quick_two_sum(xs[i], xs[i + 1], xs[i], xs[i + 1]);
#pragma unroll
  for (int i = K - 1; i > 0; --i) quick_two_sum(xs[i - 1], xs[i], xs[i - 1], xs[i]);
}

// Distillation renorm of M raw terms, in place, leaving K limbs in
// xs[0..K-1] (mplist.renorm_list, mpfloat._sweep_unrolled + compaction):
// K bottom-up TwoSum sweeps, the residue chain-summed into slot K, then a
// top-down and a bottom-up quick-two-sum compaction.
template <int K, int M, typename T>
__device__ __forceinline__ void renorm_terms(T (&xs)[M]) {
  static_assert(M >= K + 2, "renorm needs at least K + 2 terms");
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int i = M - 2; i >= k; --i) two_sum(xs[i], xs[i + 1], xs[i], xs[i + 1]);
  }
  T s = xs[M - 1];
#pragma unroll
  for (int i = M - 2; i >= K; --i) s = s + xs[i];
  xs[K] = s;
  compact<K>(xs);
}

// One step of renorm_terms's K sweeps over M rows run as a skewed wavefront
// (the schedule of mp_wide3.cuh's skewed_sweeps and mpfloat.sweeps): at step
// t sweep k works on row M-1-t+2k, so the step's K TwoSums depend only on the
// step before (sweep k's carry c[k], and v[k], what sweep k-1 left of that
// row), where renorm_terms runs a row's K TwoSums one after another.  `in`
// is row M-1-t, sweep 0's input.  Sweep k starts at step 2k (its carry is
// its first row) and runs its TwoSums at 2k < t <= M-1+k, the same TwoSums
// on the same values as renorm_terms.  EDGE: t may lie outside some sweep's
// range (steps t < 2K-1 or t > M-1, unrolled, so that t is a constant);
// otherwise every sweep runs.  Returns what sweep K-1 leaves of row
// M-t+2K-2, a residue row, when sweep K-1 runs.
template <int K, bool EDGE, typename T>
__device__ __forceinline__ T wave_step(T (&c)[K], T (&v)[K], const int t, const int M,
                                       const T in) {
  T out = T(0);
#pragma unroll
  for (int k = K - 1; k >= 0; --k) {
    const T xin = k == 0 ? in : v[k];
    if (EDGE) {
      if (t < 2 * k || t > M - 1 + k) continue;  // sweep k not begun, or done
      if (t == 2 * k) {                          // sweep k begins
        c[k] = xin;
        continue;
      }
    }
    T s, e;
    two_sum(xin, c[k], s, e);
    c[k] = s;
    if (k < K - 1)
      v[k + 1] = e;  // sweep k+1's input at the next step
    else
      out = e;
  }
  return out;
}

// The truncated product's K*K+1 terms in mplist order: exact TwoProds for
// i+j <= K-1, their errors for i+j <= K-2, a chained plain-product tail for
// i+j == K; diagonal n lists the errors of diagonal n-1, then its own
// products; the tail comes last.  put(term, n) places a term whose product
// lies on diagonal n (identity for classic limbs).
template <int K, typename T, typename Put>
__device__ __forceinline__ void mul_terms(const T (&a)[K], const T (&b)[K],
                                          T (&xs)[K * K + 1], Put put) {
  T ah[K], al[K], bh[K], bl[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    split(a[i], ah[i], al[i]);
    split(b[i], bh[i], bl[i]);
  }
  T p[K][K], e[K][K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (i + j <= K - 1) {
        p[i][j] = a[i] * b[j];
        if (i + j <= K - 2)
          e[i][j] = ((ah[i] * bh[j] - p[i][j]) + ah[i] * bl[j] + al[i] * bh[j]) +
                    al[i] * bl[j];
      }
    }
  }
  int t = 0;
#pragma unroll
  for (int n = 0; n < K; ++n) {
#pragma unroll
    for (int i = 0; i < n; ++i) xs[t++] = put(e[i][n - 1 - i], n - 1);
#pragma unroll
    for (int i = 0; i <= n; ++i) xs[t++] = put(p[i][n - i], n);
  }
  T tail = a[1] * b[K - 1];
#pragma unroll
  for (int i = 2; i < K; ++i) tail = tail + a[i] * b[K - i];
  xs[t] = put(tail, K);
}

// The truncated product's renorm_terms<K, K*K+1> over mul_terms's terms,
// without its compaction, leaving xs[0..K], with the sweeps run as a
// skewed wavefront (wave_step) and no term stored: each is made where
// sweep 0 reads it from the limbs a and b (a limb product, or its Dekker
// error with both limbs split again, operation for operation as mul_terms
// makes it), the rows walked from the last: the tail, then by diagonal n
// from K-1 down, its products (i = n..0), then the errors it lists (i =
// n-1..0).  The first 2K-1 steps and the last K-1, where sweeps begin and
// end, are unrolled; the steps in between are one loop a diagonal.  So the
// code holds a few steps where the unrolled form holds the K^3 TwoSums of
// renorm_terms over K^2+1 terms, and a thread keeps 2K carries in
// registers and 2K limbs in its frame where the unrolled form keeps K^2+1
// terms (at classic K = 13, 170 float64 terms: 5.2 KB of spills an
// outlined product, 2.6x K = 12's, and a third of K = 12's products a
// second over the card, where one thread's latency grew only 1.32x;
// tools/kernel_report.py, NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §6).
template <int K, typename T>
__device__ __forceinline__ void mul_sweeps(const T (&a)[K], const T (&b)[K], T (&xs)[K + 1]) {
  constexpr int M = K * K + 1;
  T L[2 * K];  // a and b, read at run-time indices
#pragma unroll
  for (int i = 0; i < K; ++i) {
    L[i] = a[i];
    L[K + i] = b[i];
  }
  auto prod = [&](const int i, const int j) { return L[i] * L[K + j]; };
  auto err = [&](const int i, const int j) {
    const T x = L[i], y = L[K + j];
    const T p = x * y;
    T xh, xl, yh, yl;
    split(x, xh, xl);
    split(y, yh, yl);
    return ((xh * yh - p) + xh * yl + xl * yh) + xl * yl;
  };
  T tail = a[1] * b[K - 1];
#pragma unroll
  for (int i = 2; i < K; ++i) tail = tail + a[i] * b[K - i];

  T c[K], v[K];
  // steps 0 .. 2K-2: the tail, diagonal K-1's products, its errors i = K-2..1
#pragma unroll
  for (int t = 0; t < 2 * K - 1; ++t) {
    const T in = t == 0 ? tail : t <= K ? prod(K - t, t - 1) : err(2 * K - 1 - t, t - K - 1);
    wave_step<K, true>(c, v, t, M, in);
  }
  // steps 2K-1 .. M-1, every sweep running: sweep K-1's residue rows are
  // chain-summed from the last, as renorm_terms sums them
  T chain = wave_step<K, false>(c, v, 0, M, err(0, K - 2));
#pragma unroll 1
  for (int n = K - 2; n >= 0; --n) {
#pragma unroll 1
    for (int i = n; i >= 0; --i) chain = chain + wave_step<K, false>(c, v, 0, M, prod(i, n - i));
#pragma unroll 1
    for (int i = n - 1; i >= 0; --i)
      chain = chain + wave_step<K, false>(c, v, 0, M, err(i, n - 1 - i));
  }
  // steps M .. M+K-2: the sweeps end
#pragma unroll
  for (int t = M; t < M + K - 1; ++t) chain = chain + wave_step<K, true>(c, v, t, M, T(0));
#pragma unroll
  for (int k = 0; k < K; ++k) xs[k] = c[k];
  xs[K] = chain;
}

// Where the classic product runs as mul_sweeps: K >= 11, the builds where it
// measured faster than the unrolled form in the GEMM, the factor and the
// solve alike (K = 13 GEMM 3.2-3.3x).  At classic K = 3-10 one of them ran
// more than 3% slower so (a loop step and its loads against a handful of
// TwoSums).  The scaled product keeps the unrolled form at every K: at
// K = 9 its GEMM, solve and 120-block factor ran 1.1-1.9x faster as
// mul_sweeps, but a one-block factor 2.9-4.6% slower (its pivot chain's
// rsqrt, one thread's latency).  (tools/kernel_times.py --classic-ks /
// --scaled-ks and --labels wide, both forms and the parent in turns;
// NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §6.)
template <int K>
__host__ __device__ constexpr bool wavefront_product() {
  return K >= 11;
}

// Newton steps: limbs of accuracy double per step from one, plus one.
template <int K>
__host__ __device__ constexpr int newton_steps() {
  int n = 0;
  int acc = 1;
  while (acc < K) {
    acc *= 2;
    ++n;
  }
  return n + 1;
}

// ---------------------------------------------------------------------------
// Classic representation: value = sum of K float64 limbs.

using Limb = double;

template <int K>
struct MPv {
  double x[K];
};

template <int K>
using Val = MPv<K>;

template <int K>
__device__ __forceinline__ MPv<K> zero() {
  MPv<K> r;
#pragma unroll
  for (int i = 0; i < K; ++i) r.x[i] = 0.0;
  return r;
}

// A constant held in one limb (0.5, 1, 1.5).
template <int K>
__device__ __forceinline__ MPv<K> constant(double v) {
  MPv<K> r = zero<K>();
  r.x[0] = v;
  return r;
}

template <int K>
__device__ __forceinline__ MPv<K> neg(const MPv<K>& a) {
  MPv<K> r;
#pragma unroll
  for (int i = 0; i < K; ++i) r.x[i] = -a.x[i];
  return r;
}

template <int K, int M>
__device__ __forceinline__ MPv<K> renorm(double (&xs)[M]) {
  renorm_terms<K, M>(xs);
  MPv<K> r;
#pragma unroll
  for (int i = 0; i < K; ++i) r.x[i] = xs[i];
  return r;
}

// a + b: limbs interleaved a0 b0 a1 b1 ..., then renorm (mplist.add).
template <int K>
__device__ __forceinline__ MPv<K> add(const MPv<K>& a, const MPv<K>& b) {
  double xs[2 * K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    xs[2 * i] = a.x[i];
    xs[2 * i + 1] = b.x[i];
  }
  return renorm<K, 2 * K>(xs);
}

template <int K>
__device__ __forceinline__ MPv<K> sub(const MPv<K>& a, const MPv<K>& b) {
  return add<K>(a, neg<K>(b));
}

// Truncated product (mplist._mul_terms_classic + mul).
template <int K>
__device__ __forceinline__ MPv<K> mul(const MPv<K>& a, const MPv<K>& b) {
  if constexpr (wavefront_product<K>()) {
    double xs[K + 1];
    mul_sweeps<K>(a.x, b.x, xs);
    compact<K>(xs);
    MPv<K> r;
#pragma unroll
    for (int i = 0; i < K; ++i) r.x[i] = xs[i];
    return r;
  } else {
    double xs[K * K + 1];
    mul_terms<K>(a.x, b.x, xs, [](double v, int) { return v; });
    return renorm<K, K * K + 1>(xs);
  }
}

// 1/sqrt(a) for a > 0: r <- r (3/2 - a r^2 / 2), seeded with the correctly
// rounded 1/sqrt(a0 + a1) (mplist.rsqrt; the device rsqrt() is not
// correctly rounded and is never used).
template <int K>
__device__ __forceinline__ MPv<K> rsqrt_seed(const MPv<K>& a) {
  return constant<K>(1.0 / sqrt(a.x[0] + a.x[1]));
}

// The Newton steps of rsqrt, shared by both representations: r <- r (3/2 -
// (1/2) (a (r r))), the same operations on the same operands as
// mplist.rsqrt: mul(r, r), mul(a, .), mul(half, .), sub(three_half, .),
// mul(r, .).  One loop over the steps' products, so that the loop body
// holds one product and one difference: a pivot chain that runs them back
// to back fetches that code once, not four times (a scaled product is
// thousands of instructions): one thread's scaled K = 8 rsqrt took 123,718
// cycles so against 328,672 as a loop of four products a step.  Classic
// K = 4 lost in that thread, 21,508 cycles against 17,398, yet the classic
// factor that runs it took 1.46 ms a ladder iteration against 1.63
// (tools/mp_chain_probe.cu ops 2 and 7, tools/kernel_times.py; NVIDIA
// H100 80GB HBM3, 700.00 W; PERF.md §6).
template <int K, typename V, typename Mul, typename Sub>
__device__ __forceinline__ V rsqrt_steps(const V& a, V r, const V& half, const V& three_half,
                                         Mul mul, Sub sub) {
  V x = r, y = r;  // the next product's operands
#pragma unroll 1
  for (int q = 0; q < 4 * newton_steps<K>(); ++q) {
    const V m = mul(x, y);
    switch (q & 3) {
      case 0: x = a; y = m; break;                     // a (r r)
      case 1: x = half; y = m; break;                  // (1/2) a r^2
      case 2: x = r; y = sub(three_half, m); break;    // r (3/2 - ...)
      default: r = m; x = m; y = m; break;             // the next r r
    }
  }
  return r;
}

template <int K, typename Mul, typename Sub>
__device__ __forceinline__ MPv<K> rsqrt(const MPv<K>& a, Mul mul_, Sub sub_) {
  return rsqrt_steps<K>(a, rsqrt_seed<K>(a), constant<K>(0.5), constant<K>(1.5), mul_, sub_);
}

template <int K>
__device__ __forceinline__ MPv<K> rsqrt(const MPv<K>& a) {
  return rsqrt<K>(a, [](const MPv<K>& x, const MPv<K>& y) { return mul<K>(x, y); },
                  [](const MPv<K>& x, const MPv<K>& y) { return sub<K>(x, y); });
}

// 1/a: r <- r + r (1 - a r), seeded with 1 / (a0 + a1) (mplist.reciprocal).
template <int K>
__device__ __forceinline__ MPv<K> reciprocal(const MPv<K>& a) {
  MPv<K> r = constant<K>(1.0 / (a.x[0] + a.x[1]));
  const MPv<K> one = constant<K>(1.0);
#pragma unroll 1
  for (int s = 0; s < newton_steps<K>(); ++s) {
    MPv<K> err = sub<K>(one, mul<K>(a, r));
    r = add<K>(r, mul<K>(r, err));
  }
  return r;
}

// Limb-major storage; classic values have no exponent array.
template <int K>
__device__ __forceinline__ MPv<K> load(const double* x, const int*, size_t stride,
                                       size_t idx) {
  MPv<K> r;
#pragma unroll
  for (int k = 0; k < K; ++k) r.x[k] = x[k * stride + idx];
  return r;
}

template <int K>
__device__ __forceinline__ void store(double* x, int*, size_t stride, size_t idx,
                                      const MPv<K>& v) {
#pragma unroll
  for (int k = 0; k < K; ++k) x[k * stride + idx] = v.x[k];
}

}  // namespace mpk

#if MP_SCALED
#include "mp_scaled.cuh"
namespace ar = mps;
#else
namespace ar = mpk;
#endif

// One outlined copy of the MP product and sum, for the kernels whose hot
// loops run several of them: inlined at every call site, a scaled K = 8
// product is about 3,700 SASS instructions (60 KB of code), and a loop
// holding four of them ran each 2.2x slower in one thread than a loop
// holding one, on instruction fetch (NVIDIA H100 80GB HBM3, 700.00 W;
// PERF.md §6, step 0).  Called
// through these, a kernel holds each operation's code once.
namespace mpo {

template <int K>
__device__ __noinline__ ar::Val<K> mul(ar::Val<K> a, ar::Val<K> b) {
  return ar::mul<K>(a, b);
}

template <int K>
__device__ __noinline__ ar::Val<K> add(ar::Val<K> a, ar::Val<K> b) {
  return ar::add<K>(a, b);
}

template <int K>
__device__ __forceinline__ ar::Val<K> sub(const ar::Val<K>& a, const ar::Val<K>& b) {
  return mpo::add<K>(a, ar::neg<K>(b));
}

template <int K>
__device__ __forceinline__ ar::Val<K> rsqrt(const ar::Val<K>& a) {
  return ar::rsqrt<K>(a, [](const ar::Val<K>& x, const ar::Val<K>& y) { return mpo::mul<K>(x, y); },
                      [](const ar::Val<K>& x, const ar::Val<K>& y) { return mpo::sub<K>(x, y); });
}

}  // namespace mpo
