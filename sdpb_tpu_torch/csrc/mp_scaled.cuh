// The scaled MP representation inside the CUDA kernels (namespace mps):
// value = 2^e * (x[0] + ... + x[K-1]) with float32 limbs normalized so that
// x[0] has binary exponent CENTER(K) = max(0, 24K - 100), and an int32
// exponent e per element (EXP_ZERO for an exact zero).
//
// The CUDA counterpart of the scaled path of sdpb_tpu/ops/mplist.py
// (pow2f :33, scale_pow2 :39, normalize_scaled :108, add :125, mul :181,
// rsqrt :333, reciprocal :357), operation for operation, so results agree
// limb for limb with the plain PyTorch versions (mpfloat.kmul order).
// Two points carry the bit-exactness:
//   * powers of two are assembled from bits and applied in three clipped
//     steps, each rounding once, as scale_pow2 does: one ldexpf/scalbnf
//     would round once where the reference rounds up to three times in the
//     subnormal range;
//   * subnormals are kept (-ftz=false), and a leading limb whose exponent
//     bits are 0 (zero or subnormal) marks an exact zero, as in
//     normalize_scaled.
// Included by mp.cuh when built with -DMP_SCALED=1.
#pragma once

#include "mp.cuh"

namespace mps {

using Limb = float;

constexpr int EXP_ZERO = -(1 << 24);
constexpr int MUL_UNIFORM_EXP = 15;

template <int K>
__host__ __device__ constexpr int center() {
  return 24 * K - 100 > 0 ? 24 * K - 100 : 0;
}

template <int K>
struct SV {
  float x[K];
  int e;
};

template <int K>
using Val = SV<K>;

// Exact 2^e for e in [-126, 127].
__device__ __forceinline__ float pow2f(int e) { return __int_as_float((e + 127) << 23); }

__device__ __forceinline__ int clip(int d, int lo, int hi) {
  return d < lo ? lo : (d > hi ? hi : d);
}

// x * 2^d in three clipped steps; a negative residue flushes to zero.
template <int N>
__device__ __forceinline__ void scale_pow2(float (&x)[N], int d) {
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const int step = clip(d, -126, 127);
    const float f = pow2f(step);
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = x[i] * f;
    d -= step;
  }
  if (d < 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = 0.0f;
  }
}

// Re-center v (exponent v.e) so x[0] has binary exponent CENTER(K).
template <int K>
__device__ __forceinline__ void normalize(SV<K>& v) {
  const int eb = (__float_as_int(v.x[0]) >> 23) & 0xFF;
  if (eb == 0) {
#pragma unroll
    for (int i = 0; i < K; ++i) v.x[i] = 0.0f;
    v.e = EXP_ZERO;
    return;
  }
  const int shift = eb - 127 - center<K>();
  scale_pow2(v.x, -shift);
  v.e += shift;
}

template <int K, int M>
__device__ __forceinline__ SV<K> renorm(float (&xs)[M], int e) {
  mpk::renorm_terms<K, M>(xs);
  SV<K> r;
#pragma unroll
  for (int i = 0; i < K; ++i) r.x[i] = xs[i];
  r.e = e;
  normalize<K>(r);
  return r;
}

template <int K>
__device__ __forceinline__ SV<K> zero() {
  SV<K> r;
#pragma unroll
  for (int i = 0; i < K; ++i) r.x[i] = 0.0f;
  r.e = EXP_ZERO;
  return r;
}

// f * 2^e from one float (Newton seeds; mplist.from_float).
template <int K>
__device__ __forceinline__ SV<K> from_float(float f, int e) {
  SV<K> r = zero<K>();
  r.x[0] = f;
  r.e = e;
  normalize<K>(r);
  return r;
}

// A constant exactly representable in one float32 (mplist.const).
template <int K>
__device__ __forceinline__ SV<K> constant(float v) {
  int ex;
  const float m = frexpf(v, &ex);
  SV<K> r = zero<K>();
  r.x[0] = m * pow2f(center<K>() + 1);
  r.e = ex - 1 - center<K>();
  return r;
}

template <int K>
__device__ __forceinline__ SV<K> neg(const SV<K>& a) {
  SV<K> r;
#pragma unroll
  for (int i = 0; i < K; ++i) r.x[i] = -a.x[i];
  r.e = a.e;
  return r;
}

// a + b: both aligned on the larger exponent, limbs interleaved, renorm.
template <int K>
__device__ __forceinline__ SV<K> add(const SV<K>& a, const SV<K>& b) {
  const int e = a.e > b.e ? a.e : b.e;
  float ax[K], bx[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    ax[i] = a.x[i];
    bx[i] = b.x[i];
  }
  scale_pow2(ax, a.e - e);
  scale_pow2(bx, b.e - e);
  float xs[2 * K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    xs[2 * i] = ax[i];
    xs[2 * i + 1] = bx[i];
  }
  return renorm<K, 2 * K>(xs, e);
}

template <int K>
__device__ __forceinline__ SV<K> sub(const SV<K>& a, const SV<K>& b) {
  return add<K>(a, neg<K>(b));
}

// Truncated product: every limb rescaled to about 2^MUL_UNIFORM_EXP, the
// mplist terms each put back on the result's ladder by two exact powers of
// two chosen by the product's diagonal n (the tail after its chained sum).
template <int K>
__device__ __forceinline__ SV<K> mul(const SV<K>& a, const SV<K>& b) {
  constexpr int C = center<K>();
  float al[K], bl[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const float pre = pow2f(24 * i - C + MUL_UNIFORM_EXP);
    al[i] = a.x[i] * pre;
    bl[i] = b.x[i] * pre;
  }
  float xs[K * K + 1];
  mpk::mul_terms<K>(al, bl, xs, [](float v, int n) {
    const int d = C - 2 * MUL_UNIFORM_EXP - 24 * n;
    const int d1 = clip(d, -126, 127);
    const int d2 = clip(d - d1, -126, 127);
    return v * pow2f(d1) * pow2f(d2);
  });
  return renorm<K, K * K + 1>(xs, a.e + b.e + C);
}

// 1/sqrt(a) for a > 0: the seed is the correctly rounded 1/sqrt of the
// mantissa times 2^(E mod 2), at exponent -floor(E/2), E = e + CENTER; the
// Newton steps are mpk::rsqrt_steps.
template <int K>
__device__ __forceinline__ SV<K> rsqrt_seed(const SV<K>& a) {
  constexpr int C = center<K>();
  const int E = a.e + C;
  const int q = E >> 1;  // floor(E / 2), an arithmetic shift as in jnp
  const float m = (a.x[0] + a.x[1]) * pow2f(-(C < 126 ? C : 126));
  const float x2 = m * pow2f(E - 2 * q);
  return from_float<K>(1.0f / sqrtf(x2), -q);
}

template <int K, typename Mul, typename Sub>
__device__ __forceinline__ SV<K> rsqrt(const SV<K>& a, Mul mul_, Sub sub_) {
  return mpk::rsqrt_steps<K>(a, rsqrt_seed<K>(a), constant<K>(0.5f), constant<K>(1.5f), mul_,
                             sub_);
}

template <int K>
__device__ __forceinline__ SV<K> rsqrt(const SV<K>& a) {
  return rsqrt<K>(a, [](const SV<K>& x, const SV<K>& y) { return mul<K>(x, y); },
                  [](const SV<K>& x, const SV<K>& y) { return sub<K>(x, y); });
}

// 1/a: r <- r + r (1 - a r), seeded with the mantissa's reciprocal.
template <int K>
__device__ __forceinline__ SV<K> reciprocal(const SV<K>& a) {
  constexpr int C = center<K>();
  const float m = (a.x[0] + a.x[1]) * pow2f(-(C < 126 ? C : 126));
  SV<K> r = from_float<K>(1.0f / m, -(a.e + C));
  const SV<K> one = constant<K>(1.0f);
#pragma unroll 1
  for (int s = 0; s < mpk::newton_steps<K>(); ++s) {
    SV<K> err = sub<K>(one, mul<K>(a, r));
    r = add<K>(r, mul<K>(r, err));
  }
  return r;
}

template <int K>
__device__ __forceinline__ SV<K> load(const float* x, const int* e, size_t stride,
                                      size_t idx) {
  SV<K> r;
#pragma unroll
  for (int k = 0; k < K; ++k) r.x[k] = x[k * stride + idx];
  r.e = e[idx];
  return r;
}

template <int K>
__device__ __forceinline__ void store(float* x, int* e, size_t stride, size_t idx,
                                      const SV<K>& v) {
#pragma unroll
  for (int k = 0; k < K; ++k) x[k * stride + idx] = v.x[k];
  e[idx] = v.e;
}

}  // namespace mps
