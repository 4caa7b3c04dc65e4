// Two-word (wide) MP arithmetic inside the CUDA kernels (namespace mpw): the
// compact ops of ops/mpwide_kernel.py (add_st_c, mul_st_c, add_full_c,
// mul_full_c, wfma_term_c, wacc_c, wnormalize_c), operation for operation,
// over the scaled words of mp_scaled.cuh (SV<K>, pow2f, normalize, EXP_ZERO).
//
// A wide value is a pair of scaled words (w0, w1) with |w1| <~ 2^-(24K) |w0|.
// Each op builds a row stack, laid out so that every distillation sweep
// runs over contiguous rows in the plain version's logical order:
//   add_st     [0, 2K) interleaved aligned limbs, 2 zero rows
//   add_full   [0, 2K) hi stack; lo stack = [K, 5K + 2): residual, spill,
//              interleaved routed lo limbs, 2 zero rows
//   mul_st     [0, n_mul) plan rows, 2 zero rows; products and errors at
//              [n_mul + 2, n_mul + 2 + 2K^2)
//   mul_full   [0, 2K^2) hi stack in plan order; spill [2K^2, 2K^2 + K);
//              2 zero rows; products and errors at slot + 2K^2 + K + 2, each
//              replaced in place by its routed lo part; lo stack =
//              [K, 4K^2 + K + 2): residual, spill, zeros, slots
// The sweeps of a stack run as one register wavefront (sweeps below), which
// reads each row once.  The stacks of add_st and add_full (at most 5K + 2
// rows) are local arrays with every index known at compile time, so they
// live in registers; those of mul_st and mul_full share a per-thread
// scratch array S of ROWS = 4K^2 + K + 2 floats (plus K^2 ints of
// placement exponents in D) in local memory, their row loops runtime loops
// (#pragma unroll 1), which bounds the compile time.
//
// Bit-exactness with the plain version rests on the build rules of mp.cuh
// (-fmad=false -ftz=false) and on two details:
//   * powers of two are applied as separate staged multiplies (scale1), and
//     the re-laddering lift of a residual limb is an exponent-field
//     addition, or for a subnormal its integer mantissa times 2^(24K-149);
//   * limbs within 2 of float32's subnormal range are spilled from the hi
//     word onto the lo ladder (the Pallas kernel's guard against Mosaic's
//     flushing multiplies), although nothing flushes here.
// Included by mp_wide_matmul.cu, built with -DMP_WIDE=1 -DMP_SCALED=1.
#pragma once

#include "mp.cuh"

#if !MP_SCALED || !defined(MP_WIDE) || !MP_WIDE
#error "the wide library is built with -DMP_WIDE=1 -DMP_SCALED=1 (scaled words)"
#endif

namespace mpw {

using mps::EXP_ZERO;
using mps::MUL_UNIFORM_EXP;
using mps::SV;
using mps::center;
using mps::clip;
using mps::pow2f;

template <int K>
__host__ __device__ constexpr int n_full() {
  return 2 * K * K;
}

template <int K>
__host__ __device__ constexpr int n_mul() {
  return K * K + K - 1;
}

template <int K>
__host__ __device__ constexpr int rows() {
  return 4 * K * K + K + 2;
}

// The static product plans (mpfloat.mul_term_plan_full, mul_term_plan):
// full[j] is the slot (i*K + j: product, K^2 + i*K + j: its error) of the
// j-th hi row of a full product; mul[j] / diag[j] the slot and product
// diagonal of the j-th row of a truncated product.
template <int K>
struct Plan {
  int full[n_full<K>()];
  int mul[n_mul<K>()];
  int diag[n_mul<K>()];
};

template <int K>
__host__ __device__ constexpr Plan<K> make_plan() {
  Plan<K> p{};
  int t = 0;
  for (int n = 0; n < 2 * K - 1; ++n) {
    const int lo = n - K + 1 > 0 ? n - K + 1 : 0;
    const int hi = K < n + 1 ? K : n + 1;
    for (int i = lo; i < hi; ++i) {
      p.full[t++] = i * K + n - i;
      p.full[t++] = K * K + i * K + n - i;
    }
  }
  t = 0;
  for (int n = 0; n <= K; ++n) {
    if (n < K) {
      for (int i = 0; i <= n; ++i) {
        p.mul[t] = i * K + n - i;
        p.diag[t++] = n;
      }
    }
    if (n >= 1 && n <= K - 1) {
      for (int i = 0; i < n; ++i) {
        p.mul[t] = K * K + i * K + n - 1 - i;
        p.diag[t++] = n - 1;
      }
    }
    if (n == K) {
      for (int i = 1; i < K; ++i) {
        p.mul[t] = i * K + K - i;
        p.diag[t++] = n;
      }
    }
  }
  return p;
}

// static: one copy in each object of a library (mp_wide3_matmul.cu and
// mp_wide3_ops.cu both include this header)
static __constant__ Plan<MP_K> kPlan = make_plan<MP_K>();

__device__ __forceinline__ int exp_bits(float x) { return (__float_as_int(x) >> 23) & 0xFF; }

// x * 2^d in three clipped stages, each rounding once; a negative residue
// flushes to zero.
__device__ __forceinline__ float scale1(float x, int d) {
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const int step = clip(d, -126, 127);
    x = x * pow2f(step);
    d -= step;
  }
  return d < 0 ? 0.0f : x;
}

// Exact x * 2^p (p = 24K) for normal and subnormal x.
__device__ __forceinline__ float lift(float x, int p) {
  const int bits = __float_as_int(x);
  if (((bits >> 23) & 0xFF) != 0) return __int_as_float(bits + (p << 23));
  const float mant = (float)(bits & 0x7FFFFF);
  const float sign = bits < 0 ? -1.0f : 1.0f;
  return sign * mant * pow2f(p - 149);
}

// K carry-chain extraction sweeps over x[0, m) (m >= K + 1): sweep k runs
// i = m-2 .. k with (carry, x[i+1]) = two_sum(x[i], carry) from carry =
// x[m-1], then x[k] = carry; with CHAIN the residue rows K.. are then
// chain-summed into x[K] (and rows K+1.. are left as they were).
//
// The sweeps run as one register wavefront over the rows, with the same
// TwoSums on the same values: sweep k's step at row j+k reads only what
// sweep k-1 wrote down to row j+k-1, so at each row j (descending) the
// value read passes through the K sweeps in turn, each holding its carry
// in a register.  Each row is read once, and written once (the residual
// rows K.., without CHAIN); the chain tail sums the last sweep's outputs
// in the order they leave it.  M > 0 is m known at compile time: the
// loops unroll and a row stack in a local array stays in registers.
template <int K, bool CHAIN, int M>
__device__ __forceinline__ void sweeps(float* x, int m) {
  float c[K];
  float chain = 0.0f;
  auto row = [&](int j) {
    float v = x[j];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int r = j + k;  // the row sweep k is at
      if (r < m - 1) {
        float s, e;
        mpk::two_sum(v, c[k], s, e);
        c[k] = s;
        v = e;  // row r + 1 after sweep k: sweep k + 1's input
      } else if (r == m - 1) {
        c[k] = v;  // sweep k starts
      }
    }
    if (j <= m - 1 - K) {  // v is the final row j + K
      if (CHAIN)
        chain = j == m - 1 - K ? v : chain + v;
      else
        x[j + K] = v;
    }
  };
  if constexpr (M > 0) {
#pragma unroll
    for (int j = M - 1; j >= 0; --j) row(j);
  } else {
#pragma unroll 1
    for (int j = m - 1; j >= 0; --j) row(j);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) x[k] = c[k];
  if (CHAIN) x[K] = chain;
}

// Sweeps with the chain tail, quick-TwoSum compaction of rows 0..K forward
// and back, normalize at exponent e (renorm_st).
template <int K, int M>
__device__ __forceinline__ SV<K> finish(float* x, int m, int e) {
  sweeps<K, true, M>(x, m);
  float xs[K + 1];
#pragma unroll
  for (int i = 0; i <= K; ++i) xs[i] = x[i];
  mpk::compact<K>(xs);
  SV<K> r;
#pragma unroll
  for (int i = 0; i < K; ++i) r.x[i] = xs[i];
  r.e = e;
  mps::normalize<K>(r);
  return r;
}

// Aligned scaled add (add_st_c); its 2K + 2 rows in registers.
template <int K>
__device__ SV<K> add_st(const SV<K>& a, const SV<K>& b) {
  const int e = a.e > b.e ? a.e : b.e;
  float S[2 * K + 2];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    S[2 * i] = scale1(a.x[i], a.e - e);
    S[2 * i + 1] = scale1(b.x[i], b.e - e);
  }
  S[2 * K] = 0.0f;
  S[2 * K + 1] = 0.0f;
  return finish<K, 2 * K + 2>(S, 2 * K + 2, e);
}

// Products and Dekker errors of two limb vectors into PE[slot].
template <int K>
__device__ __forceinline__ void products(const float (&as)[K], const float (&bs)[K],
                                         float* PE) {
  float ah[K], al[K], bh[K], bl[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    mpk::split(as[i], ah[i], al[i]);
    mpk::split(bs[i], bh[i], bl[i]);
  }
#pragma unroll 1
  for (int i = 0; i < K; ++i) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float p = as[i] * bs[j];
      PE[i * K + j] = p;
      PE[K * K + i * K + j] =
          ((ah[i] * bh[j] - p) + ah[i] * bl[j] + al[i] * bh[j]) + al[i] * bl[j];
    }
  }
}

// Truncated scaled product (mul_st_c): limbs prescaled by their rung, the
// plan rows put back on the result's ladder by two factors.
template <int K>
__device__ SV<K> mul_st(const SV<K>& a, const SV<K>& b, float* S) {
  constexpr int C = center<K>();
  constexpr int NM = n_mul<K>();
  float as[K], bs[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const float pre = pow2f(24 * i - C + MUL_UNIFORM_EXP);
    as[i] = a.x[i] * pre;
    bs[i] = b.x[i] * pre;
  }
  float* PE = S + NM + 2;
  products<K>(as, bs, PE);
#pragma unroll 1
  for (int j = 0; j < NM; ++j) {
    const int d = C - 2 * MUL_UNIFORM_EXP - 24 * kPlan.diag[j];
    const int d1 = clip(d, -126, 127);
    const int d2 = clip(d - d1, -126, 127);
    S[j] = PE[kPlan.mul[j]] * pow2f(d1) * pow2f(d2);
  }
  S[NM] = 0.0f;
  S[NM + 1] = 0.0f;
  return finish<K, 0>(S, NM + 2, a.e + b.e + C);
}

// Compaction of the K extracted rows into the hi limbs; limbs with exponent
// bits < 26 go, lifted exactly by 2^(24K), to spill[].
template <int K>
__device__ __forceinline__ SV<K> extract_hi(const float* x, int e, float* spill) {
  float h[K];
#pragma unroll
  for (int i = 0; i < K; ++i) h[i] = x[i];
#pragma unroll
  for (int i = 0; i < K - 1; ++i) mpk::two_sum(h[i], h[i + 1], h[i], h[i + 1]);
#pragma unroll
  for (int i = K - 1; i > 0; --i) mpk::two_sum(h[i - 1], h[i], h[i - 1], h[i]);
  SV<K> r;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const bool keep = exp_bits(h[i]) >= 26;
    spill[i] = lift(keep ? 0.0f : h[i], 24 * K);
    r.x[i] = keep ? h[i] : 0.0f;
  }
  r.e = e;
  mps::normalize<K>(r);
  return r;
}

// Word TwoSum hi + lo == a + b (add_full_c); its 5K + 2 rows in registers.
template <int K>
__device__ void add_full(const SV<K>& a, const SV<K>& b, SV<K>& hi, SV<K>& lo) {
  const int e_hi = a.e > b.e ? a.e : b.e;
  const int da = a.e - e_hi, db = b.e - e_hi;
  float S[5 * K + 2];
  float* LO = S + 3 * K;  // interleaved routed lo limbs
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const bool ka = exp_bits(a.x[i]) + da >= 24;
    const bool kb = exp_bits(b.x[i]) + db >= 24;
    S[2 * i] = scale1(ka ? a.x[i] : 0.0f, da);
    S[2 * i + 1] = scale1(kb ? b.x[i] : 0.0f, db);
    LO[2 * i] = scale1(ka ? 0.0f : a.x[i], da + 24 * K);
    LO[2 * i + 1] = scale1(kb ? 0.0f : b.x[i], db + 24 * K);
  }
  sweeps<K, false, 2 * K>(S, 2 * K);
  hi = extract_hi<K>(S, e_hi, S + 2 * K);
#pragma unroll
  for (int i = K; i < 2 * K; ++i) S[i] = lift(S[i], 24 * K);
  S[5 * K] = 0.0f;
  S[5 * K + 1] = 0.0f;
  lo = finish<K, 4 * K + 2>(S + K, 4 * K + 2, e_hi - 24 * K);
}

// Exact word product hi + lo == a * b (mul_full_c).
template <int K>
__device__ void mul_full(const SV<K>& a, const SV<K>& b, SV<K>& hi, SV<K>& lo, float* S,
                         int* D) {
  constexpr int C = center<K>();
  constexpr int NF = n_full<K>();
  constexpr int KK = K * K;
  float as[K], bs[K];
  int la[K], lb[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int ea = exp_bits(a.x[i]), eb = exp_bits(b.x[i]);
    la[i] = ea == 0 ? 0 : MUL_UNIFORM_EXP + 127 - ea;
    lb[i] = eb == 0 ? 0 : MUL_UNIFORM_EXP + 127 - eb;
    as[i] = scale1(a.x[i], la[i]);
    bs[i] = scale1(b.x[i], lb[i]);
  }
#pragma unroll
  for (int i = 0; i < K; ++i) {
#pragma unroll
    for (int j = 0; j < K; ++j) D[i * K + j] = -(la[i] + lb[j]) - C;
  }
  float* PE = S + NF + K + 2;
  products<K>(as, bs, PE);
#pragma unroll 1
  for (int j = 0; j < NF; ++j) {
    const int i = kPlan.full[j];
    const float t = PE[i];
    const int d = D[i % KK];
    const bool keep = exp_bits(t) + d >= 24;
    S[j] = scale1(keep ? t : 0.0f, d);
    PE[i] = scale1(keep ? 0.0f : t, d + 24 * K);
  }
  sweeps<K, false, 0>(S, NF);
  const int e_hi = a.e + b.e + C;
  hi = extract_hi<K>(S, e_hi, S + NF);
#pragma unroll 1
  for (int i = K; i < NF; ++i) S[i] = lift(S[i], 24 * K);
  S[NF + K] = 0.0f;
  S[NF + K + 1] = 0.0f;
  lo = finish<K, 0>(S + K, 2 * NF + 2, e_hi - 24 * K);
}

// The accumulator-free part of acc + a b (wfma_term_c): the exact hi
// product p0 and the carry cp = (a0 b1 + a1 b0) + p1.
template <int K>
__device__ void fma_term(const SV<K>& a0, const SV<K>& a1, const SV<K>& b0,
                         const SV<K>& b1, SV<K>& p0, SV<K>& cp, float* S, int* D) {
  SV<K> p1;
  mul_full<K>(a0, b0, p0, p1, S, D);
  const SV<K> c01 = mul_st<K>(a0, b1, S);
  const SV<K> c10 = mul_st<K>(a1, b0, S);
  cp = add_st<K>(add_st<K>(c01, c10), p1);
}

// The accumulate part (wacc_c): (h, l) += (p0, cp) in place, the hi
// product through one word TwoSum, the rest through truncated adds.
template <int K>
__device__ void fma_acc(SV<K>& h, SV<K>& l, const SV<K>& p0, const SV<K>& cp) {
  const SV<K> h0 = h;
  SV<K> e;
  add_full<K>(h0, p0, h, e);
  l = add_st<K>(add_st<K>(l, e), cp);
}

// Re-establish the two-word invariant (wnormalize_c).
template <int K>
__device__ void normalize(SV<K>& h, SV<K>& l) {
  const SV<K> a = h, b = l;
  add_full<K>(a, b, h, l);
}

}  // namespace mpw
