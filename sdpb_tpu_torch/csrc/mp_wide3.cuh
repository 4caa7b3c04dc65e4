// Three-word (wide) MP arithmetic inside the CUDA kernels: the sum and the
// product of two values of G = 3 scaled words (float32 limbs and an int32
// exponent each, Kg = MP_K limbs a word: 19-27 limbs in all, --precision
// 425-640), over the word ops of mp_wide.cuh (add_st, mul_st, add_full,
// mul_full).  ops/mpwide_kernel.py performs the same operations in the same
// order (word_two_sum_c, renormalize_words_c, mul_full3_c, wmul_g_c,
// wadd_g_c), so the kernels and their plain versions agree limb for limb
// and exponent for exponent (-fmad=false -ftz=false, mp.cuh).
//
// The order is that of the generic-G branches of the JAX package's
// mpwide.add and mul (sdpb_tpu/ops/mpwide.py:229-306), with three changes,
// each where that branch misses mpmath at G = 3 (ROADMAP C; two words never
// meet them): the word TwoSum leaves words more than 24 Kg digits apart as
// they are (add_full's lo ladder reaches only ~24 Kg + 150 digits below the
// top); two rounds of a bottom-up and a top-down pass of word TwoSums end
// a renormalization (after a cancellation the sweeps can leave word 0 zero
// or short and a lower word holding the value); and the exact product a0 b0 is three words (mul_full3:
// two words' product can need more than mul_full's two).
//
// Each word op is one outlined copy (__noinline__): a kernel's code holds
// one word TwoSum, one word add, one exact word product in three words and
// one in two, and one truncated word product, where inlined at each of a
// product's 44 word ops it would be fetched anew by every warp (the lesson
// of mp.cuh's mpo::).  A value's words and a product's 10 words live in
// local memory, the word products' row stacks in a per-thread scratch of
// ROWS3 = 6 Kg^2 + 2 Kg + 4 floats.  Included by
// mp_wide3_matmul.cu and mp_wide3_ops.cu, built with -DMP_WIDE=1
// -DMP_SCALED=1.
#pragma once

#include "mp_wide.cuh"

// Every function not inline is static: the header is compiled into both
// objects of a library, and nvcc gives each device function a host stub.
namespace mpw3 {

constexpr int K = MP_K;
constexpr int G = 3;
using SVk = mpw::SV<K>;

struct W {
  SVk w[G];
};

// The operands' and the output's words: limbs and exponents per word.
struct Words {
  const float* x[G];
  const int* e[G];
};

struct OutWords {
  float* x[G];
  int* e[G];
};

// The word TwoSum (word_two_sum_c): add_full, but (larger, smaller) as they
// are where the exponents lie more than 24 K apart.
static __device__ __noinline__ void two_sum_o(const SVk a, const SVk b, SVk* hi, SVk* lo) {
  const int gap = a.e - b.e;
  if (gap > 24 * K || gap < -24 * K) {
    *hi = gap >= 0 ? a : b;
    *lo = gap >= 0 ? b : a;
    return;
  }
  mpw::add_full<K>(a, b, *hi, *lo);
}

static __device__ __noinline__ SVk add_st_o(const SVk a, const SVk b) { return mpw::add_st<K>(a, b); }

static __device__ __noinline__ void mul_full_o(const SVk a, const SVk b, SVk* hi, SVk* lo, float* S,
                                        int* D) {
  mpw::mul_full<K>(a, b, *hi, *lo, S, D);
}

static __device__ __noinline__ SVk mul_st_o(const SVk a, const SVk b, float* S) {
  return mpw::mul_st<K>(a, b, S);
}

// Floats of a thread's row-stack scratch: mul_full3's three stacks.
constexpr int ROWS3 = 3 * mpw::n_full<K>() + 2 * K + 4;

// The exact word product in three words, hi + mid + lo == a * b up to the
// last word's truncation (mul_full3_c): mpw::mul_full with a third ladder
// 48 K digits down for the terms the second cannot hold as normals, and the
// second word extracted error-free as the first is.  S (ROWS3 floats):
// [0, NF) hi stack, [NF, NF + K) its spill, 2 zero rows, [NF + K + 2,
// 2 NF + K + 2) the mid slots, so that mid's stack is S[K, 2 NF + K + 2):
// hi's lifted residual, spill, zeros, slots; then mid's spill, 2 zero rows
// and [2 NF + 2 K + 4, 3 NF + 2 K + 4) the third ladder's slots, so that
// lo's stack is S[2 K, 3 NF + 2 K + 4).
static __device__ __noinline__ void mul_full3_o(const SVk a, const SVk b, SVk* hi, SVk* mid,
                                                SVk* lo, float* S, int* D) {
  constexpr int C = mps::center<K>();
  constexpr int NF = mpw::n_full<K>();
  constexpr int KK = K * K;
  float as[K], bs[K];
  int la[K], lb[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int ea = mpw::exp_bits(a.x[i]), eb = mpw::exp_bits(b.x[i]);
    la[i] = ea == 0 ? 0 : mps::MUL_UNIFORM_EXP + 127 - ea;
    lb[i] = eb == 0 ? 0 : mps::MUL_UNIFORM_EXP + 127 - eb;
    as[i] = mpw::scale1(a.x[i], la[i]);
    bs[i] = mpw::scale1(b.x[i], lb[i]);
  }
#pragma unroll
  for (int i = 0; i < K; ++i) {
#pragma unroll
    for (int j = 0; j < K; ++j) D[i * K + j] = -(la[i] + lb[j]) - C;
  }
  float* PE = S + NF + K + 2;
  float* T3 = S + 2 * NF + 2 * K + 4;
  mpw::products<K>(as, bs, PE);
#pragma unroll 1
  for (int j = 0; j < NF; ++j) {
    const int i = mpw::kPlan.full[j];
    const float t = PE[i];
    const int d = D[i % KK];
    const int e = mpw::exp_bits(t);
    const bool keep = e + d >= 24;
    const bool keep_mid = !keep && e + d + 24 * K >= 24;
    S[j] = mpw::scale1(keep ? t : 0.0f, d);
    PE[i] = mpw::scale1(keep_mid ? t : 0.0f, d + 24 * K);
    T3[i] = mpw::scale1(keep || keep_mid ? 0.0f : t, d + 48 * K);
  }
  const int e_hi = a.e + b.e + C;
  mpw::sweeps<K, false, 0>(S, NF);
  *hi = mpw::extract_hi<K>(S, e_hi, S + NF);
#pragma unroll 1
  for (int i = K; i < NF; ++i) S[i] = mpw::lift(S[i], 24 * K);
  S[NF + K] = 0.0f;
  S[NF + K + 1] = 0.0f;
  mpw::sweeps<K, false, 0>(S + K, 2 * NF + 2);
  *mid = mpw::extract_hi<K>(S + K, e_hi - 24 * K, S + 2 * NF + K + 2);
#pragma unroll 1
  for (int i = 2 * K; i < 2 * NF + K + 2; ++i) S[i] = mpw::lift(S[i], 24 * K);
  S[2 * NF + 2 * K + 2] = 0.0f;
  S[2 * NF + 2 * K + 3] = 0.0f;
  *lo = mpw::finish<K, 0>(S + 2 * K, 3 * NF + 4, e_hi - 48 * K);
}

// renormalize_words_c: G word TwoSum sweeps over xs[0, M), bottom up, the
// residue below word G-1 folded into it by word adds, then two rounds of a
// bottom-up and a top-down pass of word TwoSums over the G words.
template <int M>
__device__ __forceinline__ W renormalize(SVk (&xs)[M]) {
  static_assert(M > G, "renormalize takes more words than it keeps");
#pragma unroll 1
  for (int k = 0; k < G; ++k) {
#pragma unroll 1
    for (int i = M - 2; i >= k; --i) two_sum_o(xs[i], xs[i + 1], &xs[i], &xs[i + 1]);
  }
  SVk tail = xs[G - 1];
#pragma unroll 1
  for (int i = G; i < M; ++i) tail = add_st_o(tail, xs[i]);
  xs[G - 1] = tail;
#pragma unroll 1
  for (int round = 0; round < 2; ++round) {
#pragma unroll 1
    for (int i = G - 2; i >= 0; --i) two_sum_o(xs[i], xs[i + 1], &xs[i], &xs[i + 1]);
#pragma unroll 1
    for (int i = 0; i < G - 1; ++i) two_sum_o(xs[i], xs[i + 1], &xs[i], &xs[i + 1]);
  }
  W r;
#pragma unroll
  for (int g = 0; g < G; ++g) r.w[g] = xs[g];
  return r;
}

// Words of a product: three for the top word pair, two for each other
// pair below the last kept diagonal, one for each pair on it.
__host__ __device__ constexpr int product_words() {
  int m = 0;
  for (int g1 = 0; g1 < G; ++g1)
    for (int g2 = 0; g2 < G - g1; ++g2) m += g1 + g2 == 0 ? 3 : (g1 + g2 < G - 1 ? 2 : 1);
  return m;
}

// The product (wmul_g_c): the pair products in the loop order of (g1, g2),
// listed by diagonal (the top pair's three words on diagonals 0, 1, 2; any
// other pair's hi word on its own, its lo word on the next), then
// renormalized.
static __device__ W wmul(const W& a, const W& b, float* S, int* D) {
  constexpr int NP = G * (G + 1) / 2;
  constexpr int M = product_words();
  SVk hi[NP], lo[NP], top[3];
  mul_full3_o(a.w[0], b.w[0], &top[0], &top[1], &top[2], S, D);
  int p = 0;
#pragma unroll
  for (int g1 = 0; g1 < G; ++g1) {
#pragma unroll
    for (int g2 = 0; g2 < G - g1; ++g2, ++p) {
      if (g1 + g2 == 0) continue;
      if (g1 + g2 < G - 1)
        mul_full_o(a.w[g1], b.w[g2], &hi[p], &lo[p], S, D);
      else
        hi[p] = mul_st_o(a.w[g1], b.w[g2], S);
    }
  }
  SVk xs[M];
  int q = 0;
#pragma unroll
  for (int d = 0; d <= G; ++d) {
    p = 0;
#pragma unroll
    for (int g1 = 0; g1 < G; ++g1) {
#pragma unroll
      for (int g2 = 0; g2 < G - g1; ++g2, ++p) {
        const int n = g1 + g2;
        if (n == 0) {
          if (d < 3) xs[q++] = top[d];
        } else if (n == d) {
          xs[q++] = hi[p];
        } else if (n < G - 1 && n + 1 == d) {
          xs[q++] = lo[p];
        }
      }
    }
  }
  return renormalize<M>(xs);
}

// The sum (wadd_g_c): words interleaved a0 b0 a1 b1 ..., then renormalized.
static __device__ W wadd(const W& a, const W& b) {
  SVk xs[2 * G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    xs[2 * g] = a.w[g];
    xs[2 * g + 1] = b.w[g];
  }
  return renormalize<2 * G>(xs);
}

__device__ __forceinline__ W load_w(const float* x, const int* e, size_t words, size_t stride,
                                    size_t idx) {
  W v;
#pragma unroll
  for (int g = 0; g < G; ++g) v.w[g] = mps::load<K>(x + g * K * words, e + g * words, stride, idx);
  return v;
}

__device__ __forceinline__ void store_w(float* x, int* e, size_t words, size_t stride,
                                        size_t idx, const W& v) {
#pragma unroll
  for (int g = 0; g < G; ++g)
    mps::store<K>(x + g * K * words, e + g * words, stride, idx, v.w[g]);
}

}  // namespace mpw3
