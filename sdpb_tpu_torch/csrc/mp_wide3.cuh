// Three-word (wide) MP arithmetic inside the CUDA kernels: the sum and the
// product of two values of G = 3 scaled words (float32 limbs and an int32
// exponent each, Kg = MP_K limbs a word: 19-27 limbs in all, --precision
// 425-640), over the word ops of mp_wide.cuh (add_st, add_full, and the
// product plans, scalings and hi-word extraction).  ops/mpwide_kernel.py
// performs the same operations in the same order (word_two_sum_c,
// renormalize_words_c, mul_full3_c, mul_full_c, mul_st_c, wmul_g_c,
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
// or short and a lower word holding the value); and the exact product a0 b0
// is three words (mul_full3: two words' product can need more than
// mul_full's two).
//
// A product runs in one thread, and most of its float operations are its
// six word products' TwoSum sweeps over row stacks of up to 3 NF + 2 K + 4
// rows (NF = 2 Kg^2).  mpw::sweeps runs a stack a row at a time, the row's
// K TwoSums one after another (~5 K dependent adds a row), and keeping
// every limb product and its error beside the ladders (as mpw::mul_full
// does) takes the three-ladder product 3 NF + 2 K + 4 floats and K^2 ints,
// ~2.4 KB a thread at Kg = 9 in local memory, which at sixteen warps an SM
// overflows the L2 cache.  Here (a) the sweeps run as a skewed wavefront (skewed_sweeps: K
// independent TwoSums a step, two steps an iteration, the next rows fetched
// two steps ahead, the residual rows lifted as they are stored), and (b)
// the limb products are made again from a small table where a sweep reads
// them (term_row), so that a thread's scratch (SCRATCH floats, 1.6 KB at
// Kg = 9) holds only the rows the sweeps write back.  The operations and
// their operands are those of mpw::sweeps, mpw::mul_full and mpw::mul_st,
// in the same order.
//
// Each word op is one outlined copy (__noinline__): a kernel's code holds
// one word TwoSum, one word add, one exact word product in three words and
// one in two, one truncated word product, and one copy of each kind of
// sweep, where inlined at each of a product's 44 word ops it would be
// fetched anew by every warp (the lesson of mp.cuh's mpo::).  Included by
// mp_wide3_matmul.cu and mp_wide3_ops.cu, built with -DMP_WIDE=1
// -DMP_SCALED=1.
#pragma once

#include "mp_wide.cuh"

// Every function not inline is static: the header is compiled into both
// objects of a library, and nvcc gives each device function a host stub.
namespace mpw3 {

constexpr int K = MP_K;
constexpr int G = 3;
constexpr int C = mps::center<K>();
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

// A thread's scratch for one word product at a time, SCRATCH floats (1.6
// KB at Kg = 9: 6 Kg + 4 Kg^2 + 2 Kg + 4 floats): the scaled limbs of a and
// b, their Dekker hi halves and the limbs' uniform exponents (the term
// table, TERMS = 6 K entries), then the row stack.  mpw::mul_full and
// mul_st keep every limb product and its error (2 K^2 slots) and route each
// into the ladders at once; here a slot's product or error, and what a
// ladder takes of it, are computed again from the table where a sweep
// reads the slot (term_row): the same operations on the same values.  So
// the stack holds only what a sweep writes back: the hi ladder's rows and,
// in the exact products, the next ladder's residual rows, 2 NF + 2 K + 4
// floats at most.
constexpr int NF = mpw::n_full<K>();
constexpr int KK = K * K;
// the steady loops of skewed_sweeps run two steps an iteration
constexpr int UNROLL = 2;
constexpr int TERMS = 6 * K;
constexpr int SCRATCH = TERMS + 2 * NF + 2 * K + 4;

// The term table: a's scaled limbs and their Dekker hi halves, b's alike,
// and the placement exponents la, lb as int bits.
__device__ __forceinline__ void set_terms(float* L, const float (&as)[K], const float (&bs)[K],
                                          const int (&la)[K], const int (&lb)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) {
    float h, l;
    L[i] = as[i];
    mpk::split(as[i], h, l);
    L[K + i] = h;
    L[2 * K + i] = bs[i];
    mpk::split(bs[i], h, l);
    L[3 * K + i] = h;
    L[4 * K + i] = __int_as_float(la[i]);
    L[5 * K + i] = __int_as_float(lb[i]);
  }
}

// Slot `slot` of mpw::products: the limb product a_i b_j (slot i K + j) or
// its Dekker error (slot K^2 + i K + j), operation for operation (a lo half
// is mpk::split's a - hi).
__device__ __forceinline__ float term(const float* L, const int slot) {
  const int s = slot < KK ? slot : slot - KK;
  const int i = s / K, j = s - (s / K) * K;
  const float a = L[i], b = L[2 * K + j];
  const float p = a * b;
  if (slot < KK) return p;
  const float ah = L[K + i], bh = L[3 * K + j];
  const float al = a - ah, bl = b - bh;
  return ((ah * bh - p) + ah * bl + al * bh) + al * bl;
}

// mpw::mul_full's placement exponent of slot `slot`: -(la_i + lb_j) - C.
__device__ __forceinline__ int place(const float* L, const int slot) {
  const int s = slot < KK ? slot : slot - KK;
  const int i = s / K, j = s - (s / K) * K;
  return -(__float_as_int(L[4 * K + i]) + __float_as_int(L[5 * K + j])) - C;
}

// What a ladder takes of slot `slot` (mode): LO_FULL the lo ladder of
// mul_full (what its hi ladder does not keep), MID3 / LO3 the second and
// third ladders of mul_full3.
enum Ladder { NONE = 0, LO_FULL = 1, MID3 = 2, LO3 = 3 };

__device__ __forceinline__ float term_row(const float* L, const int mode, const int slot) {
  const float t = term(L, slot);
  const int d = place(L, slot);
  const int e = mpw::exp_bits(t);
  const bool keep = e + d >= 24;
  if (mode == LO_FULL) return mpw::scale1(keep ? 0.0f : t, d + 24 * K);
  const bool keep_mid = !keep && e + d + 24 * K >= 24;
  if (mode == MID3) return mpw::scale1(keep_mid ? t : 0.0f, d + 24 * K);
  return mpw::scale1(keep || keep_mid ? 0.0f : t, d + 48 * K);
}

// The K extraction sweeps of mpw::sweeps<K, CHAIN, 0> over m rows, the
// same TwoSums on the same values, run as a skewed wavefront: at step t
// sweep k works on row j = m-1-t+2k, so the K TwoSums of a step depend only
// on the step before (sweep k's carry c[k], and v[k], what sweep k-1 left
// of row j), where mpw::sweeps runs a row's K TwoSums one after another.
// Sweep k starts at step 2k (c[k] = its first row) and runs TwoSums for
// 2k < t <= m-1+k; the row leaving sweep K-1 at step t >= 2K-1 is final
// row j + 1 = m-t+2K-2 (j that sweep's row): without CHAIN it is stored lifted by 2^(24K) (what
// every caller did next to the residual rows), with CHAIN chain-summed in
// the order mpw::sweeps sums it and returned.  Rows below `mem` are read
// from x (steps 2K-1 .. m-1 fetch them two steps ahead), rows from `mem` up
// are slots mem.. of `mode` made by term_row (the sweeps read them first);
// the steps before 2K-1 and after m-1 check each sweep's range.  Rows
// 0..K-1 end as the carries.  m >= 2K.
template <bool CHAIN>
__device__ __forceinline__ float skewed_sweeps(float* x, const int m, const int mem,
                                               const float* L, const int mode) {
  float c[K], v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) c[k] = v[k] = 0.0f;
  float chain = 0.0f;
  auto row = [&](const int r) { return r < mem ? x[r] : term_row(L, mode, r - mem); };
  auto step = [&](const int t, const float in, const bool edge) {
    float out = 0.0f;
#pragma unroll
    for (int k = K - 1; k >= 0; --k) {
      const float xin = k == 0 ? in : v[k];
      float s, e;
      mpk::two_sum(xin, c[k], s, e);
      if (edge) {
        const bool run = t > 2 * k && t <= m - 1 + k;
        c[k] = run ? s : (t == 2 * k ? xin : c[k]);
      } else {
        c[k] = s;
      }
      if (k < K - 1)
        v[k + 1] = e;  // sweep k+1's input at the next step
      else
        out = e;
    }
    return out;
  };
  auto emit = [&](const int t, const float out) {
    if (CHAIN)
      chain = t == 2 * K - 1 ? out : chain + out;
    else
      x[m - t + 2 * K - 2] = mpw::lift(out, 24 * K);
  };
#pragma unroll 1
  for (int t = 0; t < 2 * K - 1; ++t) step(t, row(m - 1 - t), true);
  int t = 2 * K - 1;
#pragma unroll UNROLL
  for (; t <= m - 1 && m - 1 - t >= mem; ++t) emit(t, step(t, row(m - 1 - t), false));
  if (t <= m - 1) {
    float n0 = x[m - 1 - t], n1 = x[m - 2 - t >= 0 ? m - 2 - t : 0];
#pragma unroll UNROLL
    for (; t <= m - 1; ++t) {
      const float in = n0;
      n0 = n1;
      const int ahead = m - 3 - t;
      n1 = x[ahead >= 0 ? ahead : 0];
      emit(t, step(t, in, false));
    }
  }
#pragma unroll 1
  for (; t <= m + K - 2; ++t) emit(t, step(t, 0.0f, true));
#pragma unroll
  for (int k = 0; k < K; ++k) x[k] = c[k];
  return chain;
}

// mpw::sweeps<K, false, 0> over x[0, m) (rows from `mem` up made by
// term_row), the residual rows K..m-1 lifted by 2^(24K).
static __device__ __noinline__ void sweeps_lift_o(float* x, const int m, const int mem,
                                                  const float* L, const int mode) {
  skewed_sweeps<false>(x, m, mem, L, mode);
}

// mpw::finish<K, 0>: the sweeps with the chain tail, the quick-TwoSum
// compaction of rows 0..K forward and back, normalize at exponent e.
static __device__ __noinline__ SVk finish_o(float* x, const int m, const int mem, const float* L,
                                            const int mode, const int e) {
  float xs[K + 1];
  xs[K] = skewed_sweeps<true>(x, m, mem, L, mode);
#pragma unroll
  for (int i = 0; i < K; ++i) xs[i] = x[i];
  mpk::compact<K>(xs);
  SVk r;
#pragma unroll
  for (int i = 0; i < K; ++i) r.x[i] = xs[i];
  r.e = e;
  mps::normalize<K>(r);
  return r;
}

// mpw::mul_full's prologue: the limbs of a and b scaled to a uniform
// exponent, into the term table.
__device__ __forceinline__ void uniform(const SVk& a, const SVk& b, float* L) {
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
  set_terms(L, as, bs, la, lb);
}

// The hi ladder of a full product (mpw::mul_full's routing): row j of the
// plan is the slot's term where the hi ladder keeps it, placed; K rows at a
// time, each row's reads first.
__device__ __forceinline__ void hi_rows(float* S, const float* L) {
  static_assert(NF % K == 0, "the plan's rows come in blocks of K");
#pragma unroll 1
  for (int j0 = 0; j0 < NF; j0 += K) {
    float t[K];
    int d[K];
#pragma unroll
    for (int r = 0; r < K; ++r) {
      const int slot = mpw::kPlan.full[j0 + r];
      t[r] = term(L, slot);
      d[r] = place(L, slot);
    }
#pragma unroll
    for (int r = 0; r < K; ++r)
      S[j0 + r] = mpw::scale1(mpw::exp_bits(t[r]) + d[r] >= 24 ? t[r] : 0.0f, d[r]);
  }
}

// mpw::mul_full (the exact word product hi + lo == a * b, mul_full_c).
// T: a thread's scratch; its stack S: [0, NF) the hi ladder, [NF, NF + K)
// its spill, 2 zero rows; the lo ladder's NF slots made as it reads them.
static __device__ __noinline__ void mul_full_o(const SVk a, const SVk b, SVk* hi, SVk* lo,
                                               float* T) {
  float* L = T;
  float* S = T + TERMS;
  uniform(a, b, L);
  hi_rows(S, L);
  const int e_hi = a.e + b.e + C;
  sweeps_lift_o(S, NF, NF, L, NONE);
  *hi = mpw::extract_hi<K>(S, e_hi, S + NF);
  S[NF + K] = 0.0f;
  S[NF + K + 1] = 0.0f;
  *lo = finish_o(S + K, 2 * NF + 2, NF + 2, L, LO_FULL, e_hi - 24 * K);
}

// mpw::mul_st (the truncated word product, mul_st_c): limbs prescaled by
// their rung, the plan rows put back on the result's ladder by two factors.
static __device__ __noinline__ SVk mul_st_o(const SVk a, const SVk b, float* T) {
  constexpr int NM = mpw::n_mul<K>();
  float* L = T;
  float* S = T + TERMS;
  float as[K], bs[K];
  int zero[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const float pre = mps::pow2f(24 * i - C + mps::MUL_UNIFORM_EXP);
    as[i] = a.x[i] * pre;
    bs[i] = b.x[i] * pre;
    zero[i] = 0;
  }
  set_terms(L, as, bs, zero, zero);
#pragma unroll 4
  for (int j = 0; j < NM; ++j) {
    const int d = C - 2 * mps::MUL_UNIFORM_EXP - 24 * mpw::kPlan.diag[j];
    const int d1 = mps::clip(d, -126, 127);
    const int d2 = mps::clip(d - d1, -126, 127);
    S[j] = term(L, mpw::kPlan.mul[j]) * mps::pow2f(d1) * mps::pow2f(d2);
  }
  S[NM] = 0.0f;
  S[NM + 1] = 0.0f;
  return finish_o(S, NM + 2, NM + 2, L, NONE, a.e + b.e + C);
}

// The exact word product in three words, hi + mid + lo == a * b up to the
// last word's truncation (mul_full3_c): mul_full with a third ladder 48 K
// digits down for the terms the second cannot hold as normals, and the
// second word extracted error-free as the first is.  The stack S: [0, NF)
// the hi ladder, [NF, NF + K) its spill, 2 zeros, [NF + K + 2, 2 NF + K + 2)
// where the mid ladder's slots lie (made as it reads them), so that mid's
// stack is S[K, 2 NF + K + 2): hi's lifted residual, spill, zeros, slots;
// its residual rows come back to S[2 K, 2 NF + K + 2), then mid's spill,
// 2 zero rows, and the third ladder's slots, made as it reads them: lo's
// stack is S[2 K, 3 NF + 2 K + 4).
static __device__ __noinline__ void mul_full3_o(const SVk a, const SVk b, SVk* hi, SVk* mid,
                                                SVk* lo, float* T) {
  float* L = T;
  float* S = T + TERMS;
  uniform(a, b, L);
  hi_rows(S, L);
  const int e_hi = a.e + b.e + C;
  sweeps_lift_o(S, NF, NF, L, NONE);
  *hi = mpw::extract_hi<K>(S, e_hi, S + NF);
  S[NF + K] = 0.0f;
  S[NF + K + 1] = 0.0f;
  sweeps_lift_o(S + K, 2 * NF + 2, NF + 2, L, MID3);
  *mid = mpw::extract_hi<K>(S + K, e_hi - 24 * K, S + 2 * NF + K + 2);
  S[2 * NF + 2 * K + 2] = 0.0f;
  S[2 * NF + 2 * K + 3] = 0.0f;
  *lo = finish_o(S + 2 * K, 3 * NF + 4, 2 * NF + 4, L, LO3, e_hi - 48 * K);
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
static __device__ W wmul(const W& a, const W& b, float* T) {
  constexpr int NP = G * (G + 1) / 2;
  constexpr int M = product_words();
  SVk hi[NP], lo[NP], top[3];
  mul_full3_o(a.w[0], b.w[0], &top[0], &top[1], &top[2], T);
  int p = 0;
#pragma unroll
  for (int g1 = 0; g1 < G; ++g1) {
#pragma unroll
    for (int g2 = 0; g2 < G - g1; ++g2, ++p) {
      if (g1 + g2 == 0) continue;
      if (g1 + g2 < G - 1)
        mul_full_o(a.w[g1], b.w[g2], &hi[p], &lo[p], T);
      else
        hi[p] = mul_st_o(a.w[g1], b.w[g2], T);
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
