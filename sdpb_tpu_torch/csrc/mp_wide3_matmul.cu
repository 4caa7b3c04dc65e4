// Batched three-word (wide) MP GEMM: o = a @ b for a [B,M,Kd], b [B,Kd,N],
// each operand and the output three scaled words (float32 limbs [Kg,B,.,.]
// limb-major, int32 exponents [B,.,.] per word), Kg = MP_K limbs a word:
// 19-27 limbs in all, --precision 425-640.
//
// The JAX package has no Pallas kernel for three words (its wide kernel
// refuses G != 2, sdpb_tpu/ops/pallas_kernels.py:342): it computes the
// product as an XLA composite (sdpb_tpu/ops/linalg.py:32-74), which this
// kernel replaces, in the composite's order:
//   * every term a[m,t] b[t,n] is a three-word product (mp_wide3.cuh's
//     wmul: the top word product exact in three words, 2 in two, 3
//     truncated, 32 word TwoSums and 7 word adds over 10 words);
//   * the contraction runs in chunks of c = max(4, 3200 / (3 Kg)^2) terms
//     (4 at Kg = 9, 7 at Kg = 7), zero-padded to a whole number of chunks
//     (padded terms are products of exact zeros, EXP_ZERO exponents); a
//     contraction of at most c terms is one unpadded chunk of Kd terms;
//   * a chunk's products are summed by halving (add the two halves, carry
//     an odd last term: mpfloat._sum_axis0), each sum mp_wide3.cuh's wadd
//     (20 word TwoSums and 3 word adds over 6 words);
//   * the chunk sums are added in order into an accumulator that starts at
//     zero; a single chunk is the result itself.
// Its products and sums are the three-word ops of mp_wide3.cuh (wmul,
// wadd), which ops/mpwide_kernel.py performs operation for operation;
// kernels.mp_matmul_wide3_plain runs the same ops in the same order, so
// kernel and plain version agree limb for limb and exponent for exponent.
//
// The work is the products (wmul, ~10x a wadd), each as fast as the
// elementwise product (mp_wide3_ops.cu) where a thread runs one: so each
// pass over the contraction is three kernels on the caller's stream, each
// a thread per item and none waiting on another thread:
//   1. mp_wide3_term_kernel, a thread a term (b, m, t, n) of tc values of t
//      (a whole number of chunks): its product into a scratch in device
//      memory of 3 (4 Kg + 4) bytes a term (the wrapper's), [3, Kg, B, M,
//      tc, N];
//   2. mp_wide3_tree_kernel, a thread a chunk (b, m, chunk, n): the chunk's
//      halving tree in place in the scratch;
//   3. mp_wide3_acc_kernel, a thread an output: the chunk sums added in
//      order into the accumulator, carried across passes in the output
//      (stored exactly) -- the one chain the order makes serial.
// A block that computed a chunk's terms and their trees in shared memory
// (one launch, no scratch) waited at a barrier for its slowest product and
// at every level of the tree, and a thread that ran a whole chunk's
// products held more local memory: both measured slower (PERF.md).
// No shared memory, no tensor cores, no library.  Built with -DMP_WIDE=1
// -DMP_SCALED=1.
#include "mp_wide3.cuh"

namespace {

using namespace mpw3;
constexpr int THREADS = 128;

// Thread (b, m, t, n) of the pass's tc values of t from t0: its term's
// product into the scratch p, laid out [3, Kg, B, M, tc, N].
__global__ void __launch_bounds__(THREADS, 4)
mp_wide3_term_kernel(Words a, Words b, float* __restrict__ p, int* __restrict__ pe, int B,
                     int M, int Kd, int N, int t0, int tc) {
  const long long total = (long long)B * M * tc * N;
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= total) return;
  const int j = (int)(gid % N);
  const int t = t0 + (int)((gid / N) % tc);
  const long long bm = gid / ((long long)tc * N);  // bb * M + i
  W x, y;
  if (t < Kd) {
    const size_t as = (size_t)B * M * Kd;  // limb strides
    const size_t bs = (size_t)B * Kd * N;
    const size_t ai = (size_t)bm * Kd + t;                  // element (bb, i, t)
    const size_t bi = ((size_t)(bm / M) * Kd + t) * N + j;  // element (bb, t, j)
#pragma unroll
    for (int g = 0; g < G; ++g) {
      x.w[g] = mps::load<K>(a.x[g], a.e[g], as, ai);
      y.w[g] = mps::load<K>(b.x[g], b.e[g], bs, bi);
    }
  } else {  // the zero padding of the last chunk
#pragma unroll
    for (int g = 0; g < G; ++g) x.w[g] = y.w[g] = mps::zero<K>();
  }
  float T[SCRATCH];
  store_w(p, pe, (size_t)total, (size_t)total, (size_t)gid, wmul(x, y, T));
}

// Thread (b, m, chunk, n): the chunk's halving tree, in place in the
// scratch, its sum left at the chunk's first term.
__global__ void __launch_bounds__(THREADS)
mp_wide3_tree_kernel(float* __restrict__ p, int* __restrict__ pe, int B, int M, int N, int c,
                     int tc) {
  const int per = tc / c;  // chunks of the pass
  const long long chunks = (long long)B * M * per * N;
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= chunks) return;
  const int j = (int)(gid % N);
  const int q = (int)((gid / N) % per);
  const long long bm = gid / ((long long)per * N);
  const size_t ts = (size_t)B * M * tc * N;  // the scratch's terms
  const size_t base = ((size_t)bm * tc + (size_t)q * c) * N + j;  // term (bb, i, q c, j)
  auto term = [&](int i) { return base + (size_t)i * N; };
#pragma unroll 1
  for (int n = c; n > 1; n = n / 2 + (n & 1)) {
    const int half = n / 2;
#pragma unroll 1
    for (int i = 0; i < half; ++i)
      store_w(p, pe, ts, ts, term(i),
              wadd(load_w(p, pe, ts, ts, term(i)), load_w(p, pe, ts, ts, term(half + i))));
    if (n & 1) store_w(p, pe, ts, ts, term(half), load_w(p, pe, ts, ts, term(n - 1)));
  }
}

// Thread (b, m, n): the pass's chunk sums added in order into the
// accumulator (zero at the first pass, else the output; a single chunk is
// the result).
__global__ void __launch_bounds__(THREADS)
mp_wide3_acc_kernel(const float* __restrict__ p, const int* __restrict__ pe, OutWords o, int B,
                    int M, int N, int c, int tc, int first, int single) {
  const long long outs = (long long)B * M * N;
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= outs) return;
  const int j = (int)(gid % N);
  const long long bm = gid / N;  // bb * M + i
  const size_t ts = (size_t)outs * tc;
  W acc;
  if (first) {
#pragma unroll
    for (int g = 0; g < G; ++g) acc.w[g] = mps::zero<K>();
  } else {
#pragma unroll
    for (int g = 0; g < G; ++g) acc.w[g] = mps::load<K>(o.x[g], o.e[g], (size_t)outs, (size_t)gid);
  }
#pragma unroll 1
  for (int q = 0; q < tc; q += c) {
    const W s = load_w(p, pe, ts, ts, ((size_t)bm * tc + q) * N + j);
    acc = single ? s : wadd(acc, s);
  }
#pragma unroll
  for (int g = 0; g < G; ++g) mps::store<K>(o.x[g], o.e[g], (size_t)outs, (size_t)gid, acc.w[g]);
}

}  // namespace

// ptrs: a's, b's and o's words, each its limbs and exponents (a0, a0e, a1,
// a1e, a2, a2e, b0, ..., o2e), then the scratch's limbs [3, Kg, S] and
// exponents [3, S], S = B*M*tc*N terms.  c: the chunk (Kd itself when
// Kd <= the composite's chunk); tc: values of t per pass, a multiple of c.
extern "C" int mp_wide3_matmul_launch(const void* a0, const void* a0e, const void* a1,
                                      const void* a1e, const void* a2, const void* a2e,
                                      const void* b0, const void* b0e, const void* b1,
                                      const void* b1e, const void* b2, const void* b2e,
                                      void* o0, void* o0e, void* o1, void* o1e, void* o2,
                                      void* o2e, void* p, void* pe, int B, int M, int Kd,
                                      int N, int c, int tc, void* stream) {
  if (c < 1 || tc < c || tc % c != 0 || Kd < 1) return (int)cudaErrorInvalidValue;
  const long long outs = (long long)B * M * N;
  if (outs == 0) return (int)cudaSuccess;
  const Words a{{(const float*)a0, (const float*)a1, (const float*)a2},
                {(const int*)a0e, (const int*)a1e, (const int*)a2e}};
  const Words b{{(const float*)b0, (const float*)b1, (const float*)b2},
                {(const int*)b0e, (const int*)b1e, (const int*)b2e}};
  const OutWords o{{(float*)o0, (float*)o1, (float*)o2}, {(int*)o0e, (int*)o1e, (int*)o2e}};
  cudaStream_t st = (cudaStream_t)stream;
  const int nch = (Kd + c - 1) / c;
  const int padded = nch * c;
  auto blocks = [](long long n) { return (unsigned)((n + THREADS - 1) / THREADS); };
  for (int t0 = 0; t0 < padded; t0 += tc) {
    const int cur = tc < padded - t0 ? tc : padded - t0;
    mp_wide3_term_kernel<<<blocks(outs * cur), THREADS, 0, st>>>(a, b, (float*)p, (int*)pe, B, M,
                                                                 Kd, N, t0, cur);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (c > 1) {
      mp_wide3_tree_kernel<<<blocks(outs * (cur / c)), THREADS, 0, st>>>((float*)p, (int*)pe, B,
                                                                         M, N, c, cur);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    mp_wide3_acc_kernel<<<blocks(outs), THREADS, 0, st>>>((const float*)p, (const int*)pe, o, B,
                                                          M, N, c, cur, t0 == 0, nch == 1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
