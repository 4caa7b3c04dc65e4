// Batched two-word (wide) MP GEMM: o = a @ b for a [B,M,Kd], b [B,Kd,N], each
// operand and the output a pair of scaled words (float32 limbs [Kg,B,.,.]
// limb-major, int32 exponents [B,.,.]), Kg = MP_K limbs per word.
//
// Replaces sdpb_tpu/ops/pallas_kernels.py::_matmul_wide_kernel (called with
// chunk = 1 by _mp_matmul_pallas_wide): per output element the accumulator
// starts at zero (EXP_ZERO exponents), takes acc = wfma_acc(acc, a[m,t],
// b[t,n]) for t = 0..Kd-1 in order, and ends with wnormalize -- the compact
// ops of csrc/mp_wide.cuh, which ops/mpwide_kernel.py performs in the same
// order, so kernel and plain version agree limb for limb and exponent for
// exponent.
//
// What bounds it on an H100: the CUDA cores.  One wide fused multiply-add
// is tens of thousands of float operations, almost all TwoSum sweeps over
// row stacks; the operands are a few hundred bytes per output.  But about
// 89% of those operations (Kg = 9) do not read the accumulator: the exact
// product a0 b0 = p0 + p1 and the carry cp = (a0 b1 + a1 b0) + p1.  So the
// multiply-add is split, and the GEMM runs in two kernels on the caller's
// stream (one launch of the wrapper), over the contraction index t in
// chunks of tc:
//   1. mp_wide_term_kernel, one thread per term (b, m, t, n) of the chunk,
//      B*M*tc*N threads: (p0, cp) into a global scratch of 2 (4 Kg + 4)
//      bytes per term (written once, read once), laid out [Kg, B, M, tc, N]
//      so that neighbouring threads write neighbouring words;
//   2. mp_wide_acc_kernel, one thread per output (b, m, n): the serial
//      chain (h, l) += (p0, cp) over the chunk's t in ascending order,
//      carried across chunks in the output (stored exactly); wnormalize
//      after the last chunk.
// The wrapper picks tc so that a chunk holds at most
// max(kernels.WIDE_TERMS, B*M*N) terms: the scratch stays bounded (168 MB
// at Kg = 9) whatever Kd is.  Every op sees the same operands in the same
// IEEE order as the one-pass chain, so the bits do not change.  The sweeps
// run as a register wavefront (each row read once, K independent TwoSum
// chains in flight); the accumulate part's row stacks (add_full, add_st:
// at most 5 Kg + 2 rows) are in registers, the products' stacks (up to
// 4 Kg^2 + Kg + 2 floats, 1.6 KB at Kg = 9) in local memory.  No shared
// memory, no tensor cores, no library.
#include "mp_wide.cuh"

namespace {

template <int K>
__global__ void __launch_bounds__(128)
mp_wide_term_kernel(const float* __restrict__ a0, const int* __restrict__ a0e,
                    const float* __restrict__ a1, const int* __restrict__ a1e,
                    const float* __restrict__ b0, const int* __restrict__ b0e,
                    const float* __restrict__ b1, const int* __restrict__ b1e,
                    float* __restrict__ p, int* __restrict__ pe,
                    float* __restrict__ c, int* __restrict__ ce, int B, int M,
                    int Kd, int N, int t0, int tc) {
  const long long total = (long long)B * M * tc * N;
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= total) return;
  const int j = (int)(gid % N);
  const int t = t0 + (int)((gid / N) % tc);
  const long long bm = gid / ((long long)tc * N);  // bb * M + i
  const long long bb = bm / M;
  const size_t as = (size_t)B * M * Kd;  // limb strides
  const size_t bs = (size_t)B * Kd * N;
  const size_t ai = (size_t)bm * Kd + t;                      // element (bb, i, t)
  const size_t bi = ((size_t)bb * Kd + t) * N + j;            // element (bb, t, j)

  float S[mpw::rows<K>()];
  int D[K * K];
  const mpw::SV<K> x0 = mps::load<K>(a0, a0e, as, ai);
  const mpw::SV<K> x1 = mps::load<K>(a1, a1e, as, ai);
  const mpw::SV<K> y0 = mps::load<K>(b0, b0e, bs, bi);
  const mpw::SV<K> y1 = mps::load<K>(b1, b1e, bs, bi);
  mpw::SV<K> p0, cp;
  mpw::fma_term<K>(x0, x1, y0, y1, p0, cp, S, D);
  mps::store<K>(p, pe, (size_t)total, (size_t)gid, p0);
  mps::store<K>(c, ce, (size_t)total, (size_t)gid, cp);
}

template <int K>
__global__ void __launch_bounds__(128)
mp_wide_acc_kernel(const float* __restrict__ p, const int* __restrict__ pe,
                   const float* __restrict__ c, const int* __restrict__ ce,
                   float* __restrict__ o0, int* __restrict__ o0e,
                   float* __restrict__ o1, int* __restrict__ o1e, int B, int M,
                   int N, int tc, int first, int last) {
  const long long total = (long long)B * M * N;
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= total) return;
  const int j = (int)(gid % N);
  const long long bm = gid / N;  // bb * M + i
  const size_t ts = (size_t)total * tc;  // the scratch's limb stride
  const size_t ti = (size_t)bm * tc * N + j;  // term (bb, i, 0, j) of the chunk

  mpw::SV<K> h = mps::zero<K>(), l = mps::zero<K>();
  if (!first) {
    h = mps::load<K>(o0, o0e, (size_t)total, (size_t)gid);
    l = mps::load<K>(o1, o1e, (size_t)total, (size_t)gid);
  }
#pragma unroll 1
  for (int t = 0; t < tc; ++t) {
    const mpw::SV<K> p0 = mps::load<K>(p, pe, ts, ti + (size_t)t * N);
    const mpw::SV<K> cp = mps::load<K>(c, ce, ts, ti + (size_t)t * N);
    mpw::fma_acc<K>(h, l, p0, cp);
  }
  if (last) mpw::normalize<K>(h, l);
  mps::store<K>(o0, o0e, (size_t)total, (size_t)gid, h);
  mps::store<K>(o1, o1e, (size_t)total, (size_t)gid, l);
}

}  // namespace

// p/pe and c/ce: the caller's scratch for the terms' p0 and cp of one chunk
// of tc >= 1 values of t, Kg floats and one int each per term (at least
// B*M*min(tc, Kd)*N terms).
extern "C" int mp_wide_matmul_launch(const void* a0, const void* a0e, const void* a1,
                                     const void* a1e, const void* b0, const void* b0e,
                                     const void* b1, const void* b1e, void* o0, void* o0e,
                                     void* o1, void* o1e, void* p, void* pe, void* c,
                                     void* ce, int B, int M, int Kd, int N, int tc,
                                     void* stream) {
  if (tc < 1) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const long long outs = (long long)B * M * N;
  if (outs == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  int t0 = 0;
  do {  // once with an empty chunk where Kd = 0: the outputs are zeros
    const int cur = tc < Kd - t0 ? tc : Kd - t0;
    if (cur > 0) {
      const long long terms = outs * cur;
      mp_wide_term_kernel<MP_K><<<(unsigned)((terms + threads - 1) / threads), threads, 0,
                                  st>>>(
          (const float*)a0, (const int*)a0e, (const float*)a1, (const int*)a1e,
          (const float*)b0, (const int*)b0e, (const float*)b1, (const int*)b1e, (float*)p,
          (int*)pe, (float*)c, (int*)ce, B, M, Kd, N, t0, cur);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    mp_wide_acc_kernel<MP_K><<<(unsigned)((outs + threads - 1) / threads), threads, 0, st>>>(
        (const float*)p, (const int*)pe, (const float*)c, (const int*)ce, (float*)o0,
        (int*)o0e, (float*)o1, (int*)o1e, B, M, N, cur, t0 == 0, t0 + cur >= Kd);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    t0 += cur;
  } while (t0 < Kd);
  return (int)cudaSuccess;
}
