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
// Design (a first, simple one): one thread per output element (b, m, n); the
// two-word accumulator in registers; the row stacks of the distillation
// sweeps in a per-thread scratch array (4 Kg^2 + Kg + 2 floats and Kg^2
// ints, 1.6 KB at Kg = 9) in local memory; no shared memory, no tensor cores,
// no library.  One fused multiply-add costs tens of thousands of float
// operations (mostly TwoSum sweeps over ~4 Kg^2 rows), so the kernel is bound
// by the CUDA cores and by the local-memory traffic of the sweeps, not by its
// operands.  Neighbouring threads take neighbouring n: the b reads coalesce,
// the a reads are warp broadcasts.
#include "mp_wide.cuh"

namespace {

template <int K>
__global__ void __launch_bounds__(128)
mp_wide_matmul_kernel(const float* __restrict__ a0, const int* __restrict__ a0e,
                      const float* __restrict__ a1, const int* __restrict__ a1e,
                      const float* __restrict__ b0, const int* __restrict__ b0e,
                      const float* __restrict__ b1, const int* __restrict__ b1e,
                      float* __restrict__ o0, int* __restrict__ o0e,
                      float* __restrict__ o1, int* __restrict__ o1e, int B, int M,
                      int Kd, int N) {
  const long long total = (long long)B * M * N;
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= total) return;
  const int j = (int)(gid % N);
  const int i = (int)((gid / N) % M);
  const long long bb = gid / ((long long)M * N);
  const size_t as = (size_t)B * M * Kd;  // limb strides
  const size_t bs = (size_t)B * Kd * N;
  const size_t os = (size_t)B * M * N;
  const size_t ai = (size_t)bb * M * Kd + (size_t)i * Kd;  // element (bb, i, 0)
  const size_t bi = (size_t)bb * Kd * N + j;               // element (bb, 0, j)

  float S[mpw::rows<K>()];
  int D[K * K];
  mpw::SV<K> h = mps::zero<K>(), l = mps::zero<K>();
#pragma unroll 1
  for (int t = 0; t < Kd; ++t) {
    const mpw::SV<K> x0 = mps::load<K>(a0, a0e, as, ai + t);
    const mpw::SV<K> x1 = mps::load<K>(a1, a1e, as, ai + t);
    const mpw::SV<K> y0 = mps::load<K>(b0, b0e, bs, bi + (size_t)t * N);
    const mpw::SV<K> y1 = mps::load<K>(b1, b1e, bs, bi + (size_t)t * N);
    mpw::fma_acc<K>(h, l, x0, x1, y0, y1, S, D);
  }
  mpw::normalize<K>(h, l, S);
  mps::store<K>(o0, o0e, os, gid, h);
  mps::store<K>(o1, o1e, os, gid, l);
}

}  // namespace

extern "C" int mp_wide_matmul_launch(const void* a0, const void* a0e, const void* a1,
                                     const void* a1e, const void* b0, const void* b0e,
                                     const void* b1, const void* b1e, void* o0, void* o0e,
                                     void* o1, void* o1e, int B, int M, int Kd, int N,
                                     void* stream) {
  const long long total = (long long)B * M * N;
  const int threads = 128;
  const long long blocks = (total + threads - 1) / threads;
  mp_wide_matmul_kernel<MP_K><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)a0, (const int*)a0e, (const float*)a1, (const int*)a1e,
      (const float*)b0, (const int*)b0e, (const float*)b1, (const int*)b1e, (float*)o0,
      (int*)o0e, (float*)o1, (int*)o1e, B, M, Kd, N);
  return (int)cudaGetLastError();
}
