// Batched MP GEMM: o[K,B,M,N] = a[K,B,M,Kd] @ b[K,B,Kd,N] in K-limb MP
// arithmetic, classic (float64 limbs) or scaled (float32 limbs and an int32
// exponent [B,.,.] per element), one library per (K, representation).
//
// Replaces sdpb_tpu/ops/pallas_kernels.py::_matmul_kernel, both branches
// (scaled=False and scaled=True).  Same arithmetic as the TPU kernel: the
// contraction walks in chunks of 8; the 8 MP products of a chunk are summed
// as a pairwise tree ((p0+p1)+(p2+p3)) + ((p4+p5)+(p6+p7)) and the chunk
// sum is added into a K-limb accumulator.  Positions past Kd are MP zeros
// (scaled: exponent EXP_ZERO, as the Pallas wrapper pads) that go through
// the same products and adds, so the limbs agree exactly with the TPU
// kernel's semantics.  In the scaled build every add aligns its operands'
// exponents first: the tree adds are where the exponents meet.
//
// What bounds it on an H100: the CUDA cores (float64 for classic, float32
// for scaled).  One MP multiply-add costs about 6 K^3 flops of
// renormalization sweeps (plus the alignment and normalization steps when
// scaled) against 16 K bytes of operands, so the kernel is compute-bound
// by a wide margin and operand traffic is negligible.  Design: one thread
// per output element (b, i, j), accumulator and the chunk's partial sums
// in registers (no shared memory, no cross-thread reduction, hence a fixed
// operation order); neighbouring threads take neighbouring j, so the b
// operand reads are coalesced and the a operand reads are warp broadcasts.
// At classic K = 9 the registers spill; that is accepted here.
#include "mp.cuh"

namespace {

template <int K>
__global__ void __launch_bounds__(128)
mp_matmul_kernel(const ar::Limb* __restrict__ a, const int* __restrict__ ae,
                 const ar::Limb* __restrict__ b, const int* __restrict__ be,
                 ar::Limb* __restrict__ o, int* __restrict__ oe, int B, int M, int Kd,
                 int N) {
  const long long total = (long long)B * M * N;
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= total) return;
  const int j = (int)(gid % N);
  const int i = (int)((gid / N) % M);
  const long long bb = gid / ((long long)M * N);
  const size_t as = (size_t)B * M * Kd;  // limb strides
  const size_t bs = (size_t)B * Kd * N;
  const size_t os = (size_t)B * M * N;
  const size_t a0 = (size_t)bb * M * Kd + (size_t)i * Kd;  // element (bb, i, 0)
  const size_t b0 = (size_t)bb * Kd * N + j;               // element (bb, 0, j)

  auto product = [&](int t) {
    ar::Val<K> x = ar::zero<K>(), y = ar::zero<K>();
    if (t < Kd) {
      x = ar::load<K>(a, ae, as, a0 + t);
      y = ar::load<K>(b, be, bs, b0 + (size_t)t * N);
    }
    return ar::mul<K>(x, y);
  };

  ar::Val<K> acc = ar::zero<K>();
  const int nchunks = (Kd + 7) / 8;
  for (int c = 0; c < nchunks; ++c) {
    const int t0 = 8 * c;
    ar::Val<K> s01 = ar::add<K>(product(t0 + 0), product(t0 + 1));
    ar::Val<K> s23 = ar::add<K>(product(t0 + 2), product(t0 + 3));
    ar::Val<K> s03 = ar::add<K>(s01, s23);
    ar::Val<K> s45 = ar::add<K>(product(t0 + 4), product(t0 + 5));
    ar::Val<K> s67 = ar::add<K>(product(t0 + 6), product(t0 + 7));
    ar::Val<K> s47 = ar::add<K>(s45, s67);
    acc = ar::add<K>(acc, ar::add<K>(s03, s47));
  }
  ar::store<K>(o, oe, os, gid, acc);
}

}  // namespace

extern "C" int mp_matmul_launch(const void* a, const void* ae, const void* b,
                                const void* be, void* o, void* oe, int B, int M,
                                int Kd, int N, void* stream) {
  const long long total = (long long)B * M * N;
  const int threads = 128;
  const long long blocks = (total + threads - 1) / threads;
  mp_matmul_kernel<MP_K><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const ar::Limb*)a, (const int*)ae, (const ar::Limb*)b, (const int*)be,
      (ar::Limb*)o, (int*)oe, B, M, Kd, N);
  return (int)cudaGetLastError();
}
