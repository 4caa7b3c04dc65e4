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
// What bounds it on an H100: the instruction rate of the CUDA cores (float64
// for classic, float32 for scaled).  One MP multiply-add is thousands of
// instructions (a scaled K = 9 product ~5,000) against 16 K bytes of
// operands.  The previous kernel gave each output's whole contraction to one
// thread and inlined a chunk's 8 products and 8 sums into its loop: 47,464
// SASS instructions at scaled K = 9 (760 KB of code, fetched again by
// every warp), 45,600 threads at the ladder's pairing shape, 12 warps an
// SM at its 168 registers (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §6,
// step 0).  Design: the
// contraction of each output is split over threads, a thread a chunk: it
// runs the chunk's 8 products and sums them by the tree in registers, the
// chunks of an output go to G threads of one block in rounds, each chunk
// sum goes to shared memory, and one thread an output folds them into its
// accumulator in chunk order.  So an output's chunks are in flight at
// once (3x the threads at the pairing shape, 8x at the Q shape), and only
// the accumulate is serial.  Every product and sum goes through one
// outlined copy (mpo::), so the code a warp fetches is one product and
// one sum.  Shared memory: one value a thread, whatever Kd is.  Splitting
// a chunk further, over 2, 4 or 8 lanes summed across by __shfl_down_sync,
// measured slower at the ladder's shapes: the shuffle levels' sums run on
// every lane for the one that counts (PERF.md §6).
#include "mp.cuh"

namespace {

using Val = ar::Val<MP_K>;
constexpr int K = MP_K;
constexpr int THREADS = 128;

// Threads an output takes: its chunk count, at least 1 and at most THREADS.
__host__ __device__ inline int threads_per_output(int Kd) {
  const int nchunks = (Kd + 7) / 8;
  return nchunks < 1 ? 1 : (nchunks < THREADS ? nchunks : THREADS);
}

__global__ void __launch_bounds__(THREADS)
mp_matmul_kernel(const ar::Limb* __restrict__ a, const int* __restrict__ ae,
                 const ar::Limb* __restrict__ b, const int* __restrict__ be,
                 ar::Limb* __restrict__ o, int* __restrict__ oe, int B, int M, int Kd,
                 int N) {
  __shared__ Val sums[THREADS];
  const long long total = (long long)B * M * N;
  const int nchunks = (Kd + 7) / 8;
  const int G = threads_per_output(Kd);
  const int P = THREADS / G;  // outputs per block
  const int tid = threadIdx.x;
  const int p = tid / G, gi = tid % G;
  const long long out = (long long)blockIdx.x * P + p;
  const bool mine = p < P && out < total;
  const long long oo = mine ? out : 0;
  const int j = (int)(oo % N);
  const int i = (int)((oo / N) % M);
  const long long bb = oo / ((long long)M * N);
  const size_t as = (size_t)B * M * Kd;  // limb strides
  const size_t bs = (size_t)B * Kd * N;
  const size_t os = (size_t)B * M * N;
  const size_t a0 = (size_t)bb * M * Kd + (size_t)i * Kd;  // element (bb, i, 0)
  const size_t b0 = (size_t)bb * Kd * N + j;               // element (bb, 0, j)

  // the accumulator of output blockIdx.x * P + tid, for tid < P
  const long long acc_out = (long long)blockIdx.x * P + tid;
  const bool acc_mine = tid < P && acc_out < total;
  Val acc = ar::zero<K>();

  const int rounds = (nchunks + G - 1) / G;
  for (int rd = 0; rd < rounds; ++rd) {
    const int c = rd * G + gi;
    if (mine && c < nchunks) {
      // the chunk's 8 products summed by the pairwise tree: held[l] waits
      // for its right neighbour at level l; product u carries up through
      // the levels of u's trailing one bits and waits at the first zero
      // bit (static indices, so held stays in registers)
      Val held[3];
      Val v;
#pragma unroll 1
      for (int u = 0; u < 8; ++u) {
        const int t = 8 * c + u;
        Val x = ar::zero<K>(), y = ar::zero<K>();
        if (t < Kd) {
          x = ar::load<K>(a, ae, as, a0 + t);
          y = ar::load<K>(b, be, bs, b0 + (size_t)t * N);
        }
        v = mpo::mul<K>(x, y);
        const int ones = __ffs(~u) - 1;  // trailing one bits of u
#pragma unroll
        for (int l = 0; l < 3; ++l) {
          if (l < ones) v = mpo::add<K>(held[l], v);
          if (l == ones) held[l] = v;
        }
      }
      sums[tid] = v;
    }
    __syncthreads();
    if (acc_mine) {
      for (int g = 0; g < G && rd * G + g < nchunks; ++g)
        acc = mpo::add<K>(acc, sums[tid * G + g]);
    }
    __syncthreads();
  }
  if (acc_mine) ar::store<K>(o, oe, os, acc_out, acc);
}

}  // namespace

extern "C" int mp_matmul_launch(const void* a, const void* ae, const void* b,
                                const void* be, void* o, void* oe, int B, int M,
                                int Kd, int N, void* stream) {
  const long long total = (long long)B * M * N;
  const int P = THREADS / threads_per_output(Kd);
  const long long blocks = (total + P - 1) / P;
  mp_matmul_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const ar::Limb*)a, (const int*)ae, (const ar::Limb*)b, (const int*)be,
      (ar::Limb*)o, (int*)oe, B, M, Kd, N);
  return (int)cudaGetLastError();
}
