// Design trial of the three-word product: mp_wide3.cuh's wmul with its six
// word-pair products spread over a group of lanes, built and timed against
// csrc/mp_wide3_ops.cu's product kernel by tools/wide3_mul_lanes.py.  The
// main path does not run it.
//
// A product's group is one lane in each of WARPS warps of a block (lane l
// of every warp works on element 32 blockIdx + l), so that the lanes of a
// warp run pair products of one kind and do not diverge.  WARPS = 3 groups
// them by kind: warp 0 the exact three-word top product (mul_full3, the
// longest), warp 1 the two exact word products, warp 2 the three truncated
// ones and then the renormalization.  WARPS = 2 balances the two warps'
// sweeps instead: warp 0 mul_full3 and one mul_full, warp 1 the other
// mul_full, the three mul_st and the renormalization.  The pair products'
// words meet in shared memory; the last warp waits for them at a named
// barrier (the others arrive and leave), renormalizes and stores.  Each
// lane keeps its own row stacks (SCRATCH floats in local memory, as the
// kept kernel does).  The operations, their operands and the
// renormalization's order are wmul's, so the words agree bit for bit with
// the kept kernel and with ops/mpwide_kernel.py's wmul_g_c.  Built with the
// kernels' flags, -DMP_WIDE=1 -DMP_SCALED=1 and -I csrc.
#include "mp_wide3.cuh"

namespace {

using namespace mpw3;
constexpr int NP = G * (G + 1) / 2;
constexpr int M = product_words();
constexpr int LANES = 32;

// The place in wmul's list of words (by diagonal) of word `word` of pair
// product `pair` (wmul's loop order of (g1, g2)): the top pair's words 0-2,
// another pair's hi word 0 and lo word 1.
__host__ __device__ constexpr int slot_of(int pair, int word) {
  int q = 0;
  for (int d = 0; d <= G; ++d) {
    int p = 0;
    for (int g1 = 0; g1 < G; ++g1) {
      for (int g2 = 0; g2 < G - g1; ++g2, ++p) {
        const int n = g1 + g2;
        const bool here = n == 0 ? d < 3 : (n == d || (n < G - 1 && n + 1 == d));
        if (!here) continue;
        const int w = n == 0 ? d : (n == d ? 0 : 1);
        if (p == pair && w == word) return q;
        ++q;
      }
    }
  }
  return -1;
}

__host__ __device__ constexpr int words_of(int pair) {
  return pair == 0 ? 3 : (pair == 1 || pair == 3 ? 2 : 1);
}

// The warp that runs pair product `pair` (0 the top pair, 1 and 3 the
// exact word products, 2, 4, 5 the truncated ones); the last warp also
// renormalizes.
__host__ __device__ constexpr int warp_of(int warps, int pair) {
  return warps == 2 ? (pair <= 1 ? 0 : 1) : (pair == 0 ? 0 : (pair == 1 || pair == 3 ? 1 : 2));
}

__host__ __device__ constexpr bool slots_cover() {
  int seen[M] = {};
  for (int p = 0; p < NP; ++p)
    for (int w = 0; w < words_of(p); ++w) {
      const int q = slot_of(p, w);
      if (q < 0 || q >= M || seen[q]) return false;
      seen[q] = 1;
    }
  return true;
}
static_assert(slots_cover(), "every word of the product has one place in wmul's list");

__device__ __forceinline__ void bar_arrive(int count) {
#ifdef __CUDA_ARCH__
  asm volatile("bar.arrive 1, %0;" ::"r"(count) : "memory");
#endif
}

__device__ __forceinline__ void bar_sync(int count) {
#ifdef __CUDA_ARCH__
  asm volatile("bar.sync 1, %0;" ::"r"(count) : "memory");
#endif
}

__device__ __forceinline__ W load3(const Words& x, size_t n, size_t i) {
  W v;
#pragma unroll
  for (int g = 0; g < G; ++g) v.w[g] = mps::load<K>(x.x[g], x.e[g], n, i);
  return v;
}

template <int WARPS>
__global__ void __launch_bounds__(WARPS * LANES, 16 / WARPS)
mul_lanes_kernel(Words a, Words b, OutWords o, long long n) {
  __shared__ float wl[M][K][LANES];
  __shared__ int we[M][LANES];
  const int lane = threadIdx.x % LANES, warp = threadIdx.x / LANES;
  const long long i = (long long)blockIdx.x * LANES + lane;
  const bool live = i < n;
  auto put = [&](const int pair, const int word, const SVk& v) {
    const int q = slot_of(pair, word);
#pragma unroll
    for (int k = 0; k < K; ++k) wl[q][k][lane] = v.x[k];
    we[q][lane] = v.e;
  };
  if (live) {
    float T[SCRATCH];
    const W x = load3(a, (size_t)n, (size_t)i), y = load3(b, (size_t)n, (size_t)i);
    int p = 0;
#pragma unroll
    for (int g1 = 0; g1 < G; ++g1) {
#pragma unroll
      for (int g2 = 0; g2 < G - g1; ++g2, ++p) {
        if (warp_of(WARPS, p) != warp) continue;
        SVk hi, mid, lo;
        if (p == 0) {
          mul_full3_o(x.w[0], y.w[0], &hi, &mid, &lo, T);
          put(p, 0, hi);
          put(p, 1, mid);
          put(p, 2, lo);
        } else if (g1 + g2 < G - 1) {
          mul_full_o(x.w[g1], y.w[g2], &hi, &lo, T);
          put(p, 0, hi);
          put(p, 1, lo);
        } else {
          put(p, 0, mul_st_o(x.w[g1], y.w[g2], T));
        }
      }
    }
  }
  __syncwarp();
  if (warp != WARPS - 1) {
    bar_arrive(WARPS * LANES);
    return;
  }
  bar_sync(WARPS * LANES);
  if (!live) return;
  SVk xs[M];
#pragma unroll
  for (int q = 0; q < M; ++q) {
#pragma unroll
    for (int k = 0; k < K; ++k) xs[q].x[k] = wl[q][k][lane];
    xs[q].e = we[q][lane];
  }
  const W r = renormalize<M>(xs);
#pragma unroll
  for (int g = 0; g < G; ++g) mps::store<K>(o.x[g], o.e[g], (size_t)n, (size_t)i, r.w[g]);
}

}  // namespace

// The pointers as mp_wide3_ew_launch takes them (a's, b's and o's words,
// limbs and exponents each, n elements); warps 2 or 3.
extern "C" int mp_wide3_mul_lanes_launch(const void* a0, const void* a0e, const void* a1,
                                         const void* a1e, const void* a2, const void* a2e,
                                         const void* b0, const void* b0e, const void* b1,
                                         const void* b1e, const void* b2, const void* b2e,
                                         void* o0, void* o0e, void* o1, void* o1e, void* o2,
                                         void* o2e, long long n, int warps, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const Words a{{(const float*)a0, (const float*)a1, (const float*)a2},
                {(const int*)a0e, (const int*)a1e, (const int*)a2e}};
  const Words b{{(const float*)b0, (const float*)b1, (const float*)b2},
                {(const int*)b0e, (const int*)b1e, (const int*)b2e}};
  const OutWords o{{(float*)o0, (float*)o1, (float*)o2}, {(int*)o0e, (int*)o1e, (int*)o2e}};
  const unsigned blocks = (unsigned)((n + LANES - 1) / LANES);
  cudaStream_t st = (cudaStream_t)stream;
  if (warps == 2)
    mul_lanes_kernel<2><<<blocks, 2 * LANES, 0, st>>>(a, b, o, n);
  else if (warps == 3)
    mul_lanes_kernel<3><<<blocks, 3 * LANES, 0, st>>>(a, b, o, n);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
