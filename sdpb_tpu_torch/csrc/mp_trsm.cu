// Batched MP triangular solve: X = T^{-1} Bm for triangular T[K,B,n,n] and
// Bm[K,B,n,m] in K-limb MP arithmetic, classic (float64 limbs) or scaled
// (float32 limbs and an int32 exponent per element), one library per
// (K, representation); lower T solves forward, upper T (the caller passes
// L^T) backward.
//
// Replaces sdpb_tpu/ops/pallas_kernels.py::_trsm_kernel, both branches
// (scaled=False and scaled=True).  Right-looking substitution in the TPU
// kernel's order: the diagonal reciprocals 1/T[i,i] are computed once (one
// Newton chain per row; scaled, from the diagonal's own exponents, which
// the TPU kernel extracts with a masked sum); then for each pivot row i
// (ascending for lower T, descending for upper T) the solved row is
// x_i = R[i,:] * dinv_i, and it is eliminated at once from the rows still
// to come, R[r,c] -= T[r,i] * x_i[c].  Each R[r,c] takes its steps in
// pivot order, so the bits are those of the plain version.
//
// What bounds it on an H100: instruction issue and latency.  An
// elimination step is an MP product and an MP add, thousands of
// instructions, and the n pivots are strictly sequential.  Design: one
// block per batch element; the (row, column) entries still to come at
// pivot i are dealt to the threads densely, so every warp that issues is
// full.  Two places for the data, chosen per launch:
//   * shared: when the n diagonal reciprocals, the solved row x_i [m], the
//     residual R [n, m] and T's triangle (packed by columns) fit in the
//     device's opt-in shared memory, all four live there;
//   * global: otherwise all four are read through L2: the reciprocals and
//     R in the caller's scratch, x_i as the row of X just written, T in
//     place.  No size limit past the scratch.
// Both run the same steps in the same order, so both give the bits of the
// plain version.
//
// Three other designs were built and measured on the card (PERF.md):
// one warp per right-hand-side column, lanes over rows, no block barrier
// (at n = 57 half of a column's 64 lane slots idle, and each x_i solved on
// one lane); the entries held in registers by fixed owners, x_{i+1} solved
// inside the elimination of pivot i to save a barrier; and each entry's
// whole chain run by its owner, waiting on a flag per solved x (the lanes
// of a warp drift apart and serialize).  All three ran slower than the
// right-looking kernel with R and X in global memory, two barriers a
// pivot and 256 threads, in the scaled build.
#include "mp.cuh"

namespace {

using Val = ar::Val<MP_K>;
constexpr int K = MP_K;
constexpr bool kScaled = MP_SCALED != 0;
constexpr int WORDS = (int)(sizeof(ar::Limb) / 4);
// warps per block: classic, as many as the registers of an MP product's
// terms (about 2 (K^2 + 1) words and 40 more) leave room for, 8 to 16;
// scaled, 8 (its products take ~250 registers unconstrained, and 12
// warps, at ~170, ran slower at K = 8 and 9)
constexpr int REGS = 2 * (K * K + 1) * WORDS + 40 < 255 ? 2 * (K * K + 1) * WORDS + 40 : 255;
constexpr int WMAX =
    kScaled ? 8
            : (65536 / (32 * REGS) > 16 ? 16 : (65536 / (32 * REGS) < 8 ? 8 : 65536 / (32 * REGS)));

__device__ __forceinline__ int tri(int a) { return a * (a + 1) / 2; }
// first packed index of column i of a lower triangle of order n
__device__ __forceinline__ int pcol(int i, int n) { return i * n - i * (i - 1) / 2; }

// A limb-major array with exponents: element idx at x[k * stride + base + idx].
struct Arr {
  ar::Limb* x;
  int* e;
  size_t stride, base;
  __device__ __forceinline__ Val get(size_t idx) const { return ar::load<K>(x, e, stride, base + idx); }
  __device__ __forceinline__ void put(size_t idx, const Val& v) const {
    ar::store<K>(x, e, stride, base + idx, v);
  }
};

__global__ void __launch_bounds__(32 * WMAX)
mp_trsm_kernel(const ar::Limb* __restrict__ T, const int* __restrict__ Te,
               const ar::Limb* __restrict__ Bm, const int* __restrict__ Bme,
               ar::Limb* __restrict__ R, int* __restrict__ Re,
               ar::Limb* __restrict__ D, int* __restrict__ De,
               ar::Limb* __restrict__ X, int* __restrict__ Xe, int B, int n, int m,
               int lower, int shared) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int E = n * m;
  const int ntri = tri(n);
  // shared: the limbs of dinv [n], x_i [m], R [E] and T's triangle [ntri],
  // limb-major; then their exponents (scaled)
  ar::Limb* sD = (ar::Limb*)smem;
  ar::Limb* sX = sD + (size_t)K * n;
  ar::Limb* sR = sX + (size_t)K * m;
  ar::Limb* sT = sR + (size_t)K * E;
  int* sDe = (int*)(sT + (size_t)K * ntri);
  int* sXe = sDe + (kScaled ? n : 0);
  int* sRe = sXe + (kScaled ? m : 0);
  int* sTe = sRe + (kScaled ? E : 0);

  const size_t nn = (size_t)n * n;
  const size_t bs = (size_t)B * E;  // limb stride of Bm, R and X
  const size_t tb = (size_t)blockIdx.x * nn;  // this block's first elements
  const size_t bb = (size_t)blockIdx.x * E;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const Arr tg{(ar::Limb*)T, (int*)Te, B * nn, tb};
  const Arr out{X, Xe, bs, bb};
  const Arr dinv = shared ? Arr{sD, sDe, (size_t)n, 0}
                          : Arr{D, De, (size_t)B * n, (size_t)blockIdx.x * n};
  const Arr res = shared ? Arr{sR, sRe, (size_t)E, 0} : Arr{R, Re, bs, bb};
  const Arr tri_s{sT, sTe, (size_t)ntri, 0};
  // the triangle packed by columns, so the rows of one pivot column lie
  // side by side
  auto packed = [&](int r, int i) { return lower ? pcol(i, n) + r - i : tri(i) + r; };

  for (int i = tid; i < n; i += nt) dinv.put(i, ar::reciprocal<K>(tg.get((size_t)i * n + i)));
  if (shared) {
    for (int i = warp; i < n; i += nwarps)
      for (int r = (lower ? i : 0) + lane; r < (lower ? n : i + 1); r += 32)
        tri_s.put(packed(r, i), tg.get((size_t)r * n + i));
  }
  for (int e = tid; e < E; e += nt) res.put(e, ar::load<K>(Bm, Bme, bs, bb + e));
  __syncthreads();  // dinv, T and R in place

  for (int step = 0; step < n; ++step) {
    const int i = lower ? step : n - 1 - step;
    // x_i: in shared memory, or the row of X itself
    const Arr xrow = shared ? Arr{sX, sXe, (size_t)m, 0} : Arr{X, Xe, bs, bb + (size_t)i * m};
    for (int c = tid; c < m; c += nt) {
      const Val x = ar::mul<K>(res.get((size_t)i * m + c), dinv.get(i));
      if (shared) xrow.put(c, x);
      out.put((size_t)i * m + c, x);
    }
    __syncthreads();  // x_i written
    const int pairs = (n - 1 - step) * m;  // the entries still to come
    for (int q = tid; q < pairs; q += nt) {
      const int k = q / m, c = q - k * m;
      const int r = lower ? i + 1 + k : i - 1 - k;
      const Val t = shared ? tri_s.get(packed(r, i)) : tg.get((size_t)r * n + i);
      const size_t rc = (size_t)r * m + c;
      res.put(rc, ar::sub<K>(res.get(rc), ar::mul<K>(t, xrow.get(c))));
    }
    __syncthreads();  // R updated, x_i read
  }
}

}  // namespace

// R/Re [K,B,n,m] and D/De [K,B,n]: the caller's scratch for the residual
// and the reciprocals, used where they do not fit in shared memory.
extern "C" int mp_trsm_launch(const void* T, const void* Te, const void* Bm,
                              const void* Bme, void* R, void* Re, void* D, void* De,
                              void* X, void* Xe, int B, int n, int m, int lower,
                              void* stream) {
  // the opt-in shared memory of the device, queried and granted to the
  // kernel once per device (a small solve takes tens of microseconds)
  static int optins[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (optins[dev] == 0) {
    int optin = 0;
    cudaError_t err =
        cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(mp_trsm_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return (int)err;
    optins[dev] = optin;
  }
  const size_t per = K * sizeof(ar::Limb) + (kScaled ? sizeof(int) : 0);
  const size_t E = (size_t)n * m;
  const size_t all = ((size_t)n + (size_t)m + E + (size_t)n * (n + 1) / 2) * per;
  const int shared = all <= (size_t)optins[dev];
  // a warp for every 32 entries, at most WMAX
  const size_t warps = (E + 31) / 32 < (size_t)WMAX ? (E + 31) / 32 : (size_t)WMAX;
  mp_trsm_kernel<<<B, 32 * (int)warps, shared ? all : 0, (cudaStream_t)stream>>>(
      (const ar::Limb*)T, (const int*)Te, (const ar::Limb*)Bm, (const int*)Bme,
      (ar::Limb*)R, (int*)Re, (ar::Limb*)D, (int*)De, (ar::Limb*)X, (int*)Xe, B, n, m,
      lower, shared);
  return (int)cudaGetLastError();
}
