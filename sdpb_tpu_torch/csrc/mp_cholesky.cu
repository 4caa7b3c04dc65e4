// Batched MP Cholesky: lower L with L L^T = A for A[K,B,n,n] in K-limb MP
// arithmetic, classic (float64 limbs) or scaled (float32 limbs and an int32
// exponent [B,n,n] per element), one library per (K, representation).
//
// Replaces sdpb_tpu/ops/pallas_kernels.py::_cholesky_kernel, both branches
// (scaled=False and scaled=True).  Right-looking, reading ONLY the lower
// triangle of A (solver matrices are symmetric only to the last ulp).  Per
// pivot j, the same operations as the TPU kernel: r = rsqrt(W[j,j]) by one
// Newton chain, L[j,j] = W[j,j] * r, L[i,j] = W[i,j] * r below the
// diagonal, and the rank-1 trailing update W[i,k] -= L[i,j] * L[k,j] for
// i >= k > j.  The TPU kernel updates the whole working matrix (scaled:
// with exponent tiles beside the limb tiles); entries outside the lower
// trailing block are never read again, so the values of L are the same.
//
// What bounds it on an H100: the latency of the pivot chain.  Per pivot,
// rsqrt is newton_steps(K) Newton steps of 4 products and a difference (16
// and 4 at K = 8), and nothing of the next pivot can start before it
// ends.  The previous kernel ran the chain in one thread, the rest of the
// block waiting at a barrier, then the column and the trailing update
// behind two more barriers: 0.21 ms a pivot at scaled K = 8 for B = 1 and 120, n = 20
// and 57, 166 us of it the rsqrt, whose loop inlined four products, each
// then run at 2.2x the cycles of a loop holding one (instruction fetch;
// NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §6, step 0).  Design:
//   * the pivot chain runs in a warp of its own and looks ahead: once r_j
//     is known it computes L[j+1,j] = W[j+1,j] r_j, updates W[j+1,j+1] -=
//     L[j+1,j]^2 and starts r_{j+1}, while the worker warps scale column
//     j and run pivot j's trailing update, column j+1 and W[j+2,j+2] first
//     (the chain's next inputs), the rest after.  Named barriers pass r_j
//     to the workers and the first part of the update back, alternating
//     between two ids each, so that neither side runs two pivots ahead;
//   * the chain's code is compact: the rsqrt's four products are one call
//     site (mpk::rsqrt_steps), and in the scaled build every MP product and
//     sum of the kernel is one outlined copy (mpo::), so a pivot costs its
//     18 products and 5 sums at the one-copy rate; the classic products, a
//     few hundred instructions, stay inlined;
//   * the workers skip the warps that share the chain warp's scheduler
//     (warp w runs on scheduler w mod 4), so the chain has its own.
// The chain's products spread over the chain warp's lanes (the renorm
// sweeps a lane each, rows passed by __shfl_up_sync) measured no faster
// than one thread's (PERF.md §6).  Each entry still gets its updates in
// pivot order, so L has the bits of the plain version.  One block per
// batch element; the working matrix in a global scratch buffer, laid out
// by block, so that any n fits.
#include "mp.cuh"

namespace {

using Val = ar::Val<MP_K>;
constexpr int K = MP_K;
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int WORKER_WARPS = WARPS - WARPS / 4;  // the warps off scheduler 0
constexpr int WORKERS = 32 * WORKER_WARPS;
constexpr int TEAM = 32 + WORKERS;               // the chain warp and the workers
// named barrier ids (0 is __syncthreads): r_j ready, the first part of
// pivot j's update done, each by j's parity; the workers among themselves
constexpr int BAR_R = 1, BAR_P = 3, BAR_W = 5;

// The MP operations of the chain and the workers: one outlined copy each
// where a product is thousands of instructions (scaled), inlined where it
// is a few hundred (classic: fetched once all the same; outlined, one
// thread's classic K = 4 rsqrt took 22,848 cycles against 21,508 inlined;
// NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §6).
#if MP_SCALED
namespace op = mpo;
#else
namespace op = ar;
#endif

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  __threadfence_block();
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// The entry (i, k), i >= k, of a lower triangle of order t numbered q in
// row-major order.
__device__ __forceinline__ void tri_pair(int q, int& i, int& k) {
  i = (int)((sqrt(8.0 * q + 1.0) - 1.0) * 0.5);
  while (i * (i + 1) / 2 > q) --i;
  while ((i + 1) * (i + 2) / 2 <= q) ++i;
  k = q - i * (i + 1) / 2;
}

__global__ void __launch_bounds__(THREADS)
mp_cholesky_kernel(const ar::Limb* __restrict__ A, const int* __restrict__ Ae,
                   ar::Limb* __restrict__ W, int* __restrict__ We,
                   ar::Limb* __restrict__ L, int* __restrict__ Le, int B, int n) {
  const size_t nn = (size_t)n * n;
  const size_t ls = (size_t)B * nn;  // limb stride
  const size_t base = (size_t)blockIdx.x * nn;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  __shared__ Val r_sh[2];
  // W is this kernel's scratch, laid out by block: limb k of this block's
  // entry idx at Wb[k * nn + idx], so that a block's K limb planes lie
  // together (4 K n^2 bytes) and not B n^2 entries apart
  ar::Limb* const Wb = W + (size_t)blockIdx.x * K * nn;
  int* const Web = We == nullptr ? nullptr : We + base;

  auto w_at = [&](int i, int k) { return ar::load<K>(Wb, Web, nn, (size_t)i * n + k); };
  auto l_at = [&](int i, int k) { return ar::load<K>(L, Le, ls, base + (size_t)i * n + k); };

  for (size_t idx = tid; idx < nn; idx += THREADS) {
    const bool lower = (idx % n) <= (idx / n);
    ar::store<K>(Wb, Web, nn, idx, lower ? ar::load<K>(A, Ae, ls, base + idx) : ar::zero<K>());
    ar::store<K>(L, Le, ls, base + idx, ar::zero<K>());
  }
  __syncthreads();

  if (warp == 0) {
    // The pivot chain, on every lane alike; lane 0 writes.  r_j is passed
    // on before anything that depends on it is computed here.
    Val r = op::rsqrt<K>(w_at(0, 0));
    if (lane == 0) r_sh[0] = r;
    bar_arrive(BAR_R, TEAM);
    for (int j = 0; j + 1 < n; ++j) {
      // W[j+1,j] and W[j+1,j+1] after pivot j-1 (the workers' first part)
      if (j > 0) bar_sync(BAR_P + ((j - 1) & 1), TEAM);
      const Val l = op::mul<K>(w_at(j + 1, j), r);  // L[j+1,j], as the workers get it
      const Val d = op::sub<K>(w_at(j + 1, j + 1), op::mul<K>(l, l));
      if (lane == 0) ar::store<K>(Wb, Web, nn, (size_t)(j + 1) * n + j + 1, d);
      r = op::rsqrt<K>(d);
      if (lane == 0) r_sh[(j + 1) & 1] = r;
      bar_arrive(BAR_R + ((j + 1) & 1), TEAM);
    }
    return;
  }
  if (warp % 4 == 0) return;  // shares the chain warp's scheduler
  const int wt = 32 * (warp - 1 - warp / 4) + lane;  // 0 .. WORKERS - 1

  for (int j = 0; j < n; ++j) {
    bar_sync(BAR_R + (j & 1), TEAM);
    const Val r = r_sh[j & 1];
    // column j: L[j,j] = W[j,j] r and L[i,j] = W[i,j] r below it
    for (int i = j + wt; i < n; i += WORKERS)
      ar::store<K>(L, Le, ls, base + (size_t)i * n + j, op::mul<K>(w_at(i, j), r));
    if (j + 1 == n) break;
    bar_sync(BAR_W, WORKERS);  // column j written
    // pivot j's update of (i, k), j + 1 <= k <= i, but (j+1, j+1) (the
    // chain's): first column j+1 below the diagonal and (j+2, j+2), the
    // chain's inputs for pivot j+1, then the rest
    auto update = [&](int i, int k) {
      const size_t ik = (size_t)i * n + k;
      ar::store<K>(Wb, Web, nn, ik,
                   op::sub<K>(ar::load<K>(Wb, Web, nn, ik), op::mul<K>(l_at(i, j), l_at(k, j))));
    };
    const int below = n - j - 2;  // rows of column j+1 below its diagonal
    const int first = below > 0 ? below + 1 : 0;
    for (int q = wt; q < first; q += WORKERS) {
      if (q < below)
        update(j + 2 + q, j + 1);
      else
        update(j + 2, j + 2);
    }
    // the chain waits for this at pivots j + 1 < n - 1 only
    if (j + 2 < n) bar_arrive(BAR_P + (j & 1), TEAM);
    // the rest: (i, k) with j + 2 <= k <= i < n, (j+2, j+2) excepted
    const int t = n - j - 2;
    for (int q = 1 + wt; q < t * (t + 1) / 2; q += WORKERS) {
      int ii, kk;
      tri_pair(q, ii, kk);
      update(j + 2 + ii, j + 2 + kk);
    }
    bar_sync(BAR_W, WORKERS);  // pivot j's update done
  }
}

}  // namespace

extern "C" int mp_cholesky_launch(const void* A, const void* Ae, void* W, void* We,
                                  void* L, void* Le, int B, int n, void* stream) {
  mp_cholesky_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
      (const ar::Limb*)A, (const int*)Ae, (ar::Limb*)W, (int*)We, (ar::Limb*)L, (int*)Le,
      B, n);
  return (int)cudaGetLastError();
}
