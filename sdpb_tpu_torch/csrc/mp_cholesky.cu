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
// What bounds it on an H100: latency.  Each pivot is a serial rsqrt chain
// (one thread) followed by a trailing update of (n-j)(n-j-1)/2 MP
// multiply-adds, so a block is idle during the chain and under-filled near
// the end.  Design: one thread block per batch element (B = 120 blocks on
// 132 SMs for the ladder's Schur complements), the working matrix in a
// global scratch buffer so that any n fits (57 x 57 at K = 5 is 130 KB),
// block-wide barriers between the three phases of a pivot.
#include "mp.cuh"

namespace {

template <int K>
__global__ void __launch_bounds__(256)
mp_cholesky_kernel(const ar::Limb* __restrict__ A, const int* __restrict__ Ae,
                   ar::Limb* __restrict__ W, int* __restrict__ We,
                   ar::Limb* __restrict__ L, int* __restrict__ Le, int B, int n) {
  const size_t nn = (size_t)n * n;
  const size_t ls = (size_t)B * nn;          // limb stride
  const size_t base = (size_t)blockIdx.x * nn;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  __shared__ ar::Val<K> r_sh;

  for (size_t idx = tid; idx < nn; idx += nt) {
    const bool lower = (idx % n) <= (idx / n);
    ar::store<K>(W, We, ls, base + idx,
                 lower ? ar::load<K>(A, Ae, ls, base + idx) : ar::zero<K>());
    ar::store<K>(L, Le, ls, base + idx, ar::zero<K>());
  }
  __syncthreads();

  for (int j = 0; j < n; ++j) {
    const size_t jj = base + (size_t)j * n + j;
    if (tid == 0) {
      const ar::Val<K> d2 = ar::load<K>(W, We, ls, jj);
      const ar::Val<K> r = ar::rsqrt<K>(d2);
      ar::store<K>(L, Le, ls, jj, ar::mul<K>(d2, r));
      r_sh = r;
    }
    __syncthreads();
    const ar::Val<K> r = r_sh;
    for (int i = j + 1 + tid; i < n; i += nt) {
      const size_t ij = base + (size_t)i * n + j;
      ar::store<K>(L, Le, ls, ij, ar::mul<K>(ar::load<K>(W, We, ls, ij), r));
    }
    __syncthreads();
    // lower trailing block, pairs (ii, kk) with 0 <= kk <= ii < t
    const int t = n - j - 1;
    const int npairs = t * (t + 1) / 2;
    for (int q = tid; q < npairs; q += nt) {
      int ii = (int)((sqrt(8.0 * q + 1.0) - 1.0) * 0.5);
      while (ii * (ii + 1) / 2 > q) --ii;
      while ((ii + 1) * (ii + 2) / 2 <= q) ++ii;
      const int kk = q - ii * (ii + 1) / 2;
      const int i = j + 1 + ii, k = j + 1 + kk;
      const ar::Val<K> li = ar::load<K>(L, Le, ls, base + (size_t)i * n + j);
      const ar::Val<K> lk = ar::load<K>(L, Le, ls, base + (size_t)k * n + j);
      const size_t ik = base + (size_t)i * n + k;
      ar::store<K>(W, We, ls, ik, ar::sub<K>(ar::load<K>(W, We, ls, ik), ar::mul<K>(li, lk)));
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int mp_cholesky_launch(const void* A, const void* Ae, void* W, void* We,
                                  void* L, void* Le, int B, int n, void* stream) {
  mp_cholesky_kernel<MP_K><<<B, 256, 0, (cudaStream_t)stream>>>(
      (const ar::Limb*)A, (const int*)Ae, (ar::Limb*)W, (int*)We, (ar::Limb*)L,
      (int*)Le, B, n);
  return (int)cudaGetLastError();
}
