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
// x_i = Bres[i,:] * dinv_i, and it is eliminated at once from the rows
// still to come, Bres[r,c] -= T[r,i] * x_i[c].
//
// What bounds it on an H100: latency.  The n pivots are strictly
// sequential, and each does only m (solve) plus (n-1-i) m (elimination)
// MP multiply-adds, far too little to fill an SM.  Design: one thread block
// per batch element, the residual right-hand side in a global scratch
// buffer, threads spread over the columns of x_i and then over the (row,
// column) pairs of the elimination, with block-wide barriers in between.
#include "mp.cuh"

namespace {

template <int K>
__global__ void __launch_bounds__(256)
mp_trsm_kernel(const ar::Limb* __restrict__ T, const int* __restrict__ Te,
               const ar::Limb* __restrict__ Bm, const int* __restrict__ Bme,
               ar::Limb* __restrict__ R, int* __restrict__ Re,
               ar::Limb* __restrict__ D, int* __restrict__ De,
               ar::Limb* __restrict__ X, int* __restrict__ Xe,
               int B, int n, int m, int lower) {
  const size_t nn = (size_t)n * n;
  const size_t nm = (size_t)n * m;
  const size_t ts = (size_t)B * nn;  // limb strides
  const size_t bs = (size_t)B * nm;
  const size_t ds = (size_t)B * n;
  const size_t tb = (size_t)blockIdx.x * nn;  // this block's first elements
  const size_t bb = (size_t)blockIdx.x * nm;
  const size_t db = (size_t)blockIdx.x * n;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  for (size_t idx = tid; idx < nm; idx += nt)
    ar::store<K>(R, Re, bs, bb + idx, ar::load<K>(Bm, Bme, bs, bb + idx));
  for (int i = tid; i < n; i += nt)
    ar::store<K>(D, De, ds, db + i,
                 ar::reciprocal<K>(ar::load<K>(T, Te, ts, tb + (size_t)i * n + i)));
  __syncthreads();

  for (int step = 0; step < n; ++step) {
    const int i = lower ? step : n - 1 - step;
    const ar::Val<K> di = ar::load<K>(D, De, ds, db + i);
    for (int c = tid; c < m; c += nt) {
      const size_t ic = bb + (size_t)i * m + c;
      ar::store<K>(X, Xe, bs, ic, ar::mul<K>(ar::load<K>(R, Re, bs, ic), di));
    }
    __syncthreads();
    const int r0 = lower ? i + 1 : 0;
    const int nrows = lower ? n - 1 - i : i;
    for (int q = tid; q < nrows * m; q += nt) {
      const int r = r0 + q / m;
      const int c = q % m;
      const ar::Val<K> t = ar::load<K>(T, Te, ts, tb + (size_t)r * n + i);
      const ar::Val<K> x = ar::load<K>(X, Xe, bs, bb + (size_t)i * m + c);
      const size_t rc = bb + (size_t)r * m + c;
      ar::store<K>(R, Re, bs, rc, ar::sub<K>(ar::load<K>(R, Re, bs, rc), ar::mul<K>(t, x)));
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int mp_trsm_launch(const void* T, const void* Te, const void* Bm,
                              const void* Bme, void* R, void* Re, void* D, void* De,
                              void* X, void* Xe, int B, int n, int m, int lower,
                              void* stream) {
  mp_trsm_kernel<MP_K><<<B, 256, 0, (cudaStream_t)stream>>>(
      (const ar::Limb*)T, (const int*)Te, (const ar::Limb*)Bm, (const int*)Bme,
      (ar::Limb*)R, (int*)Re, (ar::Limb*)D, (int*)De, (ar::Limb*)X, (int*)Xe, B, n,
      m, lower);
  return (int)cudaGetLastError();
}
