// Elementwise three-word (wide) MP sum and product: o = a + b and o = a * b
// for n elements, each operand and the output three scaled words (float32
// limbs [Kg, n] limb-major, int32 exponents [n] per word), Kg = MP_K.
//
// The JAX package computes a three-word sum or product as its generic-G
// branch of mpwide.add and mul (sdpb_tpu/ops/mpwide.py:262-306), XLA ops
// fused on the TPU.  As torch ops, one three-word product is about 55,000
// kernel launches (a sum about 17,000): in the interior-point iteration
// they would be most of the CUDA graph's nodes and of the eager time.  So
// each is one kernel here, one thread per element running mp_wide3.cuh's
// wadd or wmul; kernels.mp_wide3_add / mp_wide3_mul broadcast and lay out
// the operands, and on the CPU run the plain versions
// (ops/mpwide_kernel.py's wadd_g_c, wmul_g_c), with which these agree limb
// for limb and exponent for exponent.  A product is bound by its thread's
// latency through the word products' TwoSum sweeps, which mp_wide3.cuh runs
// as a skewed wavefront (K independent TwoSums a step); a sum by its word
// TwoSums, whose stacks are registers.  Built with -DMP_WIDE=1
// -DMP_SCALED=1.
#include "mp_wide3.cuh"

namespace {

using namespace mpw3;
constexpr int THREADS = 128;

__device__ __forceinline__ W load3(const Words& x, size_t n, size_t i) {
  W v;
#pragma unroll
  for (int g = 0; g < G; ++g) v.w[g] = mps::load<K>(x.x[g], x.e[g], n, i);
  return v;
}

__device__ __forceinline__ void store3(const OutWords& o, size_t n, size_t i, const W& v) {
#pragma unroll
  for (int g = 0; g < G; ++g) mps::store<K>(o.x[g], o.e[g], n, i, v.w[g]);
}

__global__ void __launch_bounds__(THREADS)
mp_wide3_add_kernel(Words a, Words b, OutWords o, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  store3(o, (size_t)n, (size_t)i, wadd(load3(a, (size_t)n, (size_t)i),
                                       load3(b, (size_t)n, (size_t)i)));
}

// The product: a thread an element, its scratch in local memory (the
// SM's L1 and L2; held in shared memory it left room for four warps an SM,
// which measured slower than sixteen warps over L1 and L2).
__global__ void __launch_bounds__(THREADS, 4)
mp_wide3_mul_kernel(Words a, Words b, OutWords o, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float T[SCRATCH];
  store3(o, (size_t)n, (size_t)i, wmul(load3(a, (size_t)n, (size_t)i),
                                       load3(b, (size_t)n, (size_t)i), T));
}

}  // namespace

// ptrs: a's, b's and o's words, each its limbs and exponents (a0, a0e, a1,
// a1e, a2, a2e, b0, ..., o2e), n elements each, contiguous; op 0 adds,
// op 1 multiplies.
extern "C" int mp_wide3_ew_launch(const void* a0, const void* a0e, const void* a1,
                                  const void* a1e, const void* a2, const void* a2e,
                                  const void* b0, const void* b0e, const void* b1,
                                  const void* b1e, const void* b2, const void* b2e, void* o0,
                                  void* o0e, void* o1, void* o1e, void* o2, void* o2e,
                                  long long n, int op, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const Words a{{(const float*)a0, (const float*)a1, (const float*)a2},
                {(const int*)a0e, (const int*)a1e, (const int*)a2e}};
  const Words b{{(const float*)b0, (const float*)b1, (const float*)b2},
                {(const int*)b0e, (const int*)b1e, (const int*)b2e}};
  const OutWords o{{(float*)o0, (float*)o1, (float*)o2}, {(int*)o0e, (int*)o1e, (int*)o2e}};
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  cudaStream_t st = (cudaStream_t)stream;
  if (op == 0)
    mp_wide3_add_kernel<<<blocks, THREADS, 0, st>>>(a, b, o, n);
  else if (op == 1)
    mp_wide3_mul_kernel<<<blocks, THREADS, 0, st>>>(a, b, o, n);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
