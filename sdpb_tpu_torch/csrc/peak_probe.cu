// Peak probe of the CUDA cores: out[i] = `steps` dependent passes of
// x <- round(round(x * a) + b) over x[i], float32 or float64.
//
// Replaces the inner kernel of sdpb_tpu/tools/profile_phases.py::
// vpu_peak_gflops (the Pallas calibration kernel: a chain of x * a + b over
// one VMEM-resident tile).  Here each multiply and each add is rounded on
// its own (__fmul_rn/__fadd_rn, __dmul_rn/__dadd_rn, under the library's
// -fmad=false), because the MP kernels issue only unfused adds and
// multiplies: the probe measures the rate of exactly those instructions,
// the rate chip_smoke.py's bounds assume from the data sheet, and it stays
// bit-identical with the plain PyTorch version (two torch ops per step).
//
// What bounds it on an H100: operations.  2 * steps * n unfused operations
// against 8 n (float32) or 16 n (float64) bytes read and written once.
// Design: one dependent chain per thread, the loop unrolled by 32 so that
// the loop counter takes few issue slots.  At the 512 x 512 tile that is
// 1024 blocks of 256 threads, about one full wave over 132 SMs at 2048
// threads each, i.e. ~16 warps per scheduler: enough to hide the few
// cycles of latency of each dependent FMUL/FADD (DMUL/DADD).  If the
// reading comes out low, give each thread 2-4 independent chains.
#include <cuda_runtime.h>

namespace {

constexpr int UNROLL = 32;

__device__ __forceinline__ float step(float x, float a, float b) {
  return __fadd_rn(__fmul_rn(x, a), b);
}

__device__ __forceinline__ double step(double x, double a, double b) {
  return __dadd_rn(__dmul_rn(x, a), b);
}

template <typename T>
__global__ void __launch_bounds__(256)
peak_probe_kernel(const T* __restrict__ x, T* __restrict__ out, int n, int steps, T a,
                  T b) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  T v = x[i];
  int s = 0;
  for (; s + UNROLL <= steps; s += UNROLL) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) v = step(v, a, b);
  }
  for (; s < steps; ++s) v = step(v, a, b);
  out[i] = v;
}

template <typename T>
int launch(const void* x, void* out, int n, int steps, T a, T b, void* stream) {
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  if (blocks > 0)
    peak_probe_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const T*)x, (T*)out, n, steps, a, b);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int peak_probe_f32(const void* x, void* out, int n, int steps, float a,
                              float b, void* stream) {
  return launch<float>(x, out, n, steps, a, b, stream);
}

extern "C" int peak_probe_f64(const void* x, void* out, int n, int steps, double a,
                              double b, void* stream) {
  return launch<double>(x, out, n, steps, a, b, stream);
}
