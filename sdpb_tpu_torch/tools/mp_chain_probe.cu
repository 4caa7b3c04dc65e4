// Latency and rate probe of the MP operations of csrc/mp.cuh (classic, or
// scaled with -DMP_SCALED=1), built by tools/kernel_report.py with the
// kernels' own flags and the csrc/ of the checkout it measures.
//
// chain_kernel<OP> runs `steps` dependent MP operations in every thread
// and writes the clock cycles the first thread of each block spent in the
// loop: OP 0 r = mul(r, a), 1 r = add(r, a), 2 r = rsqrt(r), 3 four
// dependent products a loop step (the loop body four times OP 0's code);
// 4 r = mpo::mul(r, a), 5 r = mpo::add(r, a), 6 r = mpo::rsqrt(r), the
// outlined operations; 7 r = rsqrt(r) with its Newton steps as a loop of
// four inlined products a step (rsqrt_four, the form that
// mpk::rsqrt_steps's loop of one product replaced; the same bits).
// Launched as one thread it measures an operation's latency, the way a
// factor's pivot chain runs it; launched as many blocks, the card's rate.
#include "mp.cuh"

namespace {

constexpr int K = MP_K;

__device__ ar::Val<K> rsqrt_four(const ar::Val<K>& a) {
  ar::Val<K> r = ar::rsqrt_seed<K>(a);
  const ar::Val<K> half = ar::constant<K>(0.5);
  const ar::Val<K> three_half = ar::constant<K>(1.5);
#pragma unroll 1
  for (int s = 0; s < mpk::newton_steps<K>(); ++s) {
    const ar::Val<K> arr = ar::mul<K>(a, ar::mul<K>(r, r));
    r = ar::mul<K>(r, ar::sub<K>(three_half, ar::mul<K>(half, arr)));
  }
  return r;
}

template <int OP>
__global__ void chain_kernel(const ar::Limb* __restrict__ x, const int* __restrict__ xe,
                             ar::Limb* __restrict__ o, int* __restrict__ oe, int steps,
                             long long* __restrict__ cycles) {
  const ar::Val<K> a = ar::load<K>(x, xe, 2, 0);
  ar::Val<K> r = ar::load<K>(x, xe, 2, 1);
  const long long t0 = clock64();
#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    if (OP == 0) r = ar::mul<K>(r, a);
    if (OP == 1) r = ar::add<K>(r, a);
    if (OP == 2) r = ar::rsqrt<K>(r);
    if (OP == 3) r = ar::mul<K>(ar::mul<K>(ar::mul<K>(ar::mul<K>(r, a), a), a), a);
    if (OP == 4) r = mpo::mul<K>(r, a);
    if (OP == 5) r = mpo::add<K>(r, a);
    if (OP == 6) r = mpo::rsqrt<K>(r);
    if (OP == 7) r = rsqrt_four(r);
  }
  const long long t1 = clock64();
  const size_t gid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  ar::store<K>(o, oe, (size_t)gridDim.x * blockDim.x, gid, r);
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}

}  // namespace

extern "C" int chain_launch(int op, const void* x, const void* xe, void* o, void* oe,
                            int steps, void* cycles, int blocks, int threads) {
  auto a = (const ar::Limb*)x;
  auto ae = (const int*)xe;
  auto r = (ar::Limb*)o;
  auto re = (int*)oe;
  auto c = (long long*)cycles;
  if (op == 0) chain_kernel<0><<<blocks, threads>>>(a, ae, r, re, steps, c);
  if (op == 1) chain_kernel<1><<<blocks, threads>>>(a, ae, r, re, steps, c);
  if (op == 2) chain_kernel<2><<<blocks, threads>>>(a, ae, r, re, steps, c);
  if (op == 3) chain_kernel<3><<<blocks, threads>>>(a, ae, r, re, steps, c);
  if (op == 4) chain_kernel<4><<<blocks, threads>>>(a, ae, r, re, steps, c);
  if (op == 5) chain_kernel<5><<<blocks, threads>>>(a, ae, r, re, steps, c);
  if (op == 6) chain_kernel<6><<<blocks, threads>>>(a, ae, r, re, steps, c);
  if (op == 7) chain_kernel<7><<<blocks, threads>>>(a, ae, r, re, steps, c);
  return (int)cudaGetLastError();
}
