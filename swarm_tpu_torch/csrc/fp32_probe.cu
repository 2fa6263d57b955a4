// A float32 rate probe for the roofline (swarm_tpu_torch/roofline.py).
//
// It replaces no TPU kernel: tools/roofline.py measured the same ceiling
// with a fused XLA chain of compare, select and add passes over a block in
// VMEM (`measure_vpu`). Here each thread keeps CHAINS independent values in
// registers and runs, `iters` times, the step
//
//     v = (v > 0.5f) ? v * 0.99999f : v + 1e-6f
//
// on each: a compare, a multiply, an add and a select, counted as four
// operations. Every step depends on the one before, so nothing folds; the
// CHAINS chains give each warp independent instructions to issue while one
// waits on its last result. With --fmad=false the multiply and the add stay
// two roundings, as torch's `torch.where(v > 0.5, v * 0.99999, v + 1e-6)`
// issues them, so the probe equals that chain bit for bit (checked on a
// small block). It reads and writes 2 x 4 x CHAINS bytes a thread and does
// 4 x CHAINS x iters operations a thread: at the roofline's iters it is
// bound by operations by some hundred times.

#include <cuda_runtime.h>

namespace {

constexpr int CHAINS = 8;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
    fp32_probe_kernel(const float* __restrict__ x, float* __restrict__ y,
                      int n_threads, int iters) {
  const int t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= n_threads) return;
  float v[CHAINS];
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) v[c] = x[(size_t)t * CHAINS + c];
  for (int k = 0; k < iters; ++k) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c)
      v[c] = (v[c] > 0.5f) ? v[c] * 0.99999f : v[c] + 1e-6f;
  }
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) y[(size_t)t * CHAINS + c] = v[c];
}

}  // namespace

// x, y: [n_threads, CHAINS] float32 on the card; one thread a row.
extern "C" int fp32_probe_launch(const float* x, float* y, int n_threads,
                                 int iters, void* stream) {
  if (n_threads < 0 || iters < 0) return (int)cudaErrorInvalidValue;
  if (n_threads > 0)
    fp32_probe_kernel<<<(n_threads + THREADS - 1) / THREADS, THREADS, 0,
                        (cudaStream_t)stream>>>(x, y, n_threads, iters);
  return (int)cudaGetLastError();
}

extern "C" int fp32_probe_chains() { return CHAINS; }
