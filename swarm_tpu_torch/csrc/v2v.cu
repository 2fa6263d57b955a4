// Pairwise V2V statistics, for Hopper.
//
// It replaces no TPU kernel: the JAX package computes V2V in plain jnp
// (swarm_tpu/engine/sim.py v2v_stats), and the port's plain version
// (ops/v2v_cuda.py v2v_stats_plain) builds a [chunk, N] block of squared
// distances per chunk of rows, masks it and reduces it. Per row i it gives
// the least squared distance to a live agent j != i and the number of
// pairs with d2 <= r2, where a dead or self pair reads +inf, as the plain
// version's `where` writes it (so with r2 = +inf such a pair counts).
// This kernel computes both with no [chunk, N] block.
//
// Per pair, as the plain version rounds it: dx = xi - xj, dy = yi - yj,
// d2 = dx*dx + dy*dy, each operation rounded on its own (--fmad=false, and
// the intrinsics below say so), compared with r2 as torch compares a
// float32 tensor with a Python float: r2 rounded to float32 by the caller.
// The minimum propagates NaN, as torch.amin does (min.NaN.f32).
//
// What bounds it on the H100: N^2 pairs (1.07e9 at 32,768 agents) of about
// eight float32 and integer operations each, ~0.3 ms at the instruction
// rate; the inputs (N float2 and N bytes) fit in L2. The design: each thread
// keeps ROWS rows' coordinates, minima and counts in registers; a block of
// THREADS threads (BLOCK_ROWS rows) walks its share of the columns in
// tiles of TILE float2 staged in shared memory, so one broadcast read of a
// column serves ROWS rows. The columns are split over gridDim.y blocks
// (the wrapper chooses the split from N and the SM count, so the grid
// fills the card at any N), each writing its rows' partial minimum and
// count to a [splits, N] scratch; a finishing kernel reduces the splits
// (an integer minimum of the non-negative floats' bits and an integer
// sum, both exact in any order) and writes cm = trunc(sqrt(d2min) * 100),
// 0 where d2min is not finite, and the count. A tile with a dead column
// or the block's own rows (the self pairs) takes the masked loop; every
// other tile the plain loop. A NaN minimum is stored as +0.0: both give
// cm 0 (the plain version maps a non-finite minimum to 0, sqrt(0) * 100 is
// 0), and the count never reads the minimum.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
//        -std=c++17 -shared -Xcompiler -fPIC (see ops/cuda_build.py)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 4;                          // rows a thread
constexpr int BLOCK_ROWS = THREADS * ROWS;
constexpr int TILE = THREADS;                    // columns a staged tile
constexpr int FINISH_THREADS = 256;

__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float pair_d2(float xi, float yi, float2 c) {
  const float dx = __fsub_rn(xi, c.x);
  const float dy = __fsub_rn(yi, c.y);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

__global__ void __launch_bounds__(THREADS)
    v2v_pairs_kernel(const float2* __restrict__ xy,
                     const uint8_t* __restrict__ alive, int n, float r2,
                     int cols_per_split, int* __restrict__ part_min,
                     int* __restrict__ part_cnt) {
  __shared__ float2 s_xy[TILE];
  __shared__ uint8_t s_dead[TILE];
  const int r0 = blockIdx.x * BLOCK_ROWS;
  const int r1 = min(n, r0 + BLOCK_ROWS);
  const int c0 = blockIdx.y * cols_per_split;
  const int c1 = min(n, c0 + cols_per_split);
  float x[ROWS], y[ROWS], m[ROWS];
  int cnt[ROWS];
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int i = r0 + threadIdx.x + k * THREADS;
    const float2 p = i < n ? xy[i] : make_float2(0.f, 0.f);
    x[k] = p.x;
    y[k] = p.y;
    m[k] = __int_as_float(0x7f800000);
    cnt[k] = 0;
  }
  const float inf = __int_as_float(0x7f800000);
  for (int t0 = c0; t0 < c1; t0 += TILE) {
    const int w = min(TILE, c1 - t0);
    const int j = t0 + threadIdx.x;
    bool dead = false;
    if (threadIdx.x < w) {
      s_xy[threadIdx.x] = xy[j];
      dead = alive[j] == 0;
      s_dead[threadIdx.x] = dead;
    }
    // a barrier, and whether any staged column is dead
    const bool masked = __syncthreads_or(dead) || (t0 < r1 && r0 < t0 + w);
    if (!masked) {
#pragma unroll 8
      for (int c = 0; c < w; ++c) {
        const float2 p = s_xy[c];
#pragma unroll
        for (int k = 0; k < ROWS; ++k) {
          const float d2 = pair_d2(x[k], y[k], p);
          m[k] = min_nan(m[k], d2);
          cnt[k] += d2 <= r2;
        }
      }
    } else {
      for (int c = 0; c < w; ++c) {
        const float2 p = s_xy[c];
        const bool dead_c = s_dead[c];
        const int col = t0 + c;
#pragma unroll
        for (int k = 0; k < ROWS; ++k) {
          const int i = r0 + threadIdx.x + k * THREADS;
          float d2 = pair_d2(x[k], y[k], p);
          d2 = (dead_c || col == i) ? inf : d2;
          m[k] = min_nan(m[k], d2);
          cnt[k] += d2 <= r2;
        }
      }
    }
    __syncthreads();
  }
  const size_t base = (size_t)blockIdx.y * n;
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int i = r0 + threadIdx.x + k * THREADS;
    if (i < n) {
      part_min[base + i] = m[k] != m[k] ? 0 : __float_as_int(m[k]);
      part_cnt[base + i] = cnt[k];
    }
  }
}

__global__ void __launch_bounds__(FINISH_THREADS)
    v2v_finish_kernel(const int* __restrict__ part_min,
                      const int* __restrict__ part_cnt, int n, int splits,
                      int* __restrict__ cm, int* __restrict__ count) {
  const int i = blockIdx.x * FINISH_THREADS + threadIdx.x;
  if (i >= n) return;
  int key = 0x7f800000;
  int total = 0;
  for (int s = 0; s < splits; ++s) {
    key = min(key, part_min[(size_t)s * n + i]);
    total += part_cnt[(size_t)s * n + i];
  }
  const float d2 = __int_as_float(key);
  cm[i] = key < 0x7f800000 ? (int)__fmul_rn(__fsqrt_rn(d2), 100.f) : 0;
  count[i] = total;
}

}  // namespace

// xy [n, 2] float32 and alive [n] bool (one byte each) on the card;
// part [2, splits, n] int32 scratch; cm and count [n] int32. The columns
// go in splits of cols_per_split (a multiple of TILE), splits of them
// covering n. Launches the pair kernel and its finishing kernel on
// `stream`; returns the first CUDA error, 0 if none.
extern "C" int v2v_launch(const void* xy, const void* alive, int n, float r2,
                          int cols_per_split, int splits, int* part, int* cm,
                          int* count, void* stream) {
  if (n < 1 || cols_per_split < TILE || cols_per_split % TILE != 0 ||
      splits < 1 || (long long)splits * cols_per_split < n ||
      (long long)(splits - 1) * cols_per_split >= n ||
      ((uintptr_t)xy & 7) != 0)
    return (int)cudaErrorInvalidValue;
  const int row_blocks = (n + BLOCK_ROWS - 1) / BLOCK_ROWS;
  int* part_min = part;
  int* part_cnt = part + (size_t)splits * n;
  v2v_pairs_kernel<<<dim3(row_blocks, splits), THREADS, 0,
                     (cudaStream_t)stream>>>(
      (const float2*)xy, (const uint8_t*)alive, n, r2, cols_per_split,
      part_min, part_cnt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  v2v_finish_kernel<<<(n + FINISH_THREADS - 1) / FINISH_THREADS,
                      FINISH_THREADS, 0, (cudaStream_t)stream>>>(
      part_min, part_cnt, n, splits, cm, count);
  return (int)cudaGetLastError();
}
