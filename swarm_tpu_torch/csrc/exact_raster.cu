// The r1 exact per-beam raster over per-agent windows, for Hopper.
//
// Replaces swarm_tpu/ops/beam_raster_pallas.py::_kernel (entry point
// beam_raster_pallas, :900-959): per agent, over its aligned [64, 256]
// window, every cell takes the evidence of its nearest beam. The math is
// the reference kernel's, operation for operation (see the numbered steps
// below); ops/exact_raster_cuda.py holds the same function in plain torch
// (beam_raster_plain) and the wrapper that prepares this launch. The fan
// (the scan's, or the wrapped 4-way fan) is a runtime field. The ranges are
// unquantized float32 cells with a trusted flag, [B, 2] per agent; the grid
// is float32.
//
// Scheduling: csrc/free_raster.cu's owner-computes tiles. One block owns one
// 64 x 128 grid tile held in float registers and applies the agents whose
// window meets it in index order, clipping after each, as the TPU kernel's
// sequential grid does; the grid is read and written once per launch. The
// agent's table sits in shared memory and the lookup is an index (the TPU
// kernel's loop over every beam is a Mosaic workaround for a gather).
//
// What bounds it: the windows' cells read and written once (bytes) against
// ~90 float operations a cell; at 1024 agents on a 4096^2 grid the bytes
// bound it.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
//        -std=c++17 -shared -Xcompiler -fPIC (see ops/cuda_build.py).
// --fmad=false, IEEE sqrtf and division, and sinf (libdevice's, as
// torch.sin on the card) keep it bit-equal to the plain version.

#include "raster_common.cuh"

namespace {

constexpr int TILE_R = 64;
constexpr int TILE_C = 128;
constexpr int THREADS = 256;
constexpr int ROWS_PER_PASS = THREADS / TILE_C;            // 2
constexpr int CELLS = TILE_R * TILE_C / THREADS;           // 32 per thread
constexpr int MAX_BEAMS = 1024;
constexpr int META = 5;                  // ax, ay, yaw, act, max_reach
constexpr float NEAR_R = 0x1.0624dep-10f;                  // 1e-3

struct Params {
  int size;          // grid is [size, size], size % 128 == 0
  int n_tile_cols;   // size / TILE_C
  int rows, cols;    // agent window
  int n_beams;
  int wrap;          // the 4-way fan: every direction, floor-mod bin
  float theta0, dt, inv_dt;
  float miss, hit, clampv;
};

__global__ void __launch_bounds__(THREADS)
exact_raster_kernel(float* __restrict__ grid,
                    const int* __restrict__ origins,   // [N, 2]
                    const float* __restrict__ meta,    // [N, META]
                    const float* __restrict__ table,   // [N, n_beams, 2]
                    const int* __restrict__ tile_start,
                    const int* __restrict__ pair_agent, const Params p) {
  const int tile = blockIdx.x;
  const int p0 = tile_start[tile];
  const int p1 = tile_start[tile + 1];
  if (p0 == p1) return;

  __shared__ float s_rb[MAX_BEAMS];
  __shared__ float s_tb[MAX_BEAMS];

  const int gr0 = (tile / p.n_tile_cols) * TILE_R;
  const int gc = (tile % p.n_tile_cols) * TILE_C + (threadIdx.x % TILE_C);
  const int r_first = threadIdx.x / TILE_C;
  const float cx = (float)gc + 0.5f;

  float v[CELLS];
#pragma unroll
  for (int k = 0; k < CELLS; ++k) {
    const int gr = gr0 + r_first + ROWS_PER_PASS * k;
    v[k] = grid[(size_t)gr * p.size + gc];
  }

  for (int q = p0; q < p1; ++q) {
    const int a = pair_agent[q];
    __syncthreads();                       // done with the previous table
    const float* tab = table + (size_t)a * p.n_beams * 2;
    for (int b = threadIdx.x; b < p.n_beams; b += THREADS) {
      s_rb[b] = tab[2 * b];
      s_tb[b] = tab[2 * b + 1];
    }
    __syncthreads();

    const int row0 = origins[2 * a + 0];
    const int col0 = origins[2 * a + 1];
    const float* m = meta + (size_t)a * META;
    const float ax = m[0], ay = m[1], yaw = m[2], act = m[3];
    const float reach1 = m[4] + 1.0f;
    const int wc = gc - col0;
    if (wc < 0 || wc >= p.cols) continue;
    const float dx = cx - ax;

#pragma unroll
    for (int k = 0; k < CELLS; ++k) {
      const int gr = gr0 + r_first + ROWS_PER_PASS * k;
      const int wr = gr - row0;
      if (wr < 0 || wr >= p.rows) continue;
      // 1. polar coordinates of the cell centre (IEEE sqrt)
      const float dy = ((float)gr + 0.5f) - ay;
      const float r = sqrtf(dx * dx + dy * dy);
      const float theta = raster::atan2_poly(dy, dx);
      // 2. bearing relative to the first beam, floor-mod wrapped to
      // [-pi, pi): an exact fmod, then one add where its sign is negative
      float rel = theta - yaw;
      rel = rel - p.theta0;
      float m2 = fmodf(rel + raster::PI_F, raster::TWO_PI);
      if (m2 < 0.f) m2 = m2 + raster::TWO_PI;
      rel = m2 - raster::PI_F;
      // 3. nearest beam, rounded half to even; wrapped or clipped
      int b = (int)rintf(rel * p.inv_dt);
      bool in_fan = true;
      if (p.wrap) {
        b = ((b % p.n_beams) + p.n_beams) % p.n_beams;
      } else {
        in_fan = (b >= 0) && (b < p.n_beams);
        b = min(max(b, 0), p.n_beams - 1);
      }
      // 4. the beam's range and trust
      const float rb = s_rb[b];
      const float tb = s_tb[b];
      // 5. on the beam, near enough, in the fan
      const float resid = rel - (float)b * p.dt;
      const bool on_beam = fabsf(r * sinf(resid)) <= raster::ON_BEAM;
      const bool near = (r > NEAR_R) && (r <= reach1) && in_fan && on_beam;
      // 6. HIT over FREE, times active
      const bool freec = near && (r < rb - 0.5f);
      const bool occ = near && (tb > 0.5f) && (fabsf(r - rb) <= raster::RING);
      const float delta = (occ ? p.hit : (freec ? p.miss : 0.f)) * act;
      // 7. apply, clipped after this agent
      v[k] = fminf(fmaxf(v[k] + delta, -p.clampv), p.clampv);
    }
  }

#pragma unroll
  for (int k = 0; k < CELLS; ++k) {
    const int gr = gr0 + r_first + ROWS_PER_PASS * k;
    grid[(size_t)gr * p.size + gc] = v[k];
  }
}

__global__ void sin_kernel(const float* __restrict__ x, float* __restrict__ y,
                           int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = sinf(x[i]);
}

}  // namespace

// wrap: 1 for the wrapped 4-way fan. A table or grid the kernel does not
// take returns cudaErrorInvalidValue without a launch.
extern "C" int exact_raster_launch(
    float* grid, const int* origins, const float* meta, const float* table,
    const int* tile_start, const int* pair_agent, int n_tiles, int size,
    int rows, int cols, int n_beams, int wrap, int table_beams, float theta0,
    float dt, float inv_dt, float miss, float hit, float clampv,
    void* stream) {
  if (size % TILE_C != 0 || n_beams < 1 || n_beams > MAX_BEAMS ||
      table_beams != n_beams || (wrap != 0 && wrap != 1))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.size = size;
  p.n_tile_cols = size / TILE_C;
  p.rows = rows;
  p.cols = cols;
  p.n_beams = n_beams;
  p.wrap = wrap;
  p.theta0 = theta0;
  p.dt = dt;
  p.inv_dt = inv_dt;
  p.miss = miss;
  p.hit = hit;
  p.clampv = clampv;
  if (n_tiles > 0)
    exact_raster_kernel<<<n_tiles, THREADS, 0, (cudaStream_t)stream>>>(
        grid, origins, meta, table, tile_start, pair_agent, p);
  return (int)cudaGetLastError();
}

// y = sinf(x) elementwise: the kernel's sine, for comparing it with
// torch.sin on the card.
extern "C" int exact_raster_sin(const float* x, float* y, int n,
                                void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n > 0)
    sin_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(x, y, n);
  return (int)cudaGetLastError();
}
