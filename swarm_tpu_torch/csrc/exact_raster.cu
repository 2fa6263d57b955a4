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
// Scheduling: csrc/free_raster.cu's owner-computes tiles. One block owns
// one 64 x 128 grid tile and applies the agents whose window meets it in
// index order, clipping after each, as the TPU kernel's sequential grid
// does. The wrapper lists every (agent, tile) pair, sorted by (tile,
// agent); the block updates its tile's cells in place in the grid, with a
// barrier between agents, and holds no copy of the tile in registers or
// shared memory. Each pair's operands (the agent's [B, 2] table, its origin
// and meta) are copied into shared memory with cp.async one pair ahead
// (double-buffered), so they arrive while the block evaluates the previous
// pair; the lookup is an index (the TPU kernel's loop over every beam is a
// Mosaic workaround for a gather).
//
// The evaluation box. A cell takes evidence only where `near` holds, so
// the block evaluates only the cells of the box raster_common.cuh
// `evaluation_box` gives for the agent's meta reach R (its longest range,
// unquantized float32 cells) and this kernel's fan: n_bins = n_beams, gdt
// = dt, half_dt = half_gdt = dt / 2, theta0 and the wrap. Why the box holds
// every cell that can take evidence (csrc/free_raster.cu's note has the
// window kernel's argument; what differs here):
//  (a) `near` needs r <= R + 1 on the computed r = sqrtf(dx^2 + dy^2),
//      which is the centre's distance d within a few ulp, so d < R + 1 +
//      1e-5 <= rho + 1e-5 with rho = R + BOX_RADIUS. There are no pack8 or
//      pack16 ranges: R is the very float the kernel adds 1 to;
//  (b) `near` needs the fan test: b = rint(rel * inv_dt) in [0, n_beams),
//      for rel the bearing from the first beam after the floor-mod wrap of
//      rel + pi to [-pi, pi) and inv_dt = float32(1 / dt), i.e. rel in
//      [-dt / 2, (n_beams - 1 / 2) dt] up to the product's rounding (a tie
//      at -1/2 rounds to bin 0 and is in the fan; the bounds are closed,
//      not half-open as the window kernel's floorf(.. + 0.5) test is). rel
//      is the centre's direction less yaw + theta0, mod 2 pi, within the
//      polynomial's 2e-5 rad, the float32 sums' loss (below 1e-4 rad while
//      |yaw| <= 64) and the wrap's (fmodf is exact; float32(2 pi) is 2 pi
//      within 2e-7); the box's arc [lo, lo + n_beams dt] with lo = yaw +
//      theta0 - dt / 2, taken ARC_SLACK = 0.01 rad wider on each side, holds
//      both closed ends with room to spare;
//  (c) the on-beam test |r sin(rel - b dt)| <= 0.6 only narrows `near`
//      further, so the box ignores it;
//  (d) there are no fan-bbox strips;
//  (e) the wrapped fan, an arc of 2 pi or more and |yaw| > SECTOR_YAW_MAX
//      take the whole disc.
// So the centre lies in the sector of radius rho + 1e-5 over the widened
// arc, and the box, the sector's bounding box with its apex widened by
// BOX_MARGIN = 1 cell, holds every such cell (a NaN bound leaves the whole
// window in; tests/test_torch_raster_box.py proves it on the CPU against
// the plain version). A cell outside the box gets a delta of +0.0 (0 *
// act) from the plain version too.
//
// The clean tile (csrc/free_raster.cu's rule): adding +0.0 or -0.0 and
// clipping is the identity on a value in [-clamp, clamp] that is not -0.0
// (nor NaN). The block scans its tile once (16-byte loads, so the grid must
// be 16-byte aligned) and tests every value it writes (__syncthreads_and at
// each pair's start). While the whole tile is clean, only box cells are
// visited, and a pair whose agent is inactive (act == 0: a delta of +-0.0
// everywhere) is skipped whole. On any other tile every window cell of each
// agent takes its clip, and the box cells are evaluated, inactive agents'
// too (their -0.0 deltas matter on a -0.0 cell).
//
// The per-cell chain: the tests that need no sine come first (r, the fan,
// HIT or FREE against the beam's range), and the cell leaves with a +0.0
// delta as soon as one fails, which the plain version's delta also is; the
// sine is taken only where the on-beam test decides. The floor-mod's fmodf
// (a software loop) is skipped where |x| < 4 pi and |x| != 2 pi: then it
// returns x, or x -+ 2 pi, which is exact by Sterbenz's lemma.
//
// What bounds it: the covered cells read once and the changed cells
// written once (bytes; ~0.02 ms at 1024 agents on 4096^2 at an H100's
// 3.35 TB/s) against ~90 float operations a changed cell; every evaluated
// cell costs a long dependent chain (IEEE sqrt and division, the atan2
// polynomial, the sine) and every pair a chain of dependent loads and a
// barrier. Blocks of 128 threads at most 64 registers (__launch_bounds__)
// and 16 KB of shared memory fit 8 or more to an SM, 32 warps or more, so
// that many blocks' barriers and load chains overlap.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
//        -std=c++17 -shared -Xcompiler -fPIC (see ops/cuda_build.py).
// --fmad=false, IEEE sqrtf and division, and sinf (libdevice's, as
// torch.sin on the card) keep it bit-equal to the plain version.

#include "raster_common.cuh"

namespace {

using raster::Fan;

constexpr int TILE_R = 64;
constexpr int TILE_C = 128;
constexpr int THREADS = 128;
constexpr int MIN_BLOCKS = 8;            // resident blocks per SM (registers)
constexpr int MAX_BEAMS = 1024;
constexpr int META = 5;                  // ax, ay, yaw, act, max_reach
constexpr float NEAR_R = 0x1.0624dep-10f;                  // 1e-3

struct Params {
  int size;          // grid is [size, size], size % 128 == 0
  int n_tile_cols;   // size / TILE_C
  int rows, cols;    // agent window
  Fan f;             // n_bins: the beams; gdt = dt
};

// One pair's operands in shared memory: the agent's table, its origin
// (row0, col0) and its meta.
struct PairData {
  float2 table[MAX_BEAMS];   // (range in cells, trusted 0 / 1) per beam
  int origin[2];
  float meta[META];
};

// Start the copy of agent a's operands into `d` (every thread its share:
// one 8-byte beam entry each, neighbouring threads on neighbouring beams).
__device__ __forceinline__ void fetch_pair(PairData& d, int a,
                                           const int* __restrict__ origins,
                                           const float* __restrict__ meta,
                                           const float2* __restrict__ table,
                                           int n_beams) {
  for (int b = threadIdx.x; b < n_beams; b += THREADS)
    raster::copy_async<8>(&d.table[b], table + (size_t)a * n_beams + b);
  if (threadIdx.x < 2)
    raster::copy_async(&d.origin[threadIdx.x], origins + 2 * a + threadIdx.x);
  else if (threadIdx.x < 2 + META)
    raster::copy_async(&d.meta[threadIdx.x - 2],
                       meta + META * a + threadIdx.x - 2);
  raster::copy_commit();
}

// fmodf(x, TWO_PI), bit for bit: x where |x| < 2 pi, x -+ 2 pi (exact:
// Sterbenz) where 2 pi < |x| < 4 pi, else fmodf itself (its zero's sign at
// |x| == 2 pi, NaN, the rest).
__device__ __forceinline__ float fmod_two_pi(float x) {
  const float ax = fabsf(x);
  if (ax < raster::TWO_PI) return x;
  if (ax < 2.f * raster::TWO_PI && ax != raster::TWO_PI)
    return x - copysignf(raster::TWO_PI, x);
  return fmodf(x, raster::TWO_PI);
}

// The evidence of the cell centred at (cx, cy) before `act`: the hit or
// miss log-odds, or +0.0 where the cell takes none. The reference kernel's
// steps 1-6, operation for operation; a test that fails returns
// +0.0 at once (the plain version's delta there is 0 * act = +0.0 too).
__device__ __forceinline__ float evidence(float cx, float cy, float ax,
                                          float ay, float yaw, float reach1,
                                          const float2* tab, const Fan& f) {
  // 1. polar coordinates of the cell centre (IEEE sqrt)
  const float dx = cx - ax;
  const float dy = cy - ay;
  const float r = sqrtf(dx * dx + dy * dy);
  if (!(r > NEAR_R && r <= reach1)) return 0.f;
  const float theta = raster::atan2_poly(dy, dx);
  // 2. bearing relative to the first beam, floor-mod wrapped to [-pi, pi):
  // an exact fmod, then one add where its sign is negative
  float rel = theta - yaw;
  rel = rel - f.theta0;
  float m2 = fmod_two_pi(rel + raster::PI_F);
  if (m2 < 0.f) m2 = m2 + raster::TWO_PI;
  rel = m2 - raster::PI_F;
  // 3. nearest beam, rounded half to even; wrapped (floor-mod: C's %
  // truncates) or, outside the fan, no evidence
  int b = (int)rintf(rel * f.inv_dt);
  if (f.wrap) {
    b = b % f.n_bins;
    if (b < 0) b += f.n_bins;
  } else if (b < 0 || b >= f.n_bins) {
    return 0.f;
  }
  // 4. the beam's range and trust
  const float2 e = tab[b];
  // 6. HIT (a trusted beam's ring) over FREE (short of the range)
  const bool freec = r < e.x - 0.5f;
  const bool occ = (e.y > 0.5f) && (fabsf(r - e.x) <= raster::RING);
  if (!(freec || occ)) return 0.f;
  // 5. on the beam
  const float resid = rel - (float)b * f.dt;
  if (!(fabsf(r * sinf(resid)) <= raster::ON_BEAM)) return 0.f;
  return occ ? f.hit : f.miss;
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
exact_raster_kernel(float* __restrict__ grid,
                    const int* __restrict__ origins,   // [N, 2]
                    const float* __restrict__ meta,    // [N, META]
                    const float2* __restrict__ table,  // [N, n_beams]
                    const int* __restrict__ tile_start,
                    const int* __restrict__ pair_agent, const Params p) {
  const int tile = blockIdx.x;
  const int p0 = tile_start[tile];
  const int p1 = tile_start[tile + 1];
  if (p0 == p1) return;

  __shared__ PairData s_pair[2];         // the current and the next pair

  const int gr0 = (tile / p.n_tile_cols) * TILE_R;
  const int gc0 = (tile % p.n_tile_cols) * TILE_C;
  const float clampv = p.f.clampv;

  // the first pair's operands on their way while the block scans its tile
  fetch_pair(s_pair[0], pair_agent[p0], origins, meta, table, p.f.n_bins);
  int a_next = p0 + 1 < p1 ? pair_agent[p0 + 1] : 0;
  bool mine_clean = raster::scan_clean<float, TILE_C, THREADS>(
      grid, gr0, gc0, TILE_R, p.size, clampv);

  bool tile_clean = true;
  for (int q = p0; q < p1; ++q) {
    const PairData& d = s_pair[(q - p0) & 1];
    raster::copy_wait();
    // this pair's operands have arrived; done with the previous pair's
    // cells and operands
    tile_clean = __syncthreads_and(tile_clean && mine_clean) != 0;
    // the next pair's operands, and the index of the one after it
    if (q + 1 < p1) {
      fetch_pair(s_pair[(q + 1 - p0) & 1], a_next, origins, meta, table,
                 p.f.n_bins);
      a_next = q + 2 < p1 ? pair_agent[q + 2] : 0;
    }
    const float act = d.meta[3];
    if (tile_clean && act == 0.f) continue;   // +-0.0 on clean values

    const int row0 = d.origin[0];
    const int col0 = d.origin[1];
    const float ax = d.meta[0];
    const float ay = d.meta[1];
    const float yaw = d.meta[2];
    const float reach = d.meta[4];
    const float reach1 = reach + 1.0f;

    // tile-local bounds [lo, hi): the window, and the evaluated cells:
    // window ∩ box
    const int wr_lo = max(row0 - gr0, 0);
    const int wr_hi = min(row0 + p.rows - gr0, TILE_R);
    const int wc_lo = max(col0 - gc0, 0);
    const int wc_hi = min(col0 + p.cols - gc0, TILE_C);
    const raster::Box box = raster::evaluation_box(ax, ay, yaw, reach, p.f);
    const int2 er = raster::clamp_range(box.y_lo, box.y_hi, gr0, wr_lo,
                                        wr_hi);
    const int2 ec = raster::clamp_range(box.x_lo, box.x_hi, gc0, wc_lo,
                                        wc_hi);
    // visited: the evaluated cells on a clean tile, else the whole window
    const int vr_lo = tile_clean ? er.x : wr_lo;
    const int vc_lo = tile_clean ? ec.x : wc_lo;
    const int v_h = max((tile_clean ? er.y : wr_hi) - vr_lo, 0);
    const int v_w = max((tile_clean ? ec.y : wc_hi) - vc_lo, 0);

    // this thread's cells: i = threadIdx.x + THREADS k of the compact
    // index, walked as (row, column) steps with one carry, no division
    int lr = vr_lo, lc = vc_lo, step_r = 0, step_c = 0;
    if (v_w > 0) {
      lr += threadIdx.x / v_w;
      lc += threadIdx.x % v_w;
      step_r = THREADS / v_w;
      step_c = THREADS % v_w;
    }
    for (int i = threadIdx.x; i < v_h * v_w; i += THREADS) {
      float* cell = grid + (size_t)(gr0 + lr) * p.size + gc0 + lc;
      const float old = *cell;
      float delta = 0.f;
      if (lr >= er.x && lr < er.y && lc >= ec.x && lc < ec.y)
        delta = evidence((float)(gc0 + lc) + 0.5f, (float)(gr0 + lr) + 0.5f,
                         ax, ay, yaw, reach1, d.table, p.f) * act;
      // 7. apply, clipped after this agent
      const float v = raster::clip(old + delta, clampv);
      *cell = v;
      mine_clean = mine_clean && raster::clean(v, clampv);
      lr += step_r;
      lc += step_c;
      if (lc >= vc_lo + v_w) {
        lc -= v_w;
        ++lr;
      }
    }
  }
}

__global__ void sin_kernel(const float* __restrict__ x, float* __restrict__ y,
                           int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = sinf(x[i]);
}

}  // namespace

// wrap: 1 for the wrapped 4-way fan. A table or grid the kernel does not
// take (a grid not 16-byte aligned among them) returns
// cudaErrorInvalidValue without a launch.
extern "C" int exact_raster_launch(
    float* grid, const int* origins, const float* meta, const float* table,
    const int* tile_start, const int* pair_agent, int n_tiles, int size,
    int rows, int cols, int n_beams, int wrap, int table_beams, float theta0,
    float dt, float inv_dt, float miss, float hit, float clampv,
    void* stream) {
  if (size % TILE_C != 0 || n_beams < 1 || n_beams > MAX_BEAMS ||
      table_beams != n_beams || (wrap != 0 && wrap != 1) ||
      ((uintptr_t)grid & 15) != 0 || ((uintptr_t)table & 7) != 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.size = size;
  p.n_tile_cols = size / TILE_C;
  p.rows = rows;
  p.cols = cols;
  // the evaluation box's fan: one bin per beam
  p.f = Fan{n_beams, 0, theta0, 0.5f * dt, 0.5f * dt, dt, dt,
            0.f, 0.f, 0.f, miss, hit, clampv, wrap};
  p.f.inv_gdt = inv_dt;
  p.f.inv_dt = inv_dt;
  if (n_tiles > 0)
    exact_raster_kernel<<<n_tiles, THREADS, 0, (cudaStream_t)stream>>>(
        grid, origins, meta, reinterpret_cast<const float2*>(table),
        tile_start, pair_agent, p);
  return (int)cudaGetLastError();
}

// Resident blocks per SM of the kernel, from the occupancy calculator,
// into *blocks; returns the CUDA error code.
extern "C" int exact_raster_blocks_per_sm(int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, exact_raster_kernel, THREADS, 0);
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
