// Room-tile beam raster, for Hopper.
//
// Replaces swarm_tpu/ops/beam_raster_pallas.py::_room_kernel (entry point
// room_raster_pallas) on a float32 grid, in its per-beam forms (n_groups
// == n_beams: the pack16 table) and its grouped forms (n_groups < n_beams,
// bench.py --beam-groups: per group of ceil(n_beams / n_groups) beams the
// carve, the trusted fraction and the tail range as three floats, the
// table room_raster_pallas scatters, :820-830). Two template parameters
// give its four instances: GROUPED (the table) and RING (the trusted
// endpoint ring, `trusted` given; without it the endpoints go to the exact
// scatter). The grouped instances also paint the weak tail (free evidence
// at tail_w between the carve and the tail range; a runtime weight, 0
// turns it off). Every instance serves the 181-beam scan and the wrapped
// 4-way fan (the wrap is a runtime field of raster_common.cuh `Fan`). The
// world is tiled rooms: agents
// 2k and 2k+1 live in room k, which is one [128, 256] grid tile, and only
// they paint it. Each agent paints a win_rows x 256 window of its own tile
// (win_rows = 64 at the 1.2 m reach) starting at tile-local row r_loc;
// evidence outside the tile is dropped, as on the TPU. The per-cell math is
// _room_kernel's, operation for operation: raster_common.cuh `polar` for
// the beam (group) bin, the crossing count and the support, then the table
// lookup (pack16: 1/256-cell range, 15 bits and the trusted bit 15 with the
// ring, all 16 bits without it; grouped: the group's three floats), the
// free carve, the tail (grouped) and, with the ring, the ring. Slot 0
// is applied before slot 1 and the cell is clipped to [-clamp, clamp] after
// each, as the TPU kernel's sequential slot loop does. Every slot of a tile
// is applied, an empty one too (meta all zero: act 0, r_loc 0), so the
// clips match the TPU kernel's everywhere.
//
// Scheduling: one block per tile, 512 threads, so the two slots' updates
// and clips happen in slot order with no atomics: slot 0's pass over the
// grid, a barrier, slot 1's pass (a barrier makes the block's global writes
// visible to the whole block). Each slot evaluates only the cells of its
// evaluation box (raster_common.cuh `evaluation_box`; csrc/free_raster.cu
// has the argument): R, the largest range the slot's own table holds
// (pack16: 15 bits with the ring, 16 without; grouped: the carve and the
// tail of every group, padding included), is a block reduction taken while
// the tables are copied into shared memory, and no cell outside the
// bounding box of the fan's sector of radius R + 1, widened by a cell, can
// take evidence. The box is intersected with the slot's window; the block's
// threads share it through a compact index, so the work follows the box and
// not the 64 x 256 window. Every other cell of the window still takes the
// slot's clip with a +0.0 delta (`v + 0 * act`, clipped): a cheap pass, one
// 16-byte load per four cells, that writes a cell only where the clip
// changes its bits (a value beyond +-clamp, a -0.0; a NaN stays NaN), so
// on a clean grid it reads the window and writes nothing. Rows in neither
// window are not touched. The slots' range tables sit in shared memory
// and the lookup is an index (the TPU's select tree,
// _hexadecet_gather_packed, and its loop over groups are Mosaic
// workarounds). The tile's painted count is a block reduction in
// double, exact under csrc/free_raster.cu's conditions (nonzero terms of
// at least 2^-8, a total below 2^22), so it equals the plain version's in
// any order, rounded to float once.
//
// What bounds it: at 1024 agents (512 tiles) the windows cover 1024 x 64 x
// 256 cells, read and written once: 134 MB, about 40 us at 3.35 TB/s. The
// evaluated cells (~28-45 x 52 a slot at the 26-cell reach on the scan, a
// long dependent chain each) are issue- and latency-bound; at 64 registers a
// thread (__launch_bounds__) two 512-thread blocks, 32 warps, fit an SM.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
//        -std=c++17 -shared -Xcompiler -fPIC (see ops/cuda_build.py)

#include "raster_common.cuh"

namespace {

using raster::Fan;
using raster::Polar;

constexpr int TILE_ROWS = 128;
constexpr int TILE_COLS = 256;
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int MIN_BLOCKS = 2;                              // per SM
constexpr int SLOTS = 2;                                   // agents per room
constexpr int META = 8;                                    // floats per slot
constexpr int MAX_WORDS = 128;                             // <= 256 beams
constexpr int MAX_GROUPS = 512;                            // padded groups
constexpr int TABLE_WORDS = 3 * MAX_GROUPS;                // >= MAX_WORDS
constexpr float QUANT16_INV = 0x1p-8f;                     // 1 / 256

struct Params {
  int size;          // grid is [size, size]
  int n_tile_cols;   // size / TILE_COLS
  int win_rows;      // rows of an agent's window, <= TILE_ROWS
  int tab_words;     // table words per slot: pack16 words (padded), or
                     // 3 per group (padded groups)
  float tail_w;      // grouped: the tail's weight (0: no tail)
  float miss_tail;   // float32(miss * tail_w), as the reference's constant
  Fan f;
};

template <bool GROUPED, bool RING>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
room_raster_kernel(float* __restrict__ grid,
                   const float* __restrict__ meta,    // [tiles, 2, 8]
                   const int* __restrict__ table,     // [tiles, 2, tab_words]
                   float* __restrict__ counts,        // [tiles]
                   const Params p) {
  const int tile = blockIdx.x;
  const int br = tile / p.n_tile_cols;
  const int bc = tile % p.n_tile_cols;
  const int gr0 = br * TILE_ROWS;
  const int gc0 = bc * TILE_COLS;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  __shared__ uint32_t s_tab[SLOTS][TABLE_WORDS];
  __shared__ float s_reach[SLOTS][WARPS];
  __shared__ double s_red[SLOTS][WARPS];

  // the slots' tables, and each slot's R
  constexpr int KIND = GROUPED ? raster::GROUPED : raster::PACK16;
  const int* tab = table + (size_t)tile * SLOTS * p.tab_words;
  float reach[SLOTS];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    reach[s] = 0.f;
    for (int w = threadIdx.x; w < p.tab_words; w += THREADS) {
      const uint32_t x = (uint32_t)tab[s * p.tab_words + w];
      s_tab[s][w] = x;
      reach[s] = fmaxf(reach[s], raster::word_reach<KIND, RING>(x, w));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      reach[s] = fmaxf(reach[s],
                       __shfl_xor_sync(0xffffffffu, reach[s], off));
    if (lane == 0) s_reach[s][warp] = reach[s];
  }
  __syncthreads();

  const float clampv = p.f.clampv;
  double painted[SLOTS] = {0.0, 0.0};
  float act[SLOTS];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const float* m = meta + ((size_t)tile * SLOTS + s) * META;
    const float ax = m[0];
    const float ay = m[1];
    const float yaw = m[2];
    act[s] = m[3];
    const int r0 = (int)m[4];
    float rs = reach[s];
#pragma unroll
    for (int w = 0; w < WARPS; ++w) rs = fmaxf(rs, s_reach[s][w]);
    // slot s - 1's cells are written: the next slot reads them
    if (s > 0) __syncthreads();

    // tile-local box ∩ window [lo, hi)
    const raster::Box box = raster::evaluation_box(ax, ay, yaw, rs, p.f);
    const int2 er = raster::clamp_range(box.y_lo, box.y_hi, gr0, r0,
                                        r0 + p.win_rows);
    const int2 ec = raster::clamp_range(box.x_lo, box.x_hi, gc0, 0,
                                        TILE_COLS);
    const int e_h = er.y - er.x;
    const int e_w = ec.y - ec.x;

    // the window's other cells: the clip with a +0.0 delta, written only
    // where it changes the bits (one 16-byte load per four cells)
    for (int i = threadIdx.x; i < p.win_rows * (TILE_COLS / 4);
         i += THREADS) {
      const int lr = r0 + i / (TILE_COLS / 4);
      const int lc = 4 * (i % (TILE_COLS / 4));
      float* cell = grid + (size_t)(gr0 + lr) * p.size + gc0 + lc;
      const float4 q = *reinterpret_cast<const float4*>(cell);
      const float v4[4] = {q.x, q.y, q.z, q.w};
      const bool row_in = lr >= er.x && lr < er.y;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (row_in && lc + j >= ec.x && lc + j < ec.y) continue;
        const float v = raster::clip(v4[j] + 0.f * act[s], clampv);
        if (__float_as_uint(v) != __float_as_uint(v4[j])) cell[j] = v;
      }
    }
    // the box's cells are read only after the cheap pass has read them
    __syncthreads();

    // this thread's box cells: the compact index walked as (row, column)
    // steps with one carry, no division
    int lr = er.x, lc = ec.x, step_r = 0, step_c = 0;
    if (e_w > 0) {
      lr += threadIdx.x / e_w;
      lc += threadIdx.x % e_w;
      step_r = THREADS / e_w;
      step_c = THREADS % e_w;
    }
    for (int i = threadIdx.x; i < e_h * e_w; i += THREADS) {
      const float cx = (float)(gc0 + lc) + 0.5f;
      const float cy = (float)(gr0 + lr) + 0.5f;
      const Polar c = raster::polar(cx - ax, cy - ay, yaw, p.f);
      float rb, tf = 0.f, rt = 0.f;
      if (GROUPED) {
        // words 3g, 3g + 1, 3g + 2 (the fraction is 0 without the ring)
        rb = __uint_as_float(s_tab[s][3 * c.g]);
        tf = __uint_as_float(s_tab[s][3 * c.g + 1]);
        rt = __uint_as_float(s_tab[s][3 * c.g + 2]);
      } else {
        // pack16 lookup: word g >> 1, half g & 1
        const uint32_t v16 =
            (s_tab[s][c.g >> 1] >> (16 * (c.g & 1))) & 0xFFFFu;
        rb = (float)(RING ? (v16 & 0x7FFFu) : v16) * QUANT16_INV;
        if (RING) tf = (float)(v16 >> 15);   // trusted bit
      }
      const bool freec = c.base_ok && (c.r < rb - 0.5f);
      float delta = freec ? p.f.miss * c.cnt : 0.f;
      float pc = freec ? c.cnt : 0.f;
      if (GROUPED && p.tail_w > 0.f) {
        // the weak tail between the carve and the tail range
        const bool tail = c.base_ok && !freec && (c.r < rt - 0.5f);
        delta = delta + (tail ? p.miss_tail * c.cnt : 0.f);
        pc = pc + (tail ? p.tail_w * c.cnt : 0.f);
      }
      if (RING) {
        const bool on_ring =
            c.base_ok && (fabsf(c.r - rb) <= raster::RING);
        delta = delta + (on_ring ? p.f.hit * c.cnt * tf : 0.f);
        pc = pc + (on_ring ? c.cnt * tf : 0.f);
      }
      painted[s] += pc;
      // apply, clipped after this slot
      float* cell = grid + (size_t)(gr0 + lr) * p.size + gc0 + lc;
      *cell = raster::clip(*cell + delta * act[s], clampv);
      lr += step_r;
      lc += step_c;
      if (lc >= ec.y) {
        lc -= e_w;
        ++lr;
      }
    }
  }

  // the tile's painted count, exact in double
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      painted[s] += __shfl_down_sync(0xffffffffu, painted[s], off);
    if (lane == 0) s_red[s][warp] = painted[s];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double total = 0.0;
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      double sum = 0.0;
      for (int w = 0; w < WARPS; ++w) sum += s_red[s][w];
      total = total + sum * (double)act[s];
    }
    counts[tile] = (float)total;
  }
}

const void* instance(int grouped, int ring) {
  return grouped ? (ring ? (const void*)room_raster_kernel<true, true>
                         : (const void*)room_raster_kernel<true, false>)
                 : (ring ? (const void*)room_raster_kernel<false, true>
                         : (const void*)room_raster_kernel<false, false>);
}

}  // namespace

// grouped: 1 for the grouped table; ring: 1 with the endpoint ring; wrap: 1
// for the wrapped 4-way fan; n_bins: beams, or groups. A table or grid the
// kernel does not take (the clip pass reads the grid in 16-byte vectors, so
// a grid not 16-byte aligned too) returns cudaErrorInvalidValue without a
// launch.
extern "C" int room_raster_launch(
    float* grid, const float* meta, const int* table, float* counts,
    int size, int win_rows, int tab_words, int grouped, int ring, int n_bins,
    int dense, int wrap, float theta0, float half_gdt, float half_dt,
    float gdt, float dt, float fan_lo, float fan_hi, float cover, float miss,
    float hit, float clampv, float tail_w, float miss_tail, void* stream) {
  if (size % TILE_COLS != 0 || size % TILE_ROWS != 0 ||
      ((uintptr_t)grid & 15) != 0 || tab_words < 1 ||
      win_rows < 1 || win_rows > TILE_ROWS || n_bins < 1 ||
      (grouped != 0 && grouped != 1) || (ring != 0 && ring != 1) ||
      (grouped ? (tab_words % 3 != 0 || tab_words > TABLE_WORDS ||
                  3 * n_bins > tab_words)
               : (tab_words > MAX_WORDS || 2 * tab_words < n_bins)))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.size = size;
  p.n_tile_cols = size / TILE_COLS;
  p.win_rows = win_rows;
  p.tab_words = tab_words;
  p.tail_w = grouped ? tail_w : 0.f;
  p.miss_tail = miss_tail;
  p.f = Fan{n_bins, dense, theta0, half_gdt, half_dt, gdt, dt,
            fan_lo, fan_hi, cover, miss, hit, clampv, wrap};
  raster::fan_reciprocals(p.f);
  const int n_tiles = (size / TILE_ROWS) * p.n_tile_cols;
  if (n_tiles > 0) {
    void* args[] = {&grid, (void*)&meta, (void*)&table, &counts, &p};
    const cudaError_t err =
        cudaLaunchKernel(instance(grouped, ring), dim3(n_tiles),
                         dim3(THREADS), args, 0, (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// Resident blocks per SM of the (grouped, ring) instance, from the
// occupancy calculator, into *blocks; returns the CUDA error code.
extern "C" int room_raster_blocks_per_sm(int grouped, int ring,
                                         int* blocks) {
  if ((grouped != 0 && grouped != 1) || (ring != 0 && ring != 1))
    return (int)cudaErrorInvalidValue;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, instance(grouped, ring), THREADS, 0);
}
