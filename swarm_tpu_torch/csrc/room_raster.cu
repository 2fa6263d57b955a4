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
// Scheduling: one block per tile, each cell owned by one thread, so the two
// slots' updates and clips happen in registers in slot order with no
// atomics. A thread owns one column and every ROW_GROUPS-th row of the
// union of the two windows; rows in neither window are not touched, and the
// grid is updated in place (read once, written once per touched cell). The
// slots' range tables sit in shared memory and the lookup is an index (the
// TPU's select tree, _hexadecet_gather_packed, and its loop over groups are
// Mosaic workarounds). The tile's painted count is a block reduction in
// double, exact under csrc/free_raster.cu's conditions (nonzero terms of
// at least 2^-8, a total below 2^22), so it equals the plain version's in
// any order, rounded to float once.
//
// What bounds it: at 1024 agents (512 tiles) the windows cover 1024 x 64 x
// 256 cells, read and written once: 134 MB, about 40 us at 3.35 TB/s; the
// ~50 float operations per cell evaluation are about 13 us at 67 TFLOP/s.
// Bytes bound it.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
//        -std=c++17 -shared -Xcompiler -fPIC (see ops/cuda_build.py)

#include "raster_common.cuh"

namespace {

using raster::Fan;
using raster::Polar;

constexpr int TILE_ROWS = 128;
constexpr int TILE_COLS = 256;
constexpr int ROW_GROUPS = 2;
constexpr int THREADS = TILE_COLS * ROW_GROUPS;            // 512
constexpr int WARPS = THREADS / 32;
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
__global__ void __launch_bounds__(THREADS)
room_raster_kernel(float* __restrict__ grid,
                   const float* __restrict__ meta,    // [tiles, 2, 8]
                   const int* __restrict__ table,     // [tiles, 2, tab_words]
                   float* __restrict__ counts,        // [tiles]
                   const Params p) {
  const int tile = blockIdx.x;
  const int br = tile / p.n_tile_cols;
  const int bc = tile % p.n_tile_cols;

  __shared__ uint32_t s_tab[SLOTS][TABLE_WORDS];
  __shared__ double s_red[SLOTS][WARPS];

  const int* tab = table + (size_t)tile * SLOTS * p.tab_words;
  for (int i = threadIdx.x; i < SLOTS * p.tab_words; i += THREADS)
    s_tab[i / p.tab_words][i % p.tab_words] = (uint32_t)tab[i];

  float ax[SLOTS], ay[SLOTS], yaw[SLOTS], act[SLOTS];
  int r0[SLOTS];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const float* m = meta + ((size_t)tile * SLOTS + s) * META;
    ax[s] = m[0];
    ay[s] = m[1];
    yaw[s] = m[2];
    act[s] = m[3];
    r0[s] = (int)m[4];
  }
  __syncthreads();

  const int col = threadIdx.x % TILE_COLS;
  const int gc = bc * TILE_COLS + col;
  const float cx = (float)gc + 0.5f;
  const int lo = min(r0[0], r0[1]);
  const int hi = max(r0[0], r0[1]) + p.win_rows;

  double painted[SLOTS] = {0.0, 0.0};
  for (int r = lo + threadIdx.x / TILE_COLS; r < hi; r += ROW_GROUPS) {
    bool in[SLOTS];
#pragma unroll
    for (int s = 0; s < SLOTS; ++s)
      in[s] = (r >= r0[s]) && (r < r0[s] + p.win_rows);
    if (!in[0] && !in[1]) continue;
    const int gr = br * TILE_ROWS + r;
    float* cell = grid + (size_t)gr * p.size + gc;
    float v = *cell;
    const float cy = (float)gr + 0.5f;
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      if (!in[s]) continue;
      const Polar c = raster::polar(cx - ax[s], cy - ay[s], yaw[s], p.f);
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
      v = fminf(fmaxf(v + delta * act[s], -p.f.clampv), p.f.clampv);
    }
    *cell = v;
  }

  // the tile's painted count, exact in double
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      painted[s] += __shfl_down_sync(0xffffffffu, painted[s], off);
    if ((threadIdx.x & 31) == 0) s_red[s][threadIdx.x >> 5] = painted[s];
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

}  // namespace

// grouped: 1 for the grouped table; ring: 1 with the endpoint ring; wrap: 1
// for the wrapped 4-way fan; n_bins: beams, or groups. A table or grid the
// kernel does not take returns cudaErrorInvalidValue without a launch.
extern "C" int room_raster_launch(
    float* grid, const float* meta, const int* table, float* counts,
    int size, int win_rows, int tab_words, int grouped, int ring, int n_bins,
    int dense, int wrap, float theta0, float half_gdt, float half_dt,
    float gdt, float dt, float fan_lo, float fan_hi, float cover, float miss,
    float hit, float clampv, float tail_w, float miss_tail, void* stream) {
  if (size % TILE_COLS != 0 || size % TILE_ROWS != 0 || tab_words < 1 ||
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
    auto kernel = grouped ? (ring ? room_raster_kernel<true, true>
                                  : room_raster_kernel<true, false>)
                          : (ring ? room_raster_kernel<false, true>
                                  : room_raster_kernel<false, false>);
    kernel<<<n_tiles, THREADS, 0, (cudaStream_t)stream>>>(grid, meta, table,
                                                          counts, p);
  }
  return (int)cudaGetLastError();
}
