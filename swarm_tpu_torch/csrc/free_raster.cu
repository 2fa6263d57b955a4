// Beam-model free-space raster over per-agent windows, for Hopper.
//
// Replaces swarm_tpu/ops/beam_raster_pallas.py::_free_kernel in every form:
// per-beam (n_groups == n_beams) and grouped (n_groups < n_beams, bench.py
// --beam-groups), on the whole grid or on a band or tile window of it. Three
// template parameters give its twelve instances:
//   TABLE  the range table: pack8 (7-bit 1/4-cell ranges + trusted bit 7,
//          four beams per int32 word; `pack8=True`), pack16 (15-bit
//          1/256-cell ranges + trusted bit 15, two beams per word), or
//          grouped (per group of ceil(n_beams / n_groups) beams three
//          floats: the carve, the trusted fraction and the tail range, as
//          free_raster_pallas builds them, :599-612);
//   RING   the in-kernel endpoint ring (`trusted` given): the table carries
//          the trusted bit (per beam) or fraction (grouped) and the ring
//          paints hits weighted by it. Without the ring every bit of a
//          packed field is range and the endpoints go to the exact scatter
//          after the kernel;
//   T      the grid's storage: float, or __nv_bfloat16 (a bf16 grid, whose
//          windows are 16-row aligned: [80, 256] at the 26-cell reach).
// Every instance serves the 181-beam scan and the wrapped 4-way fan (the
// wrap is a runtime field of raster_common.cuh `Fan`), and the grouped
// instances the weak tail (free evidence at tail_w between the carve and
// the tail range; a runtime weight, 0 turns it off; the per-beam forms
// keep it off, as the reference does). The sharded engine's grid windows are
// runtime fields too (free_raster_pallas `band` / `band_cols`): the grid is
// [n_rows, n_cols] (a row band, or a tile plus its halo ring, whose last
// tile row may be ragged: its rows past n_rows are neither read nor
// written), the agents' cells arrive window-local, meta slots 4-5 carry the
// window's global offset, and a nonzero `guard` (the global grid's size)
// drops the evidence of every cell whose global coordinates, rebuilt in
// float32 as the reference rebuilds them, fall outside the global grid
// (:440-447). The guard is a template flag of the kernel's body, picked
// once per launch, so that the whole grid and the row bands (guard 0) run
// without its per-cell test; it adds no instance to the launch table. The
// math is the reference kernel's, operation for operation (see the numbered
// steps below);
// ops/beam_raster_cuda.py holds the same function in plain torch
// (free_raster_plain) and the wrapper that prepares this launch.
//
// Scheduling: owner-computes tiles. The TPU kernel walks agents in order on
// one core, and each agent's window is clipped to [-clamp, clamp] right
// after that agent is added, so overlapping windows must be applied in
// agent index order: clip(clip(g + d1) + d2) is not clip(g + d1 + d2), and
// plain atomics would give the latter. Here one block owns one 64 x 128
// grid tile. The wrapper lists every (agent, tile) pair, sorted stably by
// (tile, agent); the block keeps its tile in float registers, walks its
// agents in index order, and writes the tile back once. On a bf16 grid the
// reference stores each agent's window as bf16 before the next agent reads
// it, so the block rounds the agent's cells to bf16 (nearest even) after
// each agent: rounding once at the end would be a different sum wherever
// windows overlap. Each pair's painted count goes to its own slot of
// `partial`, and the wrapper reduces the slots per agent: no float atomics.
// The count is summed in double: every cell's term is a float (the same
// float in the plain version), and while each nonzero term is at least
// 2^-8 (groups of at most 256 beams, a tail weight of at least 1/256: the
// engine's is 0.25) and a window's total below 2^22, 53 bits hold every
// partial sum exactly. The order of the sum then does not matter, and the
// count, rounded to float once, equals the plain version's, also where the
// grouped tier's fractions make it a half-integer that the engine rounds.
// The grid launches one block for every tile and a tile no
// agent touches returns at once: launching only the non-empty tiles would
// need their count on the host, a sync in every step. The agent's table
// sits in shared memory and the lookup is an index: the TPU kernel's select
// trees and its loop over groups are Mosaic workarounds.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
//        -std=c++17 -shared -Xcompiler -fPIC
// --fmad=false keeps every add and multiply separately rounded, as the
// plain torch version issues them, and IEEE 1/sqrtf (not rsqrtf) and
// IEEE division keep the rest bit-equal to it.

#include <cuda_bf16.h>

#include "raster_common.cuh"

namespace {

using raster::Fan;
using raster::Polar;

constexpr int TILE_R = 64;
constexpr int TILE_C = 128;
constexpr int THREADS = 256;
constexpr int ROWS_PER_PASS = THREADS / TILE_C;            // 2
constexpr int CELLS = TILE_R * TILE_C / THREADS;           // 32 per thread
constexpr int MAX_WORDS = 128;      // pack16: <= 256 beams, pack8: <= 512
constexpr int MAX_GROUPS = 512;     // grouped: 3 floats a group
constexpr int TABLE_WORDS = 3 * MAX_GROUPS;                // >= MAX_WORDS
constexpr float QUANT8_INV = 0.25f;
constexpr float QUANT16_INV = 0x1p-8f;                     // 1/256

// The range table (the TABLE template parameter).
enum Table { PACK8 = 0, PACK16 = 1, GROUPED = 2 };
// Form codes of the launch entry (beam_raster_cuda.FORMS): the table and
// the ring.
enum Form {
  Pack8Ring = 0, Pack16 = 1, Pack16Ring = 2, Pack8 = 3, GroupedRing = 4,
  Grouped = 5
};
// Storage codes (beam_raster_cuda.STORAGE).
enum Storage { F32 = 0, BF16 = 1 };

struct Params {
  int n_rows;        // grid is [n_rows, n_cols], n_cols % 128 == 0
  int n_cols;
  int n_tile_cols;   // n_cols / TILE_C
  float guard;       // global grid size of the tile windows' guard; 0: off
  int rows, cols;    // agent window
  int n_words;       // table words per agent (grouped: 3 per group)
  float tail_w;      // grouped: the tail's weight (0: no tail)
  float miss_tail;   // float32(miss * tail_w), as the reference's constant
  Fan f;
};

__device__ __forceinline__ float load_cell(const float* p) { return *p; }
__device__ __forceinline__ float load_cell(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_cell(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_cell(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);           // exact: v is already bf16-valued
}
// The value a store of `v` leaves in the grid, as the next agent reads it.
template <typename T>
__device__ __forceinline__ float stored(float v) {
  if constexpr (sizeof(T) == 2) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

// One block's tile. GUARD: the tile windows' grid-edge guard, a template
// flag of this body that the kernel picks once per launch (p.guard > 0), so
// that the whole grid and the row bands carry no per-cell guard test.
template <int TABLE, bool RING, bool GUARD, typename T>
__device__ __forceinline__ void raster_tile(
    T* __restrict__ grid, const int* __restrict__ origins,
    const float* __restrict__ meta, const int* __restrict__ table,
    const int* __restrict__ tile_start, const int* __restrict__ pair_agent,
    const int* __restrict__ pair_slot, double* __restrict__ partial,
    const Params& p, uint32_t* s_table, double* s_red) {
  const int tile = blockIdx.x;
  const int p0 = tile_start[tile];
  const int p1 = tile_start[tile + 1];
  if (p0 == p1) return;

  const int gr0 = (tile / p.n_tile_cols) * TILE_R;
  const int gc = (tile % p.n_tile_cols) * TILE_C + (threadIdx.x % TILE_C);
  const int r_first = threadIdx.x / TILE_C;
  const float cx = (float)gc + 0.5f;

  // a ragged last tile row (a band or tile window whose height is not a
  // multiple of TILE_R): its rows past the grid are in no window and are
  // neither read nor written. The test is one branch for the whole block:
  // a test per row made ptxas keep the 32 rows' predicates live through
  // the agent loop, at twice the registers (one block per SM, not two).
  const bool full = gr0 + TILE_R <= p.n_rows;
  float v[CELLS];
  if (full) {
#pragma unroll
    for (int k = 0; k < CELLS; ++k) {
      const int gr = gr0 + r_first + ROWS_PER_PASS * k;
      v[k] = load_cell(grid + (size_t)gr * p.n_cols + gc);
    }
  } else {
#pragma unroll
    for (int k = 0; k < CELLS; ++k) {
      const int gr = gr0 + r_first + ROWS_PER_PASS * k;
      v[k] = gr < p.n_rows ? load_cell(grid + (size_t)gr * p.n_cols + gc)
                           : 0.f;
    }
  }

  for (int q = p0; q < p1; ++q) {
    const int a = pair_agent[q];
    __syncthreads();                       // done with the previous table
    for (int w = threadIdx.x; w < p.n_words; w += THREADS)
      s_table[w] = (uint32_t)table[(size_t)a * p.n_words + w];
    __syncthreads();

    const int row0 = origins[4 * a + 0];
    const int col0 = origins[4 * a + 1];
    const int t_cl = origins[4 * a + 2];
    const int t_ch = origins[4 * a + 3];
    const float ax = meta[6 * a + 0];
    const float ay = meta[6 * a + 1];
    const float yaw = meta[6 * a + 2];
    const float act = meta[6 * a + 3];

    const int wc = gc - col0;
    const bool col_in = (wc >= 0) && (wc < p.cols);
    const int strip = wc / 128;
    // column strips outside the fan bbox carry zero delta and count
    const bool strip_on = col_in && (strip >= t_cl) && (strip < t_ch);
    const float dx = cx - ax;

    double painted_sum = 0.0;
#pragma unroll
    for (int k = 0; k < CELLS; ++k) {
      const int gr = gr0 + r_first + ROWS_PER_PASS * k;
      const int wr = gr - row0;
      if (!col_in || wr < 0 || wr >= p.rows) continue;
      float delta = 0.f;
      if (strip_on) {
        const float cy = (float)gr + 0.5f;
        const float dy = cy - ay;
        Polar c = raster::polar(dx, dy, yaw, p.f);
        if (GUARD) {
          // tile windows reach past the global grid at its edges: the
          // cell's global coordinates in float32, as the reference
          // rebuilds them
          const float gy = cy + meta[6 * a + 4];
          const float gx = cx + meta[6 * a + 5];
          c.base_ok = c.base_ok && gy >= 0.f && gy < p.guard && gx >= 0.f &&
                      gx < p.guard;
        }
        // 5. table lookup: the beam's range and, with the ring, its
        // trusted bit; or the group's carve, trusted fraction and tail
        float rb, tf = 0.f, rt = 0.f;
        if (TABLE == PACK8) {
          // word g >> 2, byte g & 3
          const uint32_t v8 =
              (s_table[c.g >> 2] >> (8 * (c.g & 3))) & 0xFFu;
          rb = (float)(RING ? (v8 & 0x7Fu) : v8) * QUANT8_INV;
          if (RING) tf = (float)(v8 >> 7);
        } else if (TABLE == PACK16) {
          // word g >> 1, half g & 1
          const uint32_t v16 =
              (s_table[c.g >> 1] >> (16 * (c.g & 1))) & 0xFFFFu;
          rb = (float)(RING ? (v16 & 0x7FFFu) : v16) * QUANT16_INV;
          if (RING) tf = (float)(v16 >> 15);
        } else {
          // words 3g, 3g + 1, 3g + 2 (the fraction is 0 without the ring)
          rb = __uint_as_float(s_table[3 * c.g]);
          tf = __uint_as_float(s_table[3 * c.g + 1]);
          rt = __uint_as_float(s_table[3 * c.g + 2]);
        }
        // 8. free carve, the weak tail (grouped), and with the ring the
        // endpoint ring; the cell's painted count summed as the plain
        // version sums it
        const bool freec = c.base_ok && (c.r < rb - 0.5f);
        delta = (freec ? p.f.miss * c.cnt : 0.f) * act;
        float painted = freec ? c.cnt : 0.f;
        if (TABLE == GROUPED && p.tail_w > 0.f) {
          const bool tail = c.base_ok && !freec && (c.r < rt - 0.5f);
          delta = delta + (tail ? p.miss_tail * c.cnt : 0.f) * act;
          painted = painted + (tail ? p.tail_w * c.cnt : 0.f);
        }
        if (RING) {
          const bool on_ring =
              c.base_ok && (fabsf(c.r - rb) <= raster::RING);
          delta = delta + (on_ring ? p.f.hit * c.cnt * tf : 0.f) * act;
          painted = painted + (on_ring ? c.cnt * tf : 0.f);
        }
        painted_sum += painted;
      }
      // 11. apply, clipped (and on a bf16 grid stored) after this agent
      v[k] = stored<T>(fminf(fmaxf(v[k] + delta, -p.f.clampv), p.f.clampv));
    }

    // 10. this pair's painted count (exact in double: any order)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      painted_sum += __shfl_down_sync(0xffffffffu, painted_sum, off);
    if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = painted_sum;
    __syncthreads();
    if (threadIdx.x == 0) {
      double s = 0.0;
      for (int w = 0; w < THREADS / 32; ++w) s += s_red[w];
      partial[pair_slot[q]] = s;
    }
  }

  if (full) {
#pragma unroll
    for (int k = 0; k < CELLS; ++k) {
      const int gr = gr0 + r_first + ROWS_PER_PASS * k;
      store_cell(grid + (size_t)gr * p.n_cols + gc, v[k]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < CELLS; ++k) {
      const int gr = gr0 + r_first + ROWS_PER_PASS * k;
      if (gr < p.n_rows) store_cell(grid + (size_t)gr * p.n_cols + gc, v[k]);
    }
  }
}

template <int TABLE, bool RING, typename T>
__global__ void __launch_bounds__(THREADS)
free_raster_kernel(T* __restrict__ grid,
                   const int* __restrict__ origins,   // [N, 4]
                   const float* __restrict__ meta,    // [N, 6]
                   const int* __restrict__ table,     // [N, n_words]
                   const int* __restrict__ tile_start,
                   const int* __restrict__ pair_agent,
                   const int* __restrict__ pair_slot,
                   double* __restrict__ partial,
                   const Params p) {
  __shared__ uint32_t s_table[TABLE_WORDS];
  __shared__ double s_red[THREADS / 32];
  if (p.guard > 0.f)
    raster_tile<TABLE, RING, true>(grid, origins, meta, table, tile_start,
                                   pair_agent, pair_slot, partial, p,
                                   s_table, s_red);
  else
    raster_tile<TABLE, RING, false>(grid, origins, meta, table, tile_start,
                                    pair_agent, pair_slot, partial, p,
                                    s_table, s_red);
}

template <int TABLE, bool RING, typename T>
void launch(void* grid, const int* origins, const float* meta,
            const int* table, const int* tile_start, const int* pair_agent,
            const int* pair_slot, double* partial, int n_tiles,
            const Params& p, cudaStream_t stream) {
  free_raster_kernel<TABLE, RING, T><<<n_tiles, THREADS, 0, stream>>>(
      static_cast<T*>(grid), origins, meta, table, tile_start, pair_agent,
      pair_slot, partial, p);
}

template <typename T>
void launch_form(int form, void* grid, const int* origins, const float* meta,
                 const int* table, const int* tile_start,
                 const int* pair_agent, const int* pair_slot, double* partial,
                 int n_tiles, const Params& p, cudaStream_t stream) {
#define FREE_RASTER_LAUNCH(TABLE, RING)                                   \
  launch<TABLE, RING, T>(grid, origins, meta, table, tile_start, pair_agent, \
                         pair_slot, partial, n_tiles, p, stream)
  switch (form) {
    case Pack8Ring: FREE_RASTER_LAUNCH(PACK8, true); break;
    case Pack16: FREE_RASTER_LAUNCH(PACK16, false); break;
    case Pack16Ring: FREE_RASTER_LAUNCH(PACK16, true); break;
    case Pack8: FREE_RASTER_LAUNCH(PACK8, false); break;
    case GroupedRing: FREE_RASTER_LAUNCH(GROUPED, true); break;
    default: FREE_RASTER_LAUNCH(GROUPED, false);  // Grouped
  }
#undef FREE_RASTER_LAUNCH
}

}  // namespace

// form: a Form code; storage: F32 or BF16. Any other code, or a table or
// grid the kernel does not take, returns cudaErrorInvalidValue without a
// launch. n_bins: beams, or groups in the grouped forms. The grid is
// [n_rows, n_cols]; guard: the global grid's size for a tile window's
// grid-edge guard, 0 for none.
extern "C" int free_raster_launch(
    void* grid, const int* origins, const float* meta, const int* table,
    const int* tile_start, const int* pair_agent, const int* pair_slot,
    double* partial, int n_tiles, int n_rows, int n_cols, int guard,
    int rows, int cols, int n_words,
    int form, int storage, int n_bins, int dense, int wrap, float theta0,
    float half_gdt, float half_dt, float gdt, float dt, float fan_lo,
    float fan_hi, float cover, float miss, float hit, float clampv,
    float tail_w, float miss_tail, void* stream) {
  const bool grouped = form == GroupedRing || form == Grouped;
  if (n_cols % TILE_C != 0 || n_rows < rows || n_cols < cols || guard < 0 ||
      n_words < 1 || form < Pack8Ring ||
      form > Grouped || (storage != F32 && storage != BF16) || n_bins < 1 ||
      (grouped ? (n_bins > MAX_GROUPS || n_words != 3 * n_bins)
               : n_words > MAX_WORDS))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.n_rows = n_rows;
  p.n_cols = n_cols;
  p.n_tile_cols = n_cols / TILE_C;
  p.guard = (float)guard;
  p.rows = rows;
  p.cols = cols;
  p.n_words = n_words;
  p.tail_w = grouped ? tail_w : 0.f;
  p.miss_tail = miss_tail;
  p.f = Fan{n_bins, dense, theta0, half_gdt, half_dt, gdt, dt,
            fan_lo, fan_hi, cover, miss, hit, clampv, wrap};
  raster::fan_reciprocals(p.f);
  if (n_tiles > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (storage == BF16)
      launch_form<__nv_bfloat16>(form, grid, origins, meta, table,
                                 tile_start, pair_agent, pair_slot, partial,
                                 n_tiles, p, s);
    else
      launch_form<float>(form, grid, origins, meta, table, tile_start,
                         pair_agent, pair_slot, partial, n_tiles, p, s);
  }
  return (int)cudaGetLastError();
}
