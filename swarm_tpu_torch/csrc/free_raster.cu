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
// (tile, agent); the block walks its agents in index order and updates its
// tile's cells in place in the grid, with a barrier between agents (which
// makes the block's writes visible to all its threads). On a bf16 grid the
// reference stores each agent's window as bf16 before the next agent reads
// it, and so does the block: rounding once at the end would be a different
// sum wherever windows overlap. Each pair's painted count goes to its own
// slot of `partial`, and the wrapper reduces the slots per agent: no float
// atomics. The count is summed in double: every cell's term is a float
// (the same float in the plain version), and while each nonzero term is at
// least 2^-8 (groups of at most 256 beams, a tail weight of at least 1/256:
// the engine's is 0.25) and a window's total below 2^22, 53 bits hold
// every partial sum exactly. The order of the sum then does not matter,
// and the count, rounded to float once, equals the plain version's, also
// where the grouped tier's fractions make it a half-integer that the engine
// rounds. The grid launches one block for every tile and a tile no agent
// touches returns at once: launching only the non-empty tiles would need
// their count on the host, a sync in every step. Each agent's table, origin
// and meta are copied into shared memory with cp.async one pair ahead
// (double-buffered), so they arrive while the block evaluates the previous
// agent; the lookup is an index (the TPU kernel's select trees and its loop
// over groups are Mosaic workarounds).
//
// The evaluation box. Only a cell within reach of the agent's own ranges
// and inside its fan can take evidence, so the block evaluates
// (raster_common.cuh `polar`, the lookup, the evidence) only the cells of
// a box around the agent (raster_common.cuh `evaluation_box`). From the
// agent's table in shared memory it takes R, the largest range the table
// holds, decoded as the lookup decodes it (per beam `rb`, grouped max(rb,
// rt): the carve and the tail; every field, padding included), with a
// block reduction. Why the box holds every cell that can take evidence:
//  - evidence needs base_ok and r < rb - 0.5 (carve), r < rt - 0.5 (tail)
//    or |r - rb| <= 0.71 (ring), so the computed r <= R + 0.71; r = r2 *
//    (1 / sqrt(r2)) is the centre's distance d within a few ulp, so d <
//    R + 1 = rho;
//  - base_ok needs the in-fan test: the computed rel in [-gdt / 2,
//    (n_bins - 0.5) gdt), i.e. the centre's direction theta in [lo, lo +
//    arc) with lo = yaw + theta0 - dt / 2 and arc = n_bins gdt (mod 2 pi).
//    theta is the reference polynomial's (error below 2e-5 rad), and the
//    float32 sums and the one-round wrap lose below 1e-4 rad while |yaw| <=
//    64; the box takes the arc 0.01 rad wider on each side (the wrapped
//    fan, an arc of 2 pi or a larger |yaw|: every direction);
//  - so the centre lies in the sector of radius rho over the widened arc,
//    whose bounding box with its apex, [rho xmin, rho xmax] x [rho ymin,
//    rho ymax] from the cosines and sines of the arc's ends and the axis
//    directions it holds, the box widens by one cell: [floor(a + rho min -
//    1), ceil(a + rho max + 1)) on each axis. A cell outside has its centre
//    at least half a cell outside the sector's box, which absorbs sincosf's
//    and the bounds' rounding; a NaN bound leaves the whole window in.
// A cell outside the box therefore gets a delta of +0.0 (0 * act, then the
// strip select) and a painted count of 0 from the plain version too. The
// box is intersected with the window, the tile and the reference's
// fan-bbox strips [t_cl, t_ch) (the strips are semantics: ROADMAP C1's
// skipped cells stay skipped). The block's threads share box ∩ tile evenly
// through a compact index over it, so the work is proportional to the box,
// not to the aligned window. Every other window cell still takes the
// agent's clip (and store) with a +0.0 delta, which is the identity on a
// "clean" value: one in [-clamp, clamp] that is not -0.0 (nor NaN); the
// stored value of a bf16 grid is already bf16. The block scans its tile
// once (16-byte loads) before its first agent and tests every value it
// writes (__syncthreads_and at each agent's start): while the whole tile is
// clean, only the box is visited, read and written; a tile with any other
// value (a grid prefilled beyond +-clamp, a -0.0 cell) visits, from then
// on, every cell of each agent's window and evaluates the box cells among
// them, as the plain version does.
//
// What bounds it: the bound counts the tiles the windows cover, read and
// written once (bytes); the kernel reads them once (the scan) and writes
// only the boxes. Each evaluated cell costs a long dependent chain (IEEE
// sqrt and divisions, the atan2 polynomial), and each (agent, tile) pair a
// chain of dependent loads and two barriers. The box cuts the evaluated
// cells of a 26-cell reach to ~28-45 x 52 an agent on the 181-beam scan
// (~52 x 52 on the wrapped fan) from 64-80 x 128-256. Blocks of 128
// threads, with no tile held in registers or shared memory, fit 8 or more
// to an SM (__launch_bounds__: at most 64 registers, 32 warps or more), so
// that many blocks' barriers and load chains overlap: against 256-thread
// blocks they took a quarter off the 32,768-agent launch on an H100.
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
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MIN_BLOCKS = 8;       // resident blocks per SM (registers)
constexpr int MAX_WORDS = 128;      // pack16: <= 256 beams, pack8: <= 512
constexpr int MAX_GROUPS = 512;     // grouped: 3 floats a group
constexpr int TABLE_WORDS = 3 * MAX_GROUPS;                // >= MAX_WORDS
constexpr float QUANT8_INV = 0.25f;
constexpr float QUANT16_INV = 0x1p-8f;                     // 1/256

// The range table (the TABLE template parameter): raster_common.cuh
// TableKind.
using raster::GROUPED;
using raster::PACK16;
using raster::PACK8;
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

// One pair's operands in shared memory: the agent's table words and its
// origins (row0, col0, t_cl, t_ch) and meta (ax, ay, yaw, act, goff_r,
// goff_c) as words.
struct PairData {
  uint32_t table[TABLE_WORDS];
  int origin[4];
  float meta[6];
};

// Start the copy of agent a's operands into `d` (every thread its share).
__device__ __forceinline__ void fetch_pair(PairData& d, int a,
                                           const int* __restrict__ origins,
                                           const float* __restrict__ meta,
                                           const int* __restrict__ table,
                                           int n_words) {
  for (int w = threadIdx.x; w < n_words; w += THREADS)
    raster::copy_async(&d.table[w], table + (size_t)a * n_words + w);
  if (threadIdx.x < 4)
    raster::copy_async(&d.origin[threadIdx.x],
                       origins + 4 * a + threadIdx.x);
  else if (threadIdx.x < 10)
    raster::copy_async(&d.meta[threadIdx.x - 4],
                       meta + 6 * a + threadIdx.x - 4);
  raster::copy_commit();
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
    const Params& p, PairData* s_pair, float* s_reach, double* s_red) {
  const int tile = blockIdx.x;
  const int p0 = tile_start[tile];
  const int p1 = tile_start[tile + 1];
  if (p0 == p1) return;

  const int gr0 = (tile / p.n_tile_cols) * TILE_R;
  const int gc0 = (tile % p.n_tile_cols) * TILE_C;
  const float clampv = p.f.clampv;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // the first pair's operands on their way while the block scans its tile
  // (a ragged last tile row, of a band or tile window whose height is not
  // a multiple of TILE_R: its rows past the grid are in no window and are
  // neither read nor written)
  fetch_pair(s_pair[0], pair_agent[p0], origins, meta, table, p.n_words);
  int a_next = p0 + 1 < p1 ? pair_agent[p0 + 1] : 0;
  bool mine_clean = raster::scan_clean<T, TILE_C, THREADS>(
      grid, gr0, gc0, min(TILE_R, p.n_rows - gr0), p.n_cols, clampv);

  bool tile_clean = true;
  for (int q = p0; q < p1; ++q) {
    const PairData& d = s_pair[(q - p0) & 1];
    raster::copy_wait();
    // this pair's operands have arrived; done with the previous pair's
    // cells, operands and painted partials
    tile_clean = __syncthreads_and(tile_clean && mine_clean) != 0;
    if (threadIdx.x == 0 && q > p0) {
      double s = 0.0;
      for (int w = 0; w < WARPS; ++w) s += s_red[w];
      partial[pair_slot[q - 1]] = s;
    }
    // the next pair's operands, and the index of the one after it
    if (q + 1 < p1) {
      fetch_pair(s_pair[(q + 1 - p0) & 1], a_next, origins, meta, table,
                 p.n_words);
      a_next = q + 2 < p1 ? pair_agent[q + 2] : 0;
    }
    // R: the largest range the agent's table holds
    float reach = 0.f;
    for (int w = threadIdx.x; w < p.n_words; w += THREADS)
      reach = fmaxf(reach, raster::word_reach<TABLE, RING>(d.table[w], w));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      reach = fmaxf(reach, __shfl_xor_sync(0xffffffffu, reach, off));
    if (lane == 0) s_reach[warp] = reach;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < WARPS; ++w) reach = fmaxf(reach, s_reach[w]);

    const int row0 = d.origin[0];
    const int col0 = d.origin[1];
    const int t_cl = d.origin[2];
    const int t_ch = d.origin[3];
    const float ax = d.meta[0];
    const float ay = d.meta[1];
    const float yaw = d.meta[2];
    const float act = d.meta[3];

    // tile-local bounds [lo, hi): the window, and the evaluated cells:
    // window ∩ fan-bbox strips ∩ box
    const int wr_lo = max(row0 - gr0, 0);
    const int wr_hi = min(row0 + p.rows - gr0, TILE_R);
    const int wc_lo = max(col0 - gc0, 0);
    const int wc_hi = min(col0 + p.cols - gc0, TILE_C);
    const raster::Box box = raster::evaluation_box(ax, ay, yaw, reach, p.f);
    const int2 er = raster::clamp_range(box.y_lo, box.y_hi, gr0, wr_lo,
                                        wr_hi);
    const int2 ec = raster::clamp_range(box.x_lo, box.x_hi, gc0,
                                        max(wc_lo, col0 + 128 * t_cl - gc0),
                                        min(wc_hi, col0 + 128 * t_ch - gc0));
    const int er_lo = er.x, er_hi = er.y, ec_lo = ec.x, ec_hi = ec.y;
    // visited: the evaluated cells on a clean tile, else the whole window
    const int vr_lo = tile_clean ? er_lo : wr_lo;
    const int vc_lo = tile_clean ? ec_lo : wc_lo;
    const int v_h = max((tile_clean ? er_hi : wr_hi) - vr_lo, 0);
    const int v_w = max((tile_clean ? ec_hi : wc_hi) - vc_lo, 0);

    // this thread's cells: i = threadIdx.x + THREADS k of the compact
    // index, walked as (row, column) steps with one carry, no division
    int lr = vr_lo, lc = vc_lo, step_r = 0, step_c = 0;
    if (v_w > 0) {
      lr += threadIdx.x / v_w;
      lc += threadIdx.x % v_w;
      step_r = THREADS / v_w;
      step_c = THREADS % v_w;
    }
    double painted_sum = 0.0;
    for (int i = threadIdx.x; i < v_h * v_w; i += THREADS) {
      T* cell = grid + (size_t)(gr0 + lr) * p.n_cols + gc0 + lc;
      const float old = load_cell(cell);
      float delta = 0.f;
      if (lr >= er_lo && lr < er_hi && lc >= ec_lo && lc < ec_hi) {
        const float cx = (float)(gc0 + lc) + 0.5f;
        const float cy = (float)(gr0 + lr) + 0.5f;
        Polar c = raster::polar(cx - ax, cy - ay, yaw, p.f);
        if (GUARD) {
          // tile windows reach past the global grid at its edges: the
          // cell's global coordinates in float32, as the reference
          // rebuilds them
          const float gy = cy + d.meta[4];
          const float gx = cx + d.meta[5];
          c.base_ok = c.base_ok && gy >= 0.f && gy < p.guard && gx >= 0.f &&
                      gx < p.guard;
        }
        // 5. table lookup: the beam's range and, with the ring, its
        // trusted bit; or the group's carve, trusted fraction and tail
        float rb, tf = 0.f, rt = 0.f;
        if (TABLE == PACK8) {
          // word g >> 2, byte g & 3
          const uint32_t v8 =
              (d.table[c.g >> 2] >> (8 * (c.g & 3))) & 0xFFu;
          rb = (float)(RING ? (v8 & 0x7Fu) : v8) * QUANT8_INV;
          if (RING) tf = (float)(v8 >> 7);
        } else if (TABLE == PACK16) {
          // word g >> 1, half g & 1
          const uint32_t v16 =
              (d.table[c.g >> 1] >> (16 * (c.g & 1))) & 0xFFFFu;
          rb = (float)(RING ? (v16 & 0x7FFFu) : v16) * QUANT16_INV;
          if (RING) tf = (float)(v16 >> 15);
        } else {
          // words 3g, 3g + 1, 3g + 2 (the fraction is 0 without the ring)
          rb = __uint_as_float(d.table[3 * c.g]);
          tf = __uint_as_float(d.table[3 * c.g + 1]);
          rt = __uint_as_float(d.table[3 * c.g + 2]);
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
      const float v = stored<T>(raster::clip(old + delta, clampv));
      store_cell(cell, v);
      mine_clean = mine_clean && raster::clean(v, clampv);
      lr += step_r;
      lc += step_c;
      if (lc >= vc_lo + v_w) {
        lc -= v_w;
        ++lr;
      }
    }

    // 10. this pair's painted count (exact in double: any order), summed
    // by thread 0 after the next pair's first barrier, or after the loop
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      painted_sum += __shfl_down_sync(0xffffffffu, painted_sum, off);
    if (lane == 0) s_red[warp] = painted_sum;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = 0.0;
    for (int w = 0; w < WARPS; ++w) s += s_red[w];
    partial[pair_slot[p1 - 1]] = s;
  }
}

template <int TABLE, bool RING, typename T>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
free_raster_kernel(T* __restrict__ grid,
                   const int* __restrict__ origins,   // [N, 4]
                   const float* __restrict__ meta,    // [N, 6]
                   const int* __restrict__ table,     // [N, n_words]
                   const int* __restrict__ tile_start,
                   const int* __restrict__ pair_agent,
                   const int* __restrict__ pair_slot,
                   double* __restrict__ partial,
                   const Params p) {
  __shared__ PairData s_pair[2];       // the current and the next pair
  __shared__ float s_reach[WARPS];
  __shared__ double s_red[WARPS];
  if (p.guard > 0.f)
    raster_tile<TABLE, RING, true>(grid, origins, meta, table, tile_start,
                                   pair_agent, pair_slot, partial, p, s_pair,
                                   s_reach, s_red);
  else
    raster_tile<TABLE, RING, false>(grid, origins, meta, table, tile_start,
                                    pair_agent, pair_slot, partial, p,
                                    s_pair, s_reach, s_red);
}

// The instance of a (form, storage) pair.
template <int TABLE, bool RING, typename T>
const void* instance() {
  return (const void*)free_raster_kernel<TABLE, RING, T>;
}

template <typename T>
const void* instance_of(int form) {
  switch (form) {
    case Pack8Ring: return instance<PACK8, true, T>();
    case Pack16: return instance<PACK16, false, T>();
    case Pack16Ring: return instance<PACK16, true, T>();
    case Pack8: return instance<PACK8, false, T>();
    case GroupedRing: return instance<GROUPED, true, T>();
    default: return instance<GROUPED, false, T>();  // Grouped
  }
}

const void* instance_of(int form, int storage) {
  return storage == BF16 ? instance_of<__nv_bfloat16>(form)
                         : instance_of<float>(form);
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
      ((uintptr_t)grid & 15) != 0 ||
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
    void* args[] = {&grid, (void*)&origins, (void*)&meta, (void*)&table,
                    (void*)&tile_start, (void*)&pair_agent,
                    (void*)&pair_slot, &partial, &p};
    const cudaError_t err = cudaLaunchKernel(
        instance_of(form, storage), dim3(n_tiles), dim3(THREADS), args, 0,
        (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// Resident blocks per SM of the instance of (form, storage), from the
// occupancy calculator, into *blocks; returns the CUDA error code.
extern "C" int free_raster_blocks_per_sm(int form, int storage,
                                         int* blocks) {
  if (form < Pack8Ring || form > Grouped ||
      (storage != F32 && storage != BF16))
    return (int)cudaErrorInvalidValue;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, instance_of(form, storage), THREADS, 0);
}
