// Beam-model free-space raster over per-agent windows, for Hopper.
//
// Replaces swarm_tpu/ops/beam_raster_pallas.py::_free_kernel in its
// per-beam forms (n_groups == n_beams), with the range table as a template
// parameter:
//   Pack8Ring  pack8 table (7-bit 1/4-cell ranges + trusted bit 7, four
//              beams per int32 word) and the in-kernel endpoint ring
//              (`trusted` given, `pack8=True`);
//   Pack16     pack16 table (16-bit 1/256-cell ranges, two beams per word)
//              without the ring (`trusted=None`, `pack8=False`): the free
//              carve alone, the endpoints going to the exact scatter.
// Either table serves the 181-beam scan and the wrapped 4-way fan (the
// wrap lives in raster_common.cuh `polar`). The math is the reference
// kernel's, operation for operation (see the numbered steps below);
// ops/beam_raster_cuda.py holds the same function in plain torch
// (free_raster_plain) and the wrapper that prepares this launch.
//
// Scheduling: owner-computes tiles. The TPU kernel walks agents in order on
// one core, and each agent's window is clipped to [-clamp, clamp] right
// after that agent is added, so overlapping windows must be applied in
// agent index order: clip(clip(g + d1) + d2) is not clip(g + d1 + d2), and
// plain atomics would give the latter. Here one block owns one 64 x 128
// grid tile. The wrapper lists every (agent, tile) pair, sorted stably by
// (tile, agent); the block keeps its tile in registers, walks its agents
// in index order, and writes the tile back once. Each pair's painted count
// goes to its own slot of `partial`, and the wrapper reduces the slots per
// agent in a fixed order: no float atomics, deterministic. The grid launches
// one block for every tile and a tile no agent touches returns at once:
// launching only the non-empty tiles would need their count on the host, a
// sync in every step.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
//        -std=c++17 -shared -Xcompiler -fPIC
// --fmad=false keeps every add and multiply separately rounded, as the
// plain torch version issues them, and IEEE 1/sqrtf (not rsqrtf) and
// IEEE division keep the rest bit-equal to it.

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
constexpr float QUANT8_INV = 0.25f;
constexpr float QUANT16_INV = 0x1p-8f;                     // 1/256

enum Form { Pack8Ring = 0, Pack16 = 1 };

struct Params {
  int size;          // grid is [size, size], size % 128 == 0
  int n_tile_cols;   // size / TILE_C
  int rows, cols;    // agent window
  int n_words;       // table words per agent
  Fan f;
};

template <int FORM>
__global__ void __launch_bounds__(THREADS)
free_raster_kernel(float* __restrict__ grid,
                   const int* __restrict__ origins,   // [N, 4]
                   const float* __restrict__ meta,    // [N, 4]
                   const int* __restrict__ table,     // [N, n_words]
                   const int* __restrict__ tile_start,
                   const int* __restrict__ pair_agent,
                   const int* __restrict__ pair_slot,
                   float* __restrict__ partial,
                   const Params p) {
  const int tile = blockIdx.x;
  const int p0 = tile_start[tile];
  const int p1 = tile_start[tile + 1];
  if (p0 == p1) return;

  __shared__ uint32_t s_table[MAX_WORDS];
  __shared__ float s_red[THREADS / 32];

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
    for (int w = threadIdx.x; w < p.n_words; w += THREADS)
      s_table[w] = (uint32_t)table[(size_t)a * p.n_words + w];
    __syncthreads();

    const int row0 = origins[4 * a + 0];
    const int col0 = origins[4 * a + 1];
    const int t_cl = origins[4 * a + 2];
    const int t_ch = origins[4 * a + 3];
    const float ax = meta[4 * a + 0];
    const float ay = meta[4 * a + 1];
    const float yaw = meta[4 * a + 2];
    const float act = meta[4 * a + 3];

    const int wc = gc - col0;
    const bool col_in = (wc >= 0) && (wc < p.cols);
    const int strip = wc / 128;
    // column strips outside the fan bbox carry zero delta and count
    const bool strip_on = col_in && (strip >= t_cl) && (strip < t_ch);
    const float dx = cx - ax;

    float painted_sum = 0.f;
#pragma unroll
    for (int k = 0; k < CELLS; ++k) {
      const int gr = gr0 + r_first + ROWS_PER_PASS * k;
      const int wr = gr - row0;
      if (!col_in || wr < 0 || wr >= p.rows) continue;
      float delta = 0.f;
      if (strip_on) {
        const float dy = ((float)gr + 0.5f) - ay;
        const Polar c = raster::polar(dx, dy, yaw, p.f);
        if (FORM == Pack8Ring) {
          // 5. pack8 lookup: word g >> 2, byte g & 3
          const uint32_t v8 =
              (s_table[c.g >> 2] >> (8 * (c.g & 3))) & 0xFFu;
          const float rb = (float)(v8 & 0x7Fu) * QUANT8_INV;
          const float tf = (float)(v8 >> 7);   // trusted bit
          // 8. free carve + endpoint ring
          const bool freec = c.base_ok && (c.r < rb - 0.5f);
          delta = (freec ? p.f.miss * c.cnt : 0.f) * act;
          const bool on_ring =
              c.base_ok && (fabsf(c.r - rb) <= raster::RING);
          delta = delta + (on_ring ? p.f.hit * c.cnt * tf : 0.f) * act;
          painted_sum +=
              (freec ? c.cnt : 0.f) + (on_ring ? c.cnt * tf : 0.f);
        } else {
          // 5. pack16 lookup: word g >> 1, half g & 1; no trusted bit
          const uint32_t v16 =
              (s_table[c.g >> 1] >> (16 * (c.g & 1))) & 0xFFFFu;
          const float rb = (float)v16 * QUANT16_INV;
          // 8. free carve only
          const bool freec = c.base_ok && (c.r < rb - 0.5f);
          delta = (freec ? p.f.miss * c.cnt : 0.f) * act;
          painted_sum += freec ? c.cnt : 0.f;
        }
      }
      // 11. apply, clipped after this agent
      v[k] = fminf(fmaxf(v[k] + delta, -p.f.clampv), p.f.clampv);
    }

    // 10. this pair's painted count (integer-valued: exact in any order)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      painted_sum += __shfl_down_sync(0xffffffffu, painted_sum, off);
    if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = painted_sum;
    __syncthreads();
    if (threadIdx.x == 0) {
      float s = 0.f;
      for (int w = 0; w < THREADS / 32; ++w) s += s_red[w];
      partial[pair_slot[q]] = s;
    }
  }

#pragma unroll
  for (int k = 0; k < CELLS; ++k) {
    const int gr = gr0 + r_first + ROWS_PER_PASS * k;
    grid[(size_t)gr * p.size + gc] = v[k];
  }
}

}  // namespace

// form: 0 = pack8 table + endpoint ring, 1 = pack16 table, no ring.
extern "C" int free_raster_launch(
    float* grid, const int* origins, const float* meta, const int* table,
    const int* tile_start, const int* pair_agent, const int* pair_slot,
    float* partial, int n_tiles, int size, int rows, int cols, int n_words,
    int form, int n_beams, int dense, int wrap, float theta0,
    float half_gdt, float half_dt, float gdt, float dt, float fan_lo,
    float fan_hi, float cover, float miss, float hit, float clampv,
    void* stream) {
  if (size % TILE_C != 0 || n_words > MAX_WORDS || n_words < 1 ||
      (form != Pack8Ring && form != Pack16))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.size = size;
  p.n_tile_cols = size / TILE_C;
  p.rows = rows;
  p.cols = cols;
  p.n_words = n_words;
  p.f = Fan{n_beams, dense, theta0, half_gdt, half_dt, gdt, dt,
            fan_lo, fan_hi, cover, miss, hit, clampv, wrap};
  raster::fan_reciprocals(p.f);
  if (n_tiles > 0) {
    auto kernel = form == Pack8Ring ? free_raster_kernel<Pack8Ring>
                                    : free_raster_kernel<Pack16>;
    kernel<<<n_tiles, THREADS, 0, (cudaStream_t)stream>>>(
        grid, origins, meta, table, tile_start, pair_agent, pair_slot,
        partial, p);
  }
  return (int)cudaGetLastError();
}
