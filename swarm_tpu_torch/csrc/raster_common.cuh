// Semantics shared by the port's raster kernels (free_raster.cu,
// room_raster.cu, exact_raster.cu): the reference's float literals, its
// atan2 polynomial, the per-cell polar binning of
// swarm_tpu/ops/beam_raster_pallas.py (_atan2_poly, _wrap_pi_cheap, the beam
// or group bin and fan test, the crossing count), its clip, the evaluation
// box, the clean-tile test and the cp.async copies. Each kernel is built
// with --fmad=false, IEEE 1/sqrtf and IEEE division, so every operation
// here rounds as its counterpart in the plain torch versions (ops/).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace raster {

// float32 constants, written exactly (hex) as the reference's Python
// literals round to float32.
constexpr float EPS_R2 = 0x1.0c6f7ap-20f;      // 1e-6
constexpr float EPS_HI = 0x1.79ca1p-67f;       // 1e-20
constexpr float C0 = 0x1.fffd04p-1f;           // 0.99997726
constexpr float C1 = -0x1.549b4p-2f;           // -0.33262347
constexpr float C2 = 0x1.8c6084p-3f;           // 0.19354346
constexpr float C3 = -0x1.dce8b6p-4f;          // -0.11643287
constexpr float C4 = 0x1.af5604p-5f;           // 0.05265332
constexpr float C5 = -0x1.80148ep-7f;          // -0.01172120
constexpr float HALF_PI = 0x1.921fb6p+0f;
constexpr float PI_F = 0x1.921fb6p+1f;
constexpr float TWO_PI = 0x1.921fb6p+2f;
constexpr float INV_TWO_PI = 0x1.45f306p-3f;
constexpr float RING = 0x1.6b851ep-1f;         // 0.71
constexpr float ON_BEAM = 0x1.333334p-1f;      // 0.6

// Per-call constants of the fan (Python floats rounded to float32 by the
// wrapper): beam_raster_cuda._constants.
struct Fan {
  int n_bins;        // beams, or groups in the grouped tier
  int dense;         // every reachable cell is crossed by >= 1 beam
  float theta0, half_gdt, half_dt, gdt, dt;
  float fan_lo, fan_hi, cover;
  float miss, hit, clampv;
  int wrap;          // the fan covers the full circle (4-way); 0 if omitted
  // float32 reciprocals of gdt and dt (fan_reciprocals): the reference
  // runs under jit, where XLA turns a division by a constant into a
  // multiplication by its float32 reciprocal
  float inv_gdt, inv_dt;
};

// Fill the reciprocals on the host, once per launch (IEEE float division,
// as XLA folds 1 / c).
inline void fan_reciprocals(Fan& f) {
  f.inv_gdt = 1.0f / f.gdt;
  f.inv_dt = 1.0f / f.dt;
}

// _atan2_poly: octant reduction + the reference's odd minimax polynomial,
// Horner order as written there.
__device__ __forceinline__ float atan2_poly(float y, float x) {
  const float ax = fabsf(x);
  const float ay = fabsf(y);
  const float hi = fmaxf(ax, ay);
  const float lo = fminf(ax, ay);
  const float z = lo / fmaxf(hi, EPS_HI);
  const float s = z * z;
  float p = s * C5;
  p = C4 + p;
  p = s * p;
  p = C3 + p;
  p = s * p;
  p = C2 + p;
  p = s * p;
  p = C1 + p;
  p = s * p;
  p = C0 + p;
  p = z * p;
  float r = (ay > ax) ? HALF_PI - p : p;
  r = (x < 0.f) ? PI_F - r : r;
  return (y < 0.f) ? -r : r;
}

// One cell's polar position relative to an agent, its beam bin and the
// evidence support (steps 1-4, 6 and 7 of the reference kernels).
struct Polar {
  float r;           // distance in cells
  float cnt;         // crossing count, rounded half to even, >= 1
  int g;             // beam (group) index: clipped to [0, n_bins), or
                     // wrapped
  bool base_ok;      // in the fan, on a beam, not the agent's own cell
};

__device__ __forceinline__ Polar polar(float dx, float dy, float yaw,
                                       const Fan& f) {
  Polar o;
  // 1. polar coordinates of the cell centre
  const float r2 = dx * dx + dy * dy;
  const float rinv = 1.0f / sqrtf(fmaxf(r2, EPS_R2));
  o.r = r2 * rinv;
  // 2.-4. beam bin, wrapped with one round, and the fan test
  const float theta = atan2_poly(dy, dx);
  float rel = theta - yaw;
  rel = rel - f.theta0;
  rel = rel - f.half_gdt;
  rel = rel + f.half_dt;
  rel = rel - TWO_PI * rintf(rel * INV_TWO_PI);
  const int g = (int)floorf(rel * f.inv_gdt + 0.5f);
  bool in_fan;
  if (f.wrap) {
    // jnp.mod is a floor-mod (g lies in [-2, 2] for the 4-way fan); C's %
    // truncates. Every direction is in the fan. The residual below uses
    // the WRAPPED bin, as the reference does (ROADMAP Queue C).
    o.g = ((g % f.n_bins) + f.n_bins) % f.n_bins;
    in_fan = true;
  } else {
    in_fan = (rel >= f.fan_lo) && (rel < f.fan_hi);
    o.g = min(max(g, 0), f.n_bins - 1);
  }
  // 6. crossing count, rounded half to even
  o.cnt = fmaxf(1.0f, rintf(rinv * f.inv_dt));
  // 7. evidence support
  if (f.dense) {
    o.base_ok = in_fan && (r2 > EPS_R2);
  } else {
    const bool covered = rinv >= f.cover;
    const float resid = rel - (float)o.g * f.gdt;
    const bool on_any = covered || (fabsf(o.r * resid) <= ON_BEAM);
    o.base_ok = in_fan && on_any && (r2 > EPS_R2);
  }
  return o;
}

// Range table kinds: pack8 (7-bit 1/4-cell ranges + trusted bit 7 with
// the ring, four beams a word), pack16 (15-bit 1/256-cell ranges + trusted
// bit 15, two a word), grouped (per group the carve, the trusted fraction
// and the tail as three floats).
enum TableKind { PACK8 = 0, PACK16 = 1, GROUPED = 2 };

// The largest range one table word (index w) holds, decoded as the lookup
// decodes it: every 8-bit (pack8) or 16-bit (pack16) field, 7 or 15 bits
// of range with the ring; grouped words 3g (carve) and 3g + 2 (tail), not
// 3g + 1 (the trusted fraction). fmaxf drops a NaN: a NaN range takes no
// evidence.
template <int TABLE, bool RING>
__device__ __forceinline__ float word_reach(uint32_t x, int w) {
  if (TABLE == PACK8) {
    const uint32_t m = RING ? 0x7Fu : 0xFFu;
    const uint32_t a = max(max(x & m, (x >> 8) & m),
                           max((x >> 16) & m, (x >> 24) & m));
    return (float)a * 0.25f;
  } else if (TABLE == PACK16) {
    const uint32_t m = RING ? 0x7FFFu : 0xFFFFu;
    return (float)max(x & m, (x >> 16) & m) * 0x1p-8f;
  } else {
    return (w % 3 == 1) ? 0.f : fmaxf(__uint_as_float(x), 0.f);
  }
}

// The evaluation box: a superset of the cells that can take an agent's
// evidence, from `reach` (R, the largest range the agent's own table
// holds) and the fan (csrc/free_raster.cu's note has the argument). Float
// bounds with integer values, [lo, hi) in the agent's cells (columns x,
// rows y).
constexpr float BOX_RADIUS = 1.0f;     // beyond R: the ring's 0.71, rounding
constexpr float BOX_MARGIN = 1.0f;     // cells beyond the sector's bbox
constexpr float ARC_SLACK = 0.01f;     // radians on each side of the arc
constexpr float SECTOR_YAW_MAX = 64.f; // above: the whole disc

struct Box {
  float x_lo, x_hi, y_lo, y_hi;
};

// Whether direction `a` lies in the arc [lo, lo + arc] (mod 2 pi).
__device__ __forceinline__ bool in_arc(float a, float lo, float arc) {
  float d = a - lo;
  d = d - TWO_PI * floorf(d * INV_TWO_PI);
  return d <= arc;
}

__device__ __forceinline__ Box evaluation_box(float ax, float ay, float yaw,
                                              float reach, const Fan& f) {
  const float rho = reach + BOX_RADIUS;
  // the fan's directions (the reference's in-fan test) as the bbox of the
  // unit sector; the wrapped fan, an arc of 2 pi or a yaw whose float32
  // sums lose more than the slack: the whole disc
  float xmin = -1.f, xmax = 1.f, ymin = -1.f, ymax = 1.f;
  const float arc = (float)f.n_bins * f.gdt + 2.f * ARC_SLACK;
  if (!f.wrap && arc < TWO_PI && fabsf(yaw) <= SECTOR_YAW_MAX) {
    const float lo = yaw + f.theta0 - f.half_dt - ARC_SLACK;
    const float hi = lo + arc;
    float sl, cl, sh, ch;
    sincosf(lo, &sl, &cl);
    sincosf(hi, &sh, &ch);
    xmax = in_arc(0.f, lo, arc) ? 1.f : fmaxf(cl, ch);
    xmin = in_arc(PI_F, lo, arc) ? -1.f : fminf(cl, ch);
    ymax = in_arc(HALF_PI, lo, arc) ? 1.f : fmaxf(sl, sh);
    ymin = in_arc(-HALF_PI, lo, arc) ? -1.f : fminf(sl, sh);
  }
  // with its apex (the agent), radius rho, widened by BOX_MARGIN cells
  Box b;
  b.x_lo = floorf(ax + rho * fminf(xmin, 0.f) - BOX_MARGIN);
  b.x_hi = ceilf(ax + rho * fmaxf(xmax, 0.f) + BOX_MARGIN);
  b.y_lo = floorf(ay + rho * fminf(ymin, 0.f) - BOX_MARGIN);
  b.y_hi = ceilf(ay + rho * fmaxf(ymax, 0.f) + BOX_MARGIN);
  return b;
}

// One axis of a box as a block-local integer range [lo, hi): the bounds
// less `origin`, clamped into [a, max(a, b)] in float before the
// conversion, so that no bound overflows and a NaN bound gives way to the
// clamp's.
__device__ __forceinline__ int2 clamp_range(float lo, float hi, int origin,
                                            int a, int b) {
  const float fa = (float)a;
  const float fb = (float)max(a, b);
  return make_int2((int)fminf(fmaxf(lo - (float)origin, fa), fb),
                   (int)fmaxf(fminf(hi - (float)origin, fb), fa));
}

// The reference's clip after each agent, jnp.clip(v, -c, c) (torch.clamp
// in the plain versions): a NaN stays NaN, where fmaxf(NaN, -c) would give
// -c, and a -0.0 stays -0.0. max.NaN / min.NaN (sm_80 and later) return a
// NaN if either operand is one, each in one instruction as fmaxf / fminf.
__device__ __forceinline__ float clip(float v, float c) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(v), "f"(-c));
  asm("min.NaN.f32 %0, %0, %1;" : "+f"(r) : "f"(c));
  return r;
}

// A value on which an agent's clip with a +0.0 delta is the identity:
// in [-clamp, clamp] (so not NaN) and not -0.0.
__device__ __forceinline__ bool clean(float v, float clampv) {
  return fabsf(v) <= clampv && __float_as_uint(v) != 0x80000000u;
}

// Whether every value of this thread's share of a tile (n_tr rows of
// TILE_C cells from (gr0, gc0) of a grid n_cols wide) is clean: 16-byte
// loads, 4 float or 8 bf16 cells each, so the grid must be 16-byte
// aligned; the block's THREADS threads share the tile.
template <typename T, int TILE_C, int THREADS>
__device__ __forceinline__ bool scan_clean(const T* __restrict__ grid,
                                           int gr0, int gc0, int n_tr,
                                           int n_cols, float clampv) {
  constexpr int PER = 16 / sizeof(T);        // cells per 16-byte chunk
  constexpr int CHUNKS = TILE_C / PER;       // chunks per tile row
  bool ok = true;
  for (int i = threadIdx.x; i < n_tr * CHUNKS; i += THREADS) {
    const T* p = grid + (size_t)(gr0 + i / CHUNKS) * n_cols + gc0 +
                 PER * (i % CHUNKS);
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (sizeof(T) == 2) {
        ok = ok && clean(__uint_as_float(w[j] << 16), clampv) &&
             clean(__uint_as_float(w[j] & 0xFFFF0000u), clampv);
      } else {
        ok = ok && clean(__uint_as_float(w[j]), clampv);
      }
    }
  }
  return ok;
}

// Asynchronous copies of BYTES (4 or 8) from global into shared memory
// (cp.async, sm_80 and later): a block's next (agent, tile) pair's
// operands arrive while it evaluates the current pair.
template <int BYTES = 4>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"(BYTES));
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace raster
