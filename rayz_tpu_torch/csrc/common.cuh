// Per-ray device code shared by the port's kernels: the counter-based
// random numbers, the nearest-hit sweeps over the shared-memory scene
// tables, and the material scatter. Kernels include this header instead of
// copying the bodies (the JAX package copies them across four modules).
//
// Numerics: the functions compute exactly what the plain torch version in
// rayz_tpu_torch/ops/megakernel.py computes, operation for operation and in
// the same association, and the build passes -fmad=false so that no
// multiply-add is contracted. The one exception is sweep_packed, the
// coefficient-form sweep of the resident and culled megakernel and the
// recorders,
// whose fused multiply-adds are written out; its winner is settled in the
// plain version's arithmetic (below). Square roots and divisions are IEEE (no
// fast-math): the poisoned padding columns (|c|^2 - r^2 = 3e38) reject
// themselves because their discriminant is -inf, and sqrt(-inf) = NaN
// compares false.
#pragma once

#include <cstdint>

namespace rz {

constexpr float kBig = 3.0e38f;  // stand-in for +inf (t on miss)
constexpr float kTwoPi = 6.283185307179586f;
constexpr int kCamWords = 20;  // camera vector (18 used) at the head of smem

// Sphere table rows (one f32 row per attribute, columns = spheres).
constexpr int kCX = 0, kCY = 1, kCZ = 2, kCCMR2 = 3;
constexpr int kVX = 4, kVY = 5, kVZ = 6, kCV2 = 7, kVV = 8;
constexpr int kPKF = 9;  // then ior-or-scale, even rgb, odd rgb
constexpr int kSRows = 17;

// Triangle table rows (columns = triangles).
constexpr int kTNX = 0, kTNY = 1, kTNZ = 2, kTNV0 = 3;
constexpr int kTG1X = 4, kTG1Y = 5, kTG1Z = 6, kTG1V = 7;
constexpr int kTG2X = 8, kTG2Y = 9, kTG2Z = 10, kTG2V = 11;
constexpr int kTPKF = 12;  // then ior-or-scale, even rgb, odd rgb
constexpr int kTRows = 20;

constexpr float kDielectric = 2.0f;
constexpr float kMetallic = 1.0f;

// ---- counter-based random numbers (twin: ops/rng.py) ----

__host__ __device__ __forceinline__ uint32_t hash32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x21F0AAADu;
  x ^= x >> 15;
  x *= 0x735A2D97u;
  x ^= x >> 15;
  return x;
}

__device__ __forceinline__ uint32_t slot_key(uint32_t seed, int pix) {
  return hash32(hash32(seed) ^ static_cast<uint32_t>(pix));
}

__device__ __forceinline__ uint32_t step_key(uint32_t key0, int sample,
                                             int bounce) {
  return hash32(hash32(key0 ^ static_cast<uint32_t>(sample)) ^
                static_cast<uint32_t>(bounce));
}

__device__ __forceinline__ uint32_t draw_bits(uint32_t key, uint32_t n) {
  return hash32(key + n * 0x9E3779B9u);
}

// 23 random bits -> [0, 1), exactly representable in f32.
__device__ __forceinline__ float uniform(uint32_t bits) {
  return static_cast<float>(bits & 0x7FFFFFu) * 1.1920928955078125e-07f;
}

// NaN-propagating clamps (torch.clamp_min / clamp_max semantics).
__device__ __forceinline__ float clamp_min(float x, float c) {
  return x < c ? c : x;
}
__device__ __forceinline__ float clamp_max(float x, float c) {
  return x > c ? c : x;
}

// Uniform unit vector by the cylinder map: z ~ U[-1, 1], phi ~ U[0, 2pi).
__device__ __forceinline__ void unit3(float u_z, float u_phi, float& x,
                                      float& y, float& z) {
  z = 2.0f * u_z - 1.0f;
  const float phi = kTwoPi * u_phi;
  const float r = sqrtf(clamp_min(1.0f - z * z, 1e-24f));
  x = r * cosf(phi);
  y = r * sinf(phi);
}

// ---- ray state ----

struct Ray {
  float ox, oy, oz;  // origin
  float dx, dy, dz;  // direction (not unit)
  float tau;         // motion-blur time in [0, 1)
};

// Per-ray terms of the root tests, which run in q = t * |d|^2 space.
struct RayTerms {
  float a;        // |d|^2
  float d_dot_o;  // d . o
  float o2;       // |o|^2
  float tmin_a;   // t_min * |d|^2
  float tau2;     // tau^2
};

__device__ __forceinline__ RayTerms ray_terms(const Ray& r, float t_min) {
  RayTerms t;
  t.a = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
  t.d_dot_o = r.dx * r.ox + r.dy * r.oy + r.dz * r.oz;
  t.o2 = r.ox * r.ox + r.oy * r.oy + r.oz * r.oz;
  t.tmin_a = t_min * t.a;
  t.tau2 = r.tau * r.tau;
  return t;
}

// Sphere j's center at the ray's time (and |c|^2 - r^2 with it); the
// table's rows are `stride` columns apart.
template <bool kMotion>
__device__ __forceinline__ void sphere_at(const float* __restrict__ tab,
                                          int stride, int j, const Ray& r,
                                          const RayTerms& t, float& cx,
                                          float& cy, float& cz,
                                          float& ccmr2) {
  cx = tab[kCX * stride + j];
  cy = tab[kCY * stride + j];
  cz = tab[kCZ * stride + j];
  ccmr2 = tab[kCCMR2 * stride + j];
  if (kMotion) {
    cx = cx + r.tau * tab[kVX * stride + j];
    cy = cy + r.tau * tab[kVY * stride + j];
    cz = cz + r.tau * tab[kVZ * stride + j];
    ccmr2 = ccmr2 + tab[kCV2 * stride + j] * r.tau +
            tab[kVV * stride + j] * t.tau2;
  }
}

// Nearest-hit sweep over columns [j0, j1) of the sphere table (row stride
// `stride`): a sequential scan with a shrinking q_best, carrying only the
// winner's column in registers. Every thread of a warp reads column j at
// the same moment, so each read is a broadcast (shared memory) or one
// cached line (device memory). Ties keep the earlier column.
template <bool kMotion>
__device__ __forceinline__ void sweep_spheres(const float* __restrict__ tab,
                                              int stride, int j0, int j1,
                                              const Ray& r, const RayTerms& t,
                                              float& qb, int& best) {
#pragma unroll 8
  for (int j = j0; j < j1; ++j) {
    float cx, cy, cz, ccmr2;
    sphere_at<kMotion>(tab, stride, j, r, t, cx, cy, cz, ccmr2);
    const float half_b = r.dx * cx + r.dy * cy + r.dz * cz - t.d_dot_o;
    const float o_dot_c = r.ox * cx + r.oy * cy + r.oz * cz;
    const float c_term = ccmr2 - 2.0f * o_dot_c + t.o2;
    const float disc = half_b * half_b - t.a * c_term;
    if (disc >= 0.0f) {  // no real root otherwise (NaN compares false too)
      const float rt = sqrtf(disc);
      const float q1 = half_b - rt;
      const float q2 = half_b + rt;
      // nearest root in [t_min, t_best): the second root only when the
      // first is out of range
      const float qv = (q1 >= t.tmin_a) ? q1 : q2;
      if (qv >= t.tmin_a && qv < qb) {
        qb = qv;
        best = j;
      }
    }
  }
}

// The whole sphere table of n columns.
template <bool kMotion>
__device__ __forceinline__ void sweep_spheres(const float* __restrict__ tab,
                                              int n, const Ray& r,
                                              const RayTerms& t, float& qb,
                                              int& best) {
  sweep_spheres<kMotion>(tab, n, 0, n, r, t, qb, best);
}

// ---- the packed coefficient-form sweep (megakernel.cu resident and culled,
// record.cu resident, and record_pp.cu) ----
//
// sweep_spheres issues, per column and lane, 9 broadcast loads of one word
// (with motion), 27 unfused FP32 operations, the compare, the branch and
// its convergence barrier: 40 issue slots in the SASS (PERF.md §6), and
// the SM issues 4 warp instructions a clock. This sweep loads less and
// fuses its arithmetic: the block stages each sphere's geometry once as
// 16-byte records (one LDS.128 a column without motion, two LDS.128 and an
// LDS.32 with it), and the ray's side of the quadratic is folded once per
// segment into coefficient vectors, so a column costs 9 (17 with motion)
// fused multiply-adds (__fmaf_rn, written out: the build's -fmad=false
// keeps every other expression unfused):
//   half_b = d.c + tau d.v - d.o
//   c_term = |c|^2 - r^2 + tau (2 c.v) + tau^2 |v|^2 - 2 o.c - 2 tau o.v
//            + |o|^2
//   disc   = half_b^2 - |d|^2 c_term
// the terms of sweep_spheres' quadratic with the motion folded in (the JAX
// dense integrator's form, rayz_tpu/ops/intersect.py), then the same root
// and range rule with an approximate square root (below). Only the
// geometry sits in shared memory (9 words a column with motion, 4
// without): shading reads the winner's centre and material once per
// segment from the row-major table in device memory (L1-resident).
//
// The winner is then settled in today's arithmetic (settle_winner): its q
// is recomputed by sweep_spheres' expressions, so the hit point, and all
// that follows from it, is what sweep_spheres would give for that column;
// the runner-up, the sphere the ray leaves and the grazing column contest
// the winner in today's arithmetic. If today's arithmetic rejects
// the winner, or takes its other root, the ray is swept again in today's
// form over the packed records (sweep_today; counted by the kernels as a
// re-sweep). Paths therefore differ from sweep_spheres' only where the
// forms rank otherwise columns beyond those: a near tie among three, or
// one of two grazing columns. Poisoned padding columns (|c|^2 - r^2 = 3e38, c = v =
// 0) give c_term = 3e38 and a negative or -inf discriminant in this form
// too, and never graze.

// The sphere geometry in shared memory, as staged by stage_spheres: the
// shared-space byte addresses of its record arrays, read by explicit
// ld.shared (lds128, lds32). Generic pointers to the staged arrays, passed
// through the kernels' sweep functors, were compiled into global loads of
// the shared offsets.
struct PackedSpheres {
  uint32_t c;   // [n] float4 (cx, cy, cz, |c|^2 - r^2)
  uint32_t v;   // [n] float4 (vx, vy, vz, 2 c.v), with motion
  uint32_t vv;  // [n] float |v|^2, with motion
};

__device__ __forceinline__ float4 lds128(uint32_t addr) {
  float4 r;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(r.x), "=f"(r.y), "=f"(r.z), "=f"(r.w)
               : "r"(addr));
  return r;
}

__device__ __forceinline__ float lds32(uint32_t addr) {
  float r;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(r) : "r"(addr));
  return r;
}

// Column j's records. The functions below take the record source as a
// template parameter: PackedSpheres here (the shared-memory reads of the
// resident kernels and the culled and streamed megakernel's staging), or a
// kernel's own source with rec_* overloads found by argument-dependent
// lookup.
__device__ __forceinline__ float4 rec_c(const PackedSpheres& s, int j) {
  return lds128(s.c + 16u * j);
}
__device__ __forceinline__ float4 rec_v(const PackedSpheres& s, int j) {
  return lds128(s.v + 16u * j);
}
__device__ __forceinline__ float rec_vv(const PackedSpheres& s, int j) {
  return lds32(s.vv + 4u * j);
}

__device__ __forceinline__ void sts128(uint32_t addr, float4 v) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};"
               :
               : "r"(addr), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

__device__ __forceinline__ void sts32(uint32_t addr, float v) {
  asm volatile("st.shared.f32 [%0], %1;" : : "r"(addr), "f"(v) : "memory");
}

// f32 words of shared memory stage_spheres fills for n columns.
template <bool kMotion>
__host__ __device__ constexpr int packed_words(int n) {
  return (kMotion ? 9 : 4) * n;
}

// Stage the geometry rows of the row-major sphere table `tab` [17, n] into
// `smem` (16-byte aligned, packed_words<kMotion>(n) words) as records.
template <bool kMotion>
__device__ __forceinline__ PackedSpheres stage_spheres(
    const float* __restrict__ tab, int n, float* smem) {
  float4* c = reinterpret_cast<float4*>(smem);
  float4* v = c + n;
  float* vv = reinterpret_cast<float*>(v + n);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    c[i] = make_float4(tab[kCX * n + i], tab[kCY * n + i], tab[kCZ * n + i],
                       tab[kCCMR2 * n + i]);
    if (kMotion) {
      v[i] = make_float4(tab[kVX * n + i], tab[kVY * n + i],
                         tab[kVZ * n + i], tab[kCV2 * n + i]);
      vv[i] = tab[kVV * n + i];
    }
  }
  return PackedSpheres{static_cast<uint32_t>(__cvta_generic_to_shared(c)),
                       static_cast<uint32_t>(__cvta_generic_to_shared(v)),
                       static_cast<uint32_t>(__cvta_generic_to_shared(vv))};
}

// The ray's coefficient vectors: alpha = (d, tau d) against (c, v) gives
// half_b; beta = (-2 o, -2 tau o, tau, tau^2) against (c, v, 2 c.v, |v|^2)
// gives c_term, each started from its ray-only term (-d.o, |o|^2).
struct RayCoef {
  float dx, dy, dz, tdx, tdy, tdz;
  float mox, moy, moz, mtox, mtoy, mtoz;
  float tau, tau2;
  float ndo, o2, a, tmin_a;
};

__device__ __forceinline__ RayCoef ray_coef(const Ray& r, const RayTerms& t) {
  RayCoef c;
  c.dx = r.dx;
  c.dy = r.dy;
  c.dz = r.dz;
  c.tdx = r.tau * r.dx;
  c.tdy = r.tau * r.dy;
  c.tdz = r.tau * r.dz;
  c.mox = -2.0f * r.ox;
  c.moy = -2.0f * r.oy;
  c.moz = -2.0f * r.oz;
  c.mtox = -2.0f * (r.tau * r.ox);
  c.mtoy = -2.0f * (r.tau * r.oy);
  c.mtoz = -2.0f * (r.tau * r.oz);
  c.tau = r.tau;
  c.tau2 = t.tau2;
  c.ndo = -t.d_dot_o;
  c.o2 = t.o2;
  c.a = t.a;
  c.tmin_a = t.tmin_a;
  return c;
}

// The sweep's square root: sqrt.approx (one MUFU.SQRT). The compiler then
// predicates the whole root test into every column instead of branching
// around it: more instructions a column, but no divergent branch and no
// convergence barrier, which measured faster on the card than the IEEE
// sqrtf, whose slow-path call keeps the root test behind a branch (PERF.md).
// The sweep only ranks columns; settle_winner recomputes the winner's q
// with IEEE sqrtf.
__device__ __forceinline__ float sqrt_approx(float x) {
  float y;
  asm("sqrt.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A column whose discriminant lies within kGraze |d|^2 c_term of zero is a
// grazing root (there half_b^2 and |d|^2 c_term cancel), which the two
// forms' rounding may accept or reject: the camera's rays past a sphere's
// silhouette were most of the rays whose winner the coefficient form
// changed. 2^-14 is about 1,000 float32 roundings of |d|^2 c_term, well
// above the two forms' difference for the camera's rays and for most
// secondary ones.
constexpr float kGraze = 1.0f / 16384.0f;
// The culled megakernel's wider band (kWide): a column whose discriminant
// lies within kGrazeWide |d|^2 (| |c|^2 - r^2 | + |o|^2) of zero, the
// magnitudes c_term cancels. Away from the origin (sphere_field's small
// spheres at |c| ~ 55) c_term is a difference of terms near |c|^2, so both
// forms round it by far more than 2^-14 |d|^2 c_term, and a hit or miss
// there is decided by rounding; the band flags those columns, and the last
// of them contests the winner in today's arithmetic (PERF.md §6 gives the
// culled path's items that differ from the plain version with each band).
constexpr float kGrazeWide = 1.0f / 524288.0f;

// Column j's discriminant in the coefficient form, its half_b, and whether
// the column is grazing.
template <bool kMotion, bool kWide = false, typename S>
__device__ __forceinline__ float coef_disc(const S& s, int j,
                                           const RayCoef& c, float& half_b,
                                           bool& grazing) {
  const float4 g = rec_c(s, j);
  float hb = __fmaf_rn(c.dx, g.x, c.ndo);
  hb = __fmaf_rn(c.dy, g.y, hb);
  hb = __fmaf_rn(c.dz, g.z, hb);
  float ct = __fadd_rn(g.w, c.o2);
  ct = __fmaf_rn(c.mox, g.x, ct);
  ct = __fmaf_rn(c.moy, g.y, ct);
  ct = __fmaf_rn(c.moz, g.z, ct);
  if (kMotion) {
    const float4 v = rec_v(s, j);
    const float vv = rec_vv(s, j);
    hb = __fmaf_rn(c.tdx, v.x, hb);
    hb = __fmaf_rn(c.tdy, v.y, hb);
    hb = __fmaf_rn(c.tdz, v.z, hb);
    ct = __fmaf_rn(c.mtox, v.x, ct);
    ct = __fmaf_rn(c.mtoy, v.y, ct);
    ct = __fmaf_rn(c.mtoz, v.z, ct);
    ct = __fmaf_rn(c.tau, v.w, ct);
    ct = __fmaf_rn(c.tau2, vv, ct);
  }
  half_b = hb;
  const float act = c.a * ct;
  const float disc = __fmaf_rn(hb, hb, -act);
  if (kWide)  // false where the magnitudes overflow (the padding columns)
    grazing = fabsf(disc) < kGrazeWide * (c.a * (fabsf(g.w) + c.o2));
  else
    grazing = fabsf(disc) < kGraze * act;  // false where act overflows
  return disc;
}

// Record j of `s`, reported as column `col`, into the sweep's state (below).
template <bool kMotion, bool kWide = false, typename S>
__device__ __forceinline__ void packed_column(const S& s, int j, int col,
                                              const RayCoef& c, float& qb,
                                              int& best, float& q2,
                                              int& second, int& graze) {
  float hb;
  bool grazing;
  const float disc = coef_disc<kMotion, kWide>(s, j, c, hb, grazing);
  if (grazing) graze = col;
  if (disc >= 0.0f) {
    const float rt = sqrt_approx(disc);
    const float q1 = hb - rt;
    const float qv = (q1 >= c.tmin_a) ? q1 : hb + rt;
    if (qv >= c.tmin_a && qv < q2) {
      if (qv < qb) {
        q2 = qb;
        second = best;
        qb = qv;
        best = col;
      } else {
        q2 = qv;
        second = col;
      }
    }
  }
}

// Nearest-hit sweep over the records [j0, j1) of `s`, reported as columns
// j + off: sweep_spheres' loop (a shrinking q_best, ties keep the earlier
// column) in the coefficient form, also keeping the runner-up (`second`,
// the column of the second smallest accepted q, and its q `q2`) and the last
// grazing column (`graze`), -1 where none, which settle_winner tests in
// today's arithmetic. The state carries from one range to the next, so a
// sweep over consecutive ranges (the culled and streamed blocks) finds what
// one sweep over their union finds: the lexicographically smallest two
// (q, column) pairs.
template <bool kMotion, bool kWide = false, typename S>
__device__ __forceinline__ void sweep_packed(const S& s, int j0, int j1,
                                             int off, const RayCoef& c,
                                             float& qb, int& best, float& q2,
                                             int& second, int& graze) {
#pragma unroll 8
  for (int j = j0; j < j1; ++j)
    packed_column<kMotion, kWide>(s, j, j + off, c, qb, best, q2, second,
                                  graze);
}

// The whole table of n packed columns.
template <bool kMotion>
__device__ __forceinline__ void sweep_packed(const PackedSpheres& s, int n,
                                             const RayCoef& c, float& qb,
                                             int& best, int& second,
                                             int& graze) {
  float q2 = kBig;
  sweep_packed<kMotion>(s, 0, n, 0, c, qb, best, q2, second, graze);
}

// Lane src's ray and its terms, broadcast to the warp.
__device__ __forceinline__ Ray shfl_ray(const Ray& r, int src) {
  constexpr unsigned kAll = 0xffffffffu;
  return Ray{__shfl_sync(kAll, r.ox, src), __shfl_sync(kAll, r.oy, src),
             __shfl_sync(kAll, r.oz, src), __shfl_sync(kAll, r.dx, src),
             __shfl_sync(kAll, r.dy, src), __shfl_sync(kAll, r.dz, src),
             __shfl_sync(kAll, r.tau, src)};
}
__device__ __forceinline__ RayTerms shfl_terms(const RayTerms& t, int src) {
  constexpr unsigned kAll = 0xffffffffu;
  return RayTerms{__shfl_sync(kAll, t.a, src),
                  __shfl_sync(kAll, t.d_dot_o, src),
                  __shfl_sync(kAll, t.o2, src),
                  __shfl_sync(kAll, t.tmin_a, src),
                  __shfl_sync(kAll, t.tau2, src)};
}

// The warp's smallest (q, column) over the lanes' candidates, each lane's
// from its own columns lane, lane + 32, ... (col -1: none; an accepted q is
// >= t_min |d|^2 >= 0, so its bits order as its value, and + 0.0f turns a
// -0 into +0): the column, -1 where no lane has one, and in `qm` its q, read
// from its lane bit for bit (kBig where none). Warp-uniform call.
__device__ __forceinline__ int warp_min_column(float q, int col, float& qm) {
  constexpr unsigned kAll = 0xffffffffu;
  const unsigned key = col >= 0 ? __float_as_uint(q + 0.0f) : 0xffffffffu;
  const unsigned k = __reduce_min_sync(kAll, key);
  const unsigned j = __reduce_min_sync(
      kAll, key == k ? static_cast<unsigned>(col) : 0xffffffffu);
  const int jm = k == 0xffffffffu ? -1 : static_cast<int>(j);
  qm = __shfl_sync(kAll, q, jm & 31);
  if (jm < 0) qm = kBig;
  return jm;
}

// What a lane-split sweep gives lane src: the winner's q and column, the
// runner-up's column and the grazing column (-1 where none).
struct LaneWinners {
  float qb;
  int best, second, graze;
};

// sweep_packed over all n records, for each lane of `live` in turn, by the
// whole warp, a column per lane (warp-uniform call; the resident
// megakernel's drain, where few of a warp's lanes still trace). Lane src's
// ray is broadcast by shuffles and its coefficient vectors formed in every
// lane by ray_coef (the same bits); each lane runs packed_column, the
// sequential sweep's per-column code, over the columns lane, lane + 32, ...
// (interleaved 16-byte records: one LDS.128 a column reads 32 neighbouring
// records, free of bank conflicts); then warp reductions merge the lanes'
// states: the winner is the smallest (q, column) of the lanes' winners, the
// runner-up the smallest of the others' winners and the winner's lane's
// runner-up (the two lexicographically smallest pairs over all columns,
// which is what the sequential sweep keeps), the grazing column the
// largest of the lanes' (the sequential sweep's last). Lane src receives
// sweep_packed's qb, best, second and graze from qb = kBig, best = -1, bit
// for bit (its q2 is not kept); a lane not in `live` receives no winner.
// Not inlined: its registers (the broadcast coefficients, the records in
// flight) then leave the caller's per-lane sweep its own allocation, and
// the call's register saves fall on the drain's trips alone.
template <bool kMotion>
__device__ __noinline__ LaneWinners sweep_packed_lanes(PackedSpheres s,
                                                       int n, unsigned live,
                                                       Ray r, RayTerms t) {
  const int lane = threadIdx.x & 31;
  LaneWinners out{kBig, -1, -1, -1};
  while (live) {
    const int src = __ffs(live) - 1;
    live &= live - 1;
    const RayCoef c = ray_coef(shfl_ray(r, src), shfl_terms(t, src));
    float q1 = kBig, q2 = kBig;
    int b1 = -1, b2 = -1, g = -1;
#pragma unroll 4
    for (int j = lane; j < n; j += 32)
      packed_column<kMotion>(s, j, j, c, q1, b1, q2, b2, g);
    float qw;
    const int w = warp_min_column(q1, b1, qw);
    // the winner's lane offers its runner-up, the others their winners
    const bool won = w >= 0 && b1 == w;
    float qs;
    const int sc = warp_min_column(won ? q2 : q1, won ? b2 : b1, qs);
    const int gz = __reduce_max_sync(0xffffffffu, g);
    if (lane == src) out = LaneWinners{qw, w, sc, gz};
  }
  return out;
}

// Sphere j's centre at the ray's time and |c|^2 - r^2, from the packed
// records with sphere_at's expressions (the same values, so the same bits).
template <bool kMotion, typename S>
__device__ __forceinline__ void packed_at(const S& s, int j, const Ray& r,
                                          const RayTerms& t, float& cx,
                                          float& cy, float& cz,
                                          float& ccmr2) {
  const float4 g = rec_c(s, j);
  cx = g.x;
  cy = g.y;
  cz = g.z;
  ccmr2 = g.w;
  if (kMotion) {
    const float4 v = rec_v(s, j);
    const float vv = rec_vv(s, j);
    cx = cx + r.tau * v.x;
    cy = cy + r.tau * v.y;
    cz = cz + r.tau * v.z;
    ccmr2 = ccmr2 + v.w * r.tau + vv * t.tau2;
  }
}

// sweep_spheres' root test of packed column j: whether it accepts the
// column, the root q it takes and whether that is the first.
template <bool kMotion, typename S>
__device__ __forceinline__ bool sphere_root(const S& s, int j, const Ray& r,
                                            const RayTerms& t, float& q,
                                            bool& first) {
  float cx, cy, cz, ccmr2;
  packed_at<kMotion>(s, j, r, t, cx, cy, cz, ccmr2);
  const float half_b = r.dx * cx + r.dy * cy + r.dz * cz - t.d_dot_o;
  const float o_dot_c = r.ox * cx + r.oy * cy + r.oz * cz;
  const float c_term = ccmr2 - 2.0f * o_dot_c + t.o2;
  const float disc = half_b * half_b - t.a * c_term;
  if (!(disc >= 0.0f)) return false;
  const float rt = sqrtf(disc);
  const float q1 = half_b - rt;
  first = q1 >= t.tmin_a;
  q = first ? q1 : half_b + rt;
  return q >= t.tmin_a;
}

// sweep_spheres over the packed columns [j0, j1): its expressions, order
// and tie rule, so its winner and q are sweep_spheres' bit for bit.
// The columns are reported as j + off.
template <bool kMotion, typename S>
__device__ __forceinline__ void sweep_today(const S& s, int j0, int j1,
                                            const Ray& r, const RayTerms& t,
                                            float& qb, int& best,
                                            int off = 0) {
  for (int j = j0; j < j1; ++j) {
    float q;
    bool first;
    if (sphere_root<kMotion>(s, j, r, t, q, first) && q < qb) {
      qb = q;
      best = j + off;
    }
  }
}

// sweep_today over all n records from qb = kBig, best = -1, for each lane
// of `sweepers` in turn, by the whole warp, a column per lane (warp-uniform
// call): each lane tests the columns lane, lane + 32, ... with
// sweep_spheres' expressions against the broadcast ray, and the warp keeps
// the smallest q, then the lowest column: lane src receives sweep_today's
// winner and q bit for bit (`qb`, `best`; a lane not in `sweepers` kBig
// and -1). Not inlined, as sweep_packed_lanes.
template <bool kMotion>
__device__ __noinline__ LaneWinners sweep_today_lanes(PackedSpheres s, int n,
                                                      unsigned sweepers,
                                                      Ray r, RayTerms t) {
  const int lane = threadIdx.x & 31;
  LaneWinners out{kBig, -1, -1, -1};
  while (sweepers) {
    const int src = __ffs(sweepers) - 1;
    sweepers &= sweepers - 1;
    const Ray rs = shfl_ray(r, src);
    const RayTerms ts = shfl_terms(t, src);
    float q = kBig;
    int b = -1;
    for (int j = lane; j < n; j += 32) {
      float qv;
      bool first;
      if (sphere_root<kMotion>(s, j, rs, ts, qv, first) && qv < q) {
        q = qv;
        b = j;
      }
    }
    float qm;
    const int jm = warp_min_column(q, b, qm);
    if (lane == src) {
      out.qb = qm;
      out.best = jm;
    }
  }
  return out;
}

// Column j against the winner (q_best, best) in today's arithmetic: it
// wins where sweep_spheres would have preferred it (a smaller q, or the
// same q and an earlier column).
template <bool kMotion, typename S>
__device__ __forceinline__ void contest(const S& s, int j, const Ray& r,
                                        const RayTerms& t, float& qb,
                                        int& best) {
  float q;
  bool first;
  if (j >= 0 && j != best && sphere_root<kMotion>(s, j, r, t, q, first) &&
      (q < qb || (q == qb && j < best))) {
    qb = q;
    best = j;
  }
}

// Settle sweep_packed's winner in today's arithmetic (see above): q_best
// becomes sweep_spheres' q of the same column; where today's arithmetic
// rejects the column or takes its other root, the ray is swept again by
// sweep_today. Then three columns contest the winner in today's
// arithmetic: the runner-up (where the two are within rounding of each
// other, a near tie, the forms may rank them otherwise: where two
// overlapping spheres' surfaces cross, or the ground meets a sphere resting
// on it), the grazing column (`graze`; a column the forms' rounding may
// accept or reject), and `from`, the sphere the ray's origin lies on (-1
// if none): whether a ray re-hits the sphere it leaves (its self root lies
// at the rounding level of |c|^2 - r^2 - 2 o.c + |o|^2, near t_min at
// grazing exits) is decided by that rounding, which differs between the two
// forms; without this test the coefficient form changed a few percent of
// the flagship's recorded lane-iterations. Returns whether it swept again.
// `resweep(qb, best)` sweeps again in today's arithmetic from qb = kBig,
// best = -1: over every column for the resident kernels (settle_winner),
// behind today's bound tests for the culled and streamed megakernel.
template <bool kMotion, typename S, typename Resweep>
__device__ __forceinline__ bool settle_winner_by(const S& s, int from,
                                                 const Ray& r,
                                                 const RayTerms& t,
                                                 const RayCoef& c, float& qb,
                                                 int& best, int second,
                                                 int graze,
                                                 const Resweep& resweep) {
  if (best >= 0) {
    float hb, q;
    bool first;
    bool grazing;
    const float disc = coef_disc<kMotion>(s, best, c, hb, grazing);
    const bool first_c = hb - sqrt_approx(disc) >= c.tmin_a;
    if (!(sphere_root<kMotion>(s, best, r, t, q, first) &&
          first == first_c)) {
      qb = kBig;
      best = -1;
      resweep(qb, best);
      return true;
    }
    qb = q;
  }
  contest<kMotion>(s, second, r, t, qb, best);
  contest<kMotion>(s, graze, r, t, qb, best);
  contest<kMotion>(s, from, r, t, qb, best);
  return false;
}

// The resident kernels' form: the re-sweep covers all n packed columns.
template <bool kMotion>
__device__ __forceinline__ bool settle_winner(const PackedSpheres& s, int n,
                                              int from, const Ray& r,
                                              const RayTerms& t,
                                              const RayCoef& c, float& qb,
                                              int& best, int second,
                                              int graze) {
  return settle_winner_by<kMotion>(
      s, from, r, t, c, qb, best, second, graze,
      [&](float& q, int& b) { sweep_today<kMotion>(s, 0, n, r, t, q, b); });
}

// Work-counter slots beyond rz::Work's five (the [8] stats array): the
// re-sweeps of settle_winner, and the lane-trips of the queue kernels'
// warps (32 per loop trip of a warp that ran; the megakernel's and the
// resident bounce-indexed recorder's).
constexpr int kStatResweeps = 5;
constexpr int kStatLaneTrips = 6;

// Triangle sweep over columns [j0, j1) after the spheres, sharing q_best:
// plane test, then dual-basis barycentrics on the hit point. Double-sided;
// a parallel ray (n.d = 0) and the poisoned padding columns (g1.v0 = +BIG)
// reject themselves.
__device__ __forceinline__ void sweep_triangles(const float* __restrict__ tab,
                                                int stride, int j0, int j1,
                                                const Ray& r,
                                                const RayTerms& t, float& qb,
                                                int& best, bool& is_tri) {
  const int m = stride;
#pragma unroll 8
  for (int j = j0; j < j1; ++j) {
    const float tnx = tab[kTNX * m + j];
    const float tny = tab[kTNY * m + j];
    const float tnz = tab[kTNZ * m + j];
    const float ndd = r.dx * tnx + r.dy * tny + r.dz * tnz;
    const float ndo = r.ox * tnx + r.oy * tny + r.oz * tnz;
    const float rcp = 1.0f / ndd;
    const float tt = (tab[kTNV0 * m + j] - ndo) * rcp;
    const float qv = tt * t.a;
    if (qv >= t.tmin_a && qv < qb) {
      const float hx = r.ox + tt * r.dx;
      const float hy = r.oy + tt * r.dy;
      const float hz = r.oz + tt * r.dz;
      const float u = tab[kTG1X * m + j] * hx + tab[kTG1Y * m + j] * hy +
                      tab[kTG1Z * m + j] * hz - tab[kTG1V * m + j];
      const float v = tab[kTG2X * m + j] * hx + tab[kTG2Y * m + j] * hy +
                      tab[kTG2Z * m + j] * hz - tab[kTG2V * m + j];
      if (u >= 0.0f && v >= 0.0f && u + v <= 1.0f) {
        qb = qv;
        best = j;
        is_tri = true;
      }
    }
  }
}

// The whole triangle table of m columns.
__device__ __forceinline__ void sweep_triangles(const float* __restrict__ tab,
                                                int m, const Ray& r,
                                                const RayTerms& t, float& qb,
                                                int& best, bool& is_tri) {
  sweep_triangles(tab, m, 0, m, r, t, qb, best, is_tri);
}

// Bounding-sphere test of one culling block, chunk or supercluster: column
// i of a [4, stride] bound table (centre xyz, |c|^2 - r^2, the row form of
// a sphere). True when the segment [t_min, q_best) of the ray may enter
// the sphere: the nearer root below q_best and the farther at or past
// t_min. A miss gives a NaN root, which compares false, and a bound with
// no valid member (|c|^2 - r^2 = +BIG) never passes. Conservative: a
// primitive inside can only win if its bound passes.
__device__ __forceinline__ bool bound_possible(const float* __restrict__ rows,
                                               int stride, int i,
                                               const Ray& r,
                                               const RayTerms& t, float qb) {
  const float bx = rows[i];
  const float by = rows[stride + i];
  const float bz = rows[2 * stride + i];
  const float ccb = rows[3 * stride + i];
  const float hb = r.dx * bx + r.dy * by + r.dz * bz - t.d_dot_o;
  const float ob = r.ox * bx + r.oy * by + r.oz * bz;
  const float disc = hb * hb - t.a * (ccb - 2.0f * ob + t.o2);
  const float rtb = sqrtf(disc);
  return ccb < kBig && hb - rtb < qb && hb + rtb >= t.tmin_a;
}

// Bound i of a [4, stride] bound table as one record (centre, |c|^2 -
// r^2).
__device__ __forceinline__ float4 bound_rec(const float* __restrict__ rows,
                                            int stride, int i) {
  return make_float4(rows[i], rows[stride + i], rows[2 * stride + i],
                     rows[3 * stride + i]);
}

// bound_possible on a bound record, with a miss decided before the square
// root: a negative (or NaN) discriminant fails there as it fails
// bound_possible's NaN compares after sqrtf, so every decision is
// bound_possible's, without the IEEE square root's slow path, which a
// negative argument takes (most bound tests miss).
__device__ __forceinline__ bool bound_test(const float4& b, const Ray& r,
                                           const RayTerms& t, float qb) {
  const float hb = r.dx * b.x + r.dy * b.y + r.dz * b.z - t.d_dot_o;
  const float ob = r.ox * b.x + r.oy * b.y + r.oz * b.z;
  const float disc = hb * hb - t.a * (b.w - 2.0f * ob + t.o2);
  if (!(disc >= 0.0f)) return false;
  const float rtb = sqrtf(disc);
  return b.w < kBig && hb - rtb < qb && hb + rtb >= t.tmin_a;
}

// What one bounce does at a hit: the new direction and the attenuation, or
// absorption (ok = false).
struct Scatter {
  float dx, dy, dz;
  float ar, ag, ab;
  bool ok;
};

// The random numbers a scatter consumes, from one of two sources. Both give
// the same three values: a uniform unit vector (draws 5-6), the cube root of
// a uniform (draw 7, the diffuse ball radius) and the Schlick coin (draw 8).
// KeyDraws hashes them from the slot's step key when the scatter asks, so a
// material draws only what it uses (the dielectric draw 8, the metal 5-6,
// the diffuse 5-7). GivenDraws hands back values the caller read from memory
// (the bounce-indexed recorder's [depth, 5, R] block); the same values give
// the same rounding downstream.
struct KeyDraws {
  uint32_t key;
  __device__ __forceinline__ void unit(float& x, float& y, float& z) const {
    unit3(uniform(draw_bits(key, 5)), uniform(draw_bits(key, 6)), x, y, z);
  }
  __device__ __forceinline__ float cube_root() const {
    return expf(logf(clamp_min(uniform(draw_bits(key, 7)), 1e-24f)) *
                (1.0f / 3.0f));
  }
  __device__ __forceinline__ float coin() const {
    return uniform(draw_bits(key, 8));
  }
};

struct GivenDraws {
  float ux, uy, uz, cb, us;
  __device__ __forceinline__ void unit(float& x, float& y, float& z) const {
    x = ux;
    y = uy;
    z = uz;
  }
  __device__ __forceinline__ float cube_root() const { return cb; }
  __device__ __forceinline__ float coin() const { return us; }
};

// Material scatter at hit point p with unit normal n (already flipped to
// oppose the ray). `mat` points at the winner's packed-kind row in its
// table (row stride `stride`): packed kind/method/fuzz, ior-or-scale, even
// rgb, odd rgb. `dr` supplies the random numbers (KeyDraws or GivenDraws).
template <typename Draws>
__device__ __forceinline__ Scatter scatter(const float* __restrict__ mat,
                                           int stride, const Ray& r,
                                           float dinv, float px, float py,
                                           float pz, float nx, float ny,
                                           float nz, bool front,
                                           const Draws& dr) {
  const float bpk = mat[0];
  const float bios = mat[stride];
  const float bkm = floorf(bpk * 0.25f);
  const float bfz = (bpk - 4.0f * bkm) * 0.5f;
  const float kind = floorf(bkm * 0.25f);
  const float method = bkm - 4.0f * kind;

  Scatter s;
  if (kind == kDielectric) {
    const float eta = front ? 1.0f / bios : bios;
    const float udx = r.dx * dinv;
    const float udy = r.dy * dinv;
    const float udz = r.dz * dinv;
    const float cos_t = -(udx * nx + udy * ny + udz * nz);
    const float sin_t = sqrtf(clamp_min(1.0f - cos_t * cos_t, 0.0f));
    const bool cannot = eta * sin_t > 1.0f;
    float r0 = (1.0f - eta) / (1.0f + eta);
    r0 = r0 * r0;
    const float om = 1.0f - cos_t;
    const float om2 = om * om;
    const float refl_p = r0 + (1.0f - r0) * om2 * om2 * om;
    if (cannot || refl_p > dr.coin()) {
      // reflect uses the NON-unit incoming direction (reference quirk)
      const float two_ndd = 2.0f * (r.dx * nx + r.dy * ny + r.dz * nz);
      s.dx = r.dx - two_ndd * nx;
      s.dy = r.dy - two_ndd * ny;
      s.dz = r.dz - two_ndd * nz;
    } else {
      const float ppx = (udx + cos_t * nx) * eta;
      const float ppy = (udy + cos_t * ny) * eta;
      const float ppz = (udz + cos_t * nz) * eta;
      const float parm =
          -sqrtf(clamp_min(1.0f - (ppx * ppx + ppy * ppy + ppz * ppz), 0.0f));
      s.dx = ppx + parm * nx;
      s.dy = ppy + parm * ny;
      s.dz = ppz + parm * nz;
    }
    s.ar = 1.0f;
    s.ag = 1.0f;
    s.ab = 1.0f;
    s.ok = s.dx * s.dx + s.dy * s.dy + s.dz * s.dz > 1e-20f;
    return s;
  }

  float ux, uy, uz;
  dr.unit(ux, uy, uz);

  // checker albedo: floor-parity of p / scale picks even or odd (a solid
  // texture has even == odd and scale 1)
  const float isc = 1.0f / bios;
  const float par = floorf(px * isc) + floorf(py * isc) + floorf(pz * isc);
  const bool even_par = par - 2.0f * floorf(par * 0.5f) < 0.5f;
  const int c = even_par ? 2 : 5;
  s.ar = mat[c * stride];
  s.ag = mat[(c + 1) * stride];
  s.ab = mat[(c + 2) * stride];

  if (kind == kMetallic) {
    const float two_ndd = 2.0f * (r.dx * nx + r.dy * ny + r.dz * nz);
    const float rfx = r.dx - two_ndd * nx;
    const float rfy = r.dy - two_ndd * ny;
    const float rfz = r.dz - two_ndd * nz;
    const float rinv =
        1.0f / sqrtf(clamp_min(rfx * rfx + rfy * rfy + rfz * rfz, 1e-24f));
    const float fz = clamp_max(bfz, 1.0f);
    s.dx = rfx * rinv + fz * ux;
    s.dy = rfy * rinv + fz * uy;
    s.dz = rfz * rinv + fz * uz;
    const bool metal_ok = s.dx * nx + s.dy * ny + s.dz * nz > 0.0f;
    s.ok = metal_ok && s.dx * s.dx + s.dy * s.dy + s.dz * s.dz > 1e-20f;
    return s;
  }

  // diffuse: u^(1/3) via exp/log puts the sample inside the unit ball
  const float cb = dr.cube_root();
  const float sx = ux * cb;
  const float sy = uy * cb;
  const float sz = uz * cb;
  float offx, offy, offz;
  if (method == 0.0f) {  // UNIT_SPHERE
    offx = nx + sx;
    offy = ny + sy;
    offz = nz + sz;
  } else if (method == 1.0f) {  // UNIT_SPHERE_SURFACE
    offx = nx + ux;
    offy = ny + uy;
    offz = nz + uz;
  } else {  // HEMISPHERE
    const float flip = (sx * nx + sy * ny + sz * nz > 0.0f) ? 1.0f : -1.0f;
    offx = sx * flip;
    offy = sy * flip;
    offz = sz * flip;
  }
  // reference quirk: the near-zero check is on the target POINT; a
  // near-origin target snaps to the bare normal
  float tgx = px + offx;
  float tgy = py + offy;
  float tgz = pz + offz;
  if (fabsf(tgx) <= 1e-8f && fabsf(tgy) <= 1e-8f && fabsf(tgz) <= 1e-8f) {
    tgx = nx;
    tgy = ny;
    tgz = nz;
  }
  s.dx = tgx - px;
  s.dy = tgy - py;
  s.dz = tgz - pz;
  s.ok = s.dx * s.dx + s.dy * s.dy + s.dz * s.dz > 1e-20f;
  return s;
}

// Camera ray of a pixel's next sample (draws 0-4 under `key`): +-0.5 px
// jitter, polar defocus-disk origin and a time in [0, 1) when `jitter`;
// otherwise the pixel centre from the lens centre at time 0. `cam` is the
// [18] camera vector.
__device__ __forceinline__ void camera_ray(const float* __restrict__ cam,
                                           float pxf, float pyf, bool jitter,
                                           uint32_t key, Ray& r) {
  float x = pxf, y = pyf;
  float nox = cam[0], noy = cam[1], noz = cam[2];
  float ntau = 0.0f;
  if (jitter) {
    x = pxf + uniform(draw_bits(key, 0)) - 0.5f;
    y = pyf + uniform(draw_bits(key, 1)) - 0.5f;
    const float rr = sqrtf(uniform(draw_bits(key, 2)));
    const float th = kTwoPi * uniform(draw_bits(key, 3));
    const float ca = cosf(th);
    const float sa = sinf(th);
    nox = cam[0] + rr * (ca * cam[12] + sa * cam[15]);
    noy = cam[1] + rr * (ca * cam[13] + sa * cam[16]);
    noz = cam[2] + rr * (ca * cam[14] + sa * cam[17]);
    ntau = uniform(draw_bits(key, 4));
  }
  r.dx = x * cam[3] + y * cam[6] + cam[9] - nox;
  r.dy = x * cam[4] + y * cam[7] + cam[10] - noy;
  r.dz = x * cam[5] + y * cam[8] + cam[11] - noz;
  r.ox = nox;
  r.oy = noy;
  r.oz = noz;
  r.tau = ntau;
}

// What one bounce did to a path.
enum class Bounce { kMiss, kAbsorbed, kContinued };

// One bounce after the nearest-hit sweep found (qb, best, is_tri) in the
// tables `sph` [17, n_pad] and `tri` [20, m_pad]: on a miss the sky,
// weighted by the throughput, joins the radiance; on a hit the hit point,
// the unit normal turned against the ray and the material scatter (random
// numbers from `dr`) give the next ray and throughput, unless the surface
// absorbs the path. The caller applies its depth rule to kContinued.
template <bool kMotion, typename Draws>
__device__ __forceinline__ Bounce shade(
    const float* __restrict__ sph, int n_pad, const float* __restrict__ tri,
    int m_pad, Ray& r, const RayTerms& t, float qb, int best, bool is_tri,
    const Draws& dr, float& thx, float& thy, float& thz, float& ar,
    float& ag, float& ab) {
  const float dinv = 1.0f / sqrtf(clamp_min(t.a, 1e-24f));
  if (!(qb < kBig)) {
    // miss: sky weighted by throughput, (white * (1 - t) + blue) * t
    const float sky_t = 0.5f * (r.dy * dinv + 1.0f);
    ar = ar + thx * ((1.0f - sky_t + 0.5f) * sky_t);
    ag = ag + thy * ((1.0f - sky_t + 0.7f) * sky_t);
    ab = ab + thz * ((1.0f - sky_t + 1.0f) * sky_t);
    return Bounce::kMiss;
  }

  const float ts = qb * (1.0f / t.a);
  const float px = r.ox + ts * r.dx;
  const float py = r.oy + ts * r.dy;
  const float pz = r.oz + ts * r.dz;
  float nx, ny, nz;
  const float* mat;
  int stride;
  if (is_tri) {
    nx = tri[kTNX * m_pad + best];
    ny = tri[kTNY * m_pad + best];
    nz = tri[kTNZ * m_pad + best];
    mat = tri + kTPKF * m_pad + best;
    stride = m_pad;
  } else {
    float cx, cy, cz, ccmr2;
    sphere_at<kMotion>(sph, n_pad, best, r, t, cx, cy, cz, ccmr2);
    nx = px - cx;
    ny = py - cy;
    nz = pz - cz;
    mat = sph + kPKF * n_pad + best;
    stride = n_pad;
  }
  const float ninv =
      1.0f / sqrtf(clamp_min(nx * nx + ny * ny + nz * nz, 1e-24f));
  nx = nx * ninv;
  ny = ny * ninv;
  nz = nz * ninv;
  const bool front = nx * r.dx + ny * r.dy + nz * r.dz < 0.0f;
  const float sgn = front ? 1.0f : -1.0f;
  nx = nx * sgn;
  ny = ny * sgn;
  nz = nz * sgn;

  const Scatter s =
      scatter(mat, stride, r, dinv, px, py, pz, nx, ny, nz, front, dr);
  if (!s.ok) return Bounce::kAbsorbed;
  thx = thx * s.ar;
  thy = thy * s.ag;
  thz = thz * s.ab;
  r.ox = px;
  r.oy = py;
  r.oz = pz;
  r.dx = s.dx;
  r.dy = s.dy;
  r.dz = s.dz;
  return Bounce::kContinued;
}

// Work counters of the culled and streamed kernels (per thread, summed
// per warp into the [8] device array the wrapper passes): ray segments
// traced, primitive columns tested, bound tests, and the tile-level votes
// on chunks (blocks where there are no chunks) and how many passed.
struct Work {
  unsigned int segments = 0, prims = 0, bounds = 0, votes = 0, passed = 0;
};

__device__ __forceinline__ void flush_work(const Work& w,
                                           unsigned long long* stats) {
  const unsigned int mask = __activemask();
  const unsigned int v[5] = {w.segments, w.prims, w.bounds, w.votes,
                             w.passed};
  const bool lead = (threadIdx.x & 31) == __ffs(mask) - 1;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const unsigned int sum = __reduce_add_sync(mask, v[k]);
    if (lead && sum) atomicAdd(stats + k, static_cast<unsigned long long>(sum));
  }
}

// Blocks [b0, b1) of one class, each swept only if the ray's own bound
// test passes.
template <bool kMotion, bool kTri>
__device__ __forceinline__ void sweep_blocks(
    const float* __restrict__ tab, int stride,
    const float* __restrict__ brows, int nb, int blk, int b0, int b1,
    const rz::Ray& r, const rz::RayTerms& t, float& qb, int& best,
    bool& is_tri, rz::Work& w) {
  for (int b = b0; b < b1; ++b) {
    ++w.bounds;
    if (!rz::bound_possible(brows, nb, b, r, t, qb)) continue;
    w.prims += blk;
    if (kTri)
      rz::sweep_triangles(tab, stride, b * blk, (b + 1) * blk, r, t, qb, best,
                          is_tri);
    else
      rz::sweep_spheres<kMotion>(tab, stride, b * blk, (b + 1) * blk, r, t,
                                 qb, best);
  }
}

// One class of a streamed table: the chunk bound first (rows in shared
// memory), then the chunk's blocks, or all its columns when blk = 0.
template <bool kMotion, bool kTri>
__device__ __forceinline__ void sweep_chunks(
    const float* __restrict__ tab, int n, const float* __restrict__ cb,
    const float* __restrict__ brows, int stream, int blk, bool cull,
    const rz::Ray& r, const rz::RayTerms& t, float& qb, int& best,
    bool& is_tri, rz::Work& w) {
  const int nc = n / stream;
  for (int c = 0; c < nc; ++c) {
    if (cull) {
      ++w.votes;
      if (!rz::bound_possible(cb, nc, c, r, t, qb)) continue;
      ++w.passed;
    }
    if (blk) {
      const int per = stream / blk;
      sweep_blocks<kMotion, kTri>(tab, n, brows, n / blk, blk, c * per,
                                  (c + 1) * per, r, t, qb, best, is_tri, w);
    } else {
      w.prims += stream;
      if (kTri)
        rz::sweep_triangles(tab, n, c * stream, (c + 1) * stream, r, t, qb,
                            best, is_tri);
      else
        rz::sweep_spheres<kMotion>(tab, n, c * stream, (c + 1) * stream, r,
                                   t, qb, best);
    }
  }
}

}  // namespace rz
