// Fused replay of a persistent-path recording, and its adjoint, for Hopper
// (sm_90a).
//
// Replace the TPU kernels rayz_tpu/ops/pathrec.py:_fused_fwd_kernel and
// _fused_bwd_kernel (launched there by _fused_replay_fwd_impl and
// _fused_replay_vjp_bwd). The recorder (record_pp.cu) fixed every path's
// control: per iteration and slot the winner index (-1 a recorded miss, -2
// an idle slot) and 13 aux rows (scatter randoms, spawned ray, spawn +
// 2 * continue flag). The replay re-derives every value of those paths from
// the winner rows, which gather.cu gathered once for all iterations, so
// gradients reach the scene's parameters.
//
// Forward (replay_fwd_kernel): one thread owns one slot and loops over the
// K iterations with the 10-float carry (origin, direction, time, throughput)
// and the radiance sum in registers. Each live iteration writes the carry it
// entered with to st_entry for the backward, respawns from the recorded ray
// on a spawn, adds throughput * sky on a recorded miss, and on a recorded
// continue re-derives the hit point, normal, scatter direction and
// attenuation (the step of ops/pathrec.py:_pp_step, term for term). At the
// end it writes the radiance and the final carry (a compacted pass resumes
// from it).
//
// Backward (replay_bwd_kernel): one thread per slot walks the iterations in
// reverse with the carry's cotangent in registers, starting from the final
// carry's. A live iteration reloads its entry carry, row and aux, recomputes
// the step's intermediates and applies a hand-derived adjoint of the step
// (the TPU kernel calls jax.vjp inside the kernel; there is no autograd
// here). It writes the 20 row cotangents of the iteration (gather.cu's
// backward adds them into the table) and passes the carry's cotangent on;
// at the end it writes the initial carry's.
//
// Idle slots. The TPU skips a 2,048-lane tile-iteration when no lane in it
// is live. Here a thread skips its own idle iterations (index -2): the
// recorder writes -2 only where a slot neither spawns nor continues, with
// flag 0, and such a step leaves the carry and the radiance as they are. An
// idle iteration writes no entry carry; the backward writes zero row
// cotangents for it and passes the carry's cotangent through.
//
// Rules of the adjoint, which follows JAX's derivatives of the step:
// - a select sends the cotangent to the branch taken only: the code
//   branches instead of multiplying by masks, so a branch not taken (whose
//   partials may be infinite on a miss lane's all-zero row) never enters;
// - comparisons, floors (checker parity), the recorded flags and the aux
//   randoms get no gradient;
// - max(x, c) and min(x, c) pass the gradient on their x side, and half of
//   it at a tie (jnp.maximum / jnp.minimum): fuzz == 1 exactly gives 0.5;
// - safe_sqrt has a zero gradient at x <= 0;
// - a spawn replaces origin, direction, time and throughput, so their
//   incoming cotangents are zero.
//
// What bounds it on the H100: device-memory traffic. Per live slot and
// iteration the forward reads the index and up to 13 aux words and writes 10
// entry-carry words, and a continuing slot reads its 20 row words; the
// backward reads them again and writes 20 row cotangents. Every access is
// coalesced (neighbouring threads, neighbouring slots). The backward's
// recompute and adjoint keep ~100 floats live, so registers bound its
// occupancy (ptxas.log). Rows, aux and carries are [component, K * R]
// planes of up to 20 * 29.4 M floats at the flagship's first pass, so all
// offsets are 64-bit.
//
// Numerics: the build passes -fmad=false and no fast-math, so each
// operation rounds as the plain torch version's does; 1/sqrt is rsqrtf,
// the instruction torch.rsqrt uses on the card.
//
// C interface for ctypes (see ops/_build.py): each entry returns the
// launch's cudaError_t.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kRowCols = 20;  // winner row (ops/diffkernel.py _diff_tables)
// the carry: ox oy oz dx dy dz tau thx thy thz (struct Carry)
// aux rows (twin: ops/pathrec.py _AUX_*)
constexpr int kAuxUX = 0, kAuxCB = 3, kAuxUS = 4;
constexpr int kAuxOX = 5, kAuxDX = 8, kAuxTau = 11, kAuxFlg = 12;
constexpr int kAuxRows = 13;
constexpr float kDielectric = 2.0f, kMetallic = 1.0f;
constexpr float kUnitSphere = 0.0f, kUnitSphereSurface = 1.0f;

struct Params {
  const float* rows;      // [20, K * R] winner rows, iteration t at t * R
  const float* aux;       // [K, 13, R]
  const int* idx;         // [K, R]
  const float* st0;       // [10, R] initial carry (forward)
  const float* st_entry;  // [10, K, R] entry carries (backward input)
  const float* g_out;     // [3, R] radiance cotangent (backward)
  const float* g_fin;     // [10, R] final-carry cotangent (backward)
  float* out;             // [3, R] radiance sums (forward)
  float* fin;             // [10, R] final carry (forward)
  float* st_save;         // [10, K, R] entry carries (forward output)
  float* drows;           // [20, K * R] row cotangents (backward)
  float* dst0;            // [10, R] initial-carry cotangent (backward)
  int64_t k_it, r;
  int n_sph_pad;  // sphere rows of the table; triangle rows follow
  bool with_sph, with_tri, has_motion;
  float t_min;
};

// ---- small vector algebra, associating as the plain version does ----

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 operator+(V3 a, V3 b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V3 operator-(V3 a, V3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 operator*(float s, V3 a) {
  return {s * a.x, s * a.y, s * a.z};
}
__device__ __forceinline__ V3 mul(V3 a, V3 b) {
  return {a.x * b.x, a.y * b.y, a.z * b.z};
}
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}

// max / min with JAX's values and tie rule (d/dx = 1/2 at x == c)
__device__ __forceinline__ float vmax(float x, float c) {
  return x > c ? x : c;
}
__device__ __forceinline__ float vmin(float x, float c) {
  return x < c ? x : c;
}
__device__ __forceinline__ float dmax(float x, float c) {
  return x > c ? 1.0f : (x == c ? 0.5f : 0.0f);
}
__device__ __forceinline__ float dmin(float x, float c) {
  return x < c ? 1.0f : (x == c ? 0.5f : 0.0f);
}

__device__ __forceinline__ float safe_sqrt(float x) {
  return x > 0.0f ? sqrtf(x) : 0.0f;
}

// r = rsqrt(max(x, floor)) and the cotangent of x given r's:
// dr/dx = -r^3 / 2 above the floor
__device__ __forceinline__ float rsqrt_floor(float x, float floor) {
  return rsqrtf(vmax(x, floor));
}
__device__ __forceinline__ float rsqrt_floor_vjp(float g, float x, float r,
                                                 float floor) {
  return dmax(x, floor) * (g * (-0.5f * r * r * r));
}

// ---- loads ----

struct Carry {
  V3 o, d;
  float tau;
  V3 th;
};

__device__ __forceinline__ Carry load_carry(const float* st, int64_t stride,
                                            int64_t off) {
  Carry c;
  c.o = {st[off], st[stride + off], st[2 * stride + off]};
  c.d = {st[3 * stride + off], st[4 * stride + off], st[5 * stride + off]};
  c.tau = st[6 * stride + off];
  c.th = {st[7 * stride + off], st[8 * stride + off], st[9 * stride + off]};
  return c;
}

__device__ __forceinline__ void store_carry(float* st, int64_t stride,
                                            int64_t off, const Carry& c) {
  st[off] = c.o.x;
  st[stride + off] = c.o.y;
  st[2 * stride + off] = c.o.z;
  st[3 * stride + off] = c.d.x;
  st[4 * stride + off] = c.d.y;
  st[5 * stride + off] = c.d.z;
  st[6 * stride + off] = c.tau;
  st[7 * stride + off] = c.th.x;
  st[8 * stride + off] = c.th.y;
  st[9 * stride + off] = c.th.z;
}

// Iteration t of slot s: the entry carry after the recorded respawn, and
// the recorded flags; `at` is (t * 13) * R + s, aux row 0 of the slot.
__device__ __forceinline__ void respawn(const Params& p, int64_t at,
                                        Carry& c, bool& spawn, bool& cont) {
  const float flg = p.aux[at + kAuxFlg * p.r];
  spawn = flg - 2.0f * floorf(flg * 0.5f) >= 0.5f;
  cont = flg >= 2.0f;
  if (spawn) {
    c.o = {p.aux[at + kAuxOX * p.r], p.aux[at + (kAuxOX + 1) * p.r],
           p.aux[at + (kAuxOX + 2) * p.r]};
    c.d = {p.aux[at + kAuxDX * p.r], p.aux[at + (kAuxDX + 1) * p.r],
           p.aux[at + (kAuxDX + 2) * p.r]};
    c.tau = p.aux[at + kAuxTau * p.r];
    c.th = {1.0f, 1.0f, 1.0f};
  }
}

// ---- the bounce of a continuing slot ----

// Forward values of one bounce that its adjoint reads again.
struct Bounce {
  bool tri, hit;
  float a;  // |d|^2
  // sphere
  V3 c, co;
  float rad, half_b, c_term, disc, rt, q;
  bool first;  // the nearer root was taken
  // triangle
  V3 v0, e1, e2, pn;
  float ndd, ndd_safe, num;
  // hit frame
  float ts;
  V3 p, nraw;
  float nn, ninv;
  V3 nu;  // unit normal before the flip
  float sgn;
  bool front;
  V3 n;
  // material
  float fuzz, ior, eta;
  bool is_d, is_m, even;
  V3 u;
  bool m01, nz_tgt;  // diffuse: offset through n; target snapped to n
  float ddn;
  V3 rf;  // mirror direction (metal; dielectric reflect)
  float rr, rinv;
  float dinv;
  V3 ud;
  float cos_t;
  bool do_refl;
  V3 pp;
  float x_parm, parm;
  V3 ndir, at;
};

__device__ __forceinline__ void reflect(Bounce& b, V3 d) {
  b.ddn = dot(d, b.n);
  b.rf = d - (2.0f * b.ddn) * b.n;
}

// Re-derive the bounce of slot state `s` (after respawn) off winner row w.
__device__ __forceinline__ void bounce_forward(const Params& p,
                                               const float* w, const Carry& s,
                                               V3 u, float cb, float us,
                                               bool hit, bool tri,
                                               Bounce& b) {
  const V3 o = s.o, d = s.d;
  b.tri = tri;
  b.hit = hit;
  b.a = dot(d, d);
  float t_hit;
  if (!tri) {
    b.c = {w[0], w[1], w[2]};
    if (p.has_motion) b.c = b.c + s.tau * V3{w[3], w[4], w[5]};
    b.rad = w[6];
    b.co = b.c - o;
    b.half_b = dot(d, b.co);
    b.c_term = dot(b.co, b.co) - b.rad * b.rad;
    b.disc = b.half_b * b.half_b - b.a * b.c_term;
    b.rt = safe_sqrt(b.disc);
    const float q1 = b.half_b - b.rt;
    const float q2 = b.half_b + b.rt;
    b.first = q1 >= p.t_min * b.a;
    b.q = b.first ? q1 : q2;
    t_hit = b.q / b.a;
  } else {
    b.v0 = {w[0], w[1], w[2]};
    b.e1 = V3{w[3], w[4], w[5]} - b.v0;
    b.e2 = V3{w[6], w[7], w[8]} - b.v0;
    b.pn = cross(b.e1, b.e2);
    b.ndd = dot(b.pn, d);
    b.ndd_safe = fabsf(b.ndd) > 0.0f ? b.ndd : 1.0f;
    b.num = dot(b.pn, b.v0 - o);
    t_hit = b.num / b.ndd_safe;
  }
  b.ts = hit ? t_hit : 1.0f;
  b.p = o + b.ts * d;
  b.nraw = tri ? b.pn : b.p - b.c;
  b.nn = dot(b.nraw, b.nraw);
  b.ninv = rsqrt_floor(b.nn, 1e-24f);
  b.nu = b.ninv * b.nraw;
  b.front = dot(b.nu, d) < 0.0f;
  b.sgn = b.front ? 1.0f : -1.0f;
  b.n = b.sgn * b.nu;

  const float kind = w[9];
  const float method = w[10];
  b.fuzz = w[11];
  b.ior = vmax(w[12], 1e-6f);
  const float isc = 1.0f / vmax(w[13], 1e-6f);
  const float par =
      floorf(b.p.x * isc) + floorf(b.p.y * isc) + floorf(b.p.z * isc);
  b.even = par - 2.0f * floorf(par * 0.5f) < 0.5f;
  b.at = b.even ? V3{w[14], w[15], w[16]} : V3{w[17], w[18], w[19]};
  b.is_d = kind == kDielectric;
  b.is_m = kind == kMetallic;
  b.u = u;
  b.dinv = rsqrt_floor(b.a, 1e-24f);

  if (b.is_d) {
    b.at = {1.0f, 1.0f, 1.0f};
    b.eta = b.front ? 1.0f / b.ior : b.ior;
    b.ud = b.dinv * d;
    b.cos_t = -dot(b.ud, b.n);
    const float sin_t = safe_sqrt(1.0f - b.cos_t * b.cos_t);
    const bool cannot = b.eta * sin_t > 1.0f;
    float r0 = (1.0f - b.eta) / (1.0f + b.eta);
    r0 = r0 * r0;
    const float om = 1.0f - b.cos_t;
    const float om2 = om * om;
    const float refl_p = r0 + (1.0f - r0) * om2 * om2 * om;
    b.do_refl = cannot || refl_p > us;
    if (b.do_refl) {
      // reflect uses the NON-unit incoming direction (reference quirk)
      reflect(b, d);
      b.ndir = b.rf;
    } else {
      b.pp = b.eta * (b.ud + b.cos_t * b.n);
      b.x_parm = 1.0f - dot(b.pp, b.pp);
      b.parm = -safe_sqrt(b.x_parm);
      b.ndir = b.pp + b.parm * b.n;
    }
  } else if (b.is_m) {
    reflect(b, d);
    b.rr = dot(b.rf, b.rf);
    b.rinv = rsqrt_floor(b.rr, 1e-24f);
    b.ndir = b.rinv * b.rf + vmin(b.fuzz, 1.0f) * u;
  } else {
    const V3 s3 = cb * u;
    V3 off;
    b.m01 = method == kUnitSphere || method == kUnitSphereSurface;
    if (method == kUnitSphere) {
      off = b.n + s3;
    } else if (method == kUnitSphereSurface) {
      off = b.n + u;
    } else {  // hemisphere
      off = (dot(s3, b.n) > 0.0f ? 1.0f : -1.0f) * s3;
    }
    V3 tg = b.p + off;
    // reference quirk: a near-origin target POINT snaps to the bare normal
    b.nz_tgt =
        fabsf(tg.x) <= 1e-8f && fabsf(tg.y) <= 1e-8f && fabsf(tg.z) <= 1e-8f;
    if (b.nz_tgt) tg = b.n;
    b.ndir = tg - b.p;
  }
}

// Adjoint of the bounce. Given the cotangents of the new origin (gp, of the
// hit point), direction (gdir, of the scatter direction) and attenuation
// (gat), accumulate into the slot state's (go, gd, gtau), into ga (of
// |d|^2) and into the row's gw[20].
__device__ __forceinline__ void bounce_adjoint(const Params& p,
                                               const float* w, const Carry& s,
                                               const Bounce& b, V3 gp,
                                               V3 gdir, V3 gat, V3& go,
                                               V3& gd, float& gtau, float& ga,
                                               float* gw) {
  const V3 d = s.d;
  V3 gn = {0.0f, 0.0f, 0.0f};  // of the flipped unit normal n

  // at = dielectric ? 1 : (even ? w[14:17] : w[17:20])
  if (!b.is_d && b.even) {
    gw[14] += gat.x;
    gw[15] += gat.y;
    gw[16] += gat.z;
  } else if (!b.is_d) {
    gw[17] += gat.x;
    gw[18] += gat.y;
    gw[19] += gat.z;
  }

  bool mirror = false;  // ndir went through rf = d - 2 (d.n) n
  V3 grf = {0.0f, 0.0f, 0.0f};
  if (b.is_d) {
    if (b.do_refl) {
      grf = gdir;
      mirror = true;
    } else {
      // ndir = pp + parm n
      V3 gpp = gdir;
      const float gparm = dot(gdir, b.n);
      gn = gn + b.parm * gdir;
      // parm = -safe_sqrt(x), x = 1 - pp.pp: zero gradient at x <= 0
      if (b.x_parm > 0.0f) {
        const float gx = -gparm * (0.5f / sqrtf(b.x_parm));
        gpp = gpp + (-2.0f * gx) * b.pp;
      }
      // pp = eta (ud + cos_t n)
      const V3 inner = b.ud + b.cos_t * b.n;
      const float geta = dot(gpp, inner);
      const V3 ginner = b.eta * gpp;
      V3 gud = ginner;
      const float gcos = dot(ginner, b.n);
      gn = gn + b.cos_t * ginner;
      // cos_t = -(ud . n)
      gud = gud - gcos * b.n;
      gn = gn - gcos * b.ud;
      // ud = dinv d, dinv = rsqrt(max(|d|^2, 1e-24))
      gd = gd + b.dinv * gud;
      ga += rsqrt_floor_vjp(dot(gud, d), b.a, b.dinv, 1e-24f);
      // eta = front ? 1 / ior : ior, ior = max(w[12], 1e-6) (the
      // comparisons cannot / refl_p > us take no gradient)
      const float gior = b.front ? -geta / (b.ior * b.ior) : geta;
      gw[12] += dmax(w[12], 1e-6f) * gior;
    }
  } else if (b.is_m) {
    // ndir = rinv rf + min(fuzz, 1) u
    grf = b.rinv * gdir;
    mirror = true;
    gw[11] += dmin(b.fuzz, 1.0f) * dot(gdir, b.u);
    // rinv = rsqrt(max(rf . rf, 1e-24))
    const float grr = rsqrt_floor_vjp(dot(gdir, b.rf), b.rr, b.rinv, 1e-24f);
    grf = grf + (2.0f * grr) * b.rf;
  } else {
    // ndir = tg - p; tg = nz_tgt ? n : p + off, off = n + s or n + u
    // (unit sphere, surface) or flip * s (hemisphere: no parameter)
    gp = gp - gdir;
    if (b.nz_tgt) {
      gn = gn + gdir;
    } else {
      gp = gp + gdir;
      if (b.m01) gn = gn + gdir;
    }
  }
  if (mirror) {
    // rf = d - (2 ddn) n, ddn = d . n
    gd = gd + grf;
    const float gddn = -2.0f * dot(grf, b.n);
    gn = gn + (-2.0f * b.ddn) * grf;
    gd = gd + gddn * b.n;
    gn = gn + gddn * d;
  }

  // n = sgn nu (the flip is a constant factor), nu = ninv nraw,
  // ninv = rsqrt(max(nraw . nraw, 1e-24)); the checker parity is a floor
  // of p and takes no gradient
  const V3 gnu = b.sgn * gn;
  V3 gnraw = b.ninv * gnu;
  const float gnn = rsqrt_floor_vjp(dot(gnu, b.nraw), b.nn, b.ninv, 1e-24f);
  gnraw = gnraw + (2.0f * gnn) * b.nraw;
  // nraw = tri ? pn : p - c
  V3 gpn = {0.0f, 0.0f, 0.0f};
  V3 gc = {0.0f, 0.0f, 0.0f};
  if (b.tri) {
    gpn = gnraw;
  } else {
    gp = gp + gnraw;
    gc = gc - gnraw;
  }
  // p = o + ts d, ts = hit ? t : 1
  go = go + gp;
  gd = gd + b.ts * gp;
  const float gt = b.hit ? dot(gp, d) : 0.0f;

  if (!b.tri) {
    // t = q / a
    const float gq = gt / b.a;
    ga += -gt * b.q / (b.a * b.a);
    // q = first ? half_b - rt : half_b + rt
    float ghb = gq;
    const float grt = b.first ? -gq : gq;
    // rt = safe_sqrt(disc), disc = half_b^2 - a c_term
    const float gdisc = b.disc > 0.0f ? grt * (0.5f / b.rt) : 0.0f;
    ghb += 2.0f * b.half_b * gdisc;
    ga += -b.c_term * gdisc;
    const float gct = -b.a * gdisc;
    // c_term = co . co - rad^2, half_b = d . co, co = c - o
    V3 gco = (2.0f * gct) * b.co;
    gw[6] += -2.0f * b.rad * gct;
    gd = gd + ghb * b.co;
    gco = gco + ghb * d;
    gc = gc + gco;
    go = go - gco;
    // c = w[0:3] + tau w[3:6]: the time enters through the motion
    gw[0] += gc.x;
    gw[1] += gc.y;
    gw[2] += gc.z;
    if (p.has_motion) {
      gw[3] += s.tau * gc.x;
      gw[4] += s.tau * gc.y;
      gw[5] += s.tau * gc.z;
      gtau += dot(gc, V3{w[3], w[4], w[5]});
    }
  } else {
    // t = num / ndd_safe, ndd_safe = |ndd| > 0 ? ndd : 1
    const float gnum = gt / b.ndd_safe;
    const float gnds = -gt * b.num / (b.ndd_safe * b.ndd_safe);
    const float gndd = fabsf(b.ndd) > 0.0f ? gnds : 0.0f;
    // ndd = pn . d, num = pn . (v0 - o)
    gpn = gpn + gndd * d;
    gd = gd + gndd * b.pn;
    gpn = gpn + gnum * (b.v0 - s.o);
    const V3 gv0 = gnum * b.pn;
    go = go - gv0;
    // pn = e1 x e2, e1 = w[3:6] - v0, e2 = w[6:9] - v0, v0 = w[0:3]
    const V3 ge1 = cross(b.e2, gpn);
    const V3 ge2 = cross(gpn, b.e1);
    const V3 g0 = gv0 - ge1 - ge2;
    gw[0] += g0.x;
    gw[1] += g0.y;
    gw[2] += g0.z;
    gw[3] += ge1.x;
    gw[4] += ge1.y;
    gw[5] += ge1.z;
    gw[6] += ge2.x;
    gw[7] += ge2.y;
    gw[8] += ge2.z;
  }
}

// Sky radiance of direction d (the reference's formula):
// sky_c = (1 - t + blue_c) t, t = (d_y dinv + 1) / 2.
__device__ __forceinline__ V3 sky(float dy, float dinv, float& sky_t) {
  sky_t = 0.5f * (dy * dinv + 1.0f);
  return {(1.0f - sky_t + 0.5f) * sky_t, (1.0f - sky_t + 0.7f) * sky_t,
          (1.0f - sky_t + 1.0f) * sky_t};
}

__device__ __forceinline__ bool lane_is_tri(const Params& p, int i) {
  return p.with_tri && (!p.with_sph || i >= p.n_sph_pad);
}

__device__ __forceinline__ void load_row(const Params& p, int64_t off,
                                         float* w) {
  const int64_t kr = p.k_it * p.r;
#pragma unroll
  for (int c = 0; c < kRowCols; ++c) w[c] = p.rows[c * kr + off];
}

__device__ __forceinline__ V3 load_u(const Params& p, int64_t at) {
  return {p.aux[at + kAuxUX * p.r], p.aux[at + (kAuxUX + 1) * p.r],
          p.aux[at + (kAuxUX + 2) * p.r]};
}

__global__ void __launch_bounds__(kThreads)
    replay_fwd_kernel(const Params p) {
  const int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (s >= p.r) return;
  const int64_t kr = p.k_it * p.r;
  Carry c = load_carry(p.st0, p.r, s);
  V3 acc = {0.0f, 0.0f, 0.0f};
  for (int64_t t = 0; t < p.k_it; ++t) {
    const int64_t off = t * p.r + s;
    const int i = p.idx[off];
    if (i < -1) continue;  // idle: the step is the identity
    store_carry(p.st_save, kr, off, c);
    const int64_t at = t * kAuxRows * p.r + s;
    bool spawn, cont;
    respawn(p, at, c, spawn, cont);
    if (i == -1) {  // recorded miss: add throughput * sky
      float sky_t;
      const V3 sk = sky(c.d.y, rsqrt_floor(dot(c.d, c.d), 1e-24f), sky_t);
      acc = acc + mul(c.th, sk);
    }
    if (cont) {  // recorded continue: move to the re-derived bounce
      float w[kRowCols];
      load_row(p, off, w);
      Bounce b;
      bounce_forward(p, w, c, load_u(p, at), p.aux[at + kAuxCB * p.r],
                     p.aux[at + kAuxUS * p.r], i >= 0, lane_is_tri(p, i), b);
      c.o = b.p;
      c.d = b.ndir;
      c.th = mul(c.th, b.at);
    }
  }
  p.out[s] = acc.x;
  p.out[p.r + s] = acc.y;
  p.out[2 * p.r + s] = acc.z;
  store_carry(p.fin, p.r, s, c);
}

__global__ void __launch_bounds__(kThreads)
    replay_bwd_kernel(const Params p) {
  const int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (s >= p.r) return;
  const int64_t kr = p.k_it * p.r;
  Carry g = load_carry(p.g_fin, p.r, s);  // cotangent of the carry
  const V3 g_out = {p.g_out[s], p.g_out[p.r + s], p.g_out[2 * p.r + s]};
  for (int64_t t = p.k_it - 1; t >= 0; --t) {
    const int64_t off = t * p.r + s;
    const int i = p.idx[off];
    float gw[kRowCols];
#pragma unroll
    for (int c = 0; c < kRowCols; ++c) gw[c] = 0.0f;
    if (i >= -1) {
      Carry c = load_carry(p.st_entry, kr, off);
      const int64_t at = t * kAuxRows * p.r + s;
      bool spawn, cont;
      respawn(p, at, c, spawn, cont);
      // cotangents of the state after the respawn; tau passes unchanged
      V3 go, gd, gth;
      float gtau = g.tau;
      float ga = 0.0f;  // of a = |d|^2
      if (cont) {
        // new carry: o = p, d = ndir, th = th * at
        float w[kRowCols];
        load_row(p, off, w);
        Bounce b;
        bounce_forward(p, w, c, load_u(p, at), p.aux[at + kAuxCB * p.r],
                       p.aux[at + kAuxUS * p.r], i >= 0, lane_is_tri(p, i),
                       b);
        gth = mul(g.th, b.at);
        go = {0.0f, 0.0f, 0.0f};
        gd = {0.0f, 0.0f, 0.0f};
        bounce_adjoint(p, w, c, b, g.o, g.d, mul(g.th, c.th), go, gd, gtau,
                       ga, gw);
      } else {
        go = g.o;
        gd = g.d;
        gth = g.th;
      }
      if (i == -1) {
        // out += th * sky(d), sky_c = (1 - t + blue_c) t,
        // t = (d_y dinv + 1) / 2, dinv = rsqrt(max(|d|^2, 1e-24))
        const float a = dot(c.d, c.d);
        const float dinv = rsqrt_floor(a, 1e-24f);
        float sky_t;
        const V3 sk = sky(c.d.y, dinv, sky_t);
        gth = gth + mul(g_out, sk);
        const V3 gsk = mul(g_out, c.th);
        const float gsky_t = gsk.x * ((1.0f - sky_t + 0.5f) - sky_t) +
                             gsk.y * ((1.0f - sky_t + 0.7f) - sky_t) +
                             gsk.z * ((1.0f - sky_t + 1.0f) - sky_t);
        const float gy = 0.5f * gsky_t;  // of d_y dinv
        gd.y += gy * dinv;
        ga += rsqrt_floor_vjp(gy * c.d.y, a, dinv, 1e-24f);
      }
      gd = gd + (2.0f * ga) * c.d;
      if (spawn) {  // the recorded ray replaced the incoming state
        go = {0.0f, 0.0f, 0.0f};
        gd = {0.0f, 0.0f, 0.0f};
        gtau = 0.0f;
        gth = {0.0f, 0.0f, 0.0f};
      }
      g = {go, gd, gtau, gth};
    }
#pragma unroll
    for (int c = 0; c < kRowCols; ++c) p.drows[c * kr + off] = gw[c];
  }
  store_carry(p.dst0, p.r, s, g);
}

Params make_params(int k_it, int r, int n_sph_pad, int with_sph,
                   int with_tri, int has_motion, float t_min) {
  Params p = {};
  p.k_it = k_it;
  p.r = r;
  p.n_sph_pad = n_sph_pad;
  p.with_sph = with_sph != 0;
  p.with_tri = with_tri != 0;
  p.has_motion = has_motion != 0;
  p.t_min = t_min;
  return p;
}

unsigned int blocks(int r) {
  return static_cast<unsigned int>((r + kThreads - 1) / kThreads);
}

}  // namespace

// rows [20, K * R], aux [K, 13, R], idx [K, R], st0 [10, R] ->
// out [3, R], fin [10, R], st_entry [10, K, R] (live lanes only).
extern "C" int rayz_replay_fwd(const float* rows, const float* aux,
                               const int* idx, const float* st0, int k_it,
                               int r, float* out, float* fin,
                               float* st_entry, int n_sph_pad, int with_sph,
                               int with_tri, int has_motion, float t_min,
                               void* stream) {
  if (r == 0) return 0;
  Params p = make_params(k_it, r, n_sph_pad, with_sph, with_tri, has_motion,
                         t_min);
  p.rows = rows;
  p.aux = aux;
  p.idx = idx;
  p.st0 = st0;
  p.out = out;
  p.fin = fin;
  p.st_save = st_entry;
  replay_fwd_kernel<<<blocks(r), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// + st_entry [10, K, R], g_out [3, R], g_fin [10, R] ->
// drows [20, K * R], dst0 [10, R].
extern "C" int rayz_replay_bwd(const float* rows, const float* aux,
                               const int* idx, const float* st_entry,
                               const float* g_out, const float* g_fin,
                               int k_it, int r, float* drows, float* dst0,
                               int n_sph_pad, int with_sph, int with_tri,
                               int has_motion, float t_min, void* stream) {
  if (r == 0) return 0;
  Params p = make_params(k_it, r, n_sph_pad, with_sph, with_tri, has_motion,
                         t_min);
  p.rows = rows;
  p.aux = aux;
  p.idx = idx;
  p.st_entry = st_entry;
  p.g_out = g_out;
  p.g_fin = g_fin;
  p.drows = drows;
  p.dst0 = dst0;
  replay_bwd_kernel<<<blocks(r), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
