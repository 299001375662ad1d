// Persistent-path recorder for Hopper (sm_90a).
//
// Replaces the TPU kernel rayz_tpu/ops/pathrec.py:_record_pp_kernel (with
// _record_one_iteration), launched there by record_pp. It runs the
// megakernel's persistent path loop for a fixed number of iterations and
// records, per iteration and slot, what the differentiable replay needs:
// the winning primitive index (spheres first, triangles offset by the
// sphere count; -1 active miss, -2 idle) and 13 aux rows (the scatter
// randoms, the spawned camera ray and time, and the spawn + 2 * continue
// flag). After the last iteration it writes each slot's leftover (samples
// not yet spawned plus the path in flight) and, on request, its state for a
// resumed pass (ray, counters, and the sphere column the ray leaves).
//
// Draws are the megakernel's: keyed by (seed, pixel, sample, bounce) with
// draw numbers 0-8 (ops/rng.py), so a recorded path is exactly the path
// megakernel.cu traces for the same seed, and a resumed pass continues each
// slot's counters with the same seed (the JAX package re-seeds each pass
// because its hardware stream would repeat).
//
// What bounds it on the H100: instruction issue in the per-sphere sweep,
// the megakernel's loop, plus the recording itself: 14 words per slot and
// iteration (1.6 GB for the first pass of a flagship micro-batch), written
// coalesced ([k, row, slot], slots fastest). rz::sweep_spheres issues 40
// slots a column (9 one-word shared loads, 27 unfused FP32 operations, the
// compare, branch and convergence barrier; PERF.md §6) and ran at ~0.64
// of that issue ceiling. The design: rz::sweep_packed (common.cuh), the
// geometry staged as 16-byte records and the quadratic as fused
// multiply-adds in the coefficient form, its winner settled in today's
// arithmetic (the sphere a ray leaves and the grazing column contesting
// it), so a recorded index is today's except at rare near ties; the winner's
// centre and material are read from the row-major table in device memory
// (L1). One thread per slot in 128-thread blocks, the tables staged once
// per block in dynamic shared memory (with the >48 KB opt-in), the winner
// carried as a (q_best, column) pair. An idle iteration costs only its 14
// stores.
//
// C interface for ctypes (see ops/_build.py): returns the launch's
// cudaError_t.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

// aux rows (twin: ops/pathrec.py _AUX_*)
constexpr int kAuxUX = 0, kAuxUY = 1, kAuxUZ = 2, kAuxCB = 3, kAuxUS = 4;
constexpr int kAuxOX = 5, kAuxOY = 6, kAuxOZ = 7;
constexpr int kAuxDX = 8, kAuxDY = 9, kAuxDZ = 10, kAuxTau = 11;
constexpr int kAuxFlg = 12;
constexpr int kAuxRows = 13;

struct Params {
  const float* cam;    // [18]
  const float* stab;   // [17, n]
  const float* ttab;   // [20, m]
  const int* pix;      // [cap] flat pixel ids, -1 = no pixel
  const float* st_in;  // [7, cap] o, d, tau, or null
  const int* cnt_in;   // [3, cap] depth left, samples left, active
  const int* from_in;  // [cap] sphere column the ray leaves (-1 none)
  int* idx;            // [iters, cap]
  float* aux;          // [iters, 13, cap]
  int* left;           // [cap]
  float* st_out;       // [7, cap] or null
  int* cnt_out;        // [3, cap] or null
  int* from_out;       // [cap] or null
  unsigned long long* stats;  // [8] (re-sweeps at rz::kStatResweeps) or null
  int n, m, cap, iters;
  int width, spp, max_depth;
  float t_min;
  uint32_t seed;
  bool jitter;
};

template <bool kMotion>
__global__ void __launch_bounds__(128, 8) record_pp_kernel(Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* s_cam = smem;
  for (int i = threadIdx.x; i < 18; i += blockDim.x) s_cam[i] = p.cam[i];
  const rz::PackedSpheres ps =
      rz::stage_spheres<kMotion>(p.stab, p.n, smem + rz::kCamWords);
  float* s_tri = smem + rz::kCamWords + rz::packed_words<kMotion>(p.n);
  for (int i = threadIdx.x; i < rz::kTRows * p.m; i += blockDim.x)
    s_tri[i] = p.ttab[i];
  __syncthreads();

  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  if (slot >= p.cap) return;
  const int cap = p.cap;
  const int pix = p.pix[slot];
  const int pp = pix >= 0 ? pix : 0;
  const float pxf = static_cast<float>(pp % p.width);
  const float pyf = static_cast<float>(pp / p.width);

  rz::Ray r;
  int depth, samples, from = -1;
  bool active;
  if (p.st_in) {
    r.ox = p.st_in[0 * cap + slot];
    r.oy = p.st_in[1 * cap + slot];
    r.oz = p.st_in[2 * cap + slot];
    r.dx = p.st_in[3 * cap + slot];
    r.dy = p.st_in[4 * cap + slot];
    r.dz = p.st_in[5 * cap + slot];
    r.tau = p.st_in[6 * cap + slot];
    depth = p.cnt_in[0 * cap + slot];
    samples = p.cnt_in[1 * cap + slot];
    active = p.cnt_in[2 * cap + slot] > 0;
    from = p.from_in[slot];
  } else {
    r.ox = r.oy = r.oz = 0.0f;
    r.dx = r.dy = r.dz = 0.0f;
    r.tau = 0.0f;
    depth = 0;
    samples = pix >= 0 ? p.spp : 0;
    active = false;
  }

  const uint32_t key0 = rz::slot_key(p.seed, pix);
  for (int k = 0; k < p.iters; ++k) {
    int* idx_k = p.idx + static_cast<size_t>(k) * cap + slot;
    float* aux_k = p.aux + static_cast<size_t>(k) * kAuxRows * cap + slot;
    if (!active && samples <= 0) {  // idle: nothing left to trace
      *idx_k = -2;
      for (int row = 0; row < kAuxRows; ++row) aux_k[row * cap] = 0.0f;
      continue;
    }
    const bool spawn = !active;
    if (spawn) {
      samples -= 1;
      depth = p.max_depth;
    }
    const uint32_t key = rz::step_key(key0, p.spp - samples,
                                      p.max_depth - depth);

    // ---- respawn with the next camera sample (megakernel.cu) ----
    if (spawn) {
      float x = pxf, y = pyf;
      float nox = s_cam[0], noy = s_cam[1], noz = s_cam[2];
      float ntau = 0.0f;
      if (p.jitter) {
        x = pxf + rz::uniform(rz::draw_bits(key, 0)) - 0.5f;
        y = pyf + rz::uniform(rz::draw_bits(key, 1)) - 0.5f;
        const float rr = sqrtf(rz::uniform(rz::draw_bits(key, 2)));
        const float th = rz::kTwoPi * rz::uniform(rz::draw_bits(key, 3));
        const float ca = cosf(th);
        const float sa = sinf(th);
        nox = s_cam[0] + rr * (ca * s_cam[12] + sa * s_cam[15]);
        noy = s_cam[1] + rr * (ca * s_cam[13] + sa * s_cam[16]);
        noz = s_cam[2] + rr * (ca * s_cam[14] + sa * s_cam[17]);
        ntau = rz::uniform(rz::draw_bits(key, 4));
      }
      r.dx = x * s_cam[3] + y * s_cam[6] + s_cam[9] - nox;
      r.dy = x * s_cam[4] + y * s_cam[7] + s_cam[10] - noy;
      r.dz = x * s_cam[5] + y * s_cam[8] + s_cam[11] - noz;
      r.ox = nox;
      r.oy = noy;
      r.oz = noz;
      r.tau = ntau;
      active = true;
    }
    aux_k[kAuxOX * cap] = spawn ? r.ox : 0.0f;
    aux_k[kAuxOY * cap] = spawn ? r.oy : 0.0f;
    aux_k[kAuxOZ * cap] = spawn ? r.oz : 0.0f;
    aux_k[kAuxDX * cap] = spawn ? r.dx : 0.0f;
    aux_k[kAuxDY * cap] = spawn ? r.dy : 0.0f;
    aux_k[kAuxDZ * cap] = spawn ? r.dz : 0.0f;
    aux_k[kAuxTau * cap] = spawn ? r.tau : 0.0f;

    // ---- the scatter randoms the replay consumes (draws 5-8, as
    // rz::scatter draws them) ----
    float ux, uy, uz;
    rz::unit3(rz::uniform(rz::draw_bits(key, 5)),
              rz::uniform(rz::draw_bits(key, 6)), ux, uy, uz);
    aux_k[kAuxUX * cap] = ux;
    aux_k[kAuxUY * cap] = uy;
    aux_k[kAuxUZ * cap] = uz;
    aux_k[kAuxCB * cap] =
        expf(logf(rz::clamp_min(rz::uniform(rz::draw_bits(key, 7)), 1e-24f)) *
             (1.0f / 3.0f));
    aux_k[kAuxUS * cap] = rz::uniform(rz::draw_bits(key, 8));

    // ---- nearest hit: spheres, then triangles ----
    const rz::RayTerms t = rz::ray_terms(r, p.t_min);
    float qb = rz::kBig;
    int best = -1;
    bool is_tri = false;
    const rz::RayCoef c = rz::ray_coef(r, t);
    int second = -1, graze = -1;
    rz::sweep_packed<kMotion>(ps, p.n, c, qb, best, second, graze);
    if (rz::settle_winner<kMotion>(ps, p.n, from, r, t, c, qb, best, second,
                                   graze) &&
        p.stats)
      atomicAdd(p.stats + rz::kStatResweeps, 1ull);
    rz::sweep_triangles(s_tri, p.m, r, t, qb, best, is_tri);

    bool cont = false;
    if (qb < rz::kBig) {
      *idx_k = is_tri ? p.n + best : best;
      const float dinv = 1.0f / sqrtf(rz::clamp_min(t.a, 1e-24f));
      const float ts = qb * (1.0f / t.a);
      const float px = r.ox + ts * r.dx;
      const float py = r.oy + ts * r.dy;
      const float pz = r.oz + ts * r.dz;
      float nx, ny, nz;
      const float* mat;
      int stride;
      if (is_tri) {
        nx = s_tri[rz::kTNX * p.m + best];
        ny = s_tri[rz::kTNY * p.m + best];
        nz = s_tri[rz::kTNZ * p.m + best];
        mat = s_tri + rz::kTPKF * p.m + best;
        stride = p.m;
      } else {
        float cx, cy, cz, ccmr2;
        rz::sphere_at<kMotion>(p.stab, p.n, best, r, t, cx, cy, cz, ccmr2);
        nx = px - cx;
        ny = py - cy;
        nz = pz - cz;
        mat = p.stab + rz::kPKF * p.n + best;
        stride = p.n;
      }
      const float ninv =
          1.0f / sqrtf(rz::clamp_min(nx * nx + ny * ny + nz * nz, 1e-24f));
      nx = nx * ninv;
      ny = ny * ninv;
      nz = nz * ninv;
      const bool front = nx * r.dx + ny * r.dy + nz * r.dz < 0.0f;
      const float sgn = front ? 1.0f : -1.0f;
      nx = nx * sgn;
      ny = ny * sgn;
      nz = nz * sgn;
      const rz::Scatter s = rz::scatter(mat, stride, r, dinv, px, py, pz, nx,
                                        ny, nz, front, rz::KeyDraws{key});
      // the last bounce of a path is recorded as not continuing: it would
      // leave depth 0, which ends the path with no radiance
      if (s.ok && depth > 1) {
        cont = true;
        r.ox = px;
        r.oy = py;
        r.oz = pz;
        r.dx = s.dx;
        r.dy = s.dy;
        r.dz = s.dz;
        depth -= 1;
      }
    } else {
      *idx_k = -1;
    }
    aux_k[kAuxFlg * cap] = (spawn ? 1.0f : 0.0f) + (cont ? 2.0f : 0.0f);
    active = cont;
    from = cont && !is_tri ? best : -1;
  }

  p.left[slot] = samples + (active ? 1 : 0);
  if (p.st_out) {
    p.st_out[0 * cap + slot] = r.ox;
    p.st_out[1 * cap + slot] = r.oy;
    p.st_out[2 * cap + slot] = r.oz;
    p.st_out[3 * cap + slot] = r.dx;
    p.st_out[4 * cap + slot] = r.dy;
    p.st_out[5 * cap + slot] = r.dz;
    p.st_out[6 * cap + slot] = r.tau;
    p.cnt_out[0 * cap + slot] = depth;
    p.cnt_out[1 * cap + slot] = samples;
    p.cnt_out[2 * cap + slot] = active ? 1 : 0;
    p.from_out[slot] = from;
  }
}

template <bool kMotion>
cudaError_t launch(const Params& p, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        record_pp_kernel<kMotion>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int threads = 128;
  const int blocks = (p.cap + threads - 1) / threads;
  record_pp_kernel<kMotion><<<blocks, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rayz_record_pp(const float* cam, const float* stab, int n,
                              const float* ttab, int m, const int* pix,
                              int cap, const float* st_in, const int* cnt_in,
                              const int* from_in,
                              int* idx, float* aux, int* left, float* st_out,
                              int* cnt_out, int* from_out, int iters,
                              int width, int spp,
                              int max_depth, float t_min, int jitter,
                              int has_motion, unsigned int seed,
                              void* stats, void* stream) {
  Params p;
  p.cam = cam;
  p.stab = stab;
  p.ttab = ttab;
  p.pix = pix;
  p.st_in = st_in;
  p.cnt_in = cnt_in;
  p.from_in = from_in;
  p.idx = idx;
  p.aux = aux;
  p.left = left;
  p.st_out = st_out;
  p.cnt_out = cnt_out;
  p.from_out = from_out;
  p.n = n;
  p.m = m;
  p.cap = cap;
  p.iters = iters;
  p.width = width;
  p.spp = spp;
  p.max_depth = max_depth;
  p.t_min = t_min;
  p.seed = seed;
  p.jitter = jitter != 0;
  p.stats = static_cast<unsigned long long*>(stats);
  const size_t smem =
      sizeof(float) *
      (rz::kCamWords +
       static_cast<size_t>(has_motion ? rz::packed_words<true>(n)
                                      : rz::packed_words<false>(n)) +
       rz::kTRows * static_cast<size_t>(m));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = has_motion ? launch<true>(p, smem, s)
                                   : launch<false>(p, smem, s);
  return static_cast<int>(e);
}
