// Persistent path-tracing megakernel for Hopper (sm_90a).
//
// Replaces the TPU kernel rayz_tpu/ops/megakernel.py:_kernel in its
// SMEM-resident, culling-off, full-table mode (launched there by
// _trace_shard and _trace_shard_compact). It computes the same image: spawn
// with jitter, defocus and time; nearest hit over the spheres, then the
// triangles; one-level checker; diffuse / metal / dielectric scatter; sky on
// a miss; per-slot RGB radiance sums.
//
// What bounds it on the H100: FP32 ALU issue in the per-sphere quadratic
// (about 25 operations and a square root per sphere per bounce, every
// thread against every sphere). The design feeds that loop from the cheapest
// place: the scene tables sit in shared memory, copied once per block, and
// all threads of a warp read the same column at the same moment, so each
// table read is a broadcast; the winner is carried in registers as a
// (q_best, column) pair and its attributes are fetched once after the sweep.
//
// Layout: one thread owns one pixel slot and runs all of the slot's spp
// samples, respawning the next camera sample as soon as a path dies (the
// TPU's (rs, 128) tile and its tile-wide loop condition become a per-thread
// loop). Blocks are 128 threads: a block lives as long as its slowest pixel,
// so a small block hands its SM back sooner in the per-pixel straggler
// tail. Each block holds its own copy of the tables, so shared memory bounds
// the resident blocks (six flagship copies of 34.9 KB per SM) about as much
// as registers do (56 per thread: nine blocks).
//
// Compaction mode (the multi-pass main path at spp >= 16): `budget` caps the
// thread's loop trips (0 = run to the end), `resume` is the [16, cap] state
// the previous pass saved (read-only), `save` receives the state after this
// pass, and `pix` maps slots to flat pixel ids (-1 = retired slot). Random
// draws are keyed by (seed, pixel, sample, bounce, draw), all recoverable
// from the saved state, so any pass schedule renders the same bits as one
// launch.
//
// C interface for ctypes (see ops/_build.py): every entry point returns the
// cudaError_t of its launch.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

struct Params {
  const float* cam;     // [18]
  const float* stab;    // [17, n_pad]
  const float* ttab;    // [20, m_pad]
  const int* pix;       // [cap]
  const float* resume;  // [16, cap] or null
  float* save;          // [16, cap] or null
  float* rgb;           // [3, cap]
  int n_pad, m_pad, cap;
  int width, spp, max_depth, budget;
  float t_min;
  uint32_t seed;
  bool jitter;
};

template <bool kMotion>
__global__ void __launch_bounds__(128) megakernel(Params p) {
  extern __shared__ float smem[];
  float* s_cam = smem;
  float* s_sph = smem + rz::kCamWords;
  float* s_tri = s_sph + rz::kSRows * p.n_pad;
  for (int i = threadIdx.x; i < 18; i += blockDim.x) s_cam[i] = p.cam[i];
  for (int i = threadIdx.x; i < rz::kSRows * p.n_pad; i += blockDim.x)
    s_sph[i] = p.stab[i];
  for (int i = threadIdx.x; i < rz::kTRows * p.m_pad; i += blockDim.x)
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
  float thx, thy, thz, ar, ag, ab;
  int depth, samples;
  bool active;
  if (p.resume) {
    const float* st = p.resume + slot;
    r.ox = st[0 * cap];
    r.oy = st[1 * cap];
    r.oz = st[2 * cap];
    r.dx = st[3 * cap];
    r.dy = st[4 * cap];
    r.dz = st[5 * cap];
    r.tau = st[6 * cap];
    thx = st[7 * cap];
    thy = st[8 * cap];
    thz = st[9 * cap];
    ar = st[10 * cap];
    ag = st[11 * cap];
    ab = st[12 * cap];
    depth = static_cast<int>(st[13 * cap]);
    samples = static_cast<int>(st[14 * cap]);
    active = static_cast<int>(st[15 * cap]) > 0;
  } else {
    r.ox = r.oy = r.oz = 0.0f;
    r.dx = r.dy = 0.0f;
    r.dz = 1.0f;
    r.tau = 0.0f;
    thx = thy = thz = 0.0f;
    ar = ag = ab = 0.0f;
    depth = 0;
    samples = pix >= 0 ? p.spp : 0;
    active = false;
  }

  const uint32_t key0 = rz::slot_key(p.seed, pix);
  int trips = 0;
  while ((active || samples > 0) && (p.budget == 0 || trips < p.budget)) {
    ++trips;
    const bool spawn = !active;
    if (spawn) {
      samples -= 1;
      depth = p.max_depth;
    }
    const uint32_t key = rz::step_key(key0, p.spp - samples,
                                      p.max_depth - depth);

    // ---- respawn with the next camera sample (+-0.5 px jitter, polar
    // defocus-disk origin, time in [0, 1)) ----
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
      thx = thy = thz = 1.0f;
      active = true;
    }

    // ---- nearest hit: spheres, then triangles ----
    const rz::RayTerms t = rz::ray_terms(r, p.t_min);
    float qb = rz::kBig;
    int best = -1;
    bool is_tri = false;
    rz::sweep_spheres<kMotion>(s_sph, p.n_pad, r, t, qb, best);
    rz::sweep_triangles(s_tri, p.m_pad, r, t, qb, best, is_tri);

    const float dinv = 1.0f / sqrtf(rz::clamp_min(t.a, 1e-24f));
    if (!(qb < rz::kBig)) {
      // miss: sky weighted by throughput, (white * (1 - t) + blue) * t
      const float sky_t = 0.5f * (r.dy * dinv + 1.0f);
      ar = ar + thx * ((1.0f - sky_t + 0.5f) * sky_t);
      ag = ag + thy * ((1.0f - sky_t + 0.7f) * sky_t);
      ab = ab + thz * ((1.0f - sky_t + 1.0f) * sky_t);
      active = false;
      continue;
    }

    const float ts = qb * (1.0f / t.a);
    const float px = r.ox + ts * r.dx;
    const float py = r.oy + ts * r.dy;
    const float pz = r.oz + ts * r.dz;
    float nx, ny, nz;
    const float* mat;
    int stride;
    if (is_tri) {
      nx = s_tri[rz::kTNX * p.m_pad + best];
      ny = s_tri[rz::kTNY * p.m_pad + best];
      nz = s_tri[rz::kTNZ * p.m_pad + best];
      mat = s_tri + rz::kTPKF * p.m_pad + best;
      stride = p.m_pad;
    } else {
      float cx, cy, cz, ccmr2;
      rz::sphere_at<kMotion>(s_sph, p.n_pad, best, r, t, cx, cy, cz, ccmr2);
      nx = px - cx;
      ny = py - cy;
      nz = pz - cz;
      mat = s_sph + rz::kPKF * p.n_pad + best;
      stride = p.n_pad;
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

    const rz::Scatter s =
        rz::scatter(mat, stride, r, dinv, px, py, pz, nx, ny, nz, front, key);
    if (s.ok) {
      thx = thx * s.ar;
      thy = thy * s.ag;
      thz = thz * s.ab;
      r.ox = px;
      r.oy = py;
      r.oz = pz;
      r.dx = s.dx;
      r.dy = s.dy;
      r.dz = s.dz;
      depth -= 1;
      active = depth > 0;  // depth exhausted -> black
    } else {
      active = false;  // absorbed
    }
  }

  p.rgb[0 * cap + slot] = ar;
  p.rgb[1 * cap + slot] = ag;
  p.rgb[2 * cap + slot] = ab;
  if (p.save) {
    float* st = p.save + slot;
    st[0 * cap] = r.ox;
    st[1 * cap] = r.oy;
    st[2 * cap] = r.oz;
    st[3 * cap] = r.dx;
    st[4 * cap] = r.dy;
    st[5 * cap] = r.dz;
    st[6 * cap] = r.tau;
    st[7 * cap] = thx;
    st[8 * cap] = thy;
    st[9 * cap] = thz;
    st[10 * cap] = ar;
    st[11 * cap] = ag;
    st[12 * cap] = ab;
    st[13 * cap] = static_cast<float>(depth);
    st[14 * cap] = static_cast<float>(samples);
    st[15 * cap] = active ? 1.0f : 0.0f;
  }
}

__global__ void rng_bits_kernel(uint32_t seed, const int* pix,
                                const int* sample, const int* bounce,
                                const int* draw, int n, uint32_t* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t key = rz::step_key(rz::slot_key(seed, pix[i]), sample[i],
                                    bounce[i]);
  out[i] = rz::draw_bits(key, static_cast<uint32_t>(draw[i]));
}

template <bool kMotion>
cudaError_t launch(const Params& p, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        megakernel<kMotion>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int threads = 128;
  const int blocks = (p.cap + threads - 1) / threads;
  megakernel<kMotion><<<blocks, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rayz_megakernel(const float* cam, const float* stab, int n_pad,
                               const float* ttab, int m_pad, const int* pix,
                               int cap, const float* resume, float* save,
                               float* rgb, int width, int spp, int max_depth,
                               float t_min, int jitter, int has_motion,
                               unsigned int seed, int budget, void* stream) {
  Params p;
  p.cam = cam;
  p.stab = stab;
  p.ttab = ttab;
  p.pix = pix;
  p.resume = resume;
  p.save = save;
  p.rgb = rgb;
  p.n_pad = n_pad;
  p.m_pad = m_pad;
  p.cap = cap;
  p.width = width;
  p.spp = spp;
  p.max_depth = max_depth;
  p.budget = budget;
  p.t_min = t_min;
  p.seed = seed;
  p.jitter = jitter != 0;
  const size_t smem =
      sizeof(float) * (rz::kCamWords + rz::kSRows * static_cast<size_t>(n_pad) +
                       rz::kTRows * static_cast<size_t>(m_pad));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = has_motion ? launch<true>(p, smem, s)
                                   : launch<false>(p, smem, s);
  return static_cast<int>(e);
}

extern "C" int rayz_rng_bits(unsigned int seed, const int* pix,
                             const int* sample, const int* bounce,
                             const int* draw, int n, void* out,
                             void* stream) {
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  rng_bits_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      seed, pix, sample, bounce, draw, n, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rayz_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
