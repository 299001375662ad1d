// Persistent path-tracing megakernel for Hopper (sm_90a).
//
// Replaces the TPU kernel rayz_tpu/ops/megakernel.py:_kernel in its three
// table modes (launched there by _trace_shard, _trace_shard_compact and
// _trace_shard_streamed). It computes the same image: spawn with jitter,
// defocus and time; nearest hit over the spheres, then the triangles;
// one-level checker; diffuse / metal / dielectric scatter; sky on a miss;
// per-slot RGB radiance sums.
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
// Table modes:
//  * resident (`megakernel`, the flagship's): the full tables in shared
//    memory, every column swept.
//  * kCulled (`megakernel_culled`; the TPU's _culled_loop): Morton-sorted
//    tables and per-block bound rows in shared memory; a block of `blk`
//    columns is swept only if its bounding sphere may hold a hit nearer
//    than the current best.
//  * kStreamed (`megakernel_culled`; the TPU's _stream_loop): tables and
//    block rows stay in device memory and are read through L1/L2; the
//    chunk bound rows sit in shared memory. A chunk is entered only if its bound passes, then its
//    blocks as in kCulled. The TPU copies a chunk into SMEM scratch because
//    its scalar core reads only SMEM; here a copy would buy nothing, since
//    a sweep reads each column once per ray and a warp's threads read the
//    same column at once (one cached line serves 32 columns of a row).
// The TPU tests a bound tile-wide and sweeps the block if ANY lane may hit
// it. The threads of this persistent kernel run independent trip counts
// and cannot vote, so each thread tests bounds for its own ray and skips
// what its own test rejects. Culling is conservative either way, so the
// winners are those of a full sweep over the same tables, up to exact
// ties. Both kernels run one slot loop (trace_slot: resume and save,
// respawn, trip budget, shading through rz::camera_ray and rz::shade, the
// continue/die rule), each with its own sweep. They stay two kernels: one
// template over all three modes cost the flagship 3% in an A/B on the
// card, the resident kernel needs no work counters, and its Params stay
// the smaller struct.
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

// One slot's samples in either kernel: resume the saved state or start;
// respawn each sample's camera ray; the nearest hit through `sweep(r, t,
// qb, best, is_tri)`, the kernel's table mode; shading; continue or die;
// then the radiance sums and, compacting, the state.
template <bool kMotion, typename Sweep>
__device__ __forceinline__ void trace_slot(Params p, int slot,
                                           const float* s_cam,
                                           const float* sph, const float* tri,
                                           Sweep sweep) {
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
    if (!active) {
      samples -= 1;
      depth = p.max_depth;
    }
    const uint32_t key = rz::step_key(key0, p.spp - samples,
                                      p.max_depth - depth);
    if (!active) {
      rz::camera_ray(s_cam, pxf, pyf, p.jitter, key, r);
      thx = thy = thz = 1.0f;
      active = true;
    }

    const rz::RayTerms t = rz::ray_terms(r, p.t_min);
    float qb = rz::kBig;
    int best = -1;
    bool is_tri = false;
    sweep(r, t, qb, best, is_tri);
    if (rz::shade<kMotion>(sph, p.n_pad, tri, p.m_pad, r, t, qb, best, is_tri,
                           rz::KeyDraws{key}, thx, thy, thz, ar, ag,
                           ab) == rz::Bounce::kContinued) {
      depth -= 1;
      active = depth > 0;  // depth exhausted -> black
    } else {
      active = false;  // the sky, or absorbed
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
  const int n = p.n_pad, m = p.m_pad;
  trace_slot<kMotion>(
      p, slot, s_cam, s_sph, s_tri,
      [s_sph, s_tri, n, m](const rz::Ray& r, const rz::RayTerms& t, float& qb,
                           int& best, bool& is_tri) {
        rz::sweep_spheres<kMotion>(s_sph, n, r, t, qb, best);
        rz::sweep_triangles(s_tri, m, r, t, qb, best, is_tri);
      });
}

// Launch parameters of the culled and streamed modes.
struct ModeParams : Params {
  const float* sblk;  // [4, n_pad / blk] sphere block rows
  const float* tblk;  // [4, m_pad / blk] triangle block rows
  const float* scb;   // [4, n_pad / stream] sphere chunk bounds
  const float* tcb;   // [4, m_pad / stream] triangle chunk bounds
  int blk, stream;    // block and chunk columns (streamed blk 0: no blocks)
  bool cull;          // streamed: false sweeps every chunk untested
  unsigned long long* stats;  // [8] work counters (rz::Work) or null
};

enum : int { kCulled = 1, kStreamed = 2 };

// The culled (kCulled) and streamed (kStreamed) modes: trace_slot with the
// sweep behind bound tests, counting its work.
template <bool kMotion, int kMode>
__global__ void __launch_bounds__(128) megakernel_culled(ModeParams p) {
  extern __shared__ float smem[];
  float* s_cam = smem;
  for (int i = threadIdx.x; i < 18; i += blockDim.x) s_cam[i] = p.cam[i];
  // culled: tables, then block rows; streamed: the chunk bound rows only
  const float* sph = p.stab;
  const float* tri = p.ttab;
  const float* sbl = p.sblk;
  const float* tbl = p.tblk;
  const int ns = kMode == kCulled ? 4 * (p.n_pad / p.blk)
                                  : 4 * (p.n_pad / p.stream);
  const int nt = kMode == kCulled ? 4 * (p.m_pad / p.blk)
                                  : 4 * (p.m_pad / p.stream);
  float* s = smem + rz::kCamWords;
  if constexpr (kMode == kCulled) {
    for (int i = threadIdx.x; i < rz::kSRows * p.n_pad; i += blockDim.x)
      s[i] = p.stab[i];
    sph = s;
    s += rz::kSRows * p.n_pad;
    for (int i = threadIdx.x; i < rz::kTRows * p.m_pad; i += blockDim.x)
      s[i] = p.ttab[i];
    tri = s;
    s += rz::kTRows * p.m_pad;
  }
  const float* sb = kMode == kCulled ? p.sblk : p.scb;
  const float* tb = kMode == kCulled ? p.tblk : p.tcb;
  for (int i = threadIdx.x; i < ns; i += blockDim.x) s[i] = sb[i];
  for (int i = threadIdx.x; i < nt; i += blockDim.x) s[ns + i] = tb[i];
  if constexpr (kMode == kCulled) {
    sbl = s;
    tbl = s + ns;
  }
  const float* scb = s;  // streamed: chunk bounds
  const float* tcb = s + ns;
  __syncthreads();

  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  if (slot >= p.cap) return;
  rz::Work w;
  const int n = p.n_pad, m = p.m_pad, blk = p.blk, stream = p.stream;
  const bool cull = p.cull;
  trace_slot<kMotion>(
      p, slot, s_cam, sph, tri,
      [&w, sph, tri, sbl, tbl, scb, tcb, n, m, blk, stream, cull](
          const rz::Ray& r, const rz::RayTerms& t, float& qb, int& best,
          bool& is_tri) {
        ++w.segments;
        if constexpr (kMode == kCulled) {
          rz::sweep_blocks<kMotion, false>(sph, n, sbl, n / blk, blk, 0,
                                           n / blk, r, t, qb, best, is_tri,
                                           w);
          rz::sweep_blocks<kMotion, true>(tri, m, tbl, m / blk, blk, 0,
                                          m / blk, r, t, qb, best, is_tri, w);
        } else {
          rz::sweep_chunks<kMotion, false>(sph, n, scb, sbl, stream, blk,
                                           cull, r, t, qb, best, is_tri, w);
          rz::sweep_chunks<kMotion, true>(tri, m, tcb, tbl, stream, blk,
                                          cull, r, t, qb, best, is_tri, w);
        }
      });
  if (p.stats) rz::flush_work(w, p.stats);
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

template <typename P, typename K>
cudaError_t launch(K kernel, const P& p, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int threads = 128;
  const int blocks = (p.cap + threads - 1) / threads;
  kernel<<<blocks, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// mode: 0 resident, 1 culled (sblk/tblk, blk), 2 streamed (scb/tcb, stream,
// sblk/tblk with blk, cull). stats: null or [8] uint64 counters (culled and
// streamed modes).
extern "C" int rayz_megakernel(const float* cam, const float* stab, int n_pad,
                               const float* ttab, int m_pad, const int* pix,
                               int cap, const float* resume, float* save,
                               float* rgb, int width, int spp, int max_depth,
                               float t_min, int jitter, int has_motion,
                               unsigned int seed, int budget, int mode,
                               const float* sblk, const float* tblk,
                               const float* scb, const float* tcb, int blk,
                               int stream_cols, int cull, void* stats,
                               void* stream) {
  ModeParams p;
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
  p.sblk = sblk;
  p.tblk = tblk;
  p.scb = scb;
  p.tcb = tcb;
  p.blk = blk;
  p.stream = stream_cols;
  p.cull = cull != 0;
  p.stats = static_cast<unsigned long long*>(stats);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool motion = has_motion != 0;
  const size_t tables = rz::kSRows * static_cast<size_t>(n_pad) +
                        rz::kTRows * static_cast<size_t>(m_pad);
  const size_t cam_words = rz::kCamWords;
  cudaError_t e;
  if (mode == 0) {
    const Params& base = p;
    const size_t smem = sizeof(float) * (cam_words + tables);
    e = motion ? launch(megakernel<true>, base, smem, s)
               : launch(megakernel<false>, base, smem, s);
  } else if (mode == kCulled) {
    const size_t smem =
        sizeof(float) * (cam_words + tables +
                         4 * static_cast<size_t>(n_pad / blk + m_pad / blk));
    e = motion ? launch(megakernel_culled<true, kCulled>, p, smem, s)
               : launch(megakernel_culled<false, kCulled>, p, smem, s);
  } else if (mode == kStreamed) {
    const size_t smem =
        sizeof(float) *
        (cam_words + 4 * static_cast<size_t>(n_pad / stream_cols +
                                             m_pad / stream_cols));
    e = motion ? launch(megakernel_culled<true, kStreamed>, p, smem, s)
               : launch(megakernel_culled<false, kStreamed>, p, smem, s);
  } else {
    e = cudaErrorInvalidValue;
  }
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
