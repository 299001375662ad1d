// Persistent path-tracing megakernel for Hopper (sm_90a).
//
// Replaces the TPU kernel rayz_tpu/ops/megakernel.py:_kernel in its three
// table modes (launched there by _trace_shard, _trace_shard_compact and
// _trace_shard_streamed). It computes the same image: spawn with jitter,
// defocus and time; nearest hit over the spheres, then the triangles;
// one-level checker; diffuse / metal / dielectric scatter; sky on a miss;
// per-pixel RGB radiance sums.
//
// What bounds it on the H100: instruction issue in the per-sphere sweep,
// every segment against every sphere column (an SM issues 4 warp
// instructions a clock). Measured on the one-thread-per-slot kernel with
// rz::sweep_spheres (PERF.md §6): 40 issue slots a column (9 one-word
// shared loads, 27 unfused FP32 operations, the compare, branch and
// convergence barrier), and a quarter of the lanes idle
// (0.2295 of lane-trips in one launch at the flagship) because a thread
// owned one pixel for all its samples. The resident mode answers both:
//  * it sweeps with rz::sweep_packed (common.cuh): the geometry staged as
//    16-byte records (2 LDS.128 and an LDS.32 a column with motion), the
//    quadratic in the coefficient form as 17 fused multiply-adds, the
//    winner settled in today's arithmetic;
//  * it is megakernel_queue: a persistent grid whose lanes take (sample,
//    pixel) items from a counter on the card, 64 items per warp and atomic,
//    so no lane waits for its pixel's other samples, and a fold kernel that
//    adds each pixel's samples in sample order;
//  * the tables sit in shared memory, copied once per block, and all
//    threads of a warp read the same column at the same moment, so each
//    table read is a broadcast; the winner is carried in registers as a
//    (q_best, column) pair and its attributes (centre, material) are read
//    once per segment from the row-major table in device memory (L1).
//
// Table modes:
//  * resident (`megakernel_queue`, the flagship's): the sphere geometry
//    packed and the triangle table in shared memory, every column swept.
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
// The culled and streamed modes keep the earlier layout and sweep
// (rz::sweep_spheres): one thread owns one pixel slot and runs all of the
// slot's spp samples, respawning the next camera sample as soon as a path
// dies (the TPU's (rs, 128) tile and its tile-wide loop condition become a
// per-thread loop), in blocks of 128 threads.
// The TPU tests a bound tile-wide and sweeps the block if ANY lane may hit
// it. The threads of this persistent kernel run independent trip counts
// and cannot vote, so each thread tests bounds for its own ray and skips
// what its own test rejects. Culling is conservative either way, so the
// winners are those of a full sweep over the same tables, up to exact
// ties. Both modes run one slot loop (trace_slot: resume and save,
// respawn, trip budget, shading through rz::camera_ray and rz::shade, the
// continue/die rule), each with its own sweep.
//
// Compaction mode (the culled mode's default at spp >= 16): `budget` caps the
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

// One slot's samples in either mode of megakernel_culled: resume the saved state or start;
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

// The resident tables in shared memory: the camera vector, the sphere
// geometry packed for sweep_packed, the triangle table row-major. Returns
// the queue kernel's segment sweep: sweep_packed, its winner
// settled in today's arithmetic (settle_winner), then the triangles.
// Shading reads the winner's centre and material from the row-major table
// in device memory.
template <bool kMotion>
struct ResidentSweep {
  rz::PackedSpheres ps;
  const float* tri;   // [20, m] in shared memory
  int n, m;
  unsigned long long* stats;
  __device__ __forceinline__ void operator()(const rz::Ray& r,
                                             const rz::RayTerms& t, int from,
                                             float& qb, int& best,
                                             bool& is_tri) const {
    const rz::RayCoef c = rz::ray_coef(r, t);
    int second = -1, graze = -1;
    rz::sweep_packed<kMotion>(ps, n, c, qb, best, second, graze);
    if (rz::settle_winner<kMotion>(ps, n, from, r, t, c, qb, best, second,
                                   graze) &&
        stats)
      atomicAdd(stats + rz::kStatResweeps, 1ull);
    rz::sweep_triangles(tri, m, r, t, qb, best, is_tri);
  }
};

template <bool kMotion>
__device__ __forceinline__ ResidentSweep<kMotion> stage_resident(
    const float* cam, const float* stab, int n, const float* ttab, int m,
    unsigned long long* stats, float* smem) {
  for (int i = threadIdx.x; i < 18; i += blockDim.x) smem[i] = cam[i];
  const rz::PackedSpheres ps =
      rz::stage_spheres<kMotion>(stab, n, smem + rz::kCamWords);
  float* s_tri = smem + rz::kCamWords + rz::packed_words<kMotion>(n);
  for (int i = threadIdx.x; i < rz::kTRows * m; i += blockDim.x)
    s_tri[i] = ttab[i];
  __syncthreads();
  return ResidentSweep<kMotion>{ps, s_tri, n, m, stats};
}

// Dynamic shared memory of the queue kernel.
size_t resident_smem(bool motion, int n, int m) {
  return sizeof(float) *
         (rz::kCamWords +
          static_cast<size_t>(motion ? rz::packed_words<true>(n)
                                     : rz::packed_words<false>(n)) +
          rz::kTRows * static_cast<size_t>(m));
}

// The resident mode's main path: a persistent grid whose lanes take
// (sample, pixel) items from one counter in device memory (sample-major,
// so a warp's items are neighbouring pixels of one sample). A warp claims
// kRun items with one atomicAdd and hands them to its lanes as they free
// up (__ballot_sync/__popc), so a lane is never held by its pixel's other
// samples: the per-pixel straggler tail of a thread per pixel slot is gone,
// and only the queue's last paths leave lanes idle. Each item
// traces one camera sample to its end with today's keys (sample numbers
// s + 1, bounces 0..) and writes its radiance, the sky term or 0, to
// out[sample - s0, channel, pixel]; fold_kernel then adds a pixel's samples
// in sample order from 0.0f, the association of a thread that runs its
// pixel's samples in turn (the plain version, _trace_slots_reference), so
// the schedule changes no bit of the image.
struct QueueParams {
  const float* cam;   // [18]
  const float* stab;  // [17, n_pad]
  const float* ttab;  // [20, m_pad]
  int n_pad, m_pad, n_pix, width, max_depth;
  int s0, n_samples;  // the samples [s0, s0 + n_samples) of every pixel
  float t_min;
  uint32_t seed;
  bool jitter;
  unsigned long long* counter;  // items claimed so far (0 at launch)
  float* out;                   // [n_samples, 3, n_pix]
  unsigned long long* stats;    // [8] or null
};

constexpr int kRun = 64;  // items a warp claims with one atomicAdd

template <bool kMotion>
__global__ void __launch_bounds__(128, 8) megakernel_queue(QueueParams p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const ResidentSweep<kMotion> sweep = stage_resident<kMotion>(
      p.cam, p.stab, p.n_pad, p.ttab, p.m_pad, p.stats, smem);
  constexpr unsigned kFull = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const unsigned long long total =
      static_cast<unsigned long long>(p.n_samples) * p.n_pix;
  // the warp's claimed run (warp-uniform): items [run_end - run_left,
  // run_end) are still to hand out; drained once a claim reached the end
  unsigned long long run_end = 0;
  int run_left = 0;
  bool drained = false;

  rz::Ray r;
  float thx = 0.0f, thy = 0.0f, thz = 0.0f, ar = 0.0f, ag = 0.0f, ab = 0.0f;
  int depth = 0, pix = 0, sample = 0, from = -1;
  uint32_t key0 = 0;
  bool active = false, spawn = false;
  unsigned int segments = 0, trips = 0;
  while (true) {
    const unsigned need = __ballot_sync(kFull, !active);
    if (need) {
      const int k = __popc(need);
      const bool refill = k > run_left && !drained;
      unsigned long long fresh = 0;
      if (refill) {
        if (lane == 0)
          fresh = atomicAdd(p.counter, static_cast<unsigned long long>(kRun));
        fresh = __shfl_sync(kFull, fresh, 0);
      }
      if (!active) {
        const int rank = __popc(need & ((1u << lane) - 1u));
        unsigned long long item = total;
        if (rank < run_left)
          item = run_end - run_left + rank;
        else if (refill)
          item = fresh + (rank - run_left);
        if (item < total) {
          sample = p.s0 + static_cast<int>(item / p.n_pix);
          pix = static_cast<int>(item % p.n_pix);
          key0 = rz::slot_key(p.seed, pix);
          depth = p.max_depth;
          active = spawn = true;
        }
      }
      if (refill) {
        run_left = kRun - (k - run_left);
        run_end = fresh + kRun;
        drained = run_end >= total;
      } else {
        run_left = run_left > k ? run_left - k : 0;
      }
    }
    if (!__any_sync(kFull, active)) break;
    ++trips;
    if (!active) continue;
    ++segments;
    const uint32_t key = rz::step_key(key0, sample + 1, p.max_depth - depth);
    if (spawn) {
      rz::camera_ray(smem, static_cast<float>(pix % p.width),
                     static_cast<float>(pix / p.width), p.jitter, key, r);
      thx = thy = thz = 1.0f;
      ar = ag = ab = 0.0f;
      spawn = false;
      from = -1;
    }
    const rz::RayTerms t = rz::ray_terms(r, p.t_min);
    float qb = rz::kBig;
    int best = -1;
    bool is_tri = false;
    sweep(r, t, from, qb, best, is_tri);
    if (rz::shade<kMotion>(p.stab, p.n_pad, sweep.tri, p.m_pad, r, t, qb,
                           best, is_tri, rz::KeyDraws{key}, thx, thy, thz,
                           ar, ag, ab) == rz::Bounce::kContinued) {
      depth -= 1;
      active = depth > 0;  // depth exhausted -> black
      from = is_tri ? -1 : best;
    } else {
      active = false;  // the sky, or absorbed
    }
    if (!active) {
      float* o = p.out + static_cast<size_t>(sample - p.s0) * 3 * p.n_pix +
                 pix;
      o[0] = ar;
      o[static_cast<size_t>(p.n_pix)] = ag;
      o[2 * static_cast<size_t>(p.n_pix)] = ab;
    }
  }
  if (p.stats) {
    const unsigned int seg = __reduce_add_sync(kFull, segments);
    if (lane == 0) {
      atomicAdd(p.stats, static_cast<unsigned long long>(seg));
      atomicAdd(p.stats + rz::kStatLaneTrips,
                32ull * static_cast<unsigned long long>(trips));
    }
  }
}

// Sample-order fold of the queue's radiance: acc[i] += out[s, i] for s =
// 0, 1, ... in turn (acc starts at 0.0f), over the 3 * n_pix entries.
__global__ void fold_kernel(const float* __restrict__ out, int n_samples,
                            long long plane, float* __restrict__ acc) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= plane) return;
  float v = acc[i];
  for (int s = 0; s < n_samples; ++s) v = v + out[s * plane + i];
  acc[i] = v;
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

// mode: 1 culled (sblk/tblk, blk), 2 streamed (scb/tcb, stream, sblk/tblk
// with blk, cull); the resident mode is rayz_megakernel_queue. stats: null or [8] uint64 counters (culled and
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
  if (mode == kCulled) {
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

namespace {

// Blocks of the queue kernel's persistent grid: as many as the card holds
// at once (the occupancy of this build at `smem` bytes), at most one per
// 128 items.
template <bool kMotion>
cudaError_t queue_grid(size_t smem, unsigned long long items, int& blocks) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        megakernel_queue<kMotion>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, megakernel_queue<kMotion>, 128, smem);
  if (e != cudaSuccess) return e;
  const unsigned long long most = (items + 127) / 128;
  blocks = static_cast<int>(
      most < static_cast<unsigned long long>(per_sm) * sms
          ? most
          : static_cast<unsigned long long>(per_sm) * sms);
  return blocks > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

}  // namespace

// The queue kernel over samples [s0, s0 + n_samples) of pixels [0, n_pix):
// `counter` is one zeroed uint64, `out` [n_samples, 3, n_pix] f32, `stats`
// null or [8] uint64 (segments at 0, re-sweeps at rz::kStatResweeps, the
// warps' lane-trips at rz::kStatLaneTrips). `grid` receives the blocks.
extern "C" int rayz_megakernel_queue(
    const float* cam, const float* stab, int n_pad, const float* ttab,
    int m_pad, int n_pix, int width, int max_depth, float t_min, int jitter,
    int has_motion, unsigned int seed, int s0, int n_samples, void* counter,
    float* out, void* stats, int* grid, void* stream) {
  QueueParams p;
  p.cam = cam;
  p.stab = stab;
  p.ttab = ttab;
  p.n_pad = n_pad;
  p.m_pad = m_pad;
  p.n_pix = n_pix;
  p.width = width;
  p.max_depth = max_depth;
  p.s0 = s0;
  p.n_samples = n_samples;
  p.t_min = t_min;
  p.seed = seed;
  p.jitter = jitter != 0;
  p.counter = static_cast<unsigned long long*>(counter);
  p.out = out;
  p.stats = static_cast<unsigned long long*>(stats);
  const bool motion = has_motion != 0;
  const size_t smem = resident_smem(motion, n_pad, m_pad);
  const unsigned long long items =
      static_cast<unsigned long long>(n_samples) * n_pix;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int blocks = 0;
  cudaError_t e = motion ? queue_grid<true>(smem, items, blocks)
                         : queue_grid<false>(smem, items, blocks);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (motion)
    megakernel_queue<true><<<blocks, 128, smem, s>>>(p);
  else
    megakernel_queue<false><<<blocks, 128, smem, s>>>(p);
  *grid = blocks;
  return static_cast<int>(cudaGetLastError());
}

// acc [plane] += out[s, :] for s = 0 .. n_samples - 1, in turn.
extern "C" int rayz_fold(const float* out, int n_samples, long long plane,
                         float* acc, void* stream) {
  const int threads = 256;
  const long long blocks = (plane + threads - 1) / threads;
  fold_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                static_cast<cudaStream_t>(stream)>>>(out, n_samples, plane,
                                                     acc);
  return static_cast<int>(cudaGetLastError());
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
