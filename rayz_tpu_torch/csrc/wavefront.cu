// Wavefront (bounce-synchronous) path-tracing kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel rayz_tpu/ops/wavefront.py:_wf_kernel (launched by
// _render_wavefront_impl). One launch runs one bounce for every ray, or, in
// the tail launch, the surviving rays to full depth: nearest hit (full,
// block-culled, or streamed through superclusters, chunks and blocks),
// then the megakernel's shading (rz::shade: sky on a miss, hit frame,
// material scatter), emitting each ray's new state, alive flag and the
// radiance it added. The host sorts and partitions the rays between
// launches (ops/wavefront.py), so a block's rays are coherent and its bound
// tests prune on every bounce.
//
// What bounds it on the H100: the same FP32 quadratic per primitive as the
// megakernel, times the primitives that survive the bound tests. The design
// keeps the TPU's tile-wide pruning: one CUDA block is one tile of 128 rays,
// and every bound test is a block-uniform vote (__syncthreads_or): the
// block enters a supercluster, chunk or block if ANY of its rays may hit it
// nearer than that ray's current best (inside, each thread still skips what
// its own test rejects). A vote is a barrier, so every thread reaches every
// vote: no thread returns early, and a dead ray votes false. Superclusters
// and chunks are visited twice, first those overlapping the tile's own
// origin bound (a block reduction over its live rays), then the rest, so
// the best distance collapses on the tile's neighbourhood before the
// far-away geometry is tested ("local-first").
//
// Table modes (template parameter kMode):
//  * kResident: the full tables in shared memory, every column swept.
//  * kCulled: Morton-sorted tables and block rows in shared memory; blocks
//    near the tile first, then the rest.
//  * kStreamed: tables and block rows in device memory, read straight
//    through L1/L2 (no staging: a sweep reads each column once per ray and
//    the warp's threads read the same column, so one cached line serves 32
//    columns of a row; staging would add a block-wide copy and barrier per
//    chunk for no reuse); the chunk and supercluster bound rows sit in
//    shared memory.
//
// Fault repaired against the reference: the TPU kernel's near pass enters a
// supercluster only if it overlaps the tile bound and then takes its near
// chunks, while its far pass takes only the far chunks. A chunk's bounding
// sphere can stick out of its supercluster's (the two bound different
// boxes), so a chunk can be near while its supercluster is not, and then
// no pass sweeps it. Here a chunk counts as near only if its supercluster
// is near too, so the two passes split the chunks exactly.
//
// Random draws are keyed as the megakernel's: step_key(slot_key(seed,
// pixel), sample + 1, bounce), draws 0-4 for the camera ray and 5-8 for the
// scatter. A ray therefore follows the path the megakernel traces for the
// same pixel and sample, and the two engines render the same image.
//
// C interface for ctypes (see ops/_build.py): rayz_wavefront returns the
// cudaError_t of its launch.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kBlock = 128;  // rays per tile
constexpr int kWarps = kBlock / 32;
constexpr int kHeadWords = 48;  // camera, reduction scratch (WF_HEAD_WORDS)
constexpr float kInf = 3.0e38f;

enum : int { kResident = 0, kCulled = 1, kStreamed = 2 };

struct WfParams {
  const float* cam;     // [18]
  const float* stab;    // [17, n_pad]
  const float* ttab;    // [20, m_pad]
  const float* sblk;    // [4, n_pad / blk] block rows
  const float* tblk;    // [4, m_pad / blk]
  const float* scb;     // [4, n_pad / stream] chunk bounds
  const float* tcb;     // [4, m_pad / stream]
  const float* ssc;     // [4, n_pad / (stream * sc_s)] supercluster bounds
  const float* tsc;     // [4, m_pad / (stream * sc_t)]
  const float* st_in;   // [10, r_pad] or null: spawn camera rays
  const int* alive_in;  // [r_pad] (ignored when spawning)
  const int* rid;       // [r_pad] ray id = sample * n_px + patch slot
  const int* slot_pix;  // [n_px] patch slot -> flat pixel id
  float* st_out;        // [10, r_pad]
  int* alive_out;       // [r_pad]
  float* rad;           // [3, r_pad] radiance added by this launch
  unsigned long long* stats;  // [8] work counters (rz::Work) or null
  int n_pad, m_pad, blk, stream, sc_s, sc_t;  // sc_*: 0 = no superclusters
  int r_pad, n_rays, n_px, width;
  int bounce, loop_bounces;
  float t_min;
  uint32_t seed;
  bool jitter, cull;
};

// The tile's origin bound over its live rays: centre and radius.
struct Tile {
  float cx, cy, cz, r;
};

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(0xFFFFFFFFu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xFFFFFFFFu, v, o));
  return v;
}

// Block reduction (all threads call it; all get the same result):
// centre = midpoint of the live origins' min and max per axis, radius =
// the largest distance of a live origin from it.
__device__ __forceinline__ Tile tile_bound(const rz::Ray& r, bool active,
                                           float* s_red) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float v[6] = {warp_min(active ? r.ox : kInf), warp_min(active ? r.oy : kInf),
                warp_min(active ? r.oz : kInf),
                warp_max(active ? r.ox : -kInf),
                warp_max(active ? r.oy : -kInf),
                warp_max(active ? r.oz : -kInf)};
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < 6; ++q) s_red[q * kWarps + warp] = v[q];
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    float x = s_red[q * kWarps];
    for (int k = 1; k < kWarps; ++k)
      x = q < 3 ? fminf(x, s_red[q * kWarps + k])
                : fmaxf(x, s_red[q * kWarps + k]);
    v[q] = x;
  }
  Tile t;
  t.cx = 0.5f * (v[0] + v[3]);
  t.cy = 0.5f * (v[1] + v[4]);
  t.cz = 0.5f * (v[2] + v[5]);
  const float ex = r.ox - t.cx;
  const float ey = r.oy - t.cy;
  const float ez = r.oz - t.cz;
  const float d2 = warp_max(active ? ex * ex + ey * ey + ez * ez : 0.0f);
  if (lane == 0) s_red[6 * kWarps + warp] = d2;
  __syncthreads();
  float m = s_red[6 * kWarps];
  for (int k = 1; k < kWarps; ++k) m = fmaxf(m, s_red[6 * kWarps + k]);
  t.r = sqrtf(m);
  return t;
}

// Whether bound i of a [4, stride] bound table overlaps the tile's origin
// bound (block-uniform: every thread computes it from the same values).
__device__ __forceinline__ bool is_near(const float* rows, int stride, int i,
                                        const Tile& tile) {
  const float bx = rows[i];
  const float by = rows[stride + i];
  const float bz = rows[2 * stride + i];
  const float ccb = rows[3 * stride + i];
  const float br =
      sqrtf(rz::clamp_min(bx * bx + by * by + bz * bz - ccb, 0.0f));
  const float ex = bx - tile.cx;
  const float ey = by - tile.cy;
  const float ez = bz - tile.cz;
  const float lim = tile.r + br;
  return ex * ex + ey * ey + ez * ez <= lim * lim;
}

// Per-ray nearest-hit state threaded through the sweeps.
struct Hit {
  float qb = rz::kBig;
  int best = -1;
  bool is_tri = false;
};

template <bool kMotion, bool kTri>
__device__ __forceinline__ void sweep_cols(const float* tab, int stride,
                                           int j0, int j1, const rz::Ray& r,
                                           const rz::RayTerms& t, Hit& h,
                                           rz::Work& w) {
  w.prims += j1 - j0;
  if (kTri)
    rz::sweep_triangles(tab, stride, j0, j1, r, t, h.qb, h.best, h.is_tri);
  else
    rz::sweep_spheres<kMotion>(tab, stride, j0, j1, r, t, h.qb, h.best);
}

// One voted bound: the ray's own test, then the tile's vote. Returns the
// vote; `mine` is the ray's own result.
__device__ __forceinline__ bool vote(const float* rows, int stride, int i,
                                     bool active, const rz::Ray& r,
                                     const rz::RayTerms& t, float qb,
                                     bool& mine, rz::Work& w) {
  mine = active && rz::bound_possible(rows, stride, i, r, t, qb);
  if (active) ++w.bounds;
  return __syncthreads_or(mine) != 0;
}

// Blocks [b0, b1) of one class behind voted bound tests. `pass` 0 takes
// the blocks near the tile, 1 the rest, -1 all (one pass).
template <bool kMotion, bool kTri>
__device__ void sweep_blocks(const float* tab, int stride, const float* brows,
                             int nb, int blk, int b0, int b1, int pass,
                             const Tile& tile, bool active, const rz::Ray& r,
                             const rz::RayTerms& t, Hit& h, rz::Work& w,
                             bool count_votes) {
  for (int b = b0; b < b1; ++b) {
    if (pass >= 0 && is_near(brows, nb, b, tile) != (pass == 0)) continue;
    bool mine;
    const bool any = vote(brows, nb, b, active, r, t, h.qb, mine, w);
    if (count_votes && threadIdx.x == 0) {
      ++w.votes;
      w.passed += any;
    }
    if (any && mine)
      sweep_cols<kMotion, kTri>(tab, stride, b * blk, (b + 1) * blk, r, t, h,
                                w);
  }
}

// Chunk c of a streamed class, if its near-ness (`sc_near` and its own
// overlap with the tile) matches `want_near` and the tile votes for it.
template <bool kMotion, bool kTri>
__device__ void stream_chunk(const float* tab, int n, const float* cb,
                             const float* brows, const WfParams& p, int c,
                             bool want_near, bool sc_near, const Tile& tile,
                             bool active, const rz::Ray& r,
                             const rz::RayTerms& t, Hit& h, rz::Work& w) {
  const int nc = n / p.stream;
  if ((sc_near && is_near(cb, nc, c, tile)) != want_near) return;
  bool mine;
  const bool any = vote(cb, nc, c, active, r, t, h.qb, mine, w);
  if (threadIdx.x == 0) {
    ++w.votes;
    w.passed += any;
  }
  if (!any) return;
  if (p.blk) {
    const int per = p.stream / p.blk;
    sweep_blocks<kMotion, kTri>(tab, n, brows, n / p.blk, p.blk, c * per,
                                (c + 1) * per, -1, tile, active, r, t, h, w,
                                false);
  } else if (mine) {
    sweep_cols<kMotion, kTri>(tab, n, c * p.stream, (c + 1) * p.stream, r, t,
                              h, w);
  }
}

// One streamed class: superclusters (where enabled), chunks, blocks, with
// the tile-local pass first.
template <bool kMotion, bool kTri>
__device__ void sweep_stream(const float* tab, int n, const float* cb,
                             const float* sc, int g, const float* brows,
                             const WfParams& p, const Tile& tile, bool active,
                             const rz::Ray& r, const rz::RayTerms& t, Hit& h,
                             rz::Work& w) {
  if (n == 0) return;
  if (!p.cull) {  // every chunk, untested
    if (active) sweep_cols<kMotion, kTri>(tab, n, 0, n, r, t, h, w);
    return;
  }
  const int nc = n / p.stream;
  for (int pass = 0; pass < 2; ++pass) {
    if (g) {
      const int ns = nc / g;
      for (int s = 0; s < ns; ++s) {
        const bool sc_near = is_near(sc, ns, s, tile);
        if (pass == 0 && !sc_near) continue;
        bool mine;
        if (!vote(sc, ns, s, active, r, t, h.qb, mine, w)) continue;
        for (int k = 0; k < g; ++k)
          stream_chunk<kMotion, kTri>(tab, n, cb, brows, p, s * g + k,
                                      pass == 0, sc_near, tile, active, r, t,
                                      h, w);
      }
    } else {
      for (int c = 0; c < nc; ++c)
        stream_chunk<kMotion, kTri>(tab, n, cb, brows, p, c, pass == 0, true,
                                    tile, active, r, t, h, w);
    }
  }
}

template <bool kMotion, int kMode>
__global__ void __launch_bounds__(kBlock) wavefront_kernel(WfParams p) {
  extern __shared__ float smem[];
  float* s_cam = smem;
  float* s_red = smem + rz::kCamWords;
  float* s_tab = smem + kHeadWords;
  for (int i = threadIdx.x; i < 18; i += kBlock) s_cam[i] = p.cam[i];
  const float* sph;
  const float* tri;
  const float* sbl = nullptr;
  const float* tbl = nullptr;
  const float* scb = nullptr;
  const float* tcb = nullptr;
  const float* ssc = nullptr;
  const float* tsc = nullptr;
  if constexpr (kMode == kStreamed) {
    // bound rows of the chunks and superclusters, both classes
    const int ncs = p.n_pad / p.stream;
    const int nct = p.m_pad / p.stream;
    const int nss = p.sc_s ? ncs / p.sc_s : 0;
    const int nst = p.sc_t ? nct / p.sc_t : 0;
    float* s_scb = s_tab;
    float* s_tcb = s_scb + 4 * ncs;
    float* s_ssc = s_tcb + 4 * nct;
    float* s_tsc = s_ssc + 4 * nss;
    for (int i = threadIdx.x; i < 4 * ncs; i += kBlock) s_scb[i] = p.scb[i];
    for (int i = threadIdx.x; i < 4 * nct; i += kBlock) s_tcb[i] = p.tcb[i];
    for (int i = threadIdx.x; i < 4 * nss; i += kBlock) s_ssc[i] = p.ssc[i];
    for (int i = threadIdx.x; i < 4 * nst; i += kBlock) s_tsc[i] = p.tsc[i];
    scb = s_scb;
    tcb = s_tcb;
    ssc = s_ssc;
    tsc = s_tsc;
    sph = p.stab;
    tri = p.ttab;
    sbl = p.sblk;
    tbl = p.tblk;
  } else {
    float* s_sph = s_tab;
    float* s_tri = s_sph + rz::kSRows * p.n_pad;
    for (int i = threadIdx.x; i < rz::kSRows * p.n_pad; i += kBlock)
      s_sph[i] = p.stab[i];
    for (int i = threadIdx.x; i < rz::kTRows * p.m_pad; i += kBlock)
      s_tri[i] = p.ttab[i];
    if constexpr (kMode == kCulled) {
      float* s_sbl = s_tri + rz::kTRows * p.m_pad;
      float* s_tbl = s_sbl + 4 * (p.n_pad / p.blk);
      for (int i = threadIdx.x; i < 4 * (p.n_pad / p.blk); i += kBlock)
        s_sbl[i] = p.sblk[i];
      for (int i = threadIdx.x; i < 4 * (p.m_pad / p.blk); i += kBlock)
        s_tbl[i] = p.tblk[i];
      sbl = s_sbl;
      tbl = s_tbl;
    }
    sph = s_sph;
    tri = s_tri;
  }
  __syncthreads();

  // r_pad is a multiple of the block: every thread owns a ray slot
  const size_t i = static_cast<size_t>(blockIdx.x) * kBlock + threadIdx.x;
  const size_t rp = static_cast<size_t>(p.r_pad);
  const int rid = p.rid[i];
  const int pix = p.slot_pix[rid % p.n_px];
  const int sample = rid / p.n_px + 1;
  const uint32_t key0 = rz::slot_key(p.seed, pix);

  rz::Ray r;
  float thx, thy, thz;
  bool active;
  if (p.st_in == nullptr) {
    // ---- camera ray: the megakernel's spawn (draws 0-4 at bounce 0) ----
    rz::camera_ray(s_cam, static_cast<float>(pix % p.width),
                   static_cast<float>(pix / p.width), p.jitter,
                   rz::step_key(key0, sample, 0), r);
    thx = thy = thz = 1.0f;
    active = rid < p.n_rays;  // padding rays are never alive
  } else {
    const float* st = p.st_in + i;
    r.ox = st[0 * rp];
    r.oy = st[1 * rp];
    r.oz = st[2 * rp];
    r.dx = st[3 * rp];
    r.dy = st[4 * rp];
    r.dz = st[5 * rp];
    r.tau = st[6 * rp];
    thx = st[7 * rp];
    thy = st[8 * rp];
    thz = st[9 * rp];
    active = p.alive_in[i] > 0;
  }

  float ar = 0.0f, ag = 0.0f, ab = 0.0f;
  rz::Work w;
  // One bounce per trip; the tail launch runs up to loop_bounces. The
  // condition is a block-wide vote: a tile with no live ray is done (the
  // TPU's dead-tile skip and its tail-loop condition).
  for (int it = 0; it < p.loop_bounces; ++it) {
    if (!__syncthreads_or(active)) break;
    const uint32_t key = rz::step_key(key0, sample, p.bounce + it);
    const rz::RayTerms t = rz::ray_terms(r, p.t_min);
    Hit h;
    if (active) ++w.segments;
    if constexpr (kMode == kResident) {
      if (active) {
        sweep_cols<kMotion, false>(sph, p.n_pad, 0, p.n_pad, r, t, h, w);
        sweep_cols<kMotion, true>(tri, p.m_pad, 0, p.m_pad, r, t, h, w);
      }
    } else {
      const Tile tile = tile_bound(r, active, s_red);
      if constexpr (kMode == kCulled) {
        for (int pass = 0; pass < 2; ++pass) {
          sweep_blocks<kMotion, false>(sph, p.n_pad, sbl, p.n_pad / p.blk,
                                       p.blk, 0, p.n_pad / p.blk, pass, tile,
                                       active, r, t, h, w, true);
        }
        for (int pass = 0; pass < 2; ++pass) {
          sweep_blocks<kMotion, true>(tri, p.m_pad, tbl, p.m_pad / p.blk,
                                      p.blk, 0, p.m_pad / p.blk, pass, tile,
                                      active, r, t, h, w, true);
        }
      } else {
        sweep_stream<kMotion, false>(sph, p.n_pad, scb, ssc, p.sc_s, sbl, p,
                                     tile, active, r, t, h, w);
        sweep_stream<kMotion, true>(tri, p.m_pad, tcb, tsc, p.sc_t, tbl, p,
                                    tile, active, r, t, h, w);
      }
    }
    if (active) {
      active = rz::shade<kMotion>(sph, p.n_pad, tri, p.m_pad, r, t, h.qb,
                                  h.best, h.is_tri, rz::KeyDraws{key}, thx,
                                  thy, thz, ar, ag,
                                  ab) == rz::Bounce::kContinued;
    }
  }

  float* st = p.st_out + i;
  st[0 * rp] = r.ox;
  st[1 * rp] = r.oy;
  st[2 * rp] = r.oz;
  st[3 * rp] = r.dx;
  st[4 * rp] = r.dy;
  st[5 * rp] = r.dz;
  st[6 * rp] = r.tau;
  st[7 * rp] = thx;
  st[8 * rp] = thy;
  st[9 * rp] = thz;
  p.alive_out[i] = active ? 1 : 0;
  p.rad[0 * rp + i] = ar;
  p.rad[1 * rp + i] = ag;
  p.rad[2 * rp + i] = ab;
  if (p.stats) rz::flush_work(w, p.stats);
}

template <bool kMotion, int kMode>
cudaError_t launch(const WfParams& p, size_t smem, cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        wavefront_kernel<kMotion, kMode>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  wavefront_kernel<kMotion, kMode><<<p.r_pad / kBlock, kBlock, smem, s>>>(p);
  return cudaGetLastError();
}

template <int kMode>
cudaError_t launch_mode(const WfParams& p, bool motion, size_t smem,
                        cudaStream_t s) {
  return motion ? launch<true, kMode>(p, smem, s)
                : launch<false, kMode>(p, smem, s);
}

}  // namespace

// mode: 0 resident, 1 culled (sblk/tblk, blk), 2 streamed (scb/tcb,
// ssc/tsc with sc_s/sc_t, sblk/tblk with blk, stream, cull). st_in null =
// spawn the camera rays. smem_bytes: the wrapper's accounting of the
// dynamic shared memory (ops/tables.py wavefront_shared_bytes).
extern "C" int rayz_wavefront(
    const float* cam, const float* stab, int n_pad, const float* ttab,
    int m_pad, int mode, const float* sblk, const float* tblk, int blk,
    const float* scb, const float* tcb, const float* ssc, const float* tsc,
    int stream_cols, int sc_s, int sc_t, int cull, const float* st_in,
    const int* alive_in, const int* rid, const int* slot_pix, float* st_out,
    int* alive_out, float* rad, int r_pad, int n_rays, int n_px, int width,
    int bounce, int loop_bounces, float t_min, int jitter, int has_motion,
    unsigned int seed, int smem_bytes, void* stats, void* stream) {
  if (r_pad % kBlock) return static_cast<int>(cudaErrorInvalidValue);
  WfParams p;
  p.cam = cam;
  p.stab = stab;
  p.ttab = ttab;
  p.sblk = sblk;
  p.tblk = tblk;
  p.scb = scb;
  p.tcb = tcb;
  p.ssc = ssc;
  p.tsc = tsc;
  p.st_in = st_in;
  p.alive_in = alive_in;
  p.rid = rid;
  p.slot_pix = slot_pix;
  p.st_out = st_out;
  p.alive_out = alive_out;
  p.rad = rad;
  p.stats = static_cast<unsigned long long*>(stats);
  p.n_pad = n_pad;
  p.m_pad = m_pad;
  p.blk = blk;
  p.stream = stream_cols;
  p.sc_s = sc_s;
  p.sc_t = sc_t;
  p.r_pad = r_pad;
  p.n_rays = n_rays;
  p.n_px = n_px;
  p.width = width;
  p.bounce = bounce;
  p.loop_bounces = loop_bounces;
  p.t_min = t_min;
  p.seed = seed;
  p.jitter = jitter != 0;
  p.cull = cull != 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool motion = has_motion != 0;
  const size_t smem = static_cast<size_t>(smem_bytes);
  cudaError_t e;
  switch (mode) {
    case kResident:
      e = launch_mode<kResident>(p, motion, smem, s);
      break;
    case kCulled:
      e = launch_mode<kCulled>(p, motion, smem, s);
      break;
    case kStreamed:
      e = launch_mode<kStreamed>(p, motion, smem, s);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
