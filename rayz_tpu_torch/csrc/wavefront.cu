// Wavefront (bounce-synchronous) path-tracing kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel rayz_tpu/ops/wavefront.py:_wf_kernel (launched by
// _render_wavefront_impl). One launch runs one bounce for every ray, or, in
// the tail launch, the surviving rays to full depth: nearest hit (full,
// block-culled, or streamed through superclusters, chunks and blocks),
// then the megakernel's shading (rz::shade: sky on a miss, hit frame,
// material scatter), emitting each ray's new state, alive flag and the
// radiance it added. The host sorts and partitions the rays between
// launches (ops/wavefront.py), so a warp's rays are coherent and its bound
// tests prune on every bounce. The bounce launches give each thread one
// slot; the tail launch (loop_bounces > 1, its own instantiation) is a ray
// queue over a persistent grid (tail_queue): a lane whose path ends takes
// the next live slot, so the tail's long paths no longer hold warps whose
// other lanes have ended.
//
// What bounds it on the H100: the same FP32 quadratic per primitive as the
// megakernel, times the primitives that survive the bound tests, and the
// bound tests themselves (about two per primitive test at 100k spheres).
// The design keeps the TPU's tile-wide pruning at the width of a warp: one
// warp is one tile of 32 rays (a block holds four independent tiles), and
// every bound test is a warp vote (__any_sync): the warp enters a
// supercluster, chunk or block if ANY of its rays may hit it nearer than
// that ray's current best. Inside, a lane tests the bounds below and sweeps
// only where its own test passed: the bounds are conservative, so a ray
// whose own test rejects a supercluster or chunk can hit nothing in it (a
// tile vote alone made every live ray test every block of an entered
// chunk, twice the bound tests of each ray's own tests). No block barrier
// is taken after the tables are staged: a warp whose rays are all dead
// leaves the loop, and a tile of 128 rays with one live ray no longer
// holds four warps. The host's Morton sort makes 32
// neighbouring rays coherent. Superclusters and chunks are visited twice,
// first those overlapping the warp's own origin bound (a warp reduction
// over its live rays), then the rest, so the best distance collapses on
// the tile's neighbourhood before the far-away geometry is tested
// ("local-first").
//
// Table modes (template parameter kMode):
//  * kResident: the full tables in shared memory, every column swept.
//  * kCulled: Morton-sorted tables and block rows in shared memory; blocks
//    near the tile first, then the rest.
//  * kStreamed: tables and block rows in device memory; the chunk and
//    supercluster bound rows sit in shared memory. When a warp enters a
//    block of columns, each lane loads one column's sweep words (the rows
//    the sweep reads: coalesced, 32 consecutive floats of a row) into the
//    warp's staging buffer in shared memory as 16-byte records. Where many
//    of its rays entered the block, every lane whose own test passed sweeps
//    the block from there; where few did (at most kColumnsUpTo; on 78% of
//    the lane slots of the 100k scene's sweeps a ray per lane did no work),
//    the warp takes those rays in turn, a column per lane, and keeps the
//    nearest hit by a warp reduction. Both use sweep_spheres'
//    (sweep_triangles') expressions and tie order, so the winners keep their
//    bits. Each thread parks its throughput and radiance in shared memory
//    through the sweep, and the warps keep their work counters there.
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
// `stats` (optional, [8] uint64): segments (0), primitive tests (1), bound
// tests (2), votes (3) and those passed (4), the lane slots of primitive
// tests (6, rz::kStatLaneTrips); the tail launch also its warps' trips (5:
// segments / (32 * trips) is its live-lane share) and the rays its lanes
// took after their first (7).
//
// C interface for ctypes (see ops/_build.py): rayz_wavefront returns the
// cudaError_t of its launch.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kBlock = 128;  // rays per block: four warp tiles
constexpr int kWarps = kBlock / 32;
// The head of shared memory (WF_HEAD_WORDS): the camera (20 words), then
// each warp's work counters (kCount words, rz::Work's slots and the lane
// slots at rz::kStatLaneTrips).
constexpr int kCount = 8;
constexpr int kHeadWords = 20 + kWarps * kCount;
// Staging words per warp (WF_STAGE_WORDS / 4): 32 columns of 12 triangle
// words, or of 9 sphere words with motion; then the warp's 32 rays and
// their terms (12 words each), which the column-parallel sweep reads.
constexpr int kStageWords = 32 * 12 + 32 * 12;
// A staged block is swept a column per lane (sweep_columns) when at most
// this many of the warp's rays enter it, else a ray per lane.
constexpr int kColumnsUpTo = 16;
// Streamed, each thread parks its throughput and radiance (6 words) in
// shared memory while it sweeps (WF_PARK_WORDS / kBlock).
constexpr int kParkWords = 6;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kInf = 3.0e38f;
// Slots a warp of the tail launch claims with one atomicAdd once a claim
// found no live slot.
constexpr int kRun = 32;

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
  unsigned long long* counter;  // [1] the tail's slot counter, zeroed
  unsigned long long* stats;  // [8] work counters or null
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
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Warp reduction (every lane calls it; all get the same result): centre =
// midpoint of the live origins' min and max per axis, radius = the largest
// distance of a live origin from it.
__device__ __forceinline__ Tile tile_bound(const rz::Ray& r, bool active) {
  Tile t;
  t.cx = 0.5f * (warp_min(active ? r.ox : kInf) +
                 warp_max(active ? r.ox : -kInf));
  t.cy = 0.5f * (warp_min(active ? r.oy : kInf) +
                 warp_max(active ? r.oy : -kInf));
  t.cz = 0.5f * (warp_min(active ? r.oz : kInf) +
                 warp_max(active ? r.oz : -kInf));
  const float ex = r.ox - t.cx;
  const float ey = r.oy - t.cy;
  const float ez = r.oz - t.cz;
  t.r = sqrtf(warp_max(active ? ex * ex + ey * ey + ez * ez : 0.0f));
  return t;
}

// Whether bound i of a [4, stride] bound table overlaps the tile's origin
// bound (warp-uniform: every lane computes it from the same values).
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

// The warp's work counters in shared memory (null: not counting), kept by
// lane 0 from the warp's ballots, so that no lane carries them in
// registers through the sweeps.
// Slot 6 is rz::kStatLaneTrips; 5 and 7 count only in the tail launch.
enum : int { kSegments = 0, kPrims = 1, kBounds = 2, kVotes = 3,
             kPassed = 4, kTailTrips = 5, kTailAgain = 7 };

__device__ __forceinline__ void count(unsigned int* cnt, int slot,
                                      unsigned int n) {
  if (cnt && (threadIdx.x & 31) == 0) cnt[slot] += n;
}

// Columns [j0, j1) of a table in shared memory (resident, culled): the
// lane's own sweep.
template <bool kMotion, bool kTri>
__device__ __forceinline__ void sweep_cols(const float* tab, int stride,
                                           int j0, int j1, const rz::Ray& r,
                                           const rz::RayTerms& t, Hit& h) {
  if (kTri)
    rz::sweep_triangles(tab, stride, j0, j1, r, t, h.qb, h.best, h.is_tri);
  else
    rz::sweep_spheres<kMotion>(tab, stride, j0, j1, r, t, h.qb, h.best);
}

// Staged column j (the records at shared-space address s0) against the
// ray: rz::sweep_triangles' (rz::sweep_spheres') test with its
// expressions, true where the column hits nearer than qb, its distance in
// q.
template <bool kMotion, bool kTri>
__device__ __forceinline__ bool staged_hit(uint32_t s0, int j,
                                           const rz::Ray& r,
                                           const rz::RayTerms& t, float qb,
                                           float& q) {
  if constexpr (kTri) {
    const float4 nv = rz::lds128(s0 + 16u * j);
    const float ndd = r.dx * nv.x + r.dy * nv.y + r.dz * nv.z;
    const float ndo = r.ox * nv.x + r.oy * nv.y + r.oz * nv.z;
    const float rcp = 1.0f / ndd;
    const float tt = (nv.w - ndo) * rcp;
    q = tt * t.a;
    if (!(q >= t.tmin_a && q < qb)) return false;
    const float hx = r.ox + tt * r.dx;
    const float hy = r.oy + tt * r.dy;
    const float hz = r.oz + tt * r.dz;
    const float4 g1 = rz::lds128(s0 + 16u * (32 + j));
    const float4 g2 = rz::lds128(s0 + 16u * (64 + j));
    const float u = g1.x * hx + g1.y * hy + g1.z * hz - g1.w;
    const float v = g2.x * hx + g2.y * hy + g2.z * hz - g2.w;
    return u >= 0.0f && v >= 0.0f && u + v <= 1.0f;
  } else {
    const rz::PackedSpheres ps{s0, s0 + 16u * 32, s0 + 16u * 64};
    bool first;
    return rz::sphere_root<kMotion>(ps, j, r, t, q, first) && q < qb;
  }
}

// The staged columns (shared-space address s0; lane l's column base + l,
// l < cols) against each ray of `sweepers` in turn, a column per lane: the
// ray is read from the warp's ray stage (s0 + 16 * 96: its origin,
// direction and time and rz::RayTerms, written each bounce), each lane
// tests its own column with rz::sweep_spheres' (rz::sweep_triangles')
// expressions against the ray's best distance, and where any lane accepts
// one the warp takes the smallest distance, the lowest column at a tie:
// the winner and bits of that ray's own sweep over the columns in order.
// Warp-uniform call.
template <bool kMotion, bool kTri>
__device__ __forceinline__ void sweep_columns(uint32_t s0, int cols, int base,
                                              unsigned int sweepers, Hit& h) {
  const int lane = threadIdx.x & 31;
  const uint32_t rays = s0 + 16u * 96;
  while (sweepers) {
    const int src = __ffs(sweepers) - 1;
    sweepers &= sweepers - 1;
    const float qb = __shfl_sync(kFull, h.qb, src);
    const float4 a = rz::lds128(rays + 16u * src);
    const float4 b = rz::lds128(rays + 16u * (32 + src));
    const float4 c = rz::lds128(rays + 16u * (64 + src));
    const rz::Ray r{a.x, a.y, a.z, a.w, b.x, b.y, b.z};
    const rz::RayTerms t{b.w, c.x, c.y, c.z, c.w};
    float q = rz::kBig;
    const bool ok =
        lane < cols && staged_hit<kMotion, kTri>(s0, lane, r, t, qb, q);
    if (!__any_sync(kFull, ok)) continue;
    float qm = ok ? q : rz::kBig;
    int jm = ok ? lane : 32;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float oq = __shfl_xor_sync(kFull, qm, o);
      const int oj = __shfl_xor_sync(kFull, jm, o);
      if (oq < qm || (oq == qm && oj < jm)) {
        qm = oq;
        jm = oj;
      }
    }
    if (lane == src) {
      h.qb = qm;
      h.best = base + jm;
      h.is_tri = kTri;
    }
  }
}

// Columns [j0, j1) of a table in device memory (streamed) for the rays
// with `mine`, by the whole warp (warp-uniform call): 32 columns at a
// time, each lane stages one column's sweep words as records (spheres:
// (c, |c|^2 - r^2), with motion (v, 2 c.v) and |v|^2, as
// rz::stage_spheres lays them out; triangles: (n, n.v0), (g1, g1.v0),
// (g2, g2.v0)); then, where at most kColumnsUpTo rays sweep, a column per
// lane (sweep_columns), else each of those lanes sweeps the staged columns
// in order. Either way the winners and bits are rz::sweep_spheres'
// (rz::sweep_triangles') on the same values.
template <bool kMotion, bool kTri>
__device__ __forceinline__ void sweep_staged(const float* __restrict__ tab,
                                             int stride, int j0, int j1,
                                             bool mine, float4* stage,
                                             const rz::Ray& r,
                                             const rz::RayTerms& t, Hit& h,
                                             unsigned int* cnt) {
  const int lane = threadIdx.x & 31;
  const uint32_t s0 = static_cast<uint32_t>(__cvta_generic_to_shared(stage));
  const unsigned int sweepers = __ballot_sync(kFull, mine);
  if (!sweepers) return;
  const bool by_columns = __popc(sweepers) <= kColumnsUpTo;
  for (int base = j0; base < j1; base += 32) {
    const int cols = min(32, j1 - base);
    if (lane < cols) {
      const int j = base + lane;
      if constexpr (kTri) {
#pragma unroll
        for (int k = 0; k < 3; ++k)
          stage[32 * k + lane] = make_float4(
              tab[(4 * k) * stride + j], tab[(4 * k + 1) * stride + j],
              tab[(4 * k + 2) * stride + j], tab[(4 * k + 3) * stride + j]);
      } else {
        stage[lane] = make_float4(tab[rz::kCX * stride + j],
                                  tab[rz::kCY * stride + j],
                                  tab[rz::kCZ * stride + j],
                                  tab[rz::kCCMR2 * stride + j]);
        if (kMotion) {
          stage[32 + lane] = make_float4(tab[rz::kVX * stride + j],
                                         tab[rz::kVY * stride + j],
                                         tab[rz::kVZ * stride + j],
                                         tab[rz::kCV2 * stride + j]);
          reinterpret_cast<float*>(stage + 64)[lane] =
              tab[rz::kVV * stride + j];
        }
      }
    }
    __syncwarp();
    count(cnt, kPrims, cols * __popc(sweepers));
    if (by_columns) {
      count(cnt, rz::kStatLaneTrips, 32 * __popc(sweepers));
      sweep_columns<kMotion, kTri>(s0, cols, base, sweepers, h);
    } else {
      count(cnt, rz::kStatLaneTrips, 32 * cols);
    }
    if (!by_columns && mine) {
#pragma unroll 8
      for (int jj = 0; jj < cols; ++jj) {
        float q;
        if (staged_hit<kMotion, kTri>(s0, jj, r, t, h.qb, q)) {
          h.qb = q;
          h.best = base + jj;
          h.is_tri = kTri;
        }
      }
    }
    __syncwarp();
  }
}

// One voted bound (bound i of `rows`): each active ray's own test, then
// the warp's vote. Returns the vote; `mine` is the ray's own result.
__device__ __forceinline__ bool vote(const float* rows, int stride, int i,
                                     bool active, const rz::Ray& r,
                                     const rz::RayTerms& t, float qb,
                                     bool& mine, unsigned int* cnt) {
  mine = active && rz::bound_test(rz::bound_rec(rows, stride, i), r, t, qb);
  if (cnt) count(cnt, kBounds, __popc(__ballot_sync(kFull, active)));
  return __any_sync(kFull, mine);
}

// Blocks [b0, b1) of one class behind voted bound tests. `pass` 0 takes
// the blocks near the tile, 1 the rest, -1 all (one pass). Streamed
// (`stage` set), an entered block is staged and swept by the warp.
template <bool kMotion, bool kTri>
__device__ __forceinline__ void sweep_blocks(
    const float* tab, int stride, const float* brows, int nb, int blk,
    int b0, int b1, int pass, const Tile& tile, bool active, float4* stage,
    const rz::Ray& r, const rz::RayTerms& t, Hit& h, unsigned int* cnt,
    bool count_votes) {
  for (int b = b0; b < b1; ++b) {
    if (pass >= 0 && is_near(brows, nb, b, tile) != (pass == 0)) continue;
    bool mine;
    const bool any = vote(brows, nb, b, active, r, t, h.qb, mine, cnt);
    if (count_votes) {
      count(cnt, kVotes, 1);
      count(cnt, kPassed, any);
    }
    if (!any) continue;
    if (stage) {
      sweep_staged<kMotion, kTri>(tab, stride, b * blk, (b + 1) * blk, mine,
                                  stage, r, t, h, cnt);
    } else {
      const unsigned int sweepers = __ballot_sync(kFull, mine);
      count(cnt, kPrims, blk * __popc(sweepers));
      count(cnt, rz::kStatLaneTrips, 32 * blk);
      if (mine)
        sweep_cols<kMotion, kTri>(tab, stride, b * blk, (b + 1) * blk, r, t,
                                  h);
    }
  }
}

// Chunk c of a streamed class, if its near-ness (`sc_near` and its own
// overlap with the tile) matches `want_near` and the warp votes for it;
// `active`: the lanes whose supercluster test passed.
template <bool kMotion, bool kTri>
__device__ __forceinline__ void stream_chunk(
    const float* tab, int n, const float* cb, const float* brows,
    const WfParams& p, int c, bool want_near, bool sc_near, const Tile& tile,
    bool active, float4* stage, const rz::Ray& r, const rz::RayTerms& t,
    Hit& h, unsigned int* cnt) {
  const int nc = n / p.stream;
  if ((sc_near && is_near(cb, nc, c, tile)) != want_near) return;
  bool mine;
  const bool any = vote(cb, nc, c, active, r, t, h.qb, mine, cnt);
  count(cnt, kVotes, 1);
  count(cnt, kPassed, any);
  if (!any) return;
  if (p.blk) {
    const int per = p.stream / p.blk;
    sweep_blocks<kMotion, kTri>(tab, n, brows, n / p.blk, p.blk, c * per,
                                (c + 1) * per, -1, tile, mine, stage, r, t, h,
                                cnt, false);
  } else {
    sweep_staged<kMotion, kTri>(tab, n, c * p.stream, (c + 1) * p.stream,
                                mine, stage, r, t, h, cnt);
  }
}

// One streamed class: superclusters (where enabled), chunks, blocks, with
// the tile-local pass first.
template <bool kMotion, bool kTri>
__device__ __forceinline__ void sweep_stream(
    const float* tab, int n, const float* cb, const float* sc, int g,
    const float* brows, const WfParams& p, const Tile& tile, bool active,
    float4* stage, const rz::Ray& r, const rz::RayTerms& t, Hit& h,
    unsigned int* cnt) {
  if (n == 0) return;
  if (!p.cull) {  // every chunk, untested
    sweep_staged<kMotion, kTri>(tab, n, 0, n, active, stage, r, t, h, cnt);
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
        if (!vote(sc, ns, s, active, r, t, h.qb, mine, cnt)) continue;
        for (int k = 0; k < g; ++k)
          stream_chunk<kMotion, kTri>(tab, n, cb, brows, p, s * g + k,
                                      pass == 0, sc_near, tile, mine, stage,
                                      r, t, h, cnt);
      }
    } else {
      for (int c = 0; c < nc; ++c)
        stream_chunk<kMotion, kTri>(tab, n, cb, brows, p, c, pass == 0, true,
                                    tile, active, stage, r, t, h, cnt);
    }
  }
}

// The launch's tables as its warps read them: in shared memory (resident,
// culled) or device memory (streamed, whose chunk and supercluster bound
// rows sit in shared memory beside each warp's staging buffer and each
// thread's parked words).
struct Staged {
  const float* sph;
  const float* tri;
  const float* sbl;
  const float* tbl;
  const float* scb;
  const float* tcb;
  const float* ssc;
  const float* tsc;
  float4* stage;
  float* park;
};

// Slot i's ray as the launch receives it: the megakernel's camera ray
// (draws 0-4 at bounce 0) where st_in is null, else its state; its sample
// number (from 1) and slot key. Returns its alive flag (padding rays are
// never alive).
__device__ __forceinline__ bool load_ray(const WfParams& p,
                                         const float* s_cam, size_t i,
                                         int& sample, uint32_t& key0,
                                         rz::Ray& r, float& thx, float& thy,
                                         float& thz) {
  const size_t rp = static_cast<size_t>(p.r_pad);
  const int rid = p.rid[i];
  const int pix = p.slot_pix[rid % p.n_px];
  sample = rid / p.n_px + 1;
  key0 = rz::slot_key(p.seed, pix);
  if (p.st_in == nullptr) {
    rz::camera_ray(s_cam, static_cast<float>(pix % p.width),
                   static_cast<float>(pix / p.width), p.jitter,
                   rz::step_key(key0, sample, 0), r);
    thx = thy = thz = 1.0f;
    return rid < p.n_rays;
  }
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
  return p.alive_in[i] > 0;
}

// Slot i's outputs: the ray's state, alive flag and the radiance it added.
__device__ __forceinline__ void store_ray(const WfParams& p, size_t i,
                                          const rz::Ray& r, float thx,
                                          float thy, float thz, float ar,
                                          float ag, float ab, bool active) {
  const size_t rp = static_cast<size_t>(p.r_pad);
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
}

// Dead slot i's outputs: its state as it came in, alive 0, no radiance.
__device__ __forceinline__ void pass_through(const WfParams& p,
                                             const float* s_cam, size_t i) {
  const size_t rp = static_cast<size_t>(p.r_pad);
  if (p.st_in == nullptr) {  // the camera ray of a padding slot
    int sample;
    uint32_t key0;
    rz::Ray r;
    float thx, thy, thz;
    load_ray(p, s_cam, i, sample, key0, r, thx, thy, thz);
    store_ray(p, i, r, thx, thy, thz, 0.0f, 0.0f, 0.0f, false);
    return;
  }
#pragma unroll
  for (int k = 0; k < 10; ++k) p.st_out[k * rp + i] = p.st_in[k * rp + i];
  p.alive_out[i] = 0;
  p.rad[0 * rp + i] = 0.0f;
  p.rad[1 * rp + i] = 0.0f;
  p.rad[2 * rp + i] = 0.0f;
}

// One bounce of the warp's rays (every lane calls it; `live` is the ballot
// of `active`, the lanes that trace): the nearest hit in the launch's table
// mode, then the shading with the ray's key for bounce `bounce`.
// Streamed, each thread's throughput and radiance wait in shared memory
// through the sweep.
template <bool kMotion, int kMode>
__device__ __forceinline__ void trace_bounce(
    const WfParams& p, const Staged& s, unsigned int* cnt, unsigned int live,
    rz::Ray& r, float& thx, float& thy, float& thz, float& ar, float& ag,
    float& ab, bool& active, uint32_t key0, int sample, int bounce) {
  const rz::RayTerms t = rz::ray_terms(r, p.t_min);
  Hit h;
  if constexpr (kMode == kResident) {
    if (active) {
      sweep_cols<kMotion, false>(s.sph, p.n_pad, 0, p.n_pad, r, t, h);
      sweep_cols<kMotion, true>(s.tri, p.m_pad, 0, p.m_pad, r, t, h);
    }
    count(cnt, kPrims, (p.n_pad + p.m_pad) * __popc(live));
  } else {
    const Tile tile = tile_bound(r, active);
    if constexpr (kMode == kCulled) {
      for (int pass = 0; pass < 2; ++pass) {
        sweep_blocks<kMotion, false>(s.sph, p.n_pad, s.sbl, p.n_pad / p.blk,
                                     p.blk, 0, p.n_pad / p.blk, pass, tile,
                                     active, nullptr, r, t, h, cnt, true);
      }
      for (int pass = 0; pass < 2; ++pass) {
        sweep_blocks<kMotion, true>(s.tri, p.m_pad, s.tbl, p.m_pad / p.blk,
                                    p.blk, 0, p.m_pad / p.blk, pass, tile,
                                    active, nullptr, r, t, h, cnt, true);
      }
    } else {
      // the warp's rays and their terms, for sweep_columns
      float4* rs = s.stage + 96 + (threadIdx.x & 31);
      rs[0] = make_float4(r.ox, r.oy, r.oz, r.dx);
      rs[32] = make_float4(r.dy, r.dz, r.tau, t.a);
      rs[64] = make_float4(t.d_dot_o, t.o2, t.tmin_a, t.tau2);
      // cold through the sweep: parked in shared memory
      float* park = s.park;
      park[0 * kBlock] = thx;
      park[1 * kBlock] = thy;
      park[2 * kBlock] = thz;
      park[3 * kBlock] = ar;
      park[4 * kBlock] = ag;
      park[5 * kBlock] = ab;
      sweep_stream<kMotion, false>(s.sph, p.n_pad, s.scb, s.ssc, p.sc_s,
                                   s.sbl, p, tile, active, s.stage, r, t, h,
                                   cnt);
      sweep_stream<kMotion, true>(s.tri, p.m_pad, s.tcb, s.tsc, p.sc_t,
                                  s.tbl, p, tile, active, s.stage, r, t, h,
                                  cnt);
      thx = park[0 * kBlock];
      thy = park[1 * kBlock];
      thz = park[2 * kBlock];
      ar = park[3 * kBlock];
      ag = park[4 * kBlock];
      ab = park[5 * kBlock];
    }
  }
  if (active) {
    const uint32_t key = rz::step_key(key0, sample, bounce);
    active = rz::shade<kMotion>(s.sph, p.n_pad, s.tri, p.m_pad, r, t, h.qb,
                                h.best, h.is_tri, rz::KeyDraws{key}, thx, thy,
                                thz, ar, ag, ab) == rz::Bounce::kContinued;
  }
}

// The tail launch's schedule (loop_bounces > 1): a ray queue over the
// slots. A warp claims as many slots as it has free lanes from the counter
// with one atomicAdd; its lanes read their alive flags, write each dead
// slot through (its state unchanged, alive 0, radiance 0) and the warp
// hands the live slots to its free lanes in slot order (__ballot_sync,
// __popc, __fns). Once a claim finds no live slot, the warp claims kRun
// slots at a time, which any lane writes through. A warp keeps no live
// slots its lanes cannot take yet: with runs of 32 such a backlog held the
// Next Week's last live rays while other warps emptied (H100: the share of
// live lanes fell over the last 14 ms of a 68-ms launch; PERF.md). A lane
// carries its ray's own bounce count b and draws with
// step_key(key0, sample, bounce + b), the keys the one-slot-per-thread
// schedule gives that ray; when the path ends or reaches loop_bounces the
// lane writes the slot's outputs and takes the next live slot on the
// warp's next trip. So no lane waits for the longest path of its warp:
// with a thread per slot 23.8% of the Next Week tail's lane-trips
// carried a ray, with the queue 86.7% (H100; PERF.md). The host's
// dead-last partition puts the live slots first, so the live rays are
// claimed first; the outputs do not depend on it. Counts the warp's trips
// (kTailTrips) and the rays a lane took after its first (kTailAgain).
template <bool kMotion, int kMode>
__device__ __forceinline__ void tail_queue(const WfParams& p,
                                           const float* s_cam,
                                           const Staged& s,
                                           unsigned int* cnt) {
  const int lane = threadIdx.x & 31;
  const unsigned int below = (1u << lane) - 1u;
  // the warp's claim (warp-uniform): bit j of `pending` is live slot run +
  // j, not yet handed out; `dead` once a claim found no live slot, drained
  // once a claim passed the end
  unsigned int run = 0u, pending = 0u;
  bool drained = false, dead = false;

  unsigned int slot = 0u;
  int sample = 0, b = 0;
  uint32_t key0 = 0u;
  rz::Ray r{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float thx = 0.0f, thy = 0.0f, thz = 0.0f;
  float ar = 0.0f, ag = 0.0f, ab = 0.0f;
  bool active = false, took = false;
  while (true) {
    // hand the free lanes the next live slots
    while (true) {
      const unsigned int need = __ballot_sync(kFull, !active);
      if (!need) break;
      if (!pending) {
        if (drained) break;
        // a slot for each free lane; a whole run after a claim that found
        // no live slot (the dead slots the partition put last)
        const int want = dead ? kRun : __popc(need);
        unsigned long long base = 0;
        if (lane == 0) base = atomicAdd(p.counter, 0ull + want);
        base = __shfl_sync(kFull, base, 0);
        if (base >= static_cast<unsigned int>(p.r_pad)) {
          drained = true;
          break;
        }
        run = static_cast<unsigned int>(base);
        const size_t j = run + lane;
        const bool mine = lane < want && j < static_cast<size_t>(p.r_pad);
        const bool live =
            mine && (p.st_in ? p.alive_in[j] > 0 : p.rid[j] < p.n_rays);
        pending = __ballot_sync(kFull, live);
        if (mine && !live) pass_through(p, s_cam, j);
        dead = !pending;
        continue;
      }
      const int n = __popc(pending);
      const bool got = !active && __popc(need & below) < n;
      if (got) {
        slot = run + __fns(pending, 0, __popc(need & below) + 1);
        active = load_ray(p, s_cam, slot, sample, key0, r, thx, thy, thz);
        ar = ag = ab = 0.0f;
        b = 0;
      }
      if (cnt)
        count(cnt, kTailAgain, __popc(__ballot_sync(kFull, got && took)));
      took = took || got;
      const int k = __popc(need);
      pending = k < n ? pending & (~0u << __fns(pending, 0, k + 1)) : 0u;
    }
    const unsigned int live = __ballot_sync(kFull, active);
    if (!live) break;
    count(cnt, kSegments, __popc(live));
    count(cnt, kTailTrips, 1);
    trace_bounce<kMotion, kMode>(p, s, cnt, live, r, thx, thy, thz, ar, ag,
                                 ab, active, key0, sample, p.bounce + b);
    if ((live >> lane) & 1u) {
      ++b;
      if (!active || b == p.loop_bounces) {
        store_ray(p, slot, r, thx, thy, thz, ar, ag, ab, active);
        active = false;
      }
    }
  }
}

// At most 72 registers a thread (7 blocks of 128 an SM): the sweep waits on
// its loads, square roots and shuffles, which resident warps hide; at 64
// registers (8 blocks) the spills cost more than the eighth block gains
// (PERF.md). kTail: the tail launch's ray queue (tail_queue) over a
// persistent grid; else a thread per slot (the bounce launches), one
// bounce a trip up to loop_bounces.
template <bool kMotion, int kMode, bool kTail>
__global__ void __launch_bounds__(kBlock, 7) wavefront_kernel(WfParams p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* s_cam = smem;
  float* s_tab = smem + kHeadWords;
  for (int i = threadIdx.x; i < 18; i += kBlock) s_cam[i] = p.cam[i];
  unsigned int* cnt = nullptr;
  if (p.stats) {
    cnt = reinterpret_cast<unsigned int*>(smem + 20) +
          (threadIdx.x >> 5) * kCount;
    if ((threadIdx.x & 31) < kCount) cnt[threadIdx.x & 31] = 0u;
  }
  Staged s{};
  if constexpr (kMode == kStreamed) {
    // the warps' staging buffers, the parked states, then the bound rows
    // of the chunks and superclusters, both classes
    s.stage = reinterpret_cast<float4*>(s_tab) +
              (threadIdx.x >> 5) * (kStageWords / 4);
    s.park = s_tab + kWarps * kStageWords + threadIdx.x;
    const int ncs = p.n_pad / p.stream;
    const int nct = p.m_pad / p.stream;
    const int nss = p.sc_s ? ncs / p.sc_s : 0;
    const int nst = p.sc_t ? nct / p.sc_t : 0;
    float* s_scb = s_tab + kWarps * kStageWords + kBlock * kParkWords;
    float* s_tcb = s_scb + 4 * ncs;
    float* s_ssc = s_tcb + 4 * nct;
    float* s_tsc = s_ssc + 4 * nss;
    for (int i = threadIdx.x; i < 4 * ncs; i += kBlock) s_scb[i] = p.scb[i];
    for (int i = threadIdx.x; i < 4 * nct; i += kBlock) s_tcb[i] = p.tcb[i];
    for (int i = threadIdx.x; i < 4 * nss; i += kBlock) s_ssc[i] = p.ssc[i];
    for (int i = threadIdx.x; i < 4 * nst; i += kBlock) s_tsc[i] = p.tsc[i];
    s.scb = s_scb;
    s.tcb = s_tcb;
    s.ssc = s_ssc;
    s.tsc = s_tsc;
    s.sph = p.stab;
    s.tri = p.ttab;
    s.sbl = p.sblk;
    s.tbl = p.tblk;
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
      s.sbl = s_sbl;
      s.tbl = s_tbl;
    }
    s.sph = s_sph;
    s.tri = s_tri;
  }
  __syncthreads();  // the last block barrier: the warps run on alone

  if constexpr (kTail) {
    tail_queue<kMotion, kMode>(p, s_cam, s, cnt);
  } else {
    // r_pad is a multiple of the block: every thread owns a ray slot
    const size_t i = static_cast<size_t>(blockIdx.x) * kBlock + threadIdx.x;
    int sample;
    uint32_t key0;
    rz::Ray r;
    float thx, thy, thz;
    bool active = load_ray(p, s_cam, i, sample, key0, r, thx, thy, thz);
    float ar = 0.0f, ag = 0.0f, ab = 0.0f;
    // One bounce per trip, up to loop_bounces. The condition is a warp
    // vote: a tile with no live ray is done (the TPU's dead-tile skip).
    for (int it = 0; it < p.loop_bounces; ++it) {
      const unsigned int live = __ballot_sync(kFull, active);
      if (!live) break;
      count(cnt, kSegments, __popc(live));
      trace_bounce<kMotion, kMode>(p, s, cnt, live, r, thx, thy, thz, ar, ag,
                                   ab, active, key0, sample, p.bounce + it);
    }
    store_ray(p, i, r, thx, thy, thz, ar, ag, ab, active);
  }
  if (cnt && (threadIdx.x & 31) == 0) {
    for (int k = 0; k < kCount; ++k)
      if (cnt[k])
        atomicAdd(p.stats + k, static_cast<unsigned long long>(cnt[k]));
  }
}

// The bounce launches: a block per 128 slots. The tail launch (kTail): as
// many blocks as the card holds at once (the occupancy of that build at its
// shared memory), at most one per kBlock slots.
template <bool kMotion, int kMode, bool kTail>
cudaError_t launch(const WfParams& p, size_t smem, cudaStream_t s) {
  const auto kernel = wavefront_kernel<kMotion, kMode, kTail>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  int blocks = p.r_pad / kBlock;
  if constexpr (kTail) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kBlock, smem);
    if (e != cudaSuccess) return e;
    if (per_sm * sms < blocks) blocks = per_sm * sms;
    if (blocks <= 0) return cudaErrorInvalidConfiguration;
  }
  kernel<<<blocks, kBlock, smem, s>>>(p);
  return cudaGetLastError();
}

template <int kMode>
cudaError_t launch_mode(const WfParams& p, bool motion, size_t smem,
                        cudaStream_t s) {
  if (p.loop_bounces > 1)
    return motion ? launch<true, kMode, true>(p, smem, s)
                  : launch<false, kMode, true>(p, smem, s);
  return motion ? launch<true, kMode, false>(p, smem, s)
                : launch<false, kMode, false>(p, smem, s);
}

}  // namespace

// mode: 0 resident, 1 culled (sblk/tblk, blk), 2 streamed (scb/tcb,
// ssc/tsc with sc_s/sc_t, sblk/tblk with blk, stream, cull). st_in null =
// spawn the camera rays. smem_bytes: the wrapper's accounting of the
// dynamic shared memory (ops/tables.py wavefront_shared_bytes). counter: a
// zeroed uint64, the tail launch's (loop_bounces > 1) slot counter; null
// for the bounce launches.
extern "C" int rayz_wavefront(
    const float* cam, const float* stab, int n_pad, const float* ttab,
    int m_pad, int mode, const float* sblk, const float* tblk, int blk,
    const float* scb, const float* tcb, const float* ssc, const float* tsc,
    int stream_cols, int sc_s, int sc_t, int cull, const float* st_in,
    const int* alive_in, const int* rid, const int* slot_pix, float* st_out,
    int* alive_out, float* rad, int r_pad, int n_rays, int n_px, int width,
    int bounce, int loop_bounces, float t_min, int jitter, int has_motion,
    unsigned int seed, int smem_bytes, void* counter, void* stats,
    void* stream) {
  if (r_pad % kBlock || loop_bounces < 1 ||
      (loop_bounces > 1) != (counter != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
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
  p.counter = static_cast<unsigned long long*>(counter);
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
