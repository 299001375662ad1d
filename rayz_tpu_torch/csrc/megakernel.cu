// Persistent path-tracing megakernel for Hopper (sm_90a).
//
// Replaces the TPU kernel rayz_tpu/ops/megakernel.py:_kernel in its three
// table modes (launched there by _trace_shard, _trace_shard_compact and
// _trace_shard_streamed). It computes the same image: spawn with jitter,
// defocus and time; nearest hit over the spheres, then the triangles;
// one-level checker; diffuse / metal / dielectric scatter; sky on a miss;
// per-pixel RGB radiance sums.
//
// What bounds it on the H100: instruction issue in the per-sphere sweep
// (an SM issues 4 warp instructions a clock), and lanes left idle. The
// triangle sweep is a serial chain a column (shared loads, a dot product,
// an IEEE reciprocal, a branch on q_best), so it is bound by latency and
// needs many warps an SM to hide it. The resident build's width follows
// its shared-memory footprint (ops/tables.py queue_threads): a block of
// kBlock threads while 8 such blocks fit an SM (32 warps), else one block
// of kWide threads, so a table too large for two blocks an SM (the Cornell
// box's 1,536 triangles, 123 KB) still feeds 32 warps from its one staged
// copy, not 4. Both widths cap registers at 64 a thread. The design, in
// every table mode:
//  * megakernel_queue: a persistent grid whose lanes take (sample, pixel)
//    items from a counter on the card, 64 items per warp and atomic, so no
//    lane waits for its pixel's other samples (a thread that owned a pixel
//    for all its samples idled a quarter of its lane-trips at the
//    flagship), and a fold kernel that adds each pixel's samples in sample
//    order. The kernel is a template on its segment sweep, chosen at
//    compile time, so each mode's instantiation carries only its own code.
//  * the sphere geometry as 16-byte records (rz::stage_spheres in shared
//    memory; ops/tables.py pack_records in device memory, streamed);
//  * shading reads the winner's centre and material from the row-major
//    sphere table in device memory (L1), once per segment.
//
// Table modes (the sweep functors below):
//  * ResidentSweep (the flagship's): the sphere geometry packed and the
//    triangle table in shared memory, every column swept by
//    rz::sweep_packed (the quadratic in the coefficient form as fused
//    multiply-adds, 42-43 SASS instructions a column where sweep_spheres
//    issued 63-64), the winner settled in today's arithmetic. In the
//    kBlock build, on a loop trip where at most kColumnsUpTo of a warp's
//    lanes trace (the drain: a 1-spp launch kept 36% of its lane-trips
//    busy), the warp sweeps their rays in turn, a column per lane
//    (rz::sweep_packed_lanes), to the same winners.
//  * CulledSweep (the TPU's _culled_loop): the Morton-sorted geometry
//    packed in shared memory with the blocks' bounding spheres; each lane
//    sweeps in the packed form the blocks its own bound test passes (the
//    TPU tests a tile's bound and sweeps the block if ANY lane may hit it;
//    here the warp issues a block's sweep only where some lane's test
//    passed, and the other lanes skip it). The settle's re-sweep walks the
//    same blocks in today's arithmetic, and the grazing band is the wide
//    one (rz::kGrazeWide). Triangles as rz::sweep_blocks on the shared
//    table.
//  * StreamSweep (the TPU's _stream_loop): the tables and the packed
//    records in device memory, the chunk bounds in shared memory, the
//    block bounds as records in device memory. Each lane keeps its own
//    hierarchy (chunk, then block, each tested for its own ray against its
//    own q_best) under warp votes: the warp visits a chunk or block only
//    where __any_sync over the lanes whose own tests passed says so. A
//    visited block's records are staged in the warp's shared buffer by one
//    16-byte load a lane and swept from there by each lane whose test
//    passed; where at most kColumnsUpTo lanes did, the warp takes those
//    rays in turn, a column per lane, and keeps the smallest q, then the
//    lowest column, by warp reductions: the sequential sweep's winner.
//    Columns are tested in today's arithmetic: the packed form, its settle
//    re-sweeping ~2% of the segments through the hierarchy one lane at a
//    time, was slower here, and it parted from the plain version on ~3% of
//    the 100k scene's pixels (PERF.md). Superclusters were dropped: built
//    over chunks ordered near to far, they pruned too little to pay for
//    their tests. Triangles stream per lane behind chunk and block bounds
//    (rz::sweep_chunks).
// Culling is conservative, so the winners are those of a full sweep over
// the same (sorted) tables: bit for bit streamed (up to exact ties), up to
// near ties culled (its bound tests compare with the packed q_best).
//
// Random draws are keyed by (seed, pixel, sample, bounce, draw), so the
// schedule changes no bit: one queue launch per sample group renders what
// any other grouping renders.
//
// C interface for ctypes (see ops/_build.py): every entry point returns the
// cudaError_t of its launch.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlock = 128;  // threads per block of the queue kernel
constexpr int kWarps = kBlock / 32;
// Threads per block of the resident queue's wide build (a table whose
// footprint leaves kBlock-thread blocks short of 32 warps an SM).
constexpr int kWide = 1024;
constexpr int kRun = 64;     // items a warp claims with one atomicAdd
// A streamed block is swept a column per lane when at most this many of the
// warp's rays entered it, else a ray per lane; so is the resident table on a
// loop trip where at most this many of the warp's lanes trace (the drain).
// A column per lane costs a ray about 1/32 of a per-lane trip's issue
// slots, plus its shuffles and reductions. On an H100 the flagship's 1-spp
// launch took 1.33 ms with the drain at up to 8 live lanes, 1.24 at 16,
// 1.23 at 24 and 1.24 at 28 (2.82 without it).
constexpr int kColumnsUpTo = 16;
// The stats slot of the segments whose spheres the resident sweep took a
// column per lane (the megakernel's stats are [9]; slots 0-7 as
// rayz_megakernel_queue lists them).
constexpr int kStatColumnSegments = 8;
// Staging words per warp of the streamed sweep: 32 records of 9 words with
// motion (c and v as float4, |v|^2), 4 without.
template <bool kMotion>
__host__ __device__ constexpr int stage_words() {
  return 32 * (kMotion ? 9 : 4);
}

enum : int { kResident = 0, kCulled = 1, kStreamed = 2 };

struct QueueParams {
  const float* cam;   // [18]
  const float* stab;  // [17, n_pad]
  const float* ttab;  // [20, m_pad]
  int n_pad, m_pad, n_pix, width, max_depth;
  int p0;             // the pixels [p0, p0 + n_pix) of the image
  int s0, n_samples;  // the samples [s0, s0 + n_samples) of every pixel
  float t_min;
  uint32_t seed;
  bool jitter;
  unsigned long long* counter;  // items claimed so far (0 at launch)
  float* out;                   // [n_samples, 3, n_pix]
  unsigned long long* stats;    // [9] or null
  // the culled and streamed modes
  const float* sblk;  // [4, n_pad / blk] sphere block rows
  const float* tblk;  // [4, m_pad / blk] triangle block rows
  const float* scb;   // [4, n_pad / stream] sphere chunk rows
  const float* tcb;   // [4, m_pad / stream] triangle chunk rows
  const float* recs;  // streamed: packed sphere records (ops/tables.py)
  const float* brecs; // streamed: sphere block bounds as [n_pad / blk] float4
  int blk, stream;    // blk 0: no blocks
  bool cull;          // streamed: false sweeps every chunk untested
  int* hits;  // [max_depth, n_samples * n_pix] winners (triangles n_pad +
              // column, -1 a miss), or null
};

// Bound i of a [4, stride] bound table staged into shared memory as one
// record (centre, |c|^2 - r^2) at `dst`.
__device__ __forceinline__ void stage_bounds(const float* rows, int stride,
                                             float4* dst) {
  for (int i = threadIdx.x; i < stride; i += blockDim.x)
    dst[i] = rz::bound_rec(rows, stride, i);
}

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- the resident sweep (the flagship's) ----

// The resident tables in shared memory: the camera vector, the sphere
// geometry packed for sweep_packed, the triangle table row-major. Its
// segment sweep: sweep_packed, its winner settled in today's arithmetic
// (settle_winner), then the triangles; in the kBlock build, on a trip
// where few of the warp's lanes trace (drain), the spheres a column per
// lane instead, with the same winners. Built at kBlock threads (8 blocks
// an SM) and kWide (one block an SM), both at 64 registers a thread.
template <bool kMotion, int kWidth>
struct ResidentSweep {
  static constexpr int kMode = kResident;
  static constexpr bool kHasMotion = kMotion;
  static constexpr int kThreads = kWidth;
  static constexpr int kMinBlocks = kWidth == kBlock ? 8 : 1;
  // The drain is built at kBlock threads only: carried by the kWide build,
  // which never took it on the Cornell box (no spheres), it cost that
  // scene's renders 1.7% (H100, 39.30-39.63 against 38.60-38.66 Mrays/s).
  static constexpr bool kDrain = kWidth == kBlock;
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

  // The segment sweep where few lanes trace (warp-uniform call: every lane,
  // `active` where its lane traces a segment): the live rays' spheres by
  // the whole warp, a ray at a time and a column per lane
  // (rz::sweep_packed_lanes), each winner settled by its own lane, a
  // re-sweep in today's arithmetic a column per lane too
  // (rz::sweep_today_lanes), then each lane's triangles. The winners are
  // operator()'s, bit for bit.
  __device__ __forceinline__ void drain(bool active, const rz::Ray& r,
                                        const rz::RayTerms& t, int from,
                                        float& qb, int& best,
                                        bool& is_tri) const {
    const unsigned live = __ballot_sync(kFull, active);
    const rz::LaneWinners lw =
        rz::sweep_packed_lanes<kMotion>(ps, n, live, r, t);
    qb = lw.qb;
    best = lw.best;
    // settle_winner's re-sweep, deferred to the whole warp
    const bool again =
        active && rz::settle_winner_by<kMotion>(
                      ps, from, r, t, rz::ray_coef(r, t), qb, best,
                      lw.second, lw.graze, [](float&, int&) {});
    const unsigned resweep = __ballot_sync(kFull, again);
    if (resweep) {
      const rz::LaneWinners rw =
          rz::sweep_today_lanes<kMotion>(ps, n, resweep, r, t);
      if (again) {
        qb = rw.qb;
        best = rw.best;
      }
    }
    if (stats && (threadIdx.x & 31) == 0) {
      atomicAdd(stats + kStatColumnSegments,
                static_cast<unsigned long long>(__popc(live)));
      if (resweep)
        atomicAdd(stats + rz::kStatResweeps,
                  static_cast<unsigned long long>(__popc(resweep)));
    }
    if (active) rz::sweep_triangles(tri, m, r, t, qb, best, is_tri);
  }

  static __device__ __forceinline__ ResidentSweep stage(const QueueParams& p,
                                                        float* smem) {
    for (int i = threadIdx.x; i < 18; i += blockDim.x) smem[i] = p.cam[i];
    const rz::PackedSpheres ps =
        rz::stage_spheres<kMotion>(p.stab, p.n_pad, smem + rz::kCamWords);
    float* s_tri = smem + rz::kCamWords + rz::packed_words<kMotion>(p.n_pad);
    for (int i = threadIdx.x; i < rz::kTRows * p.m_pad; i += blockDim.x)
      s_tri[i] = p.ttab[i];
    __syncthreads();
    return ResidentSweep{ps, s_tri, p.n_pad, p.m_pad, p.stats};
  }

  static size_t smem_bytes(const QueueParams& p) {
    return sizeof(float) *
           (rz::kCamWords +
            static_cast<size_t>(rz::packed_words<kMotion>(p.n_pad)) +
            rz::kTRows * static_cast<size_t>(p.m_pad));
  }
};

// ---- the culled sweep ----

// Shared memory: the camera, the Morton-sorted sphere geometry packed, the
// sphere blocks' bounds as records, the triangle table row-major and its
// block rows. A lane sweeps a block of spheres where its own bound test
// against its q_best passes; the settle's re-sweep walks the same blocks in
// today's arithmetic.
template <bool kMotion>
struct CulledSweep {
  static constexpr int kMode = kCulled;
  static constexpr bool kHasMotion = kMotion;
  static constexpr bool kDrain = false;
  static constexpr int kMinBlocks = 4;
  static constexpr int kThreads = kBlock;
  rz::PackedSpheres ps;
  uint32_t sbr;       // [n / blk] float4 sphere block bounds (shared)
  const float* tri;   // [20, m] in shared memory
  const float* tbl;   // [4, m / blk] in shared memory
  int n, m, blk;
  unsigned long long* stats;

  __device__ __forceinline__ float4 block(int b) const {
    return rz::lds128(sbr + 16u * b);
  }

  __device__ __forceinline__ void operator()(const rz::Ray& r,
                                             const rz::RayTerms& t, int from,
                                             float& qb, int& best,
                                             bool& is_tri,
                                             rz::Work& w) const {
    const int nb = n / blk;
    if (nb) {
      const rz::RayCoef c = rz::ray_coef(r, t);
      int second = -1, graze = -1;
      float q2 = rz::kBig;
      w.bounds += nb;
      for (int b = 0; b < nb; ++b) {
        if (!rz::bound_test(block(b), r, t, qb)) continue;
        w.prims += blk;
        rz::sweep_packed<kMotion, true>(ps, b * blk, (b + 1) * blk, 0, c, qb,
                                        best, q2, second, graze);
      }
      if (rz::settle_winner_by<kMotion>(
              ps, from, r, t, c, qb, best, second, graze,
              [&](float& q, int& bb) {
                for (int b = 0; b < nb; ++b)
                  if (rz::bound_test(block(b), r, t, q))
                    rz::sweep_today<kMotion>(ps, b * blk, (b + 1) * blk, r, t,
                                             q, bb);
              }) &&
          stats)
        atomicAdd(stats + rz::kStatResweeps, 1ull);
    }
    rz::sweep_blocks<kMotion, true>(tri, m, tbl, m / blk, blk, 0, m / blk, r,
                                    t, qb, best, is_tri, w);
  }

  static __device__ __forceinline__ CulledSweep stage(const QueueParams& p,
                                                      float* smem) {
    for (int i = threadIdx.x; i < 18; i += blockDim.x) smem[i] = p.cam[i];
    const int n = p.n_pad, m = p.m_pad, blk = p.blk;
    const rz::PackedSpheres ps =
        rz::stage_spheres<kMotion>(p.stab, n, smem + rz::kCamWords);
    float4* s_sbr = reinterpret_cast<float4*>(
        smem + rz::kCamWords + rz::packed_words<kMotion>(n));
    stage_bounds(p.sblk, n / blk, s_sbr);
    float* s_tri = reinterpret_cast<float*>(s_sbr + n / blk);
    for (int i = threadIdx.x; i < rz::kTRows * m; i += blockDim.x)
      s_tri[i] = p.ttab[i];
    float* s_tbl = s_tri + rz::kTRows * m;
    for (int i = threadIdx.x; i < 4 * (m / blk); i += blockDim.x)
      s_tbl[i] = p.tblk[i];
    __syncthreads();
    return CulledSweep{ps, shared_addr(s_sbr), s_tri, s_tbl, n, m, blk,
                       p.stats};
  }

  static size_t smem_bytes(const QueueParams& p) {
    return sizeof(float) *
           (rz::kCamWords +
            static_cast<size_t>(rz::packed_words<kMotion>(p.n_pad)) +
            4 * static_cast<size_t>(p.n_pad / p.blk) +
            rz::kTRows * static_cast<size_t>(p.m_pad) +
            4 * static_cast<size_t>(p.m_pad / p.blk));
  }
};

// ---- the streamed sweep ----

// One column's records held in registers (a column per lane), read by the
// same sphere_root as the staged records (its rec_* are found by
// argument-dependent lookup).
struct RegSpheres {
  float4 c, v;
  float vv;
};
__device__ __forceinline__ float4 rec_c(const RegSpheres& s, int) {
  return s.c;
}
__device__ __forceinline__ float4 rec_v(const RegSpheres& s, int) {
  return s.v;
}
__device__ __forceinline__ float rec_vv(const RegSpheres& s, int) {
  return s.vv;
}

// The streamed sphere records in device memory (built once a render by
// ops/tables.py pack_records): [n] float4 (c, |c|^2 - r^2), then with
// motion [n] float4 (v, 2 c.v) and [n] float |v|^2.
struct StreamRecords {
  const float4* c;
  const float4* v;
  const float* vv;
};

// Shared memory: the camera, each warp's staging buffer, the sphere chunk
// bounds as records, the triangle chunk rows. Device memory: the packed
// sphere records, the sphere block bounds as records, the triangle table
// and its block rows. The columns are tested in today's arithmetic
// (sweep_spheres' expressions on the records): here the packed form lost
// (PERF.md), its settle re-sweeping ~2% of the segments through the
// hierarchy one lane at a time.
template <bool kMotion>
struct StreamSweep {
  static constexpr int kMode = kStreamed;
  static constexpr bool kHasMotion = kMotion;
  static constexpr bool kDrain = false;
  static constexpr int kMinBlocks = 4;
  static constexpr int kThreads = kBlock;
  StreamRecords recs;
  const float4* sbr;  // [n / blk] sphere block bounds (device memory)
  const float* tri;   // [20, m] (device memory)
  const float* tbl;   // [4, m / blk] (device memory)
  const float* tcb;   // [4, m / stream] (shared)
  uint32_t scb;       // [n / stream] float4 sphere chunk bounds (shared)
  uint32_t buf;       // this warp's staging buffer (shared)
  int n, m, stream, blk;
  bool cull;

  // The records [j0, j1) for the lanes with `mine` (warp-uniform call), 32
  // columns at a time: a column per lane where few lanes sweep, else staged
  // by one 16-byte load a lane and swept from there by each of them.
  __device__ __forceinline__ void sweep_range(int j0, int j1, bool mine,
                                              const rz::Ray& r,
                                              const rz::RayTerms& t,
                                              float& qb, int& best,
                                              rz::Work& w) const {
    const unsigned sweepers = __ballot_sync(kFull, mine);
    if (!sweepers) return;
    const int lane = threadIdx.x & 31;
    const bool by_columns = __popc(sweepers) <= kColumnsUpTo;
    for (int base = j0; base < j1; base += 32) {
      const int cols = min(32, j1 - base);
      if (mine) w.prims += cols;
      if (by_columns) {
        columns(base, cols, sweepers, r, t, qb, best);
        continue;
      }
      if (lane < cols) {
        const int j = base + lane;
        rz::sts128(buf + 16u * lane, __ldg(recs.c + j));
        if (kMotion) {
          rz::sts128(buf + 16u * (32 + lane), __ldg(recs.v + j));
          rz::sts32(buf + 16u * 64 + 4u * lane, __ldg(recs.vv + j));
        }
      }
      __syncwarp();
      if (mine) {
        const rz::PackedSpheres ps{buf, buf + 16u * 32, buf + 16u * 64};
        rz::sweep_today<kMotion>(ps, 0, cols, r, t, qb, best, base);
      }
      __syncwarp();
    }
  }

  // Columns [base, base + cols) a column per lane, for each ray of
  // `sweepers` in turn (warp-uniform call): each lane tests its column
  // with sweep_spheres' expressions against the ray and its q_best; the
  // smallest q, then the lowest column, is the sequential sweep's winner.
  __device__ __forceinline__ void columns(int base, int cols,
                                          unsigned sweepers, const rz::Ray& r,
                                          const rz::RayTerms& t, float& qb,
                                          int& best) const {
    const int lane = threadIdx.x & 31;
    RegSpheres rec{};
    if (lane < cols) {
      rec.c = __ldg(recs.c + base + lane);
      if (kMotion) {
        rec.v = __ldg(recs.v + base + lane);
        rec.vv = __ldg(recs.vv + base + lane);
      }
    }
    while (sweepers) {
      const int src = __ffs(sweepers) - 1;
      sweepers &= sweepers - 1;
      const rz::Ray rs{__shfl_sync(kFull, r.ox, src),
                       __shfl_sync(kFull, r.oy, src),
                       __shfl_sync(kFull, r.oz, src),
                       __shfl_sync(kFull, r.dx, src),
                       __shfl_sync(kFull, r.dy, src),
                       __shfl_sync(kFull, r.dz, src),
                       __shfl_sync(kFull, r.tau, src)};
      const rz::RayTerms ts{__shfl_sync(kFull, t.a, src),
                            __shfl_sync(kFull, t.d_dot_o, src),
                            __shfl_sync(kFull, t.o2, src),
                            __shfl_sync(kFull, t.tmin_a, src),
                            __shfl_sync(kFull, t.tau2, src)};
      const float qs = __shfl_sync(kFull, qb, src);
      float q = rz::kBig;
      bool first;
      const bool ok = lane < cols &&
                      rz::sphere_root<kMotion>(rec, 0, rs, ts, q, first) &&
                      q < qs;
      // q >= t_min |d|^2 >= 0 where accepted: its bits order as the
      // values (+ 0.0f turns a -0 into +0)
      const unsigned key = ok ? __float_as_uint(q + 0.0f) : 0xffffffffu;
      const unsigned k1 = __reduce_min_sync(kFull, key);
      if (k1 == 0xffffffffu) continue;
      const unsigned j1 = __reduce_min_sync(kFull, key == k1 ? lane : 32u);
      const float qa = __shfl_sync(kFull, q, j1);
      if (lane == src) {
        qb = qa;
        best = base + static_cast<int>(j1);
      }
    }
  }

  // Chunk k for the lanes with `act` (warp-uniform call): each lane's own
  // test, the vote, then the chunk's blocks likewise.
  __device__ __forceinline__ void chunk(int k, bool act, const rz::Ray& r,
                                        const rz::RayTerms& t, float& qb,
                                        int& best, rz::Work& w) const {
    bool mine = false;
    if (act) {
      ++w.votes;
      mine = rz::bound_test(rz::lds128(scb + 16u * k), r, t, qb);
      w.passed += mine;
    }
    if (!__any_sync(kFull, mine)) return;
    if (!blk) {
      sweep_range(k * stream, (k + 1) * stream, mine, r, t, qb, best, w);
      return;
    }
    const int per = stream / blk;
    for (int b = k * per; b < (k + 1) * per; ++b) {
      bool in = false;
      if (mine) {
        ++w.bounds;
        in = rz::bound_test(__ldg(sbr + b), r, t, qb);
      }
      sweep_range(b * blk, (b + 1) * blk, in, r, t, qb, best, w);
    }
  }

  // Warp-uniform call: every lane of the warp, `active` where its lane
  // traces a segment.
  __device__ __forceinline__ void operator()(bool active, const rz::Ray& r,
                                             const rz::RayTerms& t, int,
                                             float& qb, int& best,
                                             bool& is_tri,
                                             rz::Work& w) const {
    if (!cull) {
      sweep_range(0, n, active, r, t, qb, best, w);
    } else {
      for (int k = 0; k < n / stream; ++k) chunk(k, active, r, t, qb, best, w);
    }
    if (active)
      rz::sweep_chunks<kMotion, true>(tri, m, tcb, tbl, stream, blk, cull, r,
                                      t, qb, best, is_tri, w);
  }

  static __device__ __forceinline__ StreamSweep stage(const QueueParams& p,
                                                      float* smem) {
    for (int i = threadIdx.x; i < 18; i += blockDim.x) smem[i] = p.cam[i];
    const int n = p.n_pad, m = p.m_pad, stream = p.stream;
    float* s_stage = smem + rz::kCamWords;
    float4* s_scb = reinterpret_cast<float4*>(
        s_stage + kWarps * stage_words<kMotion>());
    stage_bounds(p.scb, n / stream, s_scb);
    float* s_tcb = reinterpret_cast<float*>(s_scb + n / stream);
    for (int i = threadIdx.x; i < 4 * (m / stream); i += blockDim.x)
      s_tcb[i] = p.tcb[i];
    __syncthreads();
    const float4* c = reinterpret_cast<const float4*>(p.recs);
    StreamSweep s;
    s.recs =
        StreamRecords{c, c + n, reinterpret_cast<const float*>(c + 2 * n)};
    s.sbr = reinterpret_cast<const float4*>(p.brecs);
    s.tri = p.ttab;
    s.tbl = p.tblk;
    s.tcb = s_tcb;
    s.scb = shared_addr(s_scb);
    s.buf =
        shared_addr(s_stage + (threadIdx.x >> 5) * stage_words<kMotion>());
    s.n = n;
    s.m = m;
    s.stream = stream;
    s.blk = p.blk;
    s.cull = p.cull;
    return s;
  }

  static size_t smem_bytes(const QueueParams& p) {
    return sizeof(float) *
           (rz::kCamWords + kWarps * stage_words<kMotion>() +
            4 * static_cast<size_t>(p.n_pad / p.stream) +
            4 * static_cast<size_t>(p.m_pad / p.stream));
  }
};

// A lane's path in the queue kernel: its ray, throughput, radiance so far,
// bounces left, its item (sample, local pixel, key) and the sphere its ray
// leaves; `spawn` until its camera ray is made.
struct Path {
  rz::Ray r{};  // lanes without an item enter the drain with it
  float thx = 0.0f, thy = 0.0f, thz = 0.0f, ar = 0.0f, ag = 0.0f, ab = 0.0f;
  int depth = 0, pix = 0, sample = 0, from = -1;
  uint32_t key0 = 0;
  bool active = false, spawn = false;
};

// One loop trip of a lane of megakernel_queue (the lanes the sweep runs
// for: those tracing a segment, or with kDrainTrip the whole warp, which
// then sweeps a column per lane): spawn the camera ray of a new item, sweep
// the segment, shade it, and write the radiance of a path that ended.
template <bool kDrainTrip, typename Sweep>
__device__ __forceinline__ void trace_trip(const Sweep& sweep,
                                           const QueueParams& p,
                                           const float* smem,
                                           unsigned long long total, Path& q,
                                           unsigned int& segments,
                                           rz::Work& w) {
  constexpr bool kWarp = Sweep::kMode == kStreamed;
  if (q.active) ++segments;
  const uint32_t key =
      rz::step_key(q.key0, q.sample + 1, p.max_depth - q.depth);
  if (q.active && q.spawn) {
    const int gpix = p.p0 + q.pix;
    rz::camera_ray(smem, static_cast<float>(gpix % p.width),
                   static_cast<float>(gpix / p.width), p.jitter, key, q.r);
    q.thx = q.thy = q.thz = 1.0f;
    q.ar = q.ag = q.ab = 0.0f;
    q.spawn = false;
    q.from = -1;
  }
  const rz::RayTerms t = rz::ray_terms(q.r, p.t_min);
  float qb = rz::kBig;
  int best = -1;
  bool is_tri = false;
  if constexpr (kDrainTrip)
    sweep.drain(q.active, q.r, t, q.from, qb, best, is_tri);
  else if constexpr (Sweep::kMode == kResident)
    sweep(q.r, t, q.from, qb, best, is_tri);
  else if constexpr (kWarp)
    sweep(q.active, q.r, t, q.from, qb, best, is_tri, w);
  else
    sweep(q.r, t, q.from, qb, best, is_tri, w);
  if ((kWarp || kDrainTrip) && !q.active) return;
  if constexpr (Sweep::kMode != kResident) {
    if (p.hits)
      p.hits[static_cast<size_t>(p.max_depth - q.depth) * total +
             static_cast<size_t>(q.sample - p.s0) * p.n_pix + q.pix] =
          is_tri ? p.n_pad + best : best;
  }
  if (rz::shade<Sweep::kHasMotion>(p.stab, p.n_pad, sweep.tri, p.m_pad, q.r,
                                   t, qb, best, is_tri, rz::KeyDraws{key},
                                   q.thx, q.thy, q.thz, q.ar, q.ag,
                                   q.ab) == rz::Bounce::kContinued) {
    q.depth -= 1;
    q.active = q.depth > 0;  // depth exhausted -> black
    q.from = is_tri ? -1 : best;
  } else {
    q.active = false;  // the sky, or absorbed
  }
  if (!q.active) {
    float* o = p.out + static_cast<size_t>(q.sample - p.s0) * 3 * p.n_pix +
               q.pix;
    o[0] = q.ar;
    o[static_cast<size_t>(p.n_pix)] = q.ag;
    o[2 * static_cast<size_t>(p.n_pix)] = q.ab;
  }
}

// A persistent grid whose lanes take (sample, pixel) items from one counter
// in device memory (sample-major, so a warp's items are neighbouring pixels
// of one sample). A warp claims kRun items with one atomicAdd and hands them
// to its lanes as they free up (__ballot_sync/__popc), so a lane is never
// held by its pixel's other samples: only the queue's last paths leave
// lanes idle. Each item traces one camera sample to its end with today's
// keys (sample numbers s + 1, bounces 0..) and writes its radiance, the sky
// term or 0, to out[sample - s0, channel, pixel]; fold_kernel then adds a
// pixel's samples in sample order from 0.0f, the association of a thread
// that runs its pixel's samples in turn (the plain version,
// _trace_slots_reference), so the schedule changes no bit of the image.
// The resident and culled sweeps run per lane (a lane with no item skips
// the segment); the streamed sweep votes across the warp, so every lane
// enters it. The resident kBlock build's warp leaves the loop for its
// drain once it has no item left to hand out and at most kColumnsUpTo
// lanes trace: from there on its live lanes only end, and every trip sweeps
// their spheres a column per lane (ResidentSweep::drain). The drain is a
// loop of its own: inside the main loop, its code slowed every per-lane
// trip (H100, the flagship at 64 spp: 36.20 ms with the drain compiled in
// but never taken, against 34.43 ms without it; 35.57 against 34.15-34.40
// as a loop of its own, which the drain wins back, 34.04).
template <typename Sweep>
__global__ void __launch_bounds__(Sweep::kThreads, Sweep::kMinBlocks)
    megakernel_queue(QueueParams p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Sweep sweep = Sweep::stage(p, smem);
  constexpr bool kWarp = Sweep::kMode == kStreamed;
  const int lane = threadIdx.x & 31;
  const unsigned long long total =
      static_cast<unsigned long long>(p.n_samples) * p.n_pix;
  // the warp's claimed run (warp-uniform): items [run_end - run_left,
  // run_end) are still to hand out; drained once a claim reached the end
  unsigned long long run_end = 0;
  int run_left = 0;
  bool drained = false;

  Path q;
  unsigned int segments = 0, trips = 0;
  rz::Work w;
  while (true) {
    const unsigned need = __ballot_sync(kFull, !q.active);
    if (need) {
      const int k = __popc(need);
      const bool refill = k > run_left && !drained;
      unsigned long long fresh = 0;
      if (refill) {
        if (lane == 0)
          fresh = atomicAdd(p.counter, static_cast<unsigned long long>(kRun));
        fresh = __shfl_sync(kFull, fresh, 0);
      }
      if (!q.active) {
        const int rank = __popc(need & ((1u << lane) - 1u));
        unsigned long long item = total;
        if (rank < run_left)
          item = run_end - run_left + rank;
        else if (refill)
          item = fresh + (rank - run_left);
        if (item < total) {
          q.sample = p.s0 + static_cast<int>(item / p.n_pix);
          q.pix = static_cast<int>(item % p.n_pix);  // local; global p0 + pix
          q.key0 = rz::slot_key(p.seed, p.p0 + q.pix);
          q.depth = p.max_depth;
          q.active = q.spawn = true;
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
    if (!__any_sync(kFull, q.active)) break;
    // to the drain: no item left to hand out, few lanes tracing
    if constexpr (Sweep::kDrain) {
      if (drained && run_end - run_left >= total && sweep.n > 0 &&
          __popc(__ballot_sync(kFull, q.active)) <= kColumnsUpTo)
        break;
    }
    ++trips;
    if (!kWarp && !q.active) continue;
    trace_trip<false>(sweep, p, smem, total, q, segments, w);
  }
  if constexpr (Sweep::kDrain) {
    while (__any_sync(kFull, q.active)) {
      ++trips;
      trace_trip<true>(sweep, p, smem, total, q, segments, w);
    }
  }
  if (p.stats) {
    const unsigned int seg = __reduce_add_sync(kFull, segments);
    if (lane == 0) {
      atomicAdd(p.stats, static_cast<unsigned long long>(seg));
      atomicAdd(p.stats + rz::kStatLaneTrips,
                32ull * static_cast<unsigned long long>(trips));
    }
    if constexpr (Sweep::kMode != kResident) rz::flush_work(w, p.stats);
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

__global__ void rng_bits_kernel(uint32_t seed, const int* pix,
                                const int* sample, const int* bounce,
                                const int* draw, int n, uint32_t* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t key = rz::step_key(rz::slot_key(seed, pix[i]), sample[i],
                                    bounce[i]);
  out[i] = rz::draw_bits(key, static_cast<uint32_t>(draw[i]));
}

// Launch the queue kernel on `Sweep`: as many blocks as the card holds at
// once (the occupancy of this build at its shared memory), at most one per
// Sweep::kThreads items. `grid` receives the blocks.
template <typename Sweep>
cudaError_t launch_queue(const QueueParams& p, cudaStream_t s, int* grid) {
  const size_t smem = Sweep::smem_bytes(p);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        megakernel_queue<Sweep>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, megakernel_queue<Sweep>, Sweep::kThreads, smem);
  if (e != cudaSuccess) return e;
  const unsigned long long items =
      static_cast<unsigned long long>(p.n_samples) * p.n_pix;
  const unsigned long long most =
      (items + Sweep::kThreads - 1) / Sweep::kThreads;
  const unsigned long long room = static_cast<unsigned long long>(per_sm) *
                                  sms;
  const int blocks = static_cast<int>(most < room ? most : room);
  if (blocks <= 0) return cudaErrorInvalidConfiguration;
  megakernel_queue<Sweep><<<blocks, Sweep::kThreads, smem, s>>>(p);
  *grid = blocks;
  return cudaGetLastError();
}

template <template <bool> class Sweep>
cudaError_t launch_mode(const QueueParams& p, bool motion, cudaStream_t s,
                        int* grid) {
  return motion ? launch_queue<Sweep<true>>(p, s, grid)
                : launch_queue<Sweep<false>>(p, s, grid);
}

template <int kWidth>
cudaError_t launch_resident(const QueueParams& p, bool motion,
                            cudaStream_t s, int* grid) {
  return motion ? launch_queue<ResidentSweep<true, kWidth>>(p, s, grid)
                : launch_queue<ResidentSweep<false, kWidth>>(p, s, grid);
}

}  // namespace

// The queue kernel over samples [s0, s0 + n_samples) of the pixels [p0, p0 +
// n_pix) of the image (keys and camera rays from the global pixel; `out`,
// `hits` and the items indexed by the local pixel):
// `counter` is one zeroed uint64, `out` [n_samples, 3, n_pix] f32, `stats`
// null or [9] uint64 (segments at 0; culled and streamed also primitive
// tests at 1, block bound tests at 2, chunk bound tests at 3 and those that
// passed at 4; re-sweeps at rz::kStatResweeps, the warps' lane-trips at
// rz::kStatLaneTrips, 7 the caller's; resident also the segments swept a
// column per lane at kStatColumnSegments). mode: 0 resident, 1 culled
// (sblk/tblk, blk), 2 streamed (scb/tcb, recs/brecs, sblk/tblk with blk,
// stream, cull).
// `hits` null or [max_depth, n_samples * n_pix] int32 (culled and streamed:
// each traced segment's winner). `threads` per block: kBlock, or kWide in the
// resident mode. `grid` receives the blocks.
extern "C" int rayz_megakernel_queue(
    const float* cam, const float* stab, int n_pad, const float* ttab,
    int m_pad, int n_pix, int p0, int width, int max_depth, float t_min,
    int jitter, int has_motion, unsigned int seed, int s0, int n_samples,
    void* counter,
    float* out, void* stats, int mode, const float* sblk, const float* tblk,
    const float* scb, const float* tcb, const float* recs, const float* brecs,
    int blk, int stream_cols, int cull, int* hits, int threads, int* grid,
    void* stream) {
  QueueParams p{};
  p.cam = cam;
  p.stab = stab;
  p.ttab = ttab;
  p.n_pad = n_pad;
  p.m_pad = m_pad;
  p.n_pix = n_pix;
  p.p0 = p0;
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
  p.sblk = sblk;
  p.tblk = tblk;
  p.scb = scb;
  p.tcb = tcb;
  p.recs = recs;
  p.brecs = brecs;
  p.blk = blk;
  p.stream = stream_cols;
  p.cull = cull != 0;
  p.hits = hits;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool motion = has_motion != 0;
  if (threads != kBlock && !(mode == kResident && threads == kWide))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  switch (mode) {
    case kResident:
      e = threads == kWide ? launch_resident<kWide>(p, motion, s, grid)
                           : launch_resident<kBlock>(p, motion, s, grid);
      break;
    case kCulled:
      e = blk > 0 ? launch_mode<CulledSweep>(p, motion, s, grid)
                  : cudaErrorInvalidValue;
      break;
    case kStreamed:
      e = stream_cols > 0 && (n_pad == 0 || (recs && (brecs || !blk)))
              ? launch_mode<StreamSweep>(p, motion, s, grid)
              : cudaErrorInvalidValue;
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
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
