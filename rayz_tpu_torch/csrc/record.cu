// Bounce-indexed path recorder for Hopper (sm_90a).
//
// Replaces the TPU kernel rayz_tpu/ops/diffkernel.py:_record_kernel
// (launched there by record_paths, one pallas_call per sample pass). It
// traces R given rays for `depth` bounces and writes, per bounce and ray,
// the winning primitive index (-1 on a miss or once the path has died;
// spheres are their column, triangles tri_base + column, tri_base being the
// raw padded sphere count, so an index is a row of _diff_tables). Each
// bounce is the megakernel's: nearest hit over the spheres, then the
// triangles, then rz::shade's hit frame and material scatter, fed with the
// random numbers the host supplies (rand [depth, 5, R]: unit vector, cube
// root of a uniform, Schlick coin) through rz::GivenDraws. With the same
// numbers the megakernel hashes from its keys, the recorded path is the
// megakernel's path.
//
// What bounds it on the H100: the FP32 sweep, every live ray segment
// against every column (resident), or against the columns of the blocks
// whose bound it may enter (streamed). The reads and writes (7 words per
// ray, 5 per ray and bounce in, 1 out) are coalesced, rays fastest.
//
// Design: one thread per ray, 128-thread blocks, the ray in registers for
// all bounces (the TPU's (ray tile, bounce) grid and its scratch carry
// become a per-thread loop). The TPU skips a tile whose rays are all dead;
// here a dead thread does not sweep, it only writes -1 for the bounces left,
// so no block vote is taken (a block-wide early exit would save those stores
// only; not measured).
//
// Table modes (template parameter kStreamed):
//  * resident: both tables in dynamic shared memory (the megakernel's
//    layout without the camera words, >48 KB opt-in), every column swept
//    with the megakernel's sweeps (IEEE 1/ndd in the triangle test, so the
//    winners are the megakernel's, not the TPU's approximate reciprocal's).
//  * streamed: the streamed megakernel's layout. Each class is
//    Morton-sorted, padded to a chunk multiple with poisoned columns, its
//    chunks ordered near to far from the camera and its blocks near to far
//    inside each chunk; the tables and block rows stay in device memory
//    (read through L1/L2: the threads of a warp read the same column at
//    once), the chunk bound rows [4, columns / chunk] sit in shared memory.
//    Each ray enters a chunk only if its bound passes, then each block of
//    `blk` columns only if its bound passes (rz::sweep_chunks, the streamed
//    megakernel's sweep); the TPU tests the bounds tile-wide, and since
//    they are conservative both find the same winner. The sweep finds the
//    winner's SORTED column; before it is written, sperm/tperm map it back
//    to the scene's own column, so the index still names a _diff_tables row
//    (rz::shade reads the sorted column, which holds the same values).
//    Sorting changes which of two columns at exactly the same f32 distance
//    comes first, so only at such a tie can a winner differ from an
//    original-order sweep. Padding never wins, and a miss (-1) is never
//    remapped.
//
// `stats` (optional, [8] uint64, rz::Work): ray segments traced, primitive
// columns tested, block bound tests, chunk bound tests, chunk bound tests
// passed.
//
// C interface for ctypes (see ops/_build.py): returns the launch's
// cudaError_t.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kBlock = 128;

struct Params {
  const float* stab;  // [17, n] spheres
  const float* ttab;  // [20, m] triangles
  const float* scb;   // streamed: [4, n / stream] chunk bounds
  const float* tcb;   // streamed: [4, m / stream]
  const float* sbl;   // streamed: [4, n / blk] block bounds
  const float* tbl;   // streamed: [4, m / blk]
  const int* sperm;   // streamed: [n] sorted sphere column -> scene column
  const int* tperm;   // streamed: [m]
  const float* rays;  // [7, r] origin, direction, time
  const float* rand;  // [depth, 5, r]
  int* idx;           // [depth, r]
  unsigned long long* stats;  // [8] or null
  int n, m;           // table columns (chunk multiples when streamed)
  int tri_base;       // index of triangle column 0
  int r, depth, stream, blk;
  float t_min;
};

template <bool kMotion, bool kStreamed>
__global__ void __launch_bounds__(kBlock) record_kernel(Params p) {
  extern __shared__ float smem[];
  const float* sph = p.stab;
  const float* tri = p.ttab;
  const float* scb = smem;
  const float* tcb = smem;
  if constexpr (kStreamed) {
    const int ns = 4 * (p.n / p.stream);
    const int nt = 4 * (p.m / p.stream);
    for (int i = threadIdx.x; i < ns; i += kBlock) smem[i] = p.scb[i];
    for (int i = threadIdx.x; i < nt; i += kBlock) smem[ns + i] = p.tcb[i];
    tcb = smem + ns;
  } else {
    for (int i = threadIdx.x; i < rz::kSRows * p.n; i += kBlock)
      smem[i] = p.stab[i];
    float* s_tri = smem + rz::kSRows * p.n;
    for (int i = threadIdx.x; i < rz::kTRows * p.m; i += kBlock)
      s_tri[i] = p.ttab[i];
    sph = smem;
    tri = s_tri;
  }
  __syncthreads();

  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= p.r) return;
  const size_t r = static_cast<size_t>(p.r);
  rz::Ray ray;
  ray.ox = p.rays[0 * r + i];
  ray.oy = p.rays[1 * r + i];
  ray.oz = p.rays[2 * r + i];
  ray.dx = p.rays[3 * r + i];
  ray.dy = p.rays[4 * r + i];
  ray.dz = p.rays[5 * r + i];
  ray.tau = p.rays[6 * r + i];

  rz::Work w;
  bool alive = true;
  for (int b = 0; b < p.depth; ++b) {
    int* out = p.idx + static_cast<size_t>(b) * r + i;
    if (!alive) {
      *out = -1;
      continue;
    }
    ++w.segments;
    const rz::RayTerms t = rz::ray_terms(ray, p.t_min);
    float qb = rz::kBig;
    int best = -1;
    bool is_tri = false;
    if constexpr (kStreamed) {
      rz::sweep_chunks<kMotion, false>(sph, p.n, scb, p.sbl, p.stream, p.blk,
                                       true, ray, t, qb, best, is_tri, w);
      rz::sweep_chunks<kMotion, true>(tri, p.m, tcb, p.tbl, p.stream, p.blk,
                                      true, ray, t, qb, best, is_tri, w);
    } else {
      w.prims += p.n + p.m;
      rz::sweep_spheres<kMotion>(sph, p.n, ray, t, qb, best);
      rz::sweep_triangles(tri, p.m, ray, t, qb, best, is_tri);
    }
    if (!(qb < rz::kBig)) {
      *out = -1;
      alive = false;
      continue;
    }
    if constexpr (kStreamed)
      *out = is_tri ? p.tri_base + p.tperm[best] : p.sperm[best];
    else
      *out = is_tri ? p.tri_base + best : best;
    const float* u = p.rand + static_cast<size_t>(b) * 5 * r + i;
    const rz::GivenDraws dr{u[0], u[r], u[2 * r], u[3 * r], u[4 * r]};
    // the throughput and radiance are the replay's business: unused here
    float thx = 1.0f, thy = 1.0f, thz = 1.0f, ar = 0.0f, ag = 0.0f, ab = 0.0f;
    alive = rz::shade<kMotion>(sph, p.n, tri, p.m, ray, t, qb, best, is_tri,
                               dr, thx, thy, thz, ar, ag,
                               ab) == rz::Bounce::kContinued;
  }
  if (p.stats) rz::flush_work(w, p.stats);
}

template <bool kMotion, bool kStreamed>
cudaError_t launch(const Params& p, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        record_kernel<kMotion, kStreamed>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int blocks = (p.r + kBlock - 1) / kBlock;
  record_kernel<kMotion, kStreamed><<<blocks, kBlock, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// stream_cols = 0: resident (stab/ttab copied into shared memory; the
// streamed arguments unused); > 0: streamed in chunks of stream_cols
// columns behind blocks of blk columns (n and m are multiples of
// stream_cols, stream_cols of blk): scb/tcb chunk bounds, sbl/tbl block
// bounds, sperm/tperm the sorted -> scene column maps. stats: null or [8]
// uint64 counters.
extern "C" int rayz_record(const float* stab, int n, const float* ttab,
                           int m, const float* scb, const float* tcb,
                           const float* sbl, const float* tbl,
                           const int* sperm, const int* tperm,
                           int stream_cols, int blk, int tri_base,
                           const float* rays, const float* rand, int r,
                           int depth, float t_min, int has_motion, int* idx,
                           void* stats, void* stream) {
  Params p;
  p.stab = stab;
  p.ttab = ttab;
  p.scb = scb;
  p.tcb = tcb;
  p.sbl = sbl;
  p.tbl = tbl;
  p.sperm = sperm;
  p.tperm = tperm;
  p.rays = rays;
  p.rand = rand;
  p.idx = idx;
  p.stats = static_cast<unsigned long long*>(stats);
  p.n = n;
  p.m = m;
  p.tri_base = tri_base;
  p.r = r;
  p.depth = depth;
  p.stream = stream_cols;
  p.blk = blk;
  p.t_min = t_min;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool motion = has_motion != 0;
  cudaError_t e;
  if (stream_cols > 0) {
    if (blk <= 0 || stream_cols % blk) return cudaErrorInvalidValue;
    const size_t smem = sizeof(float) * 4 *
                        static_cast<size_t>(n / stream_cols + m / stream_cols);
    e = motion ? launch<true, true>(p, smem, s)
               : launch<false, true>(p, smem, s);
  } else {
    const size_t smem = sizeof(float) * (rz::kSRows * static_cast<size_t>(n) +
                                         rz::kTRows * static_cast<size_t>(m));
    e = motion ? launch<true, false>(p, smem, s)
               : launch<false, false>(p, smem, s);
  }
  return static_cast<int>(e);
}
