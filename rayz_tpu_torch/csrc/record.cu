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
// ray, 5 per ray and bounce in, 1 out) are small beside it.
//
// Resident (`record_queue`): both tables in dynamic shared memory, every
// column swept, as the resident megakernel does it (csrc/megakernel.cu
// megakernel_queue):
//  * the sphere geometry staged as 16-byte records and swept by
//    rz::sweep_packed (the coefficient form, fused multiply-adds), the
//    winner settled in today's arithmetic by rz::settle_winner (the
//    runner-up, the grazing column and the sphere the ray leaves, which is
//    the previous bounce's sphere winner, contest it there; a rejected
//    winner is swept again in today's form). The paths are then the plain
//    recorder's but at the near ties and grazing roots ops/sweep.py's rule
//    accepts. The triangles keep rz::sweep_triangles on their shared
//    table, the shading rz::shade, which reads the winner's centre and
//    material from the row-major table in device memory;
//  * a persistent grid (the card's occupancy) whose warps claim runs of
//    kRun rays from one counter in device memory with one atomicAdd and
//    hand them to their free lanes (__ballot_sync/__popc). A lane carries
//    its ray across its bounces and takes the next ray when the path ends,
//    so no lane waits for the longest path of its warp: with one thread per
//    ray, 0.74 of the lane-trips of the flagship's pass were idle, a 0.76%
//    tail of 32-bounce glass paths holding their warps (PERF.md). The
//    wrapper fills idx with -1 before the launch; the kernel writes only
//    winners, so a dead lane makes no stores. A launch still lasts as long
//    as its longest chain of bounces (~2.7 ms at the flagship, most of a
//    one-pass launch), so render_diff records several sample passes per
//    launch, their rays side by side (diffkernel.RECORD_GROUP).
//
// Streamed (`record_kernel`): the streamed megakernel's layout. Each class
// is Morton-sorted, padded to a chunk multiple with poisoned columns, its
// chunks ordered near to far from the camera and its blocks near to far
// inside each chunk; the tables and block rows stay in device memory (read
// through L1/L2: the threads of a warp read the same column at once), the
// chunk bound rows [4, columns / chunk] sit in shared memory. One thread
// per ray, 128-thread blocks, the ray in registers for all bounces (a dead
// thread only writes -1 for the bounces left). Each ray enters a chunk
// only if its bound passes, then each block of `blk` columns only if its
// bound passes (rz::sweep_chunks, the streamed megakernel's sweep); the
// TPU tests the bounds tile-wide, and since they are conservative both
// find the same winner. The sweep finds the winner's SORTED column; before
// it is written, sperm/tperm map it back to the scene's own column, so the
// index still names a _diff_tables row (rz::shade reads the sorted column,
// which holds the same values). Sorting changes which of two columns at
// exactly the same f32 distance comes first, so only at such a tie can a
// winner differ from an original-order sweep. Padding never wins, and a
// miss (-1) is never remapped.
//
// `stats` (optional, [8] uint64): ray segments traced, primitive columns
// tested, block bound tests, chunk bound tests, chunk bound tests passed
// (rz::Work); resident also the re-sweeps (rz::kStatResweeps), the
// lane-trips of the warps that ran (rz::kStatLaneTrips) and the longest
// time, in ns, a warp ran after the ray counter drained (kStatTailNs).
//
// C interface for ctypes (see ops/_build.py): returns the launch's
// cudaError_t.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kBlock = 128;
constexpr int kRun = 32;  // rays a warp claims with one atomicAdd
constexpr int kStatTailNs = 7;    // stats slot of the drained-counter tail

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
  unsigned long long* counter;  // resident: [2] zeroed (rays claimed, ns)
  unsigned long long* stats;    // [8] or null
  int n, m;           // table columns (chunk multiples when streamed)
  int tri_base;       // index of triangle column 0
  int r, depth, stream, blk;
  float t_min;
};

__device__ __forceinline__ rz::Ray load_ray(const float* rays, size_t r,
                                            size_t i) {
  rz::Ray ray;
  ray.ox = rays[0 * r + i];
  ray.oy = rays[1 * r + i];
  ray.oz = rays[2 * r + i];
  ray.dx = rays[3 * r + i];
  ray.dy = rays[4 * r + i];
  ray.dz = rays[5 * r + i];
  ray.tau = rays[6 * r + i];
  return ray;
}

// One bounce's scatter from the given randoms of ray i at bounce b: true
// where the path goes on.
template <bool kMotion>
__device__ __forceinline__ bool scatter_given(
    const Params& p, const float* sph, const float* tri, rz::Ray& ray,
    const rz::RayTerms& t, float qb, int best, bool is_tri, int b,
    size_t i) {
  const size_t r = static_cast<size_t>(p.r);
  const float* u = p.rand + static_cast<size_t>(b) * 5 * r + i;
  const rz::GivenDraws dr{u[0], u[r], u[2 * r], u[3 * r], u[4 * r]};
  // the throughput and radiance are the replay's business: unused here
  float thx = 1.0f, thy = 1.0f, thz = 1.0f, ar = 0.0f, ag = 0.0f, ab = 0.0f;
  return rz::shade<kMotion>(sph, p.n, tri, p.m, ray, t, qb, best, is_tri, dr,
                            thx, thy, thz, ar, ag,
                            ab) == rz::Bounce::kContinued;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The resident mode: the persistent ray queue on the packed sweep (see the
// head of this file).
template <bool kMotion>
__global__ void __launch_bounds__(kBlock, 8) record_queue(Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const rz::PackedSpheres ps = rz::stage_spheres<kMotion>(p.stab, p.n, smem);
  float* s_tri = smem + rz::packed_words<kMotion>(p.n);
  for (int i = threadIdx.x; i < rz::kTRows * p.m; i += kBlock)
    s_tri[i] = p.ttab[i];
  __syncthreads();

  constexpr unsigned kFull = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const unsigned long long total = static_cast<unsigned long long>(p.r);
  const size_t r = static_cast<size_t>(p.r);
  // the warp's claimed run (warp-uniform): rays [run_end - run_left,
  // run_end) are still to hand out; drained once a claim reached the end
  unsigned long long run_end = 0;
  int run_left = 0;
  bool drained = false;

  rz::Ray ray;
  size_t i = 0;
  int b = 0, from = -1;
  bool active = false;
  unsigned int segments = 0, trips = 0, resweeps = 0;
  while (true) {
    const unsigned need = __ballot_sync(kFull, !active);
    if (need) {
      const int k = __popc(need);
      const bool refill = k > run_left && !drained;
      unsigned long long fresh = 0;
      if (refill) {
        if (lane == 0) {
          fresh = atomicAdd(p.counter, static_cast<unsigned long long>(kRun));
          if (fresh < total && fresh + kRun >= total)
            atomicMax(p.counter + 1, global_ns());  // the last claim
        }
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
          i = static_cast<size_t>(item);
          ray = load_ray(p.rays, r, i);
          b = 0;
          from = -1;
          active = true;
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
    const rz::RayTerms t = rz::ray_terms(ray, p.t_min);
    const rz::RayCoef c = rz::ray_coef(ray, t);
    float qb = rz::kBig;
    int best = -1, second = -1, graze = -1;
    bool is_tri = false;
    rz::sweep_packed<kMotion>(ps, p.n, c, qb, best, second, graze);
    resweeps += rz::settle_winner<kMotion>(ps, p.n, from, ray, t, c, qb, best,
                                           second, graze);
    rz::sweep_triangles(s_tri, p.m, ray, t, qb, best, is_tri);
    if (!(qb < rz::kBig)) {  // a miss: idx keeps its -1
      active = false;
      continue;
    }
    p.idx[static_cast<size_t>(b) * r + i] = is_tri ? p.tri_base + best : best;
    active = scatter_given<kMotion>(p, p.stab, s_tri, ray, t, qb, best,
                                    is_tri, b, i) &&
             b + 1 < p.depth;
    from = is_tri ? -1 : best;
    ++b;
  }
  if (p.stats) {
    const unsigned int seg = __reduce_add_sync(kFull, segments);
    const unsigned int rs = __reduce_add_sync(kFull, resweeps);
    if (lane == 0) {
      atomicAdd(p.stats, static_cast<unsigned long long>(seg));
      atomicAdd(p.stats + 1, static_cast<unsigned long long>(seg) *
                                 static_cast<unsigned long long>(p.n + p.m));
      atomicAdd(p.stats + rz::kStatResweeps,
                static_cast<unsigned long long>(rs));
      atomicAdd(p.stats + rz::kStatLaneTrips,
                32ull * static_cast<unsigned long long>(trips));
      const unsigned long long end = global_ns();
      const unsigned long long last =
          *static_cast<volatile unsigned long long*>(p.counter + 1);
      if (last && end > last) atomicMax(p.stats + kStatTailNs, end - last);
    }
  }
}

// The streamed mode: one thread per ray (see the head of this file).
template <bool kMotion>
__global__ void __launch_bounds__(kBlock) record_kernel(Params p) {
  extern __shared__ float smem[];
  const int ns = 4 * (p.n / p.stream);
  const int nt = 4 * (p.m / p.stream);
  for (int i = threadIdx.x; i < ns; i += kBlock) smem[i] = p.scb[i];
  for (int i = threadIdx.x; i < nt; i += kBlock) smem[ns + i] = p.tcb[i];
  const float* scb = smem;
  const float* tcb = smem + ns;
  __syncthreads();

  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= p.r) return;
  const size_t r = static_cast<size_t>(p.r);
  rz::Ray ray = load_ray(p.rays, r, i);

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
    rz::sweep_chunks<kMotion, false>(p.stab, p.n, scb, p.sbl, p.stream, p.blk,
                                     true, ray, t, qb, best, is_tri, w);
    rz::sweep_chunks<kMotion, true>(p.ttab, p.m, tcb, p.tbl, p.stream, p.blk,
                                    true, ray, t, qb, best, is_tri, w);
    if (!(qb < rz::kBig)) {
      *out = -1;
      alive = false;
      continue;
    }
    *out = is_tri ? p.tri_base + p.tperm[best] : p.sperm[best];
    alive = scatter_given<kMotion>(p, p.stab, p.ttab, ray, t, qb, best,
                                   is_tri, b, i);
  }
  if (p.stats) rz::flush_work(w, p.stats);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <bool kMotion>
cudaError_t launch_streamed(const Params& p, size_t smem,
                            cudaStream_t stream) {
  cudaError_t e = allow_smem(record_kernel<kMotion>, smem);
  if (e != cudaSuccess) return e;
  const int blocks = (p.r + kBlock - 1) / kBlock;
  record_kernel<kMotion><<<blocks, kBlock, smem, stream>>>(p);
  return cudaGetLastError();
}

// The queue's persistent grid: as many blocks as the card holds at once
// (the occupancy of this build at `smem` bytes), at most one per kBlock
// rays.
template <bool kMotion>
cudaError_t launch_queue(const Params& p, size_t smem, cudaStream_t stream) {
  cudaError_t e = allow_smem(record_queue<kMotion>, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, record_queue<kMotion>, kBlock, smem);
  if (e != cudaSuccess) return e;
  const long long most = (static_cast<long long>(p.r) + kBlock - 1) / kBlock;
  const long long cap = static_cast<long long>(per_sm) * sms;
  const int blocks = static_cast<int>(most < cap ? most : cap);
  if (blocks <= 0) return cudaErrorInvalidConfiguration;
  record_queue<kMotion><<<blocks, kBlock, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// stream_cols = 0: resident (the sphere geometry packed and the triangle
// table in shared memory, the queue; `counter` a zeroed [2] uint64, `idx`
// filled with -1 beforehand; the streamed arguments unused); > 0: streamed
// in chunks of stream_cols columns behind blocks of blk columns (n and m
// are multiples of stream_cols, stream_cols of blk): scb/tcb chunk bounds,
// sbl/tbl block bounds, sperm/tperm the sorted -> scene column maps;
// `counter` unused. stats: null or [8] uint64 counters.
extern "C" int rayz_record(const float* stab, int n, const float* ttab,
                           int m, const float* scb, const float* tcb,
                           const float* sbl, const float* tbl,
                           const int* sperm, const int* tperm,
                           int stream_cols, int blk, int tri_base,
                           const float* rays, const float* rand, int r,
                           int depth, float t_min, int has_motion, int* idx,
                           void* counter, void* stats, void* stream) {
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
  p.counter = static_cast<unsigned long long*>(counter);
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
    e = motion ? launch_streamed<true>(p, smem, s)
               : launch_streamed<false>(p, smem, s);
  } else {
    if (counter == nullptr) return cudaErrorInvalidValue;
    const size_t smem =
        sizeof(float) *
        (static_cast<size_t>(motion ? rz::packed_words<true>(n)
                                    : rz::packed_words<false>(n)) +
         rz::kTRows * static_cast<size_t>(m));
    e = motion ? launch_queue<true>(p, smem, s)
               : launch_queue<false>(p, smem, s);
  }
  return static_cast<int>(e);
}
