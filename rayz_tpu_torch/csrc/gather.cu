// Winner-row gather and its transpose for Hopper (sm_90a).
//
// Replace the TPU kernels rayz_tpu/ops/pathrec.py:_gather_fwd_kernel and
// _gather_bwd_kernel (launched there by gather_rows and gather_rows_T). The
// replay gathers each slot's winning parameter row out of the [P, C]
// differentiable table (P = primitives, C = 20) and its backward adds the
// row cotangents back into the table.
//
// Forward: rows = tab[idx], an index outside [0, P) giving a zero row (the
// TPU builds a one-hot per 2048-ray block and contracts it on the MXU, in
// three bf16 terms, because its vector unit cannot gather; Hopper can), in
// either layout: [R, C] (gather_rows, the "recorded" engine's per-bounce
// gathers: R = 262,144 on P = 512 rows, or 147,456 on a large scene's
// 100,352) or [C, R] (gather_rows_T, rays on columns: the fused replay's
// one gather of a pass, R = K * slots = 29,360,128 on the flagship's first
// pass, a 2.35 GB output). Bound: device-memory bandwidth, one read of the
// 4-byte indices and one write of the 4 * C bytes of each ray's row.
// Design (gather_fwd_kernel): a grid-stride loop, the grid sized to what
// the SMs hold at once, rows moved as float4s of 4 columns. [C, R]: a
// thread takes a quad of rays, reads their indices in one aligned int4
// load (a scalar tail where R % 4 != 0), range-checks each once (-1
// selects the zero row) and transposes the quad's four float4s so that for
// each column it stores 4 consecutive rays as one float4 (a warp stores
// 128 consecutive floats of a column). [R, C]: a thread takes one float4
// of the output (column quad w % 5 of ray
// w / 5 at C = 20), so a warp stores 512 consecutive bytes (a thread
// storing its own 80-byte row, lanes 80 bytes apart, half-filled each
// sector a store touched: 5.48 ms at 29,360,128 rays on an H100, against
// 0.915). Stores are streaming
// (st.global.cs): the output does not fit the 50 MB L2 and is not read
// again by this kernel. Where the table fits kFwdStageBytes of shared
// memory and each block reads at least kFwdStageRatio rows per staged row,
// each block stages it once; else rows are read through the read-only
// cache (a large scene's 8 MB table). C must be a multiple of 4.
// Only the element offsets are 64-bit. A copy, so its result equals the
// plain version's bit for bit.
//
// Backward: d_tab[p, c] = sum of g[r, c] over the rays r with idx[r] = p. It
// must be deterministic, as the TPU's contraction is: two launches on the
// same input give the same bits, so float atomics (whose order varies) are
// out. The table is cut into blocks of kRows rows and groups of kCols
// columns; one block of kWarps warps sums a run of rays into the partial
// table of one (row block, column group) in shared memory, each warp over
// its own contiguous piece of the run into its own [kRows, kCols] table. A
// warp takes 32 rays at a time: their cotangents are coalesced loads (rays
// fastest in the [C, R] layout the fused replay uses), their keys are
// sorted across the warp once (a bitonic network of shuffles over
// key * 32 + lane, so equal keys keep lane order), and a segmented scan of
// fixed shape sums each key's run; the last lane of a run adds it to the
// warp's table, where no other lane holds that key. Where every ray of the
// 32 that has a row in the block has the same row (neighbouring pixels on
// one surface), a butterfly sum replaces the sort and the scan. A warp loads
// kAhead chunks' indices, then their cotangents, before it sums any, so
// that its loads overlap. Every sum is taken in an order fixed by the input
// alone: runs of 32 in scan order, the chunks in ray order, the warps of a
// block in warp order, the runs in run order (a second launch adds their
// partial tables). Two plans cut the rays into runs:
//  * one row block (P <= kRows): no sort. The rays are cut into `tiles`
//    contiguous tiles, one block per (tile, column group); no warp sums
//    more than a few thousand rays, so a row most rays hit (a ground
//    sphere) is spread over many warps and the rounding stays near the f64
//    sum.
//  * more row blocks (a large scene's table): a stable counting sort of the
//    rays by row block (gather_bwd_count_kernel: per-tile histograms;
//    gather_bwd_scan_kernel: one exclusive scan in (row block, tile) order;
//    gather_bwd_rank_kernel: in-tile ranks by __match_any_sync, tile order
//    kept), then one block per (piece of kPiece sorted positions, column
//    group), each piece inside one row block; a ray outside [0, P) is left
//    out of the sort. So a block reads only rays that have a row in it.
// Bound: one read of g and of idx, one write of d_tab (bytes); what holds
// it back on the card is the warp shuffles of the sort and the scans, ~10
// for each value.
//
// C interface for ctypes (see ops/_build.py): each entry returns the
// launch's cudaError_t.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kFwdThreads = 256;
constexpr int kFwdStageBytes = 48 * 1024;  // no opt-in needed up to here
constexpr int kFwdStageRatio = 4;  // rows read per staged row, at least


// Columns 4q .. 4q + 3 of `row` of a [P, C] table (C % 4 == 0), or zeros
// for row -1.
template <bool kStaged>
__device__ __forceinline__ float4 row_quad(const float* src, int cols,
                                           int row, int q) {
  if (row < 0) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float4* p = reinterpret_cast<const float4*>(src + row * cols) + q;
  return kStaged ? *p : __ldg(p);
}

__device__ __forceinline__ float lane_of(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// kStaged: the table copied to shared memory first; else read from device
// memory. C % 4 == 0; tab and idx are 16-byte aligned. Work items: [C, R]
// quads of rays, [R, C] the output's float4s.
template <bool kStaged>
__global__ void __launch_bounds__(kFwdThreads)
    gather_fwd_kernel(const float* __restrict__ tab, int p_rows, int cols,
                      const int* __restrict__ idx, int rays, int transposed,
                      float* __restrict__ out) {
  extern __shared__ float4 staged[];
  const int nq = cols >> 2;
  const float* src = tab;
  if (kStaged) {
    const float4* t4 = reinterpret_cast<const float4*>(tab);
    for (int e = threadIdx.x; e < p_rows * nq; e += blockDim.x)
      staged[e] = __ldg(t4 + e);
    __syncthreads();
    src = reinterpret_cast<const float*>(staged);
  }
  const int stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  if (!transposed) {  // out [R, C]: float4 w is column quad w % nq of ray
                      // w / nq; a warp stores 512 consecutive bytes
    const int items = rays * nq;
    for (int w = first; w < items; w += stride) {
      const int r = w / nq;
      const int i = __ldg(idx + r);
      const int row =
          static_cast<unsigned>(i) < static_cast<unsigned>(p_rows) ? i : -1;
      __stcs(reinterpret_cast<float4*>(out) + w,
             row_quad<kStaged>(src, cols, row, w - r * nq));
    }
    return;
  }
  // out [C, R]: column c of the quad k at c * R + 4k
  const int quads = (rays + 3) >> 2;
  const bool col_vec = (rays & 3) == 0;  // columns 16-byte aligned
  for (int k = first; k < quads; k += stride) {
    const int r0 = 4 * k;
    const int n = min(4, rays - r0);
    int i[4];
    if (n == 4) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(idx) + k);
      i[0] = v.x, i[1] = v.y, i[2] = v.z, i[3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) i[j] = j < n ? __ldg(idx + r0 + j) : -1;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      i[j] = static_cast<unsigned>(i[j]) < static_cast<unsigned>(p_rows)
                 ? i[j] : -1;
    for (int q = 0; q < nq; ++q) {
      const float4 v0 = row_quad<kStaged>(src, cols, i[0], q);
      const float4 v1 = row_quad<kStaged>(src, cols, i[1], q);
      const float4 v2 = row_quad<kStaged>(src, cols, i[2], q);
      const float4 v3 = row_quad<kStaged>(src, cols, i[3], q);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float* o = out + static_cast<int64_t>(4 * q + j) * rays + r0;
        const float4 v = make_float4(lane_of(v0, j), lane_of(v1, j),
                                     lane_of(v2, j), lane_of(v3, j));
        if (col_vec) {
          __stcs(reinterpret_cast<float4*>(o), v);
        } else {
#pragma unroll
          for (int m = 0; m < 4; ++m)
            if (m < n) __stcs(o + m, lane_of(v, m));
        }
      }
    }
  }
}

// Blocks of gather_fwd_kernel<kStaged> one SM holds at once with `smem`
// bytes of dynamic shared memory, times the SMs (the last answer cached per
// device: a path launches at one table size).
template <bool kStaged>
int64_t fwd_grid_cap(int smem) {
  static int64_t cap[64];
  static int at[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) dev = 0;
  if (!cap[dev] || at[dev] != smem) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gather_fwd_kernel<kStaged>, kFwdThreads, smem);
    cap[dev] = static_cast<int64_t>(std::max(1, sms)) * std::max(1, per_sm);
    at[dev] = smem;
  }
  return cap[dev];
}

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;     // per block, each with its own partial table
constexpr int kRows = 512;    // table rows per block
constexpr int kCols = 4;      // table columns per block
constexpr int kAhead = 8;     // chunks of 32 rays a warp loads at once
constexpr int kTile = 1024;   // rays per tile of the counting sort
constexpr int kPiece = 4096;  // sorted positions per block (many row blocks)
constexpr size_t kBwdSmem = sizeof(float) * kWarps * kRows * kCols;

// Sort 32 distinct keys across the warp, ascending by lane.
__device__ __forceinline__ unsigned sort32(unsigned x, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const unsigned y = __shfl_xor_sync(kFull, x, j);
      const bool low = (lane & j) == 0;
      const bool asc = (lane & k) == 0;
      x = (low == asc) ? min(x, y) : max(x, y);
    }
  }
  return x;
}

// One warp's sums over positions [lo, hi) (the ray at position j is
// order[j] when kSorted, else j) into its table `tab` [kRows, kCols] of the
// rows [base, base + kRows), columns [c0, c0 + kCols).
template <bool kSorted>
__device__ __forceinline__ void warp_sums(
    const float* __restrict__ g, int64_t stride_r, int64_t stride_c,
    const int* __restrict__ idx, const int* __restrict__ order, int64_t lo,
    int64_t hi, int p_rows, int cols, int base, int c0, float* tab,
    int lane) {
  const unsigned le = lane == 31 ? kFull : (2u << lane) - 1u;
  for (int64_t j0 = lo; j0 < hi; j0 += 32 * kAhead) {
    // the indices of kAhead chunks, then the cotangents of the rays with a
    // row here, all in flight at once (a lane with no row here loads
    // nothing). The ray is recomputed (or re-read from order, a cached
    // line) rather than kept: kAhead 64-bit rays held in registers made
    // the tile plan 11% slower at the recorded-pp pass's 29.4 M rays.
    int keys[kAhead];
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      const int64_t j = j0 + 32 * a + lane;
      keys[a] = j < hi ? idx[kSorted ? order[j] : j] : -1;
    }
    float vals[kAhead][kCols];
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      const int64_t j = j0 + 32 * a + lane;
      const bool ok = keys[a] >= base && keys[a] < p_rows &&
                      keys[a] < base + kRows;
      const int64_t r = kSorted ? (ok ? order[j] : 0) : j;
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc)
        vals[a][cc] = (ok && c0 + cc < cols)
                          ? g[r * stride_r + (c0 + cc) * stride_c]
                          : 0.0f;
    }
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      const int k = keys[a];
      const bool ok = k >= base && k < p_rows && k < base + kRows;
      if (!__any_sync(kFull, ok)) continue;
      const unsigned key = ok ? static_cast<unsigned>(k - base) : kRows;
      const unsigned k0 = __shfl_sync(
          kFull, key, __ffs(__ballot_sync(kFull, ok)) - 1);
      if (__all_sync(kFull, !ok || key == k0)) {
        // one row: a butterfly sum of fixed shape, no sort
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc) {
          float x = vals[a][cc];
#pragma unroll
          for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(kFull, x, d);
          if (lane == 0) tab[k0 * kCols + cc] += x;
        }
        continue;
      }
      const unsigned s = sort32((key << 5) | lane, lane);
      const int src = static_cast<int>(s & 31u);
      const unsigned skey = s >> 5;
      const unsigned prev = __shfl_up_sync(kFull, skey, 1);
      const unsigned heads =
          __ballot_sync(kFull, lane == 0 || skey != prev);
      const int start = 31 - __clz(heads & le);
      const bool tail = lane == 31 || ((heads >> (lane + 1)) & 1u);
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) {
        float x = __shfl_sync(kFull, vals[a][cc], src);
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const float y = __shfl_up_sync(kFull, x, d);
          if (lane - d >= start) x += y;
        }
        if (tail && skey < kRows) tab[skey * kCols + cc] += x;
      }
    }
  }
}

// The block's warps' tables [kWarps, kRows, kCols], added in warp order,
// written to out[row - base, c] (row stride `cols`) for the rows
// [base, min(base + kRows, p_rows)) and columns [c0, c0 + kCols).
__device__ __forceinline__ void write_sums(const float* part, int base,
                                           int p_rows, int c0, int cols,
                                           float* __restrict__ out) {
  __syncthreads();
  for (int e = threadIdx.x; e < kRows * kCols; e += kWarps * 32) {
    const int row = e / kCols;
    const int c = c0 + e % kCols;
    if (base + row >= p_rows || c >= cols) continue;
    float sum = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += part[w * kRows * kCols + e];
    out[static_cast<int64_t>(row) * cols + c] = sum;
  }
}

// One row block: block (tile, column group) sums the rays of its tile of
// `span` rays, each warp span / kWarps of them, into out[tile] [P, C].
__global__ void __launch_bounds__(kWarps * 32)
    gather_bwd_kernel(const float* __restrict__ g, int64_t stride_r,
                      int64_t stride_c, const int* __restrict__ idx,
                      int rays, int p_rows, int cols, int64_t span,
                      float* __restrict__ out) {
  extern __shared__ float part[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ng = (cols + kCols - 1) / kCols;
  const int c0 = (blockIdx.x % ng) * kCols;
  const int64_t tile = blockIdx.x / ng;
  float* tab = part + warp * kRows * kCols;
  for (int e = lane; e < kRows * kCols; e += 32) tab[e] = 0.0f;
  __syncwarp();
  const int64_t wspan = span / kWarps;  // a multiple of 32
  const int64_t lo = tile * span + warp * wspan;
  const int64_t hi = min(lo + wspan, static_cast<int64_t>(rays));
  warp_sums<false>(g, stride_r, stride_c, idx, nullptr, lo, hi, p_rows, cols,
                   0, c0, tab, lane);
  write_sums(part, 0, p_rows, c0, cols, out + tile * p_rows * cols);
}

// hist[rb * tiles + t]: the rays of tile t whose row lies in row block rb.
// Shared-memory integer atomics: the counts do not depend on their order.
__global__ void gather_bwd_count_kernel(const int* __restrict__ idx,
                                        int rays, int p_rows, int nrb,
                                        int tiles, int* __restrict__ hist) {
  extern __shared__ int cnt[];
  for (int b = threadIdx.x; b < nrb; b += blockDim.x) cnt[b] = 0;
  __syncthreads();
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kTile;
  for (int k = threadIdx.x; k < kTile; k += blockDim.x) {
    const int64_t r = t0 + k;
    if (r >= rays) break;
    const int i = idx[r];
    if (i >= 0 && i < p_rows) atomicAdd(cnt + i / kRows, 1);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < nrb; b += blockDim.x)
    hist[static_cast<int64_t>(b) * tiles + blockIdx.x] = cnt[b];
}

// a[0, n) := its exclusive prefix sums, in place, by the one block of
// blockDim.x (a multiple of 32, at most 1024) threads; returns the total.
__device__ int block_exclusive_scan(int* a, int64_t n) {
  __shared__ int warp_sum[32];
  const int nt = blockDim.x;
  const int64_t per = (n + nt - 1) / nt;
  const int64_t lo = threadIdx.x * per;
  const int64_t hi = min(lo + per, n);
  int sum = 0;
  for (int64_t i = lo; i < hi; ++i) sum += a[i];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = sum;  // inclusive scan of the threads' sums
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nt / 32 ? warp_sum[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += y;
    }
    warp_sum[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  int run = x - sum + (warp ? warp_sum[warp - 1] : 0);
  const int total = warp_sum[nt / 32 - 1];
  for (int64_t i = lo; i < hi; ++i) {
    const int v = a[i];
    a[i] = run;
    run += v;
  }
  __syncthreads();
  return total;
}

// One block: hist := the sorted position of each (row block, tile)'s first
// ray; start[rb] the first position of row block rb (start[nrb] the rays
// with a row); pieces[rb] its first piece (pieces[nrb] the pieces in all).
__global__ void gather_bwd_scan_kernel(int* __restrict__ hist, int nrb,
                                       int tiles, int* __restrict__ start,
                                       int* __restrict__ pieces) {
  const int64_t n = static_cast<int64_t>(nrb) * tiles;
  const int total = block_exclusive_scan(hist, n);
  for (int b = threadIdx.x; b < nrb; b += blockDim.x)
    start[b] = hist[static_cast<int64_t>(b) * tiles];
  if (threadIdx.x == 0) start[nrb] = total;
  __syncthreads();
  for (int b = threadIdx.x; b <= nrb; b += blockDim.x)
    pieces[b] = b < nrb ? (start[b + 1] - start[b] + kPiece - 1) / kPiece : 0;
  __syncthreads();
  block_exclusive_scan(pieces, nrb + 1);
}

// One warp per tile: order[position] = ray, each ray at its row block's
// next position; lanes in lane order, chunks in ray order, so the sort is
// stable.
__global__ void gather_bwd_rank_kernel(const int* __restrict__ idx, int rays,
                                       int p_rows, int nrb, int tiles,
                                       const int* __restrict__ hist,
                                       int* __restrict__ order) {
  extern __shared__ int next[];
  const int lane = threadIdx.x;
  for (int b = lane; b < nrb; b += 32)
    next[b] = hist[static_cast<int64_t>(b) * tiles + blockIdx.x];
  __syncwarp();
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kTile;
  for (int k = 0; k < kTile; k += 32) {
    const int64_t r = t0 + k + lane;
    const int i = r < rays ? idx[r] : -1;
    const int rb = (i >= 0 && i < p_rows) ? i / kRows : -1;
    const unsigned peers = __match_any_sync(kFull, rb);
    const int pos = rb >= 0 ? next[rb] : 0;
    __syncwarp();
    if (rb >= 0) {
      order[pos + __popc(peers & ((1u << lane) - 1u))] =
          static_cast<int>(r);
      if (lane == __ffs(peers) - 1) next[rb] = pos + __popc(peers);
    }
    __syncwarp();
  }
}

// Many row blocks: block (piece, column group) sums the piece's sorted
// positions, each warp kPiece / kWarps of them, into out[piece]
// [kRows, C]; blocks past the last piece return.
__global__ void __launch_bounds__(kWarps * 32)
    gather_bwd_piece_kernel(const float* __restrict__ g, int64_t stride_r,
                            int64_t stride_c, const int* __restrict__ idx,
                            const int* __restrict__ order,
                            const int* __restrict__ start,
                            const int* __restrict__ pieces, int p_rows,
                            int cols, int nrb, float* __restrict__ out) {
  extern __shared__ float part[];
  const int ng = (cols + kCols - 1) / kCols;
  const int q = blockIdx.x / ng;
  const int c0 = (blockIdx.x % ng) * kCols;
  if (q >= pieces[nrb]) return;
  int lo_b = 0, hi_b = nrb;  // the row block: pieces[rb] <= q < pieces[rb+1]
  while (hi_b - lo_b > 1) {
    const int mid = (lo_b + hi_b) / 2;
    if (pieces[mid] <= q) lo_b = mid; else hi_b = mid;
  }
  const int rb = lo_b;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* tab = part + warp * kRows * kCols;
  for (int e = lane; e < kRows * kCols; e += 32) tab[e] = 0.0f;
  __syncwarp();
  const int64_t p0 = start[rb] + static_cast<int64_t>(q - pieces[rb]) * kPiece;
  const int64_t end = min(p0 + kPiece, static_cast<int64_t>(start[rb + 1]));
  const int64_t lo = p0 + warp * (kPiece / kWarps);
  const int64_t hi = min(lo + kPiece / kWarps, end);
  warp_sums<true>(g, stride_r, stride_c, idx, order, lo, hi, p_rows, cols,
                  rb * kRows, c0, tab, lane);
  write_sums(part, rb * kRows, p_rows, c0, cols,
             out + static_cast<int64_t>(q) * kRows * cols);
}

// d_tab = the tiles' partial tables [tiles, P * C] added in tile order.
__global__ void gather_bwd_tiles_kernel(const float* __restrict__ partial,
                                        int64_t n, int tiles,
                                        float* __restrict__ d_tab) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (e >= n) return;
  float sum = 0.0f;
  for (int t = 0; t < tiles; ++t) sum += partial[t * n + e];
  d_tab[e] = sum;
}

// d_tab[row, c] = the partial tables of its row block's pieces
// [pieces, kRows, C] added in piece order (zero for a row block with none).
__global__ void gather_bwd_pieces_sum_kernel(const float* __restrict__ partial,
                                             const int* __restrict__ pieces,
                                             int p_rows, int cols,
                                             float* __restrict__ d_tab) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (e >= static_cast<int64_t>(p_rows) * cols) return;
  const int row = static_cast<int>(e / cols);
  const int c = static_cast<int>(e % cols);
  const int rb = row / kRows;
  float sum = 0.0f;
  for (int q = pieces[rb]; q < pieces[rb + 1]; ++q)
    sum += partial[(static_cast<int64_t>(q) * kRows + row - rb * kRows) * cols +
                   c];
  d_tab[e] = sum;
}

}  // namespace

// tab [P, C] f32, idx [R] int32 and out ([R, C], or [C, R] when
// transposed) f32, contiguous, tab and idx 16-byte aligned, C % 4 == 0.
extern "C" int rayz_gather_fwd(const float* tab, int p_rows, int cols,
                               const int* idx, int rays, int transposed,
                               float* out, void* stream) {
  if (rays <= 0) return static_cast<int>(cudaSuccess);
  if ((cols & 3) || (reinterpret_cast<uintptr_t>(idx) & 15) ||
      (reinterpret_cast<uintptr_t>(tab) & 15))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t items = transposed ? (static_cast<int64_t>(rays) + 3) / 4
                                   : static_cast<int64_t>(rays) * (cols / 4);
  if (items >= (int64_t{1} << 31)) return cudaErrorInvalidValue;
  const int64_t want = (items + kFwdThreads - 1) / kFwdThreads;
  const int64_t stage = static_cast<int64_t>(p_rows) * cols * 4;
  if (stage <= kFwdStageBytes) {
    const int64_t grid =
        std::min(want, fwd_grid_cap<true>(static_cast<int>(stage)));
    if (rays >= static_cast<int64_t>(kFwdStageRatio) * grid * p_rows) {
      gather_fwd_kernel<true><<<static_cast<unsigned int>(grid), kFwdThreads,
                                stage, s>>>(tab, p_rows, cols, idx, rays,
                                            transposed, out);
      return static_cast<int>(cudaGetLastError());
    }
  }
  const int64_t grid = std::min(want, fwd_grid_cap<false>(0));
  gather_fwd_kernel<false><<<static_cast<unsigned int>(grid), kFwdThreads, 0,
                             s>>>(tab, p_rows, cols, idx, rays, transposed,
                                  out);
  return static_cast<int>(cudaGetLastError());
}

// g: element (r, c) at g[r * stride_r + c * stride_c]; idx [R] int32;
// d_tab [P, C]. One row block (P <= kRows): the rays cut into `tiles` tiles
// of `span` rays (a multiple of 32 * kWarps; the last may be short),
// partial [tiles, P, C] scratch when tiles > 1 (else unused), work unused.
// More row blocks: tiles and span unused; work int32 scratch of
// rayz_gather_bwd_work(R, P) ints, partial of ceil(R / kPiece) + P / kRows
// rounded up, times kRows * C floats.
extern "C" long long rayz_gather_bwd_work(int rays, int p_rows) {
  const long long nrb = (p_rows + kRows - 1) / kRows;
  const long long tiles = (rays + kTile - 1) / kTile;
  return nrb * tiles + 2 * (nrb + 1) + rays;
}

extern "C" int rayz_gather_bwd(const float* g, long long stride_r,
                               long long stride_c, const int* idx, int rays,
                               int p_rows, int cols, int tiles,
                               long long span, float* partial, int* work,
                               float* d_tab, void* stream) {
  const int nrb = (p_rows + kRows - 1) / kRows;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ng = (cols + kCols - 1) / kCols;
  const int64_t n = static_cast<int64_t>(p_rows) * cols;
  cudaError_t e;
  if (nrb == 1) {
    if (tiles < 1 || span % (32 * kWarps)) return cudaErrorInvalidValue;
    e = cudaFuncSetAttribute(gather_bwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kBwdSmem));
    if (e != cudaSuccess) return static_cast<int>(e);
    gather_bwd_kernel<<<static_cast<unsigned int>(
                            static_cast<int64_t>(tiles) * ng),
                        kWarps * 32, kBwdSmem, s>>>(
        g, static_cast<int64_t>(stride_r), static_cast<int64_t>(stride_c),
        idx, rays, p_rows, cols, static_cast<int64_t>(span),
        tiles > 1 ? partial : d_tab);
    e = cudaGetLastError();
    if (e != cudaSuccess || tiles == 1) return static_cast<int>(e);
    gather_bwd_tiles_kernel<<<static_cast<unsigned int>((n + 255) / 256),
                              256, 0, s>>>(partial, n, tiles, d_tab);
    return static_cast<int>(cudaGetLastError());
  }
  // the counting sort by row block, then the pieces
  const size_t hsmem = sizeof(int) * static_cast<size_t>(nrb);
  if (!work || !partial || hsmem > 227 * 1024) return cudaErrorInvalidValue;
  const int ntiles = (rays + kTile - 1) / kTile;
  int* hist = work;
  int* start = hist + static_cast<int64_t>(nrb) * ntiles;
  int* pieces = start + nrb + 1;
  int* order = pieces + nrb + 1;
  if (rays == 0)
    return static_cast<int>(
        cudaMemsetAsync(d_tab, 0, sizeof(float) * static_cast<size_t>(n), s));
  e = cudaFuncSetAttribute(gather_bwd_count_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(hsmem));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(gather_bwd_rank_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(hsmem));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(gather_bwd_piece_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kBwdSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  gather_bwd_count_kernel<<<ntiles, 256, hsmem, s>>>(idx, rays, p_rows, nrb,
                                                     ntiles, hist);
  gather_bwd_scan_kernel<<<1, 1024, 0, s>>>(hist, nrb, ntiles, start,
                                            pieces);
  gather_bwd_rank_kernel<<<ntiles, 32, hsmem, s>>>(idx, rays, p_rows, nrb,
                                                   ntiles, hist, order);
  const int64_t most = (static_cast<int64_t>(rays) + kPiece - 1) / kPiece +
                       nrb;
  gather_bwd_piece_kernel<<<static_cast<unsigned int>(most * ng),
                            kWarps * 32, kBwdSmem, s>>>(
      g, static_cast<int64_t>(stride_r), static_cast<int64_t>(stride_c), idx,
      order, start, pieces, p_rows, cols, nrb, partial);
  gather_bwd_pieces_sum_kernel<<<static_cast<unsigned int>((n + 255) / 256),
                                 256, 0, s>>>(partial, pieces, p_rows, cols,
                                              d_tab);
  return static_cast<int>(cudaGetLastError());
}
