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
// three bf16 terms, because its vector unit cannot gather; Hopper can). One
// thread per output element, in either layout: [R, C] (gather_rows) or
// [C, R] (gather_rows_T, rays on columns). Output stores are coalesced;
// the table is a few KB and stays in L1/L2. Bound: device-memory bandwidth
// (4 bytes of index per ray, 4 * C bytes of rows).
//
// Backward: d_tab[p, c] = sum of g[r, c] over the rays r with idx[r] = p. It
// must be deterministic, as the TPU's contraction is: two launches on the
// same input give the same bits, so float atomics (whose order varies) are
// out. The caller sorts the ray ids by index (a stable torch.argsort, glue)
// and finds each row's segment [bounds[p], bounds[p + 1]); one block per
// (p, c) then sums its segment in a fixed order: thread t takes positions
// t, t + 512, ... in ray order, and the 512 partial sums meet in a
// shared-memory tree. A flagship step puts ~10^5 rays on the ground sphere:
// a sequential f32 sum that long may drift by 10^5 * 2^-24 = 6e-3 of the sum
// of magnitudes, while ~200 terms per thread and a 9-level tree bound the
// drift by ~1.3e-5. Bound: the gathered reads of g, one pass.
//
// C interface for ctypes (see ops/_build.py): each entry returns the
// launch's cudaError_t.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kFwdThreads = 256;
constexpr int kBwdThreads = 512;

__global__ void gather_fwd_kernel(const float* __restrict__ tab, int p_rows,
                                  int cols, const int* __restrict__ idx,
                                  int rays, int transposed,
                                  float* __restrict__ out) {
  const int64_t e =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= static_cast<int64_t>(rays) * cols) return;
  int r, c;
  if (transposed) {  // out [C, R]
    c = static_cast<int>(e / rays);
    r = static_cast<int>(e % rays);
  } else {  // out [R, C]
    r = static_cast<int>(e / cols);
    c = static_cast<int>(e % cols);
  }
  const int i = idx[r];
  out[e] = (i >= 0 && i < p_rows) ? tab[static_cast<int64_t>(i) * cols + c]
                                  : 0.0f;
}

__global__ void __launch_bounds__(kBwdThreads)
    gather_bwd_kernel(const float* __restrict__ g, int64_t stride_r,
                      int64_t stride_c, const int64_t* __restrict__ order,
                      const int64_t* __restrict__ bounds, int cols,
                      float* __restrict__ d_tab) {
  __shared__ float part[kBwdThreads];
  const int p = blockIdx.x;
  const int c = blockIdx.y;
  const int64_t lo = bounds[p];
  const int64_t hi = bounds[p + 1];
  float acc = 0.0f;
  for (int64_t j = lo + threadIdx.x; j < hi; j += kBwdThreads)
    acc += g[order[j] * stride_r + c * stride_c];
  part[threadIdx.x] = acc;
  __syncthreads();
  for (int s = kBwdThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) part[threadIdx.x] += part[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) d_tab[static_cast<int64_t>(p) * cols + c] = part[0];
}

}  // namespace

extern "C" int rayz_gather_fwd(const float* tab, int p_rows, int cols,
                               const int* idx, int rays, int transposed,
                               float* out, void* stream) {
  const int64_t n = static_cast<int64_t>(rays) * cols;
  const int64_t blocks = (n + kFwdThreads - 1) / kFwdThreads;
  gather_fwd_kernel<<<static_cast<unsigned int>(blocks), kFwdThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      tab, p_rows, cols, idx, rays, transposed, out);
  return static_cast<int>(cudaGetLastError());
}

// g: element (r, c) at g[r * stride_r + c * stride_c]; order [R] ray ids
// sorted by index (stable); bounds [P + 1] segment starts; d_tab [P, C].
extern "C" int rayz_gather_bwd(const float* g, long long stride_r,
                               long long stride_c, const long long* order,
                               const long long* bounds, int p_rows, int cols,
                               float* d_tab, void* stream) {
  const dim3 grid(static_cast<unsigned int>(p_rows),
                  static_cast<unsigned int>(cols));
  gather_bwd_kernel<<<grid, kBwdThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      g, static_cast<int64_t>(stride_r), static_cast<int64_t>(stride_c),
      reinterpret_cast<const int64_t*>(order),
      reinterpret_cast<const int64_t*>(bounds), cols, d_tab);
  return static_cast<int>(cudaGetLastError());
}
