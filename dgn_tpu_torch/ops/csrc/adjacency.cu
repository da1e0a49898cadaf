// Weighted adjacency blocks of the block layout, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel dgn_tpu/ops/pallas/adjacency.py
// (build_pair_adjacency): [K, E] per-family edge weights become
// [P, K, 128, 128] blocks with W[p, k, i, j] = sum of w[k, e] over the edges
// e of pair p whose local_src is i and local_dst is j.  Pad edges carry
// weight 0; pairs that own no chunk (pad pairs) come out as zeros.
//
// Bound: writing the output.  On the main path (ZINC, batch 128: P=64, K=3)
// the kernel writes 64*3*128*128 f32 = 12.6 MB and reads about 0.2 MB, so
// it cannot take less than about 3.8 us at the H100 SXM's 3.35 TB/s.  The
// design therefore writes every output block exactly once, coalesced, and
// reads each input once.
//
// Design.  The TPU kernel walks the chunks in pair order on one core and
// carries a [K, 128, 128] VMEM accumulator from grid step to grid step.
// Hopper blocks run in parallel and carry nothing between them, so here
// one thread block OWNS one (pair, family) output block: it finds its
// pair's chunk range in pair_sorted_ids (non-decreasing) by binary search,
// visits those chunks through pair_chunk_order, scatters each edge's weight
// into a 64 KB f32 accumulator in dynamic shared memory with a shared-memory
// atomicAdd, and then writes the whole block once.  A pair with no chunks
// writes zeros.  Tail pad chunks and pad edges inside a chunk carry weight 0
// and are skipped, so they add exactly nothing.
//
// Precision.  Accumulation is f32.  For simple graphs each (pair, i, j) cell
// receives at most one edge, so the result is exact.  With multigraph edges
// the order of the f32 additions into one cell depends on the atomics'
// timing and varies from run to run.  bf16 output converts each f32 sum once
// with __float2bfloat16.
//
// Interface: plain C, loaded with ctypes (dgn_tpu_torch/ops/adjacency.py).
// The launch goes on the caller's stream; the function returns
// cudaGetLastError() so a refused launch is reported.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;
constexpr int kThreads = 256;
constexpr int kCells = kTile * kTile;
constexpr int kSmemBytes = kCells * static_cast<int>(sizeof(float));  // 64 KB

__device__ int lower_bound(const int32_t* __restrict__ a, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__device__ __forceinline__ void store4(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 packed;
  packed.x = *reinterpret_cast<uint32_t*>(&lo);
  packed.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = packed;
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
pair_adjacency_kernel(const float* __restrict__ weights,          // [K, E]
                      const int32_t* __restrict__ local_src,      // [E]
                      const int32_t* __restrict__ local_dst,      // [E]
                      const int32_t* __restrict__ pair_chunk_order,  // [C]
                      const int32_t* __restrict__ pair_sorted_ids,   // [C]
                      OutT* __restrict__ out,                     // [P,K,T,T]
                      int n_fam, int n_edges, int n_chunks) {
  extern __shared__ float4 acc4[];  // [kCells / 4]
  float* acc = reinterpret_cast<float*>(acc4);
  __shared__ int range[2];

  const int p = blockIdx.x;
  const int k = blockIdx.y;
  const int tid = threadIdx.x;

  for (int i = tid; i < kCells / 4; i += kThreads) {
    acc4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (tid == 0) range[0] = lower_bound(pair_sorted_ids, n_chunks, p);
  if (tid == 1) range[1] = lower_bound(pair_sorted_ids, n_chunks, p + 1);
  __syncthreads();

  const float* w_k = weights + static_cast<size_t>(k) * n_edges;
  const int first = range[0];
  const int total = (range[1] - first) * kTile;  // edge slots of this pair
  for (int t = tid; t < total; t += kThreads) {
    const int chunk = pair_chunk_order[first + t / kTile];
    const int e = chunk * kTile + (t % kTile);
    const float w = w_k[e];
    if (w != 0.f) {
      atomicAdd(&acc[local_src[e] * kTile + local_dst[e]], w);
    }
  }
  __syncthreads();

  OutT* block = out + (static_cast<size_t>(p) * n_fam + k) * kCells;
  for (int i = tid; i < kCells / 4; i += kThreads) {
    store4(block + 4 * i, acc4[i]);
  }
}

template <typename OutT>
int launch(const void* weights, const void* local_src, const void* local_dst,
           const void* pair_chunk_order, const void* pair_sorted_ids,
           void* out, int n_fam, int n_edges, int n_chunks, int n_pairs,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      pair_adjacency_kernel<OutT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_pairs, n_fam);
  pair_adjacency_kernel<OutT><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const float*>(weights),
      static_cast<const int32_t*>(local_src),
      static_cast<const int32_t*>(local_dst),
      static_cast<const int32_t*>(pair_chunk_order),
      static_cast<const int32_t*>(pair_sorted_ids),
      static_cast<OutT*>(out), n_fam, n_edges, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dgn_build_pair_adjacency(
    const void* weights, const void* local_src, const void* local_dst,
    const void* pair_chunk_order, const void* pair_sorted_ids, void* out,
    int n_fam, int n_edges, int n_chunks, int n_pairs, int out_bf16,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16) {
    return launch<__nv_bfloat16>(weights, local_src, local_dst,
                                 pair_chunk_order, pair_sorted_ids, out,
                                 n_fam, n_edges, n_chunks, n_pairs, s);
  }
  return launch<float>(weights, local_src, local_dst, pair_chunk_order,
                       pair_sorted_ids, out, n_fam, n_edges, n_chunks,
                       n_pairs, s);
}

extern "C" const char* dgn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
