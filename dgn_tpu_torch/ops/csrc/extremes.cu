// Per-destination max and min of edge values on the block layout, forward
// and backward, for Hopper (sm_90a).
//
// Replaces dgn_tpu/ops/extremes.py:mxu_segment_extremes, a custom-VJP XLA
// lowering for the TPU (not Pallas): a segmented shift-max scan, bf16
// triple-split exact one-hot einsums and slot gathers, all there only to
// avoid TPU scatters.  None of that is carried over.  What it computes:
//
//   forward   mx[v, f] = max of ge[e, f] over the real edges e with dst v,
//             mn[v, f] = min of the same; 0 for a node with no real edge.
//   backward  d_ge[e, f] = [ge[e, f] == mx[v, f]] * dmx[v, f] / cnt_max[v, f]
//                        + [ge[e, f] == mn[v, f]] * dmn[v, f] / cnt_min[v, f]
//             with v = dst(e) and cnt the number of tied real edges of v (the
//             equal tie split of XLA's and torch's scatter-max gradients);
//             0 for pad edges.  Every element of d_ge is written.
//
// The layout guarantees used (dgn_tpu_torch/graph.py _mxu_edge_arrange,
// ops/mxu.py MXULayout):
//   * every 128-edge chunk has one dst node block (edge_chunk_dst[c]), and
//     edge_chunk_dst is non-decreasing, so the chunks of a dst block are one
//     contiguous range (trailing all-pad chunks carry the last block);
//   * inside a chunk the real edges of one dst are contiguous (real edges
//     come first, sorted by local dst; pad slots carry local_dst 0).
// A node's edges may still span several chunks: one per src block for a
// graph over 128 nodes, or two when a run crosses a chunk boundary.  Every
// reduction therefore runs over all chunks of the block.
//
// Bound: bytes.  At the HIV main shape (E = 15744 padded edges, F = 70,
// N = 5888) the forward reads the real edges' values once and writes the two
// [N, F] outputs (about 2.3 us at 3.35 TB/s); the backward reads the values,
// both outputs and both cotangents and writes [E, F] (about 4.6 us).  There
// are 2 compares per edge and feature, far below the compute bound.
//
// Design.  One thread block owns one (dst block, 32-feature tile): 8 warps,
// lane = feature, warp w owns the 16 node slots w, w + 8, ..., w + 120 and
// keeps their running values in registers.  For each chunk of its dst block
// the block stages, behind one barrier, the chunk's [128, 32] tile of values
// in shared memory (16 independent loads a thread, so one memory latency a
// chunk) and a run table (slot -> [start, end) of its real edges in the
// chunk); then every warp walks the runs of its slots in shared memory.
// Trailing chunks without a real edge are cut from the walk first.  The
// backward walks the runs once to count ties against the stored forward
// values, keeps mx, mn, dmx / cnt and dmn / cnt of the block in shared
// memory, and then writes d_ge for every slot of every chunk of the block.
// No atomics on values, so the result is deterministic.  Equality compares
// the very f32 values the forward wrote (no fast-math; +0.0 == -0.0, as in
// XLA).
//
// Interface: plain C, loaded with ctypes (dgn_tpu_torch/ops/extremes.py).
// The launches go on the caller's stream; each function returns
// cudaGetLastError() so that a refused launch is reported.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;                     // nodes per block, edges per chunk
constexpr int kFeat = 32;                      // features per thread block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = kTile / kWarps;         // node slots per warp (16)
constexpr int kPlane = kTile * kFeat;          // one [128, 32] f32 tile
// backward dynamic shared memory: values tile, mx, mn, dmx/cnt, dmn/cnt
constexpr int kBwdSmemBytes = 5 * kPlane * static_cast<int>(sizeof(float));

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

struct ChunkRange {
  int first;      // first chunk of the dst block
  int last;       // one past its last chunk
  int last_real;  // one past its last chunk that holds a real edge
};

// The chunk range of dst block b.  Every thread of the block gets the same.
__device__ ChunkRange block_chunks(const int32_t* __restrict__ chunk_dst,
                                   const uint8_t* __restrict__ edge_mask,
                                   int n_chunks, int b) {
  __shared__ int range[2];
  __shared__ int real_end;
  const int tid = threadIdx.x;
  if (tid == 0) range[0] = lower_bound(chunk_dst, n_chunks, b);
  if (tid == 1) range[1] = lower_bound(chunk_dst, n_chunks, b + 1);
  if (tid == 2) real_end = 0;
  __syncthreads();
  const int lo = range[0], hi = range[1];
  int mine = 0;
  for (int t = tid; t < (hi - lo) * kTile; t += kThreads) {
    if (edge_mask[static_cast<size_t>(lo) * kTile + t]) {
      mine = lo + t / kTile + 1;
    }
  }
  mine = __reduce_max_sync(0xffffffffu, mine);
  if ((tid & 31) == 0 && mine > 0) atomicMax(&real_end, mine);
  __syncthreads();
  return {lo, hi, real_end > lo ? real_end : lo};
}

// Stages chunk c: vals[i][lane] = ge[c * 128 + i, f] for the thread's
// feature f (0 where f >= n_feat), and run_start/run_end [kTile] such that
// the real edges of local dst v are the chunk positions
// [run_start[v], run_end[v]) (empty when equal).  Returns the number of
// real edges in the chunk, the same in every thread, after a barrier.
__device__ int stage_chunk(const float* __restrict__ ge,
                           const int32_t* __restrict__ local_dst,
                           const uint8_t* __restrict__ edge_mask, int c,
                           int n_feat, int f, float* vals, int* run_start,
                           int* run_end) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t base = static_cast<size_t>(c) * kTile;
  __syncthreads();  // every warp is done with the previous chunk's stage
  if (tid < kTile) {
    run_start[tid] = 0;
    run_end[tid] = 0;
  }
  float x[kSlots];
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const size_t e = base + warp + j * kWarps;
    x[j] = f < n_feat ? ge[e * n_feat + f] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    vals[(warp + j * kWarps) * kFeat + lane] = x[j];
  }
  __syncthreads();
  int real = 0;
  if (tid < kTile) {
    const size_t e = base + tid;
    real = edge_mask[e] != 0;
    if (real) {
      const int v = local_dst[e];
      if (tid == 0 || !edge_mask[e - 1] || local_dst[e - 1] != v) {
        run_start[v] = tid;
      }
      if (tid == kTile - 1 || !edge_mask[e + 1] || local_dst[e + 1] != v) {
        run_end[v] = tid + 1;
      }
    }
  }
  return __syncthreads_count(real);
}

__global__ void __launch_bounds__(kThreads)
extremes_fwd_kernel(const float* __restrict__ ge,            // [E, F]
                    const int32_t* __restrict__ local_dst,   // [E]
                    const int32_t* __restrict__ chunk_dst,   // [C]
                    const uint8_t* __restrict__ edge_mask,   // [E]
                    float* __restrict__ mx,                  // [num_nodes, F]
                    float* __restrict__ mn,                  // [num_nodes, F]
                    int n_feat, int n_chunks, int num_nodes) {
  __shared__ float vals[kPlane];
  __shared__ int run_start[kTile];
  __shared__ int run_end[kTile];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int f = blockIdx.y * kFeat + lane;
  const ChunkRange r = block_chunks(chunk_dst, edge_mask, n_chunks, b);

  float vmax[kSlots], vmin[kSlots];
  unsigned seen = 0;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    vmax[k] = -CUDART_INF_F;
    vmin[k] = CUDART_INF_F;
  }
  for (int c = r.first; c < r.last_real; ++c) {
    if (stage_chunk(ge, local_dst, edge_mask, c, n_feat, f, vals, run_start,
                    run_end) == 0) {
      continue;
    }
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int v = warp + k * kWarps;
      const int s = run_start[v], t = run_end[v];
      for (int e = s; e < t; ++e) {
        const float x = vals[e * kFeat + lane];
        vmax[k] = fmaxf(vmax[k], x);
        vmin[k] = fminf(vmin[k], x);
      }
      if (s < t) seen |= 1u << k;
    }
  }
  if (f >= n_feat) return;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int node = b * kTile + warp + k * kWarps;
    if (node < num_nodes) {
      const size_t o = static_cast<size_t>(node) * n_feat + f;
      const bool has = (seen >> k) & 1u;
      mx[o] = has ? vmax[k] : 0.f;
      mn[o] = has ? vmin[k] : 0.f;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
extremes_bwd_kernel(const float* __restrict__ ge,            // [E, F]
                    const float* __restrict__ mx,            // [num_nodes, F]
                    const float* __restrict__ mn,
                    const float* __restrict__ dmx,           // [num_nodes, F]
                    const float* __restrict__ dmn,
                    const int32_t* __restrict__ local_dst,   // [E]
                    const int32_t* __restrict__ chunk_dst,   // [C]
                    const uint8_t* __restrict__ edge_mask,   // [E]
                    float* __restrict__ d_ge,                // [E, F]
                    int n_feat, int n_chunks, int num_nodes) {
  extern __shared__ float smem[];
  float* vals = smem;                  // [128][32] values of one chunk
  float* max_s = smem + kPlane;        // mx of the block's nodes
  float* min_s = smem + 2 * kPlane;    // mn
  float* gmax_s = smem + 3 * kPlane;   // dmx / cnt_max
  float* gmin_s = smem + 4 * kPlane;   // dmn / cnt_min
  __shared__ int run_start[kTile];
  __shared__ int run_end[kTile];
  __shared__ int dst_s[kTile];
  __shared__ int real_s[kTile];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int f = blockIdx.y * kFeat + lane;
  const bool active = f < n_feat;
  const ChunkRange r = block_chunks(chunk_dst, edge_mask, n_chunks, b);

  // pass 1: count the real edges tied with each stored extreme
  float vmax[kSlots], vmin[kSlots];
  int cmax[kSlots], cmin[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int node = b * kTile + warp + k * kWarps;
    const bool ok = active && node < num_nodes;
    const size_t o = static_cast<size_t>(node) * n_feat + f;
    vmax[k] = ok ? mx[o] : 0.f;
    vmin[k] = ok ? mn[o] : 0.f;
    cmax[k] = 0;
    cmin[k] = 0;
  }
  for (int c = r.first; c < r.last_real; ++c) {
    if (stage_chunk(ge, local_dst, edge_mask, c, n_feat, f, vals, run_start,
                    run_end) == 0) {
      continue;
    }
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int v = warp + k * kWarps;
      for (int e = run_start[v]; e < run_end[v]; ++e) {
        const float x = vals[e * kFeat + lane];
        cmax[k] += x == vmax[k];
        cmin[k] += x == vmin[k];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int v = warp + k * kWarps;
    const int node = b * kTile + v;
    float gx = 0.f, gn = 0.f;
    if (active && node < num_nodes) {
      const size_t o = static_cast<size_t>(node) * n_feat + f;
      gx = dmx[o] / static_cast<float>(cmax[k] > 1 ? cmax[k] : 1);
      gn = dmn[o] / static_cast<float>(cmin[k] > 1 ? cmin[k] : 1);
    }
    max_s[v * kFeat + lane] = vmax[k];
    min_s[v * kFeat + lane] = vmin[k];
    gmax_s[v * kFeat + lane] = gx;
    gmin_s[v * kFeat + lane] = gn;
  }

  // pass 2: every edge slot of every chunk of the block, pad chunks too
  for (int c = r.first; c < r.last; ++c) {
    const size_t base = static_cast<size_t>(c) * kTile;
    if (c >= r.last_real) {  // no real edge: the whole chunk gets zeros
      if (active) {
#pragma unroll
        for (int j = 0; j < kSlots; ++j) {
          d_ge[(base + warp + j * kWarps) * n_feat + f] = 0.f;
        }
      }
      continue;
    }
    __syncthreads();  // the previous chunk's dst_s/real_s are read
    if (threadIdx.x < kTile) {
      const size_t e = base + threadIdx.x;
      real_s[threadIdx.x] = edge_mask[e];
      dst_s[threadIdx.x] = local_dst[e];
    }
    float x[kSlots];
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const size_t e = base + warp + j * kWarps;
      x[j] = active ? ge[e * n_feat + f] : 0.f;
    }
    __syncthreads();
    if (!active) continue;
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int i = warp + j * kWarps;
      float out = 0.f;
      if (real_s[i]) {
        const int v = dst_s[i];
        if (b * kTile + v < num_nodes) {
          if (x[j] == max_s[v * kFeat + lane]) out += gmax_s[v * kFeat + lane];
          if (x[j] == min_s[v * kFeat + lane]) out += gmin_s[v * kFeat + lane];
        }
      }
      d_ge[(base + i) * n_feat + f] = out;
    }
  }
}

}  // namespace

extern "C" int dgn_segment_extremes_fwd(
    const void* ge, const void* local_dst, const void* chunk_dst,
    const void* edge_mask, void* mx, void* mn, int n_feat, int n_chunks,
    int n_blocks, int num_nodes, void* stream) {
  const dim3 grid(n_blocks, (n_feat + kFeat - 1) / kFeat);
  extremes_fwd_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ge), static_cast<const int32_t*>(local_dst),
      static_cast<const int32_t*>(chunk_dst),
      static_cast<const uint8_t*>(edge_mask), static_cast<float*>(mx),
      static_cast<float*>(mn), n_feat, n_chunks, num_nodes);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dgn_segment_extremes_bwd(
    const void* ge, const void* mx, const void* mn, const void* dmx,
    const void* dmn, const void* local_dst, const void* chunk_dst,
    const void* edge_mask, void* d_ge, int n_feat, int n_chunks,
    int n_blocks, int num_nodes, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      extremes_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kBwdSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_blocks, (n_feat + kFeat - 1) / kFeat);
  extremes_bwd_kernel<<<grid, kThreads, kBwdSmemBytes,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ge), static_cast<const float*>(mx),
      static_cast<const float*>(mn), static_cast<const float*>(dmx),
      static_cast<const float*>(dmn), static_cast<const int32_t*>(local_dst),
      static_cast<const int32_t*>(chunk_dst),
      static_cast<const uint8_t*>(edge_mask), static_cast<float*>(d_ge),
      n_feat, n_chunks, num_nodes);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dgn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
