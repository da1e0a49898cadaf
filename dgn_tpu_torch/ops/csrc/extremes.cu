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
//             0 for pad edges.  Every element of d_ge is written once.
//
// The layout guarantees used (dgn_tpu_torch/graph.py _mxu_edge_arrange,
// ops/mxu.py MXULayout):
//   * every 128-edge chunk has one dst node block (edge_chunk_dst[c]), and
//     edge_chunk_dst is non-decreasing, so the chunks of a dst block are one
//     contiguous range (trailing all-pad chunks carry the last block);
//   * inside a chunk the real edges come first, sorted by local dst, so the
//     real edges of one dst are contiguous and a chunk holds a real edge
//     exactly when its first slot is real; pad slots carry local_dst 0.
// A node's edges may still span several chunks: one per src block for a
// graph over 128 nodes, or two when a run crosses a chunk boundary.  Every
// reduction therefore runs over all chunks of the block.
//
// Bound: bytes.  At the shape chip_smoke.py times (a batch of 128 HIV
// graphs: E = 11,008 padded edges of which 6,676 real, C = 86 chunks,
// N = 4,096, F = 70; the train loader's pads are e_pad 8,832, n_pad 4,096)
// the forward reads the real edges' values once and writes the two [N, F]
// outputs (4.2 MB, 1.26 us at 3.35 TB/s); the backward also reads both
// outputs and both cotangents and writes [E, F] (9.6 MB, 2.86 us).  There
// are 2 compares per edge and feature, far below the compute bound.  With
// only a few kilobytes per block the kernels are bound by memory latency,
// so the design counts dependent round trips to memory.
//
// Design.  One thread block owns one (dst block, 16-feature tile): F = 70
// gives 32 x 5 = 160 blocks for 132 SMs, and each edge row of a tile is 64
// contiguous bytes, read by half a warp.  Thread t holds feature t % 16 of
// the node slots t / 16 + 16 k (k < 8) in registers.
//   1. Chunk range, one round trip: all threads read edge_chunk_dst and the
//      first edge_mask byte of every chunk in one strided pass; warp sums and
//      one barrier give the block's first chunk and one past its last chunk
//      that holds a real edge.  All-pad chunks are never staged.
//   2. Groups of up to kGroup chunks, two round trips each.  Round 1 loads
//      edge_mask and local_dst of every chunk of the group together and
//      builds each chunk's run table (slot -> [start, end) of its real
//      edges) and a real-edge flag in shared memory.  Round 2 copies the
//      real rows of every flagged chunk's value tile into shared memory with
//      cp.async, all in flight together.  Then each thread walks the runs of
//      its slots; runs that span chunks or groups combine in registers.
//   3. Backward, one read of ge: mx, mn, dmx and dmn of the block's nodes
//      are loaded before step 1, ties are counted from the staged tiles,
//      the per-node planes (mx, mn, dmx / cnt, dmn / cnt) go to shared
//      memory, and d_ge is written from the same staged tiles.  Only a
//      block with more than kGroup chunks stages its groups again to write.
//      A node block writes d_ge only for its chunks that hold a real edge;
//      extra blocks at the end of the grid split all chunks among
//      themselves, check each chunk's first edge_mask byte and write zeros
//      over every chunk without a real edge, so the trailing pad chunks are
//      not left to the last node block.
// No atomics on values, so the result is deterministic.  Equality compares
// the very f32 values the forward wrote (no fast-math; +0.0 == -0.0, as in
// XLA).  The dynamic shared-memory attribute is set once per device.
//
// Interface: plain C, loaded with ctypes (dgn_tpu_torch/ops/extremes.py).
// The launches go on the caller's stream; each function returns
// cudaGetLastError() so that a refused launch is reported.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kTile = 128;                     // nodes per block, edges per chunk
constexpr int kFeat = 16;                      // features per thread block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = kThreads / kFeat;        // node slots / edge rows a pass (16)
constexpr int kSlots = kTile / kRows;          // node slots per thread (8)
constexpr int kGroup = 8;                      // chunks staged together
constexpr int kGroupEdges = kGroup * kTile;
constexpr int kPlane = kTile * kFeat;          // one [128, 16] f32 tile
constexpr int kPadChunks = 8;                  // chunks checked per padding block
constexpr uint8_t kPadSlot = 0xff;             // dst of a pad edge in the group
constexpr int kFwdSmemBytes =
    kGroup * kPlane * static_cast<int>(sizeof(float));
// backward: the group's tiles, then mx, mn, dmx / cnt, dmn / cnt
constexpr int kBwdSmemBytes =
    (kGroup + 4) * kPlane * static_cast<int>(sizeof(float));

// The run tables of one group of chunks, slot-major per chunk.
struct alignas(16) GroupIndex {
  uint8_t dst[kGroupEdges];        // local dst of each edge, kPadSlot if pad
  uint8_t run_start[kGroupEdges];  // [chunk][slot] -> first real edge
  uint8_t run_end[kGroupEdges];    // [chunk][slot] -> one past its last
  int real[kGroup];                // the chunk holds a real edge
};

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

struct ChunkRange {
  int first;  // first chunk of the dst block
  int end;    // one past its last chunk that holds a real edge
};

// The chunk range of dst block b, in one pass over the chunks.  Every thread
// of the block gets the same.
__device__ ChunkRange block_chunks(const int32_t* __restrict__ chunk_dst,
                                   const uint8_t* __restrict__ edge_mask,
                                   int n_chunks, int b) {
  __shared__ int part[2][kWarps];
  const int tid = threadIdx.x;
  int below = 0, end = 0;
#pragma unroll 4
  for (int c = tid; c < n_chunks; c += kThreads) {
    const int d = chunk_dst[c];
    const bool real = edge_mask[static_cast<size_t>(c) * kTile] != 0;
    below += d < b;
    if (d == b && real) end = c + 1;
  }
  below = __reduce_add_sync(0xffffffffu, below);
  end = __reduce_max_sync(0xffffffffu, end);
  if ((tid & 31) == 0) {
    part[0][tid >> 5] = below;
    part[1][tid >> 5] = end;
  }
  __syncthreads();
  int first = 0;
  end = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    first += part[0][w];
    end = max(end, part[1][w]);
  }
  return {first, max(first, end)};
}

// Stages chunks [c0, c0 + nj) (nj <= kGroup): their run tables and flags in
// idx, and vals[(j * 128 + i) * 16 + lane] = ge[(c0 + j) * 128 + i, f] for
// the real rows i of every chunk j that holds a real edge (0 where f is past
// n_feat; pad rows are left as they were).  Two round trips; starts with a
// barrier, so the previous group may be read until the call, and ends with
// one.
__device__ void stage_group(const float* __restrict__ ge,
                            const int32_t* __restrict__ local_dst,
                            const uint8_t* __restrict__ edge_mask, int c0,
                            int nj, int n_feat, int f, float* vals,
                            GroupIndex& idx) {
  constexpr int kPer = kGroupEdges / kThreads;
  const int tid = threadIdx.x;
  const size_t base = static_cast<size_t>(c0) * kTile;
  // round 1: masks and local dsts of the whole group
  uint8_t mine[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int g = tid + q * kThreads;
    mine[q] = kPadSlot;
    if (g < nj * kTile) {  // both loads issued together
      const bool real = edge_mask[base + g] != 0;
      const int v = local_dst[base + g];
      if (real) mine[q] = static_cast<uint8_t>(v);
    }
  }
  __syncthreads();  // every thread is done with the previous group
  uint32_t* starts = reinterpret_cast<uint32_t*>(idx.run_start);
  uint32_t* ends = reinterpret_cast<uint32_t*>(idx.run_end);
  for (int w = tid; w < kGroupEdges / 4; w += kThreads) {
    starts[w] = 0;
    ends[w] = 0;
  }
#pragma unroll
  for (int q = 0; q < kPer; ++q) idx.dst[tid + q * kThreads] = mine[q];
  __syncthreads();
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int g = tid + q * kThreads;
    const int i = g % kTile;
    const int v = mine[q];
    if (v != kPadSlot) {
      const int slot = g - i + v;
      if (i == 0 || idx.dst[g - 1] != v) idx.run_start[slot] = i;
      if (i == kTile - 1 || idx.dst[g + 1] != v) idx.run_end[slot] = i + 1;
    }
    if (i == 0) idx.real[g / kTile] = v != kPadSlot;
  }
  __syncthreads();
  // round 2: the real rows of every chunk with a real edge, all in flight
  const int lane = tid % kFeat;
  const int row = tid / kFeat;
  for (int j = 0; j < nj; ++j) {
    if (!idx.real[j]) continue;
    const float* src = ge + (base + j * kTile) * n_feat + f;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int i = row + s * kRows;
      if (idx.dst[j * kTile + i] == kPadSlot) continue;
      float* dst = vals + (j * kTile + i) * kFeat + lane;
      if (f < n_feat) {
        cp_async4(dst, src + static_cast<size_t>(i) * n_feat);
      } else {
        *dst = 0.f;
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 2)
extremes_fwd_kernel(const float* __restrict__ ge,            // [E, F]
                    const int32_t* __restrict__ local_dst,   // [E]
                    const int32_t* __restrict__ chunk_dst,   // [C]
                    const uint8_t* __restrict__ edge_mask,   // [E]
                    float* __restrict__ mx,                  // [num_nodes, F]
                    float* __restrict__ mn,                  // [num_nodes, F]
                    int n_feat, int n_chunks, int num_nodes) {
  extern __shared__ float vals[];  // [kGroup][128][16]
  __shared__ GroupIndex idx;
  const int b = blockIdx.x;
  const int lane = threadIdx.x % kFeat;
  const int row = threadIdx.x / kFeat;
  const int f = blockIdx.y * kFeat + lane;
  const ChunkRange r = block_chunks(chunk_dst, edge_mask, n_chunks, b);

  float vmax[kSlots], vmin[kSlots];
  unsigned seen = 0;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    vmax[k] = -CUDART_INF_F;
    vmin[k] = CUDART_INF_F;
  }
  for (int c0 = r.first; c0 < r.end; c0 += kGroup) {
    const int nj = min(kGroup, r.end - c0);
    stage_group(ge, local_dst, edge_mask, c0, nj, n_feat, f, vals, idx);
    for (int j = 0; j < nj; ++j) {
      if (!idx.real[j]) continue;
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        const int v = j * kTile + row + k * kRows;
        const int s = idx.run_start[v], t = idx.run_end[v];
        for (int e = s; e < t; ++e) {
          const float x = vals[(j * kTile + e) * kFeat + lane];
          vmax[k] = fmaxf(vmax[k], x);
          vmin[k] = fminf(vmin[k], x);
        }
        if (s < t) seen |= 1u << k;
      }
    }
  }
  if (f >= n_feat) return;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int node = b * kTile + row + k * kRows;
    if (node < num_nodes) {
      const size_t o = static_cast<size_t>(node) * n_feat + f;
      const bool has = (seen >> k) & 1u;
      mx[o] = has ? vmax[k] : 0.f;
      mn[o] = has ? vmin[k] : 0.f;
    }
  }
}

// Zeros d_ge over every chunk without a real edge: padding block p of
// n_pad checks the chunks p, p + n_pad, ... (kPadChunks of them, one load
// each) and writes each such chunk's 128 rows whole with 16-byte stores.
__device__ void zero_pad_chunks(const uint8_t* __restrict__ edge_mask,
                                float* __restrict__ d_ge, int n_feat,
                                int n_chunks, int n_blocks) {
  __shared__ int pad[kPadChunks];
  const int n_pad = (gridDim.x - n_blocks) * gridDim.y;
  const int p = (blockIdx.x - n_blocks) * gridDim.y + blockIdx.y;
  const int tid = threadIdx.x;
  if (tid < kPadChunks) {
    const int c = p + tid * n_pad;
    pad[tid] = c < n_chunks && !edge_mask[static_cast<size_t>(c) * kTile];
  }
  __syncthreads();
  // a chunk of d_ge is 128 * F floats, 512-byte aligned in an allocation
  const int n_vec = kTile * n_feat / 4;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int q = 0; q < kPadChunks; ++q) {
    if (!pad[q]) continue;
    float4* out = reinterpret_cast<float4*>(
        d_ge + static_cast<size_t>(p + q * n_pad) * kTile * n_feat);
    for (int w = tid; w < n_vec; w += kThreads) out[w] = zero;
  }
}

// Writes d_ge for the staged chunks [c0, c0 + nj) of dst block b that hold
// a real edge, from the staged tiles and the per-node planes.
__device__ void write_group(const float* vals, const GroupIndex& idx,
                            const float* planes, float* __restrict__ d_ge,
                            int c0, int nj, int b, int n_feat, int f,
                            int num_nodes) {
  const int lane = threadIdx.x % kFeat;
  const int row = threadIdx.x / kFeat;
  const float* max_s = planes;
  const float* min_s = planes + kPlane;
  const float* gmax_s = planes + 2 * kPlane;
  const float* gmin_s = planes + 3 * kPlane;
  if (f >= n_feat) return;
  for (int j = 0; j < nj; ++j) {
    if (!idx.real[j]) continue;
    float* out = d_ge + static_cast<size_t>(c0 + j) * kTile * n_feat + f;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int i = row + s * kRows;
      const int v = idx.dst[j * kTile + i];
      float g = 0.f;
      if (v != kPadSlot && b * kTile + v < num_nodes) {
        const float x = vals[(j * kTile + i) * kFeat + lane];
        if (x == max_s[v * kFeat + lane]) g += gmax_s[v * kFeat + lane];
        if (x == min_s[v * kFeat + lane]) g += gmin_s[v * kFeat + lane];
      }
      out[static_cast<size_t>(i) * n_feat] = g;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
extremes_bwd_kernel(const float* __restrict__ ge,            // [E, F]
                    const float* __restrict__ mx,            // [num_nodes, F]
                    const float* __restrict__ mn,
                    const float* __restrict__ dmx,           // [num_nodes, F]
                    const float* __restrict__ dmn,
                    const int32_t* __restrict__ local_dst,   // [E]
                    const int32_t* __restrict__ chunk_dst,   // [C]
                    const uint8_t* __restrict__ edge_mask,   // [E]
                    float* __restrict__ d_ge,                // [E, F]
                    int n_feat, int n_chunks, int n_blocks, int num_nodes) {
  if (static_cast<int>(blockIdx.x) >= n_blocks) {
    zero_pad_chunks(edge_mask, d_ge, n_feat, n_chunks, n_blocks);
    return;
  }
  extern __shared__ float smem[];
  float* vals = smem;                      // [kGroup][128][16] staged values
  float* planes = smem + kGroup * kPlane;  // mx, mn, dmx / cnt, dmn / cnt
  __shared__ GroupIndex idx;
  const int b = blockIdx.x;
  const int lane = threadIdx.x % kFeat;
  const int row = threadIdx.x / kFeat;
  const int f = blockIdx.y * kFeat + lane;
  const bool active = f < n_feat;

  // the block's stored extremes and cotangents, in flight with the range
  float vmax[kSlots], vmin[kSlots], gmax[kSlots], gmin[kSlots];
  int cmax[kSlots], cmin[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int node = b * kTile + row + k * kRows;
    const bool ok = active && node < num_nodes;
    const size_t o = static_cast<size_t>(node) * n_feat + f;
    vmax[k] = ok ? mx[o] : 0.f;
    vmin[k] = ok ? mn[o] : 0.f;
    gmax[k] = ok ? dmx[o] : 0.f;
    gmin[k] = ok ? dmn[o] : 0.f;
    cmax[k] = 0;
    cmin[k] = 0;
  }
  const ChunkRange r = block_chunks(chunk_dst, edge_mask, n_chunks, b);

  // count the real edges tied with each stored extreme
  for (int c0 = r.first; c0 < r.end; c0 += kGroup) {
    const int nj = min(kGroup, r.end - c0);
    stage_group(ge, local_dst, edge_mask, c0, nj, n_feat, f, vals, idx);
    for (int j = 0; j < nj; ++j) {
      if (!idx.real[j]) continue;
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        const int v = j * kTile + row + k * kRows;
        for (int e = idx.run_start[v]; e < idx.run_end[v]; ++e) {
          const float x = vals[(j * kTile + e) * kFeat + lane];
          cmax[k] += x == vmax[k];
          cmin[k] += x == vmin[k];
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int v = (row + k * kRows) * kFeat + lane;
    planes[v] = vmax[k];
    planes[kPlane + v] = vmin[k];
    planes[2 * kPlane + v] =
        gmax[k] / static_cast<float>(cmax[k] > 1 ? cmax[k] : 1);
    planes[3 * kPlane + v] =
        gmin[k] / static_cast<float>(cmin[k] > 1 ? cmin[k] : 1);
  }

  // write d_ge: from the staged tiles when one group held every chunk
  if (r.end - r.first <= kGroup) {
    __syncthreads();  // the planes are complete
    write_group(vals, idx, planes, d_ge, r.first, r.end - r.first, b, n_feat,
                f, num_nodes);
    return;
  }
  for (int c0 = r.first; c0 < r.end; c0 += kGroup) {
    const int nj = min(kGroup, r.end - c0);
    stage_group(ge, local_dst, edge_mask, c0, nj, n_feat, f, vals, idx);
    write_group(vals, idx, planes, d_ge, c0, nj, b, n_feat, f, num_nodes);
  }
}

// Raises the kernels' dynamic shared-memory limits, once per device.
cudaError_t allow_smem() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (bit & done.load()) return cudaSuccess;
  err = cudaFuncSetAttribute(extremes_fwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kFwdSmemBytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(extremes_bwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kBwdSmemBytes);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

int feature_tiles(int n_feat) { return (n_feat + kFeat - 1) / kFeat; }

// Padding blocks of the backward: enough that each checks kPadChunks chunks.
int pad_blocks(int n_feat, int n_chunks) {
  const int tiles = feature_tiles(n_feat);
  const int needed = (n_chunks + kPadChunks - 1) / kPadChunks;
  return (needed + tiles - 1) / tiles;
}

}  // namespace

extern "C" int dgn_segment_extremes_fwd(
    const void* ge, const void* local_dst, const void* chunk_dst,
    const void* edge_mask, void* mx, void* mn, int n_feat, int n_chunks,
    int n_blocks, int num_nodes, void* stream) {
  const cudaError_t err = allow_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_blocks, feature_tiles(n_feat));
  extremes_fwd_kernel<<<grid, kThreads, kFwdSmemBytes,
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
  const cudaError_t err = allow_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_blocks + pad_blocks(n_feat, n_chunks),
                  feature_tiles(n_feat));
  extremes_bwd_kernel<<<grid, kThreads, kBwdSmemBytes,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ge), static_cast<const float*>(mx),
      static_cast<const float*>(mn), static_cast<const float*>(dmx),
      static_cast<const float*>(dmn), static_cast<const int32_t*>(local_dst),
      static_cast<const int32_t*>(chunk_dst),
      static_cast<const uint8_t*>(edge_mask), static_cast<float*>(d_ge),
      n_feat, n_chunks, n_blocks, num_nodes);
  return static_cast<int>(cudaGetLastError());
}

// The launch shapes for n_feat, n_chunks and n_blocks: out[0..2] the
// forward's grid x, grid y and dynamic shared bytes, out[3..5] the
// backward's.
extern "C" void dgn_segment_extremes_launch_shape(int n_feat, int n_chunks,
                                                  int n_blocks, int* out) {
  out[0] = n_blocks;
  out[1] = feature_tiles(n_feat);
  out[2] = kFwdSmemBytes;
  out[3] = n_blocks + pad_blocks(n_feat, n_chunks);
  out[4] = feature_tiles(n_feat);
  out[5] = kBwdSmemBytes;
}

extern "C" const char* dgn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
