// Weighted adjacency blocks of the block layout, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel dgn_tpu/ops/pallas/adjacency.py:83
// (build_pair_adjacency): [K, E] per-family f32 edge weights become
// [P, K, 128, 128] blocks, f32, bf16 or f16, with W[p, k, i, j] = sum of w[k, e]
// over the edges e of pair p whose local_src is i and local_dst is j.  Pad
// edges carry weight 0; pad pairs come out as zeros.
//
// Bound: bytes, and almost all of them the output.  At the ZINC batch
// (P=64, K=3) the kernel writes 12.6 MB in f32 (6.3 MB in bf16 or f16) and
// reads about 0.2 MB, so it cannot take less than 3.8 us (1.9 us) at the
// H100 SXM's 3.35 TB/s.  Every output byte is written once, coalesced, in
// 16-byte stores.
//
// The first design (one CTA per (pair, family) block, 64 KB of shared
// memory) ran at 53 % of that bound in f32 and 40 % in bf16 at the ZINC
// batch.  What held it back, and what this design does about each:
// 1. A serial front of about 3 us before a CTA's first store: zero 64 KB of
//    shared memory, two binary searches over pair_sorted_ids (7-11
//    dependent loads), a barrier, a dependent load chain per edge slot, a
//    barrier.  Here the host gives each pair's chunk range as a row pointer
//    (pair_chunk_start) into pair_real_chunk_order, so a CTA's first load
//    tells it its range; each thread then loads one chunk id and issues
//    16-byte loads of 4 edges' local_src, local_dst and weights before the
//    accumulator is zeroed, so a chunk costs one round trip, not one per
//    slot.
// 2. All-pad chunks (23 at the ZINC batch, all in the pair the packer parks
//    pad edges in) were walked slot by slot to add zeros.  The host lists
//    them after the real ones, outside every pair's range: skipping them is
//    exact because pad edges weigh 0 (an all-pad chunk has no real edge).
// 3. Pad pairs (38 of 64 at ZINC, 473 of 960 at CIFAR10) ran the whole
//    chain to write zeros.  An empty range writes zeros from registers: no
//    shared memory and no barrier.
// 4. 64 KB per CTA allowed 3 CTAs per SM, and 192 CTAs at ZINC left little
//    to hide item 1.  Here a CTA owns a slab of kRows = 32 rows (local_src)
//    of one (pair, family) block: a 16 KB f32 accumulator, 256 threads, up
//    to 8 CTAs per SM, 768 CTAs at ZINC, numbered in output order.  Each
//    of a pair's 4 * K CTAs reads the pair's real chunks (0.2 MB at ZINC,
//    3.8 MB at CIFAR10, again from L2) and keeps the edges of its slab.
//    The family axis stays in the grid because K depends on the data.
// 5. cudaFuncSetAttribute ran on every launch.  16 KB of static shared
//    memory needs none.
// Slabs of 16 or 64 rows, 128 threads, a persistent grid-stride loop, and
// a grid that alternates covered and pad pairs were each no faster at both
// ZINC entries and the CIFAR10 f32 entry, in turns on one H100
// (adjacency_ab.py).  The write path alone runs at the card's zero_() rate;
// what is left over it at CIFAR10 is the covered CTAs' dependent loads.
//
// Precision.  Accumulation is f32 in shared memory (atomicAdd).  For simple
// graphs each (pair, i, j) cell receives at most one edge, so the result is
// exact.  With multigraph edges the order of the f32 additions into one cell
// depends on the atomics' timing and varies from run to run.  bf16 and f16
// output round each f32 sum once, to nearest even (__floats2bfloat162_rn,
// __floats2half2_rn); f16 overflows to inf past 65504, as a cast does.
//
// Interface: plain C, loaded with ctypes (dgn_tpu_torch/ops/adjacency.py),
// which checks shapes, types, devices and 16-byte alignment; out_kind picks
// the output dtype (0 f32, 1 bf16, 2 f16).  The launch
// goes on the caller's stream; the function returns cudaGetLastError() so
// a refused launch is reported.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;
constexpr int kRows = 32;                      // local_src rows per CTA
constexpr int kSlabs = kTile / kRows;
constexpr int kThreads = 256;
constexpr int kSlabCells = kRows * kTile;      // 4096 f32 = 16 KB
constexpr int kEdgesPerThread = 4;             // one 16-byte load per array
constexpr int kChunksPerPass = kThreads * kEdgesPerThread / kTile;  // 8

// Two cells rounded to nearest even into one 32-bit word of a 16-bit type.
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16, float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack2(__half, float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 16 bytes of output from the accumulator: 8 cells of a 16-bit type (bf16,
// f16), or 4 f32 cells.
template <typename OutT>
struct Out {
  static constexpr int kCells = 8;
  __device__ static uint4 pack(const float* acc) {
    const float4 a = reinterpret_cast<const float4*>(acc)[0];
    const float4 b = reinterpret_cast<const float4*>(acc)[1];
    const OutT t{};
    return make_uint4(pack2(t, a.x, a.y), pack2(t, a.z, a.w),
                      pack2(t, b.x, b.y), pack2(t, b.z, b.w));
  }
};

template <>
struct Out<float> {
  static constexpr int kCells = 4;
  __device__ static uint4 pack(const float* acc) {
    return *reinterpret_cast<const uint4*>(acc);
  }
};

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
pair_adjacency_kernel(const float* __restrict__ weights,             // [K, E]
                      const int32_t* __restrict__ local_src,         // [E]
                      const int32_t* __restrict__ local_dst,         // [E]
                      const int32_t* __restrict__ real_chunk_order,  // [C]
                      const int32_t* __restrict__ chunk_start,       // [P+1]
                      OutT* __restrict__ out,                   // [P,K,T,T]
                      int n_fam, int n_edges) {
  __shared__ float4 acc4[kSlabCells / 4];
  constexpr int kUnits = kSlabCells / Out<OutT>::kCells;  // 16-byte stores
  constexpr int kUnitsPerThread = kUnits / kThreads;

  // blockIdx.x = (p * K + k) * kSlabs + slab: CTAs in output order
  const int slab = blockIdx.x % kSlabs;
  const int pk = blockIdx.x / kSlabs;
  const int k = pk % n_fam;
  const int p = pk / n_fam;
  const int tid = threadIdx.x;
  uint4* dst = reinterpret_cast<uint4*>(
      out + static_cast<size_t>(blockIdx.x) * kSlabCells);

  const int first = __ldg(chunk_start + p);
  const int n_chunks = __ldg(chunk_start + p + 1) - first;
  if (n_chunks == 0) {  // pad pair, or only all-pad chunks: zeros
#pragma unroll
    for (int u = 0; u < kUnitsPerThread; ++u) {
      dst[tid + u * kThreads] = make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }

  const float* w_k = weights + static_cast<size_t>(k) * n_edges;
  const int slot = tid / (kTile / kEdgesPerThread);  // chunk of the pass
  const int lane4 = (tid % (kTile / kEdgesPerThread)) * kEdgesPerThread;
  bool hit = false;
  for (int pass = 0; pass < n_chunks; pass += kChunksPerPass) {
    // all of this pass's loads in flight before any shared-memory work
    int4 src4 = make_int4(0, 0, 0, 0), dst4 = src4;
    float4 w4 = make_float4(0.f, 0.f, 0.f, 0.f);
    if (pass + slot < n_chunks) {
      const int e = __ldg(real_chunk_order + first + pass + slot) * kTile
                    + lane4;
      src4 = __ldg(reinterpret_cast<const int4*>(local_src + e));
      dst4 = __ldg(reinterpret_cast<const int4*>(local_dst + e));
      w4 = __ldg(reinterpret_cast<const float4*>(w_k + e));
    }
    if (pass == 0) {
#pragma unroll
      for (int i = tid; i < kSlabCells / 4; i += kThreads) {
        acc4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      __syncthreads();
    }
    const int srcs[4] = {src4.x, src4.y, src4.z, src4.w};
    const int dsts[4] = {dst4.x, dst4.y, dst4.z, dst4.w};
    const float ws[4] = {w4.x, w4.y, w4.z, w4.w};
    float* acc = reinterpret_cast<float*>(acc4);
#pragma unroll
    for (int j = 0; j < kEdgesPerThread; ++j) {
      if (ws[j] != 0.f && srcs[j] / kRows == slab) {
        atomicAdd(&acc[(srcs[j] % kRows) * kTile + dsts[j]], ws[j]);
        hit = true;
      }
    }
  }
  // a slab that no edge reached writes zeros without reading shared memory
  const bool any = __syncthreads_or(hit);
#pragma unroll
  for (int u = 0; u < kUnitsPerThread; ++u) {
    const int unit = tid + u * kThreads;
    dst[unit] = any ? Out<OutT>::pack(reinterpret_cast<const float*>(acc4)
                                      + unit * Out<OutT>::kCells)
                    : make_uint4(0u, 0u, 0u, 0u);
  }
}

template <typename OutT>
int launch(const void* weights, const void* local_src, const void* local_dst,
           const void* real_chunk_order, const void* chunk_start, void* out,
           int n_fam, int n_edges, int n_pairs, cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>(n_pairs) * n_fam * kSlabs;
  pair_adjacency_kernel<OutT><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(weights),
      static_cast<const int32_t*>(local_src),
      static_cast<const int32_t*>(local_dst),
      static_cast<const int32_t*>(real_chunk_order),
      static_cast<const int32_t*>(chunk_start), static_cast<OutT*>(out),
      n_fam, n_edges);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dgn_build_pair_adjacency(
    const void* weights, const void* local_src, const void* local_dst,
    const void* pair_real_chunk_order, const void* pair_chunk_start,
    void* out, int n_fam, int n_edges, int n_pairs, int out_kind,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (out_kind) {
    case 0:
      return launch<float>(weights, local_src, local_dst,
                           pair_real_chunk_order, pair_chunk_start, out,
                           n_fam, n_edges, n_pairs, s);
    case 1:
      return launch<__nv_bfloat16>(weights, local_src, local_dst,
                                   pair_real_chunk_order, pair_chunk_start,
                                   out, n_fam, n_edges, n_pairs, s);
    case 2:
      return launch<__half>(weights, local_src, local_dst,
                            pair_real_chunk_order, pair_chunk_start, out,
                            n_fam, n_edges, n_pairs, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The launch at these sizes: out[0] grid (1-D), out[1] threads per CTA,
// out[2] shared bytes per CTA (static; a pad pair's CTAs touch none).
extern "C" void dgn_pair_adjacency_launch_shape(int n_fam, int n_pairs,
                                                int* out) {
  out[0] = n_pairs * n_fam * kSlabs;
  out[1] = kThreads;
  out[2] = kSlabCells * static_cast<int>(sizeof(float));
}

extern "C" const char* dgn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
