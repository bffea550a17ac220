// Per-item span and row gathers for the mapper's DP setup.
//
// Replaces the two Pallas DMA gathers of blasr_tpu/ops/dma_gather.py:
//   gather_spans_launch <- gather_spans (pallas_call at dma_gather.py:117):
//       out[i, j] = src[clip(starts[i] + j, 0, N - 1)], the genome window
//       words of each DP item (nibble-packed genome, 8 codes per int32).
//   gather_rows_launch  <- gather_rows  (pallas_call at dma_gather.py:194):
//       out[i, :] = src[clip(rows[i], 0, R - 1), :], the packed query rows
//       and the fused anchor rows of each DP item.
//
// Bound on the H100: each call moves a few hundred KB (512 items of 128-482
// words), 0.2-0.6 us at 3.35 TB/s. That is below what one launch of this
// kernel costs the device with no work at all (1.4 us, one item of one
// word, tools/gather_kernel_times.py), so a launch, then two dependent DRAM
// round trips (the item's start or row, then its words), bound it; on the
// host the wrapper's launch path costs more again (see ops/gather.py). The
// TPU kernels issued one DMA per item because XLA's TPU gathers paid per
// element. Here the design keeps the device's share near that floor: one
// warp per item and four items per block, every load of a warp issued
// before its first store (kWordUnroll words or kUnroll int4 chunks per lane
// in flight, so a span or row takes one DRAM round trip after its start or
// row index), and no per-element work where none is needed:
//   - gather_spans splits the items in the kernel: an interior item
//     (0 <= start and start + span <= N) copies without a clip; an edge item
//     keeps the per-element clip, which is part of the result (a window
//     beyond the array reads the edge words, never a shifted window). Its
//     copies are 4-byte: the starts are arbitrary word offsets and an
//     output row of 162 words is not 16-byte aligned, and an int4 path that
//     realigned through warp shuffles (each lane's aligned source chunk
//     funnelled with its neighbour's) measured slower on the device than
//     this copy at the main path's spans (CUDA-graph replay on an H100,
//     PERF.md). Indexing into src is 64-bit (a human genome packs to
//     ~375 M words).
//   - gather_rows clips the row once per warp (lane 0, broadcast by a
//     shuffle). Its int4 instance runs when the row length is a multiple of
//     4 words and both base pointers are 16-byte aligned (the wrapper
//     decides from data_ptr() and the row length); a scalar instance of
//     the same kernel takes the rest.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kItemsPerBlock = 4;  // one warp per item
constexpr int kUnroll = 4;         // int4 chunks per lane loaded before the first store
constexpr int kWordUnroll = 8;     // words per lane loaded before the first store

// out[j] = src[at(j)] for j < n by one warp: each lane loads kWordUnroll
// words before it stores any, so up to 256 words take one DRAM round trip
// (16 words per lane measured slower at span 162, PERF.md).
template <typename At>
__device__ __forceinline__ void copy_words(const int32_t* __restrict__ src, At at,
                                           int32_t* __restrict__ out, int n, int lane) {
  for (int base = 0; base < n; base += kWarp * kWordUnroll) {
    int32_t v[kWordUnroll];
#pragma unroll
    for (int u = 0; u < kWordUnroll; ++u) {
      const int j = base + u * kWarp + lane;
      v[u] = j < n ? src[at(j)] : 0;
    }
#pragma unroll
    for (int u = 0; u < kWordUnroll; ++u) {
      const int j = base + u * kWarp + lane;
      if (j < n) out[j] = v[u];
    }
  }
}

__global__ void gather_spans_kernel(const int32_t* __restrict__ src, long long n,
                                    const int32_t* __restrict__ starts,
                                    int32_t* __restrict__ out, int n_items, int span) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int i = blockIdx.x * kItemsPerBlock + (threadIdx.x >> 5);
  if (i >= n_items) return;
  const long long s0 = starts[i];
  int32_t* row = out + static_cast<size_t>(i) * span;
  if (s0 >= 0 && s0 + span <= n) {  // interior item: no clip
    copy_words(src, [=](int j) { return s0 + j; }, row, span, lane);
  } else {  // edge item: clip every element index
    copy_words(src, [=](int j) {
      const long long p = s0 + j;
      return p < 0 ? 0 : (p > n - 1 ? n - 1 : p);
    }, row, span, lane);
  }
}

template <bool kVec>
__global__ void gather_rows_kernel(const int32_t* __restrict__ src, int n_rows, int row_len,
                                   const int32_t* __restrict__ rows,
                                   int32_t* __restrict__ out, int n_items) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int i = blockIdx.x * kItemsPerBlock + (threadIdx.x >> 5);
  if (i >= n_items) return;
  int r = 0;
  if (lane == 0) {
    r = rows[i];
    r = r < 0 ? 0 : (r > n_rows - 1 ? n_rows - 1 : r);
  }
  r = __shfl_sync(0xffffffffu, r, 0);
  const size_t in0 = static_cast<size_t>(r) * row_len;
  const size_t out0 = static_cast<size_t>(i) * row_len;
  if (kVec) {
    const int4* __restrict__ s4 = reinterpret_cast<const int4*>(src + in0);
    int4* __restrict__ o4 = reinterpret_cast<int4*>(out + out0);
    const int n_chunks = row_len >> 2;
    for (int base = 0; base < n_chunks; base += kWarp * kUnroll) {
      int4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = base + u * kWarp + lane;
        if (k < n_chunks) v[u] = s4[k];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = base + u * kWarp + lane;
        if (k < n_chunks) o4[k] = v[u];
      }
    }
  } else {
    copy_words(src + in0, [](int j) { return j; }, out + out0, row_len, lane);
  }
}

int n_blocks(int n_items) { return (n_items + kItemsPerBlock - 1) / kItemsPerBlock; }

}  // namespace

extern "C" int gather_spans_launch(const void* src, long long n, const void* starts,
                                   void* out, int n_items, int span, void* stream) {
  if (n_items <= 0) return 0;
  if (span <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  gather_spans_kernel<<<n_blocks(n_items), kWarp * kItemsPerBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(src), n, static_cast<const int32_t*>(starts),
      static_cast<int32_t*>(out), n_items, span);
  return static_cast<int>(cudaGetLastError());
}

// vec is 4 for the int4 instance (row_len % 4 == 0, src and out 16-byte
// aligned), 1 for the scalar one.
extern "C" int gather_rows_launch(const void* src, int n_rows, int row_len, const void* rows,
                                  void* out, int n_items, int vec, void* stream) {
  if (n_items <= 0 || row_len <= 0) return 0;
  if (n_rows <= 0 || (vec != 1 && vec != 4) || (vec == 4 && row_len % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<const int32_t*>(src);
  const auto r = static_cast<const int32_t*>(rows);
  const auto o = static_cast<int32_t*>(out);
  const auto cs = static_cast<cudaStream_t>(stream);
  if (vec == 4)
    gather_rows_kernel<true><<<n_blocks(n_items), kWarp * kItemsPerBlock, 0, cs>>>(
        s, n_rows, row_len, r, o, n_items);
  else
    gather_rows_kernel<false><<<n_blocks(n_items), kWarp * kItemsPerBlock, 0, cs>>>(
        s, n_rows, row_len, r, o, n_items);
  return static_cast<int>(cudaGetLastError());
}
