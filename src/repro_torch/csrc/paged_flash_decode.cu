// paged_flash_decode: one-token GQA decode attention through a block
// table, split across blocks by key range ("flash-decoding").
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/paged_flash_decode.py:paged_flash_decode (reached
// from gqa_paged_step's decode path through ops.paged_decode_attention).
//
// What bounds it on an H100: bytes, the K/V rows of the pages a lane
// owns (INT8 rows plus one f16 scale per row and kv head), which every
// query head of the group reuses.  At qpk = 8 the f32 products come
// close too (16 FMA-flops per INT8 byte), so overhead instructions count.
// The design (split_decode.cuh):
//   * grid (b * g, n_split, z): each block folds `chunk` keys of one
//     (lane, kv head) for up to 8 of its query heads (z = 2 at qwen3-moe's
//     16 heads per kv head: each block reads the split's K/V rows, the
//     second from L2), a whole number of pages; n_split and chunk come
//     from the
//     host's shape-only plan (kernels/split_decode.py), so the wrapper
//     never reads `lengths` and the launch can be captured in a graph.  A
//     block whose keys lie past the lane's length, or before its sliding
//     window, writes an empty partial and returns;
//   * K/V rows arrive as 16-byte cp.async chunks, double-buffered per
//     warp; the page id of a row is read once, by the lane that owns the
//     row, and each scale once per row: k's scale multiplies the score,
//     v's folds into p, and each int8 element is converted once;
//   * the softmax state stays in registers per warp, merged across warps
//     at the end of the split and across splits by the merge kernel, in a
//     fixed order (bitwise repeatable).
// A lane with length 0 gets the mean of V over all max_pages pages of its
// table, dequantized, as the TPU kernel and the plain version give.
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "split_decode.cuh"

namespace {

// Grid: (b * g, n_split, ceil(qpk / 8)): block z takes query heads
// [8 z, 8 z + 8) of its (lane, kv head).  q, out: (b, g, qpk, hd) f32;
// pools (n_pages,
// ps, g, hd); scales (n_pages, ps, g) f16 when QUANT; tables (b,
// max_pages) int32; lengths (b,) int32 including the current token.
// Launch bounds: at least 3 blocks an SM (up to 170 registers).  With no
// minimum ptxas held some instantiations at 80-128 registers and spilled
// (int8 hd 128 once the query-group axis came in); with 3 none spills.
template <typename T, int HD, bool QUANT>
__global__ void __launch_bounds__(split::THREADS, 3)
decode_kernel(const float* __restrict__ q, const T* __restrict__ kp,
              const T* __restrict__ vp, const __half* __restrict__ ks,
              const __half* __restrict__ vs, const int* __restrict__ tables,
              const int* __restrict__ lengths, float* __restrict__ out,
              float* __restrict__ part, int G, int QPK, int PS,
              int max_pages, int window, float cap, float scale, int chunk,
              int n_split) {
  const int row = blockIdx.x;
  const int b = row / G;
  const int gi = row - b * G;
  const int s = blockIdx.y;
  const int n_keys = max_pages * PS;
  const int len = lengths[b];
  const bool empty = len <= 0;        // sees no key: all keys, score 0
  const int hi = empty ? n_keys : min(len, n_keys);
  const int lo = (!empty && window > 0) ? max(0, len - window) : 0;
  const int* tab = tables + static_cast<size_t>(b) * max_pages;
  auto row_of = [=](int t) {
    const int pg = t / PS;
    return (static_cast<long long>(tab[pg]) * PS + (t - pg * PS)) * G + gi;
  };
  const int r0 = blockIdx.z * split::QMAX;     // this block's query heads
  const size_t head = (static_cast<size_t>(row) * QPK + r0) * HD;
  split::fold<T, HD, QUANT>(q + head, kp, vp, ks, vs, row_of,
                            max(s * chunk, lo), min((s + 1) * chunk, hi),
                            empty, min(split::QMAX, QPK - r0), scale, cap,
                            out + head, part, row, s, n_split, QPK, r0);
}

template <typename T, bool QUANT>
struct Run {
  template <int HD>
  struct At {
    static int run(const void* q, const void* kp, const void* vp,
                   const void* ks, const void* vs, const void* tables,
                   const void* lengths, void* out, void* part, int B, int G,
                   int QPK, int PS, int max_pages, int window, float cap,
                   float scale, int chunk, int n_split, cudaStream_t st) {
      return split::launch<T, HD>(
          decode_kernel<T, HD, QUANT>, B * G, n_split, QPK,
          static_cast<float*>(part), static_cast<float*>(out), st,
          static_cast<const float*>(q), static_cast<const T*>(kp),
          static_cast<const T*>(vp), static_cast<const __half*>(ks),
          static_cast<const __half*>(vs), static_cast<const int*>(tables),
          static_cast<const int*>(lengths), static_cast<float*>(out),
          static_cast<float*>(part), G, QPK, PS, max_pages, window, cap,
          scale, chunk, n_split);
    }
  };
};

}  // namespace

extern "C" {

const char* paged_flash_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// kv_kind: 0 = f32 pools, 1 = bf16 pools, 2 = int8 pools with f16 scales.
// part: scratch of b * g * n_split * qpk * (hd + 2) f32 (unused when
// n_split == 1).  qpk <= 16; hd in {16, 32, 64, 112, 128, 256}
// (`split::by_hd`).
int paged_flash_decode(const void* q, const void* kp, const void* vp,
                       const void* ks, const void* vs, const void* tables,
                       const void* lengths, void* out, void* part, int B,
                       int G, int QPK, int HD, int PS, int max_pages,
                       int chunk, int n_split, int kv_kind, int window,
                       float cap, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (QPK < 1 || QPK > split::QPK_MAX || n_split < 1 ||
      n_split > split::MAX_SPLITS)
    return cudaErrorInvalidValue;
  switch (kv_kind) {
    case 0:
      return split::by_hd<Run<float, false>::At>(
          HD, q, kp, vp, ks, vs, tables, lengths, out, part, B, G, QPK, PS,
          max_pages, window, cap, scale, chunk, n_split, st);
    case 1:
      return split::by_hd<Run<__nv_bfloat16, false>::At>(
          HD, q, kp, vp, ks, vs, tables, lengths, out, part, B, G, QPK, PS,
          max_pages, window, cap, scale, chunk, n_split, st);
    case 2:
      return split::by_hd<Run<int8_t, true>::At>(
          HD, q, kp, vp, ks, vs, tables, lengths, out, part, B, G, QPK, PS,
          max_pages, window, cap, scale, chunk, n_split, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
