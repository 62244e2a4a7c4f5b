// flash_decode: one-token decode attention over a contiguous K/V cache,
// split across blocks by key range ("flash-decoding").
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_decode.py:
// flash_decode (reached through ops.decode_attention).
//
// Semantics: q (bg, qpk, hd) f32, k/v (bg, S, hd) f32 or bf16; keys
// k_pos <= pos are visible (within `window` of pos when one is set).
// `pos` is read in the kernel from a device int32 when `pos_ptr` is not
// null, so a caller holding it on the card needs no host sync.  Any S is
// taken: the ragged edge is masked here.
//
// What bounds it on an H100: bytes, the K/V rows up to pos, which all qpk
// query rows of the group reuse.  The design is the paged kernel's
// (split_decode.cuh) without the table:
//   * grid (bg, n_split, z): each block folds `chunk` keys of one row for
//     up to 8 of its query heads (z = 2 at 16 heads per kv head), from a
//     shape-only host plan (kernels/split_decode.py), so a device `pos`
//     needs no sync and the launch can be captured in a graph; a block
//     whose keys lie past pos, or before the window, writes an empty
//     partial and returns;
//   * K/V rows arrive as 16-byte cp.async chunks, double-buffered per
//     warp; the softmax state stays in registers per warp, merged across
//     warps at the end of the split and across splits by the merge kernel
//     in a fixed order (bitwise repeatable).
// When no key is visible (pos < 0, or a window that starts past S) the
// result is the mean of V over all S keys, as the TPU kernel and the
// plain version give.
#include <cuda_runtime.h>

#include "split_decode.cuh"

namespace {

// Grid: (bg, n_split, ceil(qpk / 8)): block z takes query heads [8 z,
// 8 z + 8) of its row.  q, out: (bg, qpk, hd) f32; k, v: (bg, S, hd).
// Launch bounds: at least 3 blocks an SM (up to 170 registers).  With no
// minimum ptxas held some instantiations at 80-128 registers and spilled
// (int8 hd 128 once the query-group axis came in); with 3 none spills.
template <typename T, int HD>
__global__ void __launch_bounds__(split::THREADS, 3)
flash_decode_kernel(const float* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ pos_ptr,
                    int pos_val, float* __restrict__ out,
                    float* __restrict__ part, int S, int QPK, int window,
                    float cap, float scale, int chunk, int n_split) {
  const int row = blockIdx.x;
  const int s = blockIdx.y;
  const int pos = pos_ptr != nullptr ? *pos_ptr : pos_val;
  int hi = min(pos, S - 1) + 1;                 // visible keys: [lo, hi)
  int lo = window > 0 ? max(0, pos - window + 1) : 0;
  const bool empty = hi <= lo;                  // sees no key: all keys,
  if (empty) {                                  //   score 0
    lo = 0;
    hi = S;
  }
  const long long row0 = static_cast<long long>(row) * S;
  auto row_of = [=](int t) { return row0 + t; };
  const int r0 = blockIdx.z * split::QMAX;     // this block's query heads
  const size_t head = (static_cast<size_t>(row) * QPK + r0) * HD;
  split::fold<T, HD, false>(q + head, k, v, nullptr, nullptr, row_of,
                            max(s * chunk, lo), min((s + 1) * chunk, hi),
                            empty, min(split::QMAX, QPK - r0), scale, cap,
                            out + head, part, row, s, n_split, QPK, r0);
}

template <typename T>
struct Run {
  template <int HD>
  struct At {
    static int run(const void* q, const void* k, const void* v,
                   const void* pos_ptr, int pos_val, void* out, void* part,
                   int BG, int S, int QPK, int window, float cap, float scale,
                   int chunk, int n_split, cudaStream_t st) {
      return split::launch<T, HD>(
          flash_decode_kernel<T, HD>, BG, n_split, QPK,
          static_cast<float*>(part), static_cast<float*>(out), st,
          static_cast<const float*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const int*>(pos_ptr),
          pos_val, static_cast<float*>(out), static_cast<float*>(part), S,
          QPK, window, cap, scale, chunk, n_split);
    }
  };
};

}  // namespace

extern "C" {

const char* flash_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// kv_kind: 0 = f32 cache, 1 = bf16 cache.  pos_ptr: a device int32, or
// null to use pos_val.  part: scratch of bg * n_split * qpk * (hd + 2)
// f32 (unused when n_split == 1).  qpk <= 16; hd in {16, 32, 64, 112, 128,
// 256}.
int flash_decode(const void* q, const void* k, const void* v,
                 const void* pos_ptr, int pos_val, void* out, void* part,
                 int BG, int S, int QPK, int HD, int chunk, int n_split,
                 int kv_kind, int window, float cap, float scale,
                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (QPK < 1 || QPK > split::QPK_MAX || n_split < 1 ||
      n_split > split::MAX_SPLITS)
    return cudaErrorInvalidValue;
  switch (kv_kind) {
    case 0:
      return split::by_hd<Run<float>::At>(HD, q, k, v, pos_ptr, pos_val, out,
                                          part, BG, S, QPK, window, cap,
                                          scale, chunk, n_split, st);
    case 1:
      return split::by_hd<Run<__nv_bfloat16>::At>(
          HD, q, k, v, pos_ptr, pos_val, out, part, BG, S, QPK, window, cap,
          scale, chunk, n_split, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
