// Shared by cim_gemv.cu and swiglu_gemv.cu: reading packed INT4/INT8
// weight words and their f16 group scales.
#pragma once
#include <cuda_fp16.h>
#include <stdint.h>

namespace packed {

constexpr int COLS = 4;                  // columns per thread: one word

// Value of column j (byte j of `word`) in logical row `half` of a packed
// row pair (BITS == 4: low nibble = even row, high = odd row, +8 offset)
// or of a single row (BITS == 8: the byte is the int8).
template <int BITS>
__device__ __forceinline__ float qval(uint32_t word, int j, int half) {
  uint32_t byte = (word >> (8 * j)) & 0xFFu;
  if (BITS == 4) {
    return static_cast<float>(static_cast<int>((byte >> (4 * half)) & 0xFu) - 8);
  }
  return static_cast<float>(static_cast<int8_t>(byte));
}

// The f16 scales of group `gi` for columns c0 .. c0 + COLS - 1.
__device__ __forceinline__ void load_scales(const __half* __restrict__ s,
                                            int gi, int N, int c0,
                                            float out[COLS]) {
  const __half* p = s + static_cast<size_t>(gi) * N + c0;
#pragma unroll
  for (int j = 0; j < COLS; ++j) out[j] = __half2float(p[j]);
}

}  // namespace packed
