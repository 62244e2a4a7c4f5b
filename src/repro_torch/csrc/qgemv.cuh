// Packed-weight GEMV building blocks for Hopper: 16-byte (or 4-byte)
// asynchronous copies of packed INT4/INT8 weight rows into shared memory,
// and the conversion of packed nibbles / bytes to f32 without I2F.
// Used by cim_gemv.cu and swiglu_gemv.cu.
#pragma once
#include <cuda_fp16.h>
#include <stdint.h>

namespace qgemv {

constexpr unsigned FULL = 0xffffffffu;

// ---- asynchronous global -> shared copies -------------------------------
// 16 bytes, L2 only (the weight is streamed once; L1 would only evict).
__device__ __forceinline__ void cp16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
// 4 bytes (cp.async.cg takes only 16): for rows whose base or stride is
// not 16-byte aligned.
__device__ __forceinline__ void cp4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// wait until at most n (0..3) of this thread's groups are pending
__device__ __forceinline__ void cp_wait_dyn(int n) {
  switch (n) {
    case 0: cp_wait<0>(); break;
    case 1: cp_wait<1>(); break;
    case 2: cp_wait<2>(); break;
    default: cp_wait<3>(); break;
  }
}

// One 16-byte chunk of a packed row, of which `avail` bytes exist (the
// rest is left unwritten).  VEC = 16: one copy, the caller guarantees 16
// aligned bytes; VEC = 4: four 4-byte copies, each only if it exists.
template <int VEC>
__device__ __forceinline__ void copy_chunk(unsigned char* dst,
                                           const uint8_t* src, int avail) {
  static_assert(VEC == 16 || VEC == 4, "16- or 4-byte copies");
  if constexpr (VEC == 16) {
    cp16(dst, src);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (4 * q < avail) cp4(dst + 4 * q, src + 4 * q);
  }
}

// ---- packed values to f32 -----------------------------------------------
// f32 with bits 0x4B0000nn is exactly 2^23 + nn; subtracting 2^23 + bias
// leaves nn - bias exactly.  One PRMT moves byte j of `word` under the
// 0x4B exponent, one FADD removes the bias: no I2F.
__device__ __forceinline__ float byte_to_f32(uint32_t word, int j,
                                             float bias) {
  return __uint_as_float(__byte_perm(word, 0x4B000000u, 0x7440 | j)) - bias;
}
constexpr float INT4_BIAS = 8388616.f;     // 2^23 + 8: nibbles carry +8
constexpr float INT8_BIAS = 8388736.f;     // 2^23 + 128, after INT8_FLIP
constexpr uint32_t INT8_FLIP = 0x80808080u;  // int8 b -> unsigned b + 128

// The low (even row) and high (odd row) nibbles of the four bytes of an
// INT4 word, each in its own byte.
__device__ __forceinline__ uint32_t lo_nibbles(uint32_t w) {
  return w & 0x0F0F0F0Fu;
}
__device__ __forceinline__ uint32_t hi_nibbles(uint32_t w) {
  return (w >> 4) & 0x0F0F0F0Fu;
}
// value of byte j of a lo/hi_nibbles word (INT4) or of an INT8_FLIPped
// word (INT8)
template <int BITS>
__device__ __forceinline__ float qv(uint32_t prepared, int j) {
  return byte_to_f32(prepared, j, BITS == 4 ? INT4_BIAS : INT8_BIAS);
}

}  // namespace qgemv
