// Shared pieces of the port's attention kernels (paged_flash_decode,
// paged_flash_verify, flash_decode): element conversion to f32 and one
// online-softmax step of R query rows against a tile of keys staged in
// shared memory.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace attn {

constexpr float NEG_INF = -1.0e30f;

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ float to_f<int8_t>(int8_t v) {
  return static_cast<float>(v);
}

// Fold one staged tile of T keys into the softmax state of R rows.
//   q_s (R, HD); k_s (T, HD + 1), rows padded against bank conflicts;
//   v_s (T, HD); p_s (R, T) scratch; acc (R, HD) running numerator;
//   m_s, l_s (R) running max and sum; a_s (R) scratch.
// visible(r, t) says whether row r sees key t of this tile; a masked key
// contributes nothing, and a row that has seen no key keeps m = NEG_INF.
// The caller has synchronised after staging the tile; this returns
// synchronised, so the next tile may be staged at once.
template <int THREADS, typename Visible>
__device__ __forceinline__ void tile_step(
    const float* q_s, const float* k_s, const float* v_s, float* p_s,
    float* acc, float* m_s, float* l_s, float* a_s, int R, int T, int HD,
    float scale, float cap, Visible visible) {
  const int tid = threadIdx.x;
  for (int i = tid; i < R * T; i += THREADS) {
    const int r = i / T;
    const int t = i - r * T;
    float s = 0.f;
    for (int d = 0; d < HD; ++d)
      s = fmaf(q_s[r * HD + d], k_s[t * (HD + 1) + d], s);
    s *= scale;
    if (cap > 0.f) s = cap * tanhf(s / cap);
    p_s[i] = visible(r, t) ? s : NEG_INF;
  }
  __syncthreads();
  for (int r = tid; r < R; r += THREADS) {
    const float m_prev = m_s[r];
    float mx = m_prev;
    for (int t = 0; t < T; ++t) mx = fmaxf(mx, p_s[r * T + t]);
    float sum = 0.f;
    for (int t = 0; t < T; ++t) {
      const float sv = p_s[r * T + t];
      const float e = sv <= 0.5f * NEG_INF ? 0.f : expf(sv - mx);
      p_s[r * T + t] = e;
      sum += e;
    }
    const float alpha = m_prev <= 0.5f * NEG_INF ? 0.f : expf(m_prev - mx);
    m_s[r] = mx;
    l_s[r] = l_s[r] * alpha + sum;
    a_s[r] = alpha;
  }
  __syncthreads();
  for (int i = tid; i < R * HD; i += THREADS) {
    const int r = i / HD;
    const int d = i - r * HD;
    float o = acc[i] * a_s[r];
    for (int t = 0; t < T; ++t) o = fmaf(p_s[r * T + t], v_s[t * HD + d], o);
    acc[i] = o;
  }
  __syncthreads();
}

}  // namespace attn
