// paged_flash_decode: one-token GQA decode attention through a block
// table, with an online softmax in f32.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/paged_flash_decode.py:paged_flash_decode (reached
// from gqa_paged_step's decode path through ops.paged_decode_attention).
//
// What bounds it on an H100: bytes, the K/V rows of the pages a lane
// owns (INT8 rows plus one f16 scale per row and kv head), which every
// query head of the group reuses.  The design:
//   * one block per (lane, kv head) holds the group's qpk query rows and
//     walks only the lane's own pages, ceil(length / page_size) of them
//     (after skipping pages wholly before a sliding window), reading the
//     page ids from the block table itself; the TPU grid walked all
//     max_pages and masked the tail;
//   * each page's K and V rows are loaded once, coalesced, dequantized
//     by their f16 scale right after the load, and staged in shared
//     memory, where all qpk query rows reuse them;
//   * the softmax state (running max, sum, and the (qpk, hd)
//     accumulator) stays on chip across pages.
// A lane with length 0 (an inactive padding lane) walks no page and gets
// zeros; the TPU kernel and the plain version return the mean of
// masked rows there.  The engine drops those rows either way.
// Simple first: with few lanes the card is mostly idle (b * g blocks);
// splitting a lane's pages across blocks is later work.
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "attention_tile.cuh"

namespace {

using attn::NEG_INF;
using attn::to_f;

constexpr int THREADS = 128;

// Grid: (b, g).  q, out: (b, g, qpk, hd) f32; pools (n_pages, ps, g, hd);
// scales (n_pages, ps, g) f16 when QUANT; tables (b, max_pages) int32;
// lengths (b,) int32 including the current token.
template <typename T, bool QUANT>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const float* __restrict__ q, const T* __restrict__ kp,
              const T* __restrict__ vp, const __half* __restrict__ ks,
              const __half* __restrict__ vs, const int* __restrict__ tables,
              const int* __restrict__ lengths, float* __restrict__ out,
              int G, int QPK, int HD, int PS, int max_pages, int window,
              float cap, float scale) {
  extern __shared__ float sm[];
  float* q_s = sm;                          // QPK * HD
  float* k_s = q_s + QPK * HD;              // PS * (HD + 1), padded rows
  float* v_s = k_s + PS * (HD + 1);         // PS * HD
  float* p_s = v_s + PS * HD;               // QPK * PS scores, then probs
  float* acc = p_s + QPK * PS;              // QPK * HD
  float* m_s = acc + QPK * HD;              // QPK running max
  float* l_s = m_s + QPK;                   // QPK running sum
  float* a_s = l_s + QPK;                   // QPK rescale factor

  const int b = blockIdx.x;
  const int gi = blockIdx.y;
  const int tid = threadIdx.x;
  const int len = lengths[b];
  const size_t head = (static_cast<size_t>(b) * G + gi) * QPK * HD;

  for (int i = tid; i < QPK * HD; i += THREADS) {
    q_s[i] = q[head + i];
    acc[i] = 0.f;
  }
  for (int r = tid; r < QPK; r += THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }
  const int n_pages = (len + PS - 1) / PS;
  const int first = (window > 0 && len > window) ? (len - window) / PS : 0;
  __syncthreads();

  for (int pg = first; pg < n_pages; ++pg) {
    const int pid = tables[static_cast<size_t>(b) * max_pages + pg];
    for (int i = tid; i < PS * HD; i += THREADS) {
      const int t = i / HD;
      const int d = i - t * HD;
      const size_t row = (static_cast<size_t>(pid) * PS + t) * G + gi;
      float kv = to_f(kp[row * HD + d]);
      float vv = to_f(vp[row * HD + d]);
      if (QUANT) {
        kv *= __half2float(ks[row]);
        vv *= __half2float(vs[row]);
      }
      k_s[t * (HD + 1) + d] = kv;
      v_s[t * HD + d] = vv;
    }
    __syncthreads();
    attn::tile_step<THREADS>(
        q_s, k_s, v_s, p_s, acc, m_s, l_s, a_s, QPK, PS, HD, scale, cap,
        [=](int, int t) {
          const int kpos = pg * PS + t;
          return kpos < len && (window <= 0 || (len - 1) - kpos < window);
        });
  }
  for (int i = tid; i < QPK * HD; i += THREADS) {
    out[head + i] = acc[i] / fmaxf(l_s[i / HD], 1e-30f);
  }
}

template <typename T, bool QUANT>
int launch(const void* q, const void* kp, const void* vp, const void* ks,
           const void* vs, const void* tables, const void* lengths, void* out,
           int B, int G, int QPK, int HD, int PS, int max_pages, int window,
           float cap, float scale, cudaStream_t st) {
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(QPK) * HD + PS * (HD + 1) + PS * HD + QPK * PS +
       QPK * HD + 3 * QPK);
  auto kern = decode_kernel<T, QUANT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<dim3(B, G), THREADS, smem, st>>>(
      static_cast<const float*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const __half*>(ks),
      static_cast<const __half*>(vs), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<float*>(out), G, QPK, HD,
      PS, max_pages, window, cap, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* paged_flash_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// kv_kind: 0 = f32 pools, 1 = bf16 pools, 2 = int8 pools with f16 scales.
int paged_flash_decode(const void* q, const void* kp, const void* vp,
                       const void* ks, const void* vs, const void* tables,
                       const void* lengths, void* out, int B, int G, int QPK,
                       int HD, int PS, int max_pages, int kv_kind, int window,
                       float cap, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kv_kind) {
    case 0:
      return launch<float, false>(q, kp, vp, ks, vs, tables, lengths, out, B,
                                  G, QPK, HD, PS, max_pages, window, cap,
                                  scale, st);
    case 1:
      return launch<__nv_bfloat16, false>(q, kp, vp, ks, vs, tables, lengths,
                                          out, B, G, QPK, HD, PS, max_pages,
                                          window, cap, scale, st);
    case 2:
      return launch<int8_t, true>(q, kp, vp, ks, vs, tables, lengths, out, B,
                                  G, QPK, HD, PS, max_pages, window, cap,
                                  scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
