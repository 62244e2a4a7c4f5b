// paged_flash_verify: multi-query GQA attention through a block table for
// speculative-decode verify windows, with an online softmax in f32.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/paged_flash_decode.py:paged_flash_verify (reached
// from gqa_paged_step's verify path through ops.paged_verify_attention).
//
// Semantics: q (b, s, g, qpk, hd); lengths[b] counts the tokens cached
// BEFORE the window.  Query row j of the window sits at position
// lengths[b] + j and sees keys k_pos <= lengths[b] + j (within `window`
// of it when one is set).  The window's own K/V rows are already in the
// pool.
//
// What bounds it on an H100: at the verify shape (s = 5, qpk = 8, hd =
// 128) the f32 score and value products, s*qpk = 40 query rows against
// every K/V row the lane owns, outweigh the bytes of those rows (the
// tensor cores are not used yet).  The design:
//   * one block per (lane, kv head) holds all s*qpk query rows of its
//     group, read straight from the (b, s, g, qpk, hd) layout, so each
//     K/V row is loaded once and used by the whole window;
//   * it walks min(max_pages, ceil((lengths[b] + s) / ps)) pages of the
//     lane's table (near max_seq the padded rows of a window reach past
//     the table; the TPU grid walked all max_pages and masked them),
//     skipping pages wholly before the lowest row's sliding window;
//   * each page's K and V rows are loaded once, coalesced, dequantized
//     by their f16 scale right after the load, and staged in shared
//     memory; row r's horizon is lengths[b] + r / qpk;
//   * the softmax state (running max, sum, and the (s*qpk, hd)
//     accumulator) stays in shared memory across pages: above 48 KB at
//     the verify shape, so the launcher raises the dynamic limit.
// Padded rows (j >= the lane's real tokens) and padding lanes (length 0,
// nothing written) read stale pool rows exactly as the plain version
// and the TPU kernel do; their output is finite and discarded.  A row
// whose every key is masked (only possible with a window, for a padded
// row past the table) gets zeros where the plain version gives the mean
// of masked rows.
// Simple first: b * g blocks leave most SMs idle, and the products run
// on the f32 pipes; splitting pages across blocks and tensor-core
// products are later work.
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "attention_tile.cuh"

namespace {

using attn::NEG_INF;
using attn::to_f;

constexpr int THREADS = 256;

// Grid: (b, g).  q, out: (b, s, g, qpk, hd) f32; pools (n_pages, ps, g,
// hd); scales (n_pages, ps, g) f16 when QUANT; tables (b, max_pages)
// int32; lengths (b,) int32 excluding the window.  Block-local row r =
// j * qpk + p is query head p of window position j.
template <typename T, bool QUANT>
__global__ void __launch_bounds__(THREADS)
verify_kernel(const float* __restrict__ q, const T* __restrict__ kp,
              const T* __restrict__ vp, const __half* __restrict__ ks,
              const __half* __restrict__ vs, const int* __restrict__ tables,
              const int* __restrict__ lengths, float* __restrict__ out,
              int S, int G, int QPK, int HD, int PS, int max_pages,
              int window, float cap, float scale) {
  extern __shared__ float sm[];
  const int R = S * QPK;
  float* q_s = sm;                          // R * HD
  float* k_s = q_s + R * HD;                // PS * (HD + 1), padded rows
  float* v_s = k_s + PS * (HD + 1);         // PS * HD
  float* p_s = v_s + PS * HD;               // R * PS scores, then probs
  float* acc = p_s + R * PS;                // R * HD
  float* m_s = acc + R * HD;                // R running max
  float* l_s = m_s + R;                     // R running sum
  float* a_s = l_s + R;                     // R rescale factor

  const int b = blockIdx.x;
  const int gi = blockIdx.y;
  const int tid = threadIdx.x;
  const int len = lengths[b];

  // row r of this block lives at q[((b * S + r / QPK) * G + gi) * QPK + r % QPK]
  for (int i = tid; i < R * HD; i += THREADS) {
    const int r = i / HD;
    const int d = i - r * HD;
    const int j = r / QPK;
    const size_t src =
        ((static_cast<size_t>(b) * S + j) * G + gi) * QPK * HD +
        static_cast<size_t>(r - j * QPK) * HD + d;
    q_s[i] = q[src];
    acc[i] = 0.f;
  }
  for (int r = tid; r < R; r += THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }
  int n_pages = (len + S + PS - 1) / PS;
  if (n_pages > max_pages) n_pages = max_pages;
  const int lo = len - window + 1;          // row 0's first visible key
  const int first = (window > 0 && lo > 0) ? lo / PS : 0;
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
        q_s, k_s, v_s, p_s, acc, m_s, l_s, a_s, R, PS, HD, scale, cap,
        [=](int r, int t) {
          const int kpos = pg * PS + t;
          const int qpos = len + r / QPK;
          return kpos <= qpos && (window <= 0 || qpos - kpos < window);
        });
  }
  for (int i = tid; i < R * HD; i += THREADS) {
    const int r = i / HD;
    const int d = i - r * HD;
    const int j = r / QPK;
    const size_t dst =
        ((static_cast<size_t>(b) * S + j) * G + gi) * QPK * HD +
        static_cast<size_t>(r - j * QPK) * HD + d;
    out[dst] = acc[i] / fmaxf(l_s[r], 1e-30f);
  }
}

size_t smem_bytes(int S, int QPK, int HD, int PS) {
  const size_t R = static_cast<size_t>(S) * QPK;
  return sizeof(float) *
         (R * HD + PS * (HD + 1) + static_cast<size_t>(PS) * HD + R * PS +
          R * HD + 3 * R);
}

template <typename T, bool QUANT>
int launch(const void* q, const void* kp, const void* vp, const void* ks,
           const void* vs, const void* tables, const void* lengths, void* out,
           int B, int S, int G, int QPK, int HD, int PS, int max_pages,
           int window, float cap, float scale, cudaStream_t st) {
  const size_t smem = smem_bytes(S, QPK, HD, PS);
  auto kern = verify_kernel<T, QUANT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<dim3(B, G), THREADS, smem, st>>>(
      static_cast<const float*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const __half*>(ks),
      static_cast<const __half*>(vs), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<float*>(out), S, G, QPK,
      HD, PS, max_pages, window, cap, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* paged_flash_verify_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// kv_kind: 0 = f32 pools, 1 = bf16 pools, 2 = int8 pools with f16 scales.
int paged_flash_verify(const void* q, const void* kp, const void* vp,
                       const void* ks, const void* vs, const void* tables,
                       const void* lengths, void* out, int B, int S, int G,
                       int QPK, int HD, int PS, int max_pages, int kv_kind,
                       int window, float cap, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kv_kind) {
    case 0:
      return launch<float, false>(q, kp, vp, ks, vs, tables, lengths, out, B,
                                  S, G, QPK, HD, PS, max_pages, window, cap,
                                  scale, st);
    case 1:
      return launch<__nv_bfloat16, false>(q, kp, vp, ks, vs, tables, lengths,
                                          out, B, S, G, QPK, HD, PS, max_pages,
                                          window, cap, scale, st);
    case 2:
      return launch<int8_t, true>(q, kp, vp, ks, vs, tables, lengths, out, B,
                                  S, G, QPK, HD, PS, max_pages, window, cap,
                                  scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
