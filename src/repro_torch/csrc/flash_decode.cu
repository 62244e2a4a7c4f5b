// flash_decode: one-token decode attention over a contiguous K/V cache,
// with an online softmax in f32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_decode.py:
// flash_decode (reached through ops.decode_attention).
//
// Semantics: q (bg, qpk, hd) f32, k/v (bg, S, hd) f32 or bf16; keys
// k_pos <= pos are visible (within `window` of pos when one is set).
// `pos` is read in the kernel from a device int32 when `pos_ptr` is not
// null, so a caller holding it on the card needs no host sync.
//
// What bounds it on an H100: bytes, the K/V rows up to pos, which all
// qpk query rows of the group reuse.  The design is the paged decode
// kernel's without the table:
//   * one block per bg row holds the qpk query rows and walks
//     ceil((pos + 1) / TILE) tiles of TILE keys (capped at S), skipping
//     tiles wholly before a sliding window; the TPU grid walked every
//     512-key block of S and masked the tail.  The ragged edge (S not a
//     multiple of TILE) is masked here, so any S is taken;
//   * each tile's K and V rows are loaded once, coalesced, converted to
//     f32 and staged in shared memory, where all qpk rows reuse them;
//   * the softmax state (running max, sum, (qpk, hd) accumulator) stays
//     on chip across tiles.
// When no key is visible (pos < 0, or a window that ends before key 0
// or starts past S) the kernel returns zeros, where the plain version
// returns the mean of V.
// Simple first: bg blocks (8 for qwen2.5-3b at batch 4) leave most SMs
// idle; splitting the keys across blocks is later work.
#include <cuda_runtime.h>

#include "attention_tile.cuh"

namespace {

using attn::NEG_INF;
using attn::to_f;

constexpr int THREADS = 128;
constexpr int TILE = 32;

// Grid: (bg,).  q, out: (bg, qpk, hd) f32; k, v: (bg, S, hd).
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_decode_kernel(const float* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ pos_ptr,
                    int pos_val, float* __restrict__ out, int S, int QPK,
                    int HD, int window, float cap, float scale) {
  extern __shared__ float sm[];
  float* q_s = sm;                          // QPK * HD
  float* k_s = q_s + QPK * HD;              // TILE * (HD + 1), padded rows
  float* v_s = k_s + TILE * (HD + 1);       // TILE * HD
  float* p_s = v_s + TILE * HD;             // QPK * TILE scores, then probs
  float* acc = p_s + QPK * TILE;            // QPK * HD
  float* m_s = acc + QPK * HD;              // QPK running max
  float* l_s = m_s + QPK;                   // QPK running sum
  float* a_s = l_s + QPK;                   // QPK rescale factor

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int pos = pos_ptr != nullptr ? *pos_ptr : pos_val;
  const size_t head = static_cast<size_t>(row) * QPK * HD;
  const size_t kv0 = static_cast<size_t>(row) * S * HD;

  for (int i = tid; i < QPK * HD; i += THREADS) {
    q_s[i] = q[head + i];
    acc[i] = 0.f;
  }
  for (int r = tid; r < QPK; r += THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }
  const int last = pos < S - 1 ? pos : S - 1;             // last visible key
  const int n_tiles = last < 0 ? 0 : last / TILE + 1;
  const int lo = pos - window + 1;
  const int first = (window > 0 && lo > 0) ? lo / TILE : 0;
  __syncthreads();

  for (int tl = first; tl < n_tiles; ++tl) {
    const int t0 = tl * TILE;
    for (int i = tid; i < TILE * HD; i += THREADS) {
      const int t = i / HD;
      const int d = i - t * HD;
      float kv = 0.f, vv = 0.f;
      if (t0 + t < S) {
        const size_t at = kv0 + static_cast<size_t>(t0 + t) * HD + d;
        kv = to_f(k[at]);
        vv = to_f(v[at]);
      }
      k_s[t * (HD + 1) + d] = kv;
      v_s[t * HD + d] = vv;
    }
    __syncthreads();
    attn::tile_step<THREADS>(
        q_s, k_s, v_s, p_s, acc, m_s, l_s, a_s, QPK, TILE, HD, scale, cap,
        [=](int, int t) {
          const int kpos = t0 + t;
          return kpos <= last && (window <= 0 || pos - kpos < window);
        });
  }
  for (int i = tid; i < QPK * HD; i += THREADS) {
    out[head + i] = acc[i] / fmaxf(l_s[i / HD], 1e-30f);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* pos_ptr,
           int pos_val, void* out, int BG, int S, int QPK, int HD, int window,
           float cap, float scale, cudaStream_t st) {
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(QPK) * HD + TILE * (HD + 1) + TILE * HD +
       QPK * TILE + QPK * HD + 3 * QPK);
  auto kern = flash_decode_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<BG, THREADS, smem, st>>>(
      static_cast<const float*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(pos_ptr), pos_val,
      static_cast<float*>(out), S, QPK, HD, window, cap, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* flash_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// kv_kind: 0 = f32 cache, 1 = bf16 cache.  pos_ptr: a device int32, or
// null to use pos_val.
int flash_decode(const void* q, const void* k, const void* v,
                 const void* pos_ptr, int pos_val, void* out, int BG, int S,
                 int QPK, int HD, int kv_kind, int window, float cap,
                 float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kv_kind) {
    case 0:
      return launch<float>(q, k, v, pos_ptr, pos_val, out, BG, S, QPK, HD,
                           window, cap, scale, st);
    case 1:
      return launch<__nv_bfloat16>(q, k, v, pos_ptr, pos_val, out, BG, S, QPK,
                                   HD, window, cap, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
