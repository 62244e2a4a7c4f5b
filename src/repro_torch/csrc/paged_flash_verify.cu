// paged_flash_verify: multi-query GQA attention through a block table for
// speculative-decode verify windows, split across blocks by key range.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/paged_flash_decode.py:paged_flash_verify (reached
// from gqa_paged_step's verify path through ops.paged_verify_attention).
//
// Semantics: q (b, s, g, qpk, hd); lengths[b] counts the tokens cached
// BEFORE the window.  Row r = j * qpk + p of a (lane, kv head) is query
// head p of window position j, at position h = lengths[b] + j: it sees
// keys k <= h (within `window` of h when one is set) of the table's
// max_pages * ps keys.  The window's own K/V rows are already in the pool.
// A row that sees no key (only with a window, for a padded row past the
// table) gets the Pallas result: the mean of V over all max_pages * ps
// keys, every key counted with score 0.
//
// What bounds it on an H100: the f32 products.  At the verify shape (s =
// 5, qpk = 8, hd = 128) the s * qpk = 40 rows do 40 query-key and 40
// value products per K/V row (320 FMA-flops per int8 byte), far above the
// card's f32 rate over its bandwidth (20 per byte); the tensor cores are
// not used.  The design (split_decode.cuh):
//   * grid (b * g, n_split, z): block (row, split) folds `chunk` keys, a
//     whole number of pages, for up to MAX_WARPS * QMAX rows of the
//     window (z > 1 only past 64 rows); n_split and chunk come from the
//     host's shape-only plan (kernels/split_decode.py::plan_verify), so
//     the wrapper never reads `lengths` and the call can be captured in a
//     CUDA graph.  A block whose keys no row of it sees writes an empty
//     partial and returns;
//   * one block holds all its rows: each K/V tile of the split is staged
//     once, by 16-byte cp.async into a ring of STAGES buffers (tile i + 1
//     loads while tile i is computed; one block barrier per tile), and
//     every warp reads it.  Warp w owns rows [8w, 8w + 8) of the block
//     and keeps their (m, l, acc) in registers (split::tile_scores and
//     tile_fold, as the one-token kernels), masking each key against each
//     row's own horizon.  k's int8 row scale multiplies the score, v's
//     folds into p, and each warp converts a staged element once for all
//     its rows.  Page ids are read a tile ahead of their copies;
//   * the splits' partials go to scratch and split::merge_kernel folds
//     them in split order: every sum has a fixed order, so a call is
//     bitwise repeatable; no float atomics.
// Padded rows (j >= the lane's real tokens) and padding lanes (length 0,
// nothing written) read stale pool rows exactly as the plain version
// and the TPU kernel do; their output is finite and discarded.
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "split_decode.cuh"

namespace {

using split::NEG_INF;
using split::QMAX;

constexpr int MAX_WARPS = 8;            // row groups of QMAX rows per block
constexpr int STAGES = 3;               // K/V tiles in the ring

// Dynamic shared memory of a block of `warps` warps: their rows of q (f32),
// the ring of K and V tiles (rows padded to RS bytes), and each warp's
// (KT, QMAX) probabilities.  kernels/split_decode.py::verify_smem_bytes
// mirrors this expression, and a CPU test reads it from here.
template <typename T, int HD>
constexpr int smem_bytes(int warps) {
  constexpr int KT = split::Shape<T, HD>::KT;
  constexpr int RS = split::Shape<T, HD>::RS;
  return warps * QMAX * HD * 4 + STAGES * 2 * KT * RS + warps * KT * QMAX * 4;
}

// Keys [lo, hi) that rows of horizons h_a <= h_b walk: the union of their
// visible keys, or every key of the table when one of them sees none.
// Rows that see no key are those with h < 0 or, with a window, h >=
// n_keys + window - 1, so checking the two ends covers the rows between.
struct Span {
  int lo, hi;
};
__device__ __forceinline__ bool sees_none(int h, int window, int n_keys) {
  const int lo = window > 0 ? max(0, h - window + 1) : 0;
  return min(h + 1, n_keys) <= lo;
}
__device__ __forceinline__ Span span(int h_a, int h_b, int window,
                                     int n_keys) {
  if (sees_none(h_a, window, n_keys) || sees_none(h_b, window, n_keys))
    return {0, n_keys};
  return {window > 0 ? max(0, h_a - window + 1) : 0, min(h_b + 1, n_keys)};
}

// Grid: (b * g, n_split, z), blockDim 32 * warps.  q, out: (b, s, g, qpk,
// hd) f32; pools (n_pages, ps, g, hd); scales (n_pages, ps, g) f16 when
// QUANT; tables (b, max_pages) int32; lengths (b,) int32 excluding the
// window; part: scratch of (b * g, n_split, s * qpk, hd) then (..., 2) f32.
// Launch bounds: at hd <= 64 ptxas would cap the registers at 80 (three
// 256-thread blocks an SM) and spill; asking for one block an SM lifts
// the cap.  At hd >= 128 (0: no minimum) it picks 139 registers at the
// verify shape without a spill; one block an SM there took 171 and ran
// slower on the card.
template <typename T, int HD, bool QUANT>
__global__ void __launch_bounds__(MAX_WARPS * 32, HD <= 64 ? 1 : 0)
verify_kernel(const float* __restrict__ q, const T* __restrict__ kp,
              const T* __restrict__ vp, const __half* __restrict__ ks,
              const __half* __restrict__ vs, const int* __restrict__ tables,
              const int* __restrict__ lengths, float* __restrict__ out,
              float* __restrict__ part, int S, int G, int QPK, int PS,
              int max_pages, int window, float cap, float scale, int chunk,
              int n_split) {
  using Sh = split::Shape<T, HD>;
  constexpr int KT = Sh::KT;
  constexpr int HDL = Sh::HDL;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const int R = S * QPK;
  const int row = blockIdx.x;
  const int b = row / G;
  const int gi = row - b * G;
  const int sp = blockIdx.y;
  const int r0 = blockIdx.z * nw * QMAX;  // the block's rows [r0, r1)
  const int r1 = min(R, r0 + nw * QMAX);
  const int rw0 = r0 + warp * QMAX;       // this warp's rows [rw0, rw1)
  const int rw1 = min(r1, rw0 + QMAX);
  const int n_keys = max_pages * PS;
  const int len = lengths[b];
  const Span blk = span(len + r0 / QPK, len + (r1 - 1) / QPK, window, n_keys);
  const int kbeg = max(sp * chunk, blk.lo);
  const int kend = min((sp + 1) * chunk, blk.hi);
  const size_t n_part = static_cast<size_t>(gridDim.x) * n_split * R;
  float* ml = part + n_part * HD;                  // (rows, n_split, R, 2)
  const size_t pidx = (static_cast<size_t>(row) * n_split + sp) * R;
  // offset of row r in the (b, s, g, qpk, hd) layout of q and out
  auto at = [&](int r) {
    const int j = r / QPK;
    return ((static_cast<size_t>(b) * S + j) * G + gi) * QPK * HD +
           static_cast<size_t>(r - j * QPK) * HD;
  };

  if (kbeg >= kend) {                 // no row of the block sees a key here
    if (n_split > 1) {
      for (int r = r0 + tid; r < r1; r += blockDim.x) {
        ml[(pidx + r) * 2] = NEG_INF;
        ml[(pidx + r) * 2 + 1] = 0.f;
      }
    } else {
      for (int i = tid; i < (r1 - r0) * HD; i += blockDim.x)
        out[at(r0 + i / HD) + i % HD] = 0.f;
    }
    return;
  }

  float* q_s = reinterpret_cast<float*>(smem) + warp * QMAX * HD;
  unsigned char* ring = smem + nw * QMAX * HD * 4;
  float* p_s = reinterpret_cast<float*>(ring + STAGES * Sh::STAGE) +
               warp * KT * QMAX;
  const unsigned char* kg = reinterpret_cast<const unsigned char*>(kp);
  const unsigned char* vg = reinterpret_cast<const unsigned char*>(vp);
  const int* tab = tables + static_cast<size_t>(b) * max_pages;
  const int n_tiles = (kend - kbeg + KT - 1) / KT;
  const int j = lane % KT;            // this lane's key in a tile

  // this warp's rows of q, zero rows past rw1 (in the first commit group)
  constexpr int QC = HD / 4;          // 16-byte chunks of a q row
  for (int c = lane; c < QMAX * QC; c += 32) {
    const int i = c / QC;
    const bool ok = rw0 + i < rw1;
    split::cp16(q_s + i * HD + (c - i * QC) * 4,
                ok ? q + at(rw0 + i) + (c - i * QC) * 4 : q, ok);
  }

  // each row's horizon; rows past rw1 see nothing; `none`: rows that see
  // no key and count every key with score 0
  int h[QMAX];
  unsigned none = 0;
#pragma unroll
  for (int i = 0; i < QMAX; ++i) {
    h[i] = rw0 + i < rw1 ? len + (rw0 + i) / QPK : -1;
    if (rw0 + i < rw1 && sees_none(h[i], window, n_keys)) none |= 1u << i;
  }

  // pool row of this lane's key in tile `tile` (0 past the split's keys)
  auto key_row = [&](int tile) -> long long {
    const int t = kbeg + tile * KT + j;
    if (t >= kend) return 0;
    const int pg = t / PS;
    return (static_cast<long long>(tab[pg]) * PS + (t - pg * PS)) * G + gi;
  };
  // Stage tile `tile` into ring buffer `st`: the block's threads copy its
  // K and V rows in 16-byte chunks, a warp's lanes taking consecutive
  // chunks; `my_row` is this lane's key's pool row, shuffled to the lanes
  // that copy it.  This lane's key's scales go to ksc / vsc.
  auto stage = [&](int tile, int st, long long my_row, float& ksc,
                   float& vsc) {
    const int t0 = kbeg + tile * KT;
    if (QUANT) {
      const bool mine = t0 + j < kend;
      ksc = mine ? __half2float(ks[my_row]) : 0.f;
      vsc = mine ? __half2float(vs[my_row]) : 0.f;
    }
    unsigned char* kd = ring + st * Sh::STAGE;
    unsigned char* vd = kd + KT * Sh::RS;
    for (int i0 = warp * 32; i0 < KT * Sh::CPR; i0 += nw * 32) {
      const int i = i0 + lane;
      const int r = i < KT * Sh::CPR ? i / Sh::CPR : 0;
      const long long rr = __shfl_sync(split::FULL, my_row, r);
      if (i < KT * Sh::CPR) {
        const int c = i - r * Sh::CPR;
        const bool ok = t0 + r < kend;
        const size_t off = ok ? static_cast<size_t>(rr) * Sh::ROW + c * 16
                              : 0;
        split::cp16(kd + r * Sh::RS + c * 16, kg + off, ok);
        split::cp16(vd + r * Sh::RS + c * 16, vg + off, ok);
      }
    }
  };

  float m[QMAX], l[QMAX], acc[QMAX][HDL];
#pragma unroll
  for (int i = 0; i < QMAX; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int k = 0; k < HDL; ++k) acc[i][k] = 0.f;
  }
  float ks_cur = 1.f, vs_cur = 1.f, ks_nxt = 1.f, vs_nxt = 1.f;
  long long row_nxt = key_row(1);
  stage(0, 0, key_row(0), ks_cur, vs_cur);
  split::cp_commit();                 // q and tile 0
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      stage(it + 1, (it + 1) % STAGES, row_nxt, ks_nxt, vs_nxt);
      row_nxt = key_row(it + 2);      // used a tile from now
    }
    split::cp_commit();               // (empty past the last tile)
    split::cp_wait<1>();
    // tile it is in place for every warp; with STAGES = 3 the buffer
    // staged next was last read before the previous barrier
    __syncthreads();
    if (rw0 < rw1) {
      const unsigned char* kd = ring + (it % STAGES) * Sh::STAGE;
      const int t0 = kbeg + it * KT;
      const int t = t0 + j;
      float sc[QMAX];
      split::tile_scores<T, HD>(kd, q_s, lane, sc);
      const float f = (QUANT ? ks_cur : 1.f) * scale;
#pragma unroll
      for (int i = 0; i < QMAX; ++i) {
        float s = sc[i] * f;
        if (cap > 0.f) s = cap * tanhf(s / cap);
        const bool z = (none >> i) & 1u;
        const bool vis = t < kend && (z || (t <= h[i] && (window <= 0 ||
                                                          h[i] - t < window)));
        sc[i] = vis ? (z ? 0.f : s) : NEG_INF;
      }
      split::tile_fold<T, HD>(kd + KT * Sh::RS, p_s, min(KT, kend - t0),
                              QUANT ? vs_cur : 1.f, lane, sc, m, l, acc);
    }
    ks_cur = ks_nxt;
    vs_cur = vs_nxt;
  }
  split::cp_wait<0>();
  if (rw0 >= rw1) return;
#pragma unroll
  for (int i = 0; i < QMAX; ++i)
#pragma unroll
    for (int off = 1; off < KT; off <<= 1)
      l[i] += __shfl_xor_sync(split::FULL, l[i], off);

  const int d0 = lane * HDL;          // this lane's dims of acc
  if (d0 >= HD) return;
#pragma unroll
  for (int i = 0; i < QMAX; ++i) {
    const int r = rw0 + i;
    if (r >= rw1) break;
    if (n_split == 1) {
      float* o = out + at(r) + d0;
#pragma unroll
      for (int k = 0; k < HDL; ++k) o[k] = acc[i][k] / fmaxf(l[i], 1e-30f);
    } else {
      float* pp = part + (pidx + r) * HD + d0;
#pragma unroll
      for (int k = 0; k < HDL; ++k) pp[k] = acc[i][k];
      if (lane == 0) {
        ml[(pidx + r) * 2] = m[i];
        ml[(pidx + r) * 2 + 1] = l[i];
      }
    }
  }
}

template <typename T, bool QUANT>
struct Run {
  template <int HD>
  struct At {
    static int run(const void* q, const void* kp, const void* vp,
                   const void* ks, const void* vs, const void* tables,
                   const void* lengths, void* out, void* part, int B, int S,
                   int G, int QPK, int PS, int max_pages, int window,
                   float cap, float scale, int chunk, int n_split,
                   cudaStream_t st) {
      // rows in groups of QMAX, at most MAX_WARPS groups per block
      const int R = S * QPK;
      const int groups = (R + QMAX - 1) / QMAX;
      const int z = (groups + MAX_WARPS - 1) / MAX_WARPS;
      const int warps = (groups + z - 1) / z;
      static int limit = 0;           // the opt-in is set on first use
      return split::launch_grid(
          verify_kernel<T, HD, QUANT>, dim3(B * G, n_split, z), 32 * warps,
          smem_bytes<T, HD>(warps), limit, R, G, QPK, HD,
          static_cast<float*>(part), static_cast<float*>(out), st,
          static_cast<const float*>(q), static_cast<const T*>(kp),
          static_cast<const T*>(vp), static_cast<const __half*>(ks),
          static_cast<const __half*>(vs), static_cast<const int*>(tables),
          static_cast<const int*>(lengths), static_cast<float*>(out),
          static_cast<float*>(part), S, G, QPK, PS, max_pages, window, cap,
          scale, chunk, n_split);
    }
  };
};

}  // namespace

extern "C" {

const char* paged_flash_verify_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// kv_kind: 0 = f32 pools, 1 = bf16 pools, 2 = int8 pools with f16 scales.
// part: scratch of b * g * n_split * s * qpk * (hd + 2) f32 (unused when
// n_split == 1).  hd in {16, 32, 64, 112, 128, 256} (`split::by_hd`).
int paged_flash_verify(const void* q, const void* kp, const void* vp,
                       const void* ks, const void* vs, const void* tables,
                       const void* lengths, void* out, void* part, int B,
                       int S, int G, int QPK, int HD, int PS, int max_pages,
                       int chunk, int n_split, int kv_kind, int window,
                       float cap, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S < 1 || QPK < 1 || n_split < 1 || n_split > split::MAX_SPLITS ||
      chunk < 1)
    return cudaErrorInvalidValue;
  switch (kv_kind) {
    case 0:
      return split::by_hd<Run<float, false>::At>(
          HD, q, kp, vp, ks, vs, tables, lengths, out, part, B, S, G, QPK,
          PS, max_pages, window, cap, scale, chunk, n_split, st);
    case 1:
      return split::by_hd<Run<__nv_bfloat16, false>::At>(
          HD, q, kp, vp, ks, vs, tables, lengths, out, part, B, S, G, QPK,
          PS, max_pages, window, cap, scale, chunk, n_split, st);
    case 2:
      return split::by_hd<Run<int8_t, true>::At>(
          HD, q, kp, vp, ks, vs, tables, lengths, out, part, B, S, G, QPK,
          PS, max_pages, window, cap, scale, chunk, n_split, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
