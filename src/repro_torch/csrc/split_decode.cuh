// Split-KV ("flash-decoding") attention, shared by paged_flash_decode.cu,
// flash_decode.cu and paged_flash_verify.cu.
//
// A call's grid is (rows, n_split, z): a row is one (lane, kv head) with
// its query rows (qpk heads; s * qpk for a verify window), split s folds
// keys [s * chunk, (s + 1) * chunk) of it, and z counts the blocks that
// share a (row, split) by groups of query rows (a one-token row of qpk >
// QMAX heads: block z holds heads [QMAX z, QMAX z + QMAX), and each reads
// the split's K/V rows for its own group).  The visible keys of a
// one-token row are one interval [lo, hi); each kernel supplies that
// interval and how key t's K/V row is found (`row_of`, a row index into
// (rows, hd) pools, and its scale when QUANT).  The pieces here:
//   * one warp's work on a staged tile of KT keys for QMAX query rows:
//     `tile_scores` (lane j of a key group computes q . k for key j over
//     its share of hd, the groups sum by warp shuffles) and `tile_fold`
//     (the online softmax, its max over the tile by shuffles too, then
//     p . v, each lane owning ceil(hd / 32) dims of the (QMAX, hd)
//     accumulator); the state stays in registers;
//   * the one-token walk (`fold`): each of the block's 4 warps stages its
//     own tiles (K and V rows, 16-byte cp.async chunks into a double
//     buffer, so tile i + 1 loads while tile i is computed) and merges
//     with the others once, at the end of the split, through shared
//     memory; no block-wide barrier runs per tile.  The verify kernel
//     walks its split in its own source: it stages each tile once per
//     block, for all its warps;
//   * the partial (m, l, acc) each split writes to scratch, (rows,
//     n_split, R, hd) f32 then (rows, n_split, R, 2) f32 for R query rows
//     per grid row, or the output itself when n_split == 1;
//   * the merge (`merge_kernel`), a second launch that folds the partials
//     of each row in split order.  Every sum has a fixed order, so a call
//     is bitwise repeatable; no float atomics.
// A row that sees no key takes the TPU kernels' result, the mean of V over
// every key the kernel walks: all keys count as visible, with score 0.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "attention_tile.cuh"

namespace split {

using attn::NEG_INF;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int QMAX = 8;                 // query rows a warp holds
constexpr int QPK_MAX = 16;             // query heads per kv head, at most
                                        //   (one-token kernels: QPK_MAX /
                                        //   QMAX blocks a (row, split))
constexpr int MAX_SPLITS = 256;         // splits per row, at most
constexpr unsigned FULL = 0xffffffffu;

// Tile geometry of one warp for element type T and head dim HD.
template <typename T, int HD>
struct Shape {
  static constexpr int ROW = HD * static_cast<int>(sizeof(T));  // bytes
  static constexpr int RS = ROW + 16;   // padded shared-memory row stride
  // keys per tile: 16, fewer for rows wider than 256 B (stage <= ~8.5 KB)
  static constexpr int KT = ROW <= 256 ? 16 : (ROW <= 512 ? 8 : 4);
  static constexpr int PARTS = 32 / KT;  // lanes that share one key's q . k
  static constexpr int DP = HD / PARTS;  // dims of q . k per lane
  // bytes per load of a lane's DP dims: the largest of 16 / 8 / 4 that
  // divides them, so the loads tile them (hd 112 int8: 56 B in 8s)
  static constexpr int DPB = DP * static_cast<int>(sizeof(T));
  static constexpr int VB = DPB % 16 == 0 ? 16 : (DPB % 8 == 0 ? 8 : 4);
  static constexpr int VE = VB / static_cast<int>(sizeof(T));  // per load
  // p . v dims per lane: ceil(HD / 32), lanes past HD / HDL idle (hd 112:
  // 28 lanes of 4 dims)
  static constexpr int HDL = (HD + 31) / 32;
  static constexpr int CPR = ROW / 16;  // 16-byte chunks per row
  static constexpr int STAGE = 2 * KT * RS;            // K + V tile, bytes
  static constexpr int WARP_SMEM = 2 * STAGE + KT * QMAX * 4;
  static constexpr int SMEM = QMAX * HD * 4 + WARPS * WARP_SMEM;
  static_assert(HD % 16 == 0 && HD <= 256, "hd: a multiple of 16, <= 256");
  static_assert(ROW % 16 == 0, "rows are whole 16-byte chunks");
  static_assert(VE % 4 == 0 && DP % VE == 0,
                "q . k runs on float4 pieces of q that tile DP");
  static_assert(HD % HDL == 0, "p . v: whole lanes of HDL dims");
  // the warp's merge area (m, l, acc) reuses its stage buffers
  static_assert(QMAX * (HD + 2) * 4 <= 2 * STAGE, "merge area");
};

// Element k of T packed little-endian in a 32-bit word, as f32.
template <typename T>
__device__ __forceinline__ float unpack(uint32_t w, int k);
template <>
__device__ __forceinline__ float unpack<float>(uint32_t w, int) {
  return __uint_as_float(w);
}
template <>
__device__ __forceinline__ float unpack<__nv_bfloat16>(uint32_t w, int k) {
  return __bfloat162float(
      __ushort_as_bfloat16(static_cast<unsigned short>(w >> (16 * k))));
}
template <>
__device__ __forceinline__ float unpack<int8_t>(uint32_t w, int k) {
  return static_cast<float>(static_cast<int8_t>((w >> (8 * k)) & 0xffu));
}

// N elements of T at p (N * sizeof(T) bytes, aligned to that size or to
// 16) into f32: one vector load per 16 bytes, each element converted once.
template <typename T, int N>
__device__ __forceinline__ void load_f(const T* p, float* out) {
  constexpr int SZ = static_cast<int>(sizeof(T));
  constexpr int B = N * SZ;
  constexpr int PER = SZ < 4 ? 4 / SZ : 1;          // elements per word
  if constexpr (B > 16) {
#pragma unroll
    for (int k = 0; k < B / 16; ++k)
      load_f<T, 16 / SZ>(p + k * (16 / SZ), out + k * (16 / SZ));
  } else {
    uint32_t w[B >= 4 ? B / 4 : 1];
    if constexpr (B == 16) {
      const uint4 u = *reinterpret_cast<const uint4*>(p);
      w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
    } else if constexpr (B == 8) {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      w[0] = u.x; w[1] = u.y;
    } else if constexpr (B == 4) {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    } else if constexpr (B == 2) {
      w[0] = *reinterpret_cast<const uint16_t*>(p);
    } else {
      w[0] = *reinterpret_cast<const uint8_t*>(p);
    }
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = unpack<T>(w[i / PER], i % PER);
  }
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid.
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float weight(float m, float mx) {
  return m <= 0.5f * NEG_INF ? 0.f : expf(m - mx);
}

// Scores of this lane's key j = lane % KT of a staged K tile `kd` (rows
// RS bytes apart) against the QMAX rows of q_s ((QMAX, HD) f32): lane j
// of a key group takes DP dims of hd, and the PARTS groups sum by warp
// shuffles, so every lane of key j ends with its QMAX full dot products.
template <typename T, int HD>
__device__ __forceinline__ void tile_scores(const unsigned char* kd,
                                            const float* q_s, int lane,
                                            float (&sc)[QMAX]) {
  using S = Shape<T, HD>;
  const int j = lane % S::KT;
  const int prt = lane / S::KT;
#pragma unroll
  for (int r = 0; r < QMAX; ++r) sc[r] = 0.f;
  const T* krow = reinterpret_cast<const T*>(kd + j * S::RS) + prt * S::DP;
  const float* qp = q_s + prt * S::DP;
#pragma unroll
  for (int c = 0; c < S::DP; c += S::VE) {
    float kv[S::VE];
    load_f<T, S::VE>(krow + c, kv);
#pragma unroll
    for (int r = 0; r < QMAX; ++r) {
#pragma unroll
      for (int e = 0; e < S::VE; e += 4) {
        const float4 qv =
            *reinterpret_cast<const float4*>(qp + r * HD + c + e);
        sc[r] = fmaf(qv.x, kv[e], sc[r]);
        sc[r] = fmaf(qv.y, kv[e + 1], sc[r]);
        sc[r] = fmaf(qv.z, kv[e + 2], sc[r]);
        sc[r] = fmaf(qv.w, kv[e + 3], sc[r]);
      }
    }
  }
#pragma unroll
  for (int off = S::KT; off < 32; off <<= 1)
#pragma unroll
    for (int r = 0; r < QMAX; ++r)
      sc[r] += __shfl_xor_sync(FULL, sc[r], off);
}

// Fold one staged tile into the online-softmax state of QMAX rows.
// s: this lane's key's scores, scaled, capped and masked (NEG_INF: the
// row does not see the key); vsc: its V row scale (1 unless int8), folded
// into p; vd: the staged V tile; nj: keys staged in it.  m, l: running
// max and this lane's keys' sum (summed over the key group at the end);
// acc: this lane's HDL dims of the (QMAX, HD) numerator.  The max over
// the tile is uniform across the warp.  p_s (KT, QMAX) is the warp's
// scratch; it is free again when this returns.
template <typename T, int HD>
__device__ __forceinline__ void tile_fold(
    const unsigned char* vd, float* p_s, int nj, float vsc, int lane,
    const float (&s)[QMAX], float (&m)[QMAX], float (&l)[QMAX],
    float (&acc)[QMAX][Shape<T, HD>::HDL]) {
  using S = Shape<T, HD>;
  constexpr int KT = S::KT;
  const int j = lane % KT;
  const int d0 = lane * S::HDL;
  float alpha[QMAX], p[QMAX];
#pragma unroll
  for (int r = 0; r < QMAX; ++r) {
    float tm = s[r];
#pragma unroll
    for (int off = 1; off < KT; off <<= 1)
      tm = fmaxf(tm, __shfl_xor_sync(FULL, tm, off));
    const float mn = fmaxf(m[r], tm);
    alpha[r] = weight(m[r], mn);
    p[r] = weight(s[r], mn);
    l[r] = l[r] * alpha[r] + p[r];
    m[r] = mn;
  }
  if (lane < KT) {                    // v's row scale folds into p
    float4* pw = reinterpret_cast<float4*>(p_s + j * QMAX);
    pw[0] = make_float4(p[0] * vsc, p[1] * vsc, p[2] * vsc, p[3] * vsc);
    pw[1] = make_float4(p[4] * vsc, p[5] * vsc, p[6] * vsc, p[7] * vsc);
  }
  __syncwarp();

  if (d0 < HD) {
#pragma unroll
    for (int r = 0; r < QMAX; ++r)
#pragma unroll
      for (int i = 0; i < S::HDL; ++i) acc[r][i] *= alpha[r];
#pragma unroll 4
    for (int jj = 0; jj < nj; ++jj) {
      float vv[S::HDL];
      load_f<T, S::HDL>(reinterpret_cast<const T*>(vd + jj * S::RS) + d0,
                        vv);
      const float4* pr = reinterpret_cast<const float4*>(p_s + jj * QMAX);
      const float4 pa = pr[0], pb = pr[1];
      const float pv[QMAX] = {pa.x, pa.y, pa.z, pa.w,
                              pb.x, pb.y, pb.z, pb.w};
#pragma unroll
      for (int r = 0; r < QMAX; ++r)
#pragma unroll
        for (int i = 0; i < S::HDL; ++i)
          acc[r][i] = fmaf(pv[r], vv[i], acc[r][i]);
    }
  }
  __syncwarp();                       // p_s and the V tile free for reuse
}

// One block: fold keys [kbeg, kend) of row `row` (split `split` of
// n_split) for nq <= QMAX of its R query rows, rows [r0, r0 + nq), into
// the block's partial, or into the output when n_split == 1.
// zero_scores: the row sees no key, so every key counts with score 0.
// row_of(t): row index of key t in the pools (and in the scale pools).
// qh, out_h: the block's (nq, HD) query rows and output; part: the
// scratch, R partial rows per (row, split).
template <typename T, int HD, bool QUANT, typename RowOf>
__device__ __forceinline__ void fold(
    const float* __restrict__ qh, const T* __restrict__ kp,
    const T* __restrict__ vp, const __half* __restrict__ ks,
    const __half* __restrict__ vs, RowOf row_of, int kbeg, int kend,
    bool zero_scores, int nq, float scale, float cap,
    float* __restrict__ out_h, float* __restrict__ part, int row,
    int split, int n_split, int R, int r0) {
  using S = Shape<T, HD>;
  constexpr int KT = S::KT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // where this block's partial rows go: (rows, n_split, R, HD) then
  // (rows, n_split, R, 2); computed where they are written, so nothing
  // of it stays live across the walk
  auto part_row = [&]() {
    return (static_cast<size_t>(row) * n_split + split) * R + r0;
  };
  auto part_ml = [&]() {
    return part + static_cast<size_t>(gridDim.x) * n_split * R * HD;
  };

  if (kbeg >= kend) {                 // nothing of this row in this split
    if (n_split > 1) {
      float* ml = part_ml();
      const size_t pidx = part_row();
      for (int r = tid; r < nq; r += THREADS) {
        ml[(pidx + r) * 2] = NEG_INF;
        ml[(pidx + r) * 2 + 1] = 0.f;
      }
    } else {
      for (int i = tid; i < nq * HD; i += THREADS) out_h[i] = 0.f;
    }
    return;
  }

  float* q_s = reinterpret_cast<float*>(smem);     // (QMAX, HD), zero rows
  unsigned char* wbase = smem + QMAX * HD * 4 + warp * S::WARP_SMEM;
  float* p_s = reinterpret_cast<float*>(wbase + 2 * S::STAGE);  // (KT, QMAX)

  const int n_tiles = (kend - kbeg + KT - 1) / KT;
  const int j = lane % KT;            // this lane's key in a tile (q . k)
  const int d0 = lane * S::HDL;       // this lane's dims of acc (p . v)

  // Stage tile `tile` into buffer `st`; returns this lane's key's scales.
  auto stage = [&](int tile, int st, float& ksc, float& vsc) {
    const int t0 = kbeg + tile * KT;
    const bool mine = t0 + j < kend;
    const long long my_row = mine ? static_cast<long long>(row_of(t0 + j))
                                  : 0;
    if (QUANT) {
      ksc = mine ? __half2float(ks[my_row]) : 0.f;
      vsc = mine ? __half2float(vs[my_row]) : 0.f;
    }
    unsigned char* kd = wbase + st * S::STAGE;
    unsigned char* vd = kd + KT * S::RS;
    const unsigned char* kg = reinterpret_cast<const unsigned char*>(kp);
    const unsigned char* vg = reinterpret_cast<const unsigned char*>(vp);
#pragma unroll
    for (int i0 = 0; i0 < KT * S::CPR; i0 += 32) {
      const int i = i0 + lane;
      const int r = i < KT * S::CPR ? i / S::CPR : 0;
      const long long rr = __shfl_sync(FULL, my_row, r);
      if (i < KT * S::CPR) {
        const int c = i - r * S::CPR;
        const bool ok = t0 + r < kend;
        const size_t off = ok ? static_cast<size_t>(rr) * S::ROW + c * 16 : 0;
        cp16(kd + r * S::RS + c * 16, kg + off, ok);
        cp16(vd + r * S::RS + c * 16, vg + off, ok);
      }
    }
    cp_commit();
  };

  float m[QMAX], l[QMAX], acc[QMAX][S::HDL];
#pragma unroll
  for (int r = 0; r < QMAX; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < S::HDL; ++i) acc[r][i] = 0.f;
  }
  float ks_cur = 1.f, vs_cur = 1.f, ks_nxt = 1.f, vs_nxt = 1.f;
  if (warp < n_tiles) stage(warp, 0, ks_cur, vs_cur);  // first tile in
  for (int i = tid; i < QMAX * HD; i += THREADS)      //   flight under q
    q_s[i] = i < nq * HD ? qh[i] : 0.f;
  __syncthreads();                    // q_s is in place
  int it = 0;
  for (int tile = warp; tile < n_tiles; tile += WARPS, ++it) {
    const int st = it & 1;
    if (tile + WARPS < n_tiles) stage(tile + WARPS, st ^ 1, ks_nxt, vs_nxt);
    else cp_commit();                 // an empty group keeps the count
    cp_wait<1>();
    __syncwarp();
    const unsigned char* kd = wbase + st * S::STAGE;
    const unsigned char* vd = kd + KT * S::RS;
    const int t0 = kbeg + tile * KT;

    float sc[QMAX];
    tile_scores<T, HD>(kd, q_s, lane, sc);
    const bool vis = t0 + j < kend;
    const float f = (QUANT ? ks_cur : 1.f) * scale;
#pragma unroll
    for (int r = 0; r < QMAX; ++r) {
      float s = sc[r] * f;
      if (cap > 0.f) s = cap * tanhf(s / cap);
      if (zero_scores) s = 0.f;
      sc[r] = vis ? s : NEG_INF;
    }
    tile_fold<T, HD>(vd, p_s, min(KT, kend - t0), QUANT ? vs_cur : 1.f,
                     lane, sc, m, l, acc);
    ks_cur = ks_nxt;
    vs_cur = vs_nxt;
  }
  cp_wait<0>();
#pragma unroll
  for (int r = 0; r < QMAX; ++r)
#pragma unroll
    for (int off = 1; off < KT; off <<= 1)
      l[r] += __shfl_xor_sync(FULL, l[r], off);

  // merge the warps, in warp order, through each warp's stage area
  float* wm = reinterpret_cast<float*>(wbase);     // m (QMAX), l (QMAX),
  __syncwarp();                                    //   acc (QMAX, HD)
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < QMAX; ++r) {
      wm[r] = m[r];
      wm[QMAX + r] = l[r];
    }
  }
  if (d0 < HD) {
#pragma unroll
    for (int r = 0; r < QMAX; ++r)
#pragma unroll
      for (int i = 0; i < S::HDL; ++i)
        wm[2 * QMAX + r * HD + d0 + i] = acc[r][i];
  }
  __syncthreads();
  float* ml = part_ml();
  const size_t pidx = part_row();
  for (int i = tid; i < nq * HD; i += THREADS) {
    const int r = i / HD;
    const int d = i - r * HD;
    const float* w0 = reinterpret_cast<const float*>(smem + QMAX * HD * 4);
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w)
      mx = fmaxf(mx, w0[w * (S::WARP_SMEM / 4) + r]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float* ww = w0 + w * (S::WARP_SMEM / 4);
      const float e = weight(ww[r], mx);
      if (e != 0.f) {
        L += ww[QMAX + r] * e;
        A += ww[2 * QMAX + r * HD + d] * e;
      }
    }
    if (n_split == 1) {
      out_h[i] = A / fmaxf(L, 1e-30f);
    } else {
      part[(pidx + r) * HD + d] = A;
      if (d == 0) {
        ml[(pidx + r) * 2] = mx;
        ml[(pidx + r) * 2 + 1] = L;
      }
    }
  }
}

// Grid (rows, R): fold each grid row's n_split partials in split order.
// A grid row is one (lane, kv head) of a (b, G) layout with R partial
// rows; partial row r = j * qpk + p is query head p of window position j,
// written to the output's (b, R / qpk, G, qpk, HD) row, which is the
// (rows, qpk, HD) layout when R == qpk.  The splits' (m, l) and weights
// go to shared memory first, so each thread's walk over the splits starts
// its loads without waiting on them.  Partials with no key (m = NEG_INF)
// are skipped, never multiplied.
__global__ void __launch_bounds__(128)
merge_kernel(const float* __restrict__ part, float* __restrict__ out,
             int R, int HD, int n_split, int G, int QPK) {
  __shared__ float w_s[MAX_SPLITS];
  __shared__ float l_s[MAX_SPLITS];
  __shared__ float red[4];
  const int row = blockIdx.x;
  const int r = blockIdx.y;
  const int tid = threadIdx.x;
  const size_t n_part = static_cast<size_t>(gridDim.x) * n_split * R;
  const float* ml = part + n_part * HD;
  const size_t p0 = static_cast<size_t>(row) * n_split * R + r;
  float mx = NEG_INF;
  for (int s = tid; s < n_split; s += 128) {
    const size_t pi = p0 + static_cast<size_t>(s) * R;
    w_s[s] = ml[pi * 2];
    l_s[s] = ml[pi * 2 + 1];
    mx = fmaxf(mx, w_s[s]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
  if ((tid & 31) == 0) red[tid >> 5] = mx;
  __syncthreads();
  mx = fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]));
  for (int s = tid; s < n_split; s += 128) w_s[s] = weight(w_s[s], mx);
  __syncthreads();
  float L = 0.f;
  for (int s = 0; s < n_split; ++s)
    if (w_s[s] != 0.f) L += l_s[s] * w_s[s];
  const float inv_l = 1.f / fmaxf(L, 1e-30f);
  const int b = row / G;
  const int j = r / QPK;
  const size_t orow =
      ((static_cast<size_t>(b) * (R / QPK) + j) * G + (row - b * G)) * QPK +
      (r - j * QPK);
  for (int d = tid; d < HD; d += 128) {
    float A = 0.f;
    const float* pd = part + p0 * HD + d;
#pragma unroll 8
    for (int s = 0; s < n_split; ++s) {
      const float e = w_s[s];
      const float pv = pd[static_cast<size_t>(s) * R * HD];
      A += e != 0.f ? pv * e : 0.f;
    }
    out[orow * HD + d] = A * inv_l;
  }
}

// Launch a fold kernel on `grid` ((rows, n_split, ...), `threads` threads,
// `smem` bytes of dynamic shared memory) and, when n_split > 1, the merge
// of its R partial rows per grid row into `out` (G, qpk: the output's
// layout, as merge_kernel).  `limit` is the caller's per-instantiation
// opt-in, 0 before its first launch: every first launch sets it.
template <typename Kernel, typename... Args>
int launch_grid(Kernel kern, dim3 grid, int threads, int smem, int& limit,
                int R, int G, int qpk, int hd, float* part, float* out,
                cudaStream_t st, Args... args) {
  if (smem > limit) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    limit = smem;
  }
  kern<<<grid, threads, smem, st>>>(args...);
  cudaError_t e = cudaGetLastError();
  const int n_split = static_cast<int>(grid.y);
  if (e != cudaSuccess || n_split == 1) return static_cast<int>(e);
  merge_kernel<<<dim3(grid.x, R), 128, 0, st>>>(part, out, R, hd, n_split,
                                                G, qpk);
  return static_cast<int>(cudaGetLastError());
}

// The one-token kernels: grid (rows, n_split, ceil(qpk / QMAX)) of
// THREADS threads, qpk partial rows per grid row.
template <typename T, int HD, typename Kernel, typename... Args>
int launch(Kernel kern, int rows, int n_split, int qpk, float* part,
           float* out, cudaStream_t st, Args... args) {
  static int limit = 0;               // the opt-in is set on first use
  return launch_grid(kern, dim3(rows, n_split, (qpk + QMAX - 1) / QMAX),
                     THREADS, Shape<T, HD>::SMEM, limit, qpk, 1, qpk, HD,
                     part, out, st, args...);
}

// Dispatch a runtime head dim onto the instantiated ones.
template <template <int> class Fn, typename... Args>
int by_hd(int hd, Args... args) {
  switch (hd) {
    case 16: return Fn<16>::run(args...);
    case 32: return Fn<32>::run(args...);
    case 64: return Fn<64>::run(args...);
    case 112: return Fn<112>::run(args...);
    case 128: return Fn<128>::run(args...);
    case 256: return Fn<256>::run(args...);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace split
