// cim_gemv: x @ W with W packed INT4 or INT8 and f16 per-(group, column)
// scales, dequantized in registers, f32 accumulation.
//
// Replaces the Pallas TPU kernel src/repro/kernels/cim_gemv.py:cim_gemv
// and serves every packed projection of the decode path (q/k/v/o,
// w_down) plus the packed tied logits head, which the JAX package sends
// through XLA (ref_qmatmul_fused).
//
// What bounds it on an H100: bytes.  At decode M (<= max_batch) each
// weight byte feeds 2*M flops, far below the ~20 flops/byte where f32
// CUDA-core math would take over, so the kernel exists to stream the
// packed weight once at full HBM rate.  The design:
//   * the packed weight is read once per M-tile: every thread keeps the
//     partial sums of a tile of up to BM rows of x in registers;
//   * reads are coalesced: in the (K/2, N) layout a warp reads 128
//     consecutive bytes of one packed row (4 columns per thread); in the
//     (V, K/2) tied-table layout a warp owns one vocab row and reads it
//     as consecutive 32-bit words;
//   * enough blocks to cover the 132 SMs: the (K/2, N) layout splits K
//     across the 4 warps of a block and across blocks (grid z); split
//     partials go to a small workspace (L2-resident at decode sizes) and
//     a second pass sums them in a fixed order, so results are
//     deterministic;
//   * any group that divides K works, powers of two or not (qwen2.5-3b's
//     w_down has groups of 86): each warp walks its K range in order with
//     a running position inside the group, multiplying the per-group
//     partial sum by the group's scale when the group ends, as the
//     reference's grouped contraction does.
// It uses no tensor cores: at decode M they would idle behind HBM.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "packed.cuh"

namespace {

using packed::COLS;
using packed::load_scales;
using packed::qval;

constexpr int WARPS = 4;                 // warps per block (cols layout)
constexpr int TILE_N = 32 * COLS;        // columns per block
constexpr int BM = 8;                    // x rows per block (M tile)
constexpr int UNROLL = 4;                // packed rows in flight per warp
constexpr int ROW_WARPS = 8;             // warps per block (rows layout)
static_assert(TILE_N == WARPS * 32, "reduction maps one thread per column");

// (K/2, N) or (K, N) layout.  Grid: (M tiles, N tiles, K splits).
// Writes the split's partial sums to part[split][m][n] (or straight to
// the output when there is one split).
template <int BITS>
__global__ void __launch_bounds__(WARPS * 32)
cols_kernel(const float* __restrict__ x, const uint8_t* __restrict__ w,
            const __half* __restrict__ scales, float* __restrict__ part,
            int M, int K, int N, int group, int rows_per_split) {
  __shared__ float red[WARPS][BM][TILE_N];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int m0 = blockIdx.x * BM;
  const int c0 = blockIdx.y * TILE_N + lane * COLS;
  const int split = blockIdx.z;
  const int KP = BITS == 4 ? K / 2 : K;          // stored rows
  const int RPP = BITS == 4 ? 2 : 1;             // logical rows per stored
  const int mc = min(BM, M - m0);

  const int p_begin = split * rows_per_split;
  const int p_end = min(KP, p_begin + rows_per_split);
  const int per_warp = (p_end - p_begin + WARPS - 1) / WARPS;
  const int wp0 = p_begin + warp * per_warp;
  const int wp1 = min(p_end, wp0 + per_warp);

  float acc[BM][COLS];
  float psum[BM][COLS];
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int j = 0; j < COLS; ++j) acc[m][j] = psum[m][j] = 0.f;

  if (c0 < N && wp0 < wp1) {
    const int k_end = wp1 * RPP;
    int k = wp0 * RPP;
    int gi = k / group;
    int rem = k - gi * group;
    float s[COLS];
    load_scales(scales, gi, N, c0, s);
    for (int p = wp0; p < wp1; p += UNROLL) {
      uint32_t words[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        words[u] = (p + u < wp1)
            ? __ldg(reinterpret_cast<const uint32_t*>(
                  w + static_cast<size_t>(p + u) * N + c0))
            : 0u;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (p + u < wp1) {
#pragma unroll
          for (int h = 0; h < RPP; ++h) {
            const int kk = (p + u) * RPP + h;
            float q[COLS];
#pragma unroll
            for (int j = 0; j < COLS; ++j) q[j] = qval<BITS>(words[u], j, h);
#pragma unroll
            for (int m = 0; m < BM; ++m) {
              if (m < mc) {
                const float xv =
                    __ldg(x + static_cast<size_t>(m0 + m) * K + kk);
#pragma unroll
                for (int j = 0; j < COLS; ++j)
                  psum[m][j] = fmaf(xv, q[j], psum[m][j]);
              }
            }
            if (++rem == group) {          // group ends: apply its scale
#pragma unroll
              for (int m = 0; m < BM; ++m)
#pragma unroll
                for (int j = 0; j < COLS; ++j) {
                  acc[m][j] = fmaf(psum[m][j], s[j], acc[m][j]);
                  psum[m][j] = 0.f;
                }
              rem = 0;
              ++gi;
              if (kk + 1 < k_end) load_scales(scales, gi, N, c0, s);
            }
          }
        }
      }
    }
    if (rem != 0) {                        // range ended inside a group
#pragma unroll
      for (int m = 0; m < BM; ++m)
#pragma unroll
        for (int j = 0; j < COLS; ++j)
          acc[m][j] = fmaf(psum[m][j], s[j], acc[m][j]);
    }
  }

#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int j = 0; j < COLS; ++j) red[warp][m][lane * COLS + j] = acc[m][j];
  __syncthreads();
  const int col = blockIdx.y * TILE_N + threadIdx.x;
  if (col < N) {
    for (int m = 0; m < mc; ++m) {
      float sum = 0.f;
#pragma unroll
      for (int wv = 0; wv < WARPS; ++wv) sum += red[wv][m][threadIdx.x];
      part[(static_cast<size_t>(split) * M + m0 + m) * N + col] = sum;
    }
  }
}

// Sums the split partials in split order: out[i] = sum_s part[s][i].
__global__ void reduce_kernel(const float* __restrict__ part,
                              float* __restrict__ out, int MN, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float sum = 0.f;
  for (int s = 0; s < splits; ++s) sum += part[static_cast<size_t>(s) * MN + i];
  out[i] = sum;
}

// (V, K/2) or (V, K) tied-table layout: out[m, v] = sum_k x[m, k] W[v, k].
// One warp per vocab row, reading it as consecutive 32-bit words.
// Grid: (M tiles, ceil(V / ROW_WARPS)).
template <int BITS>
__global__ void __launch_bounds__(ROW_WARPS * 32)
rows_kernel(const float* __restrict__ x, const uint8_t* __restrict__ w,
            const __half* __restrict__ scales, float* __restrict__ out,
            int M, int K, int V, int group) {
  const int lane = threadIdx.x & 31;
  const int v = blockIdx.y * ROW_WARPS + (threadIdx.x >> 5);
  if (v >= V) return;                      // no block-wide sync below
  const int m0 = blockIdx.x * BM;
  const int mc = min(BM, M - m0);
  const int KP = BITS == 4 ? K / 2 : K;
  constexpr int PER_WORD = BITS == 4 ? 8 : 4;   // logical k per word
  const uint32_t* row =
      reinterpret_cast<const uint32_t*>(w + static_cast<size_t>(v) * KP);
  const __half* srow = scales + static_cast<size_t>(v) * (K / group);

  float acc[BM];
#pragma unroll
  for (int m = 0; m < BM; ++m) acc[m] = 0.f;

  for (int wi = lane; wi < KP / 4; wi += 32) {
    const uint32_t word = __ldg(row + wi);
    const int k0 = wi * PER_WORD;
    float q[PER_WORD];
#pragma unroll
    for (int e = 0; e < PER_WORD; ++e)
      q[e] = BITS == 4 ? qval<4>(word, e >> 1, e & 1) : qval<8>(word, e, 0);
    float xs[BM][PER_WORD];
#pragma unroll
    for (int m = 0; m < BM; ++m) {
      if (m < mc) {
        const float4* xp = reinterpret_cast<const float4*>(
            x + static_cast<size_t>(m0 + m) * K + k0);
#pragma unroll
        for (int c = 0; c < PER_WORD / 4; ++c) {
          const float4 t = __ldg(xp + c);
          xs[m][4 * c] = t.x;
          xs[m][4 * c + 1] = t.y;
          xs[m][4 * c + 2] = t.z;
          xs[m][4 * c + 3] = t.w;
        }
      }
    }
    int gi = k0 / group;
    int rem = k0 - gi * group;
    float s = __half2float(srow[gi]);
    float psum[BM];
#pragma unroll
    for (int m = 0; m < BM; ++m) psum[m] = 0.f;
#pragma unroll
    for (int e = 0; e < PER_WORD; ++e) {
#pragma unroll
      for (int m = 0; m < BM; ++m)
        if (m < mc) psum[m] = fmaf(xs[m][e], q[e], psum[m]);
      const bool group_end = ++rem == group;
      if (group_end || e == PER_WORD - 1) {
#pragma unroll
        for (int m = 0; m < BM; ++m) {
          acc[m] = fmaf(psum[m], s, acc[m]);
          psum[m] = 0.f;
        }
        if (group_end && e < PER_WORD - 1) {
          rem = 0;
          ++gi;
          s = __half2float(srow[gi]);
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < BM; ++m) {
    float a = acc[m];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
    if (lane == 0 && m < mc) out[static_cast<size_t>(m0 + m) * V + v] = a;
  }
}

}  // namespace

extern "C" {

const char* cim_gemv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (M, K) f32; w (K/2, N) uint8 [bits 4] or (K, N) int8; scales
// (K/group, N) f16; out (M, N) f32; work (splits, M, N) f32 when
// splits > 1 (unused otherwise).  Requires N % 4 == 0.
int cim_gemv_cols(const void* x, const void* w, const void* scales,
                  void* out, void* work, int M, int K, int N, int bits,
                  int group, int splits, int rows_per_split, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((M + BM - 1) / BM, (N + TILE_N - 1) / TILE_N, splits);
  float* part = splits > 1 ? static_cast<float*>(work) : static_cast<float*>(out);
  const float* xf = static_cast<const float*>(x);
  const uint8_t* wb = static_cast<const uint8_t*>(w);
  const __half* sh = static_cast<const __half*>(scales);
  if (bits == 4) {
    cols_kernel<4><<<grid, WARPS * 32, 0, st>>>(xf, wb, sh, part, M, K, N,
                                                group, rows_per_split);
  } else {
    cols_kernel<8><<<grid, WARPS * 32, 0, st>>>(xf, wb, sh, part, M, K, N,
                                                group, rows_per_split);
  }
  if (splits > 1) {
    const int MN = M * N;
    reduce_kernel<<<(MN + 255) / 256, 256, 0, st>>>(
        part, static_cast<float*>(out), MN, splits);
  }
  return static_cast<int>(cudaGetLastError());
}

// x (M, K) f32; w (V, K/2) uint8 [bits 4] or (V, K) int8; scales
// (V, K/group) f16; out (M, V) f32.  Requires the stored row length
// (K/2 or K) to be a multiple of 4.
int cim_gemv_rows(const void* x, const void* w, const void* scales,
                  void* out, int M, int K, int V, int bits, int group,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((M + BM - 1) / BM, (V + ROW_WARPS - 1) / ROW_WARPS);
  const float* xf = static_cast<const float*>(x);
  const uint8_t* wb = static_cast<const uint8_t*>(w);
  const __half* sh = static_cast<const __half*>(scales);
  float* o = static_cast<float*>(out);
  if (bits == 4) {
    rows_kernel<4><<<grid, ROW_WARPS * 32, 0, st>>>(xf, wb, sh, o, M, K, V, group);
  } else {
    rows_kernel<8><<<grid, ROW_WARPS * 32, 0, st>>>(xf, wb, sh, o, M, K, V, group);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
