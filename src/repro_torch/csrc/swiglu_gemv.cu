// swiglu_qgemv: silu(x @ Wg) * (x @ Wu) with Wg and Wu packed INT4 or
// INT8 (f16 per-(group, column) scales), both streamed over one K loop
// into two f32 accumulators.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/swiglu_gemv.py:swiglu_qgemv (reached from the dense
// FFN's fused SwiGLU).
//
// What bounds it on an H100: bytes (the gate and up weights, ~23 MB per
// qwen2.5-3b layer at INT4, against 4*M flops per packed byte).  The
// design follows cim_gemv's (K/2, N) path: each thread owns 4 columns of
// both matrices and up to BM rows of x, so each packed byte of Wg and Wu
// is read once per M-tile with coalesced 32-bit loads; K is split across
// the 4 warps of a block and across blocks to cover the 132 SMs.  Gate
// and up never reach device memory at full size: the split partials are
// a small L2-resident workspace, and the second pass sums them in a
// fixed order and applies g * sigmoid(g) * u.  Groups need not be powers
// of two; the per-group partial sum is scaled when its group ends.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "packed.cuh"

namespace {

using packed::COLS;
using packed::load_scales;
using packed::qval;

constexpr int WARPS = 4;
constexpr int TILE_N = 32 * COLS;
constexpr int BM = 4;                    // two accumulator sets: keep BM small
constexpr int UNROLL = 4;
static_assert(TILE_N == WARPS * 32, "reduction maps one thread per column");

// Grid: (M tiles, F tiles, K splits).  part: (splits, 2, M, F).
template <int BITS>
__global__ void __launch_bounds__(WARPS * 32)
swiglu_kernel(const float* __restrict__ x, const uint8_t* __restrict__ wg,
              const __half* __restrict__ sg, const uint8_t* __restrict__ wu,
              const __half* __restrict__ su, float* __restrict__ part,
              int M, int K, int F, int group, int rows_per_split) {
  __shared__ float red[2][WARPS][BM][TILE_N];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int m0 = blockIdx.x * BM;
  const int c0 = blockIdx.y * TILE_N + lane * COLS;
  const int split = blockIdx.z;
  const int KP = BITS == 4 ? K / 2 : K;
  const int RPP = BITS == 4 ? 2 : 1;
  const int mc = min(BM, M - m0);

  const int p_begin = split * rows_per_split;
  const int p_end = min(KP, p_begin + rows_per_split);
  const int per_warp = (p_end - p_begin + WARPS - 1) / WARPS;
  const int wp0 = p_begin + warp * per_warp;
  const int wp1 = min(p_end, wp0 + per_warp);

  float acc_g[BM][COLS], acc_u[BM][COLS], ps_g[BM][COLS], ps_u[BM][COLS];
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int j = 0; j < COLS; ++j)
      acc_g[m][j] = acc_u[m][j] = ps_g[m][j] = ps_u[m][j] = 0.f;

  if (c0 < F && wp0 < wp1) {
    const int k_end = wp1 * RPP;
    int k = wp0 * RPP;
    int gi = k / group;
    int rem = k - gi * group;
    float s_g[COLS], s_u[COLS];
    load_scales(sg, gi, F, c0, s_g);
    load_scales(su, gi, F, c0, s_u);
    for (int p = wp0; p < wp1; p += UNROLL) {
      uint32_t w_g[UNROLL], w_u[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const size_t off = static_cast<size_t>(p + u) * F + c0;
        const bool ok = p + u < wp1;
        w_g[u] = ok ? __ldg(reinterpret_cast<const uint32_t*>(wg + off)) : 0u;
        w_u[u] = ok ? __ldg(reinterpret_cast<const uint32_t*>(wu + off)) : 0u;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (p + u < wp1) {
#pragma unroll
          for (int h = 0; h < RPP; ++h) {
            const int kk = (p + u) * RPP + h;
            float qg[COLS], qu[COLS];
#pragma unroll
            for (int j = 0; j < COLS; ++j) {
              qg[j] = qval<BITS>(w_g[u], j, h);
              qu[j] = qval<BITS>(w_u[u], j, h);
            }
#pragma unroll
            for (int m = 0; m < BM; ++m) {
              if (m < mc) {
                const float xv =
                    __ldg(x + static_cast<size_t>(m0 + m) * K + kk);
#pragma unroll
                for (int j = 0; j < COLS; ++j) {
                  ps_g[m][j] = fmaf(xv, qg[j], ps_g[m][j]);
                  ps_u[m][j] = fmaf(xv, qu[j], ps_u[m][j]);
                }
              }
            }
            if (++rem == group) {
#pragma unroll
              for (int m = 0; m < BM; ++m)
#pragma unroll
                for (int j = 0; j < COLS; ++j) {
                  acc_g[m][j] = fmaf(ps_g[m][j], s_g[j], acc_g[m][j]);
                  acc_u[m][j] = fmaf(ps_u[m][j], s_u[j], acc_u[m][j]);
                  ps_g[m][j] = ps_u[m][j] = 0.f;
                }
              rem = 0;
              ++gi;
              if (kk + 1 < k_end) {
                load_scales(sg, gi, F, c0, s_g);
                load_scales(su, gi, F, c0, s_u);
              }
            }
          }
        }
      }
    }
    if (rem != 0) {
#pragma unroll
      for (int m = 0; m < BM; ++m)
#pragma unroll
        for (int j = 0; j < COLS; ++j) {
          acc_g[m][j] = fmaf(ps_g[m][j], s_g[j], acc_g[m][j]);
          acc_u[m][j] = fmaf(ps_u[m][j], s_u[j], acc_u[m][j]);
        }
    }
  }

#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      red[0][warp][m][lane * COLS + j] = acc_g[m][j];
      red[1][warp][m][lane * COLS + j] = acc_u[m][j];
    }
  __syncthreads();
  const int col = blockIdx.y * TILE_N + threadIdx.x;
  if (col < F) {
    for (int m = 0; m < mc; ++m) {
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        float sum = 0.f;
#pragma unroll
        for (int wv = 0; wv < WARPS; ++wv) sum += red[t][wv][m][threadIdx.x];
        part[((static_cast<size_t>(split) * 2 + t) * M + m0 + m) * F + col] = sum;
      }
    }
  }
}

// out[i] = g * sigmoid(g) * u with g, u summed over the splits in order.
__global__ void epilogue_kernel(const float* __restrict__ part,
                                float* __restrict__ out, int MF, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MF) return;
  float g = 0.f, u = 0.f;
  for (int s = 0; s < splits; ++s) {
    g += part[(static_cast<size_t>(s) * 2) * MF + i];
    u += part[(static_cast<size_t>(s) * 2 + 1) * MF + i];
  }
  out[i] = g * (1.f / (1.f + expf(-g))) * u;
}

}  // namespace

extern "C" {

const char* swiglu_gemv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (M, K) f32; wg, wu (K/2, F) uint8 [bits 4] or (K, F) int8; sg, su
// (K/group, F) f16; out (M, F) f32; work (splits, 2, M, F) f32.
// Requires F % 4 == 0.
int swiglu_qgemv(const void* x, const void* wg, const void* sg,
                 const void* wu, const void* su, void* out, void* work,
                 int M, int K, int F, int bits, int group, int splits,
                 int rows_per_split, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((M + BM - 1) / BM, (F + TILE_N - 1) / TILE_N, splits);
  const float* xf = static_cast<const float*>(x);
  const uint8_t* g8 = static_cast<const uint8_t*>(wg);
  const uint8_t* u8 = static_cast<const uint8_t*>(wu);
  const __half* gs = static_cast<const __half*>(sg);
  const __half* us = static_cast<const __half*>(su);
  float* part = static_cast<float*>(work);
  if (bits == 4) {
    swiglu_kernel<4><<<grid, WARPS * 32, 0, st>>>(xf, g8, gs, u8, us, part,
                                                  M, K, F, group, rows_per_split);
  } else {
    swiglu_kernel<8><<<grid, WARPS * 32, 0, st>>>(xf, g8, gs, u8, us, part,
                                                  M, K, F, group, rows_per_split);
  }
  const int MF = M * F;
  epilogue_kernel<<<(MF + 255) / 256, 256, 0, st>>>(
      part, static_cast<float*>(out), MF, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
