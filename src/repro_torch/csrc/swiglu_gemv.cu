// swiglu_qgemv: silu(x @ Wg) * (x @ Wu) with Wg and Wu packed INT4 or
// INT8 (f16 per-(group, column) scales), dequantized in registers, f32
// accumulation, the SiLU * mul epilogue applied to the f32 sums of the
// whole K.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/swiglu_gemv.py:swiglu_qgemv (reached from the dense
// FFN's fused SwiGLU), on the loaders of qgemv.cuh and in the shape of
// cim_gemv.cu's (K/2, N) kernel.
//
// What bounds it on an H100: the CUDA cores' issue rate, then each
// block's fixed chain.  One decode step of qwen2.5-3b (36 calls, M = 4)
// streams 0.84 GB of packed gate and up weights and scales (0.252 ms at
// 3.35 TB/s) into 1.62 G weights, and at M = 4 each weight costs about 7
// instructions (a byte permute and a subtraction to make it f32, four
// FFMAs, its share of the shared-memory loads): ~0.34-0.39 ms of issue
// on 132 SMs at 1.98-1.755 GHz (computed), above the byte bound.  At M = 20
// (a verify step) the four FFMAs become twenty and the conversion repeats
// for each M tile of 4.  Every block also pays a chain of latencies that
// no weight byte needs: x and the first weight rows arriving, the warps'
// reduction, the partials' fence and arrival counter, the last block's
// sum.  Tensor cores are not used.
//
// The design:
//   1. Gate and up share one block.  A block holds a 128-column tile of
//      both matrices for a slice of K: each stored row of the tile is 256
//      bytes in shared memory, the 128 gate bytes then the 128 up bytes,
//      and lane ct of warp rl owns 8 of those 256 columns (ct < 16: gate,
//      else up) for row-lane rl's contiguous K range; a warp is one
//      row-lane, 8 per block.  A warp's 8-byte weight reads cover 256
//      contiguous bytes and its x reads broadcast.  Gate and up meet in
//      shared memory when the warps' partials are summed; with one M tile
//      those partials reuse the slice, which is read by then.  The tile
//      width lets qwen2.5-3b's decode call (86 tiles x 3 splits) run as one
//      round of two 105 KB blocks per SM.
//   2. The weight streams in 16-byte pieces with cp.async.cg (4-byte
//      cp.async.ca in a second instantiation, for weights whose base or
//      row of F bytes is not 16-byte aligned), and each warp streams what
//      its own row-lane reads -- its weight rows in STEPS commit groups,
//      AHEAD of them in flight, and before them its x and scales --
//      waiting with cp.async.wait_group and __syncwarp(): no
//      block-wide barrier stands between the copies and the FFMAs, so
//      the warps of a block fall out of step and cover each other's
//      waits.  The slice stays in shared memory for every M tile.
//   3. Nibbles and bytes become f32 without I2F (qgemv.cuh: a byte permute
//      under a 0x4B exponent, then a subtraction; exact).  Within a
//      row-lane, runs of rows inside one scale group go without a per-row
//      test; any group that divides K works.
//   4. x is staged in shared memory (f32, 16-byte copies where aligned)
//      once per block and M tile.  The M tile MT (1, 2 or 4 rows, picked
//      by the host plan from M) is a template.  For M > MT the block loops
//      over M tiles on the slice it already holds, the next tile's x
//      landing in a second buffer while this one is computed: each weight
//      byte is read from HBM once per call at any M.
//   5. One launch per call, deterministic.  K is split across the blocks
//      of a column tile (grid (column tiles, splits)).  Each block writes
//      its gate and up partials to the workspace, then (after a barrier)
//      one thread's __threadfence() and atomicAdd on the tile's arrival
//      counter; the block that arrives last sums the partials in split
//      order, applies g * (1 / (1 + expf(-g))) * u, writes `out` and
//      resets the counter to 0 for the next call (and a CUDA-graph
//      replay).  No float atomics: calls are bitwise repeatable.  The
//      counters belong to one stream.  (Persistent blocks walking (tile,
//      split) items, with the next item's copies under this one's chain,
//      were tried and were no faster.)
//   6. The host plan (kernels/swiglu_gemv.py: split_plan) reads shapes
//      only: no host sync.  Its constants (TN, LANES, WARPS, MAX_SPLITS,
//      the M tiles, SMEM_MAX and the shared-memory size) mirror the ones
//      here; change both together.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "qgemv.cuh"

namespace {

constexpr int THREADS = 256;            // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int TN = 128;                 // columns of each matrix per block
constexpr int VN = 2 * TN;              // gate then up: bytes per stored row
constexpr int CT = VN / 8;              // column threads, 8 columns each
constexpr int CHUNKS = VN / 16;         // 16-byte chunks per stored row
constexpr int LANES = THREADS / CT;     // 8 row-lanes, one per warp
constexpr int MAX_SPLITS = 8;           // K splits of a column tile, at most
constexpr int STEPS = 6;                // weight commit groups per block
constexpr int AHEAD = 2;                // of them in flight at once
constexpr int SMEM_MAX = 226 * 1024;    // of the H100's 227 KB per block,
                                        // 1 KB left for static shared memory
static_assert(CT == 32 && LANES == WARPS, "a warp is one row-lane");

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// x floats per row-lane: a multiple of 4, for 16-byte copies
__host__ __device__ constexpr int xstride(int PL, int rpp) {
  return cdiv(PL * rpp, 4) * 4;
}
// Scale groups a row-lane of PL stored rows can touch.
__host__ __device__ constexpr int lane_groups(int PL, int rpp, int group) {
  return cdiv(PL * rpp, group) + 1;
}
// The warps' partials (WARPS, MT, VN) f32 go into the weight slice when
// there is one M tile (the slice is read by then) and it has the room.
__host__ __device__ constexpr bool red_in_slice(int P, int MT, int M) {
  return M <= MT && WARPS * MT * VN * 4 <= LANES * cdiv(P, LANES) * VN;
}
// Shared memory of a block of P stored rows: the two weight slices, x for
// the slice's logical rows (one M tile; two buffers when M > MT), each
// warp's scales (gate then up per group), and the warps' partials unless
// they fit in the slice.
__host__ __device__ constexpr int smem_bytes(int P, int MT, int rpp,
                                             int group, int M) {
  return LANES * cdiv(P, LANES) * VN +
         (M > MT ? 2 : 1) * MT * LANES * xstride(cdiv(P, LANES), rpp) * 4 +
         WARPS * lane_groups(cdiv(P, LANES), rpp, group) * VN * 2 +
         (red_in_slice(P, MT, M) ? 0 : WARPS * MT * VN * 4);
}

__device__ __forceinline__ float silu_mul(float g, float u) {
  return g * (1.f / (1.f + expf(-g))) * u;
}

// Grid: (column tiles of TN, splits of P stored rows).  Lane ct of warp
// rl owns virtual columns 8 ct .. 8 ct + 7 of the tile (gate for ct <
// 16, up for ct >= 16) for row-lane rl, which walks stored rows [rl * PL,
// (rl + 1) * PL) of the slice, PL = ceil(rows / LANES).
template <int BITS, int MT, int VEC>
__global__ void __launch_bounds__(THREADS, 2)
swiglu_kernel(const float* __restrict__ x, const uint8_t* __restrict__ wg,
              const __half* __restrict__ sg, const uint8_t* __restrict__ wu,
              const __half* __restrict__ su, float* __restrict__ out,
              float* __restrict__ part, int* __restrict__ counters, int M,
              int K, int F, int group, int P) {
  constexpr int RPP = BITS == 4 ? 2 : 1;   // logical rows per stored row
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int is_last;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ct = lane;                     // a warp is one row-lane
  const int rl = warp;
  const int tile = blockIdx.x;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const size_t MF = static_cast<size_t>(M) * F;
  const int p0 = split * P;
  const int rows = max(0, min(P, K / RPP - p0));  // stored rows of the slice
  const int KL = rows * RPP;               // logical rows of the slice
  const int PL = cdiv(rows, LANES);        // stored rows per row-lane
  const int LR = PL * RPP;                 // logical rows per row-lane
  const int RG = cdiv(PL, STEPS);          // rounds per commit group
  const int XS = xstride(PL, RPP);         // floats per row-lane

  const int PLP = cdiv(P, LANES);          // the layout's room (>= PL)
  const int SG = lane_groups(PLP, RPP, group);  // scale groups per warp
  unsigned char* w_s = smem;
  float* x_s = reinterpret_cast<float*>(smem + LANES * PLP * VN);
  const int XB = MT * LANES * xstride(PLP, RPP);  // floats per x buffer
  __half* s_all = reinterpret_cast<__half*>(x_s + (M > MT ? 2 : 1) * XB);
  __half* s_w = s_all + warp * SG * VN;    // this warp's (SG, VN) scales
  float* red = red_in_slice(P, MT, M)      // (WARPS, MT, VN)
      ? reinterpret_cast<float*>(w_s)
      : reinterpret_cast<float*>(s_all + WARPS * SG * VN);
  // the logical rows [kw0, kw1) of this warp's row-lane, their groups
  const int kw0 = p0 * RPP + min(KL, warp * LR);
  const int kw1 = p0 * RPP + min(KL, (warp + 1) * LR);
  const int gw0 = kw0 / group;
  const int ngw = kw1 > kw0 ? (kw1 - 1) / group - gw0 + 1 : 0;

  // Each warp streams what its row-lane reads -- its weight rows, x and
  // scales -- with its own cp.async groups, and waits on them with
  // __syncwarp(): no block-wide barrier until the warps' partials are
  // summed.
  //
  // x of M tile m0 into x buffer b: 16-byte copies where x's rows and the
  // row-lanes' ranges allow, else 4-byte ones.  Rows past M are left
  // unwritten: their sums are never stored.
  const bool xvec = K % 4 == 0 && P * RPP % 4 == 0 && LR % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0;
  auto stage_x = [&](int m0, int b) {
    float* xb = x_s + b * XB;
    const int Q = cdiv(LR, 4);             // 4-float pieces per row-lane
    const int n = min(KL - warp * LR, LR); // the row-lane's logical rows
    for (int idx = lane; idx < MT * Q; idx += 32) {
      const int m = idx / Q;
      const int k = 4 * (idx - m * Q);
      if (m0 + m >= M || k >= n) continue;
      float* d = xb + m * LANES * XS + warp * XS + k;
      const float* src = x + static_cast<size_t>(m0 + m) * K + p0 * RPP +
                         warp * LR + k;
      if (xvec && k + 4 <= n) {
        qgemv::cp16(d, src);
      } else {
        for (int e = 0; e < 4 && k + e < n; ++e) qgemv::cp4(d + e, src + e);
      }
    }
  };
  // The row-lane's weight rows come in STEPS commit groups of row rounds,
  // AHEAD groups in flight: group g is issued when group g - AHEAD is
  // computed (an empty group past the last keeps the count).  The 16-byte
  // chunks of a row (8 of gate, then 8 of up) go to consecutive lanes.
  auto fetch = [&](int g) {
    const int n_i = max(0, min(PL, (g + 1) * RG) - g * RG);
    for (int idx = lane; idx < n_i * CHUNKS; idx += 32) {
      const int ch = idx % CHUNKS;
      const int i = g * RG + idx / CHUNKS;
      const int p = warp * PL + i;
      const int cb = tile * TN + 16 * (ch % (CHUNKS / 2));
      if (p < min(rows, (warp + 1) * PL) && cb < F)
        qgemv::copy_chunk<VEC>(
            w_s + warp * PL * VN + i * VN + 16 * ch,
            (ch < CHUNKS / 2 ? wg : wu) + static_cast<size_t>(p0 + p) * F + cb,
            F - cb);
    }
    qgemv::cp_commit();
  };
  // first commit group: x of the first M tile and the warp's scales
  // (columns 2 c, 2 c + 1 of each of its groups: 64 pieces of gate, 64 of
  // up); then the first AHEAD weight groups
  stage_x(0, 0);
  for (int idx = lane; idx < ngw * TN; idx += 32) {
    const int gg = idx / TN;
    const int c = idx % TN;
    const int c2 = 2 * (c % (TN / 2));
    if (tile * TN + c2 < F)
      qgemv::cp4(s_w + gg * VN + (c / (TN / 2)) * TN + c2,
                 (c < TN / 2 ? sg : su) +
                     static_cast<size_t>(gw0 + gg) * F + tile * TN + c2);
  }
  qgemv::cp_commit();
  for (int g = 0; g < AHEAD; ++g) fetch(g);

  const int lane_beg = rl * PL;
  const int lane_end = min(rows, lane_beg + PL);
  const int col = tile * TN + 8 * (ct % (CT / 2));
  const bool mine = col < F && lane_beg < lane_end;
  const int n_lrows = (lane_end - lane_beg) * RPP;  // logical rows
  const int k_base = (p0 + lane_beg) * RPP;

  for (int m0 = 0, t = 0; m0 < M; m0 += MT, ++t) {
    if (t > 0) {
      qgemv::cp_wait<0>();                 // this tile's x is in, and
      __syncwarp();                        //   the last tile's is read
      if (m0 + MT < M) {
        stage_x(m0 + MT, (t + 1) & 1);
        qgemv::cp_commit();
      }
    }

    float acc[MT][8];
    float psum[MT][8];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[m][j] = psum[m][j] = 0.f;
    int gi = k_base / group;
    int nb = (gi + 1) * group - k_base;  // local row where gi ends
    bool open = false;                   // psum holds unscaled sums
    float s[8];
    auto load_scales = [&]() {
      const __half2* sp = reinterpret_cast<const __half2*>(
          s_w + (gi - gw0) * VN + 8 * ct);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float2 f = __half22float2(sp[u]);
        s[2 * u] = f.x;
        s[2 * u + 1] = f.y;
      }
    };
    auto flush = [&]() {                 // the group ends: scale it in
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[m][j] = fmaf(psum[m][j], s[j], acc[m][j]);
          psum[m][j] = 0.f;
        }
      open = false;
    };
    const float* xl = x_s + (t & 1) * XB + rl * XS;
    const unsigned char* wl = w_s + rl * PL * VN + 8 * ct;
    // the 8 values of logical row half h (INT4) of an 8-byte raw read
    auto values = [&](uint2 raw, int h, float (&q)[8]) {
      const uint32_t wd[2] = {raw.x, raw.y};
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const uint32_t pw = BITS == 4 ? (h ? qgemv::hi_nibbles(wd[u])
                                           : qgemv::lo_nibbles(wd[u]))
                                      : wd[u] ^ qgemv::INT8_FLIP;
#pragma unroll
        for (int j = 0; j < 4; ++j) q[4 * u + j] = qgemv::qv<BITS>(pw, j);
      }
    };
    // one logical row l (stored row l / RPP, half h) into psum
    auto row = [&](uint2 raw, int h, int l) {
      float q[8];
      values(raw, h, q);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float xv = xl[m * LANES * XS + l];
#pragma unroll
        for (int j = 0; j < 8; ++j) psum[m][j] = fmaf(xv, q[j], psum[m][j]);
      }
    };
    // both logical rows of stored INT4 row i, x read as one float2
    auto pair = [&](int i) {
      const uint2 raw = *reinterpret_cast<const uint2*>(wl + i * VN);
      float2 xv[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m)
        xv[m] = *reinterpret_cast<const float2*>(xl + m * LANES * XS + 2 * i);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float q[8];
        values(raw, h, q);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float xh = h ? xv[m].y : xv[m].x;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            psum[m][j] = fmaf(xh, q[j], psum[m][j]);
        }
      }
    };
    for (int g = 0; g < STEPS; ++g) {
      if (t == 0) {                      // group g (and x, scales) in
        fetch(g + AHEAD);
        qgemv::cp_wait<AHEAD>();
        __syncwarp();
      }
      if (!mine) continue;
      if (g == 0) load_scales();
      // this group's logical rows, in runs that stay inside one scale
      // group: whole stored rows without a check where the run is even
      int l = g * RG * RPP;
      const int le = min(n_lrows, (g + 1) * RG * RPP);
      while (l < le) {
        const int seg = min(le, nb);
        if (RPP == 1) {
          for (int i = l; i < seg; ++i)
            row(*reinterpret_cast<const uint2*>(wl + i * VN), 0, i);
        } else if (((l | seg) & 1) == 0) {
          for (int i = l / 2; i < seg / 2; ++i) pair(i);
        } else {
          for (int r = l; r < seg; ++r)
            row(*reinterpret_cast<const uint2*>(wl + (r / RPP) * VN),
                r % RPP, r);
        }
        open = open || seg > l;
        l = seg;
        if (l == nb) {
          flush();
          ++gi;
          nb += group;
          if (l < n_lrows) load_scales();
        }
      }
    }
    if (mine && open) flush();           // the range ended inside a group
    if (t == 0 && MT < M) {              // the next tile's x, under the
      stage_x(MT, 1);                //   reduction of this one
      qgemv::cp_commit();
    }

    // the warps' sums, in warp order
    __syncthreads();                     // the slice and the last partials
#pragma unroll                           //   are read
    for (int m = 0; m < MT; ++m) {
      float4* r4 = reinterpret_cast<float4*>(red + (warp * MT + m) * VN +
                                             8 * ct);
      r4[0] = make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
      r4[1] = make_float4(acc[m][4], acc[m][5], acc[m][6], acc[m][7]);
    }
    __syncthreads();
    // the block's gate and up partials go to the workspace (split s's
    // slots), or, with one split, straight through the epilogue to `out`
    for (int i = tid; i < MT * TN; i += THREADS) {
      const int m = i / TN;
      const int c = i - m * TN;
      const int n = tile * TN + c;
      if (m0 + m < M && n < F) {
        float gv = red[m * VN + c];
        float uv = red[m * VN + TN + c];
#pragma unroll
        for (int wv = 1; wv < WARPS; ++wv) {
          gv += red[(wv * MT + m) * VN + c];
          uv += red[(wv * MT + m) * VN + TN + c];
        }
        const size_t o = static_cast<size_t>(m0 + m) * F + n;
        if (splits > 1) {
          part[2 * split * MF + o] = gv;
          part[(2 * split + 1) * MF + o] = uv;
        } else {
          out[o] = silu_mul(gv, uv);
        }
      }
    }
  }

  if (splits == 1) return;

  // the last block of this column tile to arrive sums the splits, in
  // split order, applies the epilogue, and leaves the tile's counter at
  // zero for the next call
  __syncthreads();                         // every partial of the block is
  if (tid == 0) {                          //   written; one fence releases
    __threadfence();                       //   them all, then the arrival
    is_last = atomicAdd(counters + tile, 1) == splits - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const int cols = min(TN, F - tile * TN);
  for (int i = tid; i < M * cols; i += THREADS) {
    const int m = i / cols;
    const size_t o = static_cast<size_t>(m) * F + tile * TN + (i - m * cols);
    float tg[MAX_SPLITS], tu[MAX_SPLITS];
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) {  // every load in flight at once
      tg[r] = r < splits ? __ldcg(part + 2 * r * MF + o) : 0.f;
      tu[r] = r < splits ? __ldcg(part + (2 * r + 1) * MF + o) : 0.f;
    }
    float gv = 0.f, uv = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r)
      if (r < splits) {
        gv += tg[r];
        uv += tu[r];
      }
    out[o] = silu_mul(gv, uv);
  }
  if (tid == 0) counters[tile] = 0;
}

template <int BITS, int MT, int VEC>
int run(const float* x, const uint8_t* wg, const __half* sg,
        const uint8_t* wu, const __half* su, float* out, float* part,
        int* counters, int M, int K, int F, int group, int P, int splits,
        cudaStream_t st) {
  static int limit = 0;                   // the opt-in is set on first use
  auto kern = swiglu_kernel<BITS, MT, VEC>;
  const int smem = smem_bytes(P, MT, BITS == 4 ? 2 : 1, group, M);
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > limit) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    limit = smem;
  }
  kern<<<dim3(cdiv(F, TN), splits), THREADS, smem, st>>>(
      x, wg, sg, wu, su, out, part, counters, M, K, F, group, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* swiglu_gemv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (M, K) f32; wg, wu (K/2, F) uint8 [bits 4] or (K, F) int8; sg, su
// (K/group, F) f16, 4-byte aligned; out (M, F) f32; part (splits, 2, M,
// F) f32 when splits > 1; counters: one int per column tile, zero on
// entry and left zero.  mt: the M tile (1, 2, 4); splits: 1 to 8;
// rows_per_split: stored rows per split, a multiple of 16; vec: 16 when
// both weights' bases and F are 16-byte aligned, else 4.  Requires
// F % 4 == 0.
int swiglu_qgemv(const void* x, const void* wg, const void* sg,
                 const void* wu, const void* su, void* out, void* part,
                 void* counters, int M, int K, int F, int bits, int group,
                 int mt, int splits, int rows_per_split, int vec,
                 void* stream) {
  if (rows_per_split <= 0 || rows_per_split % LANES || splits <= 0 ||
      splits > MAX_SPLITS)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(x);
  const uint8_t* g8 = static_cast<const uint8_t*>(wg);
  const uint8_t* u8 = static_cast<const uint8_t*>(wu);
  const __half* gs = static_cast<const __half*>(sg);
  const __half* us = static_cast<const __half*>(su);
  float* o = static_cast<float*>(out);
  float* pt = static_cast<float*>(part);
  int* cnt = static_cast<int*>(counters);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SWIGLU_CASE(B, T, W)                                               \
  if (bits == B && mt == T && vec == W)                                    \
    return run<B, T, W>(xf, g8, gs, u8, us, o, pt, cnt, M, K, F, group,    \
                        rows_per_split, splits, st);
  SWIGLU_CASE(4, 1, 16) SWIGLU_CASE(4, 2, 16) SWIGLU_CASE(4, 4, 16)
  SWIGLU_CASE(4, 1, 4) SWIGLU_CASE(4, 2, 4) SWIGLU_CASE(4, 4, 4)
  SWIGLU_CASE(8, 1, 16) SWIGLU_CASE(8, 2, 16) SWIGLU_CASE(8, 4, 16)
  SWIGLU_CASE(8, 1, 4) SWIGLU_CASE(8, 2, 4) SWIGLU_CASE(8, 4, 4)
#undef SWIGLU_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
