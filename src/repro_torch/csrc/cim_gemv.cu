// cim_gemv: x @ W with W packed INT4 or INT8 and f16 per-(group, column)
// scales, dequantized in registers, f32 accumulation.
//
// Replaces the Pallas TPU kernel src/repro/kernels/cim_gemv.py:cim_gemv
// and serves every packed projection of the decode path (q/k/v/o,
// w_down) plus the packed tied logits head, which the JAX package sends
// through XLA (ref_qmatmul_fused).
//
// What bounds it on an H100: bytes, and close behind them the CUDA cores.
// At decode M (4 rows) each weight byte feeds 2 * M * (2 for INT4)
// flops: qwen2.5-3b's 181 calls of one decode step take 11.7 GFLOP
// (0.175 ms at 67 TFLOP/s of f32) against 0.78 GB (0.232 ms at 3.35
// TB/s), and turning nibbles into f32 adds two instructions per weight.
// Tensor cores would buy nothing at that M and are not used; they matter
// from M >= 16 (verify windows, prefill chunks), a later design's work.
//
// The design:
//   1. The weight streams in 16-byte pieces.  Each block copies its whole
//      slice of the packed weight into shared memory with 16-byte
//      cp.async.cg (4-byte cp.async.ca in a second instantiation of the
//      same kernel, for weights whose base or row stride is not 16-byte
//      aligned), in memory order, in STEPS commit groups, and computes on
//      each group as it lands.  x and the scales go first, in their own
//      4-byte cp.async group, so they do not queue behind the weight.  In
//      flight per SM: two (K/2, N) slices of 23-81 KB, or a table tile of
//      64 KB, against the ~25 KB that 3.35 TB/s x ~1 us of latency / 132
//      SMs asks for.
//   2. Nibbles and bytes become f32 without I2F: PRMT puts the byte under
//      a 0x4B exponent, FADD removes 2^23 + bias (qgemv.cuh); exact.
//   3. x is staged in shared memory (f32) once per block and M tile.  In
//      the (K/2, N) layout a block holds a 64-column tile: thread (rl, ct)
//      owns 8 columns of row-lane rl's contiguous K range, and the 8 lanes
//      of a row-lane read the same x, so the reads broadcast.  Row-lane
//      strides are odd (in 64-byte rows and in floats) so the 4 row-lanes
//      of a warp hit distinct banks.  The M tile MT (1, 2 or 4 rows,
//      chosen by the host plan from M) is a template: M = 4 keeps exactly
//      four rows of accumulators.  For M > MT a block loops over M tiles
//      on the weight slice it already holds in shared memory, the next
//      tile's x landing in a second buffer: the weight is read from HBM
//      once per call.  Within a row-lane, runs of rows that stay inside
//      one scale group go without a per-row test.
//   4. The tied (V, K/2) table: one persistent block of 8 warps per SM
//      stages x for the whole K once (32 KB at M = 4) and walks tiles of
//      64 vocab rows (64 KB of INT4 table at K = 2048), the next tile's
//      copies in flight in a second buffer while this one is computed.
//      A warp owns 8 rows and its lanes split K into 16-byte
//      chunks; each x value read from shared memory feeds the 8 rows, so
//      shared-memory traffic is 32/8 = 4 bytes per weight byte at M = 4
//      (13.4 TB/s at full HBM rate, under the ~29.6 TB/s the SMs serve).
//      x is stored with its float4 pieces swizzled (piece f at f ^ (f/8 &
//      7)) so the 8 lanes of a phase hit distinct banks.  Each (row,
//      group) scale is read from global memory once, into shared memory;
//      a chunk inside one group runs without a per-element test.
//   5. One launch per call, deterministic.  The (K/2, N) layout splits K
//      across up to 16 blocks per column tile (grid (column tiles,
//      splits)), as many as keep all blocks in one wave of two per SM,
//      and more, up to 32, where a block's slice of W and x would not fit
//      in shared memory (gemma2-27b's w_down, K = 36864: 16 splits at
//      INT4, 32 at INT8 once M > 4).
//      Each block writes its partial to the workspace, then
//      __threadfence() and an atomicAdd on the tile's arrival counter;
//      the block that arrives last sums the partials in split order,
//      writes `out` and resets the counter to 0, so the next call and a
//      CUDA-graph replay find it zeroed.  No float atomics: calls are
//      bitwise repeatable.  The counters belong to one stream: two calls
//      running at once on two streams must not share them.  (A cluster
//      reducing through distributed shared memory was tried: the card
//      could not hold every 8-block cluster of a call at once, and the
//      second wave cost more than the reduction saved.)
//   6. The host plan (kernels/cim_gemv.py: split_plan, stack_plan) reads
//      shapes only: no host sync.  Its constants (TN, LANES, WARPS,
//      MAX_SPLITS, TBL_VB, the M tiles, SMEM_MAX and the shared-memory
//      sizes) mirror the ones here; change both together.
//   7. A stack of E expert weights (E, K/2, N), MoE's experts: the grid
//      gains the expert axis, and block (tile, split, e) runs the (K/2,
//      N) code on expert e's x rows (E, C, K) and weight.  The rows of
//      each expert's capacity C that hold tokens, counts[e], are read on
//      the device: an expert no token chose returns at once, and rows
//      past its count are neither read nor written.  So a decode step
//      reads the bytes of the chosen experts (at most 32 of qwen3-moe's
//      128 a layer at batch 4), not of all E.  Its own arrival counters
//      per (expert, tile).
//
// Any group that divides K works (qwen2.5-3b's w_down has groups of 86):
// each row-lane walks its K range in order with a running position inside
// the group and scales the group's partial sum when the group ends, as
// the reference's grouped contraction does.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "qgemv.cuh"

namespace {

using qgemv::FULL;

constexpr int THREADS = 256;            // (K/2, N) layout: 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int CT = 8;                   // column threads, 8 columns each
constexpr int TN = 8 * CT;              // 64 columns per block
constexpr int CHUNKS = TN / 16;         // 16-byte chunks per row of a tile
constexpr int LANES = THREADS / CT;     // 32 row-lanes, each a K sub-range
constexpr int MAX_SPLITS = 32;          // K splits of a column tile, at most
constexpr int STEPS = 4;                // weight commit groups per block
constexpr int TBL_THREADS = 256;        // table layout: 8 warps
constexpr int TBL_R = 8;                // vocab rows per warp
constexpr int TBL_VB = TBL_R * TBL_THREADS / 32;  // 64 vocab rows a tile,
                                        // at most (fewer for wide rows)
constexpr int SMEM_MAX = 226 * 1024;     // of the H100's 227 KB per block,
                                        // 1 KB left for static shared memory

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// Groups of scales a slice of P stored rows can touch.
__host__ __device__ constexpr int cols_groups(int P, int rpp, int group) {
  return cdiv(P * rpp, group) + 1;
}
// Shared-memory strides of a row-lane's rows: an odd number of 64-byte
// rows (weights) and an odd number of floats (x), so the row-lanes that
// share a warp hit distinct banks.
__host__ __device__ constexpr int cols_wstride(int PL) { return (PL | 1) * TN; }
__host__ __device__ constexpr int cols_xstride(int PL, int rpp) {
  return (PL * rpp) | 1;
}
// Shared memory of a (K/2, N) block of P stored rows: the weight slice,
// x for the slice's logical rows (one M tile; two buffers when M > MT),
// the warps' partials, and the slice's scales.
__host__ __device__ constexpr int cols_smem(int P, int MT, int rpp,
                                            int group, int M) {
  return LANES * cols_wstride(cdiv(P, LANES)) +
         (M > MT ? 2 : 1) * MT * LANES * cols_xstride(cdiv(P, LANES), rpp) * 4 +
         WARPS * MT * TN * 4 + cols_groups(P, rpp, group) * TN * 2;
}
// One table weight buffer: VB rows of KP bytes, +16 B of pad for a
// ragged last chunk, in whole 16-byte units.
__host__ __device__ constexpr int tbl_wbuf(int KP, int VB) {
  return cdiv(VB * KP + 16, 16) * 16;
}
// Shared memory of a table block with nbuf weight buffers of VB rows: the
// weights, their scales, and x for one M tile over K rounded up to 32.
__host__ __device__ constexpr int rows_smem(int KP, int K, int NG, int MT,
                                            int nbuf, int VB) {
  return nbuf * tbl_wbuf(KP, VB) + cdiv(nbuf * VB * NG * 2, 16) * 16 +
         MT * cdiv(K, 32) * 32 * 4;
}

// (K/2, N) or (K, N) layout, or a stack of E such weights.  Grid: (column
// tiles of TN, splits of P stored rows, E).  Thread (rl, ct) owns columns
// 8 ct .. 8 ct + 7 of the tile for row-lane rl, which walks stored rows
// [rl * PL, (rl + 1) * PL) of the slice, PL = ceil(rows / LANES).  The
// weight comes in 16-byte chunks in memory order, STEPS commit groups of
// row rounds, each group read after a barrier.  A stack (counts not
// null): block (tile, split, e) computes rows [0, min(counts[e], M)) of
// expert e's (M, K) x against its weight; an expert with no row returns at
// once, and x rows past the count are neither read nor written.  M sizes
// the layout (shared memory, workspace) either way.
template <int BITS, int MT, int VEC>
__global__ void __launch_bounds__(THREADS)
cols_kernel(const float* __restrict__ x, const uint8_t* __restrict__ w,
            const __half* __restrict__ scales, float* __restrict__ out,
            float* __restrict__ part, int* __restrict__ counters,
            const int* __restrict__ counts, int M, int K, int N, int group,
            int P) {
  constexpr int RPP = BITS == 4 ? 2 : 1;   // logical rows per stored row
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int is_last;
  const int e = blockIdx.z;                // expert (0 for one weight)
  const int ME = counts != nullptr ? min(counts[e], M) : M;  // rows to do
  if (ME <= 0) return;
  {
    const int KP_ = K / RPP;
    const int tiles = gridDim.x;
    x += static_cast<size_t>(e) * M * K;
    w += static_cast<size_t>(e) * KP_ * N;
    scales += static_cast<size_t>(e) * (K / group) * N;
    out += static_cast<size_t>(e) * M * N;
    if (part != nullptr)
      part += static_cast<size_t>(e) * gridDim.y * M * N;
    counters += e * tiles;
  }
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ct = tid % CT;
  const int rl = tid / CT;
  const int tile = blockIdx.x;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int KP = K / RPP;
  const int p0 = split * P;
  const int rows = max(0, min(P, KP - p0));  // stored rows of the slice
  const int KL = rows * RPP;               // logical rows of the slice
  const int PL = cdiv(rows, LANES);
  const int RG = cdiv(PL, STEPS);          // rounds per commit group
  const int WS = cols_wstride(PL);         // bytes per row-lane
  const int XS = cols_xstride(PL, RPP);    // floats per row-lane
  const int lane_beg = rl * PL;
  const int lane_end = min(rows, lane_beg + PL);
  const int col = tile * TN + 8 * ct;
  const bool col_ok = col < N;

  const int PLP = cdiv(P, LANES);          // the layout's room (>= PL)
  unsigned char* w_s = smem;
  float* x_s = reinterpret_cast<float*>(smem + LANES * cols_wstride(PLP));
  float* red = x_s + (M > MT ? 2 : 1) * MT * LANES *
                         cols_xstride(PLP, RPP);  // (WARPS, MT, TN)
  __half* s_s = reinterpret_cast<__half*>(red + WARPS * MT * TN);
  const int g0 = p0 * RPP / group;         // first group of the slice
  const int ng = KL > 0 ? (p0 * RPP + KL - 1) / group - g0 + 1 : 0;

  // x of M tile m0 into x buffer b, row-lane by row-lane, by 4-byte
  // cp.async: the first tile's ahead of the slice's copies, each next
  // tile's while this one is computed (two buffers when M > MT)
  const int XB = MT * LANES * cols_xstride(PLP, RPP);  // floats per buffer
  auto stage_x = [&](int m0, int b) {
    float* xb = x_s + b * XB;
    for (int i = tid; i < MT * KL; i += THREADS) {
      const int m = i / KL;
      const int kk = i - m * KL;
      const int r = kk / (PL * RPP);
      float* d = xb + m * LANES * XS + r * XS + (kk - r * PL * RPP);
      if (m0 + m < ME)
        qgemv::cp4(d, x + static_cast<size_t>(m0 + m) * K + p0 * RPP + kk);
      else
        *d = 0.f;
    }
  };
  // first commit group: x of the first M tile and the slice's scales
  // (columns 2 t, 2 t + 1 of each of its groups, t < TN / 2)
  stage_x(0, 0);
  if (tid < TN / 2 && tile * TN + 2 * tid < N)
    for (int gg = 0; gg < ng; ++gg)
      qgemv::cp4(s_s + gg * TN + 2 * tid,
                 scales + static_cast<size_t>(g0 + gg) * N + tile * TN +
                     2 * tid);
  qgemv::cp_commit();
  // then the slice in STEPS groups of row rounds: round i is row
  // rl * PL + i of every row-lane, whose 16-byte chunks go to consecutive
  // threads
  for (int g = 0; g < STEPS; ++g) {
    const int n_i = max(0, min(PL, (g + 1) * RG) - g * RG);
    for (int idx = tid; idx < n_i * LANES * CHUNKS; idx += THREADS) {
      const int ch = idx % CHUNKS;
      const int r = (idx / CHUNKS) % LANES;
      const int i = g * RG + idx / (CHUNKS * LANES);
      const int p = r * PL + i;
      const int cb = tile * TN + 16 * ch;  // first column of the chunk
      if (p < min(rows, (r + 1) * PL) && cb < N)
        qgemv::copy_chunk<VEC>(w_s + r * WS + i * TN + 16 * ch,
                               w + static_cast<size_t>(p0 + p) * N + cb,
                               N - cb);
    }
    qgemv::cp_commit();
  }

  for (int m0 = 0, t = 0; m0 < ME; m0 += MT, ++t) {
    if (t > 0) {
      qgemv::cp_wait<0>();                 // this tile's x is in, and
      __syncthreads();                     //   the last tile's is read
      if (m0 + MT < ME) {
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
    const bool mine = col_ok && lane_beg < lane_end;
    const int n_lrows = (lane_end - lane_beg) * RPP;  // logical rows
    const int k_base = (p0 + lane_beg) * RPP;
    int gi = k_base / group;
    int nb = (gi + 1) * group - k_base;    // local row where gi ends
    bool open = false;                     // psum holds unscaled sums
    float s[8];
    auto load_scales = [&]() {
      const __half* sp = s_s + (gi - g0) * TN + 8 * ct;
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j] = __half2float(sp[j]);
    };
    auto flush = [&]() {                   // the group ends: scale it in
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
    const unsigned char* wl = w_s + rl * WS + 8 * ct;
    // one logical row l (stored row l / RPP, half h) into psum
    auto row = [&](uint2 raw, int h, int l) {
      const uint32_t wd[2] = {raw.x, raw.y};
      uint32_t pw[2];
#pragma unroll
      for (int u = 0; u < 2; ++u)
        pw[u] = BITS == 4 ? (h ? qgemv::hi_nibbles(wd[u])
                               : qgemv::lo_nibbles(wd[u]))
                          : wd[u] ^ qgemv::INT8_FLIP;
      float q[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) q[j] = qgemv::qv<BITS>(pw[j >> 2], j & 3);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float xv = xl[m * LANES * XS + l];
#pragma unroll
        for (int j = 0; j < 8; ++j) psum[m][j] = fmaf(xv, q[j], psum[m][j]);
      }
    };
    for (int g = 0; g < STEPS; ++g) {
      if (t == 0) {                        // group g (and x, scales) in
        qgemv::cp_wait_dyn(STEPS - 1 - g);
        __syncthreads();
      }
      if (!mine) continue;
      if (g == 0) load_scales();
      // this group's logical rows, in runs that stay inside one scale
      // group: whole stored rows without a check where the run is even
      int l = g * RG * RPP;
      const int le = min(n_lrows, (g + 1) * RG * RPP);
      while (l < le) {
        const int seg = min(le, nb);
        if (RPP == 1 || ((l | seg) & 1) == 0) {
#pragma unroll 2
          for (int i = l / RPP; i < seg / RPP; ++i) {
            const uint2 raw = *reinterpret_cast<const uint2*>(wl + i * TN);
#pragma unroll
            for (int h = 0; h < RPP; ++h) row(raw, h, i * RPP + h);
          }
        } else {
          for (int r = l; r < seg; ++r)
            row(*reinterpret_cast<const uint2*>(wl + (r / RPP) * TN),
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
    if (mine && open) flush();             // the range ended inside a group
    if (t == 0 && MT < ME) {               // the next tile's x, under the
      stage_x(MT, 1);                      //   reduction of this one
      qgemv::cp_commit();
    }

    // the 4 row-lanes of a warp (lanes 8 apart): (0 + 1) + (2 + 3), every
    // lane holding the same sums (a + b == b + a in IEEE f32); then the
    // warps in order into the block's partial
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[m][j] += __shfl_xor_sync(FULL, acc[m][j], 8);
        acc[m][j] += __shfl_xor_sync(FULL, acc[m][j], 16);
      }
    if (lane < CT) {
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        float4* r4 = reinterpret_cast<float4*>(red + (warp * MT + m) * TN +
                                               8 * ct);
        r4[0] = make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
        r4[1] = make_float4(acc[m][4], acc[m][5], acc[m][6], acc[m][7]);
      }
    }
    __syncthreads();
    // the block's partial goes to `out` (one split) or to its split's
    // slot of the workspace
    for (int i = tid; i < MT * TN; i += THREADS) {
      const int m = i / TN;
      const int n = tile * TN + (i - m * TN);
      if (m0 + m < ME && n < N) {
        float v = red[i];
#pragma unroll
        for (int wv = 1; wv < WARPS; ++wv) v += red[wv * MT * TN + i];
        const size_t o = static_cast<size_t>(m0 + m) * N + n;
        if (splits > 1)
          part[static_cast<size_t>(split) * M * N + o] = v;
        else
          out[o] = v;
      }
    }
  }
  if (splits == 1) return;

  // the last block of this column tile to arrive sums the splits, in
  // split order, and leaves the tile's counter at zero for the next call
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(counters + tile, 1) == splits - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const int cols = min(TN, N - tile * TN);
  const size_t MN = static_cast<size_t>(M) * N;
  for (int i = tid; i < ME * cols; i += THREADS) {
    const int m = i / cols;
    const size_t o = static_cast<size_t>(m) * N + tile * TN + (i - m * cols);
    float t[MAX_SPLITS];
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r)   // every load in flight at once
      t[r] = r < splits ? __ldcg(part + r * MN + o) : 0.f;
    float v = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r)
      if (r < splits) v += t[r];
    out[o] = v;
  }
  if (tid == 0) counters[tile] = 0;
}

// float index of x[k] in a swizzled shared-memory row: float4 piece f
// sits at f ^ ((f >> 3) & 7), so lanes reading piece j of consecutive
// 16-byte weight chunks hit distinct banks.
__device__ __forceinline__ int xswz(int k) {
  const int f = k >> 2;
  return ((f ^ ((f >> 3) & 7)) << 2) | (k & 3);
}

// (V, K/2) or (V, K) tied-table layout: out[m, v] = sum_k x[m, k] W[v, k].
// Persistent: grid = min(vocab tiles, SMs); block b takes tiles b, b +
// gridDim.x, ... of VB rows (64; 32, 16 or 8 where 64 rows of a wide
// table do not fit shared memory: gemma2-27b's INT8 table, 4608 B a row).
// Warp wp computes rows r0 = 8 wp .. + 7 of a tile, the warps past VB / 8
// only copy; lane l takes their 16-byte chunks l, l + 32, ...  With nbuf =
// 2 the next tile's weight lands in the second buffer while this one is
// computed; x (one M tile) is staged once per block when M <= MT, else
// once per tile and M tile.  A row's sum does not depend on VB.
template <int BITS, int MT, int VEC>
__global__ void __launch_bounds__(TBL_THREADS)
rows_kernel(const float* __restrict__ x, const uint8_t* __restrict__ w,
            const __half* __restrict__ scales, float* __restrict__ out,
            int M, int K, int V, int group, int nbuf, int VB) {
  constexpr int RPP = BITS == 4 ? 2 : 1;
  constexpr int EPW = 4 * RPP;             // logical k per 32-bit word
  constexpr int EPC = 4 * EPW;             // logical k per 16-byte chunk
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r0 = (tid >> 5) * TBL_R;       // first row of this warp
  const int KP = K / RPP;                  // bytes per stored row
  const int CPR = cdiv(KP, 16);            // chunks per row
  const int NI = cdiv(CPR, 32);            // chunks per lane
  const int NG = K / group;
  const int KS = cdiv(K, 32) * 32;
  const int n_tiles = cdiv(V, VB);
  const int wbuf = tbl_wbuf(KP, VB);
  const bool one_mtile = M <= MT;
  const bool computes = r0 < VB;           // warp-uniform

  unsigned char* w_s = smem;                         // nbuf weight buffers
  __half* s_s = reinterpret_cast<__half*>(smem + nbuf * wbuf);
  float* x_s = reinterpret_cast<float*>(
      smem + nbuf * wbuf + cdiv(nbuf * VB * NG * 2, 16) * 16);

  // tile t's weight and its scales into buffer b, one commit group, read
  // after the next barrier.  Thread i copies 16-byte chunks i, i + 256,
  // ... of the tile in memory order, so the block's copies in flight at
  // any moment cover one contiguous stretch of the table.
  auto fetch = [&](int t, int b) {
    const int v0 = t * VB;
    unsigned char* wb = w_s + b * wbuf;
    const int n_rows = min(VB, V - v0);
    for (int i = tid; i < n_rows * CPR; i += TBL_THREADS) {
      const int r = i / CPR;
      const int ch = i - r * CPR;
      qgemv::copy_chunk<VEC>(
          wb + r * KP + 16 * ch,
          w + static_cast<size_t>(v0 + r) * KP + 16 * ch, KP - 16 * ch);
    }
    // the tile's scales: (rows, NG) f16, contiguous, in 4-byte pieces;
    // a 2-byte tail (an odd count of halves) is read plainly
    __half* sb = s_s + b * VB * NG;
    const int nh = min(VB, V - v0) * NG;
    const __half* sg = scales + static_cast<size_t>(v0) * NG;
    for (int i = 2 * tid; i + 1 < nh; i += 2 * TBL_THREADS)
      qgemv::cp4(sb + i, sg + i);
    if ((nh & 1) && tid == 0) sb[nh - 1] = sg[nh - 1];
    qgemv::cp_commit();
  };
  // x of M tile m0, swizzled: by 4-byte cp.async (its own commit group)
  // when it is staged once, else by plain loads, 8 in flight per thread
  auto stage_x = [&](int m0, bool async) {
    if (async) {
      for (int i = tid; i < MT * KS; i += TBL_THREADS) {
        const int m = i / KS;
        const int k = i - m * KS;
        float* d = x_s + m * KS + xswz(k);
        if (m0 + m < M && k < K)
          qgemv::cp4(d, x + static_cast<size_t>(m0 + m) * K + k);
        else
          *d = 0.f;
      }
      qgemv::cp_commit();
      return;
    }
    for (int i0 = tid; i0 < MT * KS; i0 += 8 * TBL_THREADS) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = i0 + u * TBL_THREADS;
        const int m = i / KS;
        const int k = i - m * KS;
        v[u] = i < MT * KS && m0 + m < M && k < K
            ? __ldg(x + static_cast<size_t>(m0 + m) * K + k) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = i0 + u * TBL_THREADS;
        if (i < MT * KS) x_s[(i / KS) * KS + xswz(i % KS)] = v[u];
      }
    }
  };

  int t = blockIdx.x;
  if (one_mtile) stage_x(0, true);         // ahead of the first tile
  fetch(t, 0);
  for (int it = 0; t < n_tiles; ++it, t += gridDim.x) {
    const int b = nbuf == 2 ? (it & 1) : 0;
    const int tn = t + gridDim.x;
    if (nbuf == 2) {
      if (tn < n_tiles) fetch(tn, b ^ 1);
      else qgemv::cp_commit();             // an empty group keeps the count
      qgemv::cp_wait<1>();
    } else {
      qgemv::cp_wait<0>();
    }
    __syncthreads();                       // tile t's scales (and x) are in
    const unsigned char* wb = w_s + b * wbuf;
    const __half* sb = s_s + b * VB * NG;
    const int v0 = t * VB;

    for (int m0 = 0; m0 < M; m0 += MT) {
      if (!one_mtile) {
        if (m0 > 0) __syncthreads();       // the last M tile's x is read
        stage_x(m0, false);
        __syncthreads();
      }
      if (!computes) continue;
      float acc[TBL_R][MT];
#pragma unroll
      for (int r = 0; r < TBL_R; ++r)
#pragma unroll
        for (int m = 0; m < MT; ++m) acc[r][m] = 0.f;

      for (int i = 0; i < NI; ++i) {
        const int ch = lane + 32 * i;
        if (ch >= CPR) break;
        const int k0 = ch * EPC;
        int gi = k0 / group;
        int bnd = (gi + 1) * group - k0;   // chunk element where it ends
        uint4 wr[TBL_R];                   // 16-byte reads: no bank conflict
#pragma unroll
        for (int r = 0; r < TBL_R; ++r)
          wr[r] = *reinterpret_cast<const uint4*>(wb + (r0 + r) * KP + 16 * ch);
        float psum[TBL_R][MT];
#pragma unroll
        for (int r = 0; r < TBL_R; ++r)
#pragma unroll
          for (int m = 0; m < MT; ++m) psum[r][m] = 0.f;
        auto flush = [&]() {
          const int gs = min(gi, NG - 1);  // past K x is 0: any scale
#pragma unroll
          for (int r = 0; r < TBL_R; ++r) {
            const float sc = __half2float(sb[(r0 + r) * NG + gs]);
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              acc[r][m] = fmaf(psum[r][m], sc, acc[r][m]);
              psum[r][m] = 0.f;
            }
          }
        };
        // the chunk's 4 words; CHECK: a group may end inside the chunk
        // (the fast body, for chunks inside one group, has no such test)
        auto words = [&](auto check) {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            // x for this word's EPW logical k, every row of the M tile
            float xv[MT][EPW];
#pragma unroll
            for (int m = 0; m < MT; ++m)
#pragma unroll
              for (int pc = 0; pc < EPW / 4; ++pc) {
                const float4 q4 = *reinterpret_cast<const float4*>(
                    x_s + m * KS + xswz(k0 + u * EPW + 4 * pc));
                xv[m][4 * pc] = q4.x;
                xv[m][4 * pc + 1] = q4.y;
                xv[m][4 * pc + 2] = q4.z;
                xv[m][4 * pc + 3] = q4.w;
              }
            uint32_t pl[TBL_R], ph[TBL_R];
#pragma unroll
            for (int r = 0; r < TBL_R; ++r) {
              const uint32_t wd = u == 0 ? wr[r].x : u == 1 ? wr[r].y
                                : u == 2 ? wr[r].z : wr[r].w;
              if (BITS == 4) {
                pl[r] = qgemv::lo_nibbles(wd);
                ph[r] = qgemv::hi_nibbles(wd);
              } else {
                pl[r] = ph[r] = wd ^ qgemv::INT8_FLIP;
              }
            }
#pragma unroll
            for (int e = 0; e < EPW; ++e) {
              if (decltype(check)::value && u * EPW + e == bnd) {
                flush();
                ++gi;
                bnd += group;
              }
#pragma unroll
              for (int r = 0; r < TBL_R; ++r) {
                // INT4: element e is byte e / 2, nibble e % 2; INT8: byte e
                const float q = BITS == 4
                    ? qgemv::qv<4>((e & 1) ? ph[r] : pl[r], e >> 1)
                    : qgemv::qv<8>(pl[r], e);
#pragma unroll
                for (int m = 0; m < MT; ++m)
                  psum[r][m] = fmaf(xv[m][e], q, psum[r][m]);
              }
            }
          }
        };
        if (bnd >= EPC)
          words(std::false_type());
        else
          words(std::true_type());
        flush();
      }

      // sum the 32 lanes (butterfly: a fixed order, so repeatable)
#pragma unroll
      for (int r = 0; r < TBL_R; ++r)
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          float a = acc[r][m];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            a += __shfl_xor_sync(FULL, a, off);
          acc[r][m] = a;
        }
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < TBL_R; ++r) {
          const int v = v0 + r0 + r;
#pragma unroll
          for (int m = 0; m < MT; ++m)
            if (v < V && m0 + m < M)
              out[static_cast<size_t>(m0 + m) * V + v] = acc[r][m];
        }
      }
    }
    __syncthreads();                       // buffer b and its scales are read
    if (nbuf == 1 && tn < n_tiles) fetch(tn, 0);
  }
  qgemv::cp_wait<0>();
}

// Refuse what does not fit; raise an instantiation's dynamic
// shared-memory limit to what a launch asks for, when it asks for more.
template <typename Kern>
int smem_ok(Kern kern, int smem, int& limit) {
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > limit) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    limit = smem;
  }
  return 0;
}

template <int BITS, int MT, int VEC>
int run_cols(const float* x, const uint8_t* w, const __half* s, float* out,
             float* part, int* counters, const int* counts, int M, int K,
             int N, int group, int P, int splits, int experts,
             cudaStream_t st) {
  static int limit = 0;                   // the opt-in is set on first use
  auto kern = cols_kernel<BITS, MT, VEC>;
  const int smem = cols_smem(P, MT, BITS == 4 ? 2 : 1, group, M);
  int err = smem_ok(kern, smem, limit);
  if (err) return err;
  kern<<<dim3(cdiv(N, TN), splits, experts), THREADS, smem, st>>>(
      x, w, s, out, part, counters, counts, M, K, N, group, P);
  return static_cast<int>(cudaGetLastError());
}

template <int BITS, int MT, int VEC>
int run_rows(const float* x, const uint8_t* w, const __half* s, float* out,
             int M, int K, int V, int group, int blocks, int vb,
             cudaStream_t st) {
  static int limit = 0;                   // the opt-in is set on first use
  auto kern = rows_kernel<BITS, MT, VEC>;
  const int KP = K / (BITS == 4 ? 2 : 1);
  // two weight buffers when they fit, so the next tile loads under this
  const int nbuf =
      rows_smem(KP, K, K / group, MT, 2, vb) <= SMEM_MAX ? 2 : 1;
  const int smem = rows_smem(KP, K, K / group, MT, nbuf, vb);
  int err = smem_ok(kern, smem, limit);
  if (err) return err;
  kern<<<blocks, TBL_THREADS, smem, st>>>(x, w, s, out, M, K, V, group, nbuf,
                                          vb);
  return static_cast<int>(cudaGetLastError());
}

// Dispatch runtime (bits, mt, vec) onto the instantiated kernels.
template <template <int, int, int> class Fn, typename... Args>
int dispatch(int bits, int mt, int vec, Args... args) {
#define CIM_CASE(B, T, W)                                  \
  if (bits == B && mt == T && vec == W) return Fn<B, T, W>::run(args...);
  CIM_CASE(4, 1, 16) CIM_CASE(4, 2, 16) CIM_CASE(4, 4, 16)
  CIM_CASE(4, 1, 4) CIM_CASE(4, 2, 4) CIM_CASE(4, 4, 4)
  CIM_CASE(8, 1, 16) CIM_CASE(8, 2, 16) CIM_CASE(8, 4, 16)
  CIM_CASE(8, 1, 4) CIM_CASE(8, 2, 4) CIM_CASE(8, 4, 4)
#undef CIM_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int B, int T, int W>
struct ColsFn {
  template <typename... Args>
  static int run(Args... args) { return run_cols<B, T, W>(args...); }
};
template <int B, int T, int W>
struct RowsFn {
  template <typename... Args>
  static int run(Args... args) { return run_rows<B, T, W>(args...); }
};

}  // namespace

extern "C" {

const char* cim_gemv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (E, M, K) f32; w (E, K/2, N) uint8 [bits 4] or (E, K, N) int8;
// scales (E, K/group, N) f16, 4-byte aligned; out (E, M, N) f32; part
// (E, splits, M, N) f32 when splits > 1; counters: one int per (expert,
// column tile), zero on entry and left zero; counts: null for one weight
// (E = 1), else (E,) int32 rows of x to compute per expert, read on the
// device.  mt: the M tile (1, 2, 4); splits: 1 to 32; rows_per_split:
// stored rows per block; vec: 16 when w's base and N are 16-byte aligned,
// else 4.  Requires N % 4 == 0.
int cim_gemv_cols(const void* x, const void* w, const void* scales,
                  void* out, void* part, void* counters, const void* counts,
                  int M, int K, int N, int bits, int group, int mt,
                  int splits, int rows_per_split, int vec, int experts,
                  void* stream) {
  if (rows_per_split <= 0 || splits <= 0 || splits > MAX_SPLITS ||
      experts <= 0 || experts > 65535 || (experts > 1 && counts == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<ColsFn>(
      bits, mt, vec, static_cast<const float*>(x),
      static_cast<const uint8_t*>(w), static_cast<const __half*>(scales),
      static_cast<float*>(out), static_cast<float*>(part),
      static_cast<int*>(counters), static_cast<const int*>(counts), M, K, N,
      group, rows_per_split, splits, experts,
      static_cast<cudaStream_t>(stream));
}

// x (M, K) f32; w (V, K/2) uint8 [bits 4] or (V, K) int8; scales
// (V, K/group) f16; out (M, V) f32.  vec: 16 when w's base and row
// length are 16-byte aligned, else 4 (the row length a multiple of 4);
// vb: vocab rows a tile, 8, 16, 32 or 64; blocks: the persistent grid,
// at most ceil(V / vb).
int cim_gemv_rows(const void* x, const void* w, const void* scales,
                  void* out, int M, int K, int V, int bits, int group,
                  int mt, int vec, int blocks, int vb, void* stream) {
  if (vb < TBL_R || vb > TBL_VB || vb % TBL_R || (vb & (vb - 1)) ||
      blocks <= 0 || blocks > cdiv(V, vb))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<RowsFn>(
      bits, mt, vec, static_cast<const float*>(x),
      static_cast<const uint8_t*>(w), static_cast<const __half*>(scales),
      static_cast<float*>(out), M, K, V, group, blocks, vb,
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
