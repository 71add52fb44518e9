// Flash attention backward for Hopper (sm_90a): dQ and dK/dV of GQA
// self-attention, with P rebuilt from the forward's lse (FlashAttention-2
// section 3.2), as two kernels that each own their outputs, at every head
// dim of their C entries (flash_bwd.cu, flash_bwd_mid.cu).
//
// Replaces, in gpu_provisioner_tpu/ops/flash_attention.py:
//   - _bwd_dq_kernel (pallas_call in _flash_bwd_impl): flash_bwd_dq,
//     dQ_i = sum_j dS_ij K_j;
//   - _bwd_dkv_kernel: flash_bwd_dkv, dV_j = sum_i P_ij dO_i and
//     dK_j = sum_i dS_ij Q_i.
// with P = exp(S - lse) (0 where masked or on rows that attended nothing)
// and dS = P o (dP - delta) * scale, dP = dO V^T, delta = rowsum(dO o O)
// minus the lse cotangent (computed by the wrapper).
//
// What bounds it on an H100: like the forward, compute. dQ does 6 * D
// operations per attended (query, key) pair and q-head, dK/dV 8 * D, against
// a few bytes per position, thousands of operations per byte at long S.
// The bf16 instances run on the tensor cores through flash_tc.cuh's tile
// steps (wgmma on swizzled bf16 tiles, cp.async rings, one warpgroup a
// block, tc::DQ_TC_BLOCKS and tc::DKV_TC_BLOCKS CTAs an SM: two from
// D = 80 up, one at 256), shared with flash_tri.cuh; the f32 instances are
// f32 FMA from shared memory, the exactness instances. Every instance takes
// head dim 16, 32, 64, 80, 96, 100, 120, 128 or 256 (flash_bwd.cu's C
// entries 16, 32, 64 and 128, flash_bwd_mid.cu's 80 and 96,
// flash_bwd_pad.cu's 100 and 120, flash_bwd_wide.cu's 256; each refuses
// any other D): at 32
// and 16 (the tiny presets' and the fast bench_engine model's heads) the
// bf16 tiles are the D = 64 atom partly filled; at 80 and 96
// (H2O-Danube-1.8B's and Phi-3-mini's heads) D = 128's two atoms, the
// second partly filled: the K-major products (S, dP, S^T, dP^T) take D /
// 16 k-steps (5 or 6) and never read past column D, the register-A
// products (dQ += dS K, dV += P^T dO, dK += dS^T Q) stay D = 128's
// m64n128k16 over the zeroed pad, their columns D.. computed and never
// stored, with D = 128's shared memory and two CTAs an SM (an m64n80/96
// product's MN-major operand is no whole number of 128-byte swizzle
// atoms). At both the pad is zeroed once at the kernel's start
// (wg::zero_pad); the f32 instances take D / 8 columns a lane as at every
// D. At 100 (OpenLLaMA-3B's 32/32 heads) the bf16 instances are 80's and
// 96's, but a row of 200 bytes is no whole number of 16-byte chunks: Q,
// dO, K and V rows are copied in 25 pieces of 8 bytes (wg::load_tile), the
// pad zeroed from column 100 (the upper half of chunk 12 and chunks 13..15,
// never a byte a copy writes), S and dP (S^T and dP^T) take 7 k-steps, the
// last over columns 96..111 of which a quarter is real, and dQ, dK and dV
// are stored cut at column 100 (tc::store_bf16: the next head's columns
// follow in a row); the f32 instances give a lane 13 columns, the 13th
// (96 + lane) lanes 0..3's alone (fa::NCOL, fa::has_col). At 120
// (H2O-Danube3-4B's 32/8 heads) the bf16 instances are 80's and 96's, a
// row exactly 15 chunks: Q, dO, K and V copied as D = 128's 16 chunks a
// row, the 16th, the pad, zero-filled (wg::load_tile; the dK/dV stage's Q
// and dO together, 16 a thread), S and dP (S^T and dP^T) in D = 128's 8
// k-steps, every store 15 whole 8-column groups; the f32 instances 15
// columns a lane. At 256 (Gemma-2B's 8/1 heads) the bf16 instances take S and dP (S^T
// and dP^T) over the whole D in 16 k-steps on four-atom tiles, and split
// the register-A products into column halves of 128, D = 128's m64n128k16
// into its 64 floats (tc::half_at): dQ keeps both halves in one CTA (two
// accumulators beside S and dP: 255 registers, no spill), dK/dV gives each
// half a CTA of its own (tc::out_cols; two a (batch * kv head, key tile),
// side by side in the grid), since dK's and dV's 2 x 128 floats beside
// S^T and dP^T would pass 255 registers; both compute S^T and dP^T whole,
// about 1.5x the tensor work of one CTA (later work). 193 and 194 KB of
// shared memory, one CTA an SM. The f32 dQ at 256 walks
// each 64-key tile as two of 32 keys (DQ_BK), so that its shared memory
// (206 KB) fits the 227 KB a block may have; its f32 dQ and dK/dV hold 128
// accumulator floats a thread (the exactness instances; ptxas's spills are
// in PERF.md). What the design does about the bound is to do only live
// work and no redundant passes:
//   - dQ: one block per (batch * q-head, 64-row query tile) that loops over
//     the live key tiles only (causal frontier, window band:
//     fa::live_keys), the loop-bound counterpart of the TPU's sequential kv
//     grid axis, its `live` gate and its index-map clamps. In bf16 the
//     block's Q and dO tiles are loaded once, K/V come through the ring
//     (tc::kv_walk), tc::dq_tile_tc rebuilds P from lse and dS in
//     registers and rounds dS to bf16 once for dQ += dS K (tc::RectMask);
//     a causal grid starts with the longest query tiles (tc::query_tile). In
//     f32, rows owned as in the forward (flash_common.cuh).
//   - dK/dV: one block per (batch * kv-head, key tile) that loops over the
//     live query tiles only and the group's q-heads. GQA is folded inside
//     the block: the group's contributions add into one f32 accumulator,
//     which replaces the TPU's per-q-head f32 dK/dV arrays and their sum
//     over the group after the kernel. In f32, 32 keys (the FMA dK and dV
//     accumulators of 32 keys x 128 dims are 64 registers a thread), the
//     group outermost; in bf16, 64 keys, one warpgroup on the tensor cores
//     (tc::dkv_walk_tc: S^T and dP^T by wgmma from K-major tiles, P^T and
//     dS^T rounded to bf16 in registers for dV += P^T dO and dK += dS^T Q),
//     the query tiles of the live range (fa::live_queries) descending, the
//     group innermost.
//   - Every output element has one owner block, so there are no atomics and
//     the results are the same run to run.
// The opt-in flattened-triangle kernels _bwd_*_tri compute the same
// function over one flat list of the live causal tiles; their Hopper
// counterparts, a persistent balanced schedule over that list, are in
// flash_tri.cuh and share the tile steps (dq_tile, dkv_tile in
// flash_common.cuh; tc::dq_tile_tc, tc::dkv_tile_tc in flash_tc.cuh) with
// the kernels here. Left for later: warp specialisation with TMA,
// ping-pong consumers, fp8.
#pragma once

#include <type_traits>

#include "flash_tc.cuh"


namespace {

constexpr int DQ_RPT = 4;      // dQ: 16 * 4 = 64 query rows per block
constexpr int DKV_KPT = 2;     // dK/dV: 16 * 2 = 32 keys per block
constexpr int DKV_BQ = 64;     // dK/dV: query tile, 8 lanes x 8 columns

template <int D>
constexpr size_t dq_smem() {   // sQ, sdO [BR][D+1]; sK, sV [BK][D+1]; sdS [BR][BK+1]
  return sizeof(float) * (2 * 16 * DQ_RPT * (D + 1) + 2 * fa::DQ_BK<D> * (D + 1) +
                          16 * DQ_RPT * (fa::DQ_BK<D> + 1));
}

template <int D>
constexpr size_t dkv_smem() {  // sK, sV [BKV][D+1]; sQ, sdO [BQ][D+1]; sP, sdS [BKV][BQ+1]; lse, delta
  return sizeof(float) * (2 * 16 * DKV_KPT * (D + 1) + 2 * DKV_BQ * (D + 1) +
                          2 * 16 * DKV_KPT * (DKV_BQ + 1) + 2 * DKV_BQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(fa::NTHREADS) flash_bwd_dq_kernel(FlashBwdArgs a) {
  constexpr int RPT = DQ_RPT, BR = 16 * RPT, BK = fa::DQ_BK<D>;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + BR * (D + 1);
  float* sK = sdO + BR * (D + 1);
  float* sV = sK + BK * (D + 1);
  float* sdS = sV + BK * (D + 1);

  const int lane_c = threadIdx.x & 7;
  const int rg = threadIdx.x >> 3;
  const int b = blockIdx.x / a.Hq;
  const int h = blockIdx.x % a.Hq;
  const int kvh = h / (a.Hq / a.Hkv);
  const int q0 = blockIdx.y * BR;

  fa::load_rows<T, D>(sQ, BR, static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh, a.q_ss, q0,
                      a.S);
  fa::load_rows<T, D>(sdO, BR, static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh,
                      a.do_ss, q0, a.S);
  const long long rows = ((long long)b * a.Hq + h) * a.S;
  float lse[RPT], delta[RPT], acc[RPT][fa::NCOL<D>];
  int qpos[RPT];
  bool valid[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    qpos[i] = q0 + rg * RPT + i;
    valid[i] = qpos[i] < a.S;
    lse[i] = valid[i] ? a.lse[rows + qpos[i]] : FA_NEG_INF;
    delta[i] = valid[i] ? a.delta[rows + qpos[i]] : 0.f;
#pragma unroll
    for (int c = 0; c < fa::NCOL<D>; ++c) acc[i][c] = 0.f;
  }

  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  const int2 keys = fa::live_keys(q0, min(q0 + BR, a.S) - 1, a.S, a.causal, a.window);
  for (int kv0 = keys.x / BK * BK; kv0 < keys.y; kv0 += BK)
    fa::dq_tile<T, D, RPT, BK>(sQ, sdO, sK, sV, sdS, acc, lse, delta, qpos, valid, kb, vb,
                               a.k_ss, a.v_ss, kv0, a.S, a.causal, a.window, a.scale);

  T* dq = static_cast<T*>(a.dq) + b * a.dq_sb + h * a.dq_sh;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    if (!valid[i]) continue;
    T* o = dq + qpos[i] * a.dq_ss;
#pragma unroll
    for (int c = 0; c < fa::NCOL<D>; ++c) {
      if constexpr (D % 8 == 0)
        fa::from_f32(o + lane_c + 8 * c, acc[i][c]);
      else if (fa::has_col<D>(lane_c, c))
        fa::from_f32(o + lane_c + 8 * c, acc[i][c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(fa::NTHREADS) flash_bwd_dkv_kernel(FlashBwdArgs a) {
  constexpr int KPT = DKV_KPT, BKV = 16 * KPT, BQ = DKV_BQ;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BKV * (D + 1);
  float* sQ = sV + BKV * (D + 1);
  float* sdO = sQ + BQ * (D + 1);
  float* sP = sdO + BQ * (D + 1);
  float* sdS = sP + BKV * (BQ + 1);
  float* sL = sdS + BKV * (BQ + 1);
  float* sDelta = sL + BQ;

  const int lane_c = threadIdx.x & 7;
  const int rg = threadIdx.x >> 3;      // owns keys rg * KPT .. + KPT - 1
  const int b = blockIdx.x / a.Hkv;
  const int kvh = blockIdx.x % a.Hkv;
  const int group = a.Hq / a.Hkv;
  const int k0 = blockIdx.y * BKV;

  fa::load_rows<T, D>(sK, BKV, static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh, a.k_ss,
                      k0, a.S);
  fa::load_rows<T, D>(sV, BKV, static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh, a.v_ss,
                      k0, a.S);
  float dk[KPT][fa::NCOL<D>], dv[KPT][fa::NCOL<D>];
  int kpos[KPT];
#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    kpos[i] = k0 + rg * KPT + i;
#pragma unroll
    for (int c = 0; c < fa::NCOL<D>; ++c) dk[i][c] = dv[i][c] = 0.f;
  }

  const int2 queries = fa::live_queries(k0, min(k0 + BKV, a.S) - 1, a.S, a.causal, a.window);
  for (int g = 0; g < group; ++g) {   // the GQA fold: every q-head of this kv head
    const int h = kvh * group + g;
    const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
    const T* gb = static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh;
    const long long rows = ((long long)b * a.Hq + h) * a.S;
    for (int q0 = queries.x / BQ * BQ; q0 < queries.y; q0 += BQ)
      fa::dkv_tile<T, D, KPT, BQ>(sK, sV, sQ, sdO, sP, sdS, sL, sDelta, dk, dv, kpos, qb, gb,
                                  a.q_ss, a.do_ss, a.lse + rows, a.delta + rows, q0, a.S,
                                  a.causal, a.window, a.scale);
  }

  T* dkb = static_cast<T*>(a.dk) + b * a.dk_sb + kvh * a.dk_sh;
  T* dvb = static_cast<T*>(a.dv) + b * a.dv_sb + kvh * a.dv_sh;
#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    if (kpos[i] >= a.S) continue;
#pragma unroll
    for (int c = 0; c < fa::NCOL<D>; ++c) {
      if constexpr (D % 8 != 0)
        if (!fa::has_col<D>(lane_c, c)) continue;
      fa::from_f32(dkb + kpos[i] * a.dk_ss + lane_c + 8 * c, dk[i][c]);
      fa::from_f32(dvb + kpos[i] * a.dv_ss + lane_c + 8 * c, dv[i][c]);
    }
  }
}

// The bf16 instance: one warpgroup per (batch * kv-head, 64-key tile) on the
// tensor cores, and at D = 256 per column half of it (HALVES), over the
// 64-query tiles that hold the live query range; one tile spans the head
// dim D, dK and dV the CTA's DV columns.
template <int D>
__global__ void __launch_bounds__(wg::THREADS, tc::DKV_TC_BLOCKS<D>)
    flash_bwd_dkv_tc_kernel(FlashBwdArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int E = tc::E;
  constexpr int DV = tc::out_cols<D>;
  constexpr int HALVES = D / DV;
  // below D = 64, and at 80, 96, 100 and 120, the chunks past D of K, V
  // and both Q/dO stages (at 100 from column 100, the upper half of a chunk
  // whose lower half the copies write), published with the walk's first
  // copies (if constexpr: at D = 64 and 128 even the empty loop moved the
  // compiled kernel's registers)
  if constexpr (D % 64 != 0)
    for (int i = 0; i < 6; ++i) wg::zero_pad<D>(tc::tiles() + i * wg::tile_bytes<D>());
  const unsigned bh = HALVES > 1 ? blockIdx.x / HALVES : blockIdx.x;
  const int half = HALVES > 1 ? static_cast<int>(blockIdx.x % HALVES) : 0;
  const int b = bh / a.Hkv;
  const int kvh = bh % a.Hkv;
  const int k0 = blockIdx.y * E;
  const long long rows = static_cast<long long>(b) * a.Hq * a.S;
  const tc::DkvSrc src{static_cast<const bf16*>(a.k) + b * a.k_sb + kvh * a.k_sh,
                       static_cast<const bf16*>(a.v) + b * a.v_sb + kvh * a.v_sh,
                       static_cast<const bf16*>(a.q) + b * a.q_sb,
                       static_cast<const bf16*>(a.dout) + b * a.do_sb,
                       a.lse + rows, a.delta + rows,
                       a.k_ss, a.v_ss, a.q_ss, a.q_sh, a.do_ss, a.do_sh,
                       a.S, a.Hq / a.Hkv, kvh, a.scale};
  constexpr int ACC = tc::acc_floats<D>;
  float dk[ACC], dv[ACC];
#pragma unroll
  for (int e = 0; e < ACC; ++e) dk[e] = dv[e] = 0.f;
  const int2 queries = fa::live_queries(k0, min(k0 + E, a.S) - 1, a.S, a.causal, a.window);
  const int qt1 = (queries.y + E - 1) / E;   // one past the last live query tile
  tc::dkv_walk_tc<D>(dk, dv, tc::tiles(), src, k0, qt1 - 1, qt1 - queries.x / E,
                     tc::RectMask{a.S, a.causal, a.window}, half);
  tc::dkv_store<D>(dk, dv, static_cast<bf16*>(a.dk) + b * a.dk_sb + kvh * a.dk_sh + half * DV,
                   a.dk_ss,
                   static_cast<bf16*>(a.dv) + b * a.dv_sb + kvh * a.dv_sh + half * DV, a.dv_ss,
                   k0, a.S);
}

// The bf16 dQ instance: one warpgroup per (batch * q-head, 64-query tile)
// on the tensor cores, over the tiles that hold the live key range; one
// tile spans the head dim D (at 256 dQ in two column halves of
// accumulator, tc::dq_acc).
template <int D>
__global__ void __launch_bounds__(wg::THREADS, tc::DQ_TC_BLOCKS<D>)
    flash_bwd_dq_tc_kernel(FlashBwdArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int E = tc::E;
  constexpr int TILE = wg::tile_bytes<D>();
  const uint32_t sQ = tc::tiles(), sdO = sQ + TILE, ring = sdO + TILE;
  const int b = blockIdx.x / a.Hq;
  const int h = blockIdx.x % a.Hq;
  const int kvh = h / (a.Hq / a.Hkv);
  const int q0 = tc::query_tile(a.causal) * E;
  wg::load_tile<D>(sQ, static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh, a.q_ss, q0,
                   a.S);
  wg::load_tile<D>(sdO, static_cast<const bf16*>(a.dout) + b * a.do_sb + h * a.do_sh, a.do_ss,
                   q0, a.S);
  // below D = 64, and at 80, 96, 100 and 120, the chunks past D of Q, dO
  // and both K/V stages (at 100 from column 100: never a byte that the Q and dO
  // copies in flight write), published with the first key tile's copies
  if constexpr (D % 64 != 0)
    for (int i = 0; i < 6; ++i) wg::zero_pad<D>(sQ + i * TILE);
  const long long rows = (static_cast<long long>(b) * a.Hq + h) * a.S;
  float lse2[2], delta[2];
  tc::dq_acc<D> acc;
  bool live[2];
  tc::dq_rows(a.lse + rows, a.delta + rows, q0, a.S, lse2, delta, live);
  tc::zero(acc);
  const int2 keys = fa::live_keys(q0, min(q0 + E, a.S) - 1, a.S, a.causal, a.window);
  const tc::RectMask mask{a.S, a.causal, a.window};
  const float sl2 = a.scale * tc::kLog2e;
  tc::kv_walk<D>(ring, static_cast<const bf16*>(a.k) + b * a.k_sb + kvh * a.k_sh,
                 static_cast<const bf16*>(a.v) + b * a.v_sb + kvh * a.v_sh, a.k_ss, a.v_ss, a.S,
                 keys.x / E, (keys.y + E - 1) / E, [](int j) { return j + 1; },
                 [&](uint32_t sK, int j) {
                   tc::dq_tile_tc<D>(acc, sQ, sdO, sK, lse2, delta, live, q0, j * E, sl2,
                                     a.scale, mask);
                 });
  tc::store_dq<D>(acc, static_cast<bf16*>(a.dq) + b * a.dq_sb + h * a.dq_sh, a.dq_ss, q0, a.S);
}

template <typename T, int D>
cudaError_t launch_dq(const FlashBwdArgs& a, cudaStream_t stream) {
  constexpr bool tensor_cores = std::is_same<T, __nv_bfloat16>::value;
  constexpr int BR = tensor_cores ? tc::E : 16 * DQ_RPT;
  void* fn;
  size_t smem;
  if constexpr (tensor_cores) {
    fn = reinterpret_cast<void*>(flash_bwd_dq_tc_kernel<D>);
    smem = tc::dq_tc_smem<D>();
  } else {
    fn = reinterpret_cast<void*>(flash_bwd_dq_kernel<T, D>);
    smem = dq_smem<D>();
  }
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  void* args[] = {const_cast<FlashBwdArgs*>(&a)};
  e = cudaLaunchKernel(fn, dim3(a.B * a.Hq, (a.S + BR - 1) / BR), dim3(fa::NTHREADS), args, smem,
                       stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// The grid flash_bwd_dkv launches: one block per (batch * kv head, tile of
// keys), the tile 64 keys on the tensor cores (bf16) or 16 * DKV_KPT (f32);
// launch_dkv gives each column half of it a block at D = 256 in bf16.
template <typename T>
dim3 dkv_grid(int B, int Hkv, int S) {
  constexpr int edge = std::is_same<T, __nv_bfloat16>::value ? tc::E : 16 * DKV_KPT;
  return dim3(B * Hkv, (S + edge - 1) / edge);
}

template <typename T, int D>
cudaError_t launch_dkv(const FlashBwdArgs& a, cudaStream_t stream) {
  constexpr bool tensor_cores = std::is_same<T, __nv_bfloat16>::value;
  void* fn;
  size_t smem;
  if constexpr (tensor_cores) {
    fn = reinterpret_cast<void*>(flash_bwd_dkv_tc_kernel<D>);
    smem = tc::dkv_tc_smem<D>();
  } else {
    fn = reinterpret_cast<void*>(flash_bwd_dkv_kernel<T, D>);
    smem = dkv_smem<D>();
  }
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  void* args[] = {const_cast<FlashBwdArgs*>(&a)};
  dim3 grid = dkv_grid<T>(a.B, a.Hkv, a.S);
  if constexpr (tensor_cores) grid.x *= D / tc::out_cols<D>;   // at D = 256 a block a half
  e = cudaLaunchKernel(fn, grid, dim3(fa::NTHREADS), args, smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// The dQ (dq) or dK/dV launch at head dim D in the struct's act dtype.
template <int D>
cudaError_t launch_at(bool dq, const FlashBwdArgs& a, cudaStream_t s) {
  if (a.act_dtype == 0) return dq ? launch_dq<float, D>(a, s) : launch_dkv<float, D>(a, s);
  return dq ? launch_dq<__nv_bfloat16, D>(a, s) : launch_dkv<__nv_bfloat16, D>(a, s);
}

// A C entry's body at the head dims Ds its source builds: the dQ (dq) or
// dK/dV launch on `stream`, allocating nothing and not synchronising;
// returns cudaGetLastError() after it (0 on success; cudaErrorInvalidValue
// for a head dim not of Ds, an act dtype other than 0 (f32) or 1 (bf16),
// or a GQA group that does not divide).
template <int... Ds>
int run(bool dq, const FlashBwdArgs* a, void* stream) {
  if (a->S <= 0 || a->B <= 0) return 0;
  if (!((a->D == Ds) || ...) || (a->act_dtype != 0 && a->act_dtype != 1) || a->Hkv <= 0 ||
      a->Hq % a->Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  ((a->D == Ds && (e = launch_at<Ds>(dq, *a, s), true)) || ...);
  return static_cast<int>(e);
}

}  // namespace
