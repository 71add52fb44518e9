// Flash attention forward for Hopper (sm_90a): one kernel for GQA
// self-attention and for fresh queries against a KV cache, every head dim
// of its C entries (flash_fwd.cu, flash_fwd_mid.cu).
//
// Replaces, in gpu_provisioner_tpu/ops/flash_attention.py:
//   - _kernel_resident and _kernel (launched by _flash, behind
//     flash_attention / flash_attention_with_lse): the TPU's VMEM-resident
//     and streaming variants are one function, split only by a VMEM budget;
//   - _kernel_cached (behind flash_attention_cached): the same function with
//     the query block at cache positions start.., a pad floor per row, int8
//     dequantisation with per-token scales, a window and sinks.
// Both layouts go in without a copy: the wrapper passes strides, so the
// token-major [B, S, Hkv, D] K/V of self-attention and the head-major
// [B, Hkv, max_len, D] cache are read in place.
//
// What bounds it on an H100: at long S, self-attention is compute-bound
// (4 * S^2/2 * D * Hq operations against 2 * S * D * Hkv input bytes per
// batch row: thousands of operations per byte, far above the ~295 the card
// needs to leave the memory roofline). Cache prefill at the serving shapes
// (S = 128..512 queries against up to a few thousand cached positions) sits
// near the same line. What the design does about it:
//   - only live work: one block per (batch * q-head, 64-row query tile)
//     loops over the live key tiles only (causal frontier, pad floor,
//     window band plus sinks: fa::window_skips), which replaces the TPU's
//     sequential kv grid axis and its index-map clamps (_causal_kv_index),
//     so dead tiles cost neither compute nor bytes. GQA costs no copy:
//     q-head h reads kv head h / group.
//   - the bf16 instances (bf16 activations; bf16 K/V: self-attention and
//     the bf16 cache; or an int8 cache) run on the tensor cores: one
//     warpgroup per block, its Q tile swizzled once, K/V through
//     flash_tc.cuh's two-stage cp.async ring (tc::ring_walk: the copy of
//     the next live tile, not j + 1 under a window, issued before the
//     products of the current one), tc::fwd_tile_tc's wgmma products with
//     P as bf16 hi + lo, the mask on fragments (tc::CacheMask, a whole-tile
//     test first), out and lse stored from the fragments; 80 KB of shared
//     memory at D = 128, two CTAs an SM. A causal grid starts with the query tiles
//     that have the most key tiles (tc::query_tile), so that the short ones
//     fill the tail.
//   - the int8 cache's bf16 instance copies each key tile as int8 with its
//     64 k and v scales (tc::i8_stage: half the bytes of a bf16 tile) and
//     widens it, exactly (|x| <= 127 has 8 significant bits), into the
//     swizzled bf16 K/V pair the products read (tc::i8_widen); k_scale
//     multiplies score column j on the fragments, v_scale P's column j
//     before the hi + lo split, and the denominator sums the unscaled P
//     (tc::ColScales). No rounding point beyond the bf16 cache's (ROADMAP
//     Queue C 14, 15); 82 KB of shared memory at D = 128, two CTAs an SM.
//   - the f32 instances (the exactness instances, f32 or int8 cache)
//     compute in f32 FMA from shared memory (fa::attend_tiles), int8
//     dequantised per token there.
// Every instance takes head dim 16, 32, 64, 80, 96, 100, 120, 128 or 256
// (flash_fwd.cu's C entry 16, 32, 64 and 128, flash_fwd_mid.cu's 80 and
// 96, flash_fwd_pad.cu's 100 and 120, flash_fwd_wide.cu's 256; each
// refuses any other D). At D = 64 a tensor-core tile is one swizzle atom (8 KB), S = Q
// K^T takes 4 k-steps, O += P V is m64n64k16 into 32 floats a thread;
// shared memory is 41 KB (bf16 cache) or 42 KB (int8 cache), so the D = 64
// instances are built for four CTAs an SM (FWD_TC_BLOCKS: 128 registers a
// thread, no spills; at three, 147 and 168 registers, the fresh prefill at
// (8, 512, 16/8) took ~4% longer on an H100); D = 128 stays at two. At D =
// 32 and 16 (the fast serving models' 8/4 heads of 32, the tiny presets'
// 4/2 of 16) a tile is the D = 64 atom partly filled, its other chunks
// zeroed once at the start (wg::zero_pad): S = Q K^T in 2 or 1 k-steps,
// O += P V still m64n64k16 into D = 64's 32 floats a thread, of which the
// first D columns are stored; shared memory as at D = 64 (the int8 stages
// smaller), four CTAs an SM. At D = 80 and 96 (H2O-Danube-1.8B's 32/8
// heads of 80, Phi-3-mini's 32/32 of 96) a tile is D = 128's two atoms,
// the second partly filled and its pad zeroed once (wg::zero_pad): S = Q
// K^T in 5 or 6 k-steps, O += P V D = 128's m64n128k16 into its 64 floats
// a thread, of which the first D columns are stored; shared memory 80 KB
// (bf16 cache) or 70 / 74 KB (int8 cache), two CTAs an SM. The f32
// instances take every D as they are (8 lanes a row, D / 8 columns each).
// At D = 256 (Gemma-2B's 8/1 heads of 256) a tensor-core CTA owns one half
// of the output's columns (tc::out_cols; two CTAs a (batch * q-head,
// query tile), side by side in the grid, so that the second reads K from
// L2): S = Q K^T over the whole D in 16 k-steps on four-atom tiles, the
// softmax as at every D, O += P V D = 128's m64n128k16 over the half's V
// columns into its 64 floats a thread; half 0 writes lse. Both halves take
// the same k-steps and round P the same way, so m, l and every column are
// what one CTA would give; S and the K bytes are paid twice, about 1.5x
// the work of one CTA (later work). Shared memory 129 KB (bf16 cache) or
// 146 KB (int8: the whole int8 V tile copied, its half widened): one CTA
// an SM.
// At D = 100 (OpenLLaMA-3B's 32/32 heads of 100) a tile is D = 128's two
// atoms as at 80 and 96, but a bf16 row is 200 bytes, no whole number of
// 16-byte chunks: Q, K and V rows are copied in 8-byte pieces
// (wg::load_tile), the pad zeroed from column 100 (wg::zero_pad), S = Q
// K^T in 7 k-steps, O += P V D = 128's, the store cut at column 100
// (tc::store_bf16: the next head's first columns follow in a row); an int8
// row is 100 bytes, copied in 4-byte pieces into stage rows of a 112-byte
// pitch whose pad is zeroed once (tc::i8_stage, tc::i8_zero_pad) and
// widened 13 chunks a row. Shared memory 81 KB (bf16 cache) or 78 KB (int8
// cache), two CTAs an SM. The f32 instances give the thread's 13th column
// (lane + 96) to lanes 0..3 alone (fa::has_col).
// At D = 120 (H2O-Danube3-4B's 32/8 heads of 120) a tile is D = 128's two
// atoms as at 80 and 96, a bf16 row exactly 15 chunks, copied as D = 128's
// 16 with the 16th, the pad, zero-filled (wg::load_tile,
// wg::pad_zero_filled), S = Q K^T in D = 128's 8 k-steps, the store 15
// whole 8-column groups; an int8 row of 120 bytes is copied in 8-byte
// pieces into stage rows of a 128-byte pitch whose pad is zeroed once
// (tc::i8_stage, tc::i8_zero_pad) and widened 16 chunks a row, the last
// from that pad. Shared memory 80 KB
// (bf16 cache) or 82 KB (int8 cache), two CTAs an SM; the f32 instances 15
// columns a lane.
// The persistent causal schedule (one flat list of live tiles in equal
// shares per CTA, the counterpart of the TPU's _kernel_tri) lives in
// flash_tri.cuh, behind triangular=True, on the same tile steps. Left for
// later: warp specialisation with TMA, ping-pong consumers, fp8, and the
// m64n80k16 / m64n96k16 P V of D = 80 and 96 (their MN-major B is not a
// whole number of 128-byte swizzle atoms).
#pragma once

#include <type_traits>

#include "flash_tc.cuh"


namespace {

template <typename T, typename KT, int D, int RPT>
__global__ void __launch_bounds__(fa::NTHREADS) flash_fwd_kernel(FlashArgs a) {
  constexpr int BR = 16 * RPT;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BR * (D + 1);
  float* sV = sK + fa::BK * (D + 1);
  float* sP = sV + fa::BK * D;

  const int lane_c = threadIdx.x & 7;
  const int rg = threadIdx.x >> 3;
  const int b = blockIdx.x / a.Hq;
  const int h = blockIdx.x % a.Hq;
  const int kvh = h / (a.Hq / a.Hkv);
  const int q0 = blockIdx.y * BR;
  const int start = a.starts ? a.starts[a.n_start > 1 ? b : 0] : a.start;
  const int pad = a.pad_lens ? a.pad_lens[b] : 0;

  const T* q = static_cast<const T*>(a.q);
  fa::RowState<D, RPT> st;
  fa::init_state(st);
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = rg * RPT + i;
    const int s = q0 + r;
    st.valid[i] = s < a.Sq;
    st.qpos[i] = start + s;
    fa::load_q_row<T, D>(sQ, r, st.valid[i] ? q + b * a.q_sb + s * a.q_ss + h * a.q_sh : nullptr,
                         lane_c);
  }

  // block-uniform loop bounds: the live key range of the block's rows
  const int last = min(q0 + BR, a.Sq) - 1;
  const int hi = a.causal ? min(a.Sk, start + last + 1) : a.Sk;
  const int lo_tile = pad / fa::BK;
  const int hi_tile = hi > 0 ? (hi + fa::BK - 1) / fa::BK : 0;

  const KT* kb = static_cast<const KT*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const KT* vb = static_cast<const KT*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  const float* ksb = a.k_scale ? a.k_scale + b * a.sc_sb + kvh * a.sc_sh : nullptr;
  const float* vsb = a.v_scale ? a.v_scale + b * a.sc_sb + kvh * a.sc_sh : nullptr;
  fa::attend_tiles<KT, D, RPT>(sQ, sK, sV, sP, st, kb, vb, ksb, vsb, a.k_ss, a.v_ss, a.sc_ss,
                               a.Sk, a.causal, pad, a.window, a.sinks, a.scale, lo_tile,
                               hi_tile, start + q0);

  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const float lse = fa::finalize_row(st, i);
    if (!st.valid[i]) continue;
    const int s = q0 + rg * RPT + i;
    T* o = out + b * a.o_sb + s * a.o_ss + h * a.o_sh;
#pragma unroll
    for (int c = 0; c < fa::NCOL<D>; ++c) {
      if constexpr (D % 8 == 0)
        fa::from_f32(o + lane_c + 8 * c, st.acc[i][c]);
      else if (fa::has_col<D>(lane_c, c))
        fa::from_f32(o + lane_c + 8 * c, st.acc[i][c]);
    }
    if (a.lse != nullptr && lane_c == 0) a.lse[((long long)b * a.Hq + h) * a.Sq + s] = lse;
  }
}

// CTAs an SM the tensor-core instances are built for, by head dim (below
// 64 as at 64, at 80, 96, 100 and 120 as at 128: the same accumulator and about
// the same shared memory; one at 256, whose shared memory holds one).
template <int D>
constexpr int FWD_TC_BLOCKS = D > 128 ? 1 : D > 64 ? 2 : 4;

// The bf16 instances on the tensor cores, a bf16 (KT = bf16) or an int8
// (KT = int8_t) cache: one warpgroup per (batch * q-head, 64-query tile)
// over the block's live key tiles, and at D = 256 per column half of it
// (HALVES); one Q or K tile spans the head dim D, a V tile the CTA's DV
// output columns.
template <typename KT, int D>
__global__ void __launch_bounds__(wg::THREADS, FWD_TC_BLOCKS<D>) flash_fwd_tc_kernel(FlashArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int E = tc::E;
  constexpr int DV = tc::out_cols<D>;
  constexpr int HALVES = D / DV;
  constexpr uint32_t TILE = wg::tile_bytes<D>();
  const uint32_t sQ = tc::tiles(), ring = sQ + TILE;
  const unsigned bh = HALVES > 1 ? blockIdx.x / HALVES : blockIdx.x;
  const int half = HALVES > 1 ? static_cast<int>(blockIdx.x % HALVES) : 0;
  const int b = bh / a.Hq;
  const int h = bh % a.Hq;
  const int kvh = h / (a.Hq / a.Hkv);
  const int q0 = tc::query_tile(a.causal) * E;
  const int start = a.starts ? a.starts[a.n_start > 1 ? b : 0] : a.start;
  const int pad = a.pad_lens ? a.pad_lens[b] : 0;
  const int qpos0 = start + q0;   // position of the tile's first query

  // block-uniform key tiles: from the pad floor's to the causal frontier's,
  // those wholly below the window skipped unless they overlap the sinks
  const int last = min(q0 + E, a.Sq) - 1;
  const int hi = a.causal ? min(a.Sk, start + last + 1) : a.Sk;
  const int end = hi > 0 ? (hi + E - 1) / E : 0;
  const int wlo = fa::window_first_tile(qpos0, a.window);
  auto skips = [&](int j) { return fa::window_skips(j * E, qpos0, a.window, pad, a.sinks); };
  auto next = [&](int j) {
    ++j;
    return skips(j) ? wlo : j;
  };
  const int first = skips(pad / E) ? wlo : pad / E;

  wg::load_tile<D>(sQ, static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh, a.q_ss, q0,
                   a.Sq);
  // below D = 64, and at 80, 96, 100 and 120, the columns past D of Q and of every
  // K/V buffer (two ring stages, or the int8 path's widened pair),
  // published with the first tile's copies
  constexpr int BUFS = std::is_same<KT, bf16>::value ? 5 : 3;
  for (int i = 0; i < BUFS; ++i) wg::zero_pad<D>(sQ + i * TILE);
  constexpr int ACC = tc::acc_floats<D>;
  float acc[ACC], m[2] = {FA_NEG_INF, FA_NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < ACC; ++e) acc[e] = 0.f;
  const tc::CacheMask mask{a.Sk, a.causal, pad, a.window, fa::sink_bound(pad, a.sinks)};
  const float sl2 = a.scale * tc::kLog2e;
  const KT* kb = static_cast<const KT*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const KT* vb = static_cast<const KT*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  if constexpr (std::is_same<KT, bf16>::value) {
    tc::kv_walk<D, DV>(ring, kb, vb + half * DV, a.k_ss, a.v_ss, a.Sk, first, end, next,
                       [&](uint32_t sK, int j) {
                         tc::fwd_tile_tc<D>(acc, m, l, sQ, sK, qpos0, j * E, sl2, mask);
                       });
  } else {
    // the int8 cache: tiles and scales through the int8 stages after the
    // bf16 K/V pair at `ring`, widened into the pair before the products
    const uint32_t stages = ring + TILE + wg::tile_bytes<DV>();
    const float* ksb = a.k_scale + b * a.sc_sb + kvh * a.sc_sh;
    const float* vsb = a.v_scale + b * a.sc_sb + kvh * a.sc_sh;
    if constexpr (tc::i8_pitch<D>() != D) {   // D = 100 and 120: the stages' row pads
      for (int st = 0; st < 2; ++st) tc::i8_zero_pad<D>(stages + st * tc::i8_stage_bytes<D>());
    }
    tc::ring_walk(
        first, end, next,
        [&](int st, int j) {
          tc::i8_stage<D>(stages + st * tc::i8_stage_bytes<D>(), kb, vb, ksb, vsb, a.k_ss,
                          a.v_ss, a.sc_ss, j * E, a.Sk);
        },
        [&](int st, int j) {
          const uint32_t stage = stages + st * tc::i8_stage_bytes<D>();
          tc::i8_widen<D>(ring, stage, half * DV);
          wg::fence_smem_to_async();
          __syncthreads();
          tc::fwd_tile_tc<D>(acc, m, l, sQ, ring, qpos0, j * E, sl2, mask,
                             tc::ColScales{tc::floats_at(stage + 2 * tc::i8_tile<D>())});
        });
  }

  float inv[2], lse[2];
  tc::fwd_final(m, l, inv, lse);
  tc::store_bf16<ACC, DV>(acc, static_cast<bf16*>(a.out) + b * a.o_sb + h * a.o_sh + half * DV,
                          a.o_ss, q0, a.Sq, inv);
  if (a.lse != nullptr && half == 0)
    tc::store_rows(lse, a.lse + (static_cast<long long>(b) * a.Hq + h) * a.Sq, q0, a.Sq);
}

template <typename KT, int D>
cudaError_t launch_tc(const FlashArgs& a, cudaStream_t stream) {
  constexpr size_t smem =
      std::is_same<KT, int8_t>::value ? tc::fwd_i8_smem<D>() : tc::fwd_tc_smem<D>();
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_tc_kernel<KT, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  dim3 grid(a.B * a.Hq * (D / tc::out_cols<D>), (a.Sq + tc::E - 1) / tc::E);
  flash_fwd_tc_kernel<KT, D><<<grid, wg::THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, typename KT, int D>
cudaError_t launch(const FlashArgs& a, cudaStream_t stream) {
  constexpr int RPT = 4;
  constexpr int BR = 16 * RPT;
  constexpr size_t smem = fa::smem_bytes<D, RPT>();
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<T, KT, D, RPT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid(a.B * a.Hq, (a.Sq + BR - 1) / BR);
  flash_fwd_kernel<T, KT, D, RPT><<<grid, fa::NTHREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch(const FlashArgs& a, cudaStream_t s) {
  if (a.act_dtype == 0 && a.kv_dtype == 0) return launch<float, float, D>(a, s);
  if (a.act_dtype == 0 && a.kv_dtype == 2) return launch<float, int8_t, D>(a, s);
  if (a.act_dtype == 1 && a.kv_dtype == 1) return launch_tc<__nv_bfloat16, D>(a, s);
  if (a.act_dtype == 1 && a.kv_dtype == 2) return launch_tc<int8_t, D>(a, s);
  return cudaErrorInvalidValue;
}

}  // namespace
