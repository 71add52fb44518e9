// Tensor-core tile steps of the attention kernels (sm_90a, bf16), built on
// flash_wgmma.cuh's products: the forward step, the dQ step and the dK/dV
// step, each one 64 x 64 tile of (query, key) pairs, with the walks that
// feed them through a two-stage cp.async ring. flash_fwd.cu's flash_fwd and
// flash_tri.cuh's flash_fwd_tri share the forward step; flash_bwd.cuh's
// flash_bwd_dq and flash_tri.cuh's flash_bwd_dq_tri the dQ step;
// flash_bwd.cuh's flash_bwd_dkv and flash_tri.cuh's flash_bwd_dkv_tri the dK/dV
// step. What differs between a pair is the schedule and the mask, a functor
// with a per-element `keep` and a whole-tile `full` test (the step skips
// the per-element test on a full tile).
//
// Forward and dQ (FlashAttention-2/3's query-major loop). One warpgroup of
// 128 threads owns a 64-query tile, the wgmma M: its Q tile (and dO for dQ)
// is loaded once, swizzled; K/V tiles come through the ring (kv_walk), the
// copy of the next live tile issued before the products of the current one.
//   - forward: S = Q K^T, the online softmax on the accumulator's fragments
//     (running max and denominator of the thread's two rows), P split in
//     registers into two bf16 terms hi + lo, the A operands of O += P V (V
//     MN-major); the denominator sums the f32 P. One bf16 rounding of P
//     would move an output near 2 by a bf16 step, 0.0156, past the 1e-2 the
//     kernels are held to; the lo term costs half again the step's products.
//   - dQ: S = Q K^T and dP = dO V^T, P = exp(S scale - lse) from the
//     forward's lse and dS = P (dP - delta) scale in registers, dS rounded
//     to bf16 once for dQ += dS K (K MN-major: one swizzled K tile is both B
//     operands).
// The JAX kernels keep P and dS in f32; hack/torch_tri_bf16_replay.py
// replays these roundings against them (ROADMAP Queue C 12). Shared memory:
// Q and two K/V stages, 80 KB (forward); Q, dO and two stages, 96 KB (dQ):
// two CTAs an SM. The forward over an int8 cache walks the same ring
// (ring_walk) with int8 stages: each tile copied as int8 with its 64 k and
// v scales, widened exactly to bf16 into one swizzled K/V pair, the scales
// on the score and P columns (ColScales; Queue C 15): Q, the pair and two
// int8 stages, 82 KB, two CTAs an SM.
//
// Every step is generic in the head dim D = 16, 32, 64, 80, 96 or 128, a template
// parameter of its own (the accumulator holds acc_floats<D> floats a
// thread): at D = 64 a tile is one swizzle atom, S = Q K^T (and dP = dO
// V^T, S^T, dP^T) takes 4 k-steps, and the register-A products (O += P V,
// dQ += dS K, dV += P^T dO, dK += dS^T Q) are m64n64k16 into 32 floats;
// their A fragments do not change with D (their K is the tile's 64 keys or
// queries). Shared memory at D = 64: 41 KB forward (bf16 cache) or 42 KB
// (int8 cache), 49 KB dQ, 50 KB dK/dV. At D = 32 and 16 a tile is the D =
// 64 atom partly filled (flash_wgmma.cuh; the kernels zero its other
// chunks once, wg::zero_pad): the K-major products take D / 16 k-steps,
// the register-A products stay m64n64k16 into D = 64's accumulator of 32
// floats a thread, whose columns D.. are computed from the zeros and never
// stored (store_bf16's and dkv_store's D); shared memory and CTAs an SM as
// at D = 64. At D = 80 and 96 (the head dims of H2O-Danube-1.8B and
// Phi-3-mini) a tile is D = 128's two atoms, the second partly filled
// (flash_wgmma.cuh): the K-major products take D / 16 k-steps (5 or 6),
// the register-A products stay D = 128's m64n128k16 into D = 128's
// accumulator of 64 floats a thread, its columns D.. computed from the
// zeroed pad and never stored; shared memory and CTAs an SM as at D = 128
// (the forward's int8 stages smaller: 70 or 74 KB).
//
// dK/dV (FlashAttention-2/3's key-major backward). One warpgroup of 128
// threads owns a 64-key tile of one (batch, kv head), the wgmma M: its K and
// V tiles are loaded once, swizzled. Each step is one (64-query tile, q-head
// of the group), the group innermost, so GQA folds into one f32 dK and dV
// accumulator per key (no atomics, no per-q-head arrays). The step's Q and
// dO tiles and the 64 queries' lse and delta come through a two-stage
// cp.async ring; the copy of step i + 1 is issued before the products of
// step i. The products compute the transposes directly from K-major tiles,
// so nothing is transposed in shared memory:
//   S^T = K Q^T and dP^T = V dO^T (abt; rows are keys, columns queries);
//   P^T = exp2(S^T scale log2e - lse log2e) per column, 0 where masked or
//   where the query attends nothing; dS^T = P^T o (dP^T - delta) scale;
//   dV += P^T dO and dK += dS^T Q (A from registers, dO and Q MN-major, as V
//   enters P V).
// P^T and dS^T are each rounded to bf16 once before their product (the JAX
// kernels keep both f32; hack/torch_tri_bf16_replay.py replays the two
// roundings against JAX). dV's product runs while dS^T is computed; dK's is
// issued after it and both are waited for once.
//
// Shared memory of the dK/dV step, from the first swizzle-aligned byte: K, V
// (two tiles), then two stages of Q, dO (four tiles), then two stages of 64
// lse and 64 delta values (512 bytes each): 97 KB at D = 128, so two CTAs
// an SM. Registers: dK and dV acc_floats<D> f32 each (D / 2 from 64 up),
// S^T and dP^T 32 each, a thread.
#pragma once

#include "flash_common.cuh"
#include "flash_wgmma.cuh"

namespace tc {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int E = wg::ROWS;                  // a key or query tile: 64 rows
constexpr uint32_t STAT_BYTES = 2 * E * sizeof(float);   // a stage's lse, delta
constexpr float kLn2 = 0.6931471805599453f;
// Q; K and V in two stages / Q, dO; K and V in two stages / K, V; Q, dO in
// two stages; lse, delta in two stages; each plus the slack that aligns the
// first tile to a swizzle period
template <int D>
__host__ __device__ constexpr size_t fwd_tc_smem() {
  return 5 * wg::tile_bytes<D>() + wg::ALIGN;
}
template <int D>
__host__ __device__ constexpr size_t dq_tc_smem() {
  return 6 * wg::tile_bytes<D>() + wg::ALIGN;
}
template <int D>
__host__ __device__ constexpr size_t dkv_tc_smem() {
  return 6 * wg::tile_bytes<D>() + 2 * STAT_BYTES + wg::ALIGN;
}

// CTAs an SM the backward's tensor-core instances (flash_bwd.cuh's dQ and
// dK/dV, flash_tri.cuh's dK/dV) are built for, by head dim: two at D = 128
// and at 80 and 96 (D = 128's accumulators and shared memory: 97 KB for
// dK/dV, so three would neither fit nor keep their registers); at D = 64 (and below it, with D = 64's accumulators and shared memory),
// where a step holds half the accumulators and half the shared memory of
// D = 128's, the counts hack/torch_bwd_d64_ab.py measured fastest on an H100
// (it builds the sources with other values through these macros). dK/dV
// at three: 164 registers and three CTAs resident, 0.615 ms at (8, 2048,
// 16/8) against 0.818 at two (180 registers, two resident) and 0.767 at
// four (128 registers, 416 bytes of spill stores). dQ at two: 151
// registers, three CTAs resident as at three (150), 0.451 and 0.474 ms
// within the turns' spread; four spills (24 bytes) at 0.465.
#ifndef TC_DQ_BLOCKS_D64
#define TC_DQ_BLOCKS_D64 2
#endif
#ifndef TC_DKV_BLOCKS_D64
#define TC_DKV_BLOCKS_D64 3
#endif
template <int D>
constexpr int DQ_TC_BLOCKS = D > 64 ? 2 : TC_DQ_BLOCKS_D64;
template <int D>
constexpr int DKV_TC_BLOCKS = D > 64 ? 2 : TC_DKV_BLOCKS_D64;

// The floats a thread of an accumulator of 64 x (D rounded up to a whole
// swizzle atom of 64 columns) (the forward's O, dQ, dK, dV): D / 2 at 64
// and 128, D = 64's 32 below it, D = 128's 64 at 80 and 96 (the columns
// past D are computed, never stored).
template <int D>
constexpr int acc_floats = D < 64 ? 32 : (D + 63) / 64 * 32;

// The query tile of a rectangular grid's block (blockIdx.y), the tiles
// with the most key tiles first when `descending` (on a causal grid), so
// that the short ones fill the tail.
__device__ __forceinline__ int query_tile(bool descending) {
  return descending ? static_cast<int>(gridDim.y - 1 - blockIdx.y)
                    : static_cast<int>(blockIdx.y);
}

// The first swizzle-aligned byte of dynamic shared memory.
__device__ __forceinline__ uint32_t tiles() {
  extern __shared__ float smem[];
  return (wg::smem_addr(smem) + wg::ALIGN - 1) & ~(wg::ALIGN - 1);
}

// The generic pointer of shared address `addr` (for plain loads).
__device__ __forceinline__ const float* floats_at(uint32_t addr) {
  extern __shared__ float smem[];
  return reinterpret_cast<const float*>(reinterpret_cast<const char*>(smem) +
                                        (addr - wg::smem_addr(smem)));
}

// s = A B^T for one 64 x 64 tile (A, B both K-major): D / 16 k-steps.
template <int D = 128>
__device__ __forceinline__ void abt(float (&s)[32], uint32_t sa, uint32_t sb) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wg::mma_m64n64k16_ss<0>(s, wg::desc_kmajor(sa, kk), wg::desc_kmajor(sb, kk), kk > 0);
}

// acc += a x tile (MN-major), a the bf16 A fragments of 4 k-steps over the
// tile's 64 rows, the tile 2 N columns wide (N: acc's floats a thread);
// issued, not committed.
template <int N>
__device__ __forceinline__ void pv_issue(float (&acc)[N], const uint32_t (&a)[4][4],
                                         uint32_t tile) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wg::mma_rs<1>(acc, a[kk], wg::desc_mnmajor(tile, kk), 1);
}

// acc += p x tile (MN-major), 4 k-steps over the tile's 64 rows, waited
// for; p rounded to bf16, or with Split as bf16 hi + lo (8 k-steps).
template <bool Split, int N>
__device__ __forceinline__ void pv(float (&acc)[N], const float (&p)[32], uint32_t tile) {
  uint32_t hi[4][4], lo[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (Split)
      wg::a_frag_split(p, kk, hi[kk], lo[kk]);
    else
      wg::a_frag(p, kk, hi[kk]);
  }
  wg::fence();
  pv_issue(acc, hi, tile);
  if constexpr (Split) pv_issue(acc, lo, tile);
  wg::commit();
  wg::wait<0>();
  wg::fence_regs(acc);
}

// Keeps A fragments alive (and unmoved) until the product reading them has
// been waited for.
__device__ __forceinline__ void fence_frags(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[kk][i])::"memory");
}

// Rows r0 + frag_row (+ 8) of a 64 x 2N accumulator (N floats a thread),
// its first D columns (all of them by default), each times mul[i], as bf16
// at `base` (row stride ld elements), rows at or past n left out.
template <int N, int D = 2 * N>
__device__ __forceinline__ void store_bf16(const float (&acc)[N], bf16* base, long long ld,
                                           int r0, int n, const float (&mul)[2]) {
  static_assert(D % 8 == 0 && D <= 2 * N, "whole 8-column groups of the accumulator");
  const int t = threadIdx.x, row = wg::frag_row(t), col = wg::frag_col(t);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + row + 8 * i;
    if (r >= n) continue;
    bf16* o = base + r * ld + col;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * i] * mul[i], acc[4 * j + 2 * i + 1] * mul[i]);
  }
}

// ---- masks ----------------------------------------------------------------

// The masks of the tile steps, on (key, query) positions: keep(kp, qp), and
// full(k0, q0), true when every pair of the 64 x 64 tile at (k0, q0) is kept
// (the step then skips the per-element test).
struct TriMask {   // causal self-attention over the flattened triangle
  int S;
  __device__ __forceinline__ bool keep(int kp, int qp) const { return qp < S && kp <= qp; }
  __device__ __forceinline__ bool full(int k0, int q0) const { return q0 > k0 && q0 + E <= S; }
};

struct RectMask {  // fa::attendable: causal or not, with or without a window
  int S, causal, window;
  __device__ __forceinline__ bool keep(int kp, int qp) const {
    return kp < S && qp < S && fa::attendable(qp, kp, causal, 0, window, fa::sink_bound(0, 0));
  }
  __device__ __forceinline__ bool full(int k0, int q0) const {
    return k0 + E <= S && q0 + E <= S && (!causal || q0 >= k0 + E - 1) &&
           (window <= 0 || k0 > q0 + E - 1 - window);
  }
};

// fa::attendable at cache positions (flash_fwd: self-attention at start 0,
// or queries at start.. against the cache): keys below Sk, the pad floor,
// causal, the window with its sinks below sink_hi (fa::sink_bound).
struct CacheMask {
  int Sk, causal, pad, window, sink_hi;
  __device__ __forceinline__ bool keep(int kp, int qp) const {
    return kp < Sk && fa::attendable(qp, kp, causal, pad, window, sink_hi);
  }
  __device__ __forceinline__ bool full(int k0, int q0) const {
    return k0 + E <= Sk && k0 >= pad && (!causal || q0 >= k0 + E - 1) &&
           (window <= 0 || k0 > q0 + E - 1 - window || k0 + E <= sink_hi);
  }
};

// ---- forward and dQ -------------------------------------------------------

// A query tile's walk over key tiles first, next(first), ... while < end,
// through a two-stage ring: load(st, j) issues the copies of tile j into
// stage st (not committed), step(st, j) runs the products on it. Commits the
// first tile's copies with whatever the caller issued before (its Q, dO
// tiles); for each tile waits for its stage, publishes it to every thread
// and to the tensor cores, issues the copy of the next live tile into the
// other stage (whose products are done), then calls step. `next` gives the
// tile after j, skipping dead ones: the ring must hold the tile the step
// reads.
template <typename Next, typename Load, typename Step>
__device__ __forceinline__ void ring_walk(int first, int end, Next next, Load load, Step step) {
  if (first < end) load(0, first);
  wg::copy_commit();
  int st = 0;
  for (int j = first; j < end; st ^= 1) {
    const int jn = next(j);
    wg::copy_wait<0>();
    wg::fence_smem_to_async();
    __syncthreads();
    if (jn < end) {
      load(st ^ 1, jn);
      wg::copy_commit();
    }
    step(st, j);
    j = jn;
  }
  wg::copy_wait<0>();        // nothing in flight when the walk had no tile
}

// ring_walk over bf16 K/V tiles of head dim D at `ring` (stage st: K at
// ring + 2 st TILE, V after it; kb / vb at position 0 of the (batch, kv
// head), rows at or past Sk zero-filled); step(sK, j) gets the stage's K
// tile.
template <int D = 128, typename Next, typename Step>
__device__ __forceinline__ void kv_walk(uint32_t ring, const bf16* kb, const bf16* vb,
                                        long long k_ss, long long v_ss, int Sk, int first,
                                        int end, Next next, Step step) {
  constexpr int TILE = wg::tile_bytes<D>();
  ring_walk(
      first, end, next,
      [&](int st, int j) {
        const uint32_t stage = ring + 2 * st * TILE;
        wg::load_tile<D>(stage, kb, k_ss, j * E, Sk);
        wg::load_tile<D>(stage + TILE, vb, v_ss, j * E, Sk);
      },
      [&](int st, int j) { step(ring + 2 * st * TILE, j); });
}

// ---- the int8 cache -------------------------------------------------------

// An int8 stage: the K and V tiles as they lie in the cache (64 rows of D
// int8, 4 KB at D = 64, 8 KB at D = 128, each), then the tile's 64 k and 64
// v scales. An int8 value is exact in bf16 (8 significant bits), so the
// tiles widen without rounding into the swizzled bf16 K/V pair the products
// read (i8_widen); k_scale multiplies score column j, v_scale P's column j
// (ColScales).
template <int D>
__host__ __device__ constexpr uint32_t i8_tile() {
  return E * D;
}
template <int D>
__host__ __device__ constexpr uint32_t i8_stage_bytes() {
  return 2 * i8_tile<D>() + 2 * E * sizeof(float);
}
// Q, the bf16 K/V pair, two int8 stages, the alignment slack
template <int D>
__host__ __device__ constexpr size_t fwd_i8_smem() {
  return 3 * wg::tile_bytes<D>() + 2 * i8_stage_bytes<D>() + wg::ALIGN;
}

// Issues the copies of key tile rows k0 .. k0 + 63 of one (batch, kv head)
// (kb / vb / ksb / vsb at its position 0; rows at or past Sk zero-filled)
// into the int8 stage at `stage`: 64 * D / 16 16-byte chunks of each tile,
// D / 32 a thread (at D = 16, where a row is one chunk, threads 0..63 copy
// a K row each and threads 64..127 a V row; at D = 80 and 96, rows of 5 or
// 6 chunks, the K and V tiles' chunks together, D / 16 a thread), and one
// scale a thread. Not committed.
template <int D>
__device__ __forceinline__ void i8_stage(uint32_t stage, const int8_t* kb, const int8_t* vb,
                                         const float* ksb, const float* vsb, long long k_ss,
                                         long long v_ss, long long sc_ss, int k0, int Sk) {
  constexpr int CH = D / 16;                  // chunks a row
  constexpr int LOG_CH = wg::log2i(CH);
  static_assert(D % 16 == 0 && D <= 128, "D = 16, 32, 64, 80, 96 or 128");
  constexpr uint32_t TILE = i8_tile<D>();
  if constexpr ((1 << LOG_CH) != CH) {        // D = 80 or 96
#pragma unroll
    for (int it = 0; it < 2 * E * CH / wg::THREADS; ++it) {
      const int i = threadIdx.x + it * wg::THREADS;
      const int kv = i / (E * CH), j = i % (E * CH);
      const int r = j / CH, c = j % CH;
      const bool in = k0 + r < Sk;
      const long long row = in ? k0 + r : 0;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(stage + kv * TILE +
                                                                         r * D + c * 16),
                   "l"((kv ? vb + row * v_ss : kb + row * k_ss) + c * 16), "r"(in ? 16 : 0)
                   : "memory");
    }
  } else if constexpr (E * (D / 16) < wg::THREADS) {   // D = 16
    const int r = threadIdx.x & (E - 1), kv = threadIdx.x / E;
    const bool in = k0 + r < Sk;
    const long long row = in ? k0 + r : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(stage + kv * TILE +
                                                                         r * D),
                 "l"((kv ? vb + row * v_ss : kb + row * k_ss)), "r"(in ? 16 : 0)
                 : "memory");
  }
#pragma unroll
  for (int it = 0; it < ((1 << LOG_CH) == CH ? E * (D / 16) / wg::THREADS : 0); ++it) {
    const int i = threadIdx.x + it * wg::THREADS;
    const int r = i >> LOG_CH, c = i & (D / 16 - 1);
    const bool in = k0 + r < Sk;
    const long long row = in ? k0 + r : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(stage + r * D + c * 16),
                 "l"(kb + row * k_ss + c * 16), "r"(in ? 16 : 0)
                 : "memory");
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(stage + TILE + r * D +
                                                                         c * 16),
                 "l"(vb + row * v_ss + c * 16), "r"(in ? 16 : 0)
                 : "memory");
  }
  const int r = threadIdx.x & (E - 1);
  const bool in = k0 + r < Sk;
  const float* src = (threadIdx.x < E ? ksb : vsb) + (in ? (k0 + r) * sc_ss : 0);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(stage + 2 * TILE +
                                                                      threadIdx.x * 4),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

// Widens the int8 stage's K and V tiles, exactly, into the swizzled bf16
// tiles at sK and sK + TILE (wg::load_tile's layout): each thread D / 16
// chunks of 8 values a tile. The caller publishes them (fence_smem_to_async,
// then a barrier) before the products.
template <int D>
__device__ __forceinline__ void i8_widen(uint32_t sK, uint32_t stage) {
  constexpr int LOG_CH = wg::log2i(D / 8);   // log2 of the bf16 chunks a row, D / 8
  constexpr bool POW2 = (1 << LOG_CH) == D / 8;   // all but D = 80 and 96
  static_assert(wg::tile_bytes<D>() > 0, "D = 16, 32, 64, 80, 96 or 128");
  const char* src = reinterpret_cast<const char*>(floats_at(stage));
  char* dst = const_cast<char*>(reinterpret_cast<const char*>(floats_at(sK)));
#pragma unroll
  for (int kv = 0; kv < 2; ++kv)
#pragma unroll
    for (int it = 0; it < E * (D / 8) / wg::THREADS; ++it) {
      const int i = threadIdx.x + it * wg::THREADS;
      // row, chunk of 8 values along D
      const int r = POW2 ? i >> LOG_CH : i / (D / 8), c = POW2 ? i & (D / 8 - 1) : i % (D / 8);
      const uint2 raw =
          *reinterpret_cast<const uint2*>(src + kv * i8_tile<D>() + r * D + c * 8);
      const uint32_t w[2] = {raw.x, raw.y};
      uint32_t o[4];
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const uint32_t x = w[h >> 1] >> (16 * (h & 1));
        o[h] = wg::pack_bf16(static_cast<float>(static_cast<int8_t>(x & 0xffu)),
                             static_cast<float>(static_cast<int8_t>((x >> 8) & 0xffu)));
      }
      *reinterpret_cast<uint4*>(dst + kv * wg::tile_bytes<D>() + (c >> 3) * wg::ATOM_BYTES +
                                r * 128 + (((c & 7) ^ (r & 7)) << 4)) =
          make_uint4(o[0], o[1], o[2], o[3]);
    }
}

// Per-key-column factors of a forward step: none (a bf16 cache), or the int8
// cache's k_scale (on the scores, before the max) and v_scale (on P, before
// P V; the denominator sums the unscaled P).
struct NoScales {
  static constexpr bool kOn = false;
  __device__ __forceinline__ float k(int) const { return 1.f; }
  __device__ __forceinline__ float v(int) const { return 1.f; }
};

struct ColScales {
  static constexpr bool kOn = true;
  const float* ks;   // the stage's 64 k scales, then its 64 v scales
  __device__ __forceinline__ float k(int c) const { return ks[c]; }
  __device__ __forceinline__ float v(int c) const { return ks[E + c]; }
};

// One forward step (_online_update): queries q0 .. q0 + 63 (Q tile at sQ)
// against keys k0 .. k0 + 63 (K, V tiles at sK, sK + TILE), the copies
// waited for and published; head dim D, acc_floats<D> floats a thread
// (D = 2 N from 64 up; D = 64's 32 below it). S = Q K^T, the mask, the
// running max m (log2 units) and denominator l of the fragment's two rows
// (l over this thread's columns; the quad's sum at the end, fwd_final),
// acc rescaled, then acc += P V with P as bf16 hi + lo. With ColScales
// (the int8 cache) score column j is multiplied by k_scale[j] with the
// scale, and P's column j by v_scale[j] after the denominator took it.
template <int D, typename Mask, typename Scales = NoScales, int N>
__device__ __forceinline__ void fwd_tile_tc(float (&acc)[N], float (&m)[2], float (&l)[2],
                                            uint32_t sQ, uint32_t sK, int q0, int k0, float sl2,
                                            const Mask& mask, const Scales& sc = Scales()) {
  static_assert(N == acc_floats<D>, "the accumulator of head dim D");
  const int t = threadIdx.x, row = wg::frag_row(t), col = wg::frag_col(t);
  float s[32];
  wg::fence();
  abt<D>(s, sQ, sK);
  wg::commit();
  wg::wait<0>();
  wg::fence_regs(s);
  // the mask in a pass of its own, skipped on a full tile (a per-element
  // test folded into the max's loop measured slower on both schedules)
  if constexpr (Scales::kOn) {
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] *= sc.k(col + wg::elem_col(e));
  }
  if (mask.full(k0, q0)) {
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] *= sl2;
  } else {
#pragma unroll
    for (int e = 0; e < 32; ++e)
      s[e] = mask.keep(k0 + col + wg::elem_col(e), q0 + row + wg::elem_row(e)) ? s[e] * sl2
                                                                              : FA_NEG_INF;
  }
  // (element 4 j + 2 i + c of a fragment lies in row i, j-th column pair)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = FA_NEG_INF;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) mx = fmaxf(mx, s[4 * j + 2 * i + c]);
    const float m_new = fmaxf(m[i], wg::quad_max(mx));
    const bool live = m_new > FA_NEG_INF / 2;
    const float corr = exp2f(m[i] - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 4 * j + 2 * i + c;
        s[e] = live ? exp2f(s[e] - m_new) : 0.f;
        psum += s[e];
      }
    m[i] = m_new;
    l[i] = l[i] * corr + psum;
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      acc[4 * j + 2 * i] *= corr;
      acc[4 * j + 2 * i + 1] *= corr;
    }
  }
  if constexpr (Scales::kOn) {
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] *= sc.v(col + wg::elem_col(e));
  }
  pv<true>(acc, s, sK + wg::tile_bytes<D>());   // P as bf16 hi + lo
}

// _finalize_out for the fragment's two rows: inv = 1 / l (0 where the row
// attended nothing) and its lse (NEG_INF there), l summed over the quad.
__device__ __forceinline__ void fwd_final(const float (&m)[2], const float (&l)[2],
                                          float (&inv)[2], float (&lse)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float lsum = wg::quad_sum(l[i]);
    inv[i] = lsum > 0.f ? 1.f / lsum : 0.f;
    lse[i] = lsum > 0.f ? m[i] * kLn2 + logf(lsum) : FA_NEG_INF;
  }
}

// The fragment rows' values v[i] at base[r0 + frag_row + 8 i], one thread of
// each quad writing, rows at or past n left out.
__device__ __forceinline__ void store_rows(const float (&v)[2], float* base, int r0, int n) {
  const int t = threadIdx.x, row = wg::frag_row(t);
  if ((t & 3) != 0) return;
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (r0 + row + 8 * i < n) base[r0 + row + 8 * i] = v[i];
}

// The dQ inputs of the fragment's two rows q0 + frag_row (+ 8): lse in log2
// units, delta, and whether the row attended anything (lse > NEG_INF / 2);
// rows at or past S attend nothing. `lse` / `delta` at the (batch, q-head)'s
// row of [B, Hq, S].
__device__ __forceinline__ void dq_rows(const float* lse, const float* delta, int q0, int S,
                                        float (&lse2)[2], float (&dl)[2], bool (&live)[2]) {
  const int row = wg::frag_row(threadIdx.x);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = q0 + row + 8 * i;
    const float x = qp < S ? lse[qp] : FA_NEG_INF;
    live[i] = x > FA_NEG_INF / 2;
    lse2[i] = x * kLog2e;
    dl[i] = qp < S ? delta[qp] : 0.f;
  }
}

// One dQ step (_bwd_dq_step): queries q0 .. q0 + 63 (Q, dO tiles at sQ, sdO;
// their rows' dq_rows) against keys k0 .. k0 + 63 (K, V tiles at sK, sK +
// TILE), the copies waited for and published; head dim D, acc_floats<D>
// floats a thread. S = Q K^T and dP = dO V^T, P from lse while dP
// finishes, dS = P (dP - delta) scale, acc += dS K with dS rounded to bf16.
template <int D, typename Mask, int N>
__device__ __forceinline__ void dq_tile_tc(float (&acc)[N], uint32_t sQ, uint32_t sdO,
                                           uint32_t sK, const float (&lse2)[2],
                                           const float (&delta)[2], const bool (&live)[2],
                                           int q0, int k0, float sl2, float scale,
                                           const Mask& mask) {
  static_assert(N == acc_floats<D>, "the accumulator of head dim D");
  const int t = threadIdx.x, row = wg::frag_row(t), col = wg::frag_col(t);
  float s[32], dp[32];
  wg::fence();
  abt<D>(s, sQ, sK);
  wg::commit();
  abt<D>(dp, sdO, sK + wg::tile_bytes<D>());
  wg::commit();
  wg::wait<1>();
  wg::fence_regs(s);
  if (mask.full(k0, q0)) {   // as in fwd_tile_tc: no per-element test
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int i = (e >> 1) & 1;
      s[e] = live[i] ? exp2f(s[e] * sl2 - lse2[i]) : 0.f;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int i = (e >> 1) & 1;
      const bool keep = live[i] && mask.keep(k0 + col + wg::elem_col(e), q0 + row + 8 * i);
      s[e] = keep ? exp2f(s[e] * sl2 - lse2[i]) : 0.f;
    }
  }
  wg::wait<0>();
  wg::fence_regs(dp);
#pragma unroll
  for (int e = 0; e < 32; ++e) s[e] = s[e] * (dp[e] - delta[(e >> 1) & 1]) * scale;
  pv<false>(acc, s, sK);
}

// ---- dK/dV ----------------------------------------------------------------

// Where a dK/dV block reads: one (batch, kv head)'s K and V at position 0,
// the batch's Q and dO at head 0, its lse and delta rows [Hq][S] at head 0.
struct DkvSrc {
  const bf16* k;
  const bf16* v;
  const bf16* q;
  const bf16* dout;
  const float* lse;
  const float* delta;
  long long k_ss, v_ss, q_ss, q_sh, do_ss, do_sh;
  int S, group, kvh;
  float scale;
};

// Issues the copies of one step's inputs into stage `stage` (Q, dO tiles
// of head dim D) and `stats` (lse then delta of the 64 queries; zero past
// S, where the masks keep nothing): queries q0 .. q0 + 63 of q-head h. Not
// committed.
template <int D>
__device__ __forceinline__ void dkv_stage(uint32_t stage, uint32_t stats, const DkvSrc& s, int q0,
                                          int h) {
  wg::load_tile<D>(stage, s.q + h * s.q_sh, s.q_ss, q0, s.S);
  wg::load_tile<D>(stage + wg::tile_bytes<D>(), s.dout + h * s.do_sh, s.do_ss, q0, s.S);
  const int i = threadIdx.x & (E - 1);
  const bool in = q0 + i < s.S;
  const float* src = (threadIdx.x < E ? s.lse : s.delta) + static_cast<long long>(h) * s.S +
                     (in ? q0 + i : 0);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(stats + threadIdx.x * 4),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

// One dK/dV step: the block's keys k0 .. k0 + 63 (K, V tiles at sK, sK +
// TILE) against queries q0 .. q0 + 63 of one q-head (Q, dO tiles at stage,
// stage + TILE; lse, delta at sL, sL + 64), the copies waited for and
// published; head dim D, acc_floats<D> of dk's and dv's floats a thread.
// Adds the step's P^T dO to dv and dS^T Q to dk (m64nNk16 over the 64
// queries, N = max(D, 64)).
template <int D, typename Mask, int N>
__device__ __forceinline__ void dkv_tile_tc(float (&dk)[N], float (&dv)[N], uint32_t sK,
                                            uint32_t stage, const float* sL, int k0, int q0,
                                            float scale, const Mask& mask) {
  static_assert(N == acc_floats<D>, "the accumulator of head dim D");
  const uint32_t sV = sK + wg::tile_bytes<D>(), sQ = stage, sdO = stage + wg::tile_bytes<D>();
  const float* sD = sL + E;
  const int t = threadIdx.x, row = wg::frag_row(t), col = wg::frag_col(t);
  float s[32], dp[32];
  wg::fence_regs(dk);
  wg::fence_regs(dv);
  wg::fence();
  abt<D>(s, sK, sQ);         // S^T = K Q^T
  wg::commit();
  abt<D>(dp, sV, sdO);       // dP^T = V dO^T
  wg::commit();

  // P^T from the forward's lse, per column (query), while dP^T finishes
  const bool full = mask.full(k0, q0);
  const float sl2 = scale * kLog2e;
  wg::wait<1>();
  wg::fence_regs(s);
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int c = col + wg::elem_col(e);
    const float lse = sL[c];
    const bool keep = (full || mask.keep(k0 + row + wg::elem_row(e), q0 + c)) &&
                      lse > FA_NEG_INF / 2;
    s[e] = keep ? exp2f(fmaf(s[e], sl2, -lse * kLog2e)) : 0.f;
  }
  uint32_t pa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wg::a_frag(s, kk, pa[kk]);
  wg::fence();
  pv_issue(dv, pa, sdO);     // dV += P^T dO, running while dS^T is formed
  wg::commit();

  wg::wait<1>();             // dP^T is done
  wg::fence_regs(dp);
#pragma unroll
  for (int e = 0; e < 32; ++e) dp[e] = s[e] * (dp[e] - sD[col + wg::elem_col(e)]) * scale;
  uint32_t dsa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wg::a_frag(dp, kk, dsa[kk]);
  wg::fence();
  pv_issue(dk, dsa, sQ);     // dK += dS^T Q
  wg::commit();
  wg::wait<0>();
  fence_frags(pa);
  fence_frags(dsa);
  wg::fence_regs(dk);
  wg::fence_regs(dv);
}

// A dK/dV block's walk: loads its K/V tiles, then runs `tiles` query tiles
// downward, the first at tile index qt0 and each next one below it (the
// order in which the f32 sums came out most accurate), each for every q-head
// of the group (innermost), through the two-stage ring; head dim D (below
// 64 the caller zeroed the six tiles' pad). dk and dv accumulate; every
// product is waited for on return.
template <int D, typename Mask, int N>
__device__ __forceinline__ void dkv_walk_tc(float (&dk)[N], float (&dv)[N], uint32_t sK,
                                            const DkvSrc& s, int k0, int qt0, int tiles,
                                            const Mask& mask) {
  constexpr int TILE = wg::tile_bytes<D>();
  const int steps = tiles * s.group;
  if (steps <= 0) return;
  const uint32_t ring = sK + 2 * TILE;             // stage st at ring + 2 st TILE
  const uint32_t stats = sK + 6 * TILE;            // stage st at stats + st STAT
  const int h0 = s.kvh * s.group;
  wg::load_tile<D>(sK, s.k, s.k_ss, k0, s.S);
  wg::load_tile<D>(sK + TILE, s.v, s.v_ss, k0, s.S);
  dkv_stage<D>(ring, stats, s, qt0 * E, h0);
  wg::copy_commit();
  for (int i = 0; i < steps; ++i) {
    const int st = i & 1;
    wg::copy_wait<0>();
    wg::fence_smem_to_async();
    __syncthreads();         // this stage is in; the other one's readers are done
    if (i + 1 < steps) {
      const int j = i + 1;
      dkv_stage<D>(ring + 2 * (st ^ 1) * TILE, stats + (st ^ 1) * STAT_BYTES, s,
                   (qt0 - j / s.group) * E, h0 + j % s.group);
      wg::copy_commit();
    }
    dkv_tile_tc<D>(dk, dv, sK, ring + 2 * st * TILE, floats_at(stats + st * STAT_BYTES), k0,
                (qt0 - i / s.group) * E, s.scale, mask);
  }
}

// Rows k0 + frag_row (+ 8) of dK and dV from the fragments, their first D
// columns, as bf16, rows at or past S left out (`dkb` / `dvb` at position
// 0 of the (batch, kv head), `*_ss` their position strides).
template <int D, int N>
__device__ __forceinline__ void dkv_store(const float (&dk)[N], const float (&dv)[N], bf16* dkb,
                                          long long dk_ss, bf16* dvb, long long dv_ss, int k0,
                                          int S) {
  const float one[2] = {1.f, 1.f};
  store_bf16<N, D>(dk, dkb, dk_ss, k0, S, one);
  store_bf16<N, D>(dv, dvb, dv_ss, k0, S, one);
}

}  // namespace tc
