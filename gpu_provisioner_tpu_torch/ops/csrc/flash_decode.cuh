// Decode-step attention for Hopper (sm_90a): a short query block
// (S <= DECODE_MAX_S = 16 positions) per row against the KV cache.
//
// Replaces gpu_provisioner_tpu/ops/flash_attention.py:_kernel_decode
// (behind flash_attention_decode). A unit is one (batch, kv head) and a
// block of its R query rows, R the smallest of 4, 8, 16, 32, 64 that holds
// all S * group rows (4 at Llama-7B's GQA group of 4 for a plain decode
// step, 64 for a 16-position verify block; more rows take more units), so
// every GQA query of the head shares one read of each cache tile and a
// plain step computes no dead rows. Query row r sits at position start_b +
// r / group and belongs to q-head kvh * group + r % group (the row-major
// (s, g) order of the TPU kernel). `start` is one value or one per row (the
// serving engine's per-slot lengths); pads, int8 scales, a window and sinks
// mask as in the TPU kernel.
//
// What bounds it on an H100: bytes. A step reads each row's live cache
// prefix (K and V, Hkv heads, D values each) once and does about 4 * group
// operations per cached element, far below the card's ~295 operations per
// byte; at a serving batch the live prefix is a few MB, a few microseconds
// at 3.35 TB/s. So the design spreads those bytes over the whole card and
// keeps them moving:
//   - split-KV: the grid is (units, splits). The host picks `splits` from
//     the unit count and max_len alone (about two CTAs an SM in all, at
//     most one a cache tile and MAX_SPLITS; it never reads the per-row
//     starts, which would sync). Each CTA computes its unit's live key tiles
//     itself (pad floor, causal frontier of the block's last row, the window
//     band of its first row plus the sink tiles: fa::window_first_tile and
//     the sink bound of fa::window_skips), as one list of at most two runs,
//     and walks an equal share of that list (empty shares write an empty
//     partial: m = NEG_INF, l = 0);
//   - merge: each CTA writes its partial (acc [R][D] unnormalised, m and l
//     in log2 units) to the wrapper's f32 workspace, and a second launch
//     from the same C entry, a block per (unit, row), merges them by
//     log-sum-exp (flash_tri.cu's fixup pattern; parallel/ring.py's
//     _lse_merge is its plain version). A second launch rather than a
//     last-CTA merge through per-unit counters: no state lives across calls
//     or streams, and the launch costs the device a few microseconds, not
//     the host a call. With one split the kernel writes the output itself
//     and nothing is merged;
//   - the bytes stream: K/V tiles of 64 keys come through a two-stage
//     cp.async ring in 16-byte chunks, the copy of the next tile in flight
//     while this one is scored, in the cache's own dtype: an int8 tile is
//     copied as int8 (half a bf16 tile's bytes) with its 64 k and v scales
//     beside it; k_scale multiplies a score column, v_scale is folded into
//     P's column before P V, and the denominator sums the unscaled P.
// Arithmetic is f32 FMA for every dtype pair: at group 4 a bf16 step does
// about 8 operations per byte, under the ~20 that f32 FMA sustains against
// 3.35 TB/s, so the tensor cores would buy nothing here and f32 adds no
// rounding point (the merge only reorders the sums). Whether verify-sized
// blocks (64 rows, ~128 operations per byte) want mma.sync or wgmma is
// left open.
//
// Head dim 16, 32, 64, 80, 96, 100, 120, 128 or 256 (the C entries refuse
// any other D).
// A CTA keeps 128 threads at each: P V splits the block into RH = 128 / D
// row groups of D threads (1 at D = 128, 2 at 64, 4 at 32, 8 at 16), group
// g owning rows g, g + RH, ... of the unit and each of its threads one
// output column of them, so P V reads each V tile once a group and no
// combine is needed. At R = 4 rows (a plain step at group 2 or 4) and D =
// 16, groups 4..7 (warps 2 and 3) own no row and idle through P V. At D =
// 80 and 96, which do not divide 128, the block keeps D = 128's one group:
// threads 0..D-1 own a column of every row, the other 48 or 32 idle
// through P V (a block of D threads would cut the copies in flight). At D
// = 256 (Gemma-2B's 8/1 heads of 256) the block keeps its 128 threads and
// one row group, each thread owning CPT = 2 columns (t and t + 128) of
// every row: a block of 256 threads would halve the registers a thread may
// hold (two CTAs of 256 threads an SM at most under its launch bound) for
// no more bytes in flight, and the unit's rows already fill the block. A
// smaller block would cut the copies in flight a CTA, where this kernel is
// bound by bytes. The score product (a thread a key column of the 64-key
// tile against the rows of its half of the block) and the softmax (a warp
// a row) do not depend on D. A row is copied in 16-byte chunks: an int8 row
// is 64 bytes at D = 64, one chunk at D = 16, 5 or 6 chunks at 80 or 96.
// At D = 100 (OpenLLaMA-3B's 32/32 heads of 100; one row group, threads
// 0..99 owning a column, as at 80 and 96) a cached row is 200 bytes in
// bf16 and 100 in int8, no whole number of chunks, and a contiguous
// cache's rows start on 8- or 4-byte boundaries only: the ring copies
// them in pieces of 8 or 4 bytes (cp.async.ca; an f32 row of 400 bytes
// stays 16-byte chunks), and the score product reads the row's whole
// chunks and then its last 4 values alone (Layout::TAIL). At D = 120
// (H2O-Danube3-4B's 32/8 heads of 120; one row group, threads 0..119
// owning a column) a bf16 row is 240 bytes, 15 whole chunks, and an f32
// row 480, 30; an int8 row is 120 bytes, 7 chunks and 8 bytes: the ring
// copies it in pieces of 8 bytes, and the score product reads its 7 whole
// chunks and then its last 8 values (two float4s of q).
//
// This header holds the kernel, its merge and their launch for every head
// dim; flash_decode.cu's C entry takes 64 and 128, flash_decode_narrow.cu's
// 32 and 16, flash_decode_mid.cu's 80 and 96, flash_decode_pad.cu's 100
// and 120, flash_decode_wide.cu's 256,
// so that nvcc processes build
// the instances side by side (one source for all four of 16..128 took 87 s
// to build for sm_90a, four times flash_fwd.cu's 20).
#pragma once

#include <type_traits>

#include "flash_common.cuh"
#include "flash_wgmma.cuh"

namespace {

constexpr int BK = fa::BK;           // keys a tile
constexpr int THREADS = 128;
constexpr int MAX_SPLITS = 32;       // ops/flash_attention.py DECODE_MAX_SPLITS

// Shared memory of one instance: two ring stages (one for an f32 cache at
// D = 256, whose two would take 266,240 bytes, past the 232,448 a block
// may have: that instance loads each tile after the last one's products),
// each a K and a V tile of
// 64 rows padded to RB bytes (RB the least odd multiple of 16 past the
// row's whole chunks: the 16-byte chunks that eight neighbouring lanes read
// from eight rows fall in distinct banks; 16 bytes of padding, but 32 for
// the one-chunk int8 row of D = 16; at D = 100 208 bytes for a bf16 row of
// 200, 112 for an int8 row of 100, 432 for an f32 row of 400; at D = 120
// 272 for a bf16 row of 240, 144 for an int8 row of 120, 496 for an f32
// row of 480)
// plus, for int8, the tile's 64 k and 64 v scales; then Q (f32 [R][D]),
// the scores / P (f32 [R][BK]), each row's running max, denominator and
// rescale factor, and each row's query position.
template <typename KT, int D, int R>
struct Layout {
  static constexpr bool kInt8 = std::is_same<KT, int8_t>::value;
  static constexpr int ROW = D * static_cast<int>(sizeof(KT));      // bytes a cached row
  static constexpr int CH = ROW / 16;                                // its whole chunks
  static constexpr int VPC = 16 / static_cast<int>(sizeof(KT));     // values a chunk
  // bytes past them: 8 (bf16) or 4 (int8) at D = 100, 8 (int8) at 120
  static constexpr int TAIL = ROW % 16;
  // the ring's copy: 16-byte chunks, or at D = 100 pieces of 8 or 4 bytes,
  // at 120 (int8) of 8
  static constexpr int CP = TAIL == 0 ? 16 : TAIL;
  static constexpr int RB = 16 * ((CH + 1) | 1);
  static constexpr int TILE = BK * RB;
  static constexpr int STAGE = 2 * TILE + (kInt8 ? 2 * BK * 4 : 0);
  static constexpr int NSTAGE = sizeof(KT) == 4 && D > 128 ? 1 : 2;
  static constexpr int Q = NSTAGE * STAGE;
  static constexpr int S = Q + R * D * 4;
  static constexpr int M = S + R * BK * 4;
  static constexpr int L = M + R * 4;
  static constexpr int C = L + R * 4;
  static constexpr int QPOS = C + R * 4;
  static constexpr int BYTES = QPOS + R * 4;
};

__device__ __forceinline__ void cp16(const void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(wg::smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp8(const void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(wg::smem_addr(dst)),
               "l"(src), "r"(in ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp4(const void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(wg::smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

// The 16-byte chunk `u` of a cached row as f32 values.
__device__ __forceinline__ void unpack(const uint4& u, float (&x)[4], float) {
  x[0] = __uint_as_float(u.x);
  x[1] = __uint_as_float(u.y);
  x[2] = __uint_as_float(u.z);
  x[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void unpack(const uint4& u, float (&x)[8], __nv_bfloat16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void unpack(const uint4& u, float (&x)[16], int8_t) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      x[4 * i + b] = static_cast<float>(static_cast<int8_t>((w[i] >> (8 * b)) & 0xffu));
}

// The values of a row's tail (Layout::TAIL: 8 bytes of bf16 or 4 of int8
// at D = 100, 8 of int8 at 120) as f32.
__device__ __forceinline__ void unpack_tail(const char* p, float (&x)[4], __nv_bfloat16) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  x[0] = __uint_as_float(u.x << 16);
  x[1] = __uint_as_float(u.x & 0xffff0000u);
  x[2] = __uint_as_float(u.y << 16);
  x[3] = __uint_as_float(u.y & 0xffff0000u);
}

__device__ __forceinline__ void unpack_tail(const char* p, float (&x)[4], int8_t) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
  for (int b = 0; b < 4; ++b) x[b] = static_cast<float>(static_cast<int8_t>((w >> (8 * b)) & 0xffu));
}

__device__ __forceinline__ void unpack_tail(const char* p, float (&x)[8], int8_t) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const uint32_t w[2] = {u.x, u.y};
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      x[4 * i + b] = static_cast<float>(static_cast<int8_t>((w[i] >> (8 * b)) & 0xffu));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Where a unit reads: one (batch, kv head)'s K, V (and scales) at position 0.
template <typename KT>
struct Src {
  const KT* k;
  const KT* v;
  const float* ks;
  const float* vs;
  long long k_ss, v_ss, sc_ss;
  int Sk;
};

// Issues the copies of key tile j (rows at or past Sk zero-filled) into
// ring stage `stage`; not committed.
template <typename KT, int D, int R>
__device__ __forceinline__ void load_stage(char* stage, const Src<KT>& s, int j) {
  using Ly = Layout<KT, D, R>;
  const int kv0 = j * BK;
  if constexpr (Ly::CP != 16) {   // pieces of 8 (bf16 at 100, int8 at 120) or 4 (int8 at 100) bytes
    constexpr int P = Ly::ROW / Ly::CP;   // pieces a row
    for (int i = threadIdx.x; i < BK * P; i += THREADS) {
      const int r = i / P, c = i % P;
      const bool in = kv0 + r < s.Sk;
      const long long row = in ? kv0 + r : 0;
      const char* k = reinterpret_cast<const char*>(s.k + row * s.k_ss) + c * Ly::CP;
      const char* v = reinterpret_cast<const char*>(s.v + row * s.v_ss) + c * Ly::CP;
      if constexpr (Ly::CP == 8) {
        cp8(stage + r * Ly::RB + c * 8, k, in);
        cp8(stage + Ly::TILE + r * Ly::RB + c * 8, v, in);
      } else {
        cp4(stage + r * Ly::RB + c * 4, k, in);
        cp4(stage + Ly::TILE + r * Ly::RB + c * 4, v, in);
      }
    }
  } else {
    for (int i = threadIdx.x; i < BK * Ly::CH; i += THREADS) {
      const int r = i / Ly::CH, c = i % Ly::CH;
      const bool in = kv0 + r < s.Sk;
      const long long row = in ? kv0 + r : 0;
      cp16(stage + r * Ly::RB + c * 16,
           reinterpret_cast<const char*>(s.k + row * s.k_ss) + c * 16, in);
      cp16(stage + Ly::TILE + r * Ly::RB + c * 16,
           reinterpret_cast<const char*>(s.v + row * s.v_ss) + c * 16, in);
    }
  }
  if constexpr (Ly::kInt8) {   // k scales then v scales, one a thread
    const int r = threadIdx.x & (BK - 1);
    const bool in = kv0 + r < s.Sk;
    const float* src = (threadIdx.x < BK ? s.ks : s.vs) + (in ? (kv0 + r) * s.sc_ss : 0);
    cp4(stage + 2 * Ly::TILE + threadIdx.x * 4, src, in);
  }
}

// The live key tiles of a unit as one list of two runs, [lo, a_end) (the
// sink tiles under a window) then [b0, hi): tile j of [lo, hi) is live
// unless it lies wholly below the window of the unit's first row and past
// the sinks (fa::window_skips). ops/flash_attention.py _decode_tiles is its
// CPU twin.
struct Live {
  int lo, a_end, b0, hi;
  __device__ __forceinline__ int count() const { return (a_end - lo) + max(0, hi - b0); }
  __device__ __forceinline__ int at(int i) const { return i < a_end - lo ? lo + i : b0 + i - (a_end - lo); }
};

__device__ __forceinline__ Live live_tiles(int start, int pad, int first_s, int last_s, int Sk,
                                           int window, int sinks) {
  const int hi_pos = min(Sk, start + last_s + 1);
  const int lo = pad / BK;
  const int hi = hi_pos > 0 ? (hi_pos + BK - 1) / BK : 0;
  const int wlo = fa::window_first_tile(start + first_s, window);
  const int sink_end = window > 0 && sinks > 0 ? (pad + sinks - 1) / BK + 1 : 0;
  const int a_end = max(lo, min(hi, sink_end));
  return Live{lo, a_end, max(max(lo, wlo), a_end), hi};
}

// CTAs an SM the kernel's instances are built for: at head dims 80 and 96
// two, the split plan's about two an SM (_decode_splits), which leaves
// ptxas 255 registers; without a bound (-DDECODE_MID_MIN_BLOCKS=0) it
// spilled in 8 of those 60 instances (hack/torch_ptxas_variants.py
// flash_decode_mid). The same bound at 100 and 120, and at 256, whose two
// columns a thread hold up to 128 accumulators (R = 64). 0 at the other
// head dims: no bound, the same SASS as none given.
#ifndef DECODE_MID_MIN_BLOCKS
#define DECODE_MID_MIN_BLOCKS 2
#endif
template <int D>
constexpr int DECODE_MIN_BLOCKS =
    D == 80 || D == 96 || D == 100 || D == 120 || D == 256 ? DECODE_MID_MIN_BLOCKS : 0;

// One CTA: unit blockIdx.x (= ((b * Hkv + kvh) * row blocks + row block)),
// share blockIdx.y of its live tiles.
template <typename T, typename KT, int D, int R>
__global__ void __launch_bounds__(THREADS, DECODE_MIN_BLOCKS<D>) flash_decode_kernel(FlashArgs a) {
  // a thread owns one output column of every RH-th row: RH = 1 at D = 128
  // (and at 80, 96, 100 and 120, where threads D.. own none), 2 at D = 64, 4 at 32, 8
  // at 16 (rows t / D, t / D + RH, ...), NA rows; at R < RH the groups t /
  // D >= R own none; at D = 256 RH = 1 and CPT = 2 columns, t and t + 128,
  // of every row
  static_assert(D == 16 || D == 32 || D == 64 || D == 80 || D == 96 || D == 100 || D == 120 ||
                    D == 128 || D == 256,
                "head dim 16, 32, 64, 80, 96, 100, 120, 128 or 256");
  constexpr int CPT = D > THREADS ? D / THREADS : 1;
  constexpr int RH = D > THREADS ? 1 : THREADS / D;
  constexpr int NA = (R + RH - 1) / RH;
  using Ly = Layout<KT, D, R>;
  extern __shared__ __align__(16) char dsmem[];
  float* sQ = reinterpret_cast<float*>(dsmem + Ly::Q);
  float* sS = reinterpret_cast<float*>(dsmem + Ly::S);
  float* sM = reinterpret_cast<float*>(dsmem + Ly::M);
  float* sL = reinterpret_cast<float*>(dsmem + Ly::L);
  float* sC = reinterpret_cast<float*>(dsmem + Ly::C);
  int* sQpos = reinterpret_cast<int*>(dsmem + Ly::QPOS);

  const int t = threadIdx.x;
  // P V's column and row group (at RH = 1 the thread index itself, as
  // before), and whether the group owns a row
  const int col = RH == 1 ? t : t & (D - 1), rh = RH == 1 ? 0 : t / D;
  const bool owns = (R >= RH || rh < R) && (THREADS % D == 0 || t < D);
  const int group = a.Hq / a.Hkv;
  const int rows = a.Sq * group;
  const int nrb = (rows + R - 1) / R;
  const int unit = blockIdx.x;
  const int b = unit / (a.Hkv * nrb);
  const int kvh = unit / nrb % a.Hkv;
  const int r0 = unit % nrb * R;
  const int start = a.starts ? a.starts[a.n_start > 1 ? b : 0] : a.start;
  const int pad = a.pad_lens ? a.pad_lens[b] : 0;
  const int sink_hi = fa::sink_bound(pad, a.sinks);

  const Live live = live_tiles(start, pad, r0 / group, (min(r0 + R, rows) - 1) / group, a.Sk,
                               a.window, a.sinks);
  const int n = live.count();
  const int i0 = static_cast<int>(static_cast<long long>(blockIdx.y) * n / a.splits);
  const int i1 = static_cast<int>(static_cast<long long>(blockIdx.y + 1) * n / a.splits);

  if (t < R) {
    sM[t] = FA_NEG_INF;
    sL[t] = 0.f;
    // rows past the block's valid ones never attend (no key lies at or
    // below this position)
    sQpos[t] = r0 + t < rows ? start + (r0 + t) / group : -(1 << 30);
  }
  const Src<KT> src{static_cast<const KT*>(a.k) + b * a.k_sb + kvh * a.k_sh,
                    static_cast<const KT*>(a.v) + b * a.v_sb + kvh * a.v_sh,
                    a.k_scale ? a.k_scale + b * a.sc_sb + kvh * a.sc_sh : nullptr,
                    a.v_scale ? a.v_scale + b * a.sc_sb + kvh * a.sc_sh : nullptr,
                    a.k_ss, a.v_ss, a.sc_ss, a.Sk};
  float acc[CPT][NA];   // row rh + RH i, column col + THREADS c in acc[c][i]
#pragma unroll
  for (int c = 0; c < CPT; ++c)
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[c][i] = 0.f;

  if (i0 < i1) {
    load_stage<KT, D, R>(dsmem, src, live.at(i0));
    wg::copy_commit();
    const T* q = static_cast<const T*>(a.q);
    for (int idx = t; idx < R * D; idx += THREADS) {
      const int r = idx / D, d = idx % D, rg = r0 + r;
      sQ[idx] = rg < rows ? fa::to_f32(q[b * a.q_sb + (rg / group) * a.q_ss +
                                         (kvh * group + rg % group) * a.q_sh + d])
                          : 0.f;
    }
  }

  const float sl2 = a.scale * 1.4426950408889634f;   // scores in log2 units
  const int kc = t & (BK - 1), rsel = t >> 6;          // QK: key column, row parity
  const int warp = t >> 5, lane = t & 31;
  for (int i = i0; i < i1; ++i) {
    const char* stage = dsmem + (Ly::NSTAGE == 2 ? ((i - i0) & 1) * Ly::STAGE : 0);
    const int kv0 = live.at(i) * BK;
    if constexpr (Ly::NSTAGE == 1) {   // one stage: tile i once tile i - 1's readers are done
      if (i > i0) {
        __syncthreads();
        load_stage<KT, D, R>(dsmem, src, live.at(i));
        wg::copy_commit();
      }
    }
    wg::copy_wait<0>();
    __syncthreads();   // the tile is in; the other stage's, sS's and sC's readers are done
    if (Ly::NSTAGE == 2 && i + 1 < i1) {
      load_stage<KT, D, R>(dsmem + ((i + 1 - i0) & 1) * Ly::STAGE, src, live.at(i + 1));
      wg::copy_commit();
    }
    const float* ksc = reinterpret_cast<const float*>(stage + 2 * Ly::TILE);

    // S = Q K^T: this thread's key against rows rsel, rsel + 2, ...
    {
      float s[R / 2];
#pragma unroll
      for (int i2 = 0; i2 < R / 2; ++i2) s[i2] = 0.f;
      const char* krow = stage + kc * Ly::RB;
#pragma unroll 2
      for (int c = 0; c < Ly::CH; ++c) {
        float kx[Ly::VPC];
        unpack(*reinterpret_cast<const uint4*>(krow + c * 16), kx, KT());
#pragma unroll
        for (int i2 = 0; i2 < R / 2; ++i2) {
          const float* qr = sQ + (rsel + 2 * i2) * D + c * Ly::VPC;
#pragma unroll
          for (int v = 0; v < Ly::VPC; v += 4) {
            const float4 q4 = *reinterpret_cast<const float4*>(qr + v);
            s[i2] = fmaf(q4.x, kx[v], s[i2]);
            s[i2] = fmaf(q4.y, kx[v + 1], s[i2]);
            s[i2] = fmaf(q4.z, kx[v + 2], s[i2]);
            s[i2] = fmaf(q4.w, kx[v + 3], s[i2]);
          }
        }
      }
      if constexpr (Ly::TAIL != 0) {   // the row's last TV values: 4 at D = 100, 8 at 120
        constexpr int TV = Ly::TAIL / static_cast<int>(sizeof(KT));
        float kx[TV];
        unpack_tail(krow + Ly::CH * 16, kx, KT());
#pragma unroll
        for (int i2 = 0; i2 < R / 2; ++i2) {
#pragma unroll
          for (int v = 0; v < TV; v += 4) {
            const float4 q4 = *reinterpret_cast<const float4*>(sQ + (rsel + 2 * i2) * D +
                                                               Ly::CH * Ly::VPC + v);
            s[i2] = fmaf(q4.x, kx[v], s[i2]);
            s[i2] = fmaf(q4.y, kx[v + 1], s[i2]);
            s[i2] = fmaf(q4.z, kx[v + 2], s[i2]);
            s[i2] = fmaf(q4.w, kx[v + 3], s[i2]);
          }
        }
      }
      const int kp = kv0 + kc;
      const float mul = Ly::kInt8 ? sl2 * ksc[kc] : sl2;
#pragma unroll
      for (int i2 = 0; i2 < R / 2; ++i2) {
        const int r = rsel + 2 * i2;
        const bool keep =
            kp < a.Sk && fa::attendable(sQpos[r], kp, 1, pad, a.window, sink_hi);
        sS[r * BK + kc] = keep ? s[i2] * mul : FA_NEG_INF;
      }
    }
    __syncthreads();

    // the online softmax (_online_update), one warp a row: P in place of S,
    // times v_scale for int8; the rescale factor of each row into sC
    for (int r = warp; r < R; r += THREADS / 32) {
      float* srow = sS + r * BK;
      const float x0 = srow[lane], x1 = srow[lane + 32];
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(x0, x1)));
      const bool lv = m_new > FA_NEG_INF / 2;
      const float p0 = lv ? exp2f(x0 - m_new) : 0.f, p1 = lv ? exp2f(x1 - m_new) : 0.f;
      const float psum = warp_sum(p0 + p1);
      const float corr = exp2f(m_old - m_new);
      if constexpr (Ly::kInt8) {
        srow[lane] = p0 * ksc[BK + lane];
        srow[lane + 32] = p1 * ksc[BK + lane + 32];
      } else {
        srow[lane] = p0;
        srow[lane + 32] = p1;
      }
      if (lane == 0) {
        sM[r] = m_new;
        sL[r] = sL[r] * corr + psum;
        sC[r] = corr;
      }
    }
    __syncthreads();

    // acc += P V: this thread's columns of its rows
    if (!owns) continue;
#pragma unroll
    for (int i = 0; i < NA; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[c][i] *= sC[rh + RH * i];
    const char* vcol = stage + Ly::TILE + col * static_cast<int>(sizeof(KT));
#pragma unroll 2
    for (int k = 0; k < BK; k += 4) {
      float v[CPT][4];
#pragma unroll
      for (int c = 0; c < CPT; ++c)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          v[c][u] = fa::to_f32(*reinterpret_cast<const KT*>(
              vcol + (k + u) * Ly::RB + c * THREADS * static_cast<int>(sizeof(KT))));
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        const float4 p = *reinterpret_cast<const float4*>(sS + (rh + RH * i) * BK + k);
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          acc[c][i] = fmaf(p.x, v[c][0], acc[c][i]);
          acc[c][i] = fmaf(p.y, v[c][1], acc[c][i]);
          acc[c][i] = fmaf(p.z, v[c][2], acc[c][i]);
          acc[c][i] = fmaf(p.w, v[c][3], acc[c][i]);
        }
      }
    }
  }
  wg::copy_wait<0>();
  __syncthreads();   // sM / sL final (and initialised when the share is empty)

  if (a.splits == 1) {   // the whole live range: normalise and store
    T* out = static_cast<T*>(a.out);
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int r = rh + RH * i, rg = r0 + r;
      if (!owns || rg >= rows) break;
      const float l = sL[r];
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        fa::from_f32(out + b * a.o_sb + (rg / group) * a.o_ss +
                         (kvh * group + rg % group) * a.o_sh + col + c * THREADS,
                     l > 0.f ? acc[c][i] / l : 0.f);
    }
    return;
  }
  // a partial: acc [R][D] (not written for an empty share: its weight is
  // 0), then (m, l) per row
  float* ws = a.ws + (static_cast<long long>(unit) * a.splits + blockIdx.y) * R * (D + 2);
  if (i0 < i1 && owns) {
#pragma unroll
    for (int i = 0; i < NA; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c) ws[(rh + RH * i) * D + col + c * THREADS] = acc[c][i];
  }
  if (t < R) {
    ws[R * D + 2 * t] = sM[t];
    ws[R * D + 2 * t + 1] = sL[t];
  }
}

// The merge of one row of a unit's partials (a block per (unit, row),
// MERGE_THREADS<D>: a thread per column, one whole warp at D = 16, and at
// D = 256 128 threads of two columns each, t and t + 128): one
// warp reads the row's (m_i, l_i) of the P <= 32 partials at once and forms
// the weights w_i = 2^(m_i - M) / sum_j 2^(m_j - M) l_j, M the largest m_i;
// then each thread of a column sums its column's P partials, issued
// together. A row that no share attended (M = NEG_INF)
// gives zeros; an empty share's weight is 0 and its unwritten acc is
// never used.
template <int D>
constexpr int MERGE_THREADS = D < 32 ? 32 : D > THREADS ? THREADS : D;

template <typename T, int D, int R>
__global__ void __launch_bounds__(THREADS) flash_decode_merge_kernel(FlashArgs a) {
  __shared__ float sW[MAX_SPLITS];
  const int t = threadIdx.x;
  const int group = a.Hq / a.Hkv;
  const int rows = a.Sq * group;
  const int nrb = (rows + R - 1) / R;
  const int unit = blockIdx.x, r = blockIdx.y;
  const int rg = unit % nrb * R + r;
  if (rg >= rows) return;
  const int b = unit / (a.Hkv * nrb);
  const int kvh = unit / nrb % a.Hkv;
  const int P = a.splits;
  constexpr int PART = R * (D + 2);
  const float* ws = a.ws + static_cast<long long>(unit) * P * PART;
  if (t < 32) {
    const float m = t < P ? ws[t * PART + R * D + 2 * r] : FA_NEG_INF;
    const float l = t < P ? ws[t * PART + R * D + 2 * r + 1] : 0.f;
    const float M = warp_max(m);
    const float e = M > FA_NEG_INF / 2 ? exp2f(m - M) : 0.f;
    const float L = warp_sum(e * l);
    if (t < P) sW[t] = e > 0.f ? e / L : 0.f;
  }
  __syncthreads();
  if constexpr (D < 32) {
    if (t >= D) return;
  }
  constexpr int MC = D > THREADS ? D / THREADS : 1;   // columns t + THREADS c a thread
  float o[MC];
#pragma unroll
  for (int c = 0; c < MC; ++c) o[c] = 0.f;
#pragma unroll 8
  for (int i = 0; i < P; ++i) {
    const float w = sW[i];
#pragma unroll
    for (int c = 0; c < MC; ++c) {
      const float x = ws[i * PART + r * D + t + c * THREADS];
      o[c] = fmaf(w, w != 0.f ? x : 0.f, o[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < MC; ++c)
    fa::from_f32(static_cast<T*>(a.out) + b * a.o_sb + (rg / group) * a.o_ss +
                     (kvh * group + rg % group) * a.o_sh + t + c * THREADS,
                 o[c]);
}

template <typename T, typename KT, int D, int R>
cudaError_t launch(const FlashArgs& a, cudaStream_t stream) {
  constexpr int smem = Layout<KT, D, R>::BYTES;
  const int rows = a.Sq * (a.Hq / a.Hkv);
  const long long units = static_cast<long long>(a.B) * a.Hkv * ((rows + R - 1) / R);
  if (a.splits < 1 || a.splits > MAX_SPLITS || units > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (a.splits > 1 && (a.ws == nullptr || a.ws_floats < units * a.splits * R * (D + 2)))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(flash_decode_kernel<T, KT, D, R>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(static_cast<unsigned>(units), a.splits);
  flash_decode_kernel<T, KT, D, R><<<grid, THREADS, smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.splits == 1) return e;
  constexpr int merge_threads = MERGE_THREADS<D>;
  flash_decode_merge_kernel<T, D, R>
      <<<dim3(static_cast<unsigned>(units), R), merge_threads, 0, stream>>>(a);
  return cudaGetLastError();
}

// R: the smallest instance that holds a unit's S * group rows, 64 at most
// (ops/flash_attention.py _decode_rows).
template <typename T, typename KT, int D>
cudaError_t launch_rows(const FlashArgs& a, cudaStream_t s) {
  const int rows = a.Sq * (a.Hq / a.Hkv);
  if (rows <= 4) return launch<T, KT, D, 4>(a, s);
  if (rows <= 8) return launch<T, KT, D, 8>(a, s);
  if (rows <= 16) return launch<T, KT, D, 16>(a, s);
  if (rows <= 32) return launch<T, KT, D, 32>(a, s);
  return launch<T, KT, D, 64>(a, s);
}

template <int D>
cudaError_t dispatch(const FlashArgs& a, cudaStream_t s) {
  if (a.act_dtype == 0 && a.kv_dtype == 0) return launch_rows<float, float, D>(a, s);
  if (a.act_dtype == 0 && a.kv_dtype == 2) return launch_rows<float, int8_t, D>(a, s);
  if (a.act_dtype == 1 && a.kv_dtype == 1)
    return launch_rows<__nv_bfloat16, __nv_bfloat16, D>(a, s);
  if (a.act_dtype == 1 && a.kv_dtype == 2) return launch_rows<__nv_bfloat16, int8_t, D>(a, s);
  return cudaErrorInvalidValue;
}

}  // namespace
