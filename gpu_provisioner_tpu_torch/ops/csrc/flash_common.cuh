// Shared numerics core of every attention kernel of this package: the Hopper
// counterpart of gpu_provisioner_tpu/ops/flash_attention.py's
// _online_softmax_tile, _online_update and _finalize_out (forward), and of
// the mask and P rebuild of _rebuild_p_ds and the tile steps _bwd_dq_step /
// _bwd_dkv_step (backward). flash_fwd.cu (self-attention and KV-cache
// prefill), flash_decode.cuh (short query blocks against the cache),
// flash_bwd.cu (dQ and dK/dV) and flash_tri.cuh (the same functions on the
// persistent flattened-triangle schedule) all include it, so the mask, the
// NEG_INF guard, a tile step and a numerics fix land once.
//
// Model of a forward block: BR = 16 * RPT query rows against the key/value
// sequence in tiles of BK = 64 keys, 128 threads. Thread t owns rows
// (t / 8) * RPT .. + RPT - 1 and, within a tile, key columns
// (t % 8) + 8 * c; the eight threads of one row group are neighbouring lanes
// of one warp, so row maxima and sums reduce with three shuffles. The output
// accumulator of a row lives in the same thread as that row's running max
// and denominator (columns (t % 8) + 8 * c of D), so rescaling never crosses
// threads. All arithmetic is f32 FMA from shared memory: the exactness
// instances of the forward (f32 activations, an f32 or int8 cache) use it.
// The bf16 tile steps run on the tensor cores (flash_tc.cuh, on
// flash_wgmma.cuh's products); flash_decode.cuh keeps its own split
// schedule and f32 FMA loops over the mask and window helpers below.
//
// Masking follows the TPU kernels exactly, with NEG_INF the finite -1e30
// (attendable() below is its one home): key position kp is attendable from
// query position qp iff
//   kp < Sk, (!causal || kp <= qp), kp >= pad,
//   and, with a window, (kp > qp - window || kp < pad + sinks).
// A row with nothing attendable so far keeps m = NEG_INF and p = 0 (the
// `m_new > NEG_INF / 2` guard), and finalises to zeros and lse = NEG_INF;
// the backward rebuilds P = 0 on such rows (p_from_lse).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define FA_NEG_INF (-1.0e30f)

// Argument block shared by both C entry points; mirrored field for field by
// ctypes.Structure FlashArgs in ops/_cuda.py. Strides are in
// elements; the last (head) dimension is contiguous for q, k, v and out.
struct FlashArgs {
  const void* q;          // [B, Sq, Hq, D] act dtype
  const void* k;          // keys: positions x heads, strided (token- or head-major)
  const void* v;
  const float* k_scale;   // int8 cache: per-token-per-head f32 scales, or null
  const float* v_scale;
  void* out;              // [B, Sq, Hq, D] act dtype
  float* lse;             // [B, Hq, Sq] f32, or null
  const int* starts;      // device int32 [n_start], or null (use `start`)
  const int* pad_lens;    // device int32 [B], or null (no pads)
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long sc_sb, sc_ss, sc_sh;   // shared by k_scale and v_scale
  long long o_sb, o_ss, o_sh;
  int act_dtype;          // 0 f32, 1 bf16
  int kv_dtype;           // 0 f32, 1 bf16, 2 int8
  int B, Sq, Sk, Hq, Hkv, D;
  int start;              // query position of q row 0 when starts is null
  int n_start;            // 1 (one start for all rows) or B (per row)
  int causal;
  int window;             // <= 0: no window
  int sinks;
  float scale;
  // flash_decode's split schedule: the CTAs sharing each (batch, kv head,
  // row block)'s live key tiles, and the f32 workspace of their partials
  // (ws_floats long; unused, and may be null, when splits is 1)
  float* ws;
  long long ws_floats;
  int splits;
};

// Argument block of the backward entry points (flash_bwd.cu), mirrored by
// ctypes.Structure FlashBwdArgs in ops/_cuda.py. GQA self-attention at
// positions 0..S-1 (no pads, no sinks). Strides in elements, in (batch,
// position, head) order; the head dimension is contiguous everywhere.
struct FlashBwdArgs {
  const void* q;          // [B, S, Hq, D] act dtype
  const void* k;          // [B, S, Hkv, D]
  const void* v;
  const void* dout;       // [B, S, Hq, D] cotangent of out
  const float* lse;       // [B, Hq, S] f32, contiguous: the forward's
  const float* delta;     // [B, Hq, S] f32, contiguous: rowsum(dO o O) - g_lse
  void* dq;               // [B, S, Hq, D] act dtype
  void* dk;               // [B, S, Hkv, D]
  void* dv;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh;
  long long dq_sb, dq_ss, dq_sh;
  long long dk_sb, dk_ss, dk_sh;
  long long dv_sb, dv_ss, dv_sh;
  int act_dtype;          // 0 f32, 1 bf16 (every tensor but lse / delta)
  int B, S, Hq, Hkv, D;
  int causal;
  int window;             // <= 0: no window
  float scale;
};

// Argument block of the flattened-triangle entry points (flash_tri.cuh),
// mirrored by ctypes.Structure FlashTriArgs in ops/_cuda.py. Causal GQA
// self-attention at positions 0..S-1 (no window, pads or sinks); strides in
// elements, in (batch, position, head) order, the head dimension contiguous.
// The forward reads q, k, v and writes out, lse; dQ reads q, k, v, dout,
// lse, delta and writes dq; dK/dV the same and writes dk, dv. `ws` is the
// f32 workspace of cut rows, `ws_floats` long (at least `ctas` times
// flash_tri_ws_floats(), allocated by the wrapper), and `ctas` the
// persistent grid, from flash_tri_ctas().
struct FlashTriArgs {
  const void* q;          // [B, S, Hq, D] act dtype
  const void* k;          // [B, S, Hkv, D]
  const void* v;
  const void* dout;       // [B, S, Hq, D] cotangent of out
  void* out;              // [B, S, Hq, D]
  float* lse;             // [B, Hq, S] f32, contiguous: written by the forward
  const float* delta;     // [B, Hq, S] f32, contiguous: rowsum(dO o O) - g_lse
  void* dq;               // [B, S, Hq, D]
  void* dk;               // [B, S, Hkv, D]
  void* dv;
  float* ws;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh;
  long long o_sb, o_ss, o_sh;
  long long dq_sb, dq_ss, dq_sh;
  long long dk_sb, dk_ss, dk_sh;
  long long dv_sb, dv_ss, dv_sh;
  long long ws_floats;    // f32 values in ws
  int act_dtype;          // 0 f32, 1 bf16 (every tensor but lse / delta / ws)
  int B, S, Hq, Hkv, D;
  int ctas;
  float scale;
};

namespace fa {

constexpr int NTHREADS = 128;
constexpr int BK = 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float row_max8(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
}

__device__ __forceinline__ float row_sum8(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 1);
}

// sink_hi of attendable(): keys below it stay attendable under a window.
__device__ __forceinline__ int sink_bound(int pad, int sinks) {
  return sinks > 0 ? pad + sinks : -2147483647;
}

// The mask (both positions in range): key kp attendable from query qp.
__device__ __forceinline__ bool attendable(int qp, int kp, int causal, int pad, int window,
                                           int sink_hi) {
  bool keep = kp >= pad && (!causal || kp <= qp);
  if (window > 0) keep = keep && (kp > qp - window || kp < sink_hi);
  return keep;
}

// _rebuild_p_ds's P for one (query, key) pair from the forward's lse:
// exp(s - lse) where attendable, 0 where masked and on rows that attended
// nothing (lse = NEG_INF), with s the scaled score.
__device__ __forceinline__ float p_from_lse(bool keep, float s, float lse) {
  return keep && lse > FA_NEG_INF / 2 ? expf(s - lse) : 0.f;
}

// Self-attention (positions 0..S-1, no pads or sinks): the keys [x, y) that
// some query of [q0, q1] attends, and the queries [x, y) that attend some
// key of [k0, k1]. The backward loops run over these ranges only, the
// counterpart of the TPU kernels' `live` gates.
__device__ __forceinline__ int2 live_keys(int q0, int q1, int S, int causal, int window) {
  return make_int2(window > 0 ? max(0, q0 - window + 1) : 0, causal ? min(S, q1 + 1) : S);
}

__device__ __forceinline__ int2 live_queries(int k0, int k1, int S, int causal, int window) {
  return make_int2(causal ? k0 : 0, window > 0 ? min(S, k1 + window) : S);
}

// The window's key-tile gate of a forward block whose first query sits at
// position min_qpos (the TPU kernels' `live` window clause and index-map
// clamp): the BK-key tile at kv0 is skipped when it lies wholly below that
// row's window and does not overlap the sinks [pad, pad + sinks).
__device__ __forceinline__ bool window_skips(int kv0, int min_qpos, int window, int pad,
                                             int sinks) {
  if (window <= 0) return false;
  const bool below = kv0 + BK - 1 < min_qpos - window + 1;
  const bool sink = sinks > 0 && kv0 <= pad + sinks - 1;
  return below && !sink;
}

// The first key tile that is not wholly below the window of the row at
// min_qpos: every skipped tile (window_skips) lies before it, and every
// tile from the first skipped one up to it is skipped.
__device__ __forceinline__ int window_first_tile(int min_qpos, int window) {
  const int x = min_qpos - window - (BK - 2);   // tile j is below iff BK j < x
  return window > 0 && x > 0 ? (x + BK - 1) / BK : 0;
}

// Shared-memory floats a block needs: Q and K padded to D + 1 (conflict-free
// column reads), V, and the probability tile padded to BK + 1.
template <int D, int RPT>
constexpr size_t smem_bytes() {
  return sizeof(float) * (16 * RPT * (D + 1) + BK * (D + 1) + BK * D + 16 * RPT * (BK + 1));
}

// Running softmax state of the rows a thread owns.
template <int D, int RPT>
struct RowState {
  float acc[RPT][D / 8];
  float m[RPT];
  float l[RPT];
  int qpos[RPT];   // query position of each row (ignored when !valid)
  bool valid[RPT];
};

// One (batch, kv head) walk over the live key tiles. sQ must already hold
// the block's query rows (f32, [BR][D + 1]; invalid rows zero). `kb` / `vb`
// point at this (batch, kv head)'s first key; `scb` at its first scale (int8
// only). The loop visits tiles [lo_tile, hi_tile) and skips tiles that lie
// wholly below every row's window edge unless they overlap the sink range,
// the loop-bound counterpart of the TPU kernels' `live` gates and index-map
// clamps (_causal_kv_index).
template <typename KT, int D, int RPT>
__device__ void attend_tiles(const float* sQ, float* sK, float* sV, float* sP,
                             RowState<D, RPT>& st, const KT* kb, const KT* vb,
                             const float* ksb, const float* vsb,
                             long long k_ss, long long v_ss, long long sc_ss,
                             int Sk, int causal, int pad, int window, int sinks,
                             float scale, int lo_tile, int hi_tile, int min_qpos) {
  const int tid = threadIdx.x;
  const int lane_c = tid & 7;
  const int rg = tid >> 3;
  const int sink_hi = sink_bound(pad, sinks);

  for (int j = lo_tile; j < hi_tile; ++j) {
    const int kv0 = j * BK;
    if (window_skips(kv0, min_qpos, window, pad, sinks)) continue;
    __syncthreads();   // previous tile's sK / sV reads are done
    for (int idx = tid; idx < BK * D; idx += NTHREADS) {
      const int r = idx / D, d = idx % D;
      const int kp = kv0 + r;
      float kval = 0.f, vval = 0.f;
      if (kp < Sk) {
        kval = to_f32(kb[kp * k_ss + d]);
        vval = to_f32(vb[kp * v_ss + d]);
        if (ksb != nullptr) {
          kval *= ksb[kp * sc_ss];
          vval *= vsb[kp * sc_ss];
        }
      }
      sK[r * (D + 1) + d] = kval;
      sV[r * D + d] = vval;
    }
    __syncthreads();

    float s[RPT][8];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) s[i][c] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[8];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = sQ[(rg * RPT + i) * (D + 1) + d];
#pragma unroll
      for (int c = 0; c < 8; ++c) kv[c] = sK[(lane_c + 8 * c) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qp = st.qpos[i];
      float mx = FA_NEG_INF;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int kp = kv0 + lane_c + 8 * c;
        const bool keep =
            st.valid[i] && kp < Sk && attendable(qp, kp, causal, pad, window, sink_hi);
        s[i][c] = keep ? s[i][c] * scale : FA_NEG_INF;
        mx = fmaxf(mx, s[i][c]);
      }
      // _online_update: running max, guarded exp, rescale, denominator
      const float m_new = fmaxf(st.m[i], row_max8(mx));
      const bool live = m_new > FA_NEG_INF / 2;
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float p = live ? expf(s[i][c] - m_new) : 0.f;
        sP[(rg * RPT + i) * (BK + 1) + lane_c + 8 * c] = p;
        psum += p;
      }
      const float corr = expf(st.m[i] - m_new);
      st.m[i] = m_new;
      st.l[i] = st.l[i] * corr + row_sum8(psum);
#pragma unroll
      for (int c = 0; c < D / 8; ++c) st.acc[i][c] *= corr;
    }
    __syncwarp();   // a row group's P is written and read by one warp

    for (int kk = 0; kk < BK; ++kk) {
      float vv[D / 8];
#pragma unroll
      for (int c = 0; c < D / 8; ++c) vv[c] = sV[kk * D + lane_c + 8 * c];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float p = sP[(rg * RPT + i) * (BK + 1) + kk];
#pragma unroll
        for (int c = 0; c < D / 8; ++c) st.acc[i][c] = fmaf(p, vv[c], st.acc[i][c]);
      }
    }
  }
}

template <int D, int RPT>
__device__ __forceinline__ void init_state(RowState<D, RPT>& st) {
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    st.m[i] = FA_NEG_INF;
    st.l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) st.acc[i][c] = 0.f;
  }
}

// _finalize_out: acc / l where l > 0 (zeros otherwise); lse = m + log l or
// NEG_INF for a row that attended nothing.
template <int D, int RPT>
__device__ __forceinline__ float finalize_row(RowState<D, RPT>& st, int i) {
  const float l = st.l[i];
  if (l > 0.f) {
#pragma unroll
    for (int c = 0; c < D / 8; ++c) st.acc[i][c] /= l;
  }
  return l > 0.f ? st.m[i] + logf(l) : FA_NEG_INF;
}

// Loads query row `r` (D contiguous values at `src`, or zeros when null)
// into sQ as f32; the eight lanes of a row group share the row.
template <typename T, int D>
__device__ __forceinline__ void load_q_row(float* sQ, int r, const T* src, int lane_c) {
  for (int d = lane_c; d < D; d += 8) sQ[r * (D + 1) + d] = src ? to_f32(src[d]) : 0.f;
}

// Rows row0 .. row0 + n - 1 of one (batch, head) slice into shared memory as
// f32, [n][D + 1]; rows at or past S are zero. Neighbouring threads read
// neighbouring elements of a row.
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, int n, const T* base, long long row_stride,
                                          int row0, int S) {
  for (int idx = threadIdx.x; idx < n * D; idx += NTHREADS) {
    const int r = idx / D, d = idx % D;
    const int pos = row0 + r;
    dst[r * (D + 1) + d] = pos < S ? to_f32(base[pos * row_stride + d]) : 0.f;
  }
}

// One dQ tile of the backward (_bwd_dq_step): keys kv0 .. kv0 + BK - 1 of
// one (batch, kv head) (`kb` / `vb` at its first key) against the block's
// 16 * RPT query rows, already in sQ / sdO with their lse and delta in
// registers: S = Q K^T and dP = dO V^T for the thread's rows x columns,
// dS = P o (dP - delta) * scale into sdS, acc += dS K. Self-attention at
// positions 0..S-1 (no pads or sinks). Rows owned as in the forward.
template <typename T, int D, int RPT>
__device__ void dq_tile(const float* sQ, const float* sdO, float* sK, float* sV, float* sdS,
                        float (&acc)[RPT][D / 8], const float (&lse)[RPT],
                        const float (&delta)[RPT], const int (&qpos)[RPT],
                        const bool (&valid)[RPT], const T* kb, const T* vb, long long k_ss,
                        long long v_ss, int kv0, int S, int causal, int window, float scale) {
  const int lane_c = threadIdx.x & 7;
  const int rg = threadIdx.x >> 3;
  const int no_sinks = sink_bound(0, 0);
  __syncthreads();   // previous tile's sK / sV reads are done
  load_rows<T, D>(sK, BK, kb, k_ss, kv0, S);
  load_rows<T, D>(sV, BK, vb, v_ss, kv0, S);
  __syncthreads();

  float s[RPT][8], dp[RPT][8];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) s[i][c] = dp[i][c] = 0.f;
  for (int d = 0; d < D; ++d) {
    float qv[RPT], gv[RPT], kv[8], vv[8];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      qv[i] = sQ[(rg * RPT + i) * (D + 1) + d];
      gv[i] = sdO[(rg * RPT + i) * (D + 1) + d];
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      kv[c] = sK[(lane_c + 8 * c) * (D + 1) + d];
      vv[c] = sV[(lane_c + 8 * c) * (D + 1) + d];
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
        dp[i][c] = fmaf(gv[i], vv[c], dp[i][c]);
      }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int kp = kv0 + lane_c + 8 * c;
      const bool keep =
          valid[i] && kp < S && attendable(qpos[i], kp, causal, 0, window, no_sinks);
      const float p = p_from_lse(keep, s[i][c] * scale, lse[i]);
      sdS[(rg * RPT + i) * (BK + 1) + lane_c + 8 * c] = p * (dp[i][c] - delta[i]) * scale;
    }
  __syncwarp();   // a row group's dS is written and read by one warp

  for (int kk = 0; kk < BK; ++kk) {
    float kr[D / 8];
#pragma unroll
    for (int c = 0; c < D / 8; ++c) kr[c] = sK[kk * (D + 1) + lane_c + 8 * c];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float ds = sdS[(rg * RPT + i) * (BK + 1) + kk];
#pragma unroll
      for (int c = 0; c < D / 8; ++c) acc[i][c] = fmaf(ds, kr[c], acc[i][c]);
    }
  }
}

// One dK/dV tile of the backward (_bwd_dkv_step): queries q0 .. q0 + BQ - 1
// of one q-head (`qb` / `gb` at its first query, `lse_row` / `delta_row` at
// its row of lse and delta) against the block's 16 * KPT keys, already in
// sK / sV: S^T = K Q^T and dP^T = V dO^T for the thread's keys x query
// columns (lane_c + 8 * c, c < BQ / 8), then dV += P^T dO, dK += dS^T Q.
template <typename T, int D, int KPT, int BQ>
__device__ void dkv_tile(const float* sK, const float* sV, float* sQ, float* sdO, float* sP,
                         float* sdS, float* sL, float* sDelta, float (&dk)[KPT][D / 8],
                         float (&dv)[KPT][D / 8], const int (&kpos)[KPT], const T* qb,
                         const T* gb, long long q_ss, long long do_ss, const float* lse_row,
                         const float* delta_row, int q0, int S, int causal, int window,
                         float scale) {
  constexpr int NC = BQ / 8;
  const int lane_c = threadIdx.x & 7;
  const int rg = threadIdx.x >> 3;      // owns keys rg * KPT .. + KPT - 1
  const int no_sinks = sink_bound(0, 0);
  __syncthreads();   // previous tile's sQ / sdO / sP / sdS reads are done
  load_rows<T, D>(sQ, BQ, qb, q_ss, q0, S);
  load_rows<T, D>(sdO, BQ, gb, do_ss, q0, S);
  for (int r = threadIdx.x; r < BQ; r += NTHREADS) {
    const bool in = q0 + r < S;
    sL[r] = in ? lse_row[q0 + r] : FA_NEG_INF;
    sDelta[r] = in ? delta_row[q0 + r] : 0.f;
  }
  __syncthreads();

  float s[KPT][NC], dp[KPT][NC];
#pragma unroll
  for (int i = 0; i < KPT; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) s[i][c] = dp[i][c] = 0.f;
  for (int d = 0; d < D; ++d) {
    float kv[KPT], vv[KPT], qv[NC], gv[NC];
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      kv[i] = sK[(rg * KPT + i) * (D + 1) + d];
      vv[i] = sV[(rg * KPT + i) * (D + 1) + d];
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      qv[c] = sQ[(lane_c + 8 * c) * (D + 1) + d];
      gv[c] = sdO[(lane_c + 8 * c) * (D + 1) + d];
    }
#pragma unroll
    for (int i = 0; i < KPT; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        s[i][c] = fmaf(kv[i], qv[c], s[i][c]);
        dp[i][c] = fmaf(vv[i], gv[c], dp[i][c]);
      }
  }

#pragma unroll
  for (int i = 0; i < KPT; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = lane_c + 8 * c;
      const int qp = q0 + col;
      const bool keep = kpos[i] < S && qp < S &&
                        attendable(qp, kpos[i], causal, 0, window, no_sinks);
      const float p = p_from_lse(keep, s[i][c] * scale, sL[col]);
      sP[(rg * KPT + i) * (BQ + 1) + col] = p;
      sdS[(rg * KPT + i) * (BQ + 1) + col] = p * (dp[i][c] - sDelta[col]) * scale;
    }
  __syncwarp();   // a row group's P / dS rows are written and read by one warp

  for (int qq = 0; qq < BQ; ++qq) {
    float gr[D / 8], qr[D / 8];
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      gr[c] = sdO[qq * (D + 1) + lane_c + 8 * c];
      qr[c] = sQ[qq * (D + 1) + lane_c + 8 * c];
    }
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const float p = sP[(rg * KPT + i) * (BQ + 1) + qq];
      const float ds = sdS[(rg * KPT + i) * (BQ + 1) + qq];
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        dv[i][c] = fmaf(p, gr[c], dv[i][c]);
        dk[i][c] = fmaf(ds, qr[c], dk[i][c]);
      }
    }
  }
}

}  // namespace fa
