// Shared numerics core of every forward attention kernel of this package:
// the Hopper counterpart of gpu_provisioner_tpu/ops/flash_attention.py's
// _online_softmax_tile, _online_update and _finalize_out. flash_fwd.cu
// (self-attention and KV-cache prefill) and flash_decode.cu (short query
// blocks against the cache) both include it, so a numerics fix lands once.
//
// Model of a block: BR = 16 * RPT query rows against the key/value sequence
// in tiles of BK = 64 keys, 128 threads. Thread t owns rows
// (t / 8) * RPT .. + RPT - 1 and, within a tile, key columns
// (t % 8) + 8 * c; the eight threads of one row group are neighbouring lanes
// of one warp, so row maxima and sums reduce with three shuffles. The output
// accumulator of a row lives in the same thread as that row's running max
// and denominator (columns (t % 8) + 8 * c of D), so rescaling never crosses
// threads. All arithmetic is f32 FMA from shared memory: simple and right
// first; tensor cores (mma.sync / wgmma) and TMA are later work.
//
// Masking follows the TPU kernels exactly, with NEG_INF the finite -1e30:
// key position kp is attendable from query position qp iff
//   kp < Sk, (!causal || kp <= qp), kp >= pad,
//   and, with a window, (kp > qp - window || kp < pad + sinks).
// A row with nothing attendable so far keeps m = NEG_INF and p = 0 (the
// `m_new > NEG_INF / 2` guard), and finalises to zeros and lse = NEG_INF.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define FA_NEG_INF (-1.0e30f)

// Argument block shared by both C entry points; mirrored field for field by
// ctypes.Structure FlashArgs in ops/flash_attention.py. Strides are in
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
  const int sink_hi = sinks > 0 ? pad + sinks : -2147483647;

  for (int j = lo_tile; j < hi_tile; ++j) {
    const int kv0 = j * BK;
    if (window > 0) {
      const bool below = kv0 + BK - 1 < min_qpos - window + 1;
      const bool sink = sinks > 0 && kv0 <= pad + sinks - 1;
      if (below && !sink) continue;
    }
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
        bool keep = st.valid[i] && kp < Sk && kp >= pad && (!causal || kp <= qp);
        if (window > 0) keep = keep && (kp > qp - window || kp < sink_hi);
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

}  // namespace fa
