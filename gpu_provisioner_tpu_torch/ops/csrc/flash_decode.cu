// Decode-step attention for Hopper (sm_90a): a short query block
// (S <= DECODE_MAX_S = 16 positions) per row against the KV cache.
//
// Replaces gpu_provisioner_tpu/ops/flash_attention.py:_kernel_decode
// (behind flash_attention_decode). One block per (batch, kv head) holds all
// S * group query rows of that kv head (16 * 4 = 64 rows at Llama-7B's GQA
// group of 4; more rows split over a second grid axis) and walks the live
// cache prefix once, so every GQA query of the head shares one read of each
// cache tile. Query row r sits at position start_b + r / group and belongs
// to q-head kvh * group + r % group (the row-major (s, g) order of the TPU
// kernel). `start` is one value or one per row (the serving engine's
// per-slot lengths); pads, int8 scales, a window and sinks mask as in the
// TPU kernel.
//
// What bounds it on an H100: bytes. A step reads each row's live cache
// prefix (K and V, Hkv heads, D values each) and does about 4 * group
// operations per cached element, far below the card's ~295 operations per
// byte. What the design does about it: only live tiles are read (causal
// frontier per row, pad floor, window band plus sinks), each once for all
// group queries, dequantising int8 in shared memory so only the int8 bytes
// cross device memory. What it does not do yet: with one block per
// (batch, kv head) a small batch fills few of the 132 SMs, so one block's
// sequential walk sets the time; a split-KV variant that spreads a row's
// prefix over many blocks and merges by log-sum-exp is later work.
#include "flash_common.cuh"

namespace {

template <typename T, typename KT, int D, int RPT>
__global__ void __launch_bounds__(fa::NTHREADS) flash_decode_kernel(FlashArgs a) {
  constexpr int BR = 16 * RPT;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BR * (D + 1);
  float* sV = sK + fa::BK * (D + 1);
  float* sP = sV + fa::BK * D;

  const int lane_c = threadIdx.x & 7;
  const int rg = threadIdx.x >> 3;
  const int group = a.Hq / a.Hkv;
  const int rows = a.Sq * group;
  const int b = blockIdx.x / a.Hkv;
  const int kvh = blockIdx.x % a.Hkv;
  const int r0 = blockIdx.y * BR;
  const int start = a.starts ? a.starts[a.n_start > 1 ? b : 0] : a.start;
  const int pad = a.pad_lens ? a.pad_lens[b] : 0;

  const T* q = static_cast<const T*>(a.q);
  fa::RowState<D, RPT> st;
  fa::init_state(st);
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = r0 + rg * RPT + i;
    const int s = r / group;
    const int h = kvh * group + r % group;
    st.valid[i] = r < rows;
    st.qpos[i] = start + s;
    fa::load_q_row<T, D>(sQ, rg * RPT + i,
                         st.valid[i] ? q + b * a.q_sb + s * a.q_ss + h * a.q_sh : nullptr,
                         lane_c);
  }

  const int last = min(r0 + BR, rows) - 1;
  const int hi = min(a.Sk, start + last / group + 1);
  const int lo_tile = pad / fa::BK;
  const int hi_tile = hi > 0 ? (hi + fa::BK - 1) / fa::BK : 0;

  const KT* kb = static_cast<const KT*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const KT* vb = static_cast<const KT*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  const float* ksb = a.k_scale ? a.k_scale + b * a.sc_sb + kvh * a.sc_sh : nullptr;
  const float* vsb = a.v_scale ? a.v_scale + b * a.sc_sb + kvh * a.sc_sh : nullptr;
  fa::attend_tiles<KT, D, RPT>(sQ, sK, sV, sP, st, kb, vb, ksb, vsb, a.k_ss, a.v_ss, a.sc_ss,
                               a.Sk, /*causal=*/1, pad, a.window, a.sinks, a.scale, lo_tile,
                               hi_tile, start + r0 / group);

  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    fa::finalize_row(st, i);
    if (!st.valid[i]) continue;
    const int r = r0 + rg * RPT + i;
    T* o = out + b * a.o_sb + (r / group) * a.o_ss + (kvh * group + r % group) * a.o_sh;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) fa::from_f32(o + lane_c + 8 * c, st.acc[i][c]);
  }
}

template <typename T, typename KT, int D, int RPT>
cudaError_t launch(const FlashArgs& a, cudaStream_t stream) {
  constexpr int BR = 16 * RPT;
  constexpr size_t smem = fa::smem_bytes<D, RPT>();
  cudaError_t e = cudaFuncSetAttribute(flash_decode_kernel<T, KT, D, RPT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int rows = a.Sq * (a.Hq / a.Hkv);
  dim3 grid(a.B * a.Hkv, (rows + BR - 1) / BR);
  flash_decode_kernel<T, KT, D, RPT><<<grid, fa::NTHREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// 16-row blocks for a plain decode step (S = 1: group rows), 64-row blocks
// for verify-sized blocks.
template <typename T, typename KT, int D>
cudaError_t launch_rows(const FlashArgs& a, cudaStream_t s) {
  if (a.Sq * (a.Hq / a.Hkv) <= 16) return launch<T, KT, D, 1>(a, s);
  return launch<T, KT, D, 4>(a, s);
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

// Launches on `stream`, allocates nothing, does not synchronise; returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int flash_decode(const FlashArgs* a, void* stream) {
  if (a->Sq <= 0 || a->B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->D == 128) return static_cast<int>(dispatch<128>(*a, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
