// Flash attention forward for Hopper (sm_90a): one kernel for GQA
// self-attention and for fresh queries against a KV cache.
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
// near the same line. This first version computes in f32 FMA from shared
// memory (no tensor cores), so it runs well below the bf16 roofline; what
// its design does about the bound is to do only the live work: one block per
// (batch * q-head, 64-row query tile) loops over the live key tiles only
// (causal frontier, pad floor, window band plus sinks), which replaces the
// TPU's sequential kv grid axis and its index-map clamps
// (_causal_kv_index), so dead tiles cost neither compute nor bytes. GQA
// costs no copy: q-head h reads kv head h / group. The persistent causal
// schedule (one flat list of live tiles in equal shares per CTA, the
// counterpart of the TPU's _kernel_tri) lives in flash_tri.cu, behind
// triangular=True. Tensor cores (wgmma with bf16 operands) and TMA loads are
// later work.
#include "flash_common.cuh"

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
    for (int c = 0; c < D / 8; ++c) fa::from_f32(o + lane_c + 8 * c, st.acc[i][c]);
    if (a.lse != nullptr && lane_c == 0) a.lse[((long long)b * a.Hq + h) * a.Sq + s] = lse;
  }
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
  if (a.act_dtype == 1 && a.kv_dtype == 1) return launch<__nv_bfloat16, __nv_bfloat16, D>(a, s);
  if (a.act_dtype == 1 && a.kv_dtype == 2) return launch<__nv_bfloat16, int8_t, D>(a, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// Launches on `stream`, allocates nothing, does not synchronise; returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int flash_fwd(const FlashArgs* a, void* stream) {
  if (a->Sq <= 0 || a->B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->D == 128) return static_cast<int>(dispatch<128>(*a, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
