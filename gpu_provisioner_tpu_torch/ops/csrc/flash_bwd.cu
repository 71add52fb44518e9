// Flash attention backward for Hopper (sm_90a): dQ and dK/dV of GQA
// self-attention, with P rebuilt from the forward's lse (FlashAttention-2
// section 3.2), as two kernels that each own their outputs.
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
// This first version computes in f32 FMA from shared memory (no tensor
// cores), far below the bf16 roofline. What its design does about the bound
// is to do only live work and no redundant passes:
//   - dQ: one block per (batch * q-head, 64-row query tile) that loops over
//     the live key tiles only (causal frontier, window band), the loop-bound
//     counterpart of the TPU's sequential kv grid axis, its `live` gate and
//     its index-map clamps. Rows owned as in the forward (flash_common.cuh).
//   - dK/dV: one block per (batch * kv-head, 32-key tile) that loops over the
//     group's q-heads and, for each, over the live query tiles only. GQA is
//     folded inside the block: the group's contributions add into one f32
//     accumulator, which replaces the TPU's per-q-head f32 dK/dV arrays and
//     their sum over the group after the kernel. 32 keys, not 64: the f32 dK
//     and dV accumulators of 32 keys x 128 dims are 64 registers a thread.
//   - Every output element has one owner block, so there are no atomics and
//     the results are the same run to run.
// The opt-in flattened-triangle kernels _bwd_*_tri compute the same
// function over one flat list of the live causal tiles; their Hopper
// counterparts, a persistent balanced schedule over that list, are in
// flash_tri.cu and share the tile steps (dq_tile, dkv_tile in
// flash_common.cuh) with the kernels here. Tensor cores (wgmma) and TMA are
// later work.
#include "flash_common.cuh"

namespace {

constexpr int DQ_RPT = 4;      // dQ: 16 * 4 = 64 query rows per block
constexpr int DKV_KPT = 2;     // dK/dV: 16 * 2 = 32 keys per block
constexpr int DKV_BQ = 64;     // dK/dV: query tile, 8 lanes x 8 columns

template <int D>
constexpr size_t dq_smem() {   // sQ, sdO [BR][D+1]; sK, sV [BK][D+1]; sdS [BR][BK+1]
  return sizeof(float) * (2 * 16 * DQ_RPT * (D + 1) + 2 * fa::BK * (D + 1) +
                          16 * DQ_RPT * (fa::BK + 1));
}

template <int D>
constexpr size_t dkv_smem() {  // sK, sV [BKV][D+1]; sQ, sdO [BQ][D+1]; sP, sdS [BKV][BQ+1]; lse, delta
  return sizeof(float) * (2 * 16 * DKV_KPT * (D + 1) + 2 * DKV_BQ * (D + 1) +
                          2 * 16 * DKV_KPT * (DKV_BQ + 1) + 2 * DKV_BQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(fa::NTHREADS) flash_bwd_dq_kernel(FlashBwdArgs a) {
  constexpr int RPT = DQ_RPT, BR = 16 * RPT, BK = fa::BK;
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
  float lse[RPT], delta[RPT], acc[RPT][D / 8];
  int qpos[RPT];
  bool valid[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    qpos[i] = q0 + rg * RPT + i;
    valid[i] = qpos[i] < a.S;
    lse[i] = valid[i] ? a.lse[rows + qpos[i]] : FA_NEG_INF;
    delta[i] = valid[i] ? a.delta[rows + qpos[i]] : 0.f;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) acc[i][c] = 0.f;
  }

  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  const int2 keys = fa::live_keys(q0, min(q0 + BR, a.S) - 1, a.S, a.causal, a.window);
  for (int kv0 = keys.x / BK * BK; kv0 < keys.y; kv0 += BK)
    fa::dq_tile<T, D, RPT>(sQ, sdO, sK, sV, sdS, acc, lse, delta, qpos, valid, kb, vb, a.k_ss,
                           a.v_ss, kv0, a.S, a.causal, a.window, a.scale);

  T* dq = static_cast<T*>(a.dq) + b * a.dq_sb + h * a.dq_sh;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    if (!valid[i]) continue;
    T* o = dq + qpos[i] * a.dq_ss;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) fa::from_f32(o + lane_c + 8 * c, acc[i][c]);
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
  float dk[KPT][D / 8], dv[KPT][D / 8];
  int kpos[KPT];
#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    kpos[i] = k0 + rg * KPT + i;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) dk[i][c] = dv[i][c] = 0.f;
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
    for (int c = 0; c < D / 8; ++c) {
      fa::from_f32(dkb + kpos[i] * a.dk_ss + lane_c + 8 * c, dk[i][c]);
      fa::from_f32(dvb + kpos[i] * a.dv_ss + lane_c + 8 * c, dv[i][c]);
    }
  }
}

template <typename T, int D>
cudaError_t launch_dq(const FlashBwdArgs& a, cudaStream_t stream) {
  constexpr int BR = 16 * DQ_RPT;
  constexpr size_t smem = dq_smem<D>();
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid(a.B * a.Hq, (a.S + BR - 1) / BR);
  flash_bwd_dq_kernel<T, D><<<grid, fa::NTHREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const FlashBwdArgs& a, cudaStream_t stream) {
  constexpr int BKV = 16 * DKV_KPT;
  constexpr size_t smem = dkv_smem<D>();
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid(a.B * a.Hkv, (a.S + BKV - 1) / BKV);
  flash_bwd_dkv_kernel<T, D><<<grid, fa::NTHREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

bool takes(const FlashBwdArgs* a) {
  return a->D == 128 && (a->act_dtype == 0 || a->act_dtype == 1) && a->Hkv > 0 &&
         a->Hq % a->Hkv == 0;
}

}  // namespace

// Both launch on `stream`, allocate nothing and do not synchronise; each
// returns cudaGetLastError() after its launch (0 on success).
extern "C" int flash_bwd_dq(const FlashBwdArgs* a, void* stream) {
  if (a->S <= 0 || a->B <= 0) return 0;
  if (!takes(a)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(a->act_dtype == 0 ? launch_dq<float, 128>(*a, s)
                                            : launch_dq<__nv_bfloat16, 128>(*a, s));
}

extern "C" int flash_bwd_dkv(const FlashBwdArgs* a, void* stream) {
  if (a->S <= 0 || a->B <= 0) return 0;
  if (!takes(a)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(a->act_dtype == 0 ? launch_dkv<float, 128>(*a, s)
                                            : launch_dkv<__nv_bfloat16, 128>(*a, s));
}
