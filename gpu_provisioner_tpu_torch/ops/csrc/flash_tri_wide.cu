// Causal flash attention for Hopper (sm_90a) on the flattened triangle at
// head dim 256 (Gemma-2B's 8/1 heads of 256): the C entries over
// flash_tri.cuh's kernels, whose bf16 forward and dK/dV take each (batch,
// head, column half of 128) as a row of the flat list there (dQ both
// halves in one CTA). A source of its own, so that nvcc builds these
// instances beside flash_tri.cu's 128 and 64, flash_tri_narrow.cu's 32 and
// 16 and flash_tri_mid.cu's 96 and 80.
#include "flash_tri.cuh"

namespace {
using Dims = HeadDims<256, 256>;
}  // namespace

// As flash_tri.cu's flash_tri_ctas and flash_tri_ws_floats, for head dim
// 256.
extern "C" int flash_tri_ctas(int which, int act_dtype, int head_dim) {
  return tri_ctas<Dims>(which, act_dtype, head_dim);
}

extern "C" long long flash_tri_ws_floats(int which, int act_dtype, int head_dim) {
  return tri_ws_floats<Dims>(which, act_dtype, head_dim);
}

// As flash_fwd_tri, flash_bwd_dq_tri and flash_bwd_dkv_tri (flash_tri.cu),
// for head dim 256 (cudaErrorInvalidValue for any other).
extern "C" int flash_fwd_tri_wide(const FlashTriArgs* a, void* stream) {
  return run<Dims>(FWD, a, stream);
}

extern "C" int flash_bwd_dq_tri_wide(const FlashTriArgs* a, void* stream) {
  return run<Dims>(DQ, a, stream);
}

extern "C" int flash_bwd_dkv_tri_wide(const FlashTriArgs* a, void* stream) {
  return run<Dims>(DKV, a, stream);
}
