// Causal flash attention for Hopper (sm_90a) on the flattened triangle at
// head dims 96 and 80 (Phi-3-mini's 32/32 heads of 96, H2O-Danube-1.8B's
// 32/8 of 80): the C entries over flash_tri.cuh's kernels, whose bf16 tiles
// at these head dims are D = 128's two atoms, the second partly filled. A
// source of its own, so that nvcc builds these instances beside
// flash_tri.cu's 128 and 64 and flash_tri_narrow.cu's 32 and 16.
#include "flash_tri.cuh"

namespace {
using Dims = HeadDims<96, 80>;
}  // namespace

// As flash_tri.cu's flash_tri_ctas and flash_tri_ws_floats, for head dims
// 96 and 80.
extern "C" int flash_tri_ctas(int which, int act_dtype, int head_dim) {
  return tri_ctas<Dims>(which, act_dtype, head_dim);
}

extern "C" long long flash_tri_ws_floats(int which, int act_dtype, int head_dim) {
  return tri_ws_floats<Dims>(which, act_dtype, head_dim);
}

// As flash_fwd_tri, flash_bwd_dq_tri and flash_bwd_dkv_tri (flash_tri.cu),
// for head dims 96 and 80 (cudaErrorInvalidValue for any other).
extern "C" int flash_fwd_tri_mid(const FlashTriArgs* a, void* stream) {
  return run<Dims>(FWD, a, stream);
}

extern "C" int flash_bwd_dq_tri_mid(const FlashTriArgs* a, void* stream) {
  return run<Dims>(DQ, a, stream);
}

extern "C" int flash_bwd_dkv_tri_mid(const FlashTriArgs* a, void* stream) {
  return run<Dims>(DKV, a, stream);
}
