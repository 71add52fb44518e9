// Causal flash attention for Hopper (sm_90a) on the flattened triangle at
// head dims 120 (H2O-Danube3-4B's 32/8 heads of 120) and 100
// (OpenLLaMA-3B's 32/32 heads of 100): the C entries over flash_tri.cuh's
// kernels, whose bf16 tiles at these head dims are D = 128's two atoms, the
// second partly filled with a zeroed pad inside the last k-step; at 100 a
// row copied in 8-byte pieces (a row of 100 values is no whole number of
// 16-byte chunks), at 120 in its 15 chunks. A source of its own,
// so that nvcc builds these instances beside flash_tri.cu's 128 and 64,
// flash_tri_narrow.cu's 32 and 16, flash_tri_mid.cu's 96 and 80 and
// flash_tri_wide.cu's 256.
#include "flash_tri.cuh"

namespace {
using Dims = HeadDims<120, 100>;
}  // namespace

// As flash_tri.cu's flash_tri_ctas and flash_tri_ws_floats, for head dims
// 120 and 100.
extern "C" int flash_tri_ctas(int which, int act_dtype, int head_dim) {
  return tri_ctas<Dims>(which, act_dtype, head_dim);
}

extern "C" long long flash_tri_ws_floats(int which, int act_dtype, int head_dim) {
  return tri_ws_floats<Dims>(which, act_dtype, head_dim);
}

// As flash_fwd_tri, flash_bwd_dq_tri and flash_bwd_dkv_tri (flash_tri.cu),
// for head dims 120 and 100 (cudaErrorInvalidValue for any other).
extern "C" int flash_fwd_tri_pad(const FlashTriArgs* a, void* stream) {
  return run<Dims>(FWD, a, stream);
}

extern "C" int flash_bwd_dq_tri_pad(const FlashTriArgs* a, void* stream) {
  return run<Dims>(DQ, a, stream);
}

extern "C" int flash_bwd_dkv_tri_pad(const FlashTriArgs* a, void* stream) {
  return run<Dims>(DKV, a, stream);
}
