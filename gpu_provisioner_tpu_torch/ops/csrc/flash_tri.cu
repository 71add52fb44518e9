// Causal flash attention for Hopper (sm_90a) on the flattened triangle at
// head dims 128 and 64: the C entries over flash_tri.cuh's kernels (their
// design, what they replace and what bounds them are there).
// flash_tri_narrow.cu builds head dims 32 and 16 beside it.
#include "flash_tri.cuh"

namespace {
using Dims = HeadDims<128, 64>;
}  // namespace

// The persistent grid P of entry `which` (0 flash_fwd_tri, 1
// flash_bwd_dq_tri, 2 flash_bwd_dkv_tri) for act dtype 0 (f32) or 1 (bf16)
// and head dim 64 or 128 on the current device; a negative value is
// -cudaError (tri_ctas).
extern "C" int flash_tri_ctas(int which, int act_dtype, int head_dim) {
  return tri_ctas<Dims>(which, act_dtype, head_dim);
}

// f32 workspace values per CTA of entry `which` for act dtype 0 (f32) or 1
// (bf16) and head dim 64 or 128; a negative value is -cudaError
// (tri_ws_floats).
extern "C" long long flash_tri_ws_floats(int which, int act_dtype, int head_dim) {
  return tri_ws_floats<Dims>(which, act_dtype, head_dim);
}

// Each queues its main launch and its fixup on `stream`, allocates nothing
// and does not synchronise; returns cudaGetLastError() (0 on success;
// cudaErrorInvalidValue for a head dim other than 64 or 128).
extern "C" int flash_fwd_tri(const FlashTriArgs* a, void* stream) {
  return run<Dims>(FWD, a, stream);
}

extern "C" int flash_bwd_dq_tri(const FlashTriArgs* a, void* stream) {
  return run<Dims>(DQ, a, stream);
}

extern "C" int flash_bwd_dkv_tri(const FlashTriArgs* a, void* stream) {
  return run<Dims>(DKV, a, stream);
}
