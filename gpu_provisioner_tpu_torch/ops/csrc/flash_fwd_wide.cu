// Flash attention forward for Hopper (sm_90a) at head dim 256 (Gemma-2B's
// 8/1 heads of 256): the C entry over flash_fwd.cuh's kernels, whose
// tensor-core instances split the output's columns into two halves of 128
// there, one a CTA (tc::out_cols). A source of its own, so that nvcc builds
// these instances beside flash_fwd.cu's 16, 32, 64 and 128 and
// flash_fwd_mid.cu's 80 and 96.
#include "flash_fwd.cuh"

// As flash_fwd (flash_fwd.cu), for head dim 256 (cudaErrorInvalidValue for
// any other).
extern "C" int flash_fwd_wide(const FlashArgs* a, void* stream) {
  if (a->Sq <= 0 || a->B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->D == 256) return static_cast<int>(dispatch<256>(*a, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
