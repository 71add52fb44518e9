// Flash attention backward for Hopper (sm_90a) at head dim 256 (Gemma-2B's
// 8/1 heads of 256): the C entries over flash_bwd.cuh's kernels, whose
// tensor-core instances split the register-A products into column halves
// of 128 there (tc::half_at): dQ's two halves in one CTA (tc::dq_acc),
// dK/dV's one a CTA (tc::out_cols). A source of its own, so that nvcc
// builds these instances beside flash_bwd.cu's 16, 32, 64 and 128 and
// flash_bwd_mid.cu's 80 and 96.
#include "flash_bwd.cuh"

// As flash_bwd_dq and flash_bwd_dkv (flash_bwd.cu), for head dim 256
// (cudaErrorInvalidValue for any other).
extern "C" int flash_bwd_dq_wide(const FlashBwdArgs* a, void* stream) {
  return run<256>(true, a, stream);
}

extern "C" int flash_bwd_dkv_wide(const FlashBwdArgs* a, void* stream) {
  return run<256>(false, a, stream);
}
