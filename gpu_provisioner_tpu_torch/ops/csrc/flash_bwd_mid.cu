// Flash attention backward for Hopper (sm_90a) at head dims 80 and 96
// (H2O-Danube-1.8B's 32/8 heads of 80, Phi-3-mini's 32/32 of 96): the C
// entries over flash_bwd.cuh's kernels, whose tensor-core instances take
// D = 128's two-atom tile partly filled there. A source of its own, so
// that nvcc builds these instances beside flash_bwd.cu's 16, 32, 64 and
// 128.
#include "flash_bwd.cuh"

// As flash_bwd_dq and flash_bwd_dkv (flash_bwd.cu), for head dims 80 and
// 96 (cudaErrorInvalidValue for any other).
extern "C" int flash_bwd_dq_mid(const FlashBwdArgs* a, void* stream) {
  return run<96, 80>(true, a, stream);
}

extern "C" int flash_bwd_dkv_mid(const FlashBwdArgs* a, void* stream) {
  return run<96, 80>(false, a, stream);
}
