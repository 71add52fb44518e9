// Flash attention backward for Hopper (sm_90a) at head dims 100
// (OpenLLaMA-3B's 32/32 heads of 100) and 120 (H2O-Danube3-4B's 32/8 heads
// of 120): the C entries over flash_bwd.cuh's kernels, whose tensor-core
// instances take D = 128's two-atom tile partly filled there, with a zeroed
// pad inside the last k-step; at 100 a bf16 row of Q, dO, K and V copied
// in 8-byte pieces (a row of 100 values is no whole number of 16-byte
// chunks), at 120 in its 15 chunks. A source of its own, so that nvcc
// builds these instances beside flash_bwd.cu's 16, 32, 64 and 128,
// flash_bwd_mid.cu's 80 and 96 and flash_bwd_wide.cu's 256.
#include "flash_bwd.cuh"

// As flash_bwd_dq and flash_bwd_dkv (flash_bwd.cu), for head dims 100 and
// 120 (cudaErrorInvalidValue for any other).
extern "C" int flash_bwd_dq_pad(const FlashBwdArgs* a, void* stream) {
  return run<100, 120>(true, a, stream);
}

extern "C" int flash_bwd_dkv_pad(const FlashBwdArgs* a, void* stream) {
  return run<100, 120>(false, a, stream);
}
