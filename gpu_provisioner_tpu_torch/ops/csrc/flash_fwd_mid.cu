// Flash attention forward for Hopper (sm_90a) at head dims 80 and 96
// (H2O-Danube-1.8B's 32/8 heads of 80, Phi-3-mini's 32/32 of 96): the C
// entry over flash_fwd.cuh's kernels, whose tensor-core instances take D =
// 128's two-atom tile partly filled there. A source of its own, so that
// nvcc builds these instances beside flash_fwd.cu's 16, 32, 64 and 128.
#include "flash_fwd.cuh"

// As flash_fwd (flash_fwd.cu), for head dims 80 and 96
// (cudaErrorInvalidValue for any other).
extern "C" int flash_fwd_mid(const FlashArgs* a, void* stream) {
  if (a->Sq <= 0 || a->B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->D == 96) return static_cast<int>(dispatch<96>(*a, s));
  if (a->D == 80) return static_cast<int>(dispatch<80>(*a, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
