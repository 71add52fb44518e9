// Flash attention forward for Hopper (sm_90a) at head dims 100
// (OpenLLaMA-3B's 32/32 heads of 100) and 120 (H2O-Danube3-4B's 32/8 heads
// of 120): the C entry over flash_fwd.cuh's kernels, whose tensor-core
// instances take D = 128's two-atom tile partly filled there, with a zeroed
// pad inside the last k-step. At 100 a bf16 row is copied in 8-byte pieces
// and an int8 row in 4-byte pieces (a row of 100 values is no whole number
// of 16-byte chunks); at 120 a bf16 row in 16-byte chunks and an int8 row
// (120 bytes) in 8-byte pieces. A source of its own, so that nvcc builds
// these instances beside flash_fwd.cu's 16, 32, 64 and 128 and
// flash_fwd_mid.cu's 80 and 96.
#include "flash_fwd.cuh"

// As flash_fwd (flash_fwd.cu), for head dims 100 and 120
// (cudaErrorInvalidValue for any other).
extern "C" int flash_fwd_pad(const FlashArgs* a, void* stream) {
  if (a->Sq <= 0 || a->B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->D == 100) return static_cast<int>(dispatch<100>(*a, s));
  if (a->D == 120) return static_cast<int>(dispatch<120>(*a, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
