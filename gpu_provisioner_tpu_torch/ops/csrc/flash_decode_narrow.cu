// Decode-step attention for Hopper (sm_90a) at head dims 32 and 16 (the
// fast serving models' 8/4 heads of 32, the tiny presets' 4/2 of 16): the C
// entry over flash_decode.cuh's kernel, whose P V splits the 128-thread
// block into 4 or 8 row groups there. A source of its own, so that nvcc
// builds these instances beside flash_decode.cu's 64 and 128.
#include "flash_decode.cuh"

// As flash_decode (flash_decode.cu), for head dims 32 and 16
// (cudaErrorInvalidValue for any other).
extern "C" int flash_decode_narrow(const FlashArgs* a, void* stream) {
  if (a->Sq <= 0 || a->B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->D == 32) return static_cast<int>(dispatch<32>(*a, s));
  if (a->D == 16) return static_cast<int>(dispatch<16>(*a, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
