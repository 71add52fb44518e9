// Decode-step attention for Hopper (sm_90a) at head dims 80 and 96
// (H2O-Danube-1.8B's 32/8 heads of 80, Phi-3-mini's 32/32 of 96): the C
// entry over flash_decode.cuh's kernel, whose P V keeps D = 128's one row
// group there, D of its 128 threads owning a column. A source of its own,
// so that nvcc builds these instances beside flash_decode.cu's 64 and 128
// and flash_decode_narrow.cu's 32 and 16.
#include "flash_decode.cuh"

// As flash_decode (flash_decode.cu), for head dims 80 and 96
// (cudaErrorInvalidValue for any other).
extern "C" int flash_decode_mid(const FlashArgs* a, void* stream) {
  if (a->Sq <= 0 || a->B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->D == 96) return static_cast<int>(dispatch<96>(*a, s));
  if (a->D == 80) return static_cast<int>(dispatch<80>(*a, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
