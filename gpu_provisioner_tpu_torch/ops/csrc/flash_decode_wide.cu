// Decode-step attention for Hopper (sm_90a) at head dim 256 (Gemma-2B's
// 8/1 heads of 256): the C entry over flash_decode.cuh's kernel, whose P V
// keeps one row group of 128 threads there, each owning two columns of
// every row. A source of its own, so that nvcc builds these instances
// beside flash_decode.cu's 64 and 128, flash_decode_narrow.cu's 32 and 16
// and flash_decode_mid.cu's 80 and 96.
#include "flash_decode.cuh"

// As flash_decode (flash_decode.cu), for head dim 256
// (cudaErrorInvalidValue for any other).
extern "C" int flash_decode_wide(const FlashArgs* a, void* stream) {
  if (a->Sq <= 0 || a->B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->D == 256) return static_cast<int>(dispatch<256>(*a, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
