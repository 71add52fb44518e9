// Decode-step attention for Hopper (sm_90a) at head dims 100
// (OpenLLaMA-3B's 32/32 heads of 100) and 120 (H2O-Danube3-4B's 32/8 heads
// of 120): the C entry over flash_decode.cuh's kernel, whose P V keeps D =
// 128's one row group there, threads 0..D-1 owning a column, and whose
// ring copies a cached row in pieces of 8 (bf16 at 100, int8 at 120) or 4
// (int8 at 100) bytes where it is no whole number of 16-byte chunks. A
// source of its own, so that nvcc builds these instances beside
// flash_decode.cu's 64 and 128 and flash_decode_mid.cu's 80 and 96.
#include "flash_decode.cuh"

// As flash_decode (flash_decode.cu), for head dims 100 and 120
// (cudaErrorInvalidValue for any other).
extern "C" int flash_decode_pad(const FlashArgs* a, void* stream) {
  if (a->Sq <= 0 || a->B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->D == 100) return static_cast<int>(dispatch<100>(*a, s));
  if (a->D == 120) return static_cast<int>(dispatch<120>(*a, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
