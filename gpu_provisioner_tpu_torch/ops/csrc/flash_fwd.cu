// Flash attention forward for Hopper (sm_90a) at head dims 16, 32, 64 and
// 128: the C entry over flash_fwd.cuh's kernels (their design, what they
// replace and what bounds them are there). flash_fwd_mid.cu builds head
// dims 80 and 96 beside it.
#include "flash_fwd.cuh"

// Launches on `stream`, allocates nothing, does not synchronise; returns
// cudaGetLastError() after the launch (0 on success; cudaErrorInvalidValue
// for a head dim other than 16, 32, 64 or 128).
extern "C" int flash_fwd(const FlashArgs* a, void* stream) {
  if (a->Sq <= 0 || a->B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->D == 128) return static_cast<int>(dispatch<128>(*a, s));
  if (a->D == 64) return static_cast<int>(dispatch<64>(*a, s));
  if (a->D == 32) return static_cast<int>(dispatch<32>(*a, s));
  if (a->D == 16) return static_cast<int>(dispatch<16>(*a, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
