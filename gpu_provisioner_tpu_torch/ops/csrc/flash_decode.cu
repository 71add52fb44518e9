// Decode-step attention for Hopper (sm_90a) at head dims 64 and 128: the C
// entry over flash_decode.cuh's kernel (its design, what it replaces and
// what bounds it are there). flash_decode_narrow.cu builds head dims 32
// and 16 beside it.
#include "flash_decode.cuh"

// Launches the split kernel and, with more than one split, the merge on
// `stream`; allocates nothing, does not synchronise; returns
// cudaGetLastError() after the launches (0 on success; cudaErrorInvalidValue
// for a head dim other than 64 or 128).
extern "C" int flash_decode(const FlashArgs* a, void* stream) {
  if (a->Sq <= 0 || a->B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->D == 128) return static_cast<int>(dispatch<128>(*a, s));
  if (a->D == 64) return static_cast<int>(dispatch<64>(*a, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
