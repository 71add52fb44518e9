// Flash attention backward for Hopper (sm_90a) at head dims 16, 32, 64 and
// 128: the C entries over flash_bwd.cuh's kernels (their design, what they
// replace and what bounds them are there). flash_bwd_mid.cu builds head
// dims 80 and 96 beside it.
#include "flash_bwd.cuh"

// Both launch on `stream`, allocate nothing and do not synchronise; each
// returns cudaGetLastError() after its launch (0 on success;
// cudaErrorInvalidValue for a head dim other than 16, 32, 64 or 128).
extern "C" int flash_bwd_dq(const FlashBwdArgs* a, void* stream) {
  return run<16, 32, 64, 128>(true, a, stream);
}

extern "C" int flash_bwd_dkv(const FlashBwdArgs* a, void* stream) {
  return run<16, 32, 64, 128>(false, a, stream);
}

// The blocks flash_bwd_dkv (and flash_bwd_dkv_mid) launches for (B, Hkv, S)
// at act dtype act_dtype (0 f32, 1 bf16; the key tile does not depend on
// the head dim), or -cudaErrorInvalidValue for another dtype.
extern "C" long long flash_bwd_dkv_blocks(int B, int Hkv, int S, int act_dtype) {
  if (act_dtype != 0 && act_dtype != 1) return -static_cast<long long>(cudaErrorInvalidValue);
  const dim3 g = act_dtype == 0 ? dkv_grid<float>(B, Hkv, S) : dkv_grid<__nv_bfloat16>(B, Hkv, S);
  return static_cast<long long>(g.x) * g.y;
}
