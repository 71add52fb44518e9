// The tensor-core building blocks of ops/csrc/flash_wgmma.cuh on their own:
// one warpgroup loads three 64 x 128 bf16 tiles A, B, V and one 64 x 256
// tile W (four atoms) through the swizzling cp.async loader (rows at or
// past `rows` zero-filled), then
//   s = A B^T        (m64n64k16, both K-major from shared memory)
//   o = bf16(s) V    (m64n128k16, A from registers, V MN-major)
//   g = bf16(s) B    (the same with B as the MN-major operand)
//   h = bf16(s) W    (two m64n128k16 products, one a column half of W read
//                     MN-major from its first atom and two atoms in: the
//                     backward's dS K, P^T dO and dS^T Q at head dim 256,
//                     flash_tc.cuh's half_at)
// and writes s [64][64], o and g [64][128], h [64][256] in f32 through the
// fragment map. A second kernel (wgmma_check_pad) takes the pieces of head
// dim 100: three 64 x 100 bf16 tiles whose rows start on 8-byte boundaries
// only, copied in 8-byte pieces into D = 128's swizzled tile (load_tile<100>)
// over shared memory filled with NaN first, the pad zeroed from column 100
// (zero_pad<100>), then s = A B^T in 7 k-steps (the last over columns
// 96..111, a quarter real), o = bf16(s) V and g = bf16(s) B over both
// atoms (B, a K-major operand of s, read MN-major: the backward's dQ += dS
// K, and dK += dS^T Q with the roles swapped), o's and g's columns
// 100..127 written too (zero when the pad is).
// Built and checked against torch.matmul by hack/torch_wgmma_check.py.
#include <cuda_runtime.h>

#include "flash_wgmma.cuh"

namespace {

__global__ void __launch_bounds__(wg::THREADS)
    wgmma_check_kernel(const __nv_bfloat16* a, const __nv_bfloat16* b, const __nv_bfloat16* v,
                       const __nv_bfloat16* w, int rows, float* s_out, float* o_out,
                       float* g_out, float* h_out) {
  extern __shared__ unsigned char smem[];
  const uint32_t sa = (wg::smem_addr(smem) + wg::ALIGN - 1) & ~(wg::ALIGN - 1);
  const uint32_t sb = sa + wg::TILE_BYTES, sv = sb + wg::TILE_BYTES, sw = sv + wg::TILE_BYTES;
  wg::load_tile(sa, a, 128, 0, rows);
  wg::load_tile(sb, b, 128, 0, rows);
  wg::load_tile(sv, v, 128, 0, rows);
  wg::load_tile<256>(sw, w, 256, 0, rows);
  wg::copy_commit();
  wg::copy_wait<0>();
  wg::fence_smem_to_async();
  __syncthreads();

  float s[32] = {}, o[64] = {}, g[64] = {};
  wg::fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wg::mma_m64n64k16_ss<0>(s, wg::desc_kmajor(sa, kk), wg::desc_kmajor(sb, kk), kk > 0);
  wg::commit();
  wg::wait<0>();
  wg::fence_regs(s);

  uint32_t p[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wg::a_frag(s, kk, p[kk]);
  wg::fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wg::mma_m64n128k16_rs<1>(o, p[kk], wg::desc_mnmajor(sv, kk), 1);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wg::mma_m64n128k16_rs<1>(g, p[kk], wg::desc_mnmajor(sb, kk), 1);
  wg::commit();
  wg::wait<0>();
  wg::fence_regs(o);
  wg::fence_regs(g);

  const int row = wg::frag_row(threadIdx.x), col = wg::frag_col(threadIdx.x);
#pragma unroll
  for (int e = 0; e < 32; ++e) s_out[(row + wg::elem_row(e)) * 64 + col + wg::elem_col(e)] = s[e];
#pragma unroll
  for (int e = 0; e < 64; ++e) {
    const int at = (row + wg::elem_row(e)) * 128 + col + wg::elem_col(e);
    o_out[at] = o[e];
    g_out[at] = g[e];
  }
  // h's halves one at a time, into o's registers
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    wg::fence_regs(o);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wg::mma_m64n128k16_rs<1>(o, p[kk], wg::desc_mnmajor(sw + half * wg::tile_bytes<128>(), kk),
                               kk > 0);
    wg::commit();
    wg::wait<0>();
    wg::fence_regs(o);
#pragma unroll
    for (int e = 0; e < 64; ++e)
      h_out[(row + wg::elem_row(e)) * 256 + half * 128 + col + wg::elem_col(e)] = o[e];
  }
}

__global__ void __launch_bounds__(wg::THREADS)
    wgmma_check_pad_kernel(const __nv_bfloat16* a, const __nv_bfloat16* b,
                           const __nv_bfloat16* v, long long ld, int rows, float* s_out,
                           float* o_out, float* g_out) {
  extern __shared__ unsigned char smem[];
  constexpr int D = 100, TILE = wg::tile_bytes<D>();
  const uint32_t sa = (wg::smem_addr(smem) + wg::ALIGN - 1) & ~(wg::ALIGN - 1);
  const uint32_t sb = sa + TILE, sv = sb + TILE;
  unsigned char* base = smem + (sa - wg::smem_addr(smem));
  for (int i = threadIdx.x; i < 3 * TILE; i += wg::THREADS) base[i] = 0xff;   // NaN in bf16
  __syncthreads();
  wg::load_tile<D>(sa, a, ld, 0, rows);
  wg::load_tile<D>(sb, b, ld, 0, rows);
  wg::load_tile<D>(sv, v, ld, 0, rows);
  for (int t = 0; t < 3; ++t) wg::zero_pad<D>(sa + t * TILE);
  wg::copy_commit();
  wg::copy_wait<0>();
  wg::fence_smem_to_async();
  __syncthreads();

  float s[32] = {}, o[64] = {}, g[64] = {};
  wg::fence();
#pragma unroll
  for (int kk = 0; kk < (D + 15) / 16; ++kk)
    wg::mma_m64n64k16_ss<0>(s, wg::desc_kmajor(sa, kk), wg::desc_kmajor(sb, kk), kk > 0);
  wg::commit();
  wg::wait<0>();
  wg::fence_regs(s);
  uint32_t p[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wg::a_frag(s, kk, p[kk]);
  wg::fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wg::mma_m64n128k16_rs<1>(o, p[kk], wg::desc_mnmajor(sv, kk), 1);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wg::mma_m64n128k16_rs<1>(g, p[kk], wg::desc_mnmajor(sb, kk), 1);
  wg::commit();
  wg::wait<0>();
  wg::fence_regs(o);
  wg::fence_regs(g);
  const int row = wg::frag_row(threadIdx.x), col = wg::frag_col(threadIdx.x);
#pragma unroll
  for (int e = 0; e < 32; ++e) s_out[(row + wg::elem_row(e)) * 64 + col + wg::elem_col(e)] = s[e];
#pragma unroll
  for (int e = 0; e < 64; ++e) {
    o_out[(row + wg::elem_row(e)) * 128 + col + wg::elem_col(e)] = o[e];
    g_out[(row + wg::elem_row(e)) * 128 + col + wg::elem_col(e)] = g[e];
  }
}

}  // namespace

// a, b, v: 64 rows of 100 bf16 on the card, `ld` elements apart (8-byte
// aligned); s_out [64][64], o_out, g_out [64][128] f32. Returns
// cudaGetLastError() after the launch.
extern "C" int wgmma_check_pad(const void* a, const void* b, const void* v, long long ld,
                               int rows, float* s_out, float* o_out, float* g_out,
                               void* stream) {
  const int smem = 3 * wg::tile_bytes<100>() + wg::ALIGN;
  cudaError_t e = cudaFuncSetAttribute(wgmma_check_pad_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  wgmma_check_pad_kernel<<<1, wg::THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
      static_cast<const __nv_bfloat16*>(v), ld, rows, s_out, o_out, g_out);
  return static_cast<int>(cudaGetLastError());
}

// a, b, v: [64][128] bf16 on the card, w [64][256]; s_out [64][64], o_out,
// g_out [64][128], h_out [64][256] f32. Returns cudaGetLastError() after the
// launch.
extern "C" int wgmma_check(const void* a, const void* b, const void* v, const void* w, int rows,
                           float* s_out, float* o_out, float* g_out, float* h_out,
                           void* stream) {
  const int smem = 3 * wg::TILE_BYTES + wg::tile_bytes<256>() + wg::ALIGN;
  cudaError_t e =
      cudaFuncSetAttribute(wgmma_check_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  wgmma_check_kernel<<<1, wg::THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(w), rows, s_out,
      o_out, g_out, h_out);
  return static_cast<int>(cudaGetLastError());
}
