// The head-dim-64 tensor-core building blocks of ops/csrc/flash_wgmma.cuh
// and flash_tc.cuh on their own: one warpgroup loads three 64 x 64 bf16
// tiles A, B, V through the swizzling cp.async loader (one swizzle atom
// each; rows at or past `rows` zero-filled) and one 64 x 64 int8 tile W
// with its 64 scales through the int8 stage, widened to bf16 (tc::i8_stage,
// tc::i8_widen), then
//   s = A B^T        (m64n64k16, both K-major, 4 k-steps)
//   o = bf16(s) V    (m64n64k16 with A from registers, V MN-major)
//   g = bf16(s) B    (the same with B as the MN-major operand)
//   x = A W^T        (W widened from int8, K-major)
// and writes each [64][64] in f32 through the fragment map, with the
// stage's scales as it read them. Built and checked against torch.matmul by
// hack/torch_wgmma_check_d64.py.
#include <cuda_runtime.h>

#include "flash_tc.cuh"

namespace {

constexpr int D = 64;
constexpr int TILE = wg::tile_bytes<D>();

__global__ void __launch_bounds__(wg::THREADS)
    wgmma_check_d64_kernel(const __nv_bfloat16* a, const __nv_bfloat16* b,
                           const __nv_bfloat16* v, const int8_t* w, const float* ws, int rows,
                           float* s_out, float* o_out, float* g_out, float* x_out,
                           float* sc_out) {
  const uint32_t sa = tc::tiles(), sb = sa + TILE, sv = sb + TILE, sw = sv + TILE;
  const uint32_t stage = sw + 2 * TILE;   // the widened pair at sw, sw + TILE
  wg::load_tile<D>(sa, a, D, 0, rows);
  wg::load_tile<D>(sb, b, D, 0, rows);
  wg::load_tile<D>(sv, v, D, 0, rows);
  tc::i8_stage<D>(stage, w, w, ws, ws, D, D, 1, 0, rows);
  wg::copy_commit();
  wg::copy_wait<0>();
  __syncthreads();
  tc::i8_widen<D>(sw, stage);
  wg::fence_smem_to_async();
  __syncthreads();

  float s[32] = {}, o[32] = {}, g[32] = {}, x[32] = {};
  wg::fence();
  tc::abt<D>(s, sa, sb);
  tc::abt<D>(x, sa, sw);
  wg::commit();
  wg::wait<0>();
  wg::fence_regs(s);
  wg::fence_regs(x);

  uint32_t p[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wg::a_frag(s, kk, p[kk]);
  wg::fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wg::mma_m64n64k16_rs<1>(o, p[kk], wg::desc_mnmajor(sv, kk), 1);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wg::mma_m64n64k16_rs<1>(g, p[kk], wg::desc_mnmajor(sb, kk), 1);
  wg::commit();
  wg::wait<0>();
  wg::fence_regs(o);
  wg::fence_regs(g);

  const int row = wg::frag_row(threadIdx.x), col = wg::frag_col(threadIdx.x);
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int at = (row + wg::elem_row(e)) * 64 + col + wg::elem_col(e);
    s_out[at] = s[e];
    o_out[at] = o[e];
    g_out[at] = g[e];
    x_out[at] = x[e];
  }
  sc_out[threadIdx.x] = tc::floats_at(stage + 2 * tc::i8_tile<D>())[threadIdx.x];
}

}  // namespace

// a, b, v: [64][64] bf16 on the card; w [64][64] int8 and ws [64] f32;
// s_out, o_out, g_out, x_out [64][64] and sc_out [128] f32 (the k then the
// v scales of the stage). Returns cudaGetLastError() after the launch.
extern "C" int wgmma_check_d64(const void* a, const void* b, const void* v, const void* w,
                               const float* ws, int rows, float* s_out, float* o_out,
                               float* g_out, float* x_out, float* sc_out, void* stream) {
  const int smem = 6 * TILE + tc::i8_stage_bytes<D>() + wg::ALIGN;
  cudaError_t e = cudaFuncSetAttribute(wgmma_check_d64_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  wgmma_check_d64_kernel<<<1, wg::THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int8_t*>(w), ws, rows, s_out,
      o_out, g_out, x_out, sc_out);
  return static_cast<int>(cudaGetLastError());
}
