// Hopper (sm_90a) tensor-core building blocks of the attention kernels:
// warpgroup matrix products (wgmma) on bf16 tiles in 128-byte-swizzled
// shared memory, the accumulator's fragment map, row reductions on
// fragments, and the asynchronous loader that fills a tile. flash_tc.cuh
// builds the tile steps on them (flash_tri.cuh's bf16 forward, dQ and dK/dV,
// flash_bwd.cu's bf16 dK/dV); the later redesigns of flash_fwd.cu and
// flash_bwd.cu's dQ are meant to use them too.
//
// A tile is 64 rows of D bf16 values (one row per query or key position),
// D = 64 or 128 (below 64, see D = 32 or 16): D / 64 swizzle atoms of 64
// rows x 64 columns (128 bytes a row), columns 0..63 in the first, 64..127
// in the second (D = 128), 8 KB apart, each 1024-byte aligned: 8 KB at D =
// 64, 16 KB at D = 128. Inside
// an atom, row r lies at r * 128 bytes and its 16-byte chunk c (8 values)
// at chunk c ^ (r % 8): the layout TMA writes with
// CU_TENSOR_MAP_SWIZZLE_128B, and the one wgmma reads through a descriptor
// of layout type B128. Every kernel takes both (TILE_BYTES and the defaults
// below are D = 128's, for the standalone checks under hack/).
//
// D = 80 or 96 (every kernel but the decode's): D = 128's tile, two
// atoms, the second partly filled. A row's D / 8 chunks (10 or 12) go to
// their swizzled places, 8 in the first atom and 2 or 4 in the second; the
// second atom's other chunks are zeroed once a buffer (zero_pad). The
// K-major products (S = Q K^T, dP = dO V^T, S^T, dP^T) take D / 16 k-steps
// (5 or 6; desc_kmajor's k-steps 4 and 5 lie in the second atom) and never
// read past column D; the register-A products (O += P V, dQ += dS K, dV +=
// P^T dO, dK += dS^T Q) stay D = 128's m64n128k16 over both atoms, their
// columns D..127 computed from the zeros and never stored. Every
// descriptor and wgmma shape is D = 128's.
//
// D = 32 or 16 (every kernel): the D = 64 tile, one atom, partly filled.
// A row's D / 8 chunks (4 or 2) go to their swizzled places; the atom's
// other chunks are zeroed once a buffer (zero_pad) and never written
// again. The K-major products (S = Q K^T, dP = dO V^T, S^T = K Q^T, dP^T =
// V dO^T) take D / 16 k-steps (2 or 1) of the K-major descriptor and never
// read past column D; the register-A products (O += P V, dQ += dS K, dV +=
// P^T dO, dK += dS^T Q) stay m64n64k16 over the whole atom, so columns
// D..63 of their accumulators are computed (from the zeros) and never
// stored. Every descriptor and wgmma shape is D = 64's, which
// hack/torch_wgmma_check_d64.py checked on the card; the cost is an m64n64
// register-A product where m64n32 / m64n16 would do.
//
// The loader is cp.async (16 bytes a thread and copy, zero-fill past the
// sequence's end, commit groups), not TMA: the one warpgroup that computes
// also issues the copies (no producer warp yet), so the copy of the next
// tile is a few instructions per thread, the ragged edge is the zero-fill's
// src-size, and no tensor map has to be built on the host for every call
// from the argument block's pointers and strides. TMA comes with warp
// specialisation (a producer warp and setmaxnreg), later work.
//
// Products (A is M x K, B is K x N, M = 64; K-major: K contiguous):
//   - S = Q K^T: A = Q tile, B = K tile, both K-major (D contiguous);
//   - O += P V:  A = P from registers, B = V tile, MN-major (D = N
//     contiguous): the transpose bit; m64n128k16 at D = 128, m64n64k16 at
//     D = 64 (mma_rs picks);
//   - dQ += dS K: the same with the K tile, MN-major;
//   - S^T = K Q^T, dP^T = V dO^T, dV += P^T dO, dK += dS^T Q (dK/dV):
//     the same two forms with the roles of the tiles swapped.
// One swizzled tile serves as a K-major and an MN-major operand through two
// descriptors (desc_kmajor, desc_mnmajor).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace wg {

constexpr int THREADS = 128;                 // one warpgroup
constexpr int ROWS = 64;                     // wgmma M; a tile's rows
constexpr int ATOM_BYTES = ROWS * 128;       // 64 rows x 128 bytes
constexpr uint32_t ALIGN = 1024;             // a swizzle pattern's period

// A tile of 64 rows of D bf16 values: D / 64 atoms, one below D = 64 and
// two at D = 80 and 96.
template <int D>
__host__ __device__ constexpr int tile_bytes() {
  static_assert(D == 16 || D == 32 || D == 64 || D == 80 || D == 96 || D == 128,
                "a tile spans the head dim: 16, 32, 64, 80, 96 or 128");
  return D < 64 ? ATOM_BYTES : (D + 63) / 64 * ATOM_BYTES;
}

// log2 of a power of two (the chunks a row, as shift counts)
__host__ __device__ constexpr int log2i(int x) { return x <= 1 ? 0 : 1 + log2i(x / 2); }
constexpr int TILE_BYTES = tile_bytes<128>();   // 64 x 128 bf16

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- descriptors ----------------------------------------------------------

// The 64-bit shared-memory matrix descriptor: start address, leading and
// stride byte offsets (each >> 4, 14 bits), layout type 1 (128-byte
// swizzle) in bits 62-63; base offset 0, since every atom is 1024-aligned.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16 |
         static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32 | 1ull << 62;
}

// A tile read K-major (as Q, or K in S = Q K^T): rows 8 at a time 1024
// bytes apart (SBO); the leading offset is unused under the swizzle. k-step
// kk (16 values of D, D / 16 of them) starts 32 bytes further within the
// atom, and the second atom (D = 128) holds D 64..127.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int kk) {
  return make_desc(tile + (kk >> 2) * ATOM_BYTES + (kk & 3) * 32, 16, 1024);
}

// A tile read MN-major (V in P V, K in dS K: keys are K, D is N): the
// atoms of N 64 values each are ATOM_BYTES apart (LBO; one atom at D = 64,
// where it is unused), groups of 8 keys 1024 bytes apart (SBO); k-step kk
// (16 keys) starts 2048 bytes further.
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int kk) {
  return make_desc(tile + kk * 2048, ATOM_BYTES, 1024);
}

// ---- ordering -------------------------------------------------------------

__device__ __forceinline__ void fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }

__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins accumulator registers across an asynchronous product, so that the
// compiler neither reads nor moves them between issue and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Generic-proxy writes to shared memory (cp.async, st.shared) made visible
// to the async proxy that wgmma reads through; then a barrier.
__device__ __forceinline__ void fence_smem_to_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- products -------------------------------------------------------------

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B from shared memory;
// scale_d = 0 overwrites d. TransB = 1: B is MN-major.
template <int TransB>
__device__ __forceinline__ void mma_m64n64k16_ss(float (&d)[32], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TransB));
}

// d[64 x 128] (+)= A[64 x 16] B[16 x 128], A from registers (a_frag), B
// from shared memory; TransB = 1: B is MN-major.
template <int TransB>
__device__ __forceinline__ void mma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TransB));
}

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], A from registers (a_frag), B
// from shared memory; TransB = 1: B is MN-major. O += P V at D = 64.
template <int TransB>
__device__ __forceinline__ void mma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TransB));
}

// d[64 x N] (+)= A[64 x 16] B[16 x N], A from registers, N = 2 * (the
// accumulator's floats a thread): the register-A product of a 64- or
// 128-column output (P V, dS K, P^T dO, dS^T Q).
template <int TransB, int N>
__device__ __forceinline__ void mma_rs(float (&d)[N], const uint32_t (&a)[4], uint64_t db,
                                       int scale_d) {
  static_assert(N == 32 || N == 64, "an accumulator of 64 or 128 columns");
  if constexpr (N == 64)
    mma_m64n128k16_rs<TransB>(d, a, db, scale_d);
  else
    mma_m64n64k16_rs<TransB>(d, a, db, scale_d);
}

// ---- fragments ------------------------------------------------------------

// The accumulator of an m64nN product: thread t of the warpgroup holds rows
// frag_row(t) and frag_row(t) + 8, and in each 8-column group j the columns
// 8j + frag_col(t) + {0, 1}. Element e: row frag_row + 8 * ((e >> 1) & 1),
// column 8 * (e >> 2) + frag_col + (e & 1).
__device__ __forceinline__ int frag_row(int t) { return 16 * (t >> 5) + ((t & 31) >> 2); }
__device__ __forceinline__ int frag_col(int t) { return 2 * (t & 3); }
__host__ __device__ constexpr int elem_row(int e) { return 8 * ((e >> 1) & 1); }
__host__ __device__ constexpr int elem_col(int e) { return 8 * (e >> 2) + (e & 1); }

// A row's four threads are the lanes 4i .. 4i + 3 of one warp (a quad).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Columns 16 kk .. 16 kk + 15 of a 64-column f32 accumulator, rounded to
// bf16, as the register A operand of one k16 step: the accumulator's and
// the A fragment's layouts agree pair by pair.
__device__ __forceinline__ void a_frag(const float (&s)[32], int kk, uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
}

// The same columns as two bf16 terms, hi = bf16(x) and lo = bf16(x - hi),
// whose sum keeps about 16 bits of each value: products with both lose
// what one bf16 rounding would (2^-9 of the value).
__device__ __forceinline__ void a_frag_split(const float (&s)[32], int kk, uint32_t (&hi)[4],
                                             uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float x0 = s[8 * kk + 2 * i], x1 = s[8 * kk + 2 * i + 1];
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    hi[i] = *reinterpret_cast<const uint32_t*>(&h);
    lo[i] = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
  }
}

// ---- the asynchronous loader ----------------------------------------------

__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Issues the copy of rows row0 .. row0 + 63 of one (batch, head) slice of
// bf16 [positions][D] (`base` at position 0, `ld` elements between
// positions; 16-byte aligned) into the swizzled tile at `tile`: 64 * D / 8
// chunks of 16 bytes, D / 16 per thread, neighbouring threads on
// neighbouring chunks of a row. Rows at or past S are zero-filled (src-size
// 0). Not committed.
template <int D = 128>
__device__ __forceinline__ void load_tile(uint32_t tile, const __nv_bfloat16* base, long long ld,
                                          int row0, int S) {
  constexpr int LOG_CH = log2i(D / 8);   // log2 of the chunks a row, D / 8
  constexpr bool POW2 = (1 << LOG_CH) == D / 8;   // all but D = 80 and 96
  static_assert(tile_bytes<D>() > 0, "D = 16, 32, 64, 80, 96 or 128");
#pragma unroll
  for (int it = 0; it < ROWS * (D / 8) / THREADS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    // row, chunk of 8 values along D
    const int r = POW2 ? i >> LOG_CH : i / (D / 8), c = POW2 ? i & (D / 8 - 1) : i % (D / 8);
    const bool in = row0 + r < S;
    const __nv_bfloat16* src = in ? base + (row0 + r) * ld + c * 8 : base;
    const uint32_t dst = tile + (c >> 3) * ATOM_BYTES + r * 128 + (((c & 7) ^ (r & 7)) << 4);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(in ? 16 : 0)
                 : "memory");
  }
}

// Zeroes what load_tile leaves empty in every row of a tile at `tile`:
// the chunks D / 8 .. 7 of a one-atom tile (D = 32 or 16), or the chunks
// D / 8 - 8 .. 7 of a two-atom tile's second atom (D = 80 or 96); nothing
// at D = 64 and 128. Plain stores: the caller publishes them to the tensor
// cores (fence_smem_to_async, then a barrier) before the first product
// reads the tile.
template <int D>
__device__ __forceinline__ void zero_pad(uint32_t tile) {
  if constexpr (D % 64 != 0) {
    constexpr int CH = D / 8 % 8;   // chunks of the last atom in use
    constexpr int PAD = 8 - CH;     // empty chunks a row: 4 or 6
    const uint32_t atom = tile + (D / 64) * ATOM_BYTES;
    for (int i = threadIdx.x; i < ROWS * PAD; i += THREADS) {
      const int r = i / PAD, c = CH + i % PAD;
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                       atom + r * 128 + ((c ^ (r & 7)) << 4)),
                   "r"(0u), "r"(0u), "r"(0u), "r"(0u)
                   : "memory");
    }
  }
}

}  // namespace wg
