// Causal flash attention for Hopper (sm_90a) on the flattened triangle: the
// forward, dQ and dK/dV over one flat list of the live causal tiles, walked
// by a persistent grid in equal shares.
//
// Replaces, in gpu_provisioner_tpu/ops/flash_attention.py (opt-in
// triangular=True, causal, no window):
//   - _kernel_tri (pallas_call in _flash, streaming regime only):
//     flash_fwd_tri, out and lse;
//   - _bwd_dq_kernel_tri (pallas_call in _flash_bwd_tri): flash_bwd_dq_tri;
//   - _bwd_dkv_kernel_tri (the reversed triangle, _tri_decode_rev):
//     flash_bwd_dkv_tri.
// They compute what flash_fwd.cu and flash_bwd.cuh compute, with the same
// tile steps (below); what differs is the schedule.
//
// What bounds them on an H100: compute, as for the rectangular kernels (4, 6
// and 8 * D operations per attended pair and q-head against a few bytes per
// position). The TPU flattens its sequential grid so that dead cells cost no
// grid step; the rectangular CUDA kernels already skip dead tiles through
// their loop bounds. What a flat list adds on this card is balance: a
// rectangular block owns a row of 1 to n live tiles and the longest rows
// start last. Here every CTA of a persistent launch (SM count x resident
// blocks per SM) takes an equal contiguous share of the W live tiles,
// [c W / P, (c + 1) W / P), so no SM waits on a long row at the end.
//
// The schedule, in square tiles of the kernel's own edge E (64 for the
// forward and dQ, the query tile and fa::BK; for dK/dV 64 in bf16, the
// tensor-core key tile, and 32 in f32, whose FMA accumulators cap the key
// tile): within each (batch, head) n = ceil(S / E) rows and n (n + 1) / 2
// live tiles, W = B * H * n (n + 1) / 2 in all.
//   - forward, dQ: row r = query tile qi, its tiles kj = 0..qi ascending
//     (_tri_decode), H = Hq;
//   - dK/dV: row r = n - 1 - kj, its tiles qi = n - 1 down to kj
//     (_tri_decode_rev), H = Hkv, the group's q-heads innermost in each tile
//     so GQA folds inside the block as in flash_bwd_dkv.
// A CTA decodes only the start of its share (float sqrt seed, integer +-1
// corrections) and walks on in order. A row lying whole inside one share is
// finalised in place. A row cut by a share boundary leaves f32 partials in
// the workspace: the normalised o and lse (forward), the f32 dQ or dK/dV
// sums (backward). Only a share's first and last segments can be cut, so a
// CTA needs two slots: 2c for its first segment, 2c + 1 for its last (the
// layout: ws_per_cta below, which the wrapper reads through
// flash_tri_ws_floats and passes back as FlashTriArgs.ws_floats). A
// second launch, the fixup, merges each cut row's pieces in flat order
// (parallel/ring.py:_lse_merge for the forward, a sum for the backward) and
// writes the row. No atomics: the result is the same run to run for a
// given P.
//
// The tile steps. The f32 instances of all three kernels are f32 FMA from
// shared memory (attend_tiles, dq_tile, dkv_tile), the exactness
// instances. The bf16 instances run on the tensor cores, chosen by the
// template type: one warpgroup of 128 threads owns the segment's 64-row
// tile and runs the tile steps of flash_tc.cuh, which the rectangular
// kernels share (tc::fwd_tile_tc and tc::dq_tile_tc with flash_fwd.cu and
// flash_bwd.cuh's dQ through tc::kv_walk's K/V ring; tc::dkv_walk_tc with
// flash_bwd.cuh's dK/dV), with the triangle's mask (tc::TriMask). The
// forward's P goes to the tensor cores as bf16 hi + lo, dQ's dS and dK/dV's
// P^T and dS^T each rounded to bf16 once (flash_tc.cuh says why). Shared
// memory at D = 128: 80 KB forward, 96 KB dQ, 97 KB dK/dV, so two CTAs an
// SM; at D = 64 41, 49 and 50 KB, the CTAs an SM the occupancy query's
// (flash_tri_ctas). Every instance takes head dim 16, 32, 64, 80, 96 or
// 128: at 32 and 16 a bf16 tile is the D = 64 atom partly filled, with D =
// 64's shared memory and accumulators; at 96 and 80 (Phi-3-mini's and
// H2O-Danube-1.8B's heads) D = 128's two atoms, the second partly filled,
// with D = 128's shared memory, accumulators and register-A products
// (flash_bwd.cuh says why); at both the chunks past D are zeroed once a
// CTA before its first segment (the persistent walk only rewrites the
// first D / 8 chunks of a row). The workspace and the cut rows' partials
// hold D columns. Bound:
// operations, 4, 6 and 8 D per attended pair and q-head at 989 TFLOP/s
// bf16 (2.22, 3.34 and 4.45 ms at S = 32768, Hq 8). Left for later: warp
// specialisation (a producer warp issuing TMA, with setmaxnreg giving the
// consumers its registers), two consumer warpgroups in ping-pong so that
// one's softmax overlaps the other's products, and fp8 operands.
//
// This header holds the kernels, their launches and the C entries' bodies
// for every head dim (HeadDims); flash_tri.cu's entries take 128 and 64,
// flash_tri_narrow.cu's 32 and 16, flash_tri_mid.cu's 96 and 80, so that
// three nvcc processes build them side by side (one source for all four took 23.8 s to build for sm_90a,
// flash_fwd.cu 17.0 s in the same build).
#pragma once

#include <type_traits>

#include "flash_common.cuh"
#include "flash_tc.cuh"

namespace {

constexpr int FWD_RPT = 4;                 // forward / dQ: 16 * 4 = 64 query rows
constexpr int FWD_E = 16 * FWD_RPT;        // their tile edge, == fa::BK
constexpr int DKV_KPT = 2;                 // dK/dV in f32: 16 * 2 = 32 keys
constexpr int DKV_E = 16 * DKV_KPT;        // its tile edge (keys and queries)
static_assert(FWD_E == fa::BK, "forward and dQ tiles are square");
static_assert(FWD_E == tc::E, "a query tile is one wgmma M");
static_assert(fa::NTHREADS == wg::THREADS, "every block is one warpgroup");

enum Which { FWD = 0, DQ = 1, DKV = 2 };

// The dK/dV tile edge of act dtype 0 (f32, FMA) or 1 (bf16, tensor cores).
__host__ __device__ constexpr int dkv_edge(int act_dtype) {
  return act_dtype == 1 ? tc::E : DKV_E;
}

template <typename T>
constexpr bool kTensorCores = std::is_same<T, __nv_bfloat16>::value;

// f32 workspace values per CTA, two slots of E rows each. With P CTAs:
// forward o [2P][E][D] then lse [2P][E]; dQ [2P][E][D]; dK/dV dk [2P][E][D]
// then dv [2P][E][D]. Each kernel finds its second array at 2 P E D.
template <int D>
constexpr long long ws_per_cta(int which, int act_dtype) {
  return which == FWD  ? 2LL * FWD_E * (D + 1)
         : which == DQ ? 2LL * FWD_E * D
                       : 4LL * dkv_edge(act_dtype) * D;
}

// _tri_decode: flat index t of a triangle -> row r and column c <= r (row r
// starts at r (r + 1) / 2). The float sqrt is only a seed; the corrections
// decide.
__device__ __forceinline__ void tri_decode(long long t, int& r, int& c) {
  int q = static_cast<int>(floorf((sqrtf(8.f * static_cast<float>(t) + 1.f) - 1.f) / 2.f));
  if (static_cast<long long>(q) * (q + 1) / 2 > t) --q;
  if (static_cast<long long>(q + 1) * (q + 2) / 2 <= t) ++q;
  r = q;
  c = static_cast<int>(t - static_cast<long long>(q) * (q + 1) / 2);
}

// First flat index of CTA c's share of W tiles among P CTAs.
__device__ __forceinline__ long long share_lo(int c, long long W, int P) {
  return static_cast<long long>(c) * W / P;
}

struct Tri {
  int n;              // rows (tiles) per (batch, head)
  long long tiles;    // n (n + 1) / 2
  long long W;        // tiles of every (batch, head)
};

__device__ __forceinline__ Tri make_tri(int S, int E, int heads, int B) {
  Tri t;
  t.n = (S + E - 1) / E;
  t.tiles = static_cast<long long>(t.n) * (t.n + 1) / 2;
  t.W = static_cast<long long>(B) * heads * t.tiles;
  return t;
}

// One run of tiles c0..c1 of row r of (batch, head) bh inside a share.
struct Seg {
  long long bh;
  int r, c0, c1;
  bool whole;         // the row lies whole inside this share
  int slot;           // workspace slot of a cut row's partial
};

// A CTA's walk over its share, segment by segment.
struct Walk {
  long long t, hi, bh;
  int r, c, n, seg, cta;

  __device__ Walk(int cta_, const Tri& tri, int P) : n(tri.n), seg(0), cta(cta_) {
    t = share_lo(cta_, tri.W, P);
    hi = share_lo(cta_ + 1, tri.W, P);
    bh = t / tri.tiles;
    if (t < hi) tri_decode(t - bh * tri.tiles, r, c);
  }

  __device__ bool next(Seg& s) {
    if (t >= hi) return false;
    const int c1 = static_cast<int>(min(static_cast<long long>(r), c + (hi - t) - 1));
    s.bh = bh;
    s.r = r;
    s.c0 = c;
    s.c1 = c1;
    s.whole = c == 0 && c1 == r;
    s.slot = 2 * cta + (seg > 0);
    t += c1 - c + 1;
    ++seg;
    c = 0;
    if (++r == n) {
      r = 0;
      ++bh;
    }
    return true;
  }
};

// The cut row whose first tile lies in CTA `cta`'s share: only the row of
// the share's last tile can start in the share and end past it. Gives its
// (bh, r), the flat index one past its last tile and the slot of its first
// piece (the share's last segment: 2c, or 2c + 1 after an earlier one).
// False when that row began in an earlier share or ends inside this one.
// Each cut row has exactly one such CTA; that CTA's fixup block merges it.
struct CutRow {
  long long bh, end;
  int r, slot;
};

__device__ __forceinline__ bool cut_row(int cta, const Tri& tri, int P, CutRow& cr) {
  const long long lo = share_lo(cta, tri.W, P), hi = share_lo(cta + 1, tri.W, P);
  if (lo >= hi) return false;
  const long long bh = (hi - 1) / tri.tiles;
  int r, c;
  tri_decode(hi - 1 - bh * tri.tiles, r, c);
  const long long start = hi - 1 - c;   // flat index of row r's first tile
  if (start < lo) return false;
  cr.end = start + r + 1;
  if (cr.end <= hi) return false;
  cr.bh = bh;
  cr.r = r;
  cr.slot = 2 * cta + (start > lo);
  return true;
}

// Calls fn(slot) for every piece of a cut row, in flat order: the first
// piece's slot, then slot 2c' of each later non-empty share up to the one
// that holds the row's last tile.
template <typename F>
__device__ __forceinline__ void for_each_piece(int cta, const CutRow& cr, const Tri& tri, int P,
                                               F fn) {
  fn(cr.slot);
  for (int c = cta + 1;; ++c) {
    const long long lo = share_lo(c, tri.W, P), hi = share_lo(c + 1, tri.W, P);
    if (lo < hi) fn(2 * c);
    if (hi >= cr.end) break;
  }
}

// parallel/ring.py:_lse_merge for one element: merge the normalised partial
// (oi, li) into the running (o, L); NEG_INF marks a partial of weight 0.
__device__ __forceinline__ void lse_merge(float& o, float& L, float oi, float li) {
  const float M = fmaxf(L, li);
  const float w_old = L > FA_NEG_INF / 2 ? expf(L - M) : 0.f;
  const float w_new = li > FA_NEG_INF / 2 ? expf(li - M) : 0.f;
  const float z = w_old + w_new;
  const float zs = z > 0.f ? z : 1.f;
  o = o * (w_old / zs) + oi * (w_new / zs);
  L = z > 0.f ? M + logf(zs) : FA_NEG_INF;
}

// ---- tensor-core instances (bf16) -------------------------------------------

// The forward's segments on the tensor cores: tc::fwd_tile_tc (flash_tc.cuh,
// shared with flash_fwd.cu) over the segment's key tiles, the row stored
// from the fragments, or its normalised f32 partial and lse into the slot.
template <int D>
__device__ __forceinline__ void fwd_tri_tc(const FlashTriArgs& a) {
  using bf16 = __nv_bfloat16;
  constexpr int E = FWD_E;
  const uint32_t sQ = tc::tiles(), ring = sQ + wg::tile_bytes<D>();
  const int t = threadIdx.x, row = wg::frag_row(t), col = wg::frag_col(t);
  const int group = a.Hq / a.Hkv;
  const Tri tri = make_tri(a.S, E, a.Hq, a.B);
  const float sl2 = a.scale * tc::kLog2e;          // scores in log2 units
  const tc::TriMask mask{a.S};
  float* ws_lse = a.ws + 2LL * a.ctas * E * D;
  // below D = 64, and at 80 and 96, the chunks past D of Q and both K/V
  // stages, once, published with the first segment's copies (if
  // constexpr: at D = 64 and 128 even the empty loop moved the compiled
  // kernel's registers)
  if constexpr (D % 64 != 0)
    for (int i = 0; i < 5; ++i) wg::zero_pad<D>(sQ + i * wg::tile_bytes<D>());
  constexpr int ACC = tc::acc_floats<D>;

  Walk walk(blockIdx.x, tri, a.ctas);
  Seg sg;
  while (walk.next(sg)) {
    const int b = static_cast<int>(sg.bh / a.Hq), h = static_cast<int>(sg.bh % a.Hq);
    const int kvh = h / group;
    const int q0 = sg.r * E;
    __syncthreads();   // the previous segment's products are done
    wg::load_tile<D>(sQ, static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh, a.q_ss, q0,
                     a.S);
    float acc[ACC], m[2] = {FA_NEG_INF, FA_NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < ACC; ++e) acc[e] = 0.f;
    tc::kv_walk<D>(ring, static_cast<const bf16*>(a.k) + b * a.k_sb + kvh * a.k_sh,
                   static_cast<const bf16*>(a.v) + b * a.v_sb + kvh * a.v_sh, a.k_ss, a.v_ss,
                   a.S, sg.c0, sg.c1 + 1, [](int j) { return j + 1; },
                   [&](uint32_t sK, int kj) {
                     tc::fwd_tile_tc<D>(acc, m, l, sQ, sK, q0, kj * E, sl2, mask);
                   });

    // _finalize_out, then the row or its workspace slot
    float inv[2], lse[2];
    tc::fwd_final(m, l, inv, lse);
    if (sg.whole) {
      tc::store_bf16<ACC, D>(acc, static_cast<bf16*>(a.out) + b * a.o_sb + h * a.o_sh, a.o_ss,
                             q0, a.S, inv);
      tc::store_rows(lse, a.lse + (static_cast<long long>(b) * a.Hq + h) * a.S, q0, a.S);
      continue;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row + 8 * i;
      float* o = a.ws + (static_cast<long long>(sg.slot) * E + r) * D + col;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(o + 8 * j) =
            make_float2(acc[4 * j + 2 * i] * inv[i], acc[4 * j + 2 * i + 1] * inv[i]);
      if ((t & 3) == 0) ws_lse[static_cast<long long>(sg.slot) * E + r] = lse[i];
    }
  }
}

// dQ's segments on the tensor cores: tc::dq_tile_tc (shared with
// flash_bwd.cuh) over the segment's key tiles, the row stored from the
// fragments, or its f32 partial into the slot.
template <int D>
__device__ __forceinline__ void dq_tri_tc(const FlashTriArgs& a) {
  using bf16 = __nv_bfloat16;
  constexpr int E = FWD_E;
  constexpr int TILE = wg::tile_bytes<D>();
  const uint32_t sQ = tc::tiles(), sdO = sQ + TILE, ring = sdO + TILE;
  const int row = wg::frag_row(threadIdx.x), col = wg::frag_col(threadIdx.x);
  const int group = a.Hq / a.Hkv;
  const Tri tri = make_tri(a.S, E, a.Hq, a.B);
  const float sl2 = a.scale * tc::kLog2e;
  const tc::TriMask mask{a.S};
  const float one[2] = {1.f, 1.f};
  // below D = 64, and at 80 and 96, the chunks past D of Q, dO and both
  // K/V stages, once, published with the first segment's copies
  if constexpr (D % 64 != 0)
    for (int i = 0; i < 6; ++i) wg::zero_pad<D>(sQ + i * TILE);
  constexpr int ACC = tc::acc_floats<D>;

  Walk walk(blockIdx.x, tri, a.ctas);
  Seg sg;
  while (walk.next(sg)) {
    const int b = static_cast<int>(sg.bh / a.Hq), h = static_cast<int>(sg.bh % a.Hq);
    const int kvh = h / group;
    const int q0 = sg.r * E;
    __syncthreads();   // the previous segment's products are done
    wg::load_tile<D>(sQ, static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh, a.q_ss, q0,
                     a.S);
    wg::load_tile<D>(sdO, static_cast<const bf16*>(a.dout) + b * a.do_sb + h * a.do_sh,
                     a.do_ss, q0, a.S);
    const long long rows = (static_cast<long long>(b) * a.Hq + h) * a.S;
    float lse2[2], delta[2], acc[ACC];
    bool live[2];
    tc::dq_rows(a.lse + rows, a.delta + rows, q0, a.S, lse2, delta, live);
#pragma unroll
    for (int e = 0; e < ACC; ++e) acc[e] = 0.f;
    tc::kv_walk<D>(ring, static_cast<const bf16*>(a.k) + b * a.k_sb + kvh * a.k_sh,
                   static_cast<const bf16*>(a.v) + b * a.v_sb + kvh * a.v_sh, a.k_ss, a.v_ss,
                   a.S, sg.c0, sg.c1 + 1, [](int j) { return j + 1; },
                   [&](uint32_t sK, int kj) {
                     tc::dq_tile_tc<D>(acc, sQ, sdO, sK, lse2, delta, live, q0, kj * E, sl2,
                                       a.scale, mask);
                   });

    if (sg.whole) {
      tc::store_bf16<ACC, D>(acc, static_cast<bf16*>(a.dq) + b * a.dq_sb + h * a.dq_sh,
                             a.dq_ss, q0, a.S, one);
      continue;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float* o = a.ws + (static_cast<long long>(sg.slot) * E + row + 8 * i) * D + col;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(o + 8 * j) =
            make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
    }
  }
}

// ---- forward --------------------------------------------------------------

template <int D>
constexpr size_t fwd_smem() {
  return fa::smem_bytes<D, FWD_RPT>();
}

template <typename T, int D>
__device__ __forceinline__ void fwd_tri_fma(const FlashTriArgs& a) {
  constexpr int RPT = FWD_RPT, E = FWD_E;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + E * (D + 1);
  float* sV = sK + fa::BK * (D + 1);
  float* sP = sV + fa::BK * D;

  const int lane_c = threadIdx.x & 7;
  const int rg = threadIdx.x >> 3;
  const int group = a.Hq / a.Hkv;
  const Tri tri = make_tri(a.S, E, a.Hq, a.B);
  float* ws_lse = a.ws + 2LL * a.ctas * E * D;
  const T* q = static_cast<const T*>(a.q);
  T* out = static_cast<T*>(a.out);

  Walk walk(blockIdx.x, tri, a.ctas);
  Seg s;
  while (walk.next(s)) {
    const int b = static_cast<int>(s.bh / a.Hq), h = static_cast<int>(s.bh % a.Hq);
    const int kvh = h / group;
    const int q0 = s.r * E;
    fa::RowState<D, RPT> st;
    fa::init_state(st);
    __syncthreads();   // the previous segment's sQ reads are done
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = rg * RPT + i;
      const int sp = q0 + r;
      st.valid[i] = sp < a.S;
      st.qpos[i] = sp;
      fa::load_q_row<T, D>(sQ, r, st.valid[i] ? q + b * a.q_sb + sp * a.q_ss + h * a.q_sh : nullptr,
                           lane_c);
    }
    const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
    const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
    fa::attend_tiles<T, D, RPT>(sQ, sK, sV, sP, st, kb, vb, nullptr, nullptr, a.k_ss, a.v_ss, 0,
                                a.S, /*causal=*/1, /*pad=*/0, /*window=*/0, /*sinks=*/0, a.scale,
                                s.c0, s.c1 + 1, q0);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float lse = fa::finalize_row(st, i);
      const int r = rg * RPT + i;
      if (s.whole) {
        if (!st.valid[i]) continue;
        T* o = out + b * a.o_sb + (q0 + r) * a.o_ss + h * a.o_sh;
#pragma unroll
        for (int c = 0; c < D / 8; ++c) fa::from_f32(o + lane_c + 8 * c, st.acc[i][c]);
        if (lane_c == 0) a.lse[(static_cast<long long>(b) * a.Hq + h) * a.S + q0 + r] = lse;
      } else {
        float* o = a.ws + (static_cast<long long>(s.slot) * E + r) * D;
#pragma unroll
        for (int c = 0; c < D / 8; ++c) o[lane_c + 8 * c] = st.acc[i][c];
        if (lane_c == 0) ws_lse[static_cast<long long>(s.slot) * E + r] = lse;
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(fa::NTHREADS) flash_fwd_tri_kernel(FlashTriArgs a) {
  if constexpr (kTensorCores<T>)
    fwd_tri_tc<D>(a);
  else
    fwd_tri_fma<T, D>(a);
}

template <typename T, int D>
__global__ void __launch_bounds__(fa::NTHREADS) flash_fwd_tri_fixup(FlashTriArgs a) {
  constexpr int E = FWD_E;
  const Tri tri = make_tri(a.S, E, a.Hq, a.B);
  CutRow cr;
  if (!cut_row(blockIdx.x, tri, a.ctas, cr)) return;
  const int b = static_cast<int>(cr.bh / a.Hq), h = static_cast<int>(cr.bh % a.Hq);
  const int q0 = cr.r * E;
  const float* ws_lse = a.ws + 2LL * a.ctas * E * D;
  T* out = static_cast<T*>(a.out);
  for (int idx = threadIdx.x; idx < E * D; idx += fa::NTHREADS) {
    const int row = idx / D, d = idx % D;
    if (q0 + row >= a.S) continue;
    float o = 0.f, L = FA_NEG_INF;
    for_each_piece(blockIdx.x, cr, tri, a.ctas, [&](int slot) {
      const long long at = static_cast<long long>(slot) * E + row;
      lse_merge(o, L, a.ws[at * D + d], ws_lse[at]);
    });
    fa::from_f32(out + b * a.o_sb + (q0 + row) * a.o_ss + h * a.o_sh + d, o);
    if (d == 0) a.lse[(static_cast<long long>(b) * a.Hq + h) * a.S + q0 + row] = L;
  }
}

// ---- dQ -------------------------------------------------------------------

template <int D>
constexpr size_t dq_smem() {   // sQ, sdO [E][D+1]; sK, sV [BK][D+1]; sdS [E][BK+1]
  return sizeof(float) *
         (2 * FWD_E * (D + 1) + 2 * fa::BK * (D + 1) + FWD_E * (fa::BK + 1));
}

template <typename T, int D>
__device__ __forceinline__ void dq_tri_fma(const FlashTriArgs& a) {
  constexpr int RPT = FWD_RPT, E = FWD_E;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + E * (D + 1);
  float* sK = sdO + E * (D + 1);
  float* sV = sK + fa::BK * (D + 1);
  float* sdS = sV + fa::BK * (D + 1);

  const int lane_c = threadIdx.x & 7;
  const int rg = threadIdx.x >> 3;
  const int group = a.Hq / a.Hkv;
  const Tri tri = make_tri(a.S, E, a.Hq, a.B);

  Walk walk(blockIdx.x, tri, a.ctas);
  Seg s;
  while (walk.next(s)) {
    const int b = static_cast<int>(s.bh / a.Hq), h = static_cast<int>(s.bh % a.Hq);
    const int kvh = h / group;
    const int q0 = s.r * E;
    __syncthreads();   // the previous segment's sQ / sdO reads are done
    fa::load_rows<T, D>(sQ, E, static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh, a.q_ss, q0,
                        a.S);
    fa::load_rows<T, D>(sdO, E, static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh,
                        a.do_ss, q0, a.S);
    const long long rows = (static_cast<long long>(b) * a.Hq + h) * a.S;
    float lse[RPT], delta[RPT], acc[RPT][D / 8];
    int qpos[RPT];
    bool valid[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      qpos[i] = q0 + rg * RPT + i;
      valid[i] = qpos[i] < a.S;
      lse[i] = valid[i] ? a.lse[rows + qpos[i]] : FA_NEG_INF;
      delta[i] = valid[i] ? a.delta[rows + qpos[i]] : 0.f;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) acc[i][c] = 0.f;
    }
    const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
    const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
    for (int kj = s.c0; kj <= s.c1; ++kj)
      fa::dq_tile<T, D, RPT>(sQ, sdO, sK, sV, sdS, acc, lse, delta, qpos, valid, kb, vb, a.k_ss,
                             a.v_ss, kj * fa::BK, a.S, /*causal=*/1, /*window=*/0, a.scale);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = rg * RPT + i;
      if (s.whole) {
        if (!valid[i]) continue;
        T* o = static_cast<T*>(a.dq) + b * a.dq_sb + qpos[i] * a.dq_ss + h * a.dq_sh;
#pragma unroll
        for (int c = 0; c < D / 8; ++c) fa::from_f32(o + lane_c + 8 * c, acc[i][c]);
      } else {
        float* o = a.ws + (static_cast<long long>(s.slot) * E + r) * D;
#pragma unroll
        for (int c = 0; c < D / 8; ++c) o[lane_c + 8 * c] = acc[i][c];
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(fa::NTHREADS) flash_bwd_dq_tri_kernel(FlashTriArgs a) {
  if constexpr (kTensorCores<T>)
    dq_tri_tc<D>(a);
  else
    dq_tri_fma<T, D>(a);
}

template <typename T, int D>
__global__ void __launch_bounds__(fa::NTHREADS) flash_bwd_dq_tri_fixup(FlashTriArgs a) {
  constexpr int E = FWD_E;
  const Tri tri = make_tri(a.S, E, a.Hq, a.B);
  CutRow cr;
  if (!cut_row(blockIdx.x, tri, a.ctas, cr)) return;
  const int b = static_cast<int>(cr.bh / a.Hq), h = static_cast<int>(cr.bh % a.Hq);
  const int q0 = cr.r * E;
  T* dq = static_cast<T*>(a.dq);
  for (int idx = threadIdx.x; idx < E * D; idx += fa::NTHREADS) {
    const int row = idx / D, d = idx % D;
    if (q0 + row >= a.S) continue;
    float sum = 0.f;
    for_each_piece(blockIdx.x, cr, tri, a.ctas, [&](int slot) {
      sum += a.ws[(static_cast<long long>(slot) * E + row) * D + d];
    });
    fa::from_f32(dq + b * a.dq_sb + (q0 + row) * a.dq_ss + h * a.dq_sh + d, sum);
  }
}

// ---- dK/dV ----------------------------------------------------------------

template <int D>
constexpr size_t dkv_smem() {  // sK, sV, sQ, sdO [E][D+1]; sP, sdS [E][E+1]; lse, delta
  return sizeof(float) * (4 * DKV_E * (D + 1) + 2 * DKV_E * (DKV_E + 1) + 2 * DKV_E);
}

template <typename T, int D>
__global__ void __launch_bounds__(fa::NTHREADS) flash_bwd_dkv_tri_kernel(FlashTriArgs a) {
  constexpr int KPT = DKV_KPT, E = DKV_E;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + E * (D + 1);
  float* sQ = sV + E * (D + 1);
  float* sdO = sQ + E * (D + 1);
  float* sP = sdO + E * (D + 1);
  float* sdS = sP + E * (E + 1);
  float* sL = sdS + E * (E + 1);
  float* sDelta = sL + E;

  const int lane_c = threadIdx.x & 7;
  const int rg = threadIdx.x >> 3;      // owns keys rg * KPT .. + KPT - 1
  const int group = a.Hq / a.Hkv;
  const Tri tri = make_tri(a.S, E, a.Hkv, a.B);
  float* ws_dv = a.ws + 2LL * a.ctas * E * D;

  Walk walk(blockIdx.x, tri, a.ctas);
  Seg s;
  while (walk.next(s)) {
    const int b = static_cast<int>(s.bh / a.Hkv), kvh = static_cast<int>(s.bh % a.Hkv);
    const int k0 = (tri.n - 1 - s.r) * E;     // _tri_decode_rev: row r is kj = n - 1 - r
    __syncthreads();   // the previous segment's sK / sV reads are done
    fa::load_rows<T, D>(sK, E, static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh, a.k_ss,
                        k0, a.S);
    fa::load_rows<T, D>(sV, E, static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh, a.v_ss,
                        k0, a.S);
    float dk[KPT][D / 8], dv[KPT][D / 8];
    int kpos[KPT];
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      kpos[i] = k0 + rg * KPT + i;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) dk[i][c] = dv[i][c] = 0.f;
    }
    for (int c = s.c0; c <= s.c1; ++c) {
      const int q0 = (tri.n - 1 - c) * E;     // column c is qi = n - 1 - c
      for (int g = 0; g < group; ++g) {       // the GQA fold, innermost in the tile
        const int h = kvh * group + g;
        const long long rows = (static_cast<long long>(b) * a.Hq + h) * a.S;
        fa::dkv_tile<T, D, KPT, E>(
            sK, sV, sQ, sdO, sP, sdS, sL, sDelta, dk, dv, kpos,
            static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh,
            static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh, a.q_ss, a.do_ss,
            a.lse + rows, a.delta + rows, q0, a.S, /*causal=*/1, /*window=*/0, a.scale);
      }
    }
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const int r = rg * KPT + i;
      if (s.whole) {
        if (kpos[i] >= a.S) continue;
        T* okb = static_cast<T*>(a.dk) + b * a.dk_sb + kpos[i] * a.dk_ss + kvh * a.dk_sh;
        T* ovb = static_cast<T*>(a.dv) + b * a.dv_sb + kpos[i] * a.dv_ss + kvh * a.dv_sh;
#pragma unroll
        for (int c = 0; c < D / 8; ++c) {
          fa::from_f32(okb + lane_c + 8 * c, dk[i][c]);
          fa::from_f32(ovb + lane_c + 8 * c, dv[i][c]);
        }
      } else {
        const long long at = (static_cast<long long>(s.slot) * E + r) * D;
#pragma unroll
        for (int c = 0; c < D / 8; ++c) {
          a.ws[at + lane_c + 8 * c] = dk[i][c];
          ws_dv[at + lane_c + 8 * c] = dv[i][c];
        }
      }
    }
  }
}

// The bf16 instance: a 64-key tile per segment on the tensor cores
// (tc::dkv_walk_tc over the segment's query tiles, descending), the cut
// rows' f32 partials stored from the fragments.
template <int D>
__global__ void __launch_bounds__(wg::THREADS, tc::DKV_TC_BLOCKS<D>)
    flash_bwd_dkv_tri_tc_kernel(FlashTriArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int E = tc::E;
  const uint32_t sK = tc::tiles();
  // below D = 64, and at 80 and 96, the chunks past D of K, V and both
  // Q/dO stages, once, published with the first segment's copies
  if constexpr (D % 64 != 0)
    for (int i = 0; i < 6; ++i) wg::zero_pad<D>(sK + i * wg::tile_bytes<D>());
  constexpr int ACC = tc::acc_floats<D>;
  const int t = threadIdx.x, row = wg::frag_row(t), col = wg::frag_col(t);
  const int group = a.Hq / a.Hkv;
  const Tri tri = make_tri(a.S, E, a.Hkv, a.B);
  float* ws_dv = a.ws + 2LL * a.ctas * E * D;
  const tc::TriMask mask{a.S};

  Walk walk(blockIdx.x, tri, a.ctas);
  Seg sg;
  while (walk.next(sg)) {
    const int b = static_cast<int>(sg.bh / a.Hkv), kvh = static_cast<int>(sg.bh % a.Hkv);
    const int k0 = (tri.n - 1 - sg.r) * E;     // _tri_decode_rev: row r is kj = n - 1 - r
    const long long rows = static_cast<long long>(b) * a.Hq * a.S;
    const tc::DkvSrc src{static_cast<const bf16*>(a.k) + b * a.k_sb + kvh * a.k_sh,
                         static_cast<const bf16*>(a.v) + b * a.v_sb + kvh * a.v_sh,
                         static_cast<const bf16*>(a.q) + b * a.q_sb,
                         static_cast<const bf16*>(a.dout) + b * a.do_sb,
                         a.lse + rows, a.delta + rows,
                         a.k_ss, a.v_ss, a.q_ss, a.q_sh, a.do_ss, a.do_sh,
                         a.S, group, kvh, a.scale};
    float dk[ACC], dv[ACC];
#pragma unroll
    for (int e = 0; e < ACC; ++e) dk[e] = dv[e] = 0.f;
    __syncthreads();   // the previous segment's products are done
    // column c is qi = n - 1 - c: the segment's query tiles descend
    tc::dkv_walk_tc<D>(dk, dv, sK, src, k0, tri.n - 1 - sg.c0, sg.c1 - sg.c0 + 1, mask);
    if (sg.whole) {
      tc::dkv_store<D>(dk, dv, static_cast<bf16*>(a.dk) + b * a.dk_sb + kvh * a.dk_sh,
                       a.dk_ss, static_cast<bf16*>(a.dv) + b * a.dv_sb + kvh * a.dv_sh,
                       a.dv_ss, k0, a.S);
      continue;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const long long at = (static_cast<long long>(sg.slot) * E + row + 8 * i) * D + col;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<float2*>(a.ws + at + 8 * j) =
            make_float2(dk[4 * j + 2 * i], dk[4 * j + 2 * i + 1]);
        *reinterpret_cast<float2*>(ws_dv + at + 8 * j) =
            make_float2(dv[4 * j + 2 * i], dv[4 * j + 2 * i + 1]);
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(fa::NTHREADS) flash_bwd_dkv_tri_fixup(FlashTriArgs a) {
  constexpr int E = dkv_edge(kTensorCores<T>);
  const Tri tri = make_tri(a.S, E, a.Hkv, a.B);
  CutRow cr;
  if (!cut_row(blockIdx.x, tri, a.ctas, cr)) return;
  const int b = static_cast<int>(cr.bh / a.Hkv), kvh = static_cast<int>(cr.bh % a.Hkv);
  const int k0 = (tri.n - 1 - cr.r) * E;
  const float* ws_dv = a.ws + 2LL * a.ctas * E * D;
  for (int idx = threadIdx.x; idx < E * D; idx += fa::NTHREADS) {
    const int row = idx / D, d = idx % D;
    const int kp = k0 + row;
    if (kp >= a.S) continue;
    float sk = 0.f, sv = 0.f;
    for_each_piece(blockIdx.x, cr, tri, a.ctas, [&](int slot) {
      const long long at = (static_cast<long long>(slot) * E + row) * D + d;
      sk += a.ws[at];
      sv += ws_dv[at];
    });
    fa::from_f32(static_cast<T*>(a.dk) + b * a.dk_sb + kp * a.dk_ss + kvh * a.dk_sh + d, sk);
    fa::from_f32(static_cast<T*>(a.dv) + b * a.dv_sb + kp * a.dv_ss + kvh * a.dv_sh + d, sv);
  }
}

// ---- launches --------------------------------------------------------------

template <typename T, int D>
constexpr size_t smem_of(int which) {
  return which == FWD  ? (kTensorCores<T> ? tc::fwd_tc_smem<D>() : fwd_smem<D>())
         : which == DQ ? (kTensorCores<T> ? tc::dq_tc_smem<D>() : dq_smem<D>())
                       : (kTensorCores<T> ? tc::dkv_tc_smem<D>() : dkv_smem<D>());
}

template <typename T, int D>
void* dkv_kernel() {
  if constexpr (kTensorCores<T>)
    return reinterpret_cast<void*>(flash_bwd_dkv_tri_tc_kernel<D>);
  else
    return reinterpret_cast<void*>(flash_bwd_dkv_tri_kernel<T, D>);
}

template <typename T, int D>
void* main_kernel(int which) {
  return which == FWD  ? reinterpret_cast<void*>(flash_fwd_tri_kernel<T, D>)
         : which == DQ ? reinterpret_cast<void*>(flash_bwd_dq_tri_kernel<T, D>)
                       : dkv_kernel<T, D>();
}

template <typename T, int D>
void* fixup_kernel(int which) {
  return which == FWD  ? reinterpret_cast<void*>(flash_fwd_tri_fixup<T, D>)
         : which == DQ ? reinterpret_cast<void*>(flash_bwd_dq_tri_fixup<T, D>)
                       : reinterpret_cast<void*>(flash_bwd_dkv_tri_fixup<T, D>);
}

// P for `which`: the SM count times the blocks of the main kernel that fit
// on one SM; a negative cudaError on failure.
template <typename T, int D>
int resident_ctas(int which) {
  const void* fn = main_kernel<T, D>(which);
  const size_t smem = smem_of<T, D>(which);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, fa::NTHREADS,
                                                      smem);
  if (e != cudaSuccess) return -static_cast<int>(e);
  return sms * (per_sm > 0 ? per_sm : 1);
}

// Queues the persistent main launch, then the fixup, on `stream`.
template <typename T, int D>
cudaError_t launch(int which, const FlashTriArgs& a, cudaStream_t stream) {
  const void* fn = main_kernel<T, D>(which);
  const size_t smem = smem_of<T, D>(which);
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  void* args[] = {const_cast<FlashTriArgs*>(&a)};
  e = cudaLaunchKernel(fn, dim3(a.ctas), dim3(fa::NTHREADS), args, smem, stream);
  if (e != cudaSuccess) return e;
  e = cudaLaunchKernel(fixup_kernel<T, D>(which), dim3(a.ctas), dim3(fa::NTHREADS), args, 0,
                       stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// The two head dims one source builds an instance of every kernel at:
// flash_tri.cu 128 and 64, flash_tri_narrow.cu 32 and 16, flash_tri_mid.cu
// 96 and 80.
template <int D0, int D1>
struct HeadDims {
  static constexpr bool has(int D) { return D == D0 || D == D1; }
  // f(integral_constant<D>) at D = D0 or D1 (the caller checked has(D))
  template <typename F>
  static auto at(int D, F f) {
    return D == D0 ? f(std::integral_constant<int, D0>()) : f(std::integral_constant<int, D1>());
  }
};

// f32 workspace values per CTA of `which` at act dtype 0 or 1 and a head
// dim of Dims; 0 for another head dim.
template <typename Dims>
long long ws_floats(int which, int act_dtype, int head_dim) {
  if (!Dims::has(head_dim)) return 0;
  return Dims::at(head_dim,
                  [&](auto d) { return ws_per_cta<decltype(d)::value>(which, act_dtype); });
}

template <typename Dims>
bool takes(int which, const FlashTriArgs* a) {
  return Dims::has(a->D) && (a->act_dtype == 0 || a->act_dtype == 1) && a->Hkv > 0 &&
         a->Hq % a->Hkv == 0 && a->ctas > 0 && a->ws != nullptr &&
         a->ws_floats >= a->ctas * ws_floats<Dims>(which, a->act_dtype, a->D);
}

// Entry `which`: queues its main launch and its fixup on `stream`,
// allocates nothing and does not synchronise; returns cudaGetLastError()
// (0 on success; cudaErrorInvalidValue for what the kernels do not take, a
// head dim not of Dims too).
template <typename Dims>
int run(int which, const FlashTriArgs* a, void* stream) {
  if (a->S <= 0 || a->B <= 0) return 0;
  if (!takes<Dims>(which, a)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return Dims::at(a->D, [&](auto d) {
    constexpr int D = decltype(d)::value;
    return static_cast<int>(a->act_dtype == 0 ? launch<float, D>(which, *a, s)
                                              : launch<__nv_bfloat16, D>(which, *a, s));
  });
}

// The persistent grid P of entry `which` (0 flash_fwd_tri, 1
// flash_bwd_dq_tri, 2 flash_bwd_dkv_tri) for act dtype 0 (f32) or 1 (bf16)
// and a head dim of Dims on the current device (the blocks that fit on an
// SM depend on both): the wrapper sizes the workspace from it and passes it
// back as FlashTriArgs.ctas. A negative value is -cudaError.
template <typename Dims>
int tri_ctas(int which, int act_dtype, int head_dim) {
  if (which < FWD || which > DKV || act_dtype < 0 || act_dtype > 1 || !Dims::has(head_dim))
    return -static_cast<int>(cudaErrorInvalidValue);
  return Dims::at(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    return act_dtype == 0 ? resident_ctas<float, D>(which)
                          : resident_ctas<__nv_bfloat16, D>(which);
  });
}

// f32 workspace values per CTA of entry `which` for act dtype 0 (f32) or 1
// (bf16) and a head dim of Dims (as tri_ctas): the wrapper allocates ctas
// times this and passes the length as FlashTriArgs.ws_floats. A negative
// value is -cudaError.
template <typename Dims>
long long tri_ws_floats(int which, int act_dtype, int head_dim) {
  const long long n = which < FWD || which > DKV || act_dtype < 0 || act_dtype > 1
                          ? 0
                          : ws_floats<Dims>(which, act_dtype, head_dim);
  return n > 0 ? n : -static_cast<long long>(cudaErrorInvalidValue);
}

}  // namespace
