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
// They compute what flash_fwd.cu and flash_bwd.cu compute (the same tile
// steps: attend_tiles, dq_tile, dkv_tile in flash_common.cuh); what differs
// is the schedule.
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
// forward and dQ, the query tile and fa::BK; 32 for dK/dV, whose f32
// accumulators cap the key tile): within each (batch, head) n = ceil(S / E)
// rows and n (n + 1) / 2 live tiles, W = B * H * n (n + 1) / 2 in all.
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
// given P. f32 FMA from shared memory, like the kernels already ported;
// wgmma and TMA are later work.
#include "flash_common.cuh"

namespace {

constexpr int FWD_RPT = 4;                 // forward / dQ: 16 * 4 = 64 query rows
constexpr int FWD_E = 16 * FWD_RPT;        // their tile edge, == fa::BK
constexpr int DKV_KPT = 2;                 // dK/dV: 16 * 2 = 32 keys
constexpr int DKV_E = 16 * DKV_KPT;        // its tile edge (keys and queries)
static_assert(FWD_E == fa::BK, "forward and dQ tiles are square");

enum Which { FWD = 0, DQ = 1, DKV = 2 };

// f32 workspace values per CTA, two slots of E rows each. With P CTAs:
// forward o [2P][E][D] then lse [2P][E]; dQ [2P][E][D]; dK/dV dk [2P][E][D]
// then dv [2P][E][D]. Each kernel finds its second array at 2 P E D.
template <int D>
constexpr long long ws_per_cta(int which) {
  return which == FWD ? 2LL * FWD_E * (D + 1) : which == DQ ? 2LL * FWD_E * D : 4LL * DKV_E * D;
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

// ---- forward --------------------------------------------------------------

template <int D>
constexpr size_t fwd_smem() {
  return fa::smem_bytes<D, FWD_RPT>();
}

template <typename T, int D>
__global__ void __launch_bounds__(fa::NTHREADS) flash_fwd_tri_kernel(FlashTriArgs a) {
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
__global__ void __launch_bounds__(fa::NTHREADS) flash_bwd_dq_tri_kernel(FlashTriArgs a) {
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

template <typename T, int D>
__global__ void __launch_bounds__(fa::NTHREADS) flash_bwd_dkv_tri_fixup(FlashTriArgs a) {
  constexpr int E = DKV_E;
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

template <int D>
constexpr size_t smem_of(int which) {
  return which == FWD ? fwd_smem<D>() : which == DQ ? dq_smem<D>() : dkv_smem<D>();
}

template <typename T, int D>
void* main_kernel(int which) {
  return which == FWD  ? reinterpret_cast<void*>(flash_fwd_tri_kernel<T, D>)
         : which == DQ ? reinterpret_cast<void*>(flash_bwd_dq_tri_kernel<T, D>)
                       : reinterpret_cast<void*>(flash_bwd_dkv_tri_kernel<T, D>);
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
  const size_t smem = smem_of<D>(which);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, fa::NTHREADS, smem);
  if (e != cudaSuccess) return -static_cast<int>(e);
  return sms * (per_sm > 0 ? per_sm : 1);
}

// Queues the persistent main launch, then the fixup, on `stream`.
template <typename T, int D>
cudaError_t launch(int which, const FlashTriArgs& a, cudaStream_t stream) {
  const void* fn = main_kernel<T, D>(which);
  const size_t smem = smem_of<D>(which);
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

bool takes(int which, const FlashTriArgs* a) {
  return a->D == 128 && (a->act_dtype == 0 || a->act_dtype == 1) && a->Hkv > 0 &&
         a->Hq % a->Hkv == 0 && a->ctas > 0 && a->ws != nullptr &&
         a->ws_floats >= a->ctas * ws_per_cta<128>(which);
}

int run(int which, const FlashTriArgs* a, void* stream) {
  if (a->S <= 0 || a->B <= 0) return 0;
  if (!takes(which, a)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(a->act_dtype == 0 ? launch<float, 128>(which, *a, s)
                                            : launch<__nv_bfloat16, 128>(which, *a, s));
}

}  // namespace

// The persistent grid P of entry `which` (0 flash_fwd_tri, 1
// flash_bwd_dq_tri, 2 flash_bwd_dkv_tri) for act dtype 0 (f32) or 1 (bf16)
// on the current device: the wrapper sizes the workspace from it and passes
// it back as FlashTriArgs.ctas. A negative value is -cudaError.
extern "C" int flash_tri_ctas(int which, int act_dtype) {
  if (which < FWD || which > DKV || act_dtype < 0 || act_dtype > 1)
    return -static_cast<int>(cudaErrorInvalidValue);
  return act_dtype == 0 ? resident_ctas<float, 128>(which)
                        : resident_ctas<__nv_bfloat16, 128>(which);
}

// f32 workspace values per CTA of entry `which` (as flash_tri_ctas), at
// head dim 128: the wrapper allocates ctas times this and passes the length
// as FlashTriArgs.ws_floats. A negative value is -cudaError.
extern "C" long long flash_tri_ws_floats(int which) {
  if (which < FWD || which > DKV) return -static_cast<long long>(cudaErrorInvalidValue);
  return ws_per_cta<128>(which);
}

// Each queues its main launch and its fixup on `stream`, allocates nothing
// and does not synchronise; returns cudaGetLastError() (0 on success).
extern "C" int flash_fwd_tri(const FlashTriArgs* a, void* stream) { return run(FWD, a, stream); }

extern "C" int flash_bwd_dq_tri(const FlashTriArgs* a, void* stream) {
  return run(DQ, a, stream);
}

extern "C" int flash_bwd_dkv_tri(const FlashTriArgs* a, void* stream) {
  return run(DKV, a, stream);
}
