// Flash attention for Hopper: forward (K1), dQ (K2) and dK/dV (K3).
//
// Replaces the Pallas TPU kernels of colearn_federated_learning_tpu/ops/
// attention.py: _flash_kernel (K1), _flash_dq_kernel (K2) and
// _flash_dkv_kernel (K3).  Each computes what its TPU kernel computes:
//
//   K1  s = q.k^T * scale + bias, online softmax over 64-key tiles with
//       (m, l, acc) in f32, p rounded to bf16 before p.V;
//       emits O and the per-row logsumexp (lse).  A fully masked row gives
//       O = 0 and lse = +1e30, so the backward recomputes p = 0 there.
//   K2  dQ = scale * sum_k ds.K with p = exp(s - lse), ds = p*(dO.V^T - delta),
//       ds rounded to bf16 before the product.
//   K3  dV = sum_q p^T.dO and dK = scale * sum_q ds^T.q, p and ds rounded
//       to bf16 before the products.
//
// Probabilities at or below -5e29 are zeroed (a fully masked tile would
// otherwise leak exp(0) = 1); keys masked by kv_mask carry the additive
// bias -1e30, and keys past the ragged end get the score -1e30.  All sums
// are f32.
//
// Layout: q, k, v, O, dO, dQ, dK, dV are contiguous (B, L, H, D) tensors,
// exactly as the projections produce them, so no transpose is needed; lse
// and delta are (B, Lq, H) f32; the key bias is (B, Lk) f32, indexed per
// batch and shared by its heads.
//
// What bounds them on the H100: at the training shapes (B=16, H=12,
// L=128, D=64) a launch must move 12-19 MB (3.8-5.7 us at the 3.35 TB/s of
// HBM) and do 0.8-1.6 GFLOP (under 2 us at the bf16 tensor-core peak), so
// the floor is set by bytes, and the design is about the memory path:
// every byte a block needs in flight early, in wide transactions, moved
// once.  Once it is (timed on the card, chip_smoke.py), the kernels run
// about as fast with their inputs left in L2 as from HBM: what remains is
// each SM's own work -- ldmatrix traffic (every warp reads the whole
// streamed tile, 4x per block), the mma.sync instruction rate and the
// softmax's f32 arithmetic -- and the latency of a grid that fits in one
// wave.
//
// The three kernels share one design:
// - A block of 4 warps owns 64 rows of the output (K1 and K2 queries, K3
//   keys), a warp 16 of them.  Each output tile has one owner block (K1
//   and K2 loop over key tiles, K3 over query tiles), so there are no
//   atomics and results are bitwise repeatable.  64 rows, not 128: at
//   B = 16 the grid's 384 blocks fill the 132 SMs about three deep, where
//   192 would leave most with one; the second block of a (b, h) finds K
//   and V (K1, K2) or Q and dO (K3) in L2.
// - Every tile enters shared memory by 16-byte cp.async copies, zero-filled
//   past the ragged end, spread over all 128 threads so that 8 neighbouring
//   lanes copy one 128-byte row.  The block's own rows (Q in K1; Q and dO
//   in K2; K and V in K3) ride in the first tile's commit group.  The
//   streamed tiles (K1 and K2: K, V and the key bias of each 64-key tile;
//   K3: Q, dO, lse and delta of each 64-query tile) pass through a ring of
//   2 stages: tile i+1 is in flight while tile i is multiplied, and at
//   L = 128 a block's whole stream is in flight from the start.  K1 and K2
//   commit K and V of a tile as two groups, so that the scores and p start
//   before V lands.  lse and delta are H floats apart in (B, Lq, H), so K3
//   copies them by 4-byte copies and K2 loads its rows' into registers.
// - Rows in shared memory are padded by 16 bytes, so the 8 row addresses of
//   an ldmatrix phase fall on 8 distinct 4-bank groups.
// - Fragments come by ldmatrix.x4: the A operands (Q in K1; Q and dO in
//   K2; K and V in K3) and the B operands of the first products (K in K1;
//   K and V in K2; Q and dO in K3) as they lie, the B operands of the
//   second products (V; K; Q and dO again) by ldmatrix.x4.trans from the
//   same row-major tiles.  No transposed copy of any tile is made.
// - P (K1), dS (K2) and P, dS (K3) go from the f32 accumulators of the
//   first products straight into the A fragments of the second, rounded to
//   bf16 on the way, without touching memory.
// - exp is 2^x on the MUFU unit (exp(x - m) = 2^(x log2 e - m log2 e)), and
//   the ragged-end and causal masks are applied only on the tiles (K3:
//   passes) that have masked entries; the rest of the softmax is the f32
//   arithmetic the plain version does.  K1 and K2 must mask keys past Lk
//   themselves: their bias is zero-filled there.  In K2 nothing else would
//   show the omission (the zero K and V rows cancel a wrong p), so the
//   mask is kept for the semantics.
// - Outputs are staged in the shared rows their warp read its A operand
//   from, then leave by 16-byte coalesced stores.
// - Registers: K3 takes a query tile in passes of 32 queries (16 at
//   D = 128), so its live dK, dV and one pass's S^T, dP^T leave room for 3
//   blocks of 128 threads per SM at D <= 64 without spills.  K2 holds a
//   whole tile's S and dP (f32) beside dQ, and its A fragments come from
//   shared memory tile by tile, so it fits 128 registers: 4 blocks per SM
//   at D <= 64 (3 fit at 156 registers, and were 2 % slower on the card).
//   Either way the 384-block grid at B = 16 is one wave.
//
// Tensor cores: mma.sync m16n8k16 with f32 accumulators.  A wgmma form of
// K1's first product (Q from registers, K read once per warpgroup from a
// core-matrix layout) was right on the card but slower: started and awaited
// tile by tile, it overlaps nothing.  wgmma pays only with its products in
// flight beside the softmax of the tile before.
#pragma once

#include <cuda_bf16.h>

#include <type_traits>

#include "mma_primitives.cuh"

namespace fa {

constexpr float kNeg = -1e30f;
constexpr float kMaskedBelow = -5e29f;   // 0.5 * kNeg
constexpr int kRows = 64;        // output rows per block
constexpr int kTile = 64;        // rows of the streamed operand per tile
constexpr int kMmaThreads = 128; // 4 warps of 16 rows
constexpr int kPad = 8;          // bf16 elements of padding per smem row
constexpr int kStages = 2;       // depth of the ring of streamed tiles
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;    // (B, Lk)
  const void* dout;     // (B, Lq, H, D), backward only
  const float* lse;     // (B, Lq, H)
  const float* delta;   // (B, Lq, H), backward only
  void* o;              // K1: O; K2: dQ; K3: dK
  void* o2;             // K3: dV
  float* lse_out;       // K1 only
  int B, Lq, Lk, H;
  float scale;
  int causal;
};

// Offset of element (b, l, h, 0) in a contiguous (B, L, H, D) tensor.
__device__ __forceinline__ long long row_off(int b, int l, int L, int H,
                                             int h, int D) {
  return ((static_cast<long long>(b) * L + l) * H + h) * D;
}

__device__ __forceinline__ long long stat_off(int b, int l, int L, int H,
                                              int h) {
  return (static_cast<long long>(b) * L + l) * H + h;
}

// Number of kTile-key tiles a block of query rows [q0, q0 + kRows) needs:
// with causal masking, tiles entirely above the diagonal are skipped.
__device__ __forceinline__ int key_tiles(const Params& p, int q0) {
  const int n = (p.Lk + kTile - 1) / kTile;
  const int need = (q0 + kRows + kTile - 1) / kTile;
  return p.causal && need < n ? need : n;
}

// ------------------------------------------------------ building blocks

// Start the copies of rows [l0, l0 + NR) of head h of a (B, L, H, D)
// tensor into dst (row stride D + kPad), 16 bytes each; rows past L are
// zero-filled.
template <int D, int NR>
__device__ __forceinline__ void copy_rows(unsigned short* dst,
                                           const unsigned short* src, int b,
                                           int l0, int L, int H, int h) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < NR * kChunks; i += blockDim.x) {
    const int r = i / kChunks;
    const int c = (i - r * kChunks) * 8;
    const bool in = l0 + r < L;
    cp_async16(dst + r * (D + kPad) + c,
               src + row_off(b, in ? l0 + r : 0, L, H, h, D) + c, in);
  }
}

// Start the copies of key tile `tile` (K, V and the key bias of keys
// [tile * kTile, tile * kTile + kTile)) into stage tile % kStages of the
// ring: kv holds per stage K then V ([kTile][D + kPad] each), bs the bias
// ([kTile]).  Two commit groups, K with its bias and then V, so that a
// tile's scores start before its V lands; past the block's last tile the
// groups are empty, which keeps the wait counts uniform.
template <int D>
__device__ __forceinline__ void copy_key_tile(unsigned short* kv, float* bs,
                                              const Params& p, int b, int h,
                                              int tile, int n_tiles) {
  constexpr int kLd = D + kPad;
  const int s = tile % kStages, k0 = tile * kTile;
  unsigned short* ks = kv + 2 * s * kTile * kLd;
  if (tile < n_tiles) {
    copy_rows<D, kTile>(ks, static_cast<const unsigned short*>(p.k), b, k0,
                        p.Lk, p.H, h);
    for (int j = threadIdx.x; j < kTile; j += blockDim.x) {
      const bool in = k0 + j < p.Lk;
      cp_async4(bs + s * kTile + j,
                p.bias + static_cast<long long>(b) * p.Lk + (in ? k0 + j : 0),
                in);
    }
  }
  cp_async_commit();
  if (tile < n_tiles)
    copy_rows<D, kTile>(ks + kTile * kLd,
                        static_cast<const unsigned short*>(p.v), b, k0, p.Lk,
                        p.H, h);
  cp_async_commit();
}

// A fragments (16 rows x 16 columns at column c0) of rows r0 .. r0 + 15 of
// a row-major smem tile with row stride ld.
__device__ __forceinline__ void a_frag(unsigned* a, const unsigned short* m,
                                       int ld, int r0, int c0, int lane) {
  ldmatrix_x4(a, m + (r0 + (lane & 15)) * ld + c0 + (lane >> 4) * 8);
}

// B fragments of two 8-column tiles of B = M^T (B[k][n] = M[n][k]) at
// depth k0 .. k0 + 15: b[0..1] for columns n0 .. n0 + 7, b[2..3] for
// n0 + 8 .. n0 + 15, where M is a row-major smem tile (rows n).
__device__ __forceinline__ void bt_frags(unsigned* b, const unsigned short* m,
                                         int ld, int n0, int k0, int lane) {
  ldmatrix_x4(b, m + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 +
                     ((lane >> 3) & 1) * 8);
}

// B fragments of two 8-column tiles of B = M (B[k][n] = M[k][n]) at depth
// k0 .. k0 + 15: b[0..1] for columns n0 .. n0 + 7, b[2..3] for
// n0 + 8 .. n0 + 15, from the same row-major smem tile (rows k).
__device__ __forceinline__ void b_frags(unsigned* b, const unsigned short* m,
                                        int ld, int k0, int n0, int lane) {
  ldmatrix_x4_trans(b, m + (k0 + (lane & 15)) * ld + n0 + (lane >> 4) * 8);
}

// The A fragment of a 16 x 16 bf16 tile from f32 accumulators acc[j],
// acc[j + 1] (columns 8j .. 8j + 15), rounded to bf16.
__device__ __forceinline__ void pack_a(unsigned* a, const float* c0,
                                       const float* c1) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// A warp's 16 x D f32 accumulator times s0 (row g) and s1 (row g + 8),
// rounded to bf16 into its 16 smem rows at `rows` (stride D + kPad), then
// out to rows [r0, r0 + 16) of head h of a (B, L, H, D) tensor by 16-byte
// stores; rows past L are skipped.  The warp must own those smem rows.
template <int D>
__device__ __forceinline__ void store_tile(unsigned short* dst,
                                           unsigned short* rows,
                                           const float (*acc)[4], float s0,
                                           float s1, int b, int r0, int L,
                                           int H, int h, int lane) {
  constexpr int kLd = D + kPad;
  constexpr int kChunks = D / 8;
  const int g = lane / 4, t = lane % 4;
  __syncwarp();
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    st32(rows, g * kLd + 8 * n + 2 * t, pack_bf16(acc[n][0] * s0,
                                                  acc[n][1] * s0));
    st32(rows, (g + 8) * kLd + 8 * n + 2 * t, pack_bf16(acc[n][2] * s1,
                                                        acc[n][3] * s1));
  }
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = i / kChunks;
    const int c = (i - r * kChunks) * 8;
    if (r0 + r < L)
      *reinterpret_cast<uint4*>(dst + row_off(b, r0 + r, L, H, h, D) + c) =
          *reinterpret_cast<const uint4*>(rows + r * kLd + c);
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads) flash_fwd_bf16_kernel(Params p) {
  constexpr int kLd = D + kPad;
  extern __shared__ __align__(16) unsigned char fa_smem[];
  // qs: [kRows][kLd] Q, then O.  kv: per stage, K then V, [kTile][kLd] each.
  // bs: per stage, the key bias [kTile].
  unsigned short* qs = reinterpret_cast<unsigned short*>(fa_smem);
  unsigned short* kv = qs + kRows * kLd;
  float* bs = reinterpret_cast<float*>(kv + kStages * 2 * kTile * kLd);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y - b * p.H;
  const int q0 = blockIdx.x * kRows;
  const int r0 = q0 + warp * 16 + g;   // this thread's rows: r0, r0 + 8
  const int n_tiles = key_tiles(p, q0);

  copy_rows<D, kRows>(qs, static_cast<const unsigned short*>(p.q), b, q0,
                       p.Lq, p.H, h);
#pragma unroll
  for (int i = 0; i < kStages; ++i)   // Q rides with K of tile 0
    copy_key_tile<D>(kv, bs, p, b, h, i, n_tiles);

  unsigned qa[D / 16][4];
  float o[D / 8][4] = {};
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};   // l: this lane's share

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<2 * kStages - 1>();   // this thread's copies of K ...
    __syncthreads();                       // ... and everyone's
    if (tile == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        a_frag(qa[kk], qs, kLd, warp * 16, 16 * kk, lane);
    }
    const int s = tile % kStages, k0 = tile * kTile;
    const unsigned short* ks = kv + 2 * s * kTile * kLd;
    const unsigned short* vs = ks + kTile * kLd;
    const float* bias = bs + s * kTile;

    float sc[kTile / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int j = 0; j < kTile / 8; j += 2) {
        unsigned bf[4];
        bt_frags(bf, ks, kLd, 8 * j, 16 * kk, lane);
        mma_bf16_16816(sc[j], qa[kk], bf);
        mma_bf16_16816(sc[j + 1], qa[kk], bf + 2);
      }
    // Keys past Lk, and with causal masking keys after the row, score
    // -1e30; only a tile at the ragged end or across the diagonal has any.
    float mx[2] = {kNeg, kNeg};
    auto scores = [&](auto edge) {
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = 8 * j + 2 * t + (e & 1);
          float x = sc[j][e] * p.scale + bias[kj];
          if (decltype(edge)::value &&
              (k0 + kj >= p.Lk ||
               (p.causal && r0 + (e >> 1) * 8 < k0 + kj)))
            x = kNeg;
          sc[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
    };
    if (k0 + kTile > p.Lk || (p.causal && q0 + warp * 16 < k0 + kTile - 1))
      scores(std::true_type{});
    else
      scores(std::false_type{});
    // p = exp(x - m) as 2^(x log2(e) - m log2(e)): one FFMA and one
    // MUFU.EX2.  Scores at or below -5e29 give p = 0: below a row maximum
    // above -5e29 the power underflows to 0 by itself, and a row whose
    // maximum is that low has only such scores, so its offset is -inf.
    float ml[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mx[i]));
      const float corr = exp2f((m[i] - m_new) * kLog2e);
      l[i] *= corr;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[n][2 * i] *= corr;
        o[n][2 * i + 1] *= corr;
      }
      m[i] = m_new;
      ml[i] = m_new > kMaskedBelow ? -m_new * kLog2e : -INFINITY;
    }
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pj = exp2f(fmaf(sc[j][e], kLog2e, ml[e >> 1]));
        l[e >> 1] += pj;
        sc[j][e] = pj;
      }
    cp_async_wait<2 * kStages - 2>();   // V of the tile
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      unsigned a[4];
      pack_a(a, sc[2 * kk], sc[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        unsigned bf[4];
        b_frags(bf, vs, kLd, 16 * kk, 8 * n, lane);
        mma_bf16_16816(o[n], a, bf);
        mma_bf16_16816(o[n + 1], a, bf + 2);
      }
    }
    __syncthreads();                // every warp is done with stage s
    copy_key_tile<D>(kv, bs, p, b, h, tile + kStages, n_tiles);
  }
  cp_async_wait<0>();

  const float lt[2] = {quad_sum(l[0]), quad_sum(l[1])};
  store_tile<D>(static_cast<unsigned short*>(p.o), qs + warp * 16 * kLd, o,
                1.f / fmaxf(lt[0], 1e-20f), 1.f / fmaxf(lt[1], 1e-20f), b,
                q0 + warp * 16, p.Lq, p.H, h, lane);
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      if (r < p.Lq)
        p.lse_out[stat_off(b, r, p.Lq, p.H, h)] =
            lt[i] > 0.f ? m[i] + logf(fmaxf(lt[i], 1e-30f)) : -kNeg;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads, D <= 64 ? 3 : 1)
    flash_dkv_bf16_kernel(Params p) {
  constexpr int kLd = D + kPad;
  // Queries per pass over a tile: the f32 S^T and dP^T of a pass live
  // beside dK and dV, so at D = 128 a pass takes 16 queries.
  constexpr int kPass = D <= 64 ? 32 : 16;
  extern __shared__ __align__(16) unsigned char fa_smem[];
  // ks, vs: [kRows][kLd] this block's K and V rows, then dK and dV.
  // qd: per stage, Q then dO, [kTile][kLd] each.  st: per stage, lse then
  // delta, [kTile] each.
  unsigned short* ks = reinterpret_cast<unsigned short*>(fa_smem);
  unsigned short* vs = ks + kRows * kLd;
  unsigned short* qd = vs + kRows * kLd;
  float* st = reinterpret_cast<float*>(qd + kStages * 2 * kTile * kLd);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y - b * p.H;
  const int k0 = blockIdx.x * kRows;
  const int r0 = k0 + warp * 16 + g;   // this thread's keys: r0, r0 + 8
  const unsigned short* q = static_cast<const unsigned short*>(p.q);
  const unsigned short* dout = static_cast<const unsigned short*>(p.dout);

  // Query tiles strictly above the diagonal contribute nothing.
  const int t0 = p.causal ? k0 / kTile : 0;
  const int n_tiles = (p.Lq + kTile - 1) / kTile;
  // Query tile i goes to stage i % kStages; one commit group per tile.
  auto copy_tile = [&](int tile) {
    if (tile < n_tiles) {
      const int s = tile % kStages, q0 = tile * kTile;
      unsigned short* qs = qd + 2 * s * kTile * kLd;
      copy_rows<D, kTile>(qs, q, b, q0, p.Lq, p.H, h);
      copy_rows<D, kTile>(qs + kTile * kLd, dout, b, q0, p.Lq, p.H, h);
      float* ls = st + 2 * s * kTile;
      for (int i = tid; i < 2 * kTile; i += blockDim.x) {
        const int j = i % kTile;
        if (q0 + j < p.Lq)
          cp_async4(ls + i, (i < kTile ? p.lse : p.delta) +
                                stat_off(b, q0 + j, p.Lq, p.H, h), true);
        else
          ls[i] = i < kTile ? -kNeg : 0.f;   // p = 0 for absent queries
      }
    }
    cp_async_commit();
  };
  copy_rows<D, kRows>(ks, static_cast<const unsigned short*>(p.k), b, k0,
                       p.Lk, p.H, h);
  copy_rows<D, kRows>(vs, static_cast<const unsigned short*>(p.v), b, k0,
                       p.Lk, p.H, h);
#pragma unroll
  for (int i = 0; i < kStages; ++i) copy_tile(t0 + i);   // K, V ride with t0

  float kb[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    kb[i] = r < p.Lk ? p.bias[static_cast<long long>(b) * p.Lk + r] : kNeg;
  }
  float dk[D / 8][4] = {}, dv[D / 8][4] = {};

  for (int tile = t0; tile < n_tiles; ++tile) {
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const int s = tile % kStages, q0 = tile * kTile;
    const unsigned short* qs = qd + 2 * s * kTile * kLd;
    const unsigned short* dos = qs + kTile * kLd;
    const float* ls = st + 2 * s * kTile;
    const float* dls = ls + kTile;

#pragma unroll 1
    for (int c0 = 0; c0 < kTile; c0 += kPass) {   // first query of a pass
      // Transposed scores: rows are this warp's keys, columns the queries.
      float sc[kPass / 8][4] = {}, dp[kPass / 8][4] = {};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        unsigned ka[4], va[4];
        a_frag(ka, ks, kLd, warp * 16, 16 * kk, lane);
        a_frag(va, vs, kLd, warp * 16, 16 * kk, lane);
#pragma unroll
        for (int j = 0; j < kPass / 8; j += 2) {
          unsigned bq[4], bd[4];
          bt_frags(bq, qs, kLd, c0 + 8 * j, 16 * kk, lane);
          bt_frags(bd, dos, kLd, c0 + 8 * j, 16 * kk, lane);
          mma_bf16_16816(sc[j], ka, bq);
          mma_bf16_16816(sc[j + 1], ka, bq + 2);
          mma_bf16_16816(dp[j], va, bd);
          mma_bf16_16816(dp[j + 1], va, bd + 2);
        }
      }
      // p = exp(x - lse) as 2^((x - lse) log2(e)), which is 0 for a score
      // at or below -5e29 (lse is finite, or +1e30 for a fully masked
      // query).  With causal masking, queries before a key score -1e30,
      // which only a pass across the diagonal has.
      auto probs = [&](auto edge) {
#pragma unroll
        for (int j = 0; j < kPass / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = c0 + 8 * j + 2 * t + (e & 1);
            float x = sc[j][e] * p.scale + kb[e >> 1];
            if (decltype(edge)::value && q0 + qi < r0 + (e >> 1) * 8)
              x = kNeg;
            const float pj = exp2f((x - ls[qi]) * kLog2e);
            sc[j][e] = pj;
            dp[j][e] = pj * (dp[j][e] - dls[qi]);   // ds^T
          }
      };
      if (p.causal && q0 + c0 < k0 + warp * 16 + 15)
        probs(std::true_type{});
      else
        probs(std::false_type{});
#pragma unroll
      for (int kk = 0; kk < kPass / 16; ++kk) {
        unsigned pa[4], da[4];
        pack_a(pa, sc[2 * kk], sc[2 * kk + 1]);
        pack_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int n = 0; n < D / 8; n += 2) {
          unsigned bo[4], bq[4];
          b_frags(bo, dos, kLd, c0 + 16 * kk, 8 * n, lane);
          b_frags(bq, qs, kLd, c0 + 16 * kk, 8 * n, lane);
          mma_bf16_16816(dv[n], pa, bo);
          mma_bf16_16816(dv[n + 1], pa, bo + 2);
          mma_bf16_16816(dk[n], da, bq);
          mma_bf16_16816(dk[n + 1], da, bq + 2);
        }
      }
    }
    __syncthreads();                // every warp is done with stage s
    copy_tile(tile + kStages);
  }
  cp_async_wait<0>();               // K and V landed even if no tile ran
  __syncthreads();

  const int w0 = k0 + warp * 16;
  store_tile<D>(static_cast<unsigned short*>(p.o), ks + warp * 16 * kLd, dk,
                p.scale, p.scale, b, w0, p.Lk, p.H, h, lane);
  store_tile<D>(static_cast<unsigned short*>(p.o2), vs + warp * 16 * kLd, dv,
                1.f, 1.f, b, w0, p.Lk, p.H, h, lane);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads, D <= 64 ? 4 : 1)
    flash_dq_bf16_kernel(Params p) {
  constexpr int kLd = D + kPad;
  extern __shared__ __align__(16) unsigned char fa_smem[];
  // qs: [kRows][kLd] Q, then dQ.  dos: [kRows][kLd] dO.  kv: per stage, K
  // then V, [kTile][kLd] each.  bs: per stage, the key bias [kTile].
  unsigned short* qs = reinterpret_cast<unsigned short*>(fa_smem);
  unsigned short* dos = qs + kRows * kLd;
  unsigned short* kv = dos + kRows * kLd;
  float* bs = reinterpret_cast<float*>(kv + kStages * 2 * kTile * kLd);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y - b * p.H;
  const int q0 = blockIdx.x * kRows;
  const int r0 = q0 + warp * 16 + g;   // this thread's rows: r0, r0 + 8
  const int n_tiles = key_tiles(p, q0);

  copy_rows<D, kRows>(qs, static_cast<const unsigned short*>(p.q), b, q0,
                       p.Lq, p.H, h);
  copy_rows<D, kRows>(dos, static_cast<const unsigned short*>(p.dout), b, q0,
                       p.Lq, p.H, h);
#pragma unroll
  for (int i = 0; i < kStages; ++i)   // Q and dO ride with K of tile 0
    copy_key_tile<D>(kv, bs, p, b, h, i, n_tiles);

  // Rows past Lq get p = 0: lse +1e30, as for a fully masked row.
  float lse[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    const long long so = stat_off(b, r < p.Lq ? r : 0, p.Lq, p.H, h);
    lse[i] = r < p.Lq ? p.lse[so] : -kNeg;
    delta[i] = r < p.Lq ? p.delta[so] : 0.f;
  }
  float dq[D / 8][4] = {};

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<2 * kStages - 1>();   // this thread's copies of K ...
    __syncthreads();                       // ... and everyone's
    const int s = tile % kStages, k0 = tile * kTile;
    const unsigned short* ks = kv + 2 * s * kTile * kLd;
    const unsigned short* vs = ks + kTile * kLd;
    const float* bias = bs + s * kTile;

    float sc[kTile / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      unsigned qa[4];
      a_frag(qa, qs, kLd, warp * 16, 16 * kk, lane);
#pragma unroll
      for (int j = 0; j < kTile / 8; j += 2) {
        unsigned bf[4];
        bt_frags(bf, ks, kLd, 8 * j, 16 * kk, lane);
        mma_bf16_16816(sc[j], qa, bf);
        mma_bf16_16816(sc[j + 1], qa, bf + 2);
      }
    }
    // p = exp(x - lse) as 2^((x - lse) log2(e)), which is 0 for a score at
    // or below -5e29 (lse is finite, or +1e30 for a fully masked row).
    // Keys past Lk (their bias is zero-filled) and, with causal masking,
    // keys after the row score -1e30; only a tile at the ragged end or
    // across the diagonal has any.
    auto probs = [&](auto edge) {
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = 8 * j + 2 * t + (e & 1);
          float x = sc[j][e] * p.scale + bias[kj];
          if (decltype(edge)::value &&
              (k0 + kj >= p.Lk ||
               (p.causal && r0 + (e >> 1) * 8 < k0 + kj)))
            x = kNeg;
          sc[j][e] = exp2f((x - lse[e >> 1]) * kLog2e);
        }
    };
    if (k0 + kTile > p.Lk || (p.causal && q0 + warp * 16 < k0 + kTile - 1))
      probs(std::true_type{});
    else
      probs(std::false_type{});
    cp_async_wait<2 * kStages - 2>();   // V of the tile
    __syncthreads();
    float dp[kTile / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      unsigned da[4];
      a_frag(da, dos, kLd, warp * 16, 16 * kk, lane);
#pragma unroll
      for (int j = 0; j < kTile / 8; j += 2) {
        unsigned bf[4];
        bt_frags(bf, vs, kLd, 8 * j, 16 * kk, lane);
        mma_bf16_16816(dp[j], da, bf);
        mma_bf16_16816(dp[j + 1], da, bf + 2);
      }
    }
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[j][e] *= dp[j][e] - delta[e >> 1];   // ds
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      unsigned a[4];
      pack_a(a, sc[2 * kk], sc[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        unsigned bf[4];
        b_frags(bf, ks, kLd, 16 * kk, 8 * n, lane);
        mma_bf16_16816(dq[n], a, bf);
        mma_bf16_16816(dq[n + 1], a, bf + 2);
      }
    }
    __syncthreads();                // every warp is done with stage s
    copy_key_tile<D>(kv, bs, p, b, h, tile + kStages, n_tiles);
  }
  cp_async_wait<0>();

  store_tile<D>(static_cast<unsigned short*>(p.o), qs + warp * 16 * kLd, dq,
                p.scale, p.scale, b, q0 + warp * 16, p.Lq, p.H, h, lane);
}

// Dynamic shared memory of each kernel, in bytes.
template <int D> constexpr int fwd_bf16_smem() {
  return (kRows + kStages * 2 * kTile) * (D + kPad) * 2 + kStages * kTile * 4;
}
template <int D> constexpr int dq_bf16_smem() {
  return (2 * kRows + kStages * 2 * kTile) * (D + kPad) * 2 +
         kStages * kTile * 4;
}
template <int D> constexpr int dkv_bf16_smem() {
  return (2 * kRows + kStages * 2 * kTile) * (D + kPad) * 2 +
         kStages * 2 * kTile * 4;
}

}  // namespace fa
