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
//   K3  dV = sum_q p^T.dO and dK = scale * sum_q ds^T.q.
//
// Probabilities at or below -5e29 are zeroed (a fully masked tile would
// otherwise leak exp(0) = 1); keys masked by kv_mask, and keys past the
// ragged end, carry the additive bias -1e30.
//
// Layout: q, k, v, O, dO, dQ, dK, dV are contiguous (B, L, H, D) tensors,
// exactly as the projections produce them, so no transpose is needed; lse
// and delta are (B, Lq, H) f32; the key bias is (B, Lk) f32, indexed per
// batch and shared by its heads.
//
// What bounds them on the H100: at the training shapes (B=16, H=12,
// L=128, D=64) each launch moves 12-19 MB and does 0.8-1.6 GFLOP, so the
// floor is HBM bandwidth (about 4-6 us at 3.35 TB/s); the products would
// take under 2 us at the bf16 tensor-core rate.
//
// Design: bf16 operands on the tensor cores through mma.sync m16n8k16.  A
// block of 4 warps owns 64 rows of the output, a warp 16 of them.  The
// warp's rows of the resident operand live in registers as mma A
// fragments; the streamed operand passes through shared memory as raw
// bf16, once row-major and, where it is the B operand of the second
// product, once transposed, with rows padded by 8 elements so fragment
// loads hit 32 distinct banks.  P (K1) and dS (K2, K3) go from the f32
// accumulators of the first product straight into the A fragments of the
// second, rounded to bf16 on the way, without touching memory.  Not done
// yet: pipelined (cp.async/TMA) loads, wgmma.
//
// Each output tile belongs to exactly one block (K2 loops over key tiles,
// K3 over query tiles), so there are no atomics and results are identical
// from run to run.
#pragma once

#include <cuda_bf16.h>

#include "mma_primitives.cuh"

namespace fa {

constexpr float kNeg = -1e30f;
constexpr float kMaskedBelow = -5e29f;   // 0.5 * kNeg
constexpr int kRows = 64;        // output rows per block
constexpr int kTile = 64;        // rows of the streamed operand per tile
constexpr int kMmaThreads = 128; // 4 warps of 16 rows
constexpr int kPad = 8;          // bf16 elements of padding per smem row

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

__device__ __forceinline__ void load_bias(float* dst, const Params& p, int b,
                                          int k0) {
  for (int j = threadIdx.x; j < kTile; j += blockDim.x)
    dst[j] = k0 + j < p.Lk ? p.bias[static_cast<long long>(b) * p.Lk + k0 + j]
                           : kNeg;
}

// Rows [l0, l0 + kTile) of head h as raw bf16 into dst[r * ld + d]
// (row-major) or, with transpose, dst[d * ld + r]; rows past L are 0.
template <int D>
__device__ __forceinline__ void load_tile_bf16(unsigned short* dst, int ld,
                                               const unsigned short* src,
                                               int b, int l0, int L, int H,
                                               int h) {
  for (int i = threadIdx.x; i < kTile * D / 2; i += blockDim.x) {
    const int r = i / (D / 2);
    const int d = 2 * (i - r * (D / 2));
    st32(dst, r * ld + d,
         l0 + r < L ? ld32(src, row_off(b, l0 + r, L, H, h, D) + d) : 0u);
  }
}

template <int D>
__device__ __forceinline__ void load_tile_bf16_t(unsigned short* dst, int ld,
                                                 const unsigned short* src,
                                                 int b, int l0, int L, int H,
                                                 int h) {
  for (int i = threadIdx.x; i < kTile * D; i += blockDim.x) {
    const int r = i / D;
    const int d = i - r * D;
    dst[d * ld + r] =
        l0 + r < L ? src[row_off(b, l0 + r, L, H, h, D) + d] : 0;
  }
}

// A fragments (16 rows x D) of rows r0 and r0 + 8 of a (B, L, H, D) tensor;
// rows past L are 0.
template <int D>
__device__ __forceinline__ void load_a_frags(unsigned (*a)[4],
                                             const unsigned short* src, int b,
                                             int r0, int L, int H, int h,
                                             int t) {
  const int r1 = r0 + 8;
  const long long o0 = row_off(b, r0 < L ? r0 : 0, L, H, h, D);
  const long long o1 = row_off(b, r1 < L ? r1 : 0, L, H, h, D);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = 16 * kk + 2 * t;
    a[kk][0] = r0 < L ? ld32(src, o0 + c) : 0u;
    a[kk][1] = r1 < L ? ld32(src, o1 + c) : 0u;
    a[kk][2] = r0 < L ? ld32(src, o0 + c + 8) : 0u;
    a[kk][3] = r1 < L ? ld32(src, o1 + c + 8) : 0u;
  }
}

// acc[j] (16 x 8 tile j of the 16 x kTile product) += A . M^T, with M the
// kTile x D row-major tile in smem (B[k][n] = M[n][k]).
template <int D>
__device__ __forceinline__ void mma_rows_t(float (*acc)[4],
                                           const unsigned (*a)[4],
                                           const unsigned short* m, int ld,
                                           int g, int t) {
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const unsigned bf[2] = {ld32(m, (8 * j + g) * ld + 16 * kk + 2 * t),
                              ld32(m, (8 * j + g) * ld + 16 * kk + 8 + 2 * t)};
      mma_bf16_16816(acc[j], a[kk], bf);
    }
  }
}

// out[n] (16 x 8 tile n of the 16 x D result) += P . M, with P the
// 16 x kTile f32 accumulators rounded to bf16 and M given transposed in
// smem as mt[d * ld + key].
template <int D>
__device__ __forceinline__ void mma_probs(float (*out)[4],
                                          const float (*pr)[4],
                                          const unsigned short* mt, int ld,
                                          int g, int t) {
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    const unsigned a[4] = {pack_bf16(pr[2 * kk][0], pr[2 * kk][1]),
                           pack_bf16(pr[2 * kk][2], pr[2 * kk][3]),
                           pack_bf16(pr[2 * kk + 1][0], pr[2 * kk + 1][1]),
                           pack_bf16(pr[2 * kk + 1][2], pr[2 * kk + 1][3])};
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const unsigned bf[2] = {ld32(mt, (8 * n + g) * ld + 16 * kk + 2 * t),
                              ld32(mt, (8 * n + g) * ld + 16 * kk + 8 + 2 * t)};
      mma_bf16_16816(out[n], a, bf);
    }
  }
}

// Rows r0 and r0 + 8 of a D-wide f32 accumulator, times s0 and s1, stored
// as bf16 into a (B, L, H, D) tensor; rows past L are skipped.
template <int D>
__device__ __forceinline__ void store_rows(unsigned short* dst,
                                           const float (*acc)[4], float s0,
                                           float s1, int b, int r0, int L,
                                           int H, int h, int t) {
  const int r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = 8 * n + 2 * t;
    if (r0 < L)
      st32(dst, row_off(b, r0, L, H, h, D) + c,
           pack_bf16(acc[n][0] * s0, acc[n][1] * s0));
    if (r1 < L)
      st32(dst, row_off(b, r1, L, H, h, D) + c,
           pack_bf16(acc[n][2] * s1, acc[n][3] * s1));
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads) flash_fwd_bf16_kernel(Params p) {
  constexpr int kLd = D + kPad;       // [row][d] tiles
  constexpr int kLdT = kTile + kPad;  // [d][row] tiles
  extern __shared__ __align__(16) unsigned char fa_smem[];
  unsigned short* ks = reinterpret_cast<unsigned short*>(fa_smem);  // [kTile][kLd]
  unsigned short* vt = ks + kTile * kLd;                              // [D][kLdT]
  float* bs = reinterpret_cast<float*>(vt + D * kLdT);                // [kTile]

  const int tid = threadIdx.x, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y - b * p.H;
  const int q0 = blockIdx.x * kRows;
  const int r0 = q0 + (tid / 32) * 16 + g;   // this thread's rows: r0, r0 + 8

  unsigned qa[D / 16][4];
  load_a_frags<D>(qa, static_cast<const unsigned short*>(p.q), b, r0, p.Lq,
                  p.H, h, t);
  float o[D / 8][4] = {};
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};   // l: this lane's share

  const int n_tiles = key_tiles(p, q0);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kTile;
    __syncthreads();
    load_tile_bf16<D>(ks, kLd, static_cast<const unsigned short*>(p.k), b, k0,
                      p.Lk, p.H, h);
    load_tile_bf16_t<D>(vt, kLdT, static_cast<const unsigned short*>(p.v), b,
                        k0, p.Lk, p.H, h);
    load_bias(bs, p, b, k0);
    __syncthreads();

    float s[kTile / 8][4];
    mma_rows_t<D>(s, qa, ks, kLd, g, t);
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = 8 * j + 2 * t + (e & 1);
        float sc = s[j][e] * p.scale + bs[kj];
        if (p.causal && r0 + (e >> 1) * 8 < k0 + kj) sc = kNeg;
        s[j][e] = sc;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc);
      }
    float m_new[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m_new[i] = fmaxf(m[i], quad_max(mx[i]));
      const float corr = expf(m[i] - m_new[i]);
      l[i] *= corr;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[n][2 * i] *= corr;
        o[n][2 * i + 1] *= corr;
      }
      m[i] = m_new[i];
    }
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float sc = s[j][e];
        const float pj = sc > kMaskedBelow ? expf(sc - m[e >> 1]) : 0.f;
        l[e >> 1] += pj;
        s[j][e] = pj;
      }
    mma_probs<D>(o, s, vt, kLdT, g, t);
  }

  const float lt[2] = {quad_sum(l[0]), quad_sum(l[1])};
  store_rows<D>(static_cast<unsigned short*>(p.o), o,
                1.f / fmaxf(lt[0], 1e-20f), 1.f / fmaxf(lt[1], 1e-20f), b, r0,
                p.Lq, p.H, h, t);
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
__global__ void __launch_bounds__(kMmaThreads) flash_dq_bf16_kernel(Params p) {
  constexpr int kLd = D + kPad;
  constexpr int kLdT = kTile + kPad;
  extern __shared__ __align__(16) unsigned char fa_smem[];
  unsigned short* ks = reinterpret_cast<unsigned short*>(fa_smem);  // [kTile][kLd]
  unsigned short* vs = ks + kTile * kLd;                              // [kTile][kLd]
  unsigned short* kt = vs + kTile * kLd;                              // [D][kLdT]
  float* bs = reinterpret_cast<float*>(kt + D * kLdT);                // [kTile]

  const int tid = threadIdx.x, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y - b * p.H;
  const int q0 = blockIdx.x * kRows;
  const int r0 = q0 + (tid / 32) * 16 + g;

  unsigned qa[D / 16][4], da[D / 16][4];
  load_a_frags<D>(qa, static_cast<const unsigned short*>(p.q), b, r0, p.Lq,
                  p.H, h, t);
  load_a_frags<D>(da, static_cast<const unsigned short*>(p.dout), b, r0, p.Lq,
                  p.H, h, t);
  float lse[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    const long long so = stat_off(b, r < p.Lq ? r : 0, p.Lq, p.H, h);
    lse[i] = r < p.Lq ? p.lse[so] : -kNeg;
    delta[i] = r < p.Lq ? p.delta[so] : 0.f;
  }
  float dq[D / 8][4] = {};

  const int n_tiles = key_tiles(p, q0);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kTile;
    __syncthreads();
    const unsigned short* k = static_cast<const unsigned short*>(p.k);
    load_tile_bf16<D>(ks, kLd, k, b, k0, p.Lk, p.H, h);
    load_tile_bf16_t<D>(kt, kLdT, k, b, k0, p.Lk, p.H, h);
    load_tile_bf16<D>(vs, kLd, static_cast<const unsigned short*>(p.v), b, k0,
                      p.Lk, p.H, h);
    load_bias(bs, p, b, k0);
    __syncthreads();

    float s[kTile / 8][4], dp[kTile / 8][4];
    mma_rows_t<D>(s, qa, ks, kLd, g, t);
    mma_rows_t<D>(dp, da, vs, kLd, g, t);
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = 8 * j + 2 * t + (e & 1);
        float sc = s[j][e] * p.scale + bs[kj];
        if (p.causal && r0 + (e >> 1) * 8 < k0 + kj) sc = kNeg;
        const float pj = sc > kMaskedBelow ? expf(sc - lse[e >> 1]) : 0.f;
        s[j][e] = pj * (dp[j][e] - delta[e >> 1]);   // ds
      }
    mma_probs<D>(dq, s, kt, kLdT, g, t);
  }
  store_rows<D>(static_cast<unsigned short*>(p.o), dq, p.scale, p.scale, b,
                r0, p.Lq, p.H, h, t);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads) flash_dkv_bf16_kernel(Params p) {
  constexpr int kLd = D + kPad;
  constexpr int kLdT = kTile + kPad;
  extern __shared__ __align__(16) unsigned char fa_smem[];
  unsigned short* qs = reinterpret_cast<unsigned short*>(fa_smem);  // [kTile][kLd]
  unsigned short* dos = qs + kTile * kLd;                             // [kTile][kLd]
  unsigned short* qt = dos + kTile * kLd;                             // [D][kLdT]
  unsigned short* dot = qt + D * kLdT;                                // [D][kLdT]
  float* ls = reinterpret_cast<float*>(dot + D * kLdT);               // [kTile] lse
  float* dls = ls + kTile;                                            // [kTile] delta

  const int tid = threadIdx.x, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y - b * p.H;
  const int k0 = blockIdx.x * kRows;
  const int r0 = k0 + (tid / 32) * 16 + g;   // this thread's keys: r0, r0 + 8

  unsigned ka[D / 16][4], va[D / 16][4];
  load_a_frags<D>(ka, static_cast<const unsigned short*>(p.k), b, r0, p.Lk,
                  p.H, h, t);
  load_a_frags<D>(va, static_cast<const unsigned short*>(p.v), b, r0, p.Lk,
                  p.H, h, t);
  float kb[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    kb[i] = r < p.Lk ? p.bias[static_cast<long long>(b) * p.Lk + r] : kNeg;
  }
  float dk[D / 8][4] = {}, dv[D / 8][4] = {};

  // Query tiles strictly above the diagonal contribute nothing.
  const int t0 = p.causal ? k0 / kTile : 0;
  const int n_tiles = (p.Lq + kTile - 1) / kTile;
  for (int tile = t0; tile < n_tiles; ++tile) {
    const int q0 = tile * kTile;
    __syncthreads();
    const unsigned short* q = static_cast<const unsigned short*>(p.q);
    const unsigned short* dout = static_cast<const unsigned short*>(p.dout);
    load_tile_bf16<D>(qs, kLd, q, b, q0, p.Lq, p.H, h);
    load_tile_bf16_t<D>(qt, kLdT, q, b, q0, p.Lq, p.H, h);
    load_tile_bf16<D>(dos, kLd, dout, b, q0, p.Lq, p.H, h);
    load_tile_bf16_t<D>(dot, kLdT, dout, b, q0, p.Lq, p.H, h);
    for (int i = tid; i < kTile; i += blockDim.x) {
      const bool in = q0 + i < p.Lq;
      const long long so = stat_off(b, in ? q0 + i : 0, p.Lq, p.H, h);
      ls[i] = in ? p.lse[so] : -kNeg;
      dls[i] = in ? p.delta[so] : 0.f;
    }
    __syncthreads();

    // Transposed scores: rows are this warp's keys, columns the queries.
    float st[kTile / 8][4], dpt[kTile / 8][4];
    mma_rows_t<D>(st, ka, qs, kLd, g, t);
    mma_rows_t<D>(dpt, va, dos, kLd, g, t);
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 8 * j + 2 * t + (e & 1);
        float sc = st[j][e] * p.scale + kb[e >> 1];
        if (p.causal && q0 + qi < r0 + (e >> 1) * 8) sc = kNeg;
        const float pj = sc > kMaskedBelow ? expf(sc - ls[qi]) : 0.f;
        st[j][e] = pj;
        dpt[j][e] = pj * (dpt[j][e] - dls[qi]);   // ds^T
      }
    mma_probs<D>(dv, st, dot, kLdT, g, t);
    mma_probs<D>(dk, dpt, qt, kLdT, g, t);
  }
  unsigned short* dko = static_cast<unsigned short*>(p.o);
  unsigned short* dvo = static_cast<unsigned short*>(p.o2);
  store_rows<D>(dko, dk, p.scale, p.scale, b, r0, p.Lk, p.H, h, t);
  store_rows<D>(dvo, dv, 1.f, 1.f, b, r0, p.Lk, p.H, h, t);
}

// Dynamic shared memory of each kernel, in bytes.
template <int D> constexpr int fwd_bf16_smem() {
  return (kTile * (D + kPad) + D * (kTile + kPad)) * 2 + kTile * 4;
}
template <int D> constexpr int dq_bf16_smem() {
  return (2 * kTile * (D + kPad) + D * (kTile + kPad)) * 2 + kTile * 4;
}
template <int D> constexpr int dkv_bf16_smem() {
  return (2 * kTile * (D + kPad) + 2 * D * (kTile + kPad)) * 2 + 2 * kTile * 4;
}

}  // namespace fa
