// N1: the top-k-by-magnitude selector of the uplink compression (C entry
// points loaded with ctypes by colearn_federated_learning_tpu_torch/ops/
// _build.py; the wrapper is ops/topk.py).
//
// Replaces the JAX package's native/src/topk.cpp (cl_topk_abs, a
// thread-parallel radix select on the host, called per leaf by
// fed/compression.py through native.topk_abs).  It computes the same
// function: the k entries of a flat float32 leaf with the largest
// magnitude bits (bits & 0x7FFFFFFF, so -0.0 == +0.0 and NaN ranks above
// inf), ties to the lower index, their int32 indices ascending and their
// values src[idx] bit for bit.  One call selects every leaf of a tree
// (a table on the card gives each leaf's pointer, n, k and output
// offset), into one output buffer.
//
// Design.  A leaf of at most kSmallMax entries is small: one block does
// its whole selection in shared memory.  A larger leaf takes two reads,
// as the JAX selector does:
//   K1 hist_kernel: blocks over (leaf, tile) histogram the top 11 key
//      bits into the leaf's global histogram (shared bins; a warp whose
//      32 entries share a bin, as in an all-zero stretch, adds once).
//      The leaf's last block (threadfence and an atomic ticket) picks the
//      boundary bin b* where the count from the top reaches k, `need1`,
//      how many of its entries are taken, and numbers B's tiles.  The same
//      launch's first blocks do the small leaves' whole selections (three
//      digit passes of 11, 10 and 10 bits and one stable compaction, all
//      in shared memory).
//   K2 collect_kernel: read 2.  Tiles in index order (block t is tile t)
//      compact, by a single-pass scan with decoupled look-back, the
//      entries above b* into A (index, value bits; k - need1 of them, all
//      selected) and b*'s entries into B (index, value bits), and
//      histogram B's key bits 19..10.
//   K3 resolve_kernel: over B alone, each B tile picks the digit of bits
//      19..10 from that histogram and histograms bits 9..0 among the
//      entries of it; the leaf's last B tile picks the threshold key T and
//      `need`, how many entries equal to T are taken.
//   K4 choose_kernel compacts, again with look-back, B's entries above T
//      and its first `need` entries equal to T (B is in index order, so
//      ties go to the lower index) into C (index, value bits; need1 of
//      them), each tile's run written coalesced from shared memory.
//   K5 merge_kernel merges A and C (both ascending) into the leaf's k
//      outputs by merge path: each block's output range is split between
//      A and C by a warp's search on its diagonal, the two segments meet
//      in shared memory.  O(k) bytes.
// Reads of a large leaf: two (K1, K2); K3-K5 touch B, A and C only.
// Launches per call: one memset of the counters, histograms and look-back
// flags, then K1, and K2-K5 when a leaf is large: at most six, however
// many leaves.  No host sync: the call is capturable in a CUDA graph.
// Degenerate leaves (all zeros, a constant, k = n) put a whole leaf into
// b*: B is sized for that (the scratch holds n entries of B per large
// leaf) and the resolve then reads all of it.  K3 and K4 take a fixed grid
// over the tiles B really holds (K1 numbers them; K4 hands them out by
// ticket when there are more than blocks).
//
// What bounds it on an H100: bytes.  The least work reads each leaf once
// (n * 4 bytes) and writes k * 8; a large leaf is read twice, coalesced
// (16-byte loads, all of a tile's in flight at once), with B about
// 1-2 % of a delta's leaf (one bin of the 2048 spans an eighth of an
// octave).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kMagMask = 0x7FFFFFFFu;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kThreads = 512;
constexpr int kPerThread = 16;
constexpr int kTile = kThreads * kPerThread;       // entries per tile: 8192
constexpr int kSmallMax = kTile;                   // one block's leaf
constexpr int kPadded = kTile + kTile / kPerThread;
constexpr int kMaxBins = 2048;                     // 11 bits
constexpr int kLowBins = 1024;                     // 10 bits
constexpr int kMergePer = 8;
constexpr int kMergeTile = kThreads * kMergePer;   // outputs per merge block
constexpr long long kResolveBlocks = 132 * 2;      // K3, K4: a wave

// One row of the table (int64 each): the leaf's source pointer, output
// offset, n, k, then for a large leaf its offsets into A and B (entries),
// its first tile and its first merge block.  Large leaves come first.
struct Leaf {
  long long src, out, n, k, a_off, b_off, tile0, merge0;
};

// A large leaf's selection state (zeroed before K1).
struct LeafState {
  unsigned ticket1, ticket3;
  unsigned bstar, need1, nb;       // K1: boundary bin, taken from it, |B|
  unsigned bt0, bta;               // K1: its first B tile, its B tiles
  unsigned thresh, need;           // K3: the key T, how many equal to T
  unsigned hist1[kMaxBins];
  unsigned hist2[kLowBins];
  unsigned hist3[kLowBins];
};

// Look-back words: flag in bits 63..62 (1: the tile's aggregate, 2: its
// inclusive prefix), then two 31-bit counts (first << 31 | second).
constexpr unsigned long long kAggregate = 1ULL << 62;
constexpr unsigned long long kPrefix = 2ULL << 62;
constexpr unsigned long long kValueMask = (1ULL << 62) - 1;

__device__ __forceinline__ int pad(int w) { return w + w / kPerThread; }

// A tile's two counts, 16 bits each (hi << 16 | lo), as a look-back
// word's value (hi << 31 | lo).
__device__ __forceinline__ unsigned long long tile_counts(unsigned packed) {
  return (static_cast<unsigned long long>(packed >> 16) << 31) |
         (packed & 0xFFFFu);
}

// The thread's kPerThread words of the tile p[0, cnt) into v, all loads
// in flight before any is used: 16-byte loads where the tile is whole and
// aligned (returns true; word j then sits at tile position
// tile_pos(j, true)), else one word a load (missing words 0).
__device__ __forceinline__ bool load_tile(const unsigned* __restrict__ p,
                                          int cnt,
                                          unsigned (&v)[kPerThread]) {
  if (cnt == kTile && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int j = 0; j < kPerThread / 4; ++j) {
      const uint4 x = __ldg(q + threadIdx.x + kThreads * j);
      v[4 * j] = x.x;
      v[4 * j + 1] = x.y;
      v[4 * j + 2] = x.z;
      v[4 * j + 3] = x.w;
    }
    return true;
  }
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int w = threadIdx.x + kThreads * j;
    v[j] = w < cnt ? __ldg(p + w) : 0u;
  }
  return false;
}

__device__ __forceinline__ int tile_pos(int j, bool vec) {
  return vec ? 4 * (threadIdx.x + kThreads * (j >> 2)) + (j & 3)
             : threadIdx.x + kThreads * j;
}

// The tile p[0, cnt) into shared memory (padded, so thread t's
// kPerThread consecutive words are conflict-free).
__device__ __forceinline__ void stage_tile(const unsigned* __restrict__ p,
                                           int cnt, unsigned* sdata) {
  unsigned v[kPerThread];
  const bool vec = load_tile(p, cnt, v);
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int w = tile_pos(j, vec);
    if (w < cnt) sdata[pad(w)] = v[j];
  }
}

// Exclusive scan over the block of a per-thread value; `total` gets the
// block's sum.  Every thread of the block must call it.
template <typename T>
__device__ T block_exclusive_scan(T v, T* total) {
  __shared__ T warp_sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  T x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    T s = lane < nwarps ? warp_sums[lane] : T(0);
    for (int o = 1; o < 32; o <<= 1) {
      const T y = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += y;
    }
    warp_sums[lane] = s;
  }
  __syncthreads();
  const T before = warp > 0 ? warp_sums[warp - 1] : T(0);
  *total = warp_sums[nwarps - 1];
  __syncthreads();            // warp_sums is reused by the next call
  return before + x - v;
}

// Adds one to bins[digit] for every lane with `take`: one shared atomic
// when all 32 lanes take the same digit, else one a lane.  Every lane of
// the warp must call it.
__device__ __forceinline__ void warp_count(unsigned* bins, bool take,
                                           unsigned digit) {
  const unsigned lead = __shfl_sync(kFull, digit, 0);
  if (__all_sync(kFull, take && digit == lead)) {
    if ((threadIdx.x & 31) == 0) atomicAdd(bins + lead, 32u);
  } else if (take) {
    atomicAdd(bins + digit, 1u);
  }
}

// Adds the block's nonzero shared bins into global ones.
__device__ __forceinline__ void flush_bins(const unsigned* bins, int nbins,
                                           unsigned* global) {
  for (int b = threadIdx.x; b < nbins; b += kThreads)
    if (bins[b]) atomicAdd(global + b, bins[b]);
}

// Walking `nbins` bins from the top, the bin where the count from the top
// first reaches `want`, and how many of its entries that leaves to take:
// written to *bin and *rem by one thread.  Every thread must call it;
// `kGlobal` reads bins that other blocks' atomics filled.
template <bool kGlobal>
__device__ void pick_bin(const unsigned* bins, int nbins, unsigned want,
                         unsigned* bin, unsigned* rem) {
  constexpr int kPer = kMaxBins / kThreads;
  unsigned c[kPer];
  unsigned mine = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int pos = threadIdx.x * kPer + j;            // descending position
    c[j] = 0;
    if (pos < nbins)
      c[j] = kGlobal ? __ldcg(bins + nbins - 1 - pos) : bins[nbins - 1 - pos];
    mine += c[j];
  }
  unsigned total;
  unsigned above = block_exclusive_scan<unsigned>(mine, &total);
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int pos = threadIdx.x * kPer + j;
    if (pos < nbins && above < want && above + c[j] >= want) {
      *bin = static_cast<unsigned>(nbins - 1 - pos);
      *rem = want - above;
    }
    above += c[j];
  }
}

// True in every thread of the one block that arrives last of `count` at
// `ticket`, after the block's global atomics (made visible first).
__device__ bool last_block(unsigned* ticket, unsigned count) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == count - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// The large leaf whose range of `field` (tile0 or merge0) holds `t`.
__device__ int find_leaf(const Leaf* tab, int nl, long long t, int field) {
  int lo = 0, hi = nl - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    const long long start = field == 0 ? __ldg(&tab[mid].tile0)
                                       : __ldg(&tab[mid].merge0);
    if (start <= t) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// Publishes tile t's aggregate, or its inclusive prefix if it is the
// leaf's first tile, as soon as the block has it (thread 0).
__device__ __forceinline__ void publish(unsigned long long* status,
                                        long long t, long long first,
                                        unsigned long long agg) {
  if (threadIdx.x == 0)
    *reinterpret_cast<volatile unsigned long long*>(status + t) =
        (t == first ? kPrefix : kAggregate) | agg;
}

// After publish(): warp 0 looks back over the tiles before t down to the
// leaf's `first`, 32 of them a round, and publishes t's inclusive prefix.
// Returns the exclusive prefix (31-bit packed) to every thread.
__device__ unsigned long long look_back(unsigned long long* status, long long t,
                                        long long first,
                                        unsigned long long agg) {
  __shared__ unsigned long long excl_s;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    volatile unsigned long long* st = status;
    unsigned long long excl = 0;
    for (long long j = t - 1 - lane; t > first; j -= 32) {
      unsigned long long s = kPrefix;         // before the leaf: prefix 0
      if (j >= first) {
        do {
          s = st[j];
        } while ((s >> 62) == 0);
      }
      // The nearest inclusive prefix, then the words up to it.
      const unsigned done = __ballot_sync(kFull, (s >> 62) == 2);
      const int stop = done ? __ffs(done) - 1 : 31;
      unsigned long long v = lane <= stop ? (s & kValueMask) : 0ULL;
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
      excl += v;
      if (done) break;
    }
    if (lane == 0) {
      if (t > first) st[t] = kPrefix | (excl + agg);
      excl_s = excl;
    }
  }
  __syncthreads();
  return excl_s;
}

// ------------------------------------------------------------ small leaf
// One block: the whole selection of a leaf of at most kSmallMax entries,
// held in shared memory.
__device__ void select_small(const Leaf& L, int* __restrict__ out_idx,
                             unsigned* __restrict__ out_val, unsigned* sdata,
                             unsigned* bins) {
  __shared__ unsigned bin_s, rem_s;
  const int n = static_cast<int>(L.n);
  stage_tile(reinterpret_cast<const unsigned*>(L.src), n, sdata);
  unsigned prefix = 0, rem = static_cast<unsigned>(L.k);
  for (int p = 0; p < 3; ++p) {                 // bits 30..20, 19..10, 9..0
    const int nbits = p == 0 ? 11 : 10, shift = 20 - 10 * p;
    const int nbins = 1 << nbits, hi = shift + nbits;
    for (int b = threadIdx.x; b < nbins; b += kThreads) bins[b] = 0;
    __syncthreads();
    for (int base = 0; base < n; base += kThreads) {   // whole warps
      const int w = base + threadIdx.x;
      bool take = false;
      unsigned digit = 0;
      if (w < n) {
        const unsigned key = sdata[pad(w)] & kMagMask;
        take = hi >= 31 || (key >> hi) == prefix;
        digit = (key >> shift) & (nbins - 1);
      }
      warp_count(bins, take, digit);
    }
    __syncthreads();
    pick_bin<false>(bins, nbins, rem, &bin_s, &rem_s);
    __syncthreads();
    prefix = (prefix << nbits) | bin_s;
    rem = rem_s;
  }
  // prefix is the threshold key T; rem entries equal to T are taken.
  const int w0 = threadIdx.x * kPerThread;
  unsigned long long mine = 0;
  for (int j = 0; j < kPerThread; ++j) {
    if (w0 + j < n) {
      const unsigned key = sdata[pad(w0 + j)] & kMagMask;
      mine += key > prefix ? (1ULL << 32) : (key == prefix ? 1ULL : 0ULL);
    }
  }
  unsigned long long total;
  const unsigned long long before =
      block_exclusive_scan<unsigned long long>(mine, &total);
  unsigned above = static_cast<unsigned>(before >> 32);
  unsigned equal = static_cast<unsigned>(before & 0xFFFFFFFFull);
  for (int j = 0; j < kPerThread; ++j) {
    const int w = w0 + j;
    if (w >= n) break;
    const unsigned word = sdata[pad(w)];
    const unsigned key = word & kMagMask;
    if (key > prefix || (key == prefix && equal < rem)) {
      const long long pos = L.out + above + min(equal, rem);
      out_idx[pos] = w;
      out_val[pos] = word;
    }
    if (key > prefix) ++above;
    else if (key == prefix) ++equal;
  }
}

// ------------------------------------------------------------------ K1
__global__ void __launch_bounds__(kThreads)
hist_kernel(const Leaf* __restrict__ tab, int nl, int ns,
            LeafState* __restrict__ state, unsigned* __restrict__ btiles,
            int* __restrict__ btile_leaf, int* __restrict__ out_idx,
            unsigned* __restrict__ out_val) {
  __shared__ unsigned sdata[kPadded];
  __shared__ unsigned bins[kMaxBins];
  if (static_cast<int>(blockIdx.x) < ns) {
    const Leaf L = tab[nl + blockIdx.x];
    select_small(L, out_idx, out_val, sdata, bins);
    return;
  }
  const long long t = static_cast<long long>(blockIdx.x) - ns;
  const int leaf = find_leaf(tab, nl, t, 0);
  const Leaf L = tab[leaf];
  LeafState* st = state + leaf;
  const long long base = (t - L.tile0) * kTile;
  const int cnt = static_cast<int>(min(static_cast<long long>(kTile),
                                       L.n - base));
  unsigned v[kPerThread];
  const bool vec = load_tile(reinterpret_cast<const unsigned*>(L.src) + base,
                             cnt, v);
  for (int b = threadIdx.x; b < kMaxBins; b += kThreads) bins[b] = 0;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kPerThread; ++j)
    warp_count(bins, vec || tile_pos(j, false) < cnt,
               (v[j] & kMagMask) >> 20);
  __syncthreads();
  flush_bins(bins, kMaxBins, st->hist1);
  const unsigned tiles = static_cast<unsigned>((L.n + kTile - 1) / kTile);
  if (!last_block(&st->ticket1, tiles)) return;
  __shared__ unsigned bin_s, rem_s;
  pick_bin<true>(st->hist1, kMaxBins, static_cast<unsigned>(L.k), &bin_s,
                 &rem_s);
  __syncthreads();
  // The leaf's B tiles take a range of the compact B-tile space that K3
  // and K4 walk (the tiles of all large leaves' B).
  __shared__ unsigned bt0_s, bta_s;
  if (threadIdx.x == 0) {
    const unsigned nb = __ldcg(st->hist1 + bin_s);
    bta_s = (nb + kTile - 1) / kTile;
    bt0_s = atomicAdd(btiles, bta_s);
    st->bstar = bin_s;
    st->need1 = rem_s;
    st->nb = nb;
    st->bt0 = bt0_s;
    st->bta = bta_s;
  }
  __syncthreads();
  for (unsigned u = threadIdx.x; u < bta_s; u += kThreads)
    btile_leaf[bt0_s + u] = leaf;
}

// ------------------------------------------------------------------ K2
// Tile t is block t: blocks start in index order (as CUB's single-pass
// scans rely on), so every tile a block waits on in its look-back has
// started.  A tile's A and B entries meet in shared memory (up to
// kStage of them; a tile with more writes them where they fall) and go
// out in coalesced runs.  K3 picks the digit of B's histogram.
constexpr int kStage = 1024;

__global__ void __launch_bounds__(kThreads, 4)
collect_kernel(const Leaf* __restrict__ tab, int nl,
               LeafState* __restrict__ state,
               unsigned long long* __restrict__ status,
               int* __restrict__ a_idx, unsigned* __restrict__ a_val,
               int* __restrict__ b_idx, unsigned* __restrict__ b_val) {
  __shared__ unsigned sdata[kPadded];
  __shared__ unsigned bins[kLowBins];
  __shared__ int stage_idx[kStage];
  __shared__ unsigned stage_val[kStage];
  for (int b = threadIdx.x; b < kLowBins; b += kThreads) bins[b] = 0;
  const long long t = blockIdx.x;
  const int leaf = find_leaf(tab, nl, t, 0);
  const Leaf* L = tab + leaf;
  LeafState* st = state + leaf;
  const long long n = __ldg(&L->n);
  const long long base = (t - __ldg(&L->tile0)) * kTile;
  const int cnt = static_cast<int>(min(static_cast<long long>(kTile),
                                       n - base));
  stage_tile(reinterpret_cast<const unsigned*>(__ldg(&L->src)) + base, cnt,
             sdata);
  const unsigned bstar = st->bstar;
  __syncthreads();
  // The thread's entries above b* and in it, as bit masks; the block's
  // counts are below 2^16 (above b* in the high half).
  const int w0 = threadIdx.x * kPerThread;
  unsigned amask = 0, bmask = 0;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const unsigned bin = (sdata[pad(w0 + j)] & kMagMask) >> 20;
    if (w0 + j < cnt) {
      amask |= static_cast<unsigned>(bin > bstar) << j;
      bmask |= static_cast<unsigned>(bin == bstar) << j;
    }
  }
  const unsigned mine = (__popc(amask) << 16) | __popc(bmask);
  unsigned total;
  const unsigned before = block_exclusive_scan<unsigned>(mine, &total);
  const unsigned na = total >> 16, nb = total & 0xFFFFu;
  const long long tile0 = __ldg(&L->tile0);
  const unsigned long long agg = tile_counts(total);
  publish(status, t, tile0, agg);
  const int i0 = static_cast<int>(base);
  const bool staged = na + nb <= kStage;
  if (staged) {
    // A's entries at [0, na), B's at [na, na + nb), in index order, while
    // the tiles before this one publish.
    unsigned at = before >> 16;
    for (unsigned m = amask; m; m &= m - 1, ++at) {
      const int j = __ffs(m) - 1;
      stage_idx[at] = i0 + w0 + j;
      stage_val[at] = sdata[pad(w0 + j)];
    }
    at = na + (before & 0xFFFFu);
    for (unsigned m = bmask; m; m &= m - 1, ++at) {
      const int j = __ffs(m) - 1;
      stage_idx[at] = i0 + w0 + j;
      stage_val[at] = sdata[pad(w0 + j)];
    }
  }
  const unsigned long long excl = look_back(status, t, tile0, agg);
  int* ai = a_idx + __ldg(&L->a_off) + (excl >> 31);
  unsigned* av = a_val + (ai - a_idx);
  int* bi = b_idx + __ldg(&L->b_off) + (excl & 0x7FFFFFFFull);
  unsigned* bv = b_val + (bi - b_idx);
  if (staged) {
    for (int q = threadIdx.x; q < static_cast<int>(na); q += kThreads) {
      ai[q] = stage_idx[q];
      av[q] = stage_val[q];
    }
    for (int q0 = 0; q0 < static_cast<int>(nb); q0 += kThreads) {
      const int q = q0 + threadIdx.x;     // whole warps for warp_count
      const bool in = q < static_cast<int>(nb);
      const unsigned word = in ? stage_val[na + q] : 0u;
      if (in) {
        bi[q] = stage_idx[na + q];
        bv[q] = word;
      }
      warp_count(bins, in, (word >> 10) & (kLowBins - 1));
    }
  } else {
    ai += before >> 16;
    av += before >> 16;
    bi += before & 0xFFFFu;
    bv += before & 0xFFFFu;
#pragma unroll 1
    for (int j = 0; j < kPerThread; ++j) {
      const unsigned word = sdata[pad(w0 + j)];
      if ((amask >> j) & 1) {
        *ai++ = i0 + w0 + j;
        *av++ = word;
      } else if ((bmask >> j) & 1) {
        *bi++ = i0 + w0 + j;
        *bv++ = word;
      }
      warp_count(bins, (bmask >> j) & 1, (word >> 10) & (kLowBins - 1));
    }
  }
  __syncthreads();
  flush_bins(bins, kLowBins, st->hist2);
}

// ------------------------------------------------------------------ K3
// Per B tile: the digit of bits 19..10 from K2's histogram (the entries
// with it form the prefix of key bits 30..10), then among B's entries of
// that prefix a histogram of bits 9..0; the leaf's last B tile picks the
// threshold.  Blocks stride over the compact B-tile space.
__global__ void __launch_bounds__(kThreads)
resolve_kernel(LeafState* __restrict__ state,
               const unsigned* __restrict__ btiles,
               const int* __restrict__ btile_leaf, const Leaf* __restrict__ tab,
               const unsigned* __restrict__ b_val) {
  __shared__ unsigned bins[kLowBins];
  __shared__ unsigned bin_s, rem_s;
  const unsigned total = *btiles;
  for (unsigned u = blockIdx.x; u < total; u += gridDim.x) {
    const int leaf = btile_leaf[u];
    LeafState* st = state + leaf;
    const long long base = static_cast<long long>(u - st->bt0) * kTile;
    const int cnt = static_cast<int>(min(static_cast<long long>(kTile),
                                         st->nb - base));
    unsigned v[kPerThread];
    const bool vec = load_tile(b_val + tab[leaf].b_off + base, cnt, v);
    __syncthreads();                  // the last tile's bins are flushed
    pick_bin<true>(st->hist2, kLowBins, st->need1, &bin_s, &rem_s);
    for (int b = threadIdx.x; b < kLowBins; b += kThreads) bins[b] = 0;
    __syncthreads();
    const unsigned prefix = (st->bstar << 10) | bin_s, need2 = rem_s;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const unsigned key = v[j] & kMagMask;
      warp_count(bins, (vec || tile_pos(j, false) < cnt) &&
                           (key >> 10) == prefix,
                 key & (kLowBins - 1));
    }
    __syncthreads();
    flush_bins(bins, kLowBins, st->hist3);
    if (!last_block(&st->ticket3, st->bta)) continue;
    __syncthreads();                  // bin_s, rem_s read
    pick_bin<true>(st->hist3, kLowBins, need2, &bin_s, &rem_s);
    __syncthreads();
    if (threadIdx.x == 0) {
      st->thresh = (prefix << 10) | bin_s;
      st->need = rem_s;
    }
  }
}

// ------------------------------------------------------------------ K4
// Every tile's predecessors are taken by running blocks.  A tile's chosen
// entries are one run of C: they meet in shared memory and go out
// coalesced.  Dynamic shared memory: the tile's values, then the run's
// indices and values (kChooseSmem bytes).
constexpr int kChooseSmem = (kPadded + 2 * kTile) * 4;

__global__ void __launch_bounds__(kThreads, 2)
choose_kernel(const LeafState* __restrict__ state,
              const unsigned* __restrict__ btiles,
              const int* __restrict__ btile_leaf, const Leaf* __restrict__ tab,
              unsigned long long* __restrict__ status,
              unsigned* __restrict__ ticket, const int* __restrict__ b_idx,
              const unsigned* __restrict__ b_val, int* __restrict__ c_idx,
              unsigned* __restrict__ c_val) {
  extern __shared__ unsigned smem[];
  unsigned* svals = smem;
  int* run_idx = reinterpret_cast<int*>(smem + kPadded);
  unsigned* run_val = smem + kPadded + kTile;
  __shared__ unsigned u_s;
  const unsigned total = *btiles;
  if (blockIdx.x >= total) return;    // the others take every B tile
  // Where the grid covers B, block u is tile u (blocks start in index
  // order, as in K2); else blocks take tiles by ticket.
  const bool by_ticket = total > gridDim.x;
  const int w0 = threadIdx.x * kPerThread;
  for (unsigned round = 0;; ++round) {
    __syncthreads();                  // the last tile is done with smem
    if (threadIdx.x == 0) u_s = by_ticket ? atomicAdd(ticket, 1u) : blockIdx.x;
    __syncthreads();
    const unsigned u = u_s;
    if (u >= total || (!by_ticket && round > 0)) return;
    const int leaf = btile_leaf[u];
    const LeafState* st = state + leaf;
    const long long first = st->bt0;
    const long long base = (u - first) * kTile;
    const unsigned thresh = st->thresh, need = st->need;
    const int cnt = static_cast<int>(min(static_cast<long long>(kTile),
                                         st->nb - base));
    {                                 // B is small: four loads in flight
      const unsigned* p = b_val + tab[leaf].b_off + base;
#pragma unroll 4
      for (int w = threadIdx.x; w < cnt; w += kThreads)
        svals[pad(w)] = __ldg(p + w);
    }
    __syncthreads();
    // The thread's entries above T and equal to T, as bit masks.
    unsigned gt = 0, eq = 0;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const unsigned key = svals[pad(w0 + j)] & kMagMask;
      if (w0 + j < cnt) {
        gt |= static_cast<unsigned>(key > thresh) << j;
        eq |= static_cast<unsigned>(key == thresh) << j;
      }
    }
    // Counts below 2^16 a tile (above T in the high half).
    unsigned sum;
    const unsigned before =
        block_exclusive_scan<unsigned>((__popc(gt) << 16) | __popc(eq), &sum);
    const unsigned long long agg = tile_counts(sum);
    publish(status, u, first, agg);
    const unsigned long long excl = look_back(status, u, first, agg);
    // Counts below 2^31: 32-bit from here.  The tile's run of C starts at
    // `start` and holds `len` entries.
    const unsigned ex_above = static_cast<unsigned>(excl >> 31);
    const unsigned ex_equal = static_cast<unsigned>(excl & 0x7FFFFFFFull);
    const unsigned start = ex_above + min(ex_equal, need);
    unsigned above = ex_above + (before >> 16);
    unsigned equal = ex_equal + (before & 0xFFFFu);
    const int* bi = b_idx + tab[leaf].b_off + base;
    for (unsigned m = gt | eq; m; m &= m - 1) {
      const int j = __ffs(m) - 1;
      const bool above_t = (gt >> j) & 1;
      if (above_t || equal < need) {
        const unsigned at = above + min(equal, need) - start;
        run_idx[at] = __ldg(bi + w0 + j);
        run_val[at] = svals[pad(w0 + j)];
      }
      if (above_t) ++above;
      else ++equal;
    }
    const unsigned len = ex_above + (sum >> 16) +
                         min(ex_equal + (sum & 0xFFFFu), need) - start;
    __syncthreads();
    int* ci = c_idx + tab[leaf].a_off + start;
    unsigned* cv = c_val + tab[leaf].a_off + start;
    for (int q = threadIdx.x; q < static_cast<int>(len); q += kThreads) {
      ci[q] = run_idx[q];
      cv[q] = run_val[q];
    }
  }
}

// ------------------------------------------------------------------ K5
// How many of the first d merged entries come from a (the rest from c):
// the merge-path split on diagonal d of two ascending, disjoint lists,
// the least m with !(a[m] < c[d - m - 1]), found by one warp probing 32
// points of the range a round.  Every lane returns it.
__device__ long long co_rank(const int* a, long long na, const int* c,
                             long long nc, long long d) {
  const int lane = threadIdx.x & 31;
  long long lo = d > nc ? d - nc : 0, hi = d < na ? d : na;
  while (lo < hi) {
    const long long step = (hi - lo + 31) / 32;
    const long long m = lo + lane * step;
    const bool below = m < hi && __ldg(a + m) < __ldg(c + d - m - 1);
    // The probes below the answer are a prefix of the lanes.
    const int count = __popc(__ballot_sync(kFull, below));
    hi = min(hi, lo + count * step);
    lo = count ? lo + (count - 1) * step + 1 : lo;
  }
  return lo;
}

// Entries of the ascending s[0, len) below x.
__device__ int lower_bound(const int* s, int len, int x) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int m = (lo + hi) / 2;
    if (s[m] < x) lo = m + 1; else hi = m;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
merge_kernel(const Leaf* __restrict__ tab, int nl,
             const LeafState* __restrict__ state,
             const int* __restrict__ a_idx, const unsigned* __restrict__ a_val,
             const int* __restrict__ c_idx, const unsigned* __restrict__ c_val,
             int* __restrict__ out_idx, unsigned* __restrict__ out_val) {
  __shared__ int s_idx[kMergeTile];
  __shared__ unsigned s_val[kMergeTile];
  __shared__ long long split[2];
  const long long m = blockIdx.x;
  const int leaf = find_leaf(tab, nl, m, 1);
  const Leaf L = tab[leaf];
  const long long nc = state[leaf].need1, na = L.k - nc;
  const int* ai = a_idx + L.a_off;
  const int* ci = c_idx + L.a_off;
  const long long d0 = (m - L.merge0) * kMergeTile;
  const long long d1 = min(d0 + kMergeTile, L.k);
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const long long r = co_rank(ai, na, ci, nc, warp ? d1 : d0);
    if ((threadIdx.x & 31) == 0) split[warp] = r;
  }
  __syncthreads();
  const long long a0 = split[0], a1 = split[1];
  const long long c0 = d0 - a0, c1 = d1 - a1;
  const int la = static_cast<int>(a1 - a0), lc = static_cast<int>(c1 - c0);
  // The block's A segment, then its C segment, into shared memory (every
  // load in flight before any store).
  {
    int qi[kMergePer];
    unsigned qv[kMergePer];
#pragma unroll
    for (int j = 0; j < kMergePer; ++j) {
      const int q = threadIdx.x + kThreads * j;
      const bool from_a = q < la;
      const long long at = L.a_off + (from_a ? a0 + q : c0 + q - la);
      qi[j] = 0;
      qv[j] = 0;
      if (q < la + lc) {
        qi[j] = __ldg((from_a ? a_idx : c_idx) + at);
        qv[j] = __ldg((from_a ? a_val : c_val) + at);
      }
    }
#pragma unroll
    for (int j = 0; j < kMergePer; ++j) {
      const int q = threadIdx.x + kThreads * j;
      if (q < la + lc) {
        s_idx[q] = qi[j];
        s_val[q] = qv[j];
      }
    }
  }
  __syncthreads();
  for (int q = threadIdx.x; q < la + lc; q += kThreads) {
    const int x = s_idx[q];
    const int pos = q < la ? q + lower_bound(s_idx + la, lc, x)
                           : (q - la) + lower_bound(s_idx, la, x);
    out_idx[L.out + d0 + pos] = x;
    out_val[L.out + d0 + pos] = s_val[q];
  }
}

// Rows of the table passed by value, for a table first made inside a
// CUDA-graph capture (the graph keeps the parameters).
constexpr int kFillRows = 48;
struct FillChunk {
  long long rows[kFillRows * 8];
  int count;
};

__global__ void fill_kernel(long long* __restrict__ table, FillChunk chunk) {
  for (int i = threadIdx.x; i < chunk.count * 8; i += blockDim.x)
    table[i] = chunk.rows[i];
}

long long align256(long long b) { return (b + 255) / 256 * 256; }

// K4's shared memory above 48 KB, allowed once on each device (the
// attribute is set outside any stream, so a capture need not see it).
cudaError_t allow_choose_smem() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(choose_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kChooseSmem);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

// The scratch's layout: the zeroed part (states, two look-back status
// arrays, K4's ticket and the count of B tiles), then each B tile's leaf,
// A, C (each k entries a leaf, at a_off) and B.
struct Layout {
  long long states, status2, status4, tickets, zeroed, btile_leaf, a_idx,
      a_val, c_idx, c_val, b_idx, b_val, total;
};

Layout layout(long long nl, long long tiles, long long sum_n, long long sum_k) {
  Layout s;
  s.states = 0;
  s.status2 = align256(nl * static_cast<long long>(sizeof(LeafState)));
  s.status4 = s.status2 + align256(8 * tiles);
  s.tickets = s.status4 + align256(8 * tiles);
  s.zeroed = s.tickets + 256;
  s.btile_leaf = s.zeroed;
  s.a_idx = s.btile_leaf + align256(4 * tiles);
  s.a_val = s.a_idx + align256(4 * sum_k);
  s.c_idx = s.a_val + align256(4 * sum_k);
  s.c_val = s.c_idx + align256(4 * sum_k);
  s.b_idx = s.c_val + align256(4 * sum_k);
  s.b_val = s.b_idx + align256(4 * sum_n);
  s.total = s.b_val + align256(4 * sum_n);
  return s;
}

}  // namespace

extern "C" {

// The selector's constants: 0 the largest small leaf, 1 the tile, 2 the
// outputs per merge block.
long long topk_constant(int which) {
  return which == 0 ? kSmallMax : which == 1 ? kTile : kMergeTile;
}

// Scratch bytes of a call with nl large leaves of `tiles` tiles, sum_n
// entries of B and sum_k selections in all.
long long topk_scratch_bytes(long long nl, long long tiles, long long sum_n,
                             long long sum_k) {
  return layout(nl, tiles, sum_n, sum_k).total;
}

// Writes `nrows` rows of the table (host memory, int64) into `table` on
// the card by kernels that carry them as parameters, on `stream`; a copy
// from host memory would not be replayable from a CUDA graph.
int topk_fill_table(void* table, const long long* rows, int nrows,
                    void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto* out = static_cast<long long*>(table);
  for (int r = 0; r < nrows; r += kFillRows) {
    FillChunk chunk;
    chunk.count = nrows - r < kFillRows ? nrows - r : kFillRows;
    for (int i = 0; i < chunk.count * 8; ++i) chunk.rows[i] = rows[8LL * r + i];
    fill_kernel<<<1, 128, 0, st>>>(out + 8LL * r, chunk);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Select every leaf of the table (nl large leaves, then ns small ones; on
// the card, int64 rows as in struct Leaf) into out_idx (int32) and
// out_val (float32 bits) at each leaf's offset, on `stream`.  `tiles` and
// `merge_tiles` are the large leaves' tiles and merge blocks, sum_n the
// entries of B their offsets span and sum_k their selections.  Returns
// the first error (0 on success).
int topk_abs_many(const void* table, int nl, int ns, long long tiles,
                  long long merge_tiles, long long sum_n, long long sum_k,
                  void* out_idx, void* out_val, void* scratch, void* stream) {
  if (nl < 0 || ns < 0 || tiles < nl || merge_tiles < nl ||
      tiles + ns >= (1LL << 31) || merge_tiles >= (1LL << 31))
    return cudaErrorInvalidValue;
  if (nl + ns == 0) return cudaSuccess;
  auto st = static_cast<cudaStream_t>(stream);
  auto* tab = static_cast<const Leaf*>(table);
  const Layout s = layout(nl, tiles, sum_n, sum_k);
  char* base = static_cast<char*>(scratch);
  auto* state = reinterpret_cast<LeafState*>(base + s.states);
  auto* status2 = reinterpret_cast<unsigned long long*>(base + s.status2);
  auto* status4 = reinterpret_cast<unsigned long long*>(base + s.status4);
  auto* tickets = reinterpret_cast<unsigned*>(base + s.tickets);
  auto* btile_leaf = reinterpret_cast<int*>(base + s.btile_leaf);
  auto* a_idx = reinterpret_cast<int*>(base + s.a_idx);
  auto* a_val = reinterpret_cast<unsigned*>(base + s.a_val);
  auto* c_idx = reinterpret_cast<int*>(base + s.c_idx);
  auto* c_val = reinterpret_cast<unsigned*>(base + s.c_val);
  auto* b_idx = reinterpret_cast<int*>(base + s.b_idx);
  auto* b_val = reinterpret_cast<unsigned*>(base + s.b_val);
  auto* oi = static_cast<int*>(out_idx);
  auto* ov = static_cast<unsigned*>(out_val);
  cudaError_t err;
  if (nl > 0 && (err = cudaMemsetAsync(base, 0, s.zeroed, st)) != cudaSuccess)
    return err;
  hist_kernel<<<static_cast<unsigned>(ns + tiles), kThreads, 0, st>>>(
      tab, nl, ns, state, tickets + 1, btile_leaf, oi, ov);
  if ((err = cudaGetLastError()) != cudaSuccess || nl == 0) return err;
  collect_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(
      tab, nl, state, status2, a_idx, a_val, b_idx, b_val);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // B holds 1-2 % of a delta's leaf: K3 and K4 stride over its tiles with
  // at most kResolveBlocks blocks.
  const unsigned few = static_cast<unsigned>(
      tiles < kResolveBlocks ? tiles : kResolveBlocks);
  resolve_kernel<<<few, kThreads, 0, st>>>(state, tickets + 1, btile_leaf,
                                           tab, b_val);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = allow_choose_smem()) != cudaSuccess) return err;
  choose_kernel<<<few, kThreads, kChooseSmem, st>>>(
      state, tickets + 1, btile_leaf, tab, status4, tickets, b_idx, b_val,
      c_idx, c_val);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  merge_kernel<<<static_cast<unsigned>(merge_tiles), kThreads, 0, st>>>(
      tab, nl, state, a_idx, a_val, c_idx, c_val, oi, ov);
  return cudaGetLastError();
}

}  // extern "C"
