// B4: the server's ingest fold (C entry points loaded with ctypes by
// colearn_federated_learning_tpu_torch/ops/_build.py).
//
// Replaces the JAX package's ops/fold_kernel.py (FoldKernel.fold_sparse and
// fold_dense, an XLA lax.scan) and its C++ lowering native/src/fold.cpp.
//
// The accumulator is one flat float32 buffer holding every slot (a leaf of
// the model) at its offset (64-bit: slot_off[s] + i).  A sparse
// contribution is, per slot, a run of int32 indices into the slot (the
// wire's own, no slot reaches 2^31 entries) and int8 (topk8) or float32
// (topk) values with the slot's dequant scale; its runs are packed back to
// back from entry 0, and `begin` (nslots + 1 entries) gives where each run
// starts.
//
// Bitwise contract with the host fold: each value becomes
// (value * scale) * weight, two float32 roundings (__fmul_rn keeps nvcc from
// contracting the pair, or the add after it, into an FMA); the first
// contribution of a fold is ASSIGNED into fresh zeros, the others are
// added in cohort order, one launch per contribution (stream order keeps
// the order).  Within one contribution the indices are unique, so threads
// never collide and no atomics are needed; an entry the host did not write
// keeps its bits, so a -0.0 survives.  The dense fold adopts its first row
// (or reads the accumulator) and adds the rows in order, one launch per
// batch, each thread walking the rows of its own elements.
//
// What bounds it on an H100: bytes.  The sparse fold reads 5 (topk8) or 8
// (topk) bytes per entry and reads and writes the 32-byte sector its index
// lands in, since the indices scatter over a ~440 MB accumulator; the
// dense fold streams rows + 1 reads and one write per element, coalesced
// across each warp.  So the sparse kernel keeps many scattered
// read-modify-writes in flight and spends little else per entry.  The
// contribution is cut into tiles of kTile entries, one block per SM walks
// them, and each thread takes kU entries of a tile 32 apart (so every load
// instruction of a warp reads 32 consecutive indices and values), then
// loads all kU accumulator words before it stores any.  No entry searches
// for its slot: the host gives each tile the slots of its first and last
// entries (`tiles`), a thread finds its first entry's slot within that
// range (no step at all when the tile lies in one slot, as most do), then
// walks forward across run boundaries, empty runs included.  Tiles start
// at multiples of kTile of a contribution packed from entry 0, so only the
// last tile is ragged.
//
// The layout is measured (scripts/torch_port_fold_layouts.py, PERF.md):
// at BERT-base's layout the time follows how far the entries in flight
// spread over the accumulator.  One block of 128 threads x 8 entries per
// SM (135 K entries, ~11 MB of accumulator at 5 % density) beat full
// occupancy, and lanes 32 apart beat lanes taking 8 consecutive entries
// with 16-byte loads, which spread each warp's accesses 8 times wider.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;                // dense fold
constexpr long long kMaxBlocks = 132LL * 16;
constexpr int kSparseThreads = 128;          // sparse fold
constexpr int kU = 8;                        // entries per thread per tile
constexpr int kTile = kSparseThreads * kU;   // entries per tile

template <typename V, bool kSet>
__global__ void __launch_bounds__(kSparseThreads)
fold_sparse_kernel(float* __restrict__ acc, const int* __restrict__ idx,
                   const V* __restrict__ vals,
                   const long long* __restrict__ begin,
                   const float* __restrict__ scales,
                   const int* __restrict__ tiles,
                   const long long* __restrict__ slot_off,
                   const long long* __restrict__ slot_size, long long k,
                   int ntiles, float w) {
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    // Warp q takes the tile's entries [q * 32 * kU, (q + 1) * 32 * kU),
    // lane l those at l, l + 32, ...
    const long long base = static_cast<long long>(t) * kTile +
                           (threadIdx.x >> 5) * (32 * kU) +
                           (threadIdx.x & 31);
    if (base >= k) continue;
    // The slot of base: the largest s in [first, last] with begin[s] <=
    // base.
    int lo = __ldg(tiles + t), hi = __ldg(tiles + t + 1);
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (__ldg(begin + mid) <= base) lo = mid; else hi = mid - 1;
    }
    int s = lo;
    long long next = __ldg(begin + s + 1);
    long long off = __ldg(slot_off + s), size = __ldg(slot_size + s);
    float scale = __ldg(scales + s);

    int ix[kU];
    float raw[kU];
#pragma unroll
    for (int j = 0; j < kU; ++j) {
      const long long e = base + 32 * j;
      ix[j] = e < k ? __ldcs(idx + e) : -1;
      raw[j] = e < k ? static_cast<float>(__ldcs(vals + e)) : 0.0f;
    }
    float* p[kU];
    float v[kU];
#pragma unroll
    for (int j = 0; j < kU; ++j) {
      const long long e = base + 32 * j;
      p[j] = nullptr;
      if (e < k) {
        while (e >= next) {                // cross into the next run
          ++s;
          next = __ldg(begin + s + 1);
          off = __ldg(slot_off + s);
          size = __ldg(slot_size + s);
          scale = __ldg(scales + s);
        }
        // The wrapper checked every index; this guard only keeps a bad
        // call from writing outside the slot.
        if (ix[j] >= 0 && ix[j] < size) p[j] = acc + off + ix[j];
      }
      v[j] = __fmul_rn(__fmul_rn(raw[j], scale), w);
    }
    if (kSet) {
#pragma unroll
      for (int j = 0; j < kU; ++j)
        if (p[j]) *p[j] = v[j];
    } else {
      float old[kU];
#pragma unroll
      for (int j = 0; j < kU; ++j) old[j] = p[j] ? *p[j] : 0.0f;
#pragma unroll
      for (int j = 0; j < kU; ++j)
        if (p[j]) *p[j] = __fadd_rn(old[j], v[j]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
fold_dense_kernel(float* __restrict__ acc, const float* __restrict__ x,
                  long long n, int rows, int adopt) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       j < n; j += stride) {
    int r = 0;
    float a;
    if (adopt) { a = x[j]; r = 1; } else { a = acc[j]; }
    for (; r < rows; ++r) a = __fadd_rn(a, x[static_cast<long long>(r) * n + j]);
    acc[j] = a;
  }
}

unsigned blocks_for(long long items) {
  long long b = (items + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return static_cast<unsigned>(b);
}

template <typename V, bool kSet>
cudaError_t launch_sparse(float* acc, const int* idx, const void* vals,
                          const long long* begin, const float* scales,
                          const int* tiles, const long long* slot_off,
                          const long long* slot_size, long long k, float w,
                          cudaStream_t stream) {
  static int sms = 0;                        // one block per SM
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  const long long ntiles = (k + kTile - 1) / kTile;
  const unsigned grid = static_cast<unsigned>(
      ntiles < 1 ? 1 : (ntiles < sms ? ntiles : sms));
  fold_sparse_kernel<V, kSet><<<grid, kSparseThreads, 0, stream>>>(
      acc, idx, static_cast<const V*>(vals), begin, scales, tiles, slot_off,
      slot_size, k, static_cast<int>(ntiles), w);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One contribution of k entries packed from entry 0: int32 indices
// `idx` and values `vals` (vals_int8: 1 for int8, 0 for float32), whose
// runs start at begin[0..nslots] (int64, begin[0] == 0, begin[nslots] ==
// k), with per-slot dequant scales, and `tiles` (int32, one per tile of
// `tile` entries and one more): tiles[t] the slot of tile t's first entry,
// tiles[ntiles] that of entry k - 1.
// set: assign instead of add.  Launches once whatever k (an empty
// contribution runs no tile) and returns cudaGetLastError() after the
// launch (0 on success), or cudaErrorInvalidValue for a tile size that is
// not the kernel's.
int fold_sparse(void* acc, const void* idx, const void* vals, int vals_int8,
                const void* begin, const void* scales, const void* tiles,
                int tile, const void* slot_off, const void* slot_size,
                long long k, float w, int set, void* stream) {
  if (tile != kTile || k < 0) return cudaErrorInvalidValue;
  auto* a = static_cast<float*>(acc);
  auto* i = static_cast<const int*>(idx);
  auto* b = static_cast<const long long*>(begin);
  auto* s = static_cast<const float*>(scales);
  auto* t = static_cast<const int*>(tiles);
  auto* off = static_cast<const long long*>(slot_off);
  auto* size = static_cast<const long long*>(slot_size);
  auto st = static_cast<cudaStream_t>(stream);
  if (vals_int8)
    return set ? launch_sparse<signed char, true>(a, i, vals, b, s, t, off,
                                                  size, k, w, st)
               : launch_sparse<signed char, false>(a, i, vals, b, s, t, off,
                                                   size, k, w, st);
  return set ? launch_sparse<float, true>(a, i, vals, b, s, t, off, size, k,
                                          w, st)
             : launch_sparse<float, false>(a, i, vals, b, s, t, off, size, k,
                                           w, st);
}

// `rows` dense contributions x (rows, n) row-major, added in row order into
// acc (n); adopt: start from row 0 instead of acc's values.
int fold_dense(void* acc, const void* x, long long n, int rows, int adopt,
               void* stream) {
  if (n <= 0 || rows <= 0) return 0;
  fold_dense_kernel<<<blocks_for(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(acc), static_cast<const float*>(x), n, rows,
      adopt);
  return cudaGetLastError();
}

}  // extern "C"
