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
// values src[idx] bit for bit.
//
// Design: a radix select over the 31 magnitude bits in three digit passes
// (11, 10 and 10 bits), then one stable compaction in index order.
//   1. hist_kernel counts the digit of every entry whose higher digits
//      equal the prefix found so far (all entries in the first pass) into
//      a global histogram (shared-memory bins, warp-aggregated with
//      __match_any_sync, since a delta's magnitudes crowd into a few
//      exponent bins and an all-zero leaf into one).
//   2. pick_kernel (one block) walks the histogram from the top, finds the
//      bin where the count above reaches k, and appends it to the prefix
//      in device memory with the remaining count.  No host sync: the next
//      pass reads the prefix there.  After three passes the prefix is the
//      exact threshold key T and the remaining count `need` is how many
//      entries equal to T are kept (one bin may hold everything: an
//      all-zero or constant leaf, or k = n; the later passes resolve it).
//   3. count_kernel counts, per tile of kTile entries, the entries above T
//      and those equal to T; scan_kernel (one block) turns the counts into
//      each tile's offsets; emit_kernel re-reads each tile in index order
//      and writes entry i, if key > T or it is among the first `need`
//      entries equal to T, at the number of selected entries before it.
//      So the indices come out ascending with no sort, and ties go to the
//      lower index.
//
// What bounds it on an H100: bytes.  The least work reads the leaf once
// (n * 4 bytes) and writes k * 8; this design reads it five times (three
// histogram passes, the count and the emit), all coalesced, plus ten
// launches per selection, which dominate the small leaves.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kMagMask = 0x7FFFFFFFu;
constexpr int kHistThreads = 512;
constexpr int kMaxBins = 2048;               // the first digit: 11 bits
constexpr int kPickThreads = 1024;
constexpr int kTileThreads = 256;
constexpr int kPerThread = 16;
constexpr int kTile = kTileThreads * kPerThread;   // entries per tile
constexpr int kMaxHistBlocks = 132 * 4;

// Digit passes: bits [shift, shift + bits) of the 31-bit magnitude key.
constexpr int kPasses = 3;
constexpr int kShift[kPasses] = {20, 10, 0};
constexpr int kBits[kPasses] = {11, 10, 10};

// The selection's state in device memory: the key prefix found so far and
// how many entries are still to be taken at or below it.
struct State {
  unsigned prefix;
  int remaining;
};

// One block: the state starts at (0, k) and every pass's histogram at 0.
__global__ void init_kernel(State* __restrict__ state,
                            unsigned* __restrict__ hist, int k) {
  for (int b = threadIdx.x; b < kMaxBins * kPasses; b += blockDim.x)
    hist[b] = 0;
  if (threadIdx.x == 0) {
    state->prefix = 0;
    state->remaining = k;
  }
}

__device__ __forceinline__ unsigned key_of(const unsigned* bits, long long i) {
  return __ldg(bits + i) & kMagMask;
}

__global__ void __launch_bounds__(kHistThreads)
hist_kernel(const unsigned* __restrict__ bits, long long n,
            const State* __restrict__ state, unsigned* __restrict__ hist,
            int shift, int nbits) {
  __shared__ unsigned bins[kMaxBins];
  const int nbins = 1 << nbits;
  for (int b = threadIdx.x; b < nbins; b += blockDim.x) bins[b] = 0;
  __syncthreads();
  const int hi = shift + nbits;
  const unsigned prefix = state->prefix;
  const unsigned lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  // Whole warps run every iteration (the loop bound is the warp's, not
  // the thread's), so the ballot below names all 32 lanes.
  const long long base = static_cast<long long>(blockIdx.x) * blockDim.x;
  for (long long w = base; w < n; w += stride) {
    const long long i = w + threadIdx.x;
    bool take = false;
    unsigned digit = 0;
    if (i < n) {
      const unsigned key = key_of(bits, i);
      take = hi >= 31 || (key >> hi) == prefix;
      digit = (key >> shift) & (nbins - 1);
    }
    const unsigned active = __ballot_sync(0xFFFFFFFFu, take);
    if (take) {
      const unsigned same = __match_any_sync(active, digit);
      if (lane == static_cast<unsigned>(__ffs(same) - 1))
        atomicAdd(bins + digit, static_cast<unsigned>(__popc(same)));
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < nbins; b += blockDim.x)
    if (bins[b]) atomicAdd(hist + b, bins[b]);
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
    const T y = __shfl_up_sync(0xFFFFFFFFu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    T s = lane < nwarps ? warp_sums[lane] : T(0);
    for (int o = 1; o < 32; o <<= 1) {
      const T y = __shfl_up_sync(0xFFFFFFFFu, s, o);
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

// One block of kPickThreads: bins in descending order, kMaxBins /
// kPickThreads consecutive ones per thread.
__global__ void __launch_bounds__(kPickThreads)
pick_kernel(const unsigned* __restrict__ hist, State* __restrict__ state,
            int nbits) {
  constexpr int kPer = kMaxBins / kPickThreads;
  const int nbins = 1 << nbits;
  unsigned c[kPer];
  unsigned mine = 0;
  for (int j = 0; j < kPer; ++j) {
    const int pos = threadIdx.x * kPer + j;          // descending position
    c[j] = pos < nbins ? hist[nbins - 1 - pos] : 0u;
    mine += c[j];
  }
  unsigned total;
  unsigned above = block_exclusive_scan<unsigned>(mine, &total);
  const unsigned want = static_cast<unsigned>(state->remaining);
  const unsigned prefix = state->prefix;
  __syncthreads();            // every thread has read the state
  for (int j = 0; j < kPer; ++j) {
    const int pos = threadIdx.x * kPer + j;
    if (pos < nbins && above < want && above + c[j] >= want) {
      state->prefix = (prefix << nbits) | static_cast<unsigned>(nbins - 1 - pos);
      state->remaining = static_cast<int>(want - above);
    }
    above += c[j];
  }
}

// Per tile: the count above T (high word) and equal to T (low word).
__global__ void __launch_bounds__(kTileThreads)
count_kernel(const unsigned* __restrict__ bits, long long n,
             const State* __restrict__ state,
             unsigned long long* __restrict__ tile_counts) {
  const unsigned t = state->prefix;
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  unsigned long long mine = 0;
  for (int j = 0; j < kPerThread; ++j) {
    const long long i = base + j * kTileThreads + threadIdx.x;
    if (i < n) {
      const unsigned key = key_of(bits, i);
      mine += key > t ? (1ULL << 32) : (key == t ? 1ULL : 0ULL);
    }
  }
  unsigned long long total;
  block_exclusive_scan<unsigned long long>(mine, &total);
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = total;
}

// One block of kPickThreads: tile_counts -> each tile's exclusive offsets,
// in place.  Sums stay below 2^32 in each word (n < 2^31).
__global__ void __launch_bounds__(kPickThreads)
scan_kernel(unsigned long long* __restrict__ tile_counts, int ntiles) {
  const int per = (ntiles + blockDim.x - 1) / blockDim.x;
  const int lo = threadIdx.x * per;
  const int hi = min(lo + per, ntiles);
  unsigned long long mine = 0;
  for (int b = lo; b < hi; ++b) mine += tile_counts[b];
  unsigned long long total;
  unsigned long long run = block_exclusive_scan<unsigned long long>(mine,
                                                                    &total);
  for (int b = lo; b < hi; ++b) {
    const unsigned long long c = tile_counts[b];
    tile_counts[b] = run;
    run += c;
  }
}

__global__ void __launch_bounds__(kTileThreads)
emit_kernel(const unsigned* __restrict__ bits, long long n,
            const State* __restrict__ state,
            const unsigned long long* __restrict__ tile_offsets,
            int* __restrict__ out_idx, unsigned* __restrict__ out_val) {
  const unsigned t = state->prefix;
  const unsigned need = static_cast<unsigned>(state->remaining);
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  unsigned long long run = tile_offsets[blockIdx.x];
  for (int j = 0; j < kPerThread; ++j) {
    const long long i = base + j * kTileThreads + threadIdx.x;
    unsigned word = 0, key = 0;
    unsigned long long flag = 0;
    if (i < n) {
      word = __ldg(bits + i);
      key = word & kMagMask;
      flag = key > t ? (1ULL << 32) : (key == t ? 1ULL : 0ULL);
    }
    unsigned long long total;
    const unsigned long long before =
        run + block_exclusive_scan<unsigned long long>(flag, &total);
    const unsigned above = static_cast<unsigned>(before >> 32);
    const unsigned equal = static_cast<unsigned>(before & 0xFFFFFFFFull);
    if (i < n && (key > t || (key == t && equal < need))) {
      const unsigned pos = above + min(equal, need);
      out_idx[pos] = static_cast<int>(i);
      out_val[pos] = word;
    }
    run += total;
  }
}

}  // namespace

extern "C" {

// Scratch bytes one selection needs for a leaf of n entries (the wrapper
// allocates them, 16-byte aligned).
long long topk_scratch_bytes(long long n) {
  const long long ntiles = (n + kTile - 1) / kTile;
  return 16 + 4LL * kMaxBins * kPasses + 8 * ntiles;
}

// The k largest-magnitude entries of src (n float32) into out_idx (k
// int32, ascending) and out_val (k float32, src's bits), on `stream`.
// Launches ten kernels and returns the first launch error (0 on
// success), or cudaErrorInvalidValue for k outside [1, n] or n >= 2^31.
int topk_abs(const void* src, long long n, long long k, void* out_idx,
             void* out_val, void* scratch, void* stream) {
  if (n <= 0 || n >= (1LL << 31) || k <= 0 || k > n)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto* bits = static_cast<const unsigned*>(src);
  auto* state = static_cast<State*>(scratch);
  auto* hist = reinterpret_cast<unsigned*>(static_cast<char*>(scratch) + 16);
  auto* tiles = reinterpret_cast<unsigned long long*>(
      static_cast<char*>(scratch) + 16 + 4LL * kMaxBins * kPasses);
  const long long ntiles = (n + kTile - 1) / kTile;
  if (ntiles > (1LL << 30)) return cudaErrorInvalidValue;
  init_kernel<<<1, kPickThreads, 0, st>>>(state, hist, static_cast<int>(k));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  long long hb = (n + kHistThreads - 1) / kHistThreads;
  const int hist_blocks = static_cast<int>(hb < kMaxHistBlocks ? hb
                                                               : kMaxHistBlocks);
  for (int p = 0; p < kPasses; ++p) {
    hist_kernel<<<hist_blocks, kHistThreads, 0, st>>>(
        bits, n, state, hist + p * kMaxBins, kShift[p], kBits[p]);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    pick_kernel<<<1, kPickThreads, 0, st>>>(hist + p * kMaxBins, state,
                                            kBits[p]);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const int nt = static_cast<int>(ntiles);
  count_kernel<<<nt, kTileThreads, 0, st>>>(bits, n, state, tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  scan_kernel<<<1, kPickThreads, 0, st>>>(tiles, nt);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  emit_kernel<<<nt, kTileThreads, 0, st>>>(
      bits, n, state, tiles, static_cast<int*>(out_idx),
      static_cast<unsigned*>(out_val));
  return cudaGetLastError();
}

}  // extern "C"
