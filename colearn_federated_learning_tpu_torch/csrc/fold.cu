// B4: the server's ingest fold (C entry points loaded with ctypes by
// colearn_federated_learning_tpu_torch/ops/_build.py).
//
// Replaces the JAX package's ops/fold_kernel.py (FoldKernel.fold_sparse and
// fold_dense, an XLA lax.scan) and its C++ lowering native/src/fold.cpp.
//
// The accumulator is one flat float32 buffer holding every slot (a leaf of
// the model) at its offset.  A sparse contribution is, per slot, a run of
// int64 indices into the slot and int8 (topk8) or float32 (topk) values
// with the slot's dequant scale; the contribution's runs are packed back
// to back, and `begin` (nslots + 1 entries) gives where each run starts.
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
// What bounds it on an H100: bytes.  The sparse fold reads 9 (topk8) or 12
// (topk) bytes per entry and reads and writes the 32-byte sector its index
// lands in, since the indices scatter over a ~440 MB accumulator; the
// dense fold streams rows + 1 reads and one write per element, coalesced
// across each warp.  Each sparse entry finds its slot by a binary search
// over `begin`, a table of a few hundred entries that stays in L1.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 16;

// Largest s in [0, nslots) with begin[s] <= e, for begin[0] <= e <
// begin[nslots]; empty runs (begin[s] == begin[s + 1]) are skipped over.
__device__ __forceinline__ int slot_of(const long long* __restrict__ begin,
                                       int nslots, long long e) {
  int lo = 0, hi = nslots;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(begin + mid) <= e) lo = mid; else hi = mid;
  }
  return lo;
}

template <typename V, bool kSet>
__global__ void __launch_bounds__(kThreads)
fold_sparse_kernel(float* __restrict__ acc, const long long* __restrict__ idx,
                   const V* __restrict__ vals,
                   const long long* __restrict__ begin,
                   const float* __restrict__ scales,
                   const long long* __restrict__ slot_off,
                   const long long* __restrict__ slot_size, int nslots,
                   long long lo, long long hi, float w) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = lo + static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       e < hi; e += stride) {
    const int s = slot_of(begin, nslots, e);
    const long long i = __ldg(idx + e);
    // The wrapper checked every index; this guard only keeps a bad call
    // from writing outside the slot.
    if (i < 0 || i >= __ldg(slot_size + s)) continue;
    const float v = __fmul_rn(
        __fmul_rn(static_cast<float>(vals[e]), __ldg(scales + s)), w);
    float* p = acc + __ldg(slot_off + s) + i;
    if (kSet) *p = v; else *p = __fadd_rn(*p, v);
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

template <typename V>
cudaError_t launch_sparse(float* acc, const long long* idx, const void* vals,
                          const long long* begin, const float* scales,
                          const long long* slot_off,
                          const long long* slot_size, int nslots,
                          long long lo, long long hi, float w, int set,
                          cudaStream_t stream) {
  const unsigned grid = blocks_for(hi - lo);
  const V* v = static_cast<const V*>(vals);
  if (set)
    fold_sparse_kernel<V, true><<<grid, kThreads, 0, stream>>>(
        acc, idx, v, begin, scales, slot_off, slot_size, nslots, lo, hi, w);
  else
    fold_sparse_kernel<V, false><<<grid, kThreads, 0, stream>>>(
        acc, idx, v, begin, scales, slot_off, slot_size, nslots, lo, hi, w);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One contribution: entries [lo, hi) of the packed idx/vals buffers, whose
// runs start at begin[0..nslots] (absolute positions, begin[0] == lo and
// begin[nslots] == hi), with per-slot dequant scales.  vals_int8: 1 for
// int8 values, 0 for float32.  set: assign instead of add.  Returns
// cudaGetLastError() after the launch (0 on success).
int fold_sparse(void* acc, const void* idx, const void* vals, int vals_int8,
                const void* begin, const void* scales, const void* slot_off,
                const void* slot_size, int nslots, long long lo, long long hi,
                float w, int set, void* stream) {
  if (hi <= lo) return 0;
  auto* a = static_cast<float*>(acc);
  auto* i = static_cast<const long long*>(idx);
  auto* b = static_cast<const long long*>(begin);
  auto* s = static_cast<const float*>(scales);
  auto* off = static_cast<const long long*>(slot_off);
  auto* size = static_cast<const long long*>(slot_size);
  auto st = static_cast<cudaStream_t>(stream);
  if (vals_int8)
    return launch_sparse<signed char>(a, i, vals, b, s, off, size, nslots, lo,
                                      hi, w, set, st);
  return launch_sparse<float>(a, i, vals, b, s, off, size, nslots, lo, hi, w,
                              set, st);
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
