// N2: the row gather that packs the engine's client shards on the card (C
// entry points loaded with ctypes by colearn_federated_learning_tpu_torch/
// ops/_build.py; the wrapper is ops/gather.py).
//
// Replaces the JAX package's native/src/gather.cpp (cl_gather_rows, a
// thread-parallel host memcpy of byte rows, called by data/sharding.py's
// pack_client_shards): dst[i] = src[idx[i]] for rows of row_bytes bytes,
// with every index checked before anything is written.
//
// Design: check_kernel sets a flag in device memory if any index lies
// outside [0, n_src); copy_kernel reads the flag first and writes nothing
// when it is set, so a bad index leaves dst untouched, as gather.cpp's
// check up front does.  The wrapper reads the flag after the launch and
// raises.  The copy moves words of W bytes (16, 8, 4 or 1: the largest
// that divides the row and both base addresses), one word per thread and
// neighbouring threads on neighbouring words of a row, so each warp's
// loads and stores are coalesced within a row.
//
// What bounds it on an H100: bytes, each output row read once from src and
// written once, plus the 8-byte indices.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 16;

__global__ void __launch_bounds__(kThreads)
check_kernel(const long long* __restrict__ idx, long long n_out,
             long long n_src, int* __restrict__ bad) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n_out; i += stride) {
    const long long r = __ldg(idx + i);
    if (r < 0 || r >= n_src) atomicOr(bad, 1);
  }
}

template <typename W>
__global__ void __launch_bounds__(kThreads)
copy_kernel(const W* __restrict__ src, const long long* __restrict__ idx,
            long long n_out, long long row_words, W* __restrict__ dst,
            const int* __restrict__ bad) {
  if (*bad) return;
  const long long total = n_out * row_words;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long w = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       w < total; w += stride) {
    const long long row = w / row_words;
    const long long col = w - row * row_words;
    dst[w] = __ldg(src + __ldg(idx + row) * row_words + col);
  }
}

template <typename W>
int launch_copy(const void* src, const long long* idx, long long n_out,
                long long row_bytes, void* dst, const int* bad,
                cudaStream_t st) {
  const long long row_words = row_bytes / static_cast<long long>(sizeof(W));
  const long long total = n_out * row_words;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  copy_kernel<W><<<static_cast<int>(blocks), kThreads, 0, st>>>(
      static_cast<const W*>(src), idx, n_out, row_words, static_cast<W*>(dst),
      bad);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dst (n_out rows) = src (n_src rows of row_bytes) at idx (n_out int64),
// on `stream`; `bad` is one int32 of device scratch, set to 1 (and dst
// left untouched) when an index is out of range.  Launches two kernels
// (none for an empty gather) and returns the first launch error, 0 on
// success.
int gather_rows(const void* src, long long n_src, long long row_bytes,
                const void* idx, long long n_out, void* dst, void* bad,
                void* stream) {
  if (n_src < 0 || row_bytes < 0 || n_out < 0) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto* flag = static_cast<int*>(bad);
  cudaError_t err = cudaMemsetAsync(flag, 0, sizeof(int), st);
  if (err != cudaSuccess || n_out == 0 || row_bytes == 0) return err;
  auto* ix = static_cast<const long long*>(idx);
  long long cb = (n_out + kThreads - 1) / kThreads;
  if (cb > kMaxBlocks) cb = kMaxBlocks;
  check_kernel<<<static_cast<int>(cb), kThreads, 0, st>>>(ix, n_out, n_src,
                                                          flag);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const unsigned long long a =
      reinterpret_cast<unsigned long long>(src) |
      reinterpret_cast<unsigned long long>(dst) |
      static_cast<unsigned long long>(row_bytes);
  if (a % 16 == 0) return launch_copy<uint4>(src, ix, n_out, row_bytes, dst,
                                             flag, st);
  if (a % 8 == 0) return launch_copy<unsigned long long>(src, ix, n_out,
                                                         row_bytes, dst, flag,
                                                         st);
  if (a % 4 == 0) return launch_copy<unsigned>(src, ix, n_out, row_bytes,
                                               dst, flag, st);
  return launch_copy<unsigned char>(src, ix, n_out, row_bytes, dst, flag, st);
}

}  // extern "C"
