// Variants of the sparse fold kernel (colearn_federated_learning_tpu_torch/
// csrc/fold.cu) for scripts/torch_port_fold_layouts.py, which times them
// against each other on the card.  They compute the same function as the
// package's kernel, bit for bit, and differ only in how work is laid out:
// kThr threads a block, kU entries a thread, lanes taking kVec consecutive
// entries (kVec 8: 16-byte index loads and 8-byte int8 / 16-byte float
// value loads; kVec 1: lanes 32 apart, each load instruction of a warp
// reading 32 consecutive entries), and the number of blocks.  Nothing in
// the package loads this file.

#include <cuda_runtime.h>

namespace {

template <typename V, int kVec> struct Group;
template <typename V> struct Group<V, 1> {
  static __device__ __forceinline__ void load(const int* i, const V* v,
                                              int* ix, float* raw) {
    ix[0] = __ldcs(i);
    raw[0] = static_cast<float>(__ldcs(v));
  }
};
template <> struct Group<signed char, 8> {
  static __device__ __forceinline__ void load(const int* i,
                                              const signed char* v, int* ix,
                                              float* raw) {
    const int4 a = __ldcs(reinterpret_cast<const int4*>(i));
    const int4 b = __ldcs(reinterpret_cast<const int4*>(i) + 1);
    const int2 c = __ldcs(reinterpret_cast<const int2*>(v));
    ix[0] = a.x; ix[1] = a.y; ix[2] = a.z; ix[3] = a.w;
    ix[4] = b.x; ix[5] = b.y; ix[6] = b.z; ix[7] = b.w;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      raw[j] = static_cast<float>(static_cast<signed char>(
          (j < 4 ? c.x : c.y) >> (8 * (j & 3))));
  }
};
template <> struct Group<float, 8> {
  static __device__ __forceinline__ void load(const int* i, const float* v,
                                              int* ix, float* raw) {
    const int4 a = __ldcs(reinterpret_cast<const int4*>(i));
    const int4 b = __ldcs(reinterpret_cast<const int4*>(i) + 1);
    const float4 c = __ldcs(reinterpret_cast<const float4*>(v));
    const float4 d = __ldcs(reinterpret_cast<const float4*>(v) + 1);
    ix[0] = a.x; ix[1] = a.y; ix[2] = a.z; ix[3] = a.w;
    ix[4] = b.x; ix[5] = b.y; ix[6] = b.z; ix[7] = b.w;
    raw[0] = c.x; raw[1] = c.y; raw[2] = c.z; raw[3] = c.w;
    raw[4] = d.x; raw[5] = d.y; raw[6] = d.z; raw[7] = d.w;
  }
};

template <typename V, bool kSet, int kThr, int kU, int kVec>
__global__ void __launch_bounds__(kThr)
fold_sparse_layout_kernel(float* __restrict__ acc, const int* __restrict__ idx,
                          const V* __restrict__ vals,
                          const long long* __restrict__ begin,
                          const float* __restrict__ scales,
                          const int* __restrict__ tiles,
                          const long long* __restrict__ slot_off,
                          const long long* __restrict__ slot_size,
                          long long k, int ntiles, float w) {
  constexpr int kTile = kThr * kU;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    // Lane l takes kU / kVec groups of kVec consecutive entries, group g
    // at g * 32 * kVec + l * kVec within its warp's 32 * kU entries.
    const long long base = static_cast<long long>(t) * kTile +
                           (threadIdx.x >> 5) * (32 * kU) +
                           (threadIdx.x & 31) * kVec;
    if (base >= k) continue;
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
    for (int g = 0; g < kU / kVec; ++g) {
      const long long e = base + g * 32 * kVec;
      if (e + kVec <= k) {
        Group<V, kVec>::load(idx + e, vals + e, ix + g * kVec,
                             raw + g * kVec);
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          ix[g * kVec + j] = e + j < k ? __ldcs(idx + e + j) : -1;
          raw[g * kVec + j] =
              e + j < k ? static_cast<float>(__ldcs(vals + e + j)) : 0.0f;
        }
      }
    }
    float* p[kU];
    float v[kU];
#pragma unroll
    for (int j = 0; j < kU; ++j) {
      const long long e = base + (j / kVec) * 32 * kVec + j % kVec;
      p[j] = nullptr;
      if (e < k) {
        while (e >= next) {
          ++s;
          next = __ldg(begin + s + 1);
          off = __ldg(slot_off + s);
          size = __ldg(slot_size + s);
          scale = __ldg(scales + s);
        }
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

template <typename V, bool kSet, int kThr, int kU, int kVec>
int launch(float* acc, const int* idx, const void* vals, const long long* b,
           const float* s, const int* t, const long long* off,
           const long long* size, long long k, float w, int blocks,
           cudaStream_t st) {
  auto kernel = fold_sparse_layout_kernel<V, kSet, kThr, kU, kVec>;
  if (blocks <= 0) {                 // every block the SMs hold at once
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThr, 0);
    blocks = sms * per_sm;
  }
  const long long ntiles = (k + kThr * kU - 1) / (kThr * kU);
  const unsigned grid = static_cast<unsigned>(
      ntiles < 1 ? 1 : (ntiles < blocks ? ntiles : blocks));
  kernel<<<grid, kThr, 0, st>>>(acc, idx, static_cast<const V*>(vals), b, s,
                                t, off, size, k, static_cast<int>(ntiles), w);
  return cudaGetLastError();
}

template <int kThr, int kU, int kVec>
int dispatch(float* a, const int* i, const void* v, int i8,
             const long long* b, const float* s, const int* t,
             const long long* off, const long long* size, long long k,
             float w, int set, int blocks, cudaStream_t st) {
  if (i8)
    return set ? launch<signed char, true, kThr, kU, kVec>(
                     a, i, v, b, s, t, off, size, k, w, blocks, st)
               : launch<signed char, false, kThr, kU, kVec>(
                     a, i, v, b, s, t, off, size, k, w, blocks, st);
  return set ? launch<float, true, kThr, kU, kVec>(a, i, v, b, s, t, off,
                                                   size, k, w, blocks, st)
             : launch<float, false, kThr, kU, kVec>(a, i, v, b, s, t, off,
                                                    size, k, w, blocks, st);
}

}  // namespace

extern "C" {

// As csrc/fold.cu's fold_sparse, with the layout (threads, entries a
// thread, consecutive entries a lane, blocks; 0 blocks: full occupancy)
// chosen at run time among the compiled ones; cudaErrorInvalidValue for
// another.
int fold_sparse_layout(void* acc, const void* idx, const void* vals,
                       int vals_int8, const void* begin, const void* scales,
                       const void* tiles, const void* slot_off,
                       const void* slot_size, long long k, float w, int set,
                       void* stream, int thr, int u, int vec, int blocks) {
  auto* a = static_cast<float*>(acc);
  auto* i = static_cast<const int*>(idx);
  auto* b = static_cast<const long long*>(begin);
  auto* s = static_cast<const float*>(scales);
  auto* t = static_cast<const int*>(tiles);
  auto* off = static_cast<const long long*>(slot_off);
  auto* size = static_cast<const long long*>(slot_size);
  auto st = static_cast<cudaStream_t>(stream);
#define LAYOUT(T, U, V)                                                   \
  if (thr == T && u == U && vec == V)                                     \
    return dispatch<T, U, V>(a, i, vals, vals_int8, b, s, t, off, size, k, \
                             w, set, blocks, st);
  LAYOUT(256, 8, 8) LAYOUT(256, 8, 1) LAYOUT(256, 4, 1) LAYOUT(128, 8, 1)
#undef LAYOUT
  return cudaErrorInvalidValue;
}

}  // extern "C"
