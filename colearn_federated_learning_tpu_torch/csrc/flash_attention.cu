// C entry points of the flash-attention kernels (K1-K3), loaded with
// ctypes by colearn_federated_learning_tpu_torch/ops/_build.py.
//
// Each entry launches one kernel on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() (0 on success) so a
// refused launch (too much shared memory, a bad grid) reaches the wrapper.
// Operands are bfloat16; head dims 16, 32, 64 and 128.

#include <cuda_runtime.h>

#include <atomic>

#include "flash_attention_kernels.cuh"

namespace fa {
namespace {

enum Kind { kFwd = 0, kDq = 1, kDkv = 2 };

using KernelFn = void (*)(Params);

// Devices (one bit each) on which a kernel's shared-memory limit is set.
// Internal linkage: a function-local static of a template would be one
// process-wide object shared with any other build of these sources loaded
// beside this one.
template <KernelFn kernel>
std::atomic<unsigned long long> ready{0};

// Lift the kernel's dynamic shared-memory limit to `smem` on the current
// device.  cudaFuncSetAttribute costs about as much as a kernel's own time
// here, so it runs once per kernel and device; an error still
// reaches the caller, and the next launch tries again.
template <KernelFn kernel, int smem>
cudaError_t prepare() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (ready<kernel>.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err == cudaSuccess)
    ready<kernel>.fetch_or(bit, std::memory_order_release);
  return err;
}

template <KernelFn kernel, int smem>
cudaError_t launch_kernel(dim3 grid, const Params& p, cudaStream_t stream) {
  const cudaError_t err = prepare<kernel, smem>();
  if (err != cudaSuccess) return err;
  kernel<<<grid, kMmaThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <KernelFn kernel, int smem>
cudaError_t occupancy(int* blocks) {
  const cudaError_t err = prepare<kernel, smem>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                       kMmaThreads, smem);
}

template <int D>
cudaError_t launch(Kind kind, const Params& p, cudaStream_t stream) {
  static_assert(kRows == kTile, "a block's rows are one tile of the stream");
  const int lrows = kind == kDkv ? p.Lk : p.Lq;
  const dim3 grid((lrows + kRows - 1) / kRows, p.B * p.H);
  if (kind == kFwd)
    return launch_kernel<flash_fwd_bf16_kernel<D>, fwd_bf16_smem<D>()>(
        grid, p, stream);
  if (kind == kDq)
    return launch_kernel<flash_dq_bf16_kernel<D>, dq_bf16_smem<D>()>(
        grid, p, stream);
  return launch_kernel<flash_dkv_bf16_kernel<D>, dkv_bf16_smem<D>()>(
      grid, p, stream);
}

template <int D>
cudaError_t blocks_per_sm(Kind kind, int* blocks) {
  if (kind == kFwd)
    return occupancy<flash_fwd_bf16_kernel<D>, fwd_bf16_smem<D>()>(blocks);
  if (kind == kDq)
    return occupancy<flash_dq_bf16_kernel<D>, dq_bf16_smem<D>()>(blocks);
  return occupancy<flash_dkv_bf16_kernel<D>, dkv_bf16_smem<D>()>(blocks);
}

}  // namespace

int run(Kind kind, int D, const Params& p, void* stream) {
  if (p.B <= 0 || p.H <= 0 || p.Lq <= 0 || p.Lk <= 0 || p.B * p.H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 16: err = launch<16>(kind, p, s); break;
    case 32: err = launch<32>(kind, p, s); break;
    case 64: err = launch<64>(kind, p, s); break;
    case 128: err = launch<128>(kind, p, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

Params make_params(const void* q, const void* k, const void* v,
                   const float* bias, int B, int Lq, int Lk, int H,
                   float scale, int causal) {
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.bias = bias;
  p.B = B;
  p.Lq = Lq;
  p.Lk = Lk;
  p.H = H;
  p.scale = scale;
  p.causal = causal;
  return p;
}

}  // namespace fa

extern "C" {

// K1: o (B, Lq, H, D) and lse (B, Lq, H) from q, k, v and the key bias.
int fa_forward(const void* q, const void* k, const void* v, const float* bias,
               void* o, float* lse, int B, int Lq, int Lk, int H, int D,
               float scale, int causal, void* stream) {
  fa::Params p = fa::make_params(q, k, v, bias, B, Lq, Lk, H, scale, causal);
  p.o = o;
  p.lse_out = lse;
  return fa::run(fa::kFwd, D, p, stream);
}

// K2: dq (B, Lq, H, D).
int fa_backward_dq(const void* q, const void* k, const void* v,
                   const float* bias, const void* dout, const float* lse,
                   const float* delta, void* dq, int B, int Lq, int Lk, int H,
                   int D, float scale, int causal, void* stream) {
  fa::Params p = fa::make_params(q, k, v, bias, B, Lq, Lk, H, scale, causal);
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.o = dq;
  return fa::run(fa::kDq, D, p, stream);
}

// K3: dk and dv (B, Lk, H, D).
int fa_backward_dkv(const void* q, const void* k, const void* v,
                    const float* bias, const void* dout, const float* lse,
                    const float* delta, void* dk, void* dv, int B, int Lq,
                    int Lk, int H, int D, float scale, int causal,
                    void* stream) {
  fa::Params p = fa::make_params(q, k, v, bias, B, Lq, Lk, H, scale, causal);
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.o = dk;
  p.o2 = dv;
  return fa::run(fa::kDkv, D, p, stream);
}

// Blocks of kernel `kind` (0 K1, 1 K2, 2 K3) that fit on one SM at head
// dim D, by the occupancy calculator of the current device.
int fa_blocks_per_sm(int kind, int D, int* blocks) {
  switch (D) {
    case 16: return fa::blocks_per_sm<16>(static_cast<fa::Kind>(kind), blocks);
    case 32: return fa::blocks_per_sm<32>(static_cast<fa::Kind>(kind), blocks);
    case 64: return fa::blocks_per_sm<64>(static_cast<fa::Kind>(kind), blocks);
    case 128: return fa::blocks_per_sm<128>(static_cast<fa::Kind>(kind), blocks);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
