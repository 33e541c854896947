// C entry points of the flash-attention kernels (K1-K3), loaded with
// ctypes by colearn_federated_learning_tpu_torch/ops/_build.py.
//
// Each entry launches one kernel on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() (0 on success) so a
// refused launch (too much shared memory, a bad grid) reaches the wrapper.
// Operands are bfloat16; head dims 16, 32, 64 and 128.

#include <cuda_runtime.h>

#include "flash_attention_kernels.cuh"

namespace fa {

enum Kind { kFwd = 0, kDq = 1, kDkv = 2 };

template <typename Kernel>
cudaError_t launch_kernel(Kernel kernel, int smem, dim3 grid, int threads,
                          const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(Kind kind, const Params& p, cudaStream_t stream) {
  static_assert(kRows == kTile, "K3 loads its key rows as one tile");
  const int lrows = kind == kDkv ? p.Lk : p.Lq;
  const dim3 grid((lrows + kRows - 1) / kRows, p.B * p.H);
  if (kind == kFwd)
    return launch_kernel(flash_fwd_bf16_kernel<D>, fwd_bf16_smem<D>(), grid,
                         kMmaThreads, p, stream);
  if (kind == kDq)
    return launch_kernel(flash_dq_bf16_kernel<D>, dq_bf16_smem<D>(), grid,
                         kMmaThreads, p, stream);
  return launch_kernel(flash_dkv_bf16_kernel<D>, dkv_bf16_smem<D>(), grid,
                       kMmaThreads, p, stream);
}

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

}  // extern "C"
