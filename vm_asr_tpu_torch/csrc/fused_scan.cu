// Fused N=1 selective scan, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_make_kernel` launched by `_fused_fwd_pallas`
// (vm_asr_tpu/ops/selective_scan_fused.py:86-196). Layout (B, L, K*D), channel
// q = k*D + d; for every (b, q):
//   dt = softplus(dts + bias[q]);  a = exp(dt * A[q]);  b = dt * u * B[b, t, k]
//   h_t = a_t * h_{t-1} + b_t;     y = C[b, t, k] * h + Dskip[q] * u
// u, dts, B, C and y are all bf16 or all fp32; A, bias, Dskip are fp32 and the
// maths is fp32.
//
// What bounds it: memory. Per element it reads u and dts and writes y (6 bytes
// in bf16) for about 15 fp32 operations, far below the card's 20 operations
// per byte for fp32. The design keeps every load coalesced: consecutive
// threads take consecutive channels q, so a warp reads one contiguous run of
// a row at each t, and the B/C value of direction k = q / D is one address
// the whole warp shares. The TPU kernel's one-hot matmul that expands B/C to
// lanes (selective_scan_fused.py:68-83) is not needed here.
//
// Parallelism: at B = 1 the model has 128-1024 channels against L up to
// 16 384, so one thread per channel would leave most of the 132 SMs idle.
// L is split into chunks that run in parallel (see scan_common.cuh): pass 1
// folds each chunk, pass 2 carries the chunk states, pass 3 recomputes each
// chunk from its carry and writes y. This is the TPU kernel's chunk carry
// (selective_scan_fused.py:94-125) with the chunks run at once. It does not
// emit the chunk-entry states the TPU backward reads; the backward is not
// ported yet.
//
// Numerics: expf / log1pf (no fast-math intrinsics), softplus written as
// jax.nn.softplus computes it: max(x, 0) + log1p(exp(-|x|)).
#include "scan_common.cuh"

namespace vmasr {
namespace {

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

struct FusedArgs {
  const void* u;
  const void* dts;
  const void* bs;
  const void* cs;
  const float* A;
  const float* bias;
  const float* dskip;
  void* y;
  int B, L, KD, K, chunk, n_chunks;
};

// One thread per (b, chunk, q), q fastest. kWrite = false: pass 1 (fold the
// chunk into P, S). kWrite = true: pass 3 (start from H0, write y).
template <typename T, bool kWrite>
__global__ void __launch_bounds__(kThreads)
fused_chunk_kernel(FusedArgs args, float* __restrict__ P, float* __restrict__ S,
                   const float* __restrict__ H0) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)args.B * args.n_chunks * args.KD;
  if (idx >= total) return;
  const int q = (int)(idx % args.KD);
  const size_t bc = idx / args.KD;
  const int c = (int)(bc % args.n_chunks);
  const size_t b = bc / args.n_chunks;
  const int k = q / (args.KD / args.K);

  const T* __restrict__ u = static_cast<const T*>(args.u);
  const T* __restrict__ dts = static_cast<const T*>(args.dts);
  const T* __restrict__ bs = static_cast<const T*>(args.bs);
  const T* __restrict__ cs = static_cast<const T*>(args.cs);
  T* __restrict__ y = static_cast<T*>(args.y);
  const float a_q = args.A[q];
  const float bias_q = args.bias[q];
  const float d_q = args.dskip[q];

  const int t0 = c * args.chunk;
  const int t1 = min(t0 + args.chunk, args.L);
  float h = kWrite ? H0[idx] : 0.f;
  float p = 1.f;
#pragma unroll 4
  for (int t = t0; t < t1; ++t) {
    const size_t row = b * args.L + t;
    const size_t i = row * args.KD + q;
    const float uu = load_f(u, i);
    const float dt = softplus(load_f(dts, i) + bias_q);
    const float a = expf(dt * a_q);
    h = fmaf(a, h, (dt * uu) * load_f(bs, row * args.K + k));
    if (kWrite) {
      store_f(y, i, fmaf(load_f(cs, row * args.K + k), h, d_q * uu));
    } else {
      p *= a;
    }
  }
  if (!kWrite) {
    P[idx] = p;
    S[idx] = h;
  }
}

template <typename T>
int launch(const FusedArgs& args, float* P, float* S, float* H0, cudaStream_t stream) {
  const size_t threads = (size_t)args.B * args.n_chunks * args.KD;
  const int blocks = num_blocks(threads, kThreads);
  fused_chunk_kernel<T, false><<<blocks, kThreads, 0, stream>>>(args, P, S, nullptr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  chunk_carry_kernel<<<args.B * args.KD, kCarryThreads, 0, stream>>>(
      P, S, H0, args.n_chunks, args.KD);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fused_chunk_kernel<T, true><<<blocks, kThreads, 0, stream>>>(args, nullptr, nullptr, H0);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace vmasr

// u, dts, y: (B, L, KD); bs, cs: (B, L, K); A, bias, dskip: (KD,) fp32;
// P, S, H0: (B, n_chunks, KD) fp32 scratch with n_chunks = ceil(L / chunk).
// bf16 != 0: the activations are bf16, else fp32. Returns a cudaError_t.
extern "C" int vmasr_fused_scan_fwd(const void* u, const void* dts, const void* bs,
                                    const void* cs, const float* A, const float* bias,
                                    const float* dskip, void* y, float* P, float* S,
                                    float* H0, int B, int L, int KD, int K, int chunk,
                                    int bf16, void* stream) {
  if (B <= 0 || L <= 0 || K <= 0 || KD % K != 0 || chunk <= 0) return (int)cudaErrorInvalidValue;
  vmasr::FusedArgs args{u, dts, bs, cs, A, bias, dskip, y,
                        B, L, KD, K, chunk, (L + chunk - 1) / chunk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? vmasr::launch<__nv_bfloat16>(args, P, S, H0, s)
              : vmasr::launch<float>(args, P, S, H0, s);
}
