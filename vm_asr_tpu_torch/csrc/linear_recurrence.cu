// Linear recurrence h_t = a_t * h_{t-1} + b_t (h_{-1} = 0) over (R, L, D)
// fp32, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_lr_kernel` launched by `_lr_pallas`
// (vm_asr_tpu/ops/linear_recurrence.py:155-204). On the model's path it runs
// the two narrow output-head scans, (B, 65 536, 64) and (B, 262 144, 8).
//
// What bounds it: memory, 12 bytes per element (read a and b, write h) for
// two fp32 operations. The TPU kernel pads D to 128 lanes, 16x waste at
// D = 8; this one takes D as it is. Consecutive threads take consecutive
// (chunk, channel) pairs with the channel fastest, so at D = 8 a warp covers
// four chunks of eight channels and still reads whole 32-byte sectors.
//
// Parallelism: at D = 8 and B = 1 there are only 8 independent sequences of
// 262 144 steps, so L is split into chunks that run in parallel, in the three
// passes of scan_common.cuh.
#include "scan_common.cuh"

namespace vmasr {
namespace {

// One thread per (r, chunk, d), d fastest. kWrite = false: pass 1 (fold the
// chunk into P, S). kWrite = true: pass 3 (start from H0, write h).
template <bool kWrite>
__global__ void __launch_bounds__(kThreads)
lr_chunk_kernel(const float* __restrict__ a, const float* __restrict__ b,
                float* __restrict__ h_out, float* __restrict__ P, float* __restrict__ S,
                const float* __restrict__ H0, int R, int L, int D, int chunk,
                int n_chunks) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)R * n_chunks * D;
  if (idx >= total) return;
  const int d = (int)(idx % D);
  const size_t rc = idx / D;
  const int c = (int)(rc % n_chunks);
  const size_t r = rc / n_chunks;

  const int t0 = c * chunk;
  const int t1 = min(t0 + chunk, L);
  float h = kWrite ? H0[idx] : 0.f;
  float p = 1.f;
#pragma unroll 4
  for (int t = t0; t < t1; ++t) {
    const size_t i = (r * L + t) * D + d;
    const float at = a[i];
    h = fmaf(at, h, b[i]);
    if (kWrite) {
      h_out[i] = h;
    } else {
      p *= at;
    }
  }
  if (!kWrite) {
    P[idx] = p;
    S[idx] = h;
  }
}

}  // namespace
}  // namespace vmasr

// a, b, h: (R, L, D) fp32; P, S, H0: (R, n_chunks, D) fp32 scratch with
// n_chunks = ceil(L / chunk). Returns a cudaError_t.
extern "C" int vmasr_linear_recurrence(const float* a, const float* b, float* h,
                                       float* P, float* S, float* H0, int R, int L,
                                       int D, int chunk, void* stream) {
  if (R <= 0 || L <= 0 || D <= 0 || chunk <= 0) return (int)cudaErrorInvalidValue;
  using namespace vmasr;
  const int n_chunks = (L + chunk - 1) / chunk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = num_blocks((size_t)R * n_chunks * D, kThreads);
  lr_chunk_kernel<false><<<blocks, kThreads, 0, s>>>(a, b, nullptr, P, S, nullptr,
                                                     R, L, D, chunk, n_chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  chunk_carry_kernel<<<R * D, kCarryThreads, 0, s>>>(P, S, H0, n_chunks, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  lr_chunk_kernel<true><<<blocks, kThreads, 0, s>>>(a, b, h, nullptr, nullptr, H0,
                                                    R, L, D, chunk, n_chunks);
  return (int)cudaGetLastError();
}
