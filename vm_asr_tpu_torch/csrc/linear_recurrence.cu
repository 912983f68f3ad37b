// Linear recurrence h_t = a_t * h_{t-1} + b_t (h_{-1} = 0) over (R, L, D)
// fp32, and its backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_lr_kernel` launched by `_lr_pallas`
// (vm_asr_tpu/ops/linear_recurrence.py:155-204), and its backward `_lr_bwd`
// (linear_recurrence.py:241-256), which runs the same kernel time-reversed.
// On the model's path it runs the two narrow output-head scans,
// (B, 65 536, 64) and (B, 262 144, 8), forward and in reverse.
//
// Reverse mode, given a, the forward's h and the incoming gradient g:
//   dh_t = g_t + a_{t+1} * dh_{t+1}   (dh_L = 0),   da_t = dh_t * h_{t-1}
// and db = dh. It walks each chunk from its last step to its first, carrying
// x = a_t * dh_t, so that a chunk needs no value of the next one: the chunk
// folds into the affine step x -> (prod a) * x + x_local like a forward chunk,
// and pass 2 carries those steps from the last chunk to the first.
//
// What bounds it: memory, 12 bytes per element forward (read a and b, write
// h) and 20 in reverse (read a, g and h, write dh and da), for two to three
// fp32 operations. The TPU kernel pads D to 128 lanes, 16x waste at D = 8;
// this one takes D as it is. Consecutive threads take consecutive (chunk,
// channel) pairs with the channel fastest, so at D = 8 a warp covers four
// chunks of eight channels and still reads whole 32-byte sectors.
//
// Parallelism: at D = 8 and B = 1 there are only 8 independent sequences of
// 262 144 steps, so L is split into chunks that run in parallel, in the three
// passes of scan_common.cuh.
#include "scan_common.cuh"

namespace vmasr {
namespace {

// One thread per (r, chunk, d), d fastest. kWrite = false: pass 1 (fold the
// chunk into P, S). kWrite = true: pass 3 (start from H0, write the outputs).
// kReverse = false: h = scan(a, b) into out. kReverse = true: b holds g; dh
// goes to out and dh * h_{t-1} (h read from h_fwd) to da.
template <bool kWrite, bool kReverse>
__global__ void __launch_bounds__(kThreads)
lr_chunk_kernel(const float* __restrict__ a, const float* __restrict__ b,
                const float* __restrict__ h_fwd, float* __restrict__ out,
                float* __restrict__ da, float* __restrict__ P, float* __restrict__ S,
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
  float h = kWrite ? H0[idx] : 0.f;  // reverse: x = a_{t+1} * dh_{t+1}
  float p = 1.f;
  if (!kReverse) {
#pragma unroll 4
    for (int t = t0; t < t1; ++t) {
      const size_t i = (r * L + t) * D + d;
      const float at = a[i];
      h = fmaf(at, h, b[i]);
      if (kWrite) {
        out[i] = h;
      } else {
        p *= at;
      }
    }
  } else {
#pragma unroll 4
    for (int t = t1 - 1; t >= t0; --t) {
      const size_t i = (r * L + t) * D + d;
      const float at = a[i];
      const float dh = b[i] + h;
      if (kWrite) {
        out[i] = dh;
        da[i] = t > 0 ? dh * h_fwd[i - D] : 0.f;
      } else {
        p *= at;
      }
      h = at * dh;
    }
  }
  if (!kWrite) {
    P[idx] = p;
    S[idx] = h;
  }
}

template <bool kReverse>
int launch(const float* a, const float* b, const float* h_fwd, float* out, float* da,
           float* P, float* S, float* H0, int R, int L, int D, int chunk,
           cudaStream_t s) {
  const int n_chunks = (L + chunk - 1) / chunk;
  const int blocks = num_blocks((size_t)R * n_chunks * D, kThreads);
  lr_chunk_kernel<false, kReverse><<<blocks, kThreads, 0, s>>>(
      a, b, nullptr, nullptr, nullptr, P, S, nullptr, R, L, D, chunk, n_chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  chunk_carry_kernel<<<R * D, kCarryThreads, 0, s>>>(P, S, H0, n_chunks, D, kReverse);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  lr_chunk_kernel<true, kReverse><<<blocks, kThreads, 0, s>>>(
      a, b, h_fwd, out, da, nullptr, nullptr, H0, R, L, D, chunk, n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace vmasr

// a, b, h: (R, L, D) fp32; P, S, H0: (R, n_chunks, D) fp32 scratch with
// n_chunks = ceil(L / chunk). Returns a cudaError_t.
extern "C" int vmasr_linear_recurrence(const float* a, const float* b, float* h,
                                       float* P, float* S, float* H0, int R, int L,
                                       int D, int chunk, void* stream) {
  if (R <= 0 || L <= 0 || D <= 0 || chunk <= 0) return (int)cudaErrorInvalidValue;
  return vmasr::launch<false>(a, b, nullptr, h, nullptr, P, S, H0, R, L, D, chunk,
                              static_cast<cudaStream_t>(stream));
}

// The backward: a, g, h (the forward's output), dh, da: (R, L, D) fp32;
// scratch as above. Writes dh (= the gradient of b) and da. Returns a
// cudaError_t.
extern "C" int vmasr_linear_recurrence_reverse(const float* a, const float* g,
                                               const float* h, float* dh, float* da,
                                               float* P, float* S, float* H0, int R,
                                               int L, int D, int chunk, void* stream) {
  if (R <= 0 || L <= 0 || D <= 0 || chunk <= 0) return (int)cudaErrorInvalidValue;
  return vmasr::launch<true>(a, g, h, dh, da, P, S, H0, R, L, D, chunk,
                             static_cast<cudaStream_t>(stream));
}
