// LayerNorm over the last dimension, forward, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves LayerNorm to XLA, which
// fuses it with its neighbours. The port ran it as torch's LayerNorm between
// two casts (models/layers.py: x.float(), F.layer_norm, .to(compute dtype)):
// three passes, 20 bytes an element at bf16, and torch's LayerNorm gives each
// row one thread block (128 threads on its vectorised path, 512 on the other,
// which takes every width that is no multiple of 4). The generator's rows are
// 2 to 384 values wide and there are up to 262 144 of them a call at batch 1,
// so almost every thread of those blocks idles and the cost follows the rows,
// not the bytes: in the serving cells that route was ~60 % of the device's
// busy time, at under 1 % of its byte bound. Added for the forward without a
// gradient (the serving forward, the classifier, evaluation): the wrapper
// (ops/layer_norm.py) takes no call that autograd records.
//
// What it computes, per row of N values, as torch's route does: the fp32 mean
// and biased variance, rstd = rsqrt(var + eps), y = (x - mean) * rstd * gamma +
// beta in fp32, rounded once to the output's dtype. x and y are bf16 or fp32,
// contiguous (rows, N); gamma and beta fp32 (N,).
//
// What bounds it: bytes. One read of x and one write of y, 4 bytes an element
// at bf16 in and out: 24.4 M elements a flagship segment at dims 16, 29 us at
// 3.35 TB/s. The statistics cost a few fp32 operations an element.
//
// Design: the width decides the geometry, and nothing else does.
// - A thread loads its part of a row as whole vectors of E values, the widest
//   of 16, 8, 4 or 2 bytes that divides the row (and the row's alignment).
// - Rows narrower than a 16-byte vector, N a power of two, are packed whole
//   into one: P = E / N rows a thread and vector (N = 2 in bf16: 4 rows).
// - Wider rows take a group of G lanes of one warp (a power of two, at most
//   32), each lane V vectors, lane l holding vectors l, l + G, l + 2G, ... so
//   that a group's loads are contiguous; sums over the group by
//   __shfl_xor_sync (a butterfly: every lane ends with the same bits). Rows
//   wider than 32 lanes x 8 vectors are walked in chunks of G * V vectors,
//   read again from L1/L2 for the second and third pass.
// - Statistics in two passes over the registers: the mean, then the centred
//   squares (no Welford, no cancellation).
// - gamma and beta are loaded once per thread where a lane's columns fit in
//   16 registers each (kHoldAffine), else once per row from L1.
// - 256 threads a CTA, at most 8 CTAs an SM, striding over the rows: no
//   shared memory, no atomics; the result does not depend on the grid.
// The wrapper's layer_norm_plan is the same rule in Python, which the CPU
// tests check covers every row and element once.
//
// The namespace is not `vmasr`: the benchmark's scan_roofline.classify reads
// the device time of every kernel named vmasr::..., the scans' namespace.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vmasr_norm {
namespace {

constexpr int kThreads = 256;
constexpr int kHoldAffine = 16;  // gamma, beta of a lane's columns held in registers up to this

// A value's bits in memory and its fp32 value.
template <typename T>
struct Io;
template <>
struct Io<float> {
  using Bits = float;
  static __device__ __forceinline__ float get(float b) { return b; }
  static __device__ __forceinline__ float put(float v) { return v; }
};
template <>
struct Io<__nv_bfloat16> {
  using Bits = unsigned short;
  static __device__ __forceinline__ float get(unsigned short b) {
    return __uint_as_float(static_cast<unsigned>(b) << 16);  // exact
  }
  static __device__ __forceinline__ unsigned short put(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));  // round to nearest even, as torch's .to
  }
};

template <int kBytes>
struct Word;
template <>
struct Word<2> { using T = unsigned short; };
template <>
struct Word<4> { using T = unsigned; };
template <>
struct Word<8> { using T = uint2; };
template <>
struct Word<16> { using T = uint4; };

// E values of T, moved as whole words of at most 16 bytes (fp32 out of a bf16
// vector of 8 is two).
template <typename T, int E>
struct Vec {
  using Bits = typename Io<T>::Bits;
  static constexpr int kBytes = E * static_cast<int>(sizeof(Bits));
  static constexpr int kWord = kBytes < 16 ? kBytes : 16;
  using W = typename Word<kWord>::T;
  union {
    W w[kBytes / kWord];
    Bits v[E];
  };
  __device__ __forceinline__ void load(const Bits* p) {
#pragma unroll
    for (int i = 0; i < kBytes / kWord; ++i) w[i] = reinterpret_cast<const W*>(p)[i];
  }
  __device__ __forceinline__ void store(Bits* p) const {
#pragma unroll
    for (int i = 0; i < kBytes / kWord; ++i) reinterpret_cast<W*>(p)[i] = w[i];
  }
};

struct LnArgs {
  const void* x;      // (rows, N), contiguous
  const float* gamma;  // (N,), 16-byte aligned
  const float* beta;
  void* y;  // (rows, N), contiguous
  long long rows;
  int N;
  int lanes;   // G
  int chunks;  // ceil(N / (E * G * V)); 1 with P > 1
  float eps;
};

__device__ __forceinline__ float group_sum(float v, unsigned mask, int lanes) {
  for (int m = lanes >> 1; m > 0; m >>= 1) v += __shfl_xor_sync(mask, v, m, lanes);
  return v;
}

// P > 1: P rows of E / P values a thread, one vector, lanes 1. P == 1: a row
// a group of lanes, V vectors of E values a lane and chunk.
template <typename Tin, typename Tout, int E, int V, int P>
__global__ void __launch_bounds__(kThreads) layer_norm_kernel(LnArgs a) {
  using In = typename Io<Tin>::Bits;
  using Out = typename Io<Tout>::Bits;
  const In* __restrict__ x = static_cast<const In*>(a.x);
  Out* __restrict__ y = static_cast<Out*>(a.y);
  const float* __restrict__ gamma = a.gamma;
  const float* __restrict__ beta = a.beta;
  const int lanes = a.lanes;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (lanes - 1);
  const unsigned mask = lanes == 32 ? 0xffffffffu : ((1u << lanes) - 1) << (lane & ~(lanes - 1));
  const long long group = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / lanes;
  const long long groups = static_cast<long long>(gridDim.x) * kThreads / lanes;

  if constexpr (P > 1) {
    constexpr int kN = E / P;
    float g[kN], b[kN];
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      g[e] = gamma[e];
      b[e] = beta[e];
    }
    for (long long r0 = group * P; r0 < a.rows; r0 += groups * P) {
      const long long left = a.rows - r0;  // the last vector may hold fewer rows
      Vec<Tin, E> q;
      if (left >= P) {
        q.load(x + r0 * kN);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) q.v[e] = e < left * kN ? x[r0 * kN + e] : In(0);
      }
      Vec<Tout, E> o;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        float f[kN], s = 0.f;
#pragma unroll
        for (int e = 0; e < kN; ++e) {
          f[e] = Io<Tin>::get(q.v[p * kN + e]);
          s += f[e];
        }
        const float mean = s / kN;
        float ss = 0.f;
#pragma unroll
        for (int e = 0; e < kN; ++e) ss = fmaf(f[e] - mean, f[e] - mean, ss);
        const float rstd = rsqrtf(ss / kN + a.eps);
#pragma unroll
        for (int e = 0; e < kN; ++e) o.v[p * kN + e] = Io<Tout>::put(fmaf((f[e] - mean) * rstd, g[e], b[e]));
      }
      if (left >= P) {
        o.store(y + r0 * kN);
      } else {
        for (int e = 0; e < left * kN; ++e) y[r0 * kN + e] = o.v[e];
      }
    }
  } else {
    constexpr bool kHold = V * E <= kHoldAffine;
    const int n = a.N, vecs = n / E, chunks = a.chunks;
    float g[kHold ? V : 1][E], b[kHold ? V : 1][E];
    if constexpr (kHold) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int j = k * lanes + sub;
        Vec<float, E> gv, bv;
        if (j < vecs) {
          gv.load(gamma + j * E);
          bv.load(beta + j * E);
        }
#pragma unroll
        for (int e = 0; e < E; ++e) {
          g[k][e] = j < vecs ? gv.v[e] : 0.f;
          b[k][e] = j < vecs ? bv.v[e] : 0.f;
        }
      }
    }
    float f[V][E];
    for (long long r = group; r < a.rows; r += groups) {
      const In* xr = x + r * n;
      Out* yr = y + r * n;
      // The lane's vectors of chunk c; those past the row read as 0.
      auto load = [&](int c) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const int j = (c * V + k) * lanes + sub;
          Vec<Tin, E> q;
          if (j < vecs) q.load(xr + j * E);
#pragma unroll
          for (int e = 0; e < E; ++e) f[k][e] = j < vecs ? Io<Tin>::get(q.v[e]) : 0.f;
        }
      };
      float s = 0.f;
      for (int c = 0; c < chunks; ++c) {
        load(c);
#pragma unroll
        for (int k = 0; k < V; ++k) {
#pragma unroll
          for (int e = 0; e < E; ++e) s += f[k][e];
        }
      }
      const float mean = group_sum(s, mask, lanes) / n;
      float ss = 0.f;
      for (int c = 0; c < chunks; ++c) {
        if (chunks > 1) load(c);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          if ((c * V + k) * lanes + sub < vecs) {
#pragma unroll
            for (int e = 0; e < E; ++e) ss = fmaf(f[k][e] - mean, f[k][e] - mean, ss);
          }
        }
      }
      const float rstd = rsqrtf(group_sum(ss, mask, lanes) / n + a.eps);
      for (int c = 0; c < chunks; ++c) {
        if (chunks > 1) load(c);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const int j = (c * V + k) * lanes + sub;
          if (j >= vecs) continue;
          float gk[E], bk[E];
          if constexpr (kHold) {
            if (chunks == 1) {
#pragma unroll
              for (int e = 0; e < E; ++e) {
                gk[e] = g[k][e];
                bk[e] = b[k][e];
              }
            }
          }
          if (!kHold || chunks > 1) {
            Vec<float, E> gv, bv;
            gv.load(gamma + j * E);
            bv.load(beta + j * E);
#pragma unroll
            for (int e = 0; e < E; ++e) {
              gk[e] = gv.v[e];
              bk[e] = bv.v[e];
            }
          }
          Vec<Tout, E> o;
#pragma unroll
          for (int e = 0; e < E; ++e) o.v[e] = Io<Tout>::put(fmaf((f[k][e] - mean) * rstd, gk[e], bk[e]));
          o.store(yr + j * E);
        }
      }
    }
  }
}

template <typename Tin, typename Tout, int E, int V, int P>
int ln_launch(const LnArgs& a, int blocks, cudaStream_t stream) {
  layer_norm_kernel<Tin, Tout, E, V, P><<<blocks, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The instances: V in {1, 2, 3, 4, 6, 8} for every vector width, and packed
// rows (V 1) in full 16-byte vectors. ops/layer_norm.py:LAYER_NORM_KERNELS
// names the same set.
template <typename Tin, typename Tout, int E>
int by_vectors(const LnArgs& a, int V, int blocks, cudaStream_t s) {
  switch (V) {
    case 1: return ln_launch<Tin, Tout, E, 1, 1>(a, blocks, s);
    case 2: return ln_launch<Tin, Tout, E, 2, 1>(a, blocks, s);
    case 3: return ln_launch<Tin, Tout, E, 3, 1>(a, blocks, s);
    case 4: return ln_launch<Tin, Tout, E, 4, 1>(a, blocks, s);
    case 6: return ln_launch<Tin, Tout, E, 6, 1>(a, blocks, s);
    case 8: return ln_launch<Tin, Tout, E, 8, 1>(a, blocks, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename Tin, typename Tout>
int by_width(const LnArgs& a, int E, int V, int P, int blocks, cudaStream_t s) {
  constexpr int kFull = 16 / sizeof(Tin);  // values of a 16-byte vector
  if (P > 1) {
    if (E != kFull || V != 1) return static_cast<int>(cudaErrorInvalidValue);
    switch (P) {
      case 2: return ln_launch<Tin, Tout, kFull, 1, 2>(a, blocks, s);
      case 4: return ln_launch<Tin, Tout, kFull, 1, 4>(a, blocks, s);
      case 8:
        if constexpr (kFull == 8) return ln_launch<Tin, Tout, kFull, 1, 8>(a, blocks, s);
        return static_cast<int>(cudaErrorInvalidValue);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (E) {
    case 1: return by_vectors<Tin, Tout, 1>(a, V, blocks, s);
    case 2: return by_vectors<Tin, Tout, 2>(a, V, blocks, s);
    case 4: return by_vectors<Tin, Tout, 4>(a, V, blocks, s);
    case 8:
      if constexpr (kFull == 8) return by_vectors<Tin, Tout, 8>(a, V, blocks, s);
      return static_cast<int>(cudaErrorInvalidValue);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool aligned(const void* p, size_t n) { return reinterpret_cast<uintptr_t>(p) % n == 0; }

}  // namespace
}  // namespace vmasr_norm

// x, y: (rows, N), contiguous, bf16 (bf16_in / bf16_out != 0) or fp32; gamma,
// beta: (N,) fp32, 16-byte aligned. The plan (ops/layer_norm.py:
// layer_norm_plan): vec E values a vector (E * itemsize <= 16 and x aligned
// to it), vectors V a lane and chunk, rows_per_vec P (> 1: N * P == E, E a
// full 16-byte vector, V 1, lanes 1), lanes G a power of two up to 32, chunks
// ceil(N / (E * G * V)), threads 256, blocks >= 1. Returns a cudaError_t;
// cudaErrorInvalidValue for a shape or plan it does not take.
extern "C" int vmasr_layer_norm_fwd(const void* x, const float* gamma, const float* beta, void* y,
                                    long long rows, int N, int bf16_in, int bf16_out, float eps,
                                    int vec, int vectors, int rows_per_vec, int lanes, int chunks,
                                    int threads, int blocks, void* stream) {
  using namespace vmasr_norm;
  const size_t in_item = bf16_in ? 2 : 4, out_item = bf16_out ? 2 : 4;
  const int E = vec, V = vectors, P = rows_per_vec;
  if (rows <= 0 || N <= 0 || threads != kThreads || blocks <= 0 || E <= 0 || V <= 0 || P <= 0 ||
      E * in_item > 16 || lanes <= 0 || lanes > 32 || (lanes & (lanes - 1)) != 0 || chunks <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (P > 1 ? (N * P != E || lanes != 1 || chunks != 1)
            : (N % E != 0 || chunks != (N / E + lanes * V - 1) / (lanes * V))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t out_word = E * out_item < 16 ? E * out_item : 16;
  if (!aligned(x, E * in_item) || !aligned(y, out_word) || !aligned(gamma, 16) ||
      !aligned(beta, 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const LnArgs a{x, gamma, beta, y, rows, N, lanes, chunks, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_in) {
    return bf16_out ? by_width<__nv_bfloat16, __nv_bfloat16>(a, E, V, P, blocks, s)
                    : by_width<__nv_bfloat16, float>(a, E, V, P, blocks, s);
  }
  return bf16_out ? by_width<float, __nv_bfloat16>(a, E, V, P, blocks, s)
                  : by_width<float, float>(a, E, V, P, blocks, s);
}
