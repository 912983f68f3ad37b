// Fused selective scan, forward, for N = 16 states (d_state 16), for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package runs N > 1 as one `_lr_pallas`
// recurrence per state channel inside XLA glue, and the port did the same
// (ops/scan_api.py's general-N loop: per state, exp, two products, a
// recurrence launch and a sum, each a pass over an fp32 (B, L, K*D) tensor).
// Added for the VMamba classifier, every SS2D of which has d_state 16: there
// that loop's 16 recurrences and their torch glue were ~97 % of a batch-128
// forward's device time. The wrapper (ops/selective_scan_nstate.py) takes
// the forward without a gradient only; with one, the general-N loop stays,
// since its reverse recurrence is its backward.
//
// Layout (B, L, K*D), channel q = k*D + d; B and C per direction, (B, L, K,
// N). For every chain (b, q):
//   dt  = softplus(dts + bias[q])                       once a step
//   h_n = exp(dt * A[q, n]) * h_n + (dt * u) * B[b, t, k, n]     n < N
//   y   = sum_n C[b, t, k, n] * h_n + Dskip[q] * u
// u, dts, B, C and y are all bf16 or all fp32; A (K*D, N), bias and Dskip
// fp32; the maths and the 16 states fp32. exp and softplus are
// scan_common.cuh's (exp2 on the SFU, log1p_unit), as in the other scan
// kernels.
//
// What bounds it: the exponential. Per chain and step it must take N + 1
// exponentials (the states' decays and softplus's) on the SFU, 16 a clock
// on each SM, against ~4 fp32 operations a state on the FMA pipe (128 a
// clock) and 6 bytes of u, dts and y in bf16. At the classifier's batch of
// 128 the least bytes take ~3.1 ms a forward at 3.35 TB/s and the
// exponentials ~7.3 ms at ~1.75 GHz.
//
// Design. At batch 128 the chains alone fill the card (B*K*D = 98 304 at
// VMamba-T's first stage, 786 432 at its last), so L is not split: one
// launch, no look-back, no workspace, and each thread walks its chain from
// the first step to the last with its 16 states and its 16 decay rates
// (A * log2 e) in registers. A CTA takes G contiguous channels of one
// direction of one row (G the largest divisor of D up to 128: 96 at D = 192,
// 128 above), and walks L in tiles of kSteps = 16 steps staged in shared
// memory, two buffers filled by cp.async 16-byte pieces while the tile
// before is walked: u and dts as rows of G channels, B and C as one row of N
// each per step, which every channel of the direction reads (a broadcast).
// bf16 B and C rows are widened to fp32 once a tile by the CTA, so that a
// step reads its 2N values as float4 broadcasts and converts nothing. A
// step: dts + bias, softplus and dt * u once, then N x (exp2, product, two
// FMAs); y is stored straight from the register, a warp's stores coalesced
// into G contiguous channels. The registers are held to 80 a thread
// (__launch_bounds__(128, 6)): 768 resident threads an SM, which at batch 128
// takes VMamba-T's first stage (98 304 chains, 745 an SM) in one wave and
// the others in whole waves but for ~3 %.
//
// Measured on an H100 (700 W), bf16, batch 128, device ms over a forward's
// 15 calls: 10.65 as shipped, against 7.3 for the exponentials at 1.755 GHz
// (6.9 at 1.98) and 3.1 for the bytes. Variants timed against it, each
// slower: the step loop unrolled 1 (11.26) or 4 (10.80, spills); 5 CTAs an
// SM at 93 registers (11.08) or 8 at 64 (11.44); y summed in four partial
// sums (11.05); tiles of 32 steps (10.90) or 8 (11.04); 64 or 32 channels a
// CTA where D allows 128 (10.81, 11.07).
//
// Few chains (chip_smoke's batch 8, batch 1): one thread a chain would leave
// most of the card idle, so `lanes` (1, 2, 4, 8, 16) threads share a chain,
// each with N / lanes of its states; each lane computes softplus itself (no
// exchange), and the lanes' parts of y are summed by shuffles, in a fixed
// order. The rule is the wrapper's (ops/selective_scan_nstate.py:
// nstate_tile_layout), by the chain count B*K*D, which the CPU tests reach:
// the fewest lanes that give at least 65 536 threads. Every batch-128 shape
// of VMamba-T takes one lane.
//
// Bitwise repeatable by construction: no atomics, no order that depends on
// timing. Nothing is allocated but y, and the host does not wait: a CUDA
// graph may capture the call.
#include "scan_common.cuh"

namespace vmasr {
namespace {

constexpr int kSteps = 16;        // steps of one staged tile
constexpr int kMaxThreads = 128;  // channels x lanes of a CTA, rounded up to a warp
constexpr int kMinBlocks = 6;     // CTAs of 128 threads an SM: at most 80 registers

struct NsArgs {
  const void* u;
  const void* dts;
  const void* bs;
  const void* cs;
  const float* A;  // (KD, N)
  const float* bias;
  const float* dskip;
  void* y;
  int B, L, KD, K;
};

// G channels of one direction a CTA, n_groups = KD / G CTAs a row. vec: u
// and dts rows of G channels, and B and C rows, move as 16-byte pieces.
struct NsTile {
  int G, n_groups;
  bool vec;
};

// A staging buffer: u, dts [kSteps][G] and B, C [kSteps][2][N] (a step's B
// row then its C row), in the IO dtype, each array rounded up to 16 bytes;
// the CTA has two, and for bf16 one fp32 copy of B, C [kSteps][2][N].
// ops/selective_scan_nstate.py:nstate_tile_smem is the same sum.
__host__ __device__ __forceinline__ size_t ns_io_bytes(int G, size_t item) {
  return round16((size_t)kSteps * G * item);
}
__host__ __device__ __forceinline__ size_t ns_bc_bytes(int N, size_t item) {
  return round16((size_t)kSteps * 2 * N * item);
}
__host__ __device__ __forceinline__ size_t ns_smem_bytes(int G, int N, size_t item) {
  return 2 * (2 * ns_io_bytes(G, item) + ns_bc_bytes(N, item)) +
         (item == sizeof(float) ? 0 : ns_bc_bytes(N, sizeof(float)));
}

template <typename T>
struct NsBuf {
  T* u;
  T* dts;
  T* bc;
};

// Start the loads of the tile of steps [t0, t0 + kSteps) into buf; rows
// past L are left as they are (their steps are not walked). 16-byte pieces
// go by cp.async, which the caller commits and waits for; other rows by
// plain loads, landed when this returns.
template <typename T, int kN>
__device__ void ns_stage(const NsArgs& args, const NsTile& tile, const NsBuf<T>& buf, size_t b,
                         int k, int c0, int t0) {
  const int G = tile.G;
  const T* u = static_cast<const T*>(args.u);
  const T* dts = static_cast<const T*>(args.dts);
  const T* bs = static_cast<const T*>(args.bs);
  const T* cs = static_cast<const T*>(args.cs);
  const int rows = min(kSteps, args.L - t0);
  if (tile.vec) {
    constexpr int kPer = 16 / sizeof(T);  // elements a piece
    const int per_row = G / kPer;
    for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
      const int r = i / per_row, e = (i - r * per_row) * kPer;
      const size_t g = (b * args.L + t0 + r) * args.KD + c0 + e;
      cp_async<16>(buf.u + r * G + e, u + g);
      cp_async<16>(buf.dts + r * G + e, dts + g);
    }
    constexpr int kRowPieces = kN / kPer;  // pieces of one B or C row
    for (int i = threadIdx.x; i < rows * 2 * kRowPieces; i += blockDim.x) {
      const int r = i / (2 * kRowPieces), w = i - r * 2 * kRowPieces;
      const int which = w / kRowPieces, e = (w - which * kRowPieces) * kPer;
      const size_t g = ((b * args.L + t0 + r) * args.K + k) * kN + e;
      cp_async<16>(buf.bc + (r * 2 + which) * kN + e, (which ? cs : bs) + g);
    }
  } else {
    for (int i = threadIdx.x; i < rows * G; i += blockDim.x) {
      const int r = i / G;
      const size_t g = (b * args.L + t0 + r) * args.KD + c0 + (i - r * G);
      buf.u[i] = u[g];
      buf.dts[i] = dts[g];
    }
    for (int i = threadIdx.x; i < rows * 2 * kN; i += blockDim.x) {
      const int r = i / (2 * kN), w = i - r * 2 * kN;
      const int which = w / kN, n = w - which * kN;
      buf.bc[i] = (which ? cs : bs)[((b * args.L + t0 + r) * args.K + k) * kN + n];
    }
  }
}

// kLanes threads a chain, each with kN / kLanes of its states. Threads
// t = c * kLanes + lane: channel c0 + c of the CTA's group, states
// [lane * kNS, (lane + 1) * kNS); threads past G * kLanes stage and wait,
// and walk nothing.
template <typename T, int kN, int kLanes>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
nstate_fwd_kernel(NsArgs args, NsTile tile) {
  constexpr int kNS = kN / kLanes;
  static_assert(kN % kLanes == 0 && 32 % kLanes == 0, "lanes must divide N and a warp");
  constexpr bool kWiden = sizeof(T) != sizeof(float);
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = tile.G, D = args.KD / args.K;
  const size_t b = blockIdx.x / tile.n_groups;
  const int c0 = (int)(blockIdx.x - b * tile.n_groups) * G;
  const int k = c0 / D;
  const int tid = threadIdx.x;
  const int lane = tid % kLanes, c = tid / kLanes;
  const bool live = c < G;
  const int q = c0 + (live ? c : 0);

  const size_t io = ns_io_bytes(G, sizeof(T)), bcb = ns_bc_bytes(kN, sizeof(T));
  auto buffer = [&](int which) {
    unsigned char* base = smem + which * (2 * io + bcb);
    return NsBuf<T>{reinterpret_cast<T*>(base), reinterpret_cast<T*>(base + io),
                    reinterpret_cast<T*>(base + 2 * io)};
  };
  float* widened = reinterpret_cast<float*>(smem + 2 * (2 * io + bcb));

  float a2[kNS], h[kNS];
#pragma unroll
  for (int i = 0; i < kNS; ++i) {
    a2[i] = args.A[(size_t)q * kN + lane * kNS + i] * kLog2e;
    h[i] = 0.f;
  }
  const float bias_q = args.bias[q], d_q = args.dskip[q];
  T* y = static_cast<T*>(args.y);
  // The lanes of a chain: kLanes adjacent threads of one warp.
  const unsigned group_mask =
      kLanes == 32 ? 0xffffffffu : ((1u << kLanes) - 1) << ((tid & 31) & ~(kLanes - 1));

  const int n_tiles = (args.L + kSteps - 1) / kSteps;
  ns_stage<T, kN>(args, tile, buffer(0), b, k, c0, 0);
  cp_async_commit();
  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<0>();
    __syncthreads();  // tile j is in; every thread is done with tile j - 1
    const NsBuf<T> cur = buffer(j & 1);
    const float* bc;
    if constexpr (kWiden) {
      for (int i = tid; i < kSteps * 2 * kN; i += blockDim.x) widened[i] = to_f(cur.bc[i]);
      bc = widened;
    } else {
      bc = reinterpret_cast<const float*>(cur.bc);
    }
    if (j + 1 < n_tiles) {
      ns_stage<T, kN>(args, tile, buffer((j + 1) & 1), b, k, c0, (j + 1) * kSteps);
      cp_async_commit();
    }
    if constexpr (kWiden) __syncthreads();  // the widened rows are in
    if (!live) continue;
    const int t0 = j * kSteps, len = min(kSteps, args.L - t0);
#pragma unroll 2
    for (int s = 0; s < len; ++s) {
      const float uu = to_f(cur.u[s * G + c]);
      float e;
      const float dt = softplus(to_f(cur.dts[s * G + c]) + bias_q, e);
      const float dtu = dt * uu;
      const float* brow = bc + s * 2 * kN + lane * kNS;
      const float* crow = brow + kN;
      float yv = 0.f;
      if constexpr (kNS % 4 == 0) {
#pragma unroll
        for (int i4 = 0; i4 < kNS; i4 += 4) {
          const float4 bb = *reinterpret_cast<const float4*>(brow + i4);
          const float4 cc = *reinterpret_cast<const float4*>(crow + i4);
          const float bv[4] = {bb.x, bb.y, bb.z, bb.w}, cv[4] = {cc.x, cc.y, cc.z, cc.w};
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int i = i4 + m;
            h[i] = fmaf(exp2_sfu(dt * a2[i]), h[i], dtu * bv[m]);
            yv = fmaf(cv[m], h[i], yv);
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < kNS; ++i) {
          h[i] = fmaf(exp2_sfu(dt * a2[i]), h[i], dtu * brow[i]);
          yv = fmaf(crow[i], h[i], yv);
        }
      }
      if constexpr (kLanes > 1) {
#pragma unroll
        for (int m = kLanes / 2; m > 0; m /= 2) yv += __shfl_xor_sync(group_mask, yv, m, kLanes);
      }
      if (lane == 0) store_f(y, (b * args.L + t0 + s) * args.KD + q, fmaf(d_q, uu, yv));
    }
  }
}

template <typename T, int kN, int kLanes>
int ns_launch(const NsArgs& args, const NsTile& tile, int threads, int smem,
              cudaStream_t stream) {
  const size_t grid = (size_t)args.B * tile.n_groups;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nstate_fwd_kernel<T, kN, kLanes>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  nstate_fwd_kernel<T, kN, kLanes><<<(unsigned)grid, threads, smem, stream>>>(args, tile);
  return (int)cudaGetLastError();
}

template <typename T, int kN>
int ns_dispatch(const NsArgs& args, const NsTile& tile, int lanes, int threads, int smem,
                cudaStream_t stream) {
  switch (lanes) {
    case 1: return ns_launch<T, kN, 1>(args, tile, threads, smem, stream);
    case 2: return ns_launch<T, kN, 2>(args, tile, threads, smem, stream);
    case 4: return ns_launch<T, kN, 4>(args, tile, threads, smem, stream);
    case 8: return ns_launch<T, kN, 8>(args, tile, threads, smem, stream);
    case 16: return ns_launch<T, kN, 16>(args, tile, threads, smem, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace vmasr

// u, dts, y: (B, L, KD); bs, cs: (B, L, K, N); all contiguous, in the IO
// dtype (bf16 != 0: bf16, else fp32). A: (KD, N), bias, dskip: (KD,), fp32.
// N = 16. The tile: tile_lanes threads a chain (1, 2, 4, 8 or 16);
// tile_channels dividing D = KD / K; tile_threads a multiple of 32 in
// [channels * lanes, 128]; tile_smem at least what they need (the wrapper's
// nstate_tile_smem) and at most 232 448 bytes. Returns a cudaError_t;
// cudaErrorInvalidValue for a shape or tile it does not take.
extern "C" int vmasr_nstate_scan_fwd(const void* u, const void* dts, const void* bs,
                                     const void* cs, const float* A, const float* bias,
                                     const float* dskip, void* y, int B, int L, int KD, int K,
                                     int N, int bf16, int tile_lanes, int tile_channels,
                                     int tile_threads, int tile_smem, void* stream) {
  using namespace vmasr;
  if (B <= 0 || L <= 0 || K <= 0 || KD <= 0 || KD % K != 0 || N != 16) {
    return (int)cudaErrorInvalidValue;
  }
  const int D = KD / K, G = tile_channels, lanes = tile_lanes;
  if (G <= 0 || D % G != 0 || lanes <= 0 || (long long)G * lanes > tile_threads ||
      tile_threads > kMaxThreads || tile_threads % 32 != 0 ||
      (size_t)B * (KD / G) > 0x7fffffffu) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t item = bf16 ? sizeof(__nv_bfloat16) : sizeof(float);
  if (tile_smem > kMaxBlockSmem || (size_t)tile_smem < ns_smem_bytes(G, N, item)) {
    return (int)cudaErrorInvalidValue;
  }
  const bool vec = (G * item) % 16 == 0 && (KD * item) % 16 == 0 && aligned(u, 16) &&
                   aligned(dts, 16) && aligned(bs, 16) && aligned(cs, 16);
  const NsArgs args{u, dts, bs, cs, A, bias, dskip, y, B, L, KD, K};
  const NsTile tile{G, KD / G, vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? ns_dispatch<__nv_bfloat16, 16>(args, tile, lanes, tile_threads, tile_smem, s)
              : ns_dispatch<float, 16>(args, tile, lanes, tile_threads, tile_smem, s);
}
