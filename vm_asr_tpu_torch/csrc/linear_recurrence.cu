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
// and db = dh. It walks from the last step to the first carrying
// x = a_t * dh_t, so that a step needs no value of the next one: a run of
// steps folds into the affine step x -> (prod a) * x + x_local like a
// forward run (the JAX `a_next` convention, a_{t+1} paired with step t).
//
// What bounds it: bytes, 12 per element forward (read a and b, write h) and
// 20 in reverse (read a, g and h, write dh and da), for two to three fp32
// operations. The TPU kernel pads D to 128 lanes, 16x waste at D = 8; this
// one takes D as it is.
//
// One persistent launch per call, nothing to initialise. A tile is (row,
// L-tile, group of G contiguous channels: 32 where D is a multiple of 32,
// else the largest divisor of D up to 64, so D = 8 is one group of 8). Each
// thread takes one (16-step segment, channel); a tile is as many segments as
// 256 threads hold (512 steps at G = 8, 128 at G = 32). Tiles are numbered
// with the L-tile slowest, the reverse's from the last L-tile, and each CTA
// takes the next tile id from the look-back's ticket as it goes
// (scan_common.cuh: take_tile). For each it
//   1. has the tile's a and b (reverse: a, g, and h shifted by one step, so
//      that a row holds h_{t-1}) in shared memory, loaded by cp.async
//      16-byte pieces while it walked the tile before (two buffers; plain
//      loads where G or D is no multiple of 4). Segments sit G floats apart
//      per step, and G apart from each other where G < 32 divides 32, so
//      that the segments a warp walks fall on distinct banks;
//   2. folds each segment in registers into an affine step (P, S);
//   3. composes its segments per channel in order into the tile's aggregate
//      and takes the state entering the tile from the look-back of
//      scan_common.cuh (checkpoints every W tiles);
//   4. re-walks each segment from its entry state, writing h over b (the
//      reverse: dh over g, da over a) in shared memory, and the CTA stores
//      them as 16-byte pieces.
// So each input is read once and each output written once: 12 and 20
// bytes per element. The flagship's groups (G = 8 and 32) have instances
// with G a compile-time constant, so that the walks' offsets are
// immediates; any other G takes the instance that reads it at run time. The
// geometry comes from the wrapper (ops/linear_recurrence.py:lr_tile_layout),
// which the CPU tests reach; this side checks it.
//
// Bitwise repeatable: every state is one fixed expression of the tiles'
// aggregates (scan_common.cuh), so two calls give the same bits, on any grid.
//
// The look-back's W (the wrapper's choice, W * G near 1024 forward and 512
// in reverse, within 8..64): W = 32 forward and 16 in reverse at G = 32, 64
// at G = 8. Timed in chip_smoke.py on an H100 (700 W), device ms per call
// at W = 8, 16, 32, 64: forward (1, 65536, 64) 0.0383, 0.0298, 0.0284,
// 0.0342; (1, 262144, 8) 0.0265, 0.0165, 0.0115, 0.0116; (4, 65536, 64)
// 0.0836, 0.0827, 0.0810, 0.0967; (4, 262144, 8) 0.0493, 0.0446, 0.0443,
// 0.0447; reverse (4, 65536, 64) 0.1300, 0.1271, 0.1322, 0.1719;
// (4, 262144, 8) 0.0684 to 0.0693 at all four. One chain of 512 tiles at
// batch 1 wants few checkpoint hops; many chains want few aggregates read.
// Thread g of a group asks for the checkpoint's prefix first and composes
// the aggregates before it waits for it (scan_common.cuh), so a hop is one
// round trip: composing after the wait took (1, 65536, 64) from 0.0298 to
// 0.0388 ms at W = 16.
//
// What bounds it now: at batch 4 and 8 the bytes, within 1.3-1.5x of the
// bound (about 2.4 TB/s of the card's 3.35); at batch 1 the checkpoint hops
// of one or two chains of 512 tiles.
//
// What this design does about what held the three-pass version back:
//   - three launches (fold, chunk carry, re-run) and a second read of the
//     inputs: one launch, each input read once;
//   - the carry pass starved at batch 1 (8 blocks for 16 384 chunks at
//     (1, 262 144, 8)): the states cross tiles in the look-back, at n / W
//     checkpoint hops per chain;
//   - host cost: the ctypes functions typed once, the stream taken as the
//     fused wrappers take it, the look-back's words in the workspace the
//     fused forward uses too; only the outputs are allocated.
// Left for later: more CTAs per SM (the forward holds three, the reverse
// two, by shared memory), a deeper pipeline of tiles, and TMA loads.
#include "scan_common.cuh"

namespace vmasr {
namespace {

constexpr int kSeg = 16;          // steps of one thread's segment
constexpr int kMaxThreads = 256;  // segments * G, rounded up to a warp
constexpr int kMaxGroup = 64;     // the widest channel group

struct LrArgs {
  const float* a;
  const float* b;  // the reverse: g
  const float* h;  // the reverse: the forward's h
  float* out;      // h; the reverse: dh
  float* da;       // the reverse
  int R, L, D;
};

// The geometry: G channels per group, `segs` segments of kSeg steps per
// tile, `stride` floats from one segment to the next in shared memory;
// n_groups groups, n_tiles L-tiles per row. vec: rows of G channels move as
// 16-byte pieces.
struct LrTile {
  int G, segs, stride, n_groups, n_tiles;
  bool vec;
};

__host__ __device__ __forceinline__ int seg_stride(int G) {
  return kSeg * G + (G < 32 && 32 % G == 0 ? G : 0);
}
__host__ __device__ __forceinline__ size_t array_bytes(int G, int segs) {
  return (size_t)segs * seg_stride(G) * sizeof(float);
}
// Two buffers of 2 arrays (the reverse: 3), then the look-back's words.
__host__ __device__ __forceinline__ size_t smem_bytes(int G, int segs, bool reverse,
                                                      int window) {
  return 2 * (reverse ? 3 : 2) * array_bytes(G, segs) + lookback_smem_bytes(G, window);
}

// Where tile `id` lies: the L-tile is j, or the j-th from the last in reverse.
struct TileAt {
  size_t row;
  int j;         // position in the chain
  int t0;        // first step of the L-tile
  int c0;        // first channel of the group
  size_t slot0;  // look-back slot of the chain's first tile
};

template <bool kReverse>
__device__ __forceinline__ TileAt tile_at(const LrArgs& args, const LrTile& tile, int id) {
  const int chains = args.R * tile.n_groups;
  const int j = id / chains;
  const int chain = id - j * chains;  // row * n_groups + group
  const int jt = kReverse ? tile.n_tiles - 1 - j : j;
  return {(size_t)(chain / tile.n_groups), j, jt * tile.segs * kSeg,
          (chain % tile.n_groups) * tile.G, (size_t)chain * tile.n_tiles};
}

// Shared-memory offset of step r of the tile, channel e of the group.
__device__ __forceinline__ int at_smem(int r, int e, int G, int stride) {
  return (r / kSeg) * stride + (r % kSeg) * G + e;
}

// Start the loads of the tile into arrays x[0 .. n) from src[0 .. n),
// channels [c0, c0 + G); steps past L are left as they are (the walks mask
// them). A third array (the reverse's h) is staged one step back: row r
// holds step t - 1, 0 at t = 0. Rows of whole 16-byte pieces go by cp.async,
// which the caller commits and waits for; other rows by plain loads.
template <int kG, int n>
__device__ void stage(const LrArgs& args, const LrTile& tile, float* const* x,
                      const float* const* src, const TileAt& at) {
  const int G = kG > 0 ? kG : tile.G, stride = kG > 0 ? seg_stride(kG) : tile.stride;
  const int rows = tile.segs * kSeg;
  if (tile.vec) {
    const int per_row = G / 4;
    for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
      const int r = i / per_row, e = (i - r * per_row) * 4;
      const int t = at.t0 + r;
      if (t >= args.L) continue;
      const int o = at_smem(r, e, G, stride);
#pragma unroll
      for (int m = 0; m < n; ++m) {
        const int ts = m == 2 ? t - 1 : t;
        if (ts < 0) {
          *reinterpret_cast<float4*>(x[m] + o) = make_float4(0.f, 0.f, 0.f, 0.f);
        } else {
          cp_async<16>(x[m] + o, src[m] + (at.row * args.L + ts) * args.D + at.c0 + e);
        }
      }
    }
  } else {
    for (int i = threadIdx.x; i < rows * G; i += blockDim.x) {
      const int r = i / G, e = i - r * G;
      const int t = at.t0 + r;
      if (t >= args.L) continue;
      const int o = at_smem(r, e, G, stride);
#pragma unroll
      for (int m = 0; m < n; ++m) {
        const int ts = m == 2 ? t - 1 : t;
        x[m][o] = ts < 0 ? 0.f : src[m][(at.row * args.L + ts) * args.D + at.c0 + e];
      }
    }
  }
}

// Store arrays x[0 .. n) of the tile to dst[..] (steps past L are skipped).
template <int kG, int n>
__device__ void store(const LrArgs& args, const LrTile& tile, const float* const* x,
                      float* const* dst, const TileAt& at) {
  const int G = kG > 0 ? kG : tile.G, stride = kG > 0 ? seg_stride(kG) : tile.stride;
  const int rows = tile.segs * kSeg;
  if (tile.vec) {
    const int per_row = G / 4;
    for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
      const int r = i / per_row, e = (i - r * per_row) * 4;
      const int t = at.t0 + r;
      if (t >= args.L) continue;
      const int o = at_smem(r, e, G, stride);
      const size_t gi = (at.row * args.L + t) * args.D + at.c0 + e;
#pragma unroll
      for (int m = 0; m < n; ++m)
        *reinterpret_cast<float4*>(dst[m] + gi) = *reinterpret_cast<const float4*>(x[m] + o);
    }
  } else {
    for (int i = threadIdx.x; i < rows * G; i += blockDim.x) {
      const int r = i / G, e = i - r * G;
      const int t = at.t0 + r;
      if (t >= args.L) continue;
      const int o = at_smem(r, e, G, stride);
#pragma unroll
      for (int m = 0; m < n; ++m) dst[m][(at.row * args.L + t) * args.D + at.c0 + e] = x[m][o];
    }
  }
}

// kReverse = false: h = scan(a, b) into out. kReverse = true: b holds g; dh
// goes to out and dh * h_{t-1} to da. kG > 0: groups of kG channels, known
// to the compiler; kG = 0: any group, from tile.
template <bool kReverse, int kG>
__global__ void __launch_bounds__(kMaxThreads, 2)
lr_scan_kernel(LrArgs args, LrTile tile, LookBack lb) {
  constexpr int kArrays = kReverse ? 3 : 2;  // a, b (the reverse: a, g, h_{t-1})
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Affine part[kMaxThreads];  // each segment's step, then its entry state
  const int G = kG > 0 ? kG : tile.G, stride = kG > 0 ? seg_stride(kG) : tile.stride;
  const size_t arr = (size_t)tile.segs * stride;  // floats
  float* const base = reinterpret_cast<float*>(smem);
  float* const vals = base + 2 * kArrays * arr;  // the look-back's words
  auto buffer = [&](int which, float* (&x)[kArrays]) {
#pragma unroll
    for (int m = 0; m < kArrays; ++m) x[m] = base + (which * kArrays + m) * arr;
  };
  const float* const src[3] = {args.a, args.b, args.h};  // the reverse's h: h_{t-1}
  const int total = tile.n_tiles * args.R * tile.n_groups;
  const int tid = threadIdx.x;
  const int segs = tile.segs;
  const bool live = tid < G * segs;  // threads past it stage and store, and walk nothing
  const int seg = live ? tid / G : 0;
  const int g = live ? tid - seg * G : 0;

  __shared__ int ticket;  // the tile id thread 0 took for the CTA
  if (tid == 0) ticket = take_tile(lb);
  __syncthreads();
  int id = ticket;
  if (id < total) {
    float* x[kArrays];
    buffer(0, x);
    stage<kG, kArrays>(args, tile, x, src, tile_at<kReverse>(args, tile, id));
    cp_async_commit();
  }
  for (int n = 0; id < total; ++n) {
    float* x[kArrays];
    buffer(n & 1, x);
    const TileAt at = tile_at<kReverse>(args, tile, id);
    __syncthreads();  // every thread has read the ticket
    if (tid == 0) ticket = take_tile(lb);
    __syncthreads();
    const int next_id = ticket;
    if (next_id < total) {
      float* y[kArrays];
      buffer((n + 1) & 1, y);
      stage<kG, kArrays>(args, tile, y, src, tile_at<kReverse>(args, tile, next_id));
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // 2. Fold the segment, in the scan's direction; steps past L are the
    // identity (a = 1, b = 0).
    const int t_seg = at.t0 + seg * kSeg;
    const int len = live ? max(0, min(kSeg, args.L - t_seg)) : 0;
    float* const sa = x[0] + seg * stride + g;
    float* const sb = x[1] + seg * stride + g;
    Affine f{1.f, 0.f};
#pragma unroll
    for (int i = 0; i < kSeg; ++i) {
      const int s = kReverse ? kSeg - 1 - i : i;
      const bool ok = s < len;
      const float at_ = ok ? sa[s * G] : 1.f;
      const float bt = ok ? sb[s * G] : 0.f;
      f.s = kReverse ? at_ * (bt + f.s) : fmaf(at_, f.s, bt);
      f.p *= at_;
    }

    // 3. The tile's aggregate per channel, its segments composed in the
    // scan's order; the look-back; the state entering each segment.
    part[tid] = f;
    __syncthreads();
    Affine agg{1.f, 0.f};
    const bool checkpoint = is_checkpoint(lb, at.j);
    if (tid < G) {
      for (int i = 0; i < segs; ++i) {
        const int sg = kReverse ? segs - 1 - i : i;
        agg = compose(agg, part[sg * G + tid]);
      }
      if (!checkpoint) publish_aggregate(lb, at.slot0, at.j, G, tid, agg);
    }
    float h = look_back(lb, at.slot0, at.j, G, vals);
    if (tid < G) {
      if (checkpoint) publish_inclusive(lb, at.slot0, at.j, G, tid, fmaf(agg.p, h, agg.s));
      for (int i = 0; i < segs; ++i) {
        const int sg = kReverse ? segs - 1 - i : i;
        const Affine p = part[sg * G + tid];
        part[sg * G + tid].s = h;
        h = fmaf(p.p, h, p.s);
      }
    }
    __syncthreads();

    // 4. The re-walk from the segment's entry state, the outputs over the
    // inputs in shared memory.
    h = part[tid].s;
    if constexpr (kReverse) {
      const float* const shp = x[2] + seg * stride + g;
#pragma unroll
      for (int i = 0; i < kSeg; ++i) {
        const int s = kSeg - 1 - i;
        if (s < len) {
          const float at_ = sa[s * G];
          const float dh = sb[s * G] + h;
          sb[s * G] = dh;
          sa[s * G] = dh * shp[s * G];
          h = at_ * dh;
        }
      }
    } else {
#pragma unroll
      for (int s = 0; s < kSeg; ++s) {
        if (s < len) {
          h = fmaf(sa[s * G], h, sb[s * G]);
          sb[s * G] = h;
        }
      }
    }
    __syncthreads();
    if constexpr (kReverse) {
      const float* const out[2] = {x[1], x[0]};
      float* const dst[2] = {args.out, args.da};
      store<kG, 2>(args, tile, out, dst, at);
    } else {
      const float* const out[1] = {x[1]};
      float* const dst[1] = {args.out};
      store<kG, 1>(args, tile, out, dst, at);
    }
    __syncthreads();  // before the buffer takes the tile after next, and part the next
    id = next_id;
  }
}

template <bool kReverse, int kG>
int launch(const LrArgs& args, const LrTile& tile, const LookBack& lb, int threads, int smem,
           int max_ctas, cudaStream_t stream) {
  unsigned grid;
  const size_t tiles = (size_t)tile.n_tiles * args.R * tile.n_groups;
  cudaError_t err =
      persistent_grid(lr_scan_kernel<kReverse, kG>, threads, smem, tiles, max_ctas, &grid);
  if (err != cudaSuccess) return (int)err;
  lr_scan_kernel<kReverse, kG><<<grid, threads, smem, stream>>>(args, tile, lb);
  return (int)cudaGetLastError();
}

template <bool kReverse>
int run(const LrArgs& args, void* work, long long work_bytes, unsigned epoch, int G, int segs,
        int threads, int window, int smem, int max_ctas, void* stream) {
  const int R = args.R, L = args.L, D = args.D;
  if (R <= 0 || L <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  if (G <= 0 || G > kMaxGroup || D % G != 0 || segs <= 0 || (long long)G * segs > threads ||
      threads > kMaxThreads || threads % 32 != 0 || window < 1)
    return (int)cudaErrorInvalidValue;
  if (smem > kMaxBlockSmem || (size_t)smem < smem_bytes(G, segs, kReverse, window))
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (L + segs * kSeg - 1) / (segs * kSeg);
  const size_t slots = (size_t)R * (D / G) * n_tiles;
  if (!lookback_ok(work, work_bytes, epoch, slots, G, window)) return (int)cudaErrorInvalidValue;
  bool vec = G % 4 == 0 && D % 4 == 0 && aligned(args.a, 16) && aligned(args.b, 16) &&
             aligned(args.out, 16);
  if (kReverse) vec = vec && aligned(args.h, 16) && aligned(args.da, 16);
  const LrTile tile{G, segs, seg_stride(G), D / G, n_tiles, vec};
  const LookBack lb = make_lookback(work, slots, G, epoch, window);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G == 8 && vec) return launch<kReverse, 8>(args, tile, lb, threads, smem, max_ctas, s);
  if (G == 32 && vec) return launch<kReverse, 32>(args, tile, lb, threads, smem, max_ctas, s);
  return launch<kReverse, 0>(args, tile, lb, threads, smem, max_ctas, s);
}

}  // namespace
}  // namespace vmasr

// a, b, h: (R, L, D) fp32, contiguous. work: work_bytes of device memory
// that the caller keeps across calls, at least 24 * slots * tile_channels
// bytes for slots = R * (D / tile_channels) * ceil(L / (16 * tile_segments)),
// zeroed before its first use; epoch in [1, 2^30), a new one for each call
// that uses it (calls on one stream). The tile: tile_channels dividing D, at
// most 64; tile_threads a multiple of 32 in [channels * segments, 256];
// tile_window >= 1, the look-back's checkpoint spacing; tile_smem at least
// what they need and at most 232 448 bytes. max_ctas > 0 caps the grid (the
// result is the same on any grid). Returns a cudaError_t;
// cudaErrorInvalidValue for a shape, tile or workspace it does not take.
extern "C" int vmasr_linear_recurrence(const float* a, const float* b, float* h, void* work,
                                       long long work_bytes, unsigned epoch, int R, int L, int D,
                                       int tile_channels, int tile_segments, int tile_threads,
                                       int tile_window, int tile_smem, int max_ctas,
                                       void* stream) {
  const vmasr::LrArgs args{a, b, nullptr, h, nullptr, R, L, D};
  return vmasr::run<false>(args, work, work_bytes, epoch, tile_channels, tile_segments,
                           tile_threads, tile_window, tile_smem, max_ctas, stream);
}

// The backward: a, g, h (the forward's output), dh, da: (R, L, D) fp32,
// contiguous; workspace and tile as above. Writes dh (= the gradient of b)
// and da. Returns a cudaError_t.
extern "C" int vmasr_linear_recurrence_reverse(const float* a, const float* g, const float* h,
                                               float* dh, float* da, void* work,
                                               long long work_bytes, unsigned epoch, int R,
                                               int L, int D, int tile_channels,
                                               int tile_segments, int tile_threads,
                                               int tile_window, int tile_smem, int max_ctas,
                                               void* stream) {
  const vmasr::LrArgs args{a, g, h, dh, da, R, L, D};
  return vmasr::run<true>(args, work, work_bytes, epoch, tile_channels, tile_segments,
                          tile_threads, tile_window, tile_smem, max_ctas, stream);
}
