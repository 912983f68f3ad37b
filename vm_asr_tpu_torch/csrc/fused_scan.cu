// Fused N=1 selective scan, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_make_kernel` launched by `_fused_fwd_pallas`
// (vm_asr_tpu/ops/selective_scan_fused.py:86-196). Layout (B, L, K*D), channel
// q = k*D + d; for every (b, q):
//   dt = softplus(dts + bias[q]);  a = exp(dt * A[q]);  b = dt * u * B[b, t, k]
//   h_t = a_t * h_{t-1} + b_t;     y = C[b, t, k] * h + Dskip[q] * u
// and H0 (B, n_chunks, K*D) fp32, the state entering each L-chunk of the
// wrapper's chunk length: the TPU kernel's checkpoint `ckpt`, from which the
// backward (fused_scan_bwd.cu) rebuilds h. u, dts, B, C and y are all bf16 or
// all fp32; A, bias, Dskip are fp32 and the maths is fp32.
//
// Parameter groups: A, bias and Dskip may hold S sets of KD values, one per
// run of B / S consecutive rows, so that one launch serves S streams with
// their own parameters (the stream-stacked generator folds its streams
// into the rows; the TPU kernel gets the same from pallas_call's batching
// rule under the JAX package's nn.vmap). Row b reads set b / group_rows;
// S = 1 (group_rows = B) is the plain call, bit for bit.
//
// What bounds it: bytes. It must read u and dts and write y, 6 bytes per
// element in bf16 (12 in fp32), plus B, C and H0, against ~15 fp32
// operations per element, far below the card's 20 operations per byte.
//
// One launch. A tile is (batch row b, L-tile of C whole chunks, channel
// group of G contiguous channels: 32 where K*D allows, the flagship's case,
// compiled with G and K = 4 as constants). Each chunk is split into
// `splits` segments of 16 steps, one thread per (segment, channel), so that
// every flagship chunk (16 or 32 steps at batch 1 and 4, 64 at batch 8) is
// one 16-step sub-tile per thread. Tiles are numbered with the L-tile
// slowest: id = (tile * B + b) * n_groups + group. The kernel is persistent:
// each CTA takes the next tile id from the look-back's ticket as it goes
// (scan_common.cuh: take_tile), and for each it
//   1. has the tile's u, dts, B and C in shared memory, loaded by cp.async
//      while it walked the tile before (two buffers): 16-byte pieces of
//      contiguous channels and one piece per row of B and C (plain loads where
//      the rows are no whole pieces, as at D = 33);
//   2. walks it, each thread down its segment, computing dt and a once per
//      element and keeping a and dt*u*B in registers, and folds the segment
//      into an affine step (P, S);
//   3. composes its segments per channel in order into the tile's
//      aggregate and takes the state entering the tile from the
//      checkpointed look-back of scan_common.cuh over the preceding tiles of
//      the same (b, group): checkpoints every W = 16 tiles publish the state
//      leaving them, the other tiles their aggregate, and the CTA reads the
//      words a tile needs together;
//   4. gives each thread the state entering its segment, writes H0 at each
//      chunk's first segment, and re-walks the segment out of registers,
//      writing y over u in shared memory; the CTA stores y as 16-byte pieces.
// Segments longer than 16 steps (chunks beyond 16 * splits: 512 steps and up
// at G = 32, or narrow groups) are walked in 16-step sub-tiles; their
// re-walk stages each sub-tile again, mostly from L2, and computes dt and a
// again. The geometry comes from the wrapper
// (ops/selective_scan_fused.py:fwd_tile_layout), which the CPU tests reach;
// this side checks it.
//
// The look-back's note (scan_common.cuh) says why it cannot deadlock and
// why no kernel clears its words (they carry a per-call epoch, so a CUDA
// graph cannot capture the kernel as it stands).
//
// Bitwise repeatable: each state is one fixed expression of the tiles'
// aggregates, so H0 and y are the same bits on every call and on any grid
// (chip_smoke.py checks two calls and a grid of five CTAs at every shape).
// (A decoupled look-back that composes whichever preceding aggregates it
// finds before an inclusive prefix gives last bits that depend on timing.)
//
// What this design does about what held the three-pass version back:
//   - three launches per call (fold, chunk_carry_kernel, re-run): one, and
//     nothing to initialise it;
//   - each input read twice and each transcendental computed twice: u, dts,
//     B and C are read once (about 6 bytes per element in bf16, against 10),
//     dt and a computed once per element wherever a segment is one sub-tile
//     (every flagship shape);
//   - the carry pass read P and S at a stride of K*D floats: there is no
//     carry pass; the look-back reads 24 bytes per channel of a preceding
//     tile, from L2;
//   - host cost: the ctypes function typed once; y and H0 from torch.empty
//     and a workspace kept across calls, instead of P, S and H0 per call.
// Changed from the plan, each measured on an H100 against the alternative:
// one thread walks a 16-step segment, not a whole chunk (a 32-step chunk in
// registers took 233 registers, two CTAs per SM, slower); 32-channel groups,
// not 128 (more chains of tiles, so fewer tiles of one chain run at once and
// each look-back is shorter; 128, 64, 16 and 8 were slower); the group width
// a compile-time constant (the walks' shared-memory offsets become
// immediates, and the kernel, bound by its integer work more than by its
// loads, ran faster at every shape); persistent CTAs with the next tile's
// loads in flight (as fast as one CTA per tile, within the spread).
// The look-back's W = 16, of 8, 16, 32 and 64 timed in chip_smoke.py on an
// H100 (700 W), bf16, device ms summed over the flagship's 30 calls: per
// batch-4 train step 0.568, 0.571, 0.595, 0.619; per batch-1 forward 0.226,
// 0.222, 0.220, 0.233. Short chains (batch 1) want a larger W, many chains
// (batch 4) fewer aggregates read; 16 is within 1 % of the best of both.
// Being repeatable costs about 5 % per train step against the decoupled
// look-back that stopped at the first inclusive prefix it found (0.544 ms):
// a tile now reads up to W - 1 aggregates rather than mostly one prefix.
// Left for later: TMA loads from a producer warp, a look-back that overlaps
// the next tile's walk, and a device-side epoch that would let a CUDA graph
// capture the kernel.
//
// Numerics: dt and a as the backward computes them (scan_common.cuh: exp on
// the SFU, log1p_unit), so that H0 and the backward's walk agree to the bit.
// The fp32 flagship forward stays within chip_smoke.py's bar of 1e-5 of its
// scale from the plain scan with them (PERF.md has the reading), so the
// accurate libm versions were not needed.
#include "scan_common.cuh"

namespace vmasr {
namespace {

constexpr int kSteps = 16;             // steps of one thread's segment (or sub-tile of it)
constexpr int kMaxTileThreads = 256;   // segments * G threads, rounded up to a warp
constexpr int kMinTiles = 2;           // CTAs of 256 threads per SM: at most 128 registers
constexpr int kMaxChunk = 1024;        // the wrapper's largest chunk

struct FwdArgs {
  const void* u;
  const void* dts;
  const void* bs;
  const void* cs;
  const float* A;
  const float* bias;
  const float* dskip;
  void* y;
  float* H0;  // (B, n_chunks, KD)
  int B, L, KD, K, chunk, n_chunks;
  int group_rows;  // rows per parameter set: row b reads A, bias, Dskip at (b / group_rows) * KD
};

// The geometry: G channels per group, C chunks per L-tile, each chunk split
// into `splits` segments of n_sub * kSteps steps, one thread per (segment,
// channel); n_groups groups, n_tiles L-tiles per row. vec: rows of G
// channels move as 16-byte pieces, rows of B and C (K = 4) as one piece each.
struct FwdTile {
  int G, C, splits, n_sub, n_groups, n_tiles;
  bool vec;
};

// A staging buffer: u, dts [R][G] and B, C [R][K] in the IO dtype for R =
// C * splits * kSteps rows, each array rounded up to 16 bytes; the CTA has
// two. ops/selective_scan_fused.py:fwd_tile_smem is the same sum. Row r
// holds step s = r % kSteps of sub-tile j of segment r / kSteps.
__host__ __device__ __forceinline__ size_t io_bytes(int rows, int G, size_t item) {
  return round16((size_t)rows * G * item);
}
__host__ __device__ __forceinline__ size_t buffer_bytes(int rows, int G, int K, size_t item) {
  return 2 * io_bytes(rows, G, item) + 2 * round16((size_t)rows * K * item);
}
// Two buffers (the tile being walked and the next one, in flight), then the
// look-back's words.
__host__ __device__ __forceinline__ size_t smem_bytes(int rows, int G, int K, size_t item,
                                                      int window) {
  return 2 * buffer_bytes(rows, G, K, item) + lookback_smem_bytes(G, window);
}

template <typename T>
struct Buf {
  T* u;  // y overwrites it in the re-walk
  T* dts;
  T* b;
  T* c;
};

// The step of row r of sub-tile j, in the tile starting at step t_tile:
// t_tile + r where each segment is one sub-tile (the rows are then the
// tile's steps in order).
__device__ __forceinline__ int step_of(const FwdArgs& args, const FwdTile& tile, int t_tile,
                                       int j, int r) {
  if (tile.n_sub == 1) return t_tile + r;
  const int seg = r / kSteps;
  return t_tile + (seg / tile.splits) * args.chunk +
         (seg % tile.splits) * tile.n_sub * kSteps + j * kSteps + r % kSteps;
}

// Start the loads of sub-tile j of the tile, channels [c0, c0 + G), into
// buf; rows past L are left as they are (their steps are masked). Rows of
// whole 16-byte pieces go by cp.async, which the caller commits and waits
// for; other rows by plain loads, landed when this returns.
template <typename T, int kG>
__device__ void stage_async(const FwdArgs& args, const FwdTile& tile, const Buf<T>& buf,
                            size_t b, int t_tile, int j, int c0) {
  const int G = kG > 0 ? kG : tile.G, rows = tile.C * tile.splits * kSteps;
  const T* u = static_cast<const T*>(args.u);
  const T* dts = static_cast<const T*>(args.dts);
  const T* bs = static_cast<const T*>(args.bs);
  const T* cs = static_cast<const T*>(args.cs);
  if (tile.vec) {
    // A thread takes one 16-byte piece of every (blockDim.x / per_row)-th
    // row: per_row divides blockDim.x (checked on the host).
    constexpr int kPer = 16 / sizeof(T);  // elements per 16-byte piece
    const int per_row = G / kPer;
    const int e = (threadIdx.x % per_row) * kPer;
    for (int r = threadIdx.x / per_row; r < rows; r += blockDim.x / per_row) {
      const int t = step_of(args, tile, t_tile, j, r);
      if (t < args.L) {
        const size_t g = (b * args.L + t) * args.KD + c0 + e;
        cp_async<16>(buf.u + r * G + e, u + g);
        cp_async<16>(buf.dts + r * G + e, dts + g);
      }
    }
    constexpr int kRow = 4 * sizeof(T);  // B, C rows of K = 4 directions
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      const int t = step_of(args, tile, t_tile, j, r);
      if (t < args.L) {
        cp_async<kRow>(buf.b + r * 4, bs + (b * args.L + t) * 4);
        cp_async<kRow>(buf.c + r * 4, cs + (b * args.L + t) * 4);
      }
    }
  } else {
    for (int i = threadIdx.x; i < rows * G; i += blockDim.x) {
      const int r = i / G;
      const int t = step_of(args, tile, t_tile, j, r);
      if (t < args.L) {
        const size_t g = (b * args.L + t) * args.KD + c0 + (i - r * G);
        buf.u[i] = u[g];
        buf.dts[i] = dts[g];
      }
    }
    for (int i = threadIdx.x; i < rows * args.K; i += blockDim.x) {
      const int r = i / args.K;
      const int t = step_of(args, tile, t_tile, j, r);
      if (t < args.L) {
        const size_t g = (b * args.L + t) * args.K + (i - r * args.K);
        buf.b[i] = bs[g];
        buf.c[i] = cs[g];
      }
    }
  }
}

// Store y of sub-tile j from buf.u (rows past L are skipped).
template <typename T, int kG>
__device__ void store_y(const FwdArgs& args, const FwdTile& tile, const Buf<T>& buf, size_t b,
                        int t_tile, int j, int c0) {
  const int G = kG > 0 ? kG : tile.G, rows = tile.C * tile.splits * kSteps;
  T* y = static_cast<T*>(args.y);
  if (tile.vec) {
    constexpr int kPer = 16 / sizeof(T);
    const int per_row = G / kPer;
    const int e = (threadIdx.x % per_row) * kPer;
    for (int r = threadIdx.x / per_row; r < rows; r += blockDim.x / per_row) {
      const int t = step_of(args, tile, t_tile, j, r);
      if (t < args.L) {
        *reinterpret_cast<uint4*>(y + (b * args.L + t) * args.KD + c0 + e) =
            *reinterpret_cast<const uint4*>(buf.u + r * G + e);
      }
    }
  } else {
    for (int i = threadIdx.x; i < rows * G; i += blockDim.x) {
      const int r = i / G;
      const int t = step_of(args, tile, t_tile, j, r);
      if (t < args.L) y[(b * args.L + t) * args.KD + c0 + (i - r * G)] = buf.u[i];
    }
  }
}

// One thread's steps [0, len) of a staged sub-tile (rows r0 .. r0 + kSteps -
// 1), column g: dt and a once per step, a and dt*u*B kept in av, bv (steps
// past len: a = 1, b = 0, the identity). Returns the sub-tile's affine step.
// Unrolled in full: the steps' transcendentals are independent and
// interleave; only the fold's two operations wait for the step before.
template <typename T>
__device__ __forceinline__ Affine walk_fold(float (&av)[kSteps], float (&bv)[kSteps], int len,
                                            const Buf<T>& buf, int G, int K, int r0, int g,
                                            int k, float a2_q, float bias_q) {
  Affine f{1.f, 0.f};
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int r = r0 + s;
    const float raw = to_f(buf.dts[r * G + g]) + bias_q;
    const float uu = to_f(buf.u[r * G + g]);
    const float bb = to_f(buf.b[r * K + k]);
    float e;
    const float dt = softplus(raw, e);
    const bool ok = s < len;
    av[s] = ok ? exp2_sfu(dt * a2_q) : 1.f;
    bv[s] = ok ? (dt * uu) * bb : 0.f;
    f.s = fmaf(av[s], f.s, bv[s]);
    f.p *= av[s];
  }
  return f;
}

// The re-walk of the same steps from h, out of av and bv: y = C*h + D*u over
// u in the staging buffer. Returns h after the sub-tile.
template <typename T>
__device__ __forceinline__ float walk_out(float h, const float (&av)[kSteps],
                                          const float (&bv)[kSteps], int len, const Buf<T>& buf,
                                          int G, int K, int r0, int g, int k, float d_q) {
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int r = r0 + s;
    h = fmaf(av[s], h, bv[s]);
    if (s < len) {
      T& slot = buf.u[r * G + g];
      from_f(slot, fmaf(to_f(buf.c[r * K + k]), h, d_q * to_f(slot)));
    }
  }
  return h;
}

// Where tile `id` (ticket order: the L-tile slowest) lies.
struct TileAt {
  size_t b;     // batch row
  int jt;       // L-tile
  int c0;        // first channel of the group
  size_t slot0;  // look-back slot of the chain's first tile
};

__device__ __forceinline__ TileAt tile_at(const FwdArgs& args, const FwdTile& tile, int id) {
  const int chains = args.B * tile.n_groups;
  const int jt = id / chains;
  const int chain = id - jt * chains;  // b * n_groups + group
  return {(size_t)(chain / tile.n_groups), jt, (chain % tile.n_groups) * tile.G,
          (size_t)chain * tile.n_tiles};
}

// Persistent: each CTA takes tile ids from the ticket (scan_common.cuh:
// take_tile), with the next tile's loads in flight while it walks the
// current one. kG > 0: the
// group is kG channels and K = 4, known to the compiler, so that the
// shared-memory offsets of the walks are immediates (the flagship's
// stages); kG = 0: any group and K, from tile and args.
template <typename T, int kG>
__global__ void __launch_bounds__(kMaxTileThreads, kMinTiles)
fused_fwd_kernel(FwdArgs args, FwdTile tile, LookBack lb) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Affine part[kMaxTileThreads];  // each segment's step, then its entry state
  const int G = kG > 0 ? kG : tile.G, K = kG > 0 ? 4 : args.K, D = args.KD / K;
  const int segs = tile.C * tile.splits;
  const size_t io = io_bytes(segs * kSteps, G, sizeof(T));
  const size_t bc = round16((size_t)segs * kSteps * K * sizeof(T));
  float* vals = reinterpret_cast<float*>(smem + 2 * (2 * io + 2 * bc));  // look-back words
  auto buffer = [&](int which) {
    unsigned char* base = smem + which * (2 * io + 2 * bc);
    return Buf<T>{reinterpret_cast<T*>(base), reinterpret_cast<T*>(base + io),
                  reinterpret_cast<T*>(base + 2 * io), reinterpret_cast<T*>(base + 2 * io + bc)};
  };
  const int total = tile.n_tiles * args.B * tile.n_groups;
  const int tid = threadIdx.x;
  const bool live = tid < G * segs;  // threads past it stage and store, and walk nothing
  const int seg = live ? tid / G : 0;
  const int g = live ? tid - seg * G : 0;

  __shared__ int ticket;  // the tile id thread 0 took for the CTA
  if (tid == 0) ticket = take_tile(lb);
  __syncthreads();
  int id = ticket;
  if (id < total) {
    const TileAt at = tile_at(args, tile, id);
    stage_async<T, kG>(args, tile, buffer(0), at.b, at.jt * tile.C * args.chunk, 0, at.c0);
    cp_async_commit();
  }
  for (int n = 0; id < total; ++n) {
    const Buf<T> buf = buffer(n & 1);
    const TileAt at = tile_at(args, tile, id);
    __syncthreads();  // every thread has read the ticket
    if (tid == 0) ticket = take_tile(lb);
    __syncthreads();
    const int next_id = ticket;
    if (next_id < total) {
      const TileAt next = tile_at(args, tile, next_id);
      stage_async<T, kG>(args, tile, buffer((n + 1) & 1), next.b,
                         next.jt * tile.C * args.chunk, 0, next.c0);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const int q = at.c0 + g;
    const int k = q / D;
    const size_t pq = at.b / args.group_rows * args.KD + q;  // this row's parameter set
    const float a2_q = args.A[pq] * kLog2e;
    const float bias_q = args.bias[pq];
    const float d_q = args.dskip[pq];
    const int t_tile = at.jt * tile.C * args.chunk;
    const int ci = at.jt * tile.C + seg / tile.splits;  // this thread's chunk
    const int t_seg = ci * args.chunk + (seg % tile.splits) * tile.n_sub * kSteps;
    const int t_end = min(min(t_seg + tile.n_sub * kSteps, (ci + 1) * args.chunk), args.L);
    auto len_of = [&](int j) { return live ? min(kSteps, t_end - (t_seg + j * kSteps)) : 0; };
    // Sub-tile j > 0 of a segment longer than one, staged now.
    auto restage = [&](int j) {
      __syncthreads();  // every thread is done with the sub-tile before
      stage_async<T, kG>(args, tile, buf, at.b, t_tile, j, at.c0);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    };

    // 1-2. Fold the segment.
    float av[kSteps], bv[kSteps];
    Affine fold{1.f, 0.f};
    for (int j = 0; j < tile.n_sub; ++j) {
      if (j > 0) restage(j);
      fold = compose(fold, walk_fold(av, bv, len_of(j), buf, G, K, seg * kSteps, g, k, a2_q,
                                     bias_q));
    }

    // 3. The tile's aggregate per channel, its segments composed in order;
    // the look-back; the state entering each segment.
    part[tid] = fold;
    __syncthreads();
    Affine agg{1.f, 0.f};
    const bool checkpoint = is_checkpoint(lb, at.jt);
    if (tid < G) {
      for (int sg = 0; sg < segs; ++sg) agg = compose(agg, part[sg * G + tid]);
      if (!checkpoint) publish_aggregate(lb, at.slot0, at.jt, G, tid, agg);
    }
    float h = look_back(lb, at.slot0, at.jt, G, vals);
    if (tid < G) {
      if (checkpoint) publish_inclusive(lb, at.slot0, at.jt, G, tid, fmaf(agg.p, h, agg.s));
      for (int sg = 0; sg < segs; ++sg) {
        const Affine p = part[sg * G + tid];
        part[sg * G + tid].s = h;
        h = fmaf(p.p, h, p.s);
      }
    }
    __syncthreads();

    // 4. H0 at each chunk's first segment; the re-walk, which recomputes
    // dt and a only where the segment outgrew one sub-tile (from L2).
    h = part[tid].s;
    if (live && seg % tile.splits == 0 && ci < args.n_chunks)
      args.H0[(at.b * args.n_chunks + ci) * args.KD + q] = h;
    for (int j = 0; j < tile.n_sub; ++j) {
      if (tile.n_sub > 1) {
        restage(j);
        walk_fold(av, bv, len_of(j), buf, G, K, seg * kSteps, g, k, a2_q, bias_q);
      }
      h = walk_out(h, av, bv, len_of(j), buf, G, K, seg * kSteps, g, k, d_q);
      __syncthreads();
      store_y<T, kG>(args, tile, buf, at.b, t_tile, j, at.c0);
    }
    __syncthreads();  // before the buffer takes the tile after next, and part the next
    id = next_id;
  }
}

template <typename T, int kG>
int launch(const FwdArgs& args, const FwdTile& tile, LookBack lb, int threads, int smem,
           int max_ctas, cudaStream_t stream) {
  unsigned grid;
  const size_t tiles = (size_t)tile.n_tiles * args.B * tile.n_groups;
  cudaError_t err = persistent_grid(fused_fwd_kernel<T, kG>, threads, smem, tiles, max_ctas, &grid);
  if (err != cudaSuccess) return (int)err;
  fused_fwd_kernel<T, kG><<<grid, threads, smem, stream>>>(args, tile, lb);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace vmasr

// u, dts, y: (B, L, KD); bs, cs: (B, L, K); all in the IO dtype (bf16 != 0:
// bf16, else fp32). A, bias, dskip: (B / group_rows, KD) fp32, row b reading
// set b / group_rows (group_rows = B: one set, (KD,)). H0: (B, n_chunks, KD) fp32,
// n_chunks = ceil(L / chunk), receives the state entering each chunk. work:
// work_bytes of device memory that the caller keeps across calls, at least
// 24 * slots * tile_channels bytes for slots = B * (KD / tile_channels) *
// ceil(n_chunks / tile_chunks), and zeroed before its first use; epoch in
// [1, 2^30), a new one for each call that uses it (calls on one stream).
// The tile: tile_channels dividing KD; tile_chunks >= 1; tile_splits
// segments per chunk, each a whole number of 16-step sub-tiles;
// tile_threads a multiple of 32 in [channels * chunks * splits, 256];
// tile_window >= 1, the look-back's checkpoint spacing W; tile_smem at least
// what they need and at most 232 448 bytes. max_ctas > 0 caps the grid (the
// result is the same on any grid). Returns a cudaError_t;
// cudaErrorInvalidValue for a shape, tile or workspace it does not take.
extern "C" int vmasr_fused_scan_fwd(const void* u, const void* dts, const void* bs,
                                    const void* cs, const float* A, const float* bias,
                                    const float* dskip, void* y, float* H0, void* work,
                                    long long work_bytes, unsigned epoch, int B, int L, int KD,
                                    int K, int chunk, int group_rows, int bf16,
                                    int tile_channels,
                                    int tile_chunks, int tile_splits, int tile_threads,
                                    int tile_window, int tile_smem, int max_ctas, void* stream) {
  using namespace vmasr;
  if (B <= 0 || L <= 0 || K <= 0 || KD % K != 0 || chunk <= 0 || chunk > kMaxChunk ||
      group_rows <= 0 || B % group_rows != 0)
    return (int)cudaErrorInvalidValue;
  const int G = tile_channels, C = tile_chunks, sp = tile_splits;
  if (G <= 0 || KD % G != 0 || C <= 0 || sp <= 0 || chunk % (sp * kSteps) != 0 ||
      (long long)G * C * sp > tile_threads || tile_threads > kMaxTileThreads ||
      tile_threads % 32 != 0 || tile_window < 1)
    return (int)cudaErrorInvalidValue;
  const size_t item = bf16 ? sizeof(__nv_bfloat16) : sizeof(float);
  if (tile_smem > kMaxBlockSmem ||
      (size_t)tile_smem < smem_bytes(C * sp * kSteps, G, K, item, tile_window))
    return (int)cudaErrorInvalidValue;
  const int n_chunks = (L + chunk - 1) / chunk;
  const int n_tiles = (n_chunks + C - 1) / C;
  const size_t slots = (size_t)B * (KD / G) * n_tiles;
  if (!lookback_ok(work, work_bytes, epoch, slots, G, tile_window))
    return (int)cudaErrorInvalidValue;
  const bool vec = K == 4 && (G * item) % 16 == 0 && tile_threads % (G * item / 16) == 0 &&
                   (KD * item) % 16 == 0 && aligned(u, 16) && aligned(dts, 16) &&
                   aligned(y, 16) && aligned(bs, 4 * item) && aligned(cs, 4 * item);
  FwdTile tile{G, C, sp, chunk / (sp * kSteps), KD / G, n_tiles, vec};
  FwdArgs args{u, dts, bs, cs, A, bias, dskip, y, H0, B, L, KD, K, chunk, n_chunks,
               group_rows};
  const LookBack lb = make_lookback(work, slots, G, epoch, tile_window);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G == 32 && K == 4) {
    return bf16 ? launch<__nv_bfloat16, 32>(args, tile, lb, tile_threads, tile_smem, max_ctas, s)
                : launch<float, 32>(args, tile, lb, tile_threads, tile_smem, max_ctas, s);
  }
  return bf16 ? launch<__nv_bfloat16, 0>(args, tile, lb, tile_threads, tile_smem, max_ctas, s)
              : launch<float, 0>(args, tile, lb, tile_threads, tile_smem, max_ctas, s);
}
