// K7: the fused spatial ResNet block for one same-channel ResnetBlock2D,
// bf16 in and out, channels-first:
//   h = conv3x3(SiLU(GN1(x))) + (bias1 + temb)
//   y = conv3x3(SiLU(GN2(h))) + bias2 + x
// Replaces the Pallas kernel ctrlv_tpu/ops/resblock.py::fused_resblock2d
// (_resblock_kernel). Both GroupNorms and both convolutions are computed here:
// nothing on this path calls a library.
//
// What bounds it on an H100: the tensor cores. At (N, C, H, W) =
// (50, 320, 40, 64) a call is 2 * 2 * N*H*W * 9*C*C = 0.47 TFLOP against
// 0.17 GB that must move (x, y and the two weights once). At the deep levels
// (C = 1280 at 10x16 and 5x8) the products are few (0.12 TFLOP at 5x8) and
// the weights many (29.5 MB a convolution), so the weight bytes that every
// pixel tile streams through L2 weigh as much as the products.
//
// Arithmetic, as the TPU kernel has it: per sample, f32 sum and sum of squares
// per group over the whole image, var = E[x^2] - E[x]^2 (clamped at 0),
// a = rsqrt(var + eps) * gamma, b = beta - mean * a, SiLU(a * x + b) rounded to
// bf16; each convolution as nine shifted products with an f32 accumulator
// over 9 * C terms and zeros outside the image; + (bias1 + temb) in f32 and
// ONE rounding to bf16; GN2's statistics from those rounded values;
// + bias2 + x in f32 and one rounding.
//
// Design. The TPU kernel gives one program a whole sample in VMEM. A Hopper
// block has 227 KB, so the work is cut across blocks, a GroupNorm's statistics
// cross blocks and h goes through device memory (L2 where it fits). A call is
// four launches (GN1's sums, conv1, GN2's fold, conv2); the weights are
// re-laid to (9, C_out, C_in) by a second entry point, which the wrapper calls
// only when a weight is new or has changed (ops/resblock.py caches the copy).
//
// Each convolution is an implicit GEMM: M = output pixels, N = output
// channels, K = 9 taps x C_in, walked as (64 input channels, tap) stages.
// A block owns a 128-pixel M tile and 160 or 320 output channels (make_plan)
// and is warp-specialised into four warpgroups (registers by setmaxnreg,
// Split below):
//   - producer thread 0 issues every weight stage by TMA (a 3-D tensor map
//     over the cached (9, C_out, C_in) copy, one or two 160 x 64 boxes,
//     128-byte swizzle) into a ring of 2-4 stages with a "full" and an
//     "empty" mbarrier each;
//   - the other seven producer warps stage the A operand: 64 input channels
//     of the tile's image rows and their halo are read from NCHW (16 bytes
//     along the pixels), normalised, SiLU'd, rounded and written pixel-major
//     with a zero column left and right into one of two A buffers (mbarriers
//     again), so a tap is a shift of the row address that ldmatrix reads and
//     the image border needs no mask. TMA cannot apply the norm, so A takes
//     this path;
//   - two consumer warpgroups of 64 pixels each: per tap, ldmatrix the
//     tap-shifted rows into registers and issue register-A wgmma m64n160k16
//     (one or two) against the K-major weight tiles, four k16 slices a tap.
// The M tile is 128 / W whole image rows of the flattened (N * H) rows, so it
// may span several samples (5x8: 3.2 samples a tile, 10x16: 0.8); each
// sample's rows are staged with their own halo, and a row of a lane's
// ldmatrix address costs nothing to place. Only the last tile of the call is
// ragged. Tiles are the fastest grid axis, so the blocks in flight share one
// slab of weights in L2. A block takes 320 output channels where that still
// leaves a block for each SM: one staged input tile then feeds twice the
// products.
// The epilogue stages the f32 tile in shared memory (over the ring), 160
// channels at a time, so that the NCHW stores are 16-byte and coalesced.
// conv1 adds bias1 + temb, rounds, stores h and leaves per-(tile, sample,
// group) sums of the ROUNDED h in scratch; a small kernel adds them up per
// sample over its tiles in tile order, and conv2 takes GN2's affine from
// those sums and adds bias2 and x.
// No float atomics: two runs on the same input agree to the bit.
#include "hopper_utils.cuh"

#include <algorithm>

namespace ctrlv {
namespace {

constexpr int kConsumers = 2;                  // consumer warpgroups of 64 pixels
constexpr int kProducers = 2;                  // warpgroups that feed them
constexpr int kThreads = 128 * (kConsumers + kProducers);
// Registers a thread after setmaxnreg (the pool is 65536 / kThreads a thread)
// and the staging loads a producer thread keeps in flight, by block width:
// a consumer of 320 channels holds 160 f32 accumulators.
template <int kHalves>
struct Split {
  static constexpr int kProducerRegs = kHalves == 1 ? 96 : 40;
  static constexpr int kConsumerRegs = kHalves == 1 ? 160 : 216;
  static constexpr int kUnroll = kHalves == 1 ? 4 : 1;
  static_assert(128 * (kProducers * kProducerRegs + kConsumers * kConsumerRegs) <= 65536,
                "setmaxnreg: more registers than an SM has");
};
constexpr int kTileM = 64 * kConsumers;        // output pixels of a block
constexpr int kBN = 160;                       // output channels of one product (a "half")
constexpr int kKC = 64;                        // input channels of a stage
constexpr int kARow = kKC + 8;                 // bf16 row stride of an A buffer (no bank conflicts)
constexpr int kBTile = kBN * kKC * 2;          // bytes of one 160 x 64 weight tile
constexpr int kMaxStages = 4;
constexpr int kXformWarps = 4 * kProducers - 1;  // all producer warps but the first
constexpr int kTransformThreads = 32 * kXformWarps;
constexpr int kOutStride = kTileM + 4;         // f32 row stride of the epilogue tile
constexpr int kOutBytes = kBN * kOutStride * 4;
constexpr int kBarBytes = 8 * (2 * kMaxStages + 4);
constexpr int kMaxStagedRows = 3 * (kTileM / 8);  // rows + 2 halo rows a sample, W >= 8
constexpr int kSmemMax = 232448 - 1024;  // the block's 227 KB, less the static arrays
constexpr int kSMs = 132;                // an H100's, for the plan's choice of block width

// The tiling of one call: a pure function of the shape, mirrored by
// ops/resblock.py::_plan.
struct Plan {
  int rows;         // image rows of an M tile: kTileM / W
  long long tiles;  // M tiles over the N * H image rows
  int max_seg;      // samples one tile touches, at most
  int slots;        // pixel slots of one A buffer: (rows + 2 * max_seg) * (W + 2)
  int halves;       // output channels of a block: 160 * halves
  int stages;       // weight stages in flight; 0 where nothing fits
  int smem;         // dynamic shared memory of a block
};

inline int samples_touched(long long g0, int rows, long long total_rows, int h) {
  const long long g1 = std::min(g0 + rows, total_rows);
  return static_cast<int>((g1 - 1) / h - g0 / h + 1);
}

// A block takes 320 output channels, so that one staged input tile feeds
// twice the products, where that still leaves a block for every SM and the
// shared memory holds two stages; else 160.
Plan make_plan(int n, int c, int h, int w, int groups) {
  Plan p{};
  p.rows = kTileM / w;
  const long long total = static_cast<long long>(n) * h;
  p.tiles = (total + p.rows - 1) / p.rows;
  // tile t starts at row t * rows: the pattern of samples repeats within h tiles
  for (long long t = 0; t < std::min<long long>(p.tiles, h); ++t)
    p.max_seg = std::max(p.max_seg, samples_touched(t * p.rows, p.rows, total, h));
  p.slots = (p.rows + 2 * p.max_seg) * (w + 2);
  const int a_bytes = 2 * p.slots * kARow * 2;
  const int fixed = 1024 + a_bytes + kBarBytes + 4 * (2 * c + 2 * p.max_seg * groups);
  for (int halves = 2; halves >= 1; --halves) {
    if (c % (kBN * halves) || (halves == 2 && p.tiles * (c / (2 * kBN)) < kSMs)) continue;
    for (int s = kMaxStages; s >= 2; --s) {
      const int ring = s * halves * kBTile;
      if (fixed + ring <= kSmemMax && ring + a_bytes >= kOutBytes) {
        p.halves = halves;
        p.stages = s;
        p.smem = fixed + ring;
        return p;
      }
    }
  }
  return p;
}

__device__ __forceinline__ long long min_ll(long long a, long long b) { return a < b ? a : b; }
__device__ __forceinline__ long long max_ll(long long a, long long b) { return a > b ? a : b; }

__device__ __forceinline__ float load_param(const void* p, long long i, int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const bf16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ float silu(float v) { return __fdividef(v, 1.f + __expf(-v)); }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// (C_out, C_in, 9) -> (9, C_out, C_in)
__global__ void relayout_kernel(const bf16* __restrict__ w, bf16* __restrict__ wr, int cc) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= cc) return;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) wr[static_cast<long long>(tap) * cc + idx] = w[idx * 9LL + tap];
}

// GN2's sums per (sample, group), to stats[sample][group][2]: conv1's sums per
// (tile, sample of the tile, group) in `part`, over the tiles that cover the
// sample, in tile order.
__global__ void gn_fold_kernel(const float* __restrict__ part, float* __restrict__ stats, int n,
                               int groups, int h, int rows, int max_seg) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n * groups) return;
  const int sample = i / groups, grp = i % groups;
  const long long t_lo = static_cast<long long>(sample) * h / rows;
  const long long t_hi = (static_cast<long long>(sample + 1) * h - 1) / rows;
  float sum = 0.f, sq = 0.f;
  for (long long t = t_lo; t <= t_hi; ++t) {
    const int seg = sample - static_cast<int>(t * rows / h);
    const float* st = part + ((t * max_seg + seg) * groups + grp) * 2;
    sum += st[0];
    sq += st[1];
  }
  stats[i * 2LL] = sum;
  stats[i * 2LL + 1] = sq;
}

// One block per (sample, group): the sum and the sum of squares of its
// contiguous run of `run` elements (a multiple of 8), to stats[block][2].
__global__ void __launch_bounds__(256)
    gn_sums_kernel(const bf16* __restrict__ x, float* __restrict__ stats, int run) {
  constexpr int kT = 256;
  __shared__ float red[2][kT / 32];
  const bf16* base = x + static_cast<long long>(blockIdx.x) * run;
  float s = 0.f, q = 0.f;
  for (int i = threadIdx.x * 8; i < run; i += kT * 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(base + i);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float f = __bfloat162float(e[j]);
      s += f;
      q += f * f;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffff, s, off);
    q += __shfl_xor_sync(0xffffffff, q, off);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    red[0][warp] = s;
    red[1][warp] = q;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    s = q = 0.f;
    for (int i = 0; i < kT / 32; ++i) {
      s += red[0][i];
      q += red[1][i];
    }
    stats[blockIdx.x * 2LL] = s;
    stats[blockIdx.x * 2LL + 1] = q;
  }
}

struct ConvArgs {
  const bf16* in;        // (N, C, H, W): x for conv1, h for conv2
  const float* stats;    // (N, G, 2) sums of `in`
  const void* gamma;     // (C) of the norm in front of the conv
  const void* beta;
  const void* bias;      // (C)
  const void* temb;      // (N, C), conv1 only
  const bf16* residual;  // (N, C, H, W), conv2 only
  bf16* out;             // (N, C, H, W)
  float* out_stats;      // (tiles, max_seg, G, 2), conv1 only
  int n, c, h, w_, cpg, groups, rows, max_seg, slots, stages, params_bf16, temb_bf16;
  float eps;
};

// grid: (M tiles, C / (160 * kHalves))
template <bool kFirst, int kHalves>
__global__ void __launch_bounds__(kThreads, 1)
    conv_kernel(const __grid_constant__ CUtensorMap tm_w, const ConvArgs a) {
  constexpr int kStage = kHalves * kBTile;  // bytes of one weight stage
  extern __shared__ unsigned char smem_raw[];
  __shared__ long long s_off[kMaxStagedRows];  // a staged row's offset in `in` at channel 0, or -1
  __shared__ int s_seg[kMaxStagedRows];        // and the tile's sample it belongs to
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int C = a.c, H = a.h, W = a.w_, R = a.rows, wp = W + 2, S = a.stages;
  const int a_elems = a.slots * kARow;  // one A buffer
  unsigned char* s_b = smem;                                    // [S][halves][160 rows][128 B]
  bf16* s_a = reinterpret_cast<bf16*>(smem + S * kStage);       // [2][slots][kARow]
  uint64_t* bars = reinterpret_cast<uint64_t*>(s_a + 2 * a_elems);
  uint64_t* full = bars;
  uint64_t* empty = bars + kMaxStages;
  uint64_t* a_full = bars + 2 * kMaxStages;
  uint64_t* a_empty = a_full + 2;
  float* s_gamma = reinterpret_cast<float*>(bars + 2 * kMaxStages + 4);
  float* s_beta = s_gamma + C;
  float* s_mean = s_beta + C;  // [segment][group]
  float* s_rstd = s_mean + a.max_seg * a.groups;
  float* s_out = reinterpret_cast<float*>(smem);  // [kBN][kOutStride], after the main loop

  const int tid = threadIdx.x;
  const long long tile = blockIdx.x;
  const int co0 = blockIdx.y * kHalves * kBN;
  const long long g0 = tile * R;  // first image row of the tile in the flattened N * H rows
  const int valid_rows = static_cast<int>(min_ll(R, static_cast<long long>(a.n) * H - g0));
  const int n0 = static_cast<int>(g0 / H);
  const int nseg = static_cast<int>((g0 + valid_rows - 1) / H) - n0 + 1;
  const int staged = valid_rows + 2 * nseg;
  const long long hw = static_cast<long long>(H) * W;
  // Segment s: the tile's rows of sample n0 + s, [seg_lo, seg_hi) within the tile.
  auto seg_lo = [&](int s) {
    return static_cast<int>(max_ll(g0, static_cast<long long>(n0 + s) * H) - g0);
  };
  auto seg_hi = [&](int s) {
    return static_cast<int>(min_ll(g0 + valid_rows, static_cast<long long>(n0 + s + 1) * H) - g0);
  };

  const int chunks = C / kKC;
  // Weight stage it is (input-channel chunk it / 9, tap it % 9).
  auto issue_weights = [&](int it) {
    const int s = it % S;
    mbar_arrive_expect_tx(&full[s], kStage);
#pragma unroll
    for (int h = 0; h < kHalves; ++h)
      tma_load_3d(s_b + s * kStage + h * kBTile, &tm_w, &full[s], (it / 9) * kKC,
                  co0 + h * kBN, it % 9);
  };
  if (tid == 0) {
    for (int s = 0; s < kMaxStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kConsumers);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&a_full[b], kTransformThreads);
      mbar_init(&a_empty[b], 4 * kConsumers);
    }
    fence_mbar_init();
    // The first weight stages are on their way while the rest of the block sets up.
    for (int it = 0; it < S && it < chunks * 9; ++it) issue_weights(it);
  }
  for (int i = tid; i < C; i += kThreads) {
    s_gamma[i] = load_param(a.gamma, i, a.params_bf16);
    s_beta[i] = load_param(a.beta, i, a.params_bf16);
  }
  // The norm's statistics for each sample of the tile.
  const float count = static_cast<float>(a.cpg) * static_cast<float>(hw);
  for (int i = tid; i < nseg * a.groups; i += kThreads) {
    const int s = i / a.groups, grp = i % a.groups;
    const float* st = a.stats + (static_cast<long long>(n0 + s) * a.groups + grp) * 2;
    const float mean = st[0] / count;
    s_mean[i] = mean;
    s_rstd[i] = rsqrtf(fmaxf(st[1] / count - mean * mean, 0.f) + a.eps);
  }
  // Staged rows: each sample's rows of the tile with one halo row above and
  // below, which is an image row where the sample goes on and zeros at its edge.
  for (int sr = tid; sr < staged; sr += kThreads) {
    long long off_in = -1;
    int seg = 0;
    for (int s = 0; s < nseg; ++s) {
      const int off = seg_lo(s) + 2 * s;
      if (sr >= off && sr < off + seg_hi(s) - seg_lo(s) + 2) {
        const long long y = g0 + seg_lo(s) - static_cast<long long>(n0 + s) * H - 1 + (sr - off);
        off_in = y >= 0 && y < H ? static_cast<long long>(n0 + s) * C * hw + y * W : -1;
        seg = s;
      }
    }
    s_off[sr] = off_in;
    s_seg[sr] = seg;
  }
  // The halo columns of both A buffers, zeroed once: the staging writes
  // columns 1..W of the staged rows, and a stored pixel reads no other row.
  constexpr int kSlotChunks = kARow / 8;  // 16-byte pieces of a slot
  for (int i = tid; i < 2 * staged * 2 * kSlotChunks; i += kThreads) {
    const int piece = i % kSlotChunks, side = (i / kSlotChunks) % 2;
    const int sr = (i / kSlotChunks / 2) % staged, buf = i / kSlotChunks / 2 / staged;
    reinterpret_cast<uint4*>(s_a + buf * a_elems + (sr * wp + side * (W + 1)) * kARow)[piece] =
        make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg < kProducers) {
    setmaxnreg_dec<Split<kHalves>::kProducerRegs>();
    if (tid == 0) {
      for (int it = S; it < chunks * 9; ++it) {
        mbar_wait(&empty[it % S], ((it / S) - 1) & 1);
        issue_weights(it);
      }
    } else if (tid >= 32) {
      // Stage A. A thread keeps one pair of channels (kTransformThreads is a
      // multiple of 32); an item is 8 pixels of one staged row in both. A
      // thread loads kUnroll items before it converts any, so that enough
      // bytes are in flight to cover the latency of device memory.
      constexpr int kUnroll = Split<kHalves>::kUnroll;
      const int tt = tid - 32;
      const int cp = tt % 32;
      const int gshift = __ffs(W / 8) - 1;  // W / 8 is a power of two
      const int row_items = staged << gshift;
      for (int kc = 0; kc < chunks; ++kc) {
        const int buf = kc & 1;
        const int c = kc * kKC + 2 * cp;
        const int j0 = c / a.cpg, j1 = (c + 1) / a.cpg;
        const float ga0 = s_gamma[c], ga1 = s_gamma[c + 1], be0 = s_beta[c], be1 = s_beta[c + 1];
        const bf16* in_c = a.in + static_cast<long long>(c) * hw;
        if (kc >= 2) mbar_wait(&a_empty[buf], ((kc >> 1) - 1) & 1);
        bf16* base = s_a + buf * a_elems + 1 * kARow + 2 * cp;
        for (int q0 = tt / 32; q0 < row_items; q0 += kUnroll * kXformWarps) {
          uint4 v[kUnroll][2];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int q = q0 + u * kXformWarps;
            const long long off = q < row_items ? s_off[q >> gshift] : -1;
            if (off >= 0) {
              const bf16* p = in_c + off + (q & ((1 << gshift) - 1)) * 8;
              v[u][0] = *reinterpret_cast<const uint4*>(p);
              v[u][1] = *reinterpret_cast<const uint4*>(p + hw);
            }
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int q = q0 + u * kXformWarps;
            if (q < row_items) {
              const int sr = q >> gshift;
              uint32_t* dst = reinterpret_cast<uint32_t*>(
                  base + (sr * wp + (q & ((1 << gshift) - 1)) * 8) * kARow);
              if (s_off[sr] >= 0) {
                const bf16* e0 = reinterpret_cast<const bf16*>(&v[u][0]);
                const bf16* e1 = reinterpret_cast<const bf16*>(&v[u][1]);
                const int st = s_seg[sr] * a.groups;
                const float a0 = s_rstd[st + j0] * ga0, b0 = be0 - s_mean[st + j0] * a0;
                const float a1 = s_rstd[st + j1] * ga1, b1 = be1 - s_mean[st + j1] * a1;
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                  dst[j * (kARow / 2)] = pack_bf16x2(silu(a0 * __bfloat162float(e0[j]) + b0),
                                                     silu(a1 * __bfloat162float(e1[j]) + b1));
                }
              } else {
#pragma unroll
                for (int j = 0; j < 8; ++j) dst[j * (kARow / 2)] = 0u;
              }
            }
          }
        }
        mbar_arrive(&a_full[buf]);
      }
    }
    return;
  }
  setmaxnreg_inc<Split<kHalves>::kConsumerRegs>();

  // Consumer warpgroup cw: pixels 64 cw .. 64 cw + 63 of the tile, all the
  // block's output channels.
  const int cw = wg - kProducers;
  const int t = tid % 128;
  const int warp = t / 32, lane = t % 32;
  const int g = lane / 4, tq = lane % 4;
  // The A buffer row that this lane hands to ldmatrix at the centre tap; a tap
  // shifts it. A pixel past the call's last row reads any row: it is not stored.
  int slot = wp + 1;
  {
    const int p = cw * 64 + warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
    const int r = p / W;
    if (r < valid_rows) {
      const int s = static_cast<int>((g0 + r) / H) - n0;
      slot = (r + 2 * s + 1) * wp + p % W + 1;
    }
  }
  const bf16* a_lane = s_a + slot * kARow + (lane / 16) * 8;
  const uint32_t b_addr = smem_addr(s_b);

  float acc[kHalves][kBN / 2];
#pragma unroll
  for (int h = 0; h < kHalves; ++h)
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[h][i] = 0.f;
  // A of the taps whose products may be in flight: with one half, the product
  // of a tap runs while the next tap's A is loaded; with two, each tap's
  // products are long enough that the other consumer's keep the cores busy.
  constexpr int kSets = kHalves == 1 ? 3 : 1;
  constexpr int kInFlight = kHalves == 1 ? 1 : 0;
  uint32_t af[kSets][4][4];
  auto fence_regs = [&]() {
#pragma unroll
    for (int h = 0; h < kHalves; ++h) reg_fence(acc[h]);
#pragma unroll
    for (int k = 0; k < kSets; ++k) reg_fence(af[k]);
  };
  // A stage's weight tiles, and at a chunk's last tap its A buffer, are free.
  auto release = [&](int it) {
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(&empty[it % S]);
      if (it % 9 == 8) mbar_arrive(&a_empty[(it / 9) & 1]);
    }
  };
  int it = 0;
  for (int kc = 0; kc < chunks; ++kc) {
    const bf16* abuf = a_lane + (kc & 1) * a_elems;
    mbar_wait(&a_full[kc & 1], (kc >> 1) & 1);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap, ++it) {
      const int toff = ((tap / 3 - 1) * wp + (tap % 3 - 1)) * kARow;
      const int s = it % S;
      mbar_wait(&full[s], (it / S) & 1);
#pragma unroll
      for (int kk = 0; kk < kKC / 16; ++kk)
        ldmatrix_x4(af[tap % kSets][kk], abuf + toff + kk * 16);
      fence_regs();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKC / 16; ++kk)
#pragma unroll
        for (int h = 0; h < kHalves; ++h)
          wgmma_m64n160k16_rs_k(acc[h], af[tap % kSets][kk],
                                sw128_desc(b_addr + s * kStage + h * kBTile + kk * 32, 16, 1024),
                                1);
      wgmma_commit();
      wgmma_wait<kInFlight>();
      fence_regs();
      if (it >= kInFlight) release(it - kInFlight);
    }
  }
  wgmma_wait<0>();
  fence_regs();

  const int ct = tid - 128 * kProducers;
  const int cwarp = ct / 32;
#pragma unroll
  for (int h = 0; h < kHalves; ++h) {
    // Every consumer is done with the ring and the A buffers (their last
    // writers finished before the consumers could read), or with the last
    // half's tile: the f32 tile of this half takes their place.
    named_barrier_sync(1, 128 * kConsumers);
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) {
      const int col = 8 * (i / 4) + 2 * tq + (i % 2);
      const int row = cw * 64 + warp * 16 + g + 8 * ((i % 4) / 2);
      s_out[col * kOutStride + row] = acc[h][i];
    }
    named_barrier_sync(1, 128 * kConsumers);
    const int cob = co0 + h * kBN;

    // Channel by channel, 8 pixels of one image row an item: add, round,
    // store. A thread's kItems items fetch their operands first, so that the
    // latencies of those loads overlap.
    constexpr int kItems = kBN * (kTileM / 8) / (128 * kConsumers);  // exact: 10
    long long off[kItems];
    float add[kItems];
    uint4 rx[kItems];
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const int i = ct + u * 128 * kConsumers;
      const int co_l = i / (kTileM / 8), p0 = (i % (kTileM / 8)) * 8, r = p0 / W;
      off[u] = -1;
      if (r < valid_rows) {
        const long long gr = g0 + r;
        const long long n = gr / H, y = gr % H;
        const int co = cob + co_l;
        add[u] = load_param(a.bias, co, a.params_bf16);
        if (kFirst) add[u] += load_param(a.temb, n * C + co, a.temb_bf16);
        off[u] = ((n * C + co) * H + y) * W + p0 % W;
        if (!kFirst) rx[u] = *reinterpret_cast<const uint4*>(a.residual + off[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      if (off[u] >= 0) {
        const int i = ct + u * 128 * kConsumers;
        float* srow = s_out + (i / (kTileM / 8)) * kOutStride + (i % (kTileM / 8)) * 8;
        float v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = srow[j] + add[u];
        if (!kFirst) {
          const bf16* e = reinterpret_cast<const bf16*>(&rx[u]);
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] += __bfloat162float(e[j]);
        }
        uint4 o;
        o.x = pack_bf16x2(v[0], v[1]);
        o.y = pack_bf16x2(v[2], v[3]);
        o.z = pack_bf16x2(v[4], v[5]);
        o.w = pack_bf16x2(v[6], v[7]);
        *reinterpret_cast<uint4*>(a.out + off[u]) = o;
        if (kFirst) {
#pragma unroll
          for (int j = 0; j < 8; ++j) srow[j] = round_bf16(v[j]);
        }
      }
    }

    if (kFirst) {
      // The sums of the rounded h per (sample of the tile, group), a warp an item.
      named_barrier_sync(1, 128 * kConsumers);
      const int local_groups = kBN / a.cpg;
      for (int item = cwarp; item < local_groups * nseg; item += 4 * kConsumers) {
        const int gl = item / nseg, s = item % nseg;
        const int px0 = seg_lo(s) * W;
        const int npx = (seg_hi(s) - seg_lo(s)) * W;
        const float* src = s_out + gl * a.cpg * kOutStride + px0;
        float sum = 0.f, sq = 0.f;
        for (int i = lane; i < a.cpg * npx; i += 32) {
          const float v = src[(i / npx) * kOutStride + i % npx];
          sum += v;
          sq += v * v;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          sum += __shfl_xor_sync(0xffffffff, sum, off);
          sq += __shfl_xor_sync(0xffffffff, sq, off);
        }
        if (lane == 0) {
          float* st = a.out_stats +
                      ((tile * a.max_seg + s) * a.groups + cob / a.cpg + gl) * 2;
          st[0] = sum;
          st[1] = sq;
        }
      }
    }
  }
}

template <bool kFirst, int kHalves>
cudaError_t launch_conv(const ConvArgs& a, const Plan& p, const void* wr, cudaStream_t stream) {
  CUtensorMap tm;
  cudaError_t err = encode_tensor_map(&tm, wr, a.c, a.c, 9, kKC, kBN);
  if (err != cudaSuccess) return err;
  auto kernel = conv_kernel<kFirst, kHalves>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(static_cast<unsigned>(p.tiles), a.c / (kHalves * kBN)), kThreads, p.smem,
           stream>>>(tm, a);
  return cudaGetLastError();
}

template <bool kFirst>
cudaError_t launch_conv(const ConvArgs& a, const Plan& p, const void* wr, cudaStream_t stream) {
  return p.halves == 2 ? launch_conv<kFirst, 2>(a, p, wr, stream)
                       : launch_conv<kFirst, 1>(a, p, wr, stream);
}

}  // namespace
}  // namespace ctrlv

// One conv weight from nn.Conv2d's (c, c, 3, 3) to (9, c, c) = [tap][c_out][c_in],
// the layout the convolutions read by TMA. Both bf16, contiguous, on the current
// device. Returns a cudaError_t.
extern "C" int ctrlv_resblock_relayout(const void* w, void* wr, int c, void* stream) {
  using namespace ctrlv;
  if (c < 1 || c > 46340) return cudaErrorInvalidValue;
  const int cc = c * c;
  relayout_kernel<<<(cc + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(w), static_cast<bf16*>(wr), cc);
  return cudaGetLastError();
}

// x, y and the scratch h: (n, c, height, width) bf16; wr1, wr2: the two conv
// weights re-laid by ctrlv_resblock_relayout, (9, c, c) bf16; g1, b1, wb1, g2,
// b2, wb2: (c), all bf16 or all f32; temb: (n, c) bf16 or f32. Scratch:
// stats1 (n, groups, 2) f32; stats2 (tiles, max_seg, groups, 2) f32 with tiles
// and max_seg as make_plan has them. All contiguous on the current device, the
// weights 16-byte aligned. c a multiple of 320 whose group size divides 160;
// width a multiple of 8 that divides 128. Returns a cudaError_t.
extern "C" int ctrlv_resblock_fwd(const void* x, const void* g1, const void* b1, const void* wr1,
                                  const void* wb1, const void* temb, const void* g2,
                                  const void* b2, const void* wr2, const void* wb2, void* y,
                                  void* h, void* stats1, void* stats2, int n, int c, int height,
                                  int width, int groups, int params_bf16, int temb_bf16,
                                  float eps, void* stream) {
  using namespace ctrlv;
  if (n < 1 || c < 1 || height < 1 || width < 8 || groups < 1) return cudaErrorInvalidValue;
  if (c % kBN || c % kKC || c % groups || kBN % (c / groups) || width % 8 || kTileM % width)
    return cudaErrorInvalidValue;
  if (static_cast<long long>(n) * c * height * width >= (1LL << 31)) return cudaErrorInvalidValue;
  const Plan p = make_plan(n, c, height, width, groups);
  if (p.stages == 0 || p.rows + 2 * p.max_seg > kMaxStagedRows || p.tiles > 0x7fffffff)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const int cpg = c / groups;
  gn_sums_kernel<<<n * groups, 256, 0, st>>>(static_cast<const bf16*>(x),
                                             static_cast<float*>(stats1), cpg * height * width);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  ConvArgs a;
  a.n = n;
  a.c = c;
  a.h = height;
  a.w_ = width;
  a.cpg = cpg;
  a.groups = groups;
  a.rows = p.rows;
  a.max_seg = p.max_seg;
  a.slots = p.slots;
  a.stages = p.stages;
  a.params_bf16 = params_bf16;
  a.temb_bf16 = temb_bf16;
  a.eps = eps;

  a.in = static_cast<const bf16*>(x);
  a.stats = static_cast<const float*>(stats1);
  a.gamma = g1;
  a.beta = b1;
  a.bias = wb1;
  a.temb = temb;
  a.residual = nullptr;
  a.out = static_cast<bf16*>(h);
  a.out_stats = static_cast<float*>(stats2);
  err = launch_conv<true>(a, p, wr1, st);
  if (err != cudaSuccess) return err;

  // GN2's sums go where GN1's were: conv1, the only reader of those, is done.
  gn_fold_kernel<<<(n * groups + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(stats2), static_cast<float*>(stats1), n, groups, height, p.rows,
      p.max_seg);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  a.in = static_cast<const bf16*>(h);
  a.stats = static_cast<const float*>(stats1);
  a.gamma = g2;
  a.beta = b2;
  a.bias = wb2;
  a.temb = nullptr;
  a.residual = static_cast<const bf16*>(x);
  a.out = static_cast<bf16*>(y);
  a.out_stats = nullptr;
  return launch_conv<false>(a, p, wr2, st);
}
