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
// 0.17 GB that must move (x, y and the two weights once).
//
// Arithmetic, as the TPU kernel has it: per sample, f32 sum and sum of squares
// per group over the whole image, var = E[x^2] - E[x]^2 (clamped at 0),
// a = rsqrt(var + eps) * gamma, b = beta - mean * a, SiLU(a * x + b) rounded to
// bf16; each convolution as nine shifted products with an f32 accumulator
// over 9 * C terms and zeros outside the image; + (bias1 + temb) in f32 and
// ONE rounding to bf16; GN2's statistics from those rounded values;
// + bias2 + x in f32 and one rounding.
//
// Design. The TPU kernel gives one program a whole sample: the (H*W, C)
// activation, both padded intermediates and both weight stacks sit in VMEM. A
// Hopper block has 227 KB, a sample alone is 1.6 MB, so the work is cut across
// blocks, a GroupNorm's statistics cross blocks, and h goes through device
// memory (it stays in the 50 MB L2 where it fits). One call is five launches:
//   1. relayout: both weights from nn.Conv2d's (C_out, C_in, 3, 3), whose tap
//      is innermost, to (9, C_out, C_in): per tap the reduction axis is then
//      contiguous, the "col-major B" of mma.sync. The copy is made anew on
//      every call (3.7 MB at C = 320, a few microseconds), so it is never stale
//      when the weights train.
//   2. GN1's sums: one block per (sample, group), which in NCHW is one
//      contiguous run.
//   3. conv1: a block owns 128 output pixels (whole image rows) x 160 output
//      channels, f32 accumulators in registers (8 warps as 4 x 2, each 32
//      pixels x 80 channels). The reduction axis is walked in chunks of 64
//      input channels: the chunk's rows with one row of halo above and below
//      are read from NCHW (contiguous along the pixels), normalised, SiLU'd,
//      rounded and written to shared memory pixel-major with a zero column
//      left and right, so that a tap is a shift of the row address that
//      ldmatrix reads and the image border needs no mask. No NHWC copy of an
//      activation exists in device memory. Per tap the (160 x 64) weight tile
//      streams in with cp.async, double-buffered. 128 registers and 87 KB of
//      shared memory a block, so two blocks share an SM and one's staging
//      overlaps the other's products. The epilogue goes through shared memory
//      so that the NCHW stores are 16-byte and coalesced, and adds the tile's
//      per-group sums of the ROUNDED h to scratch.
//   4. conv2: the same kernel on h; GN2's affine is folded from the tiles'
//      partial sums, added in a fixed order by every block; the epilogue adds
//      bias2 and x.
// No float atomics: two runs on the same input agree to the bit. Image rows
// past H in the last tile are zero on load, masked on store and add nothing
// to the sums.
#include "mma_utils.cuh"

namespace ctrlv {
namespace {

constexpr int kThreads = 256;
constexpr int kTilePix = 128;             // output pixels of a block
constexpr int kCoutBlk = 160;             // output channels of a block
constexpr int kKC = 64;                   // input channels of a chunk
constexpr int kSRow = kKC + 8;            // bf16 row stride of the input and weight tiles
constexpr int kOutStride = kTilePix + 4;  // f32 row stride of the epilogue tile
constexpr int kWarpN = kCoutBlk / 2;      // output channels of a warp

__host__ __device__ inline int in_slots(int width) {
  return (kTilePix / width + 2) * (width + 2);
}

// Bytes of the region that holds the input and weight tiles during the main
// loop and the f32 output tile after it.
__host__ __device__ inline int union_bytes(int width) {
  const int loop = (in_slots(width) + 2 * kCoutBlk) * kSRow * static_cast<int>(sizeof(bf16));
  const int out = kCoutBlk * kOutStride * static_cast<int>(sizeof(float));
  return loop > out ? loop : out;
}

__device__ __forceinline__ float load_param(const void* p, long long i, int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const bf16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ float silu(float v) { return v / (1.f + __expf(-v)); }

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

// One block per (sample, group): the sum and the sum of squares of its
// contiguous run of `run` elements (a multiple of 8), to stats[block][2].
__global__ void __launch_bounds__(kThreads)
    gn_sums_kernel(const bf16* __restrict__ x, float* __restrict__ stats, int run) {
  __shared__ float red[2][kThreads / 32];
  const bf16* base = x + static_cast<long long>(blockIdx.x) * run;
  float s = 0.f, q = 0.f;
  for (int i = threadIdx.x * 8; i < run; i += kThreads * 8) {
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
    for (int i = 0; i < kThreads / 32; ++i) {
      s += red[0][i];
      q += red[1][i];
    }
    stats[blockIdx.x * 2LL] = s;
    stats[blockIdx.x * 2LL + 1] = q;
  }
}

struct ConvArgs {
  const bf16* in;        // (N, C, H, W): x for conv1, h for conv2
  const float* stats;    // (N, parts, G, 2): partial sums of `in`
  const void* gamma;     // (C) of the norm in front of the conv
  const void* beta;
  const bf16* w;         // (9, C, C): [tap][c_out][c_in]
  const void* bias;      // (C)
  const void* temb;      // (N, C), conv1 only
  const bf16* residual;  // (N, C, H, W), conv2 only
  bf16* out;             // (N, C, H, W)
  float* out_stats;      // (N, tiles, G, 2), conv1 only
  int parts, c, h, w_, cpg, groups, params_bf16, temb_bf16;
  float eps;
};

// grid: (C / 160, tiles of 128 / W image rows, N)
template <bool kFirst>
__global__ void __launch_bounds__(kThreads, 2) conv_kernel(const ConvArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int C = a.c, H = a.h, W = a.w_;
  const int rows = kTilePix / W;  // image rows of a tile
  const int wp = W + 2;           // row length with the two zero columns
  const int slots = (rows + 2) * wp;
  bf16* s_in = reinterpret_cast<bf16*>(smem_raw);                       // [slots][kSRow]
  bf16* s_w = s_in + slots * kSRow;                                     // [2][kCoutBlk][kSRow]
  float* s_out = reinterpret_cast<float*>(smem_raw);                    // [kCoutBlk][kOutStride]
  float* s_a = reinterpret_cast<float*>(smem_raw + union_bytes(W));     // [C] scale
  float* s_b = s_a + C;                                                 // [C] shift

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;  // 32 pixels x 80 channels a warp
  const int g = lane / 4, t = lane % 4;
  const int co0 = blockIdx.x * kCoutBlk;
  const int tile = blockIdx.y;
  const int n = blockIdx.z;
  const int y0 = tile * rows;
  const long long hw = static_cast<long long>(H) * W;

  // The norm's affine per input channel, from the partial sums in a fixed order.
  const float count = static_cast<float>(a.cpg) * static_cast<float>(hw);
  for (int c = tid; c < C; c += kThreads) {
    const int grp = c / a.cpg;
    float s = 0.f, q = 0.f;
    for (int p = 0; p < a.parts; ++p) {
      const float* st = a.stats + ((static_cast<long long>(n) * a.parts + p) * a.groups + grp) * 2;
      s += st[0];
      q += st[1];
    }
    const float mean = s / count;
    const float rstd = rsqrtf(fmaxf(q / count - mean * mean, 0.f) + a.eps);
    const float scale = rstd * load_param(a.gamma, c, a.params_bf16);
    s_a[c] = scale;
    s_b[c] = load_param(a.beta, c, a.params_bf16) - mean * scale;
  }
  // Zero the input tile once: the staging below never writes the halo columns.
  for (int i = tid; i < slots * kSRow / 8; i += kThreads)
    reinterpret_cast<uint4*>(s_in)[i] = make_uint4(0u, 0u, 0u, 0u);

  float acc[2][kWarpN / 8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < kWarpN / 8; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  // The row of the input tile that this lane hands to ldmatrix for each of its
  // warp's two 16-pixel tiles, at the centre tap; a tap shifts it.
  int slot[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int p = wm * 32 + mt * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
    slot[mt] = (p / W + 1) * wp + (p % W) + 1;
  }
  const int a_col = (lane / 16) * 8;
  const int b_row = (lane % 8) + (lane / 16) * 8;
  const int b_col = ((lane / 8) % 2) * 8;

  const int total = (C / kKC) * 9;
  auto load_weights = [&](int it) {
    const int kc = it / 9, tap = it % 9;
    load_tile_async<kCoutBlk, kKC, kSRow>(
        s_w + (it & 1) * kCoutBlk * kSRow,
        a.w + (static_cast<long long>(tap) * C + co0) * C + kc * kKC, C, 0, kCoutBlk, tid,
        kThreads);
    cp_async_commit();
  };
  load_weights(0);

  const int gpr = W / 8;  // groups of 8 pixels in an image row
  const int items = 32 * (rows + 2) * gpr;
  for (int it = 0; it < total; ++it) {
    const int kc = it / 9, tap = it % 9;
    // This tap's weights have landed, and every warp is past the tap before:
    // the other weight buffer and, at a new chunk, the input tile are free.
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < total) load_weights(it + 1);
    if (tap == 0) {
      // Stage 64 input channels: an item is 8 pixels of two channels.
      for (int i = tid; i < items; i += kThreads) {
        const int cp = i % 32;
        const int gx = (i / 32) % gpr;
        const int r = (i / 32) / gpr;
        const int yy = y0 - 1 + r;
        const int c = kc * kKC + 2 * cp;
        uint32_t* dst =
            reinterpret_cast<uint32_t*>(s_in + (r * wp + 1 + gx * 8) * kSRow + 2 * cp);
        if (yy >= 0 && yy < H) {
          const bf16* src = a.in + ((static_cast<long long>(n) * C + c) * H + yy) * W + gx * 8;
          const uint4 v0 = *reinterpret_cast<const uint4*>(src);
          const uint4 v1 = *reinterpret_cast<const uint4*>(src + hw);
          const bf16* e0 = reinterpret_cast<const bf16*>(&v0);
          const bf16* e1 = reinterpret_cast<const bf16*>(&v1);
          const float a0 = s_a[c], b0 = s_b[c], a1 = s_a[c + 1], b1 = s_b[c + 1];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            dst[j * (kSRow / 2)] = pack_bf16x2(silu(a0 * __bfloat162float(e0[j]) + b0),
                                               silu(a1 * __bfloat162float(e1[j]) + b1));
          }
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) dst[j * (kSRow / 2)] = 0u;
        }
      }
      __syncthreads();
    }

    const int toff = ((tap / 3 - 1) * wp + (tap % 3 - 1)) * kSRow;
    const bf16* wbuf = s_w + (it & 1) * kCoutBlk * kSRow;
#pragma unroll
    for (int kk = 0; kk < kKC / 16; ++kk) {
      uint32_t af[2][4];
      ldmatrix_x4(af[0], s_in + slot[0] * kSRow + toff + kk * 16 + a_col);
      ldmatrix_x4(af[1], s_in + slot[1] * kSRow + toff + kk * 16 + a_col);
#pragma unroll
      for (int nb = 0; nb < kWarpN / 16; ++nb) {
        uint32_t bfrag[4];
        ldmatrix_x4(bfrag, wbuf + (wn * kWarpN + nb * 16 + b_row) * kSRow + kk * 16 + b_col);
        mma_bf16_16816(acc[0][2 * nb], af[0], bfrag[0], bfrag[1]);
        mma_bf16_16816(acc[0][2 * nb + 1], af[0], bfrag[2], bfrag[3]);
        mma_bf16_16816(acc[1][2 * nb], af[1], bfrag[0], bfrag[1]);
        mma_bf16_16816(acc[1][2 * nb + 1], af[1], bfrag[2], bfrag[3]);
      }
    }
  }
  __syncthreads();  // every warp is done with the tiles: the f32 output tile takes their place

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < kWarpN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int co_l = wn * kWarpN + nt * 8 + 2 * t + (e & 1);
        const int p = wm * 32 + mt * 16 + g + (e >> 1) * 8;
        s_out[co_l * kOutStride + p] = acc[mt][nt][e];
      }
  __syncthreads();

  // Channel by channel, 8 pixels of one image row an item: add, round, store.
  for (int i = tid; i < kCoutBlk * (kTilePix / 8); i += kThreads) {
    const int co_l = i / (kTilePix / 8);
    const int p0 = (i % (kTilePix / 8)) * 8;
    const int yy = y0 + p0 / W;
    float* srow = s_out + co_l * kOutStride + p0;
    if (yy < H) {
      const int co = co0 + co_l;
      float add = load_param(a.bias, co, a.params_bf16);
      if (kFirst) add += load_param(a.temb, static_cast<long long>(n) * C + co, a.temb_bf16);
      const long long off = ((static_cast<long long>(n) * C + co) * H + yy) * W + p0 % W;
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = srow[j] + add;
      if (!kFirst) {
        const uint4 rx = *reinterpret_cast<const uint4*>(a.residual + off);
        const bf16* e = reinterpret_cast<const bf16*>(&rx);
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] += __bfloat162float(e[j]);
      }
      uint4 o;
      o.x = pack_bf16x2(v[0], v[1]);
      o.y = pack_bf16x2(v[2], v[3]);
      o.z = pack_bf16x2(v[4], v[5]);
      o.w = pack_bf16x2(v[6], v[7]);
      *reinterpret_cast<uint4*>(a.out + off) = o;
      if (kFirst) {
#pragma unroll
        for (int j = 0; j < 8; ++j) srow[j] = round_bf16(v[j]);
      }
    } else if (kFirst) {
#pragma unroll
      for (int j = 0; j < 8; ++j) srow[j] = 0.f;
    }
  }

  if (kFirst) {
    // The tile's sums of the rounded h per group, one warp a group.
    __syncthreads();
    const int span = a.cpg * kTilePix;
    for (int gl = warp; gl < kCoutBlk / a.cpg; gl += kThreads / 32) {
      const float* base = s_out + gl * a.cpg * kOutStride;
      float s = 0.f, q = 0.f;
      for (int i = lane; i < span; i += 32) {
        const float v = base[(i / kTilePix) * kOutStride + i % kTilePix];
        s += v;
        q += v * v;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s += __shfl_xor_sync(0xffffffff, s, off);
        q += __shfl_xor_sync(0xffffffff, q, off);
      }
      if (lane == 0) {
        float* st = a.out_stats +
                    ((static_cast<long long>(n) * gridDim.y + tile) * a.groups + co0 / a.cpg + gl) * 2;
        st[0] = s;
        st[1] = q;
      }
    }
  }
}

template <bool kFirst>
cudaError_t launch_conv(const ConvArgs& a, int n, int tiles, cudaStream_t stream) {
  const int smem = union_bytes(a.w_) + 2 * a.c * static_cast<int>(sizeof(float));
  auto kernel = conv_kernel<kFirst>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.c / kCoutBlk, tiles, n), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ctrlv

// x, y and the scratch h: (n, c, height, width) bf16; w1, w2: (c, c, 3, 3) bf16;
// g1, b1, wb1, g2, b2, wb2: (c), all bf16 or all f32; temb: (n, c) bf16 or f32.
// Scratch: wr (2, 9, c, c) bf16; stats1 (n, groups, 2) f32; stats2
// (n, tiles, groups, 2) f32 with tiles = ceil(height / (128 / width)). All
// contiguous on the current device. c a multiple of 320 whose group size
// divides 160; width a multiple of 8 that divides 128. Returns a cudaError_t.
extern "C" int ctrlv_resblock_fwd(const void* x, const void* g1, const void* b1, const void* w1,
                                  const void* wb1, const void* temb, const void* g2,
                                  const void* b2, const void* w2, const void* wb2, void* y,
                                  void* h, void* wr, void* stats1, void* stats2, int n, int c,
                                  int height, int width, int groups, int params_bf16,
                                  int temb_bf16, float eps, void* stream) {
  using namespace ctrlv;
  if (n < 1 || n > 65535 || c < 1 || height < 1 || width < 8 || groups < 1)
    return cudaErrorInvalidValue;
  if (c % kCoutBlk || c % kKC || c % groups || kCoutBlk % (c / groups) || width % 8 ||
      kTilePix % width)
    return cudaErrorInvalidValue;
  const int cpg = c / groups;
  const int rows = kTilePix / width;
  const int tiles = (height + rows - 1) / rows;
  if (tiles > 65535) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const int cc = c * c;
  auto* wr1 = static_cast<bf16*>(wr);
  auto* wr2 = wr1 + 9LL * cc;
  relayout_kernel<<<(cc + 255) / 256, 256, 0, st>>>(static_cast<const bf16*>(w1), wr1, cc);
  relayout_kernel<<<(cc + 255) / 256, 256, 0, st>>>(static_cast<const bf16*>(w2), wr2, cc);
  gn_sums_kernel<<<n * groups, kThreads, 0, st>>>(static_cast<const bf16*>(x),
                                                  static_cast<float*>(stats1),
                                                  cpg * height * width);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  ConvArgs a;
  a.c = c;
  a.h = height;
  a.w_ = width;
  a.cpg = cpg;
  a.groups = groups;
  a.params_bf16 = params_bf16;
  a.temb_bf16 = temb_bf16;
  a.eps = eps;

  a.in = static_cast<const bf16*>(x);
  a.stats = static_cast<const float*>(stats1);
  a.parts = 1;
  a.gamma = g1;
  a.beta = b1;
  a.w = wr1;
  a.bias = wb1;
  a.temb = temb;
  a.residual = nullptr;
  a.out = static_cast<bf16*>(h);
  a.out_stats = static_cast<float*>(stats2);
  err = launch_conv<true>(a, n, tiles, st);
  if (err != cudaSuccess) return err;

  a.in = static_cast<const bf16*>(h);
  a.stats = static_cast<const float*>(stats2);
  a.parts = tiles;
  a.gamma = g2;
  a.beta = b2;
  a.w = wr2;
  a.bias = wb2;
  a.temb = nullptr;
  a.residual = static_cast<const bf16*>(x);
  a.out = static_cast<bf16*>(y);
  a.out_stats = nullptr;
  return launch_conv<false>(a, n, tiles, st);
}
