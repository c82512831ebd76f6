// K6 at C = 1280: the fused GEGLU feed-forward of the 1280-wide levels, bf16
// in and out:
//   [a|g] = x W1^T + b1,  act = a * gelu_erf(g),  y = act W2^T + b2.
// Replaces the Pallas kernel ctrlv_tpu/ops/geglu_ff.py::geglu_ff (_ff_body)
// where its _plan tiles C_in = C_out = 1280 (inner 5120); geglu_ff_ln takes
// the LayerNorm first, by layer_norm.cu (K5) into a scratch tensor (the
// wrapper's, ops/geglu_ff.py). geglu_ff.cu keeps C = 320 and 640.
//
// Arithmetic, as the TPU kernel has it: both halves of the first product
// accumulate in f32, take the bias in f32 and are rounded to bf16; the gelu is
// the erf form on f32 internals, rounded to bf16; a * gelu(g) is rounded to
// bf16; the second product keeps one f32 accumulator over all of `inner`,
// takes its bias in f32 and is rounded once.
//
// Why two kernels here and one back-to-back GEMM at C = 320 and 640: y's f32
// accumulator for 64 rows is 64 x 1280 x 4 = 320 KB, more than a warpgroup's
// registers and more than a block's shared memory. And at this width act costs
// little in device memory: at M = 8000 it is 82 MB written and read once,
// about 0.05 ms at 3.35 TB/s, against 0.318 ms of tensor work (6 M C inner
// operations at 989 TFLOP/s). So act goes through device memory:
//   - the gate kernel: act = a * gelu(g) over tiles of 128 rows x 128 inner
//     columns, a and g of the same columns from the same x tile (K = C);
//     bias, roundings and gelu in the epilogue, act stored as bf16;
//   - the out kernel: y = act W2^T + b2 over tiles of 128 rows x 160 columns
//     of y (K = inner), bias in the epilogue. 160 columns make 8 tiles across
//     y, so that M = 2000 (the mid block of a Box2Video step) gives 128 tiles
//     for the 132 SMs.
// Both products are this file's: no library GEMM.
//
// Design, both kernels: a persistent grid (one block an SM, at most as many
// as tiles) whose blocks walk the tiles, the tile's columns fastest, so that
// the blocks at work at once share the rows of A (x or act: read about once
// from device memory) and stream the weights from L2. A block of three
// warpgroups, warp-specialised as in geglu_ff.cu:
//   - the producer warpgroup gives its registers back (setmaxnreg) and one
//     thread issues every copy by TMA into 128-byte-swizzled tiles, one
//     64-column K slab of A (128 rows) and of B (the weight rows of the tile)
//     a stage of a ring ("full": TMA bytes, "empty": an arrival per consumer
//     warp); the weights carry an evict_last L2 hint. The ring carries over
//     from one tile to the next, so the next tile's slabs arrive during the
//     epilogue;
//   - two consumer warpgroups, 64 rows of the tile each, run one SS wgmma
//     per k16 of a slab (the gate kernel two: m64n128 for a, m64n128 for g,
//     into two accumulators whose elements i are the same row and column, so
//     a column's a and g are in the same thread's registers; the out kernel
//     one m64n160), wait for the slab before last and release its stage;
//   - epilogue from registers: each thread stores its pairs of columns of
//     its rows as bf16x2, rows past M not at all (they arrived as zeros from
//     TMA and were computed on, harmlessly), and the gate kernel's columns
//     past inner neither (inner % 128 == 64 leaves half a tile).
// No float atomics: two runs on the same input agree to the bit.
//
// What bounds it on an H100: the tensor cores (0.318 ms at (8000, 1280)). A
// slab of the gate kernel is 2*128*256*64 operations on 48 KB from L2 (87 a
// byte), of the out kernel 2*128*160*64 on 36 KB (71 a byte); the gate's erf
// gelu (16384 a tile) runs in the epilogue, not beside the products.
//
// The gate (ops/geglu_ff.py::_plan): C_in = C_out = 1280, inner a multiple of
// 64, any M >= 1. ops/geglu_ff.py::_WIDE mirrors the tile constants below.
#include "hopper_utils.cuh"

#include <math.h>

namespace ctrlv {
namespace {

constexpr int kRowBytes = 128;  // a 128-byte swizzled row: 64 bf16
constexpr int kThreads = 384;   // the producer warpgroup and two consumer warpgroups
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
static_assert(128 * (kProducerRegs + 2 * kConsumerRegs) <= 65536,
              "setmaxnreg: more registers than an SM has");
constexpr int kWideC = 1280;  // the width this file takes
constexpr int kBM = 128;      // rows of a tile: 64 a consumer warpgroup
constexpr int kBK = 64;       // K columns of a stage: one swizzled row

// A kernel's tile: kGate, the gate kernel (else the out kernel); kBN, the
// tile's output columns (the gate: inner columns of act, each from a and g).
template <bool kGate_, int kBN_, int kStages_>
struct Wide {
  static constexpr bool kGate = kGate_;
  static constexpr int kBN = kBN_, kStages = kStages_;
  static constexpr int kBRows = kGate ? 2 * kBN : kBN;  // weight rows a stage: a's, then g's
  static constexpr int kAStage = kBM * kRowBytes;
  static constexpr int kStage = kAStage + kBRows * kRowBytes;
  static constexpr int kAcc = kBN / 2;  // f32 accumulator registers of an m64nN product
  // the ring and its barriers, with 1024 bytes of slack to align the stages to
  // the swizzle atom
  static constexpr int kSmem = 1024 + kStages * kStage + 8 * 2 * kStages;
  static_assert(kSmem <= 232448, "more shared memory than a block has");
  static_assert(kGate ? kBN == 128 : kBN == 160, "the products are m64n128 and m64n160");
  static_assert(kStage % 1024 == 0, "stages on swizzle atoms");
};

// Wide<gate, tile columns, stages>, mirrored in ops/geglu_ff.py::_WIDE.
using GateTile = Wide<true, 128, 4>;
using OutTile = Wide<false, 160, 6>;

struct WideArgs {
  const bf16* bias;  // the gate: b1 (2 * n), a's then g's; the out kernel: b2 (n)
  bf16* out;         // (m, n): act or y
  int m, n, k;       // rows, output columns, contraction
  int n_tiles, tiles;
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// a * gelu_erf(g) with the TPU kernel's roundings; a and g are f32 sums plus bias.
__device__ __forceinline__ float geglu_act(float a, float g) {
  const float ab = round_bf16(a);
  const float gb = round_bf16(g);
  const float gelu = round_bf16(0.5f * gb * (1.0f + erff(gb * 0.70710678118654752f)));
  return ab * gelu;  // rounded to bf16 by the caller's pack
}

__device__ __forceinline__ float2 load_bf16x2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <class K>
__global__ void __launch_bounds__(kThreads, 1)
    geglu_ff_wide_kernel(const __grid_constant__ CUtensorMap tm_a,
                         const __grid_constant__ CUtensorMap tm_b, const WideArgs p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + K::kStages * K::kStage);
  uint64_t* empty = full + K::kStages;
  const int k_slabs = p.k / kBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < K::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: one thread issues every copy, in the order the consumers take them.
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      const uint64_t keep = l2_policy<L2Evict::kLast>();
      int it = 0;  // stages issued
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        const int m0 = (tile / p.n_tiles) * kBM, n0 = (tile % p.n_tiles) * K::kBN;
        for (int ks = 0; ks < k_slabs; ++ks, ++it) {
          const int s = it % K::kStages;
          if (it >= K::kStages) mbar_wait(&empty[s], ((it / K::kStages) - 1) & 1);
          unsigned char* st = smem + s * K::kStage;
          mbar_arrive_expect_tx(&full[s], K::kStage);
          tma_load_3d(st, &tm_a, &full[s], ks * kBK, m0, 0);
          tma_load_3d_hint(st + K::kAStage, &tm_b, &full[s], ks * kBK, n0, 0, keep);
          if constexpr (K::kGate)  // g's rows of the same inner columns
            tma_load_3d_hint(st + K::kAStage + K::kBN * kRowBytes, &tm_b, &full[s], ks * kBK,
                             p.n + n0, 0, keep);
        }
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int c = wg - 1;
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32, g = lane / 4, tq = lane % 4;

    // d0: a (gate) or y (out); d1: g. Element i is row 16 warp + g + 8 ((i % 4) / 2),
    // column 8 (i / 4) + 2 tq + i % 2 of this warpgroup's 64 rows of the tile.
    float d0[K::kAcc];
    float d1[K::kGate ? K::kAcc : 1];
#pragma unroll
    for (int i = 0; i < K::kAcc; ++i) d0[i] = 0.f;
#pragma unroll
    for (int i = 0; i < (K::kGate ? K::kAcc : 1); ++i) d1[i] = 0.f;
    auto fence_regs = [&]() {
      reg_fence(d0);
      reg_fence(d1);
    };
    // A stage is free once every consumer warp is done with it.
    auto release = [&](int stage) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage % K::kStages]);
    };

    int it = 0;  // stages consumed
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const int m0 = (tile / p.n_tiles) * kBM, n0 = (tile % p.n_tiles) * K::kBN;
      for (int ks = 0; ks < k_slabs; ++ks, ++it) {
        const int s = it % K::kStages;
        mbar_wait(&full[s], (it / K::kStages) & 1);
        fence_regs();
        wgmma_fence();
        const uint32_t a_addr = smem_addr(smem + s * K::kStage) + 64 * c * kRowBytes;
        const uint32_t b_addr = smem_addr(smem + s * K::kStage + K::kAStage);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t da = sw128_desc(a_addr + kk * 32, 16, 1024);
          if constexpr (K::kGate) {
            wgmma_m64n128k16_ss(d0, da, sw128_desc(b_addr + kk * 32, 16, 1024), ks | kk);
            wgmma_m64n128k16_ss(d1, da,
                                sw128_desc(b_addr + K::kBN * kRowBytes + kk * 32, 16, 1024),
                                ks | kk);
          } else {
            wgmma_m64n160k16_ss(d0, da, sw128_desc(b_addr + kk * 32, 16, 1024), ks | kk);
          }
        }
        wgmma_commit();
        // the slab before this one is done: its stage goes back to the producer
        wgmma_wait<1>();
        fence_regs();
        if (ks > 0) release(it - 1);
      }
      wgmma_wait<0>();
      fence_regs();
      release(it - 1);

      // Epilogue: bias, roundings (and the gate's gelu), bf16 pairs to device memory.
      const int r0 = m0 + 64 * c + 16 * warp + g;
#pragma unroll
      for (int i = 0; i < K::kAcc; i += 2) {
        const int col = n0 + 8 * (i / 4) + 2 * tq;
        const int r = r0 + 8 * ((i % 4) / 2);
        uint32_t v;
        if constexpr (K::kGate) {
          if (col >= p.n) continue;
          const float2 ba = load_bf16x2(p.bias + col), bg = load_bf16x2(p.bias + p.n + col);
          v = pack_bf16x2(geglu_act(d0[i] + ba.x, d1[i] + bg.x),
                          geglu_act(d0[i + 1] + ba.y, d1[i + 1] + bg.y));
        } else {
          const float2 b = load_bf16x2(p.bias + col);
          v = pack_bf16x2(d0[i] + b.x, d0[i + 1] + b.y);
        }
        if (r < p.m)
          *reinterpret_cast<uint32_t*>(p.out + static_cast<size_t>(r) * p.n + col) = v;
      }
    }
  }
}

// One kernel's launch: A (m, k) and the weights B (b_rows, k), both bf16 with
// rows contiguous; out (m, n).
template <class K>
cudaError_t launch(const void* a, const void* b, int b_rows, const bf16* bias, bf16* out, int m,
                   int n, int k, cudaStream_t stream) {
  CUtensorMap tm_a, tm_b;
  cudaError_t err;
  if ((err = encode_tensor_map(&tm_a, a, k, m, 1, kBK, kBM)) != cudaSuccess ||
      (err = encode_tensor_map(&tm_b, b, k, b_rows, 1, kBK, K::kBN)) != cudaSuccess)
    return err;
  auto kernel = geglu_ff_wide_kernel<K>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, K::kSmem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
          cudaSuccess)
    return err;
  const int n_tiles = (n + K::kBN - 1) / K::kBN;
  const int tiles = (m + kBM - 1) / kBM * n_tiles;
  const unsigned blocks = static_cast<unsigned>(tiles < sms ? tiles : sms);
  kernel<<<blocks, kThreads, K::kSmem, stream>>>(tm_a, tm_b,
                                                 WideArgs{bias, out, m, n, k, n_tiles, tiles});
  return cudaGetLastError();
}

}  // namespace
}  // namespace ctrlv

// x: (m, c); w1: (2*inner, c), a's rows then g's; b1: (2*inner); w2: (c, inner);
// b2: (c); act: (m, inner), the scratch between the two kernels; y: (m, c); all
// contiguous bf16 on the current device, 16-byte aligned, c = 1280, inner a
// multiple of 64. Launches the gate kernel, then the out kernel, on `stream`.
// Returns a cudaError_t code.
extern "C" int ctrlv_geglu_ff_wide_fwd(const void* x, const void* w1, const void* b1,
                                       const void* w2, const void* b2, void* act, void* y, int m,
                                       int c, int inner, void* stream) {
  using namespace ctrlv;
  if (m < 1 || c != kWideC || inner < 64 || inner % 64) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto* act_p = static_cast<bf16*>(act);
  cudaError_t err = launch<GateTile>(x, w1, 2 * inner, static_cast<const bf16*>(b1), act_p, m,
                                     inner, c, st);
  if (err != cudaSuccess) return err;
  return launch<OutTile>(act, w2, c, static_cast<const bf16*>(b2), static_cast<bf16*>(y), m, c,
                         inner, st);
}
