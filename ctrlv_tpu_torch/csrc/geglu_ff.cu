// K6: the fused GEGLU feed-forward, bf16 in and out:
//   [a|g] = x W1^T + b1,  act = a * gelu_erf(g),  y = act W2^T + b2,
// optionally with a LayerNorm of each row of x in front. Replaces the Pallas
// kernels ctrlv_tpu/ops/geglu_ff.py::geglu_ff and ::geglu_ff_ln (_ff_body,
// _ff_ln_kernel). The (M, 2*inner) intermediate and act never reach device
// memory.
//
// What bounds it on an H100: the tensor cores. At (M, C, inner) =
// (128000, 320, 1280) a call is 6*M*C*inner = 0.31 TFLOP against 0.17 GB
// moved (x, y and the three weight matrices once).
//
// Arithmetic, as the TPU kernel has it: both halves of the first product
// accumulate in f32, take the bias in f32 and are rounded to bf16; the gelu is
// the erf form on f32 internals, rounded to bf16; a * gelu(g) is rounded to
// bf16; the second product keeps one f32 accumulator over all of `inner`, takes
// its bias in f32 and is rounded once.
//
// Design. The TPU kernel walks `inner` on a sequential grid axis with a
// (bm, C) f32 accumulator in 13 MB of VMEM; a Hopper block has 227 KB and no
// order between blocks, so the walk over `inner` is a loop inside the block:
//   - one block owns BM rows of x (held in shared memory for the whole walk)
//     and all C columns of y, whose f32 accumulator lives in registers: the
//     warps form a (BM/16) x WN grid, each with 16 rows and C/WN columns;
//   - `inner` is walked in chunks of JC columns. For a chunk the block streams
//     JC rows of Wa and of Wg (W1 is nn.Linear's (2*inner, C) weight, a in the
//     first half of the rows, read where it lies) and the (C, JC) slice of W2
//     with cp.async. The two weight buffers are single: the W2 slice arrives
//     while the first product runs, the next chunk's Wa|Wg while the second
//     does;
//   - first product: each warp computes a and g for its 16 rows and JC/WN of
//     the chunk's columns (mma.sync m16n8k16 bf16, f32 accumulators), applies
//     bias, rounding and gelu in registers and writes act to shared memory;
//   - second product: each warp multiplies its 16 rows of act by its C/WN
//     rows of the W2 slice into the y accumulator;
//   - rows past M are zero-filled on load and not stored; y leaves through
//     the x tile's shared memory in 16-byte rows.
// Both weights lie with the reduction axis contiguous, which is the
// "col-major B" that mma.sync wants: no transposing load. Shared-memory rows
// are padded by 8 bf16, so the 8 rows an ldmatrix reads fall in different
// banks.
//
// A block at C = 1280 would need a 320 KB accumulator: only C = 320 (64 rows,
// chunks of 64) and C = 640 (32 rows, chunks of 32) are instantiated, and the
// wrapper's gate sends every other width to the unfused path.
#include "mma_utils.cuh"

#include <math.h>

namespace ctrlv {
namespace {

constexpr int kPad = 8;

template <int C, int BM, int WN, int JC>
struct FFConfig {
  static constexpr int WM = BM / 16;
  static constexpr int kThreads = WM * WN * 32;
  static constexpr int SX = C + kPad;    // row stride of the x tile and of Wa|Wg
  static constexpr int SJ = JC + kPad;   // row stride of act and of the W2 slice
  static constexpr int NOUT = C / WN;    // y columns per warp
  static constexpr int NW1 = JC / WN;    // chunk columns per warp in the first product
  static constexpr int kSmemBytes =
      (BM * SX + 2 * JC * SX + C * SJ + BM * SJ) * static_cast<int>(sizeof(bf16));
  static_assert(BM % 16 == 0 && C % 16 == 0 && JC % 16 == 0, "tile sizes");
  static_assert(NOUT % 16 == 0 && NW1 % 8 == 0, "warp tiles");
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

template <int C, int BM, int WN, int JC, bool LN>
__global__ void __launch_bounds__(FFConfig<C, BM, WN, JC>::kThreads)
    geglu_ff_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_gamma,
                    const float* __restrict__ ln_beta, const bf16* __restrict__ w1,
                    const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                    const bf16* __restrict__ b2, bf16* __restrict__ y, int m, int inner,
                    float eps) {
  using Cfg = FFConfig<C, BM, WN, JC>;
  constexpr int SX = Cfg::SX, SJ = Cfg::SJ, NOUT = Cfg::NOUT, NW1 = Cfg::NW1;
  constexpr int kThreads = Cfg::kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* s_x = reinterpret_cast<bf16*>(smem_raw);  // [BM][SX]
  bf16* s_wa = s_x + BM * SX;                     // [JC][SX], then Wg: [JC][SX]
  bf16* s_wg = s_wa + JC * SX;
  bf16* s_w2 = s_wg + JC * SX;                    // [C][SJ]
  bf16* s_act = s_w2 + C * SJ;                    // [BM][SJ]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wm = warp / WN;  // which 16 rows
  const int wn = warp % WN;  // which columns
  const int g = lane / 4;
  const int t = lane % 4;
  const int row0 = blockIdx.x * BM;

  load_tile_async<BM, C, SX>(s_x, x, C, row0, m, tid, kThreads);
  load_tile_async<JC, C, SX>(s_wa, w1, C, 0, 2 * inner, tid, kThreads);
  load_tile_async<JC, C, SX>(s_wg, w1, C, inner, 2 * inner, tid, kThreads);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  if (LN) {
    // One warp a row: f32 mean and E[x^2] - mean^2 (clamped at 0), the affine
    // in f32, one rounding, written back in place.
    for (int r = warp; r < BM; r += kThreads / 32) {
      bf16* row = s_x + r * SX;
      float sum = 0.f, sq = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float v = __bfloat162float(row[c]);
        sum += v;
        sq += v * v;
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2) {
        sum += __shfl_xor_sync(0xffffffff, sum, off);
        sq += __shfl_xor_sync(0xffffffff, sq, off);
      }
      const float mean = sum / C;
      const float rstd = rsqrtf(fmaxf(sq / C - mean * mean, 0.f) + eps);
      for (int c = lane; c < C; c += 32) {
        const float v = (__bfloat162float(row[c]) - mean) * rstd * ln_gamma[c] + ln_beta[c];
        row[c] = __float2bfloat16_rn(v);
      }
    }
    __syncthreads();
  }

  float acc[NOUT / 8][4];
#pragma unroll
  for (int i = 0; i < NOUT / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  // ldmatrix row and column offsets of an A fragment (16 rows x 16 k) and of
  // a B fragment pair (16 n x 16 k), as in the attention kernels.
  const int a_row = wm * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
  const int a_col = (lane / 16) * 8;
  const int b_row = (lane % 8) + (lane / 16) * 8;
  const int b_col = ((lane / 8) % 2) * 8;

  const int n_chunks = inner / JC;
  for (int c = 0; c < n_chunks; ++c) {
    const int j0 = c * JC;
    // Wa|Wg of this chunk have landed; every warp is past the last chunk's
    // second product, so the W2 slice and act may be overwritten.
    cp_async_wait<0>();
    __syncthreads();
    load_tile_async<C, JC, SJ>(s_w2, w2 + j0, inner, 0, C, tid, kThreads);
    cp_async_commit();

    // First product: a and g for 16 rows x NW1 chunk columns.
    float aacc[NW1 / 8][4], gacc[NW1 / 8][4];
#pragma unroll
    for (int i = 0; i < NW1 / 8; ++i) {
      aacc[i][0] = aacc[i][1] = aacc[i][2] = aacc[i][3] = 0.f;
      gacc[i][0] = gacc[i][1] = gacc[i][2] = gacc[i][3] = 0.f;
    }
    // One ldmatrix_x4 brings the B fragments of one 8-column tile of Wa
    // (matrices 0, 1) and of the same tile of Wg (matrices 2, 3).
    const bf16* w_base = (lane / 16 ? s_wg : s_wa) + (wn * NW1 + (lane % 8)) * SX + b_col;
#pragma unroll 4
    for (int kk = 0; kk < C / 16; ++kk) {
      uint32_t af[4];
      ldmatrix_x4(af, s_x + a_row * SX + kk * 16 + a_col);
#pragma unroll
      for (int i = 0; i < NW1 / 8; ++i) {
        uint32_t bfrag[4];
        ldmatrix_x4(bfrag, w_base + i * 8 * SX + kk * 16);
        mma_bf16_16816(aacc[i], af, bfrag[0], bfrag[1]);
        mma_bf16_16816(gacc[i], af, bfrag[2], bfrag[3]);
      }
    }
#pragma unroll
    for (int i = 0; i < NW1 / 8; ++i) {
      const int col = wn * NW1 + i * 8 + 2 * t;
      const float2 ba = load_bf16x2(b1 + j0 + col);
      const float2 bg = load_bf16x2(b1 + inner + j0 + col);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float v0 = geglu_act(aacc[i][2 * half] + ba.x, gacc[i][2 * half] + bg.x);
        const float v1 = geglu_act(aacc[i][2 * half + 1] + ba.y, gacc[i][2 * half + 1] + bg.y);
        *reinterpret_cast<uint32_t*>(s_act + (wm * 16 + g + 8 * half) * SJ + col) =
            pack_bf16x2(v0, v1);
      }
    }
    __syncthreads();  // act is whole; nobody reads Wa|Wg any more

    if (c + 1 < n_chunks) {
      load_tile_async<JC, C, SX>(s_wa, w1, C, j0 + JC, 2 * inner, tid, kThreads);
      load_tile_async<JC, C, SX>(s_wg, w1, C, inner + j0 + JC, 2 * inner, tid, kThreads);
    }
    cp_async_commit();   // possibly empty: keeps "all but the newest group" = the W2 slice
    cp_async_wait<1>();
    __syncthreads();

    // Second product: y += act (16 x JC) * W2 slice (NOUT x JC)^T.
#pragma unroll
    for (int kk = 0; kk < JC / 16; ++kk) {
      uint32_t af[4];
      ldmatrix_x4(af, s_act + a_row * SJ + kk * 16 + a_col);
#pragma unroll
      for (int nb = 0; nb < NOUT / 16; ++nb) {
        uint32_t bfrag[4];
        ldmatrix_x4(bfrag, s_w2 + (wn * NOUT + nb * 16 + b_row) * SJ + kk * 16 + b_col);
        mma_bf16_16816(acc[2 * nb], af, bfrag[0], bfrag[1]);
        mma_bf16_16816(acc[2 * nb + 1], af, bfrag[2], bfrag[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the x tile: y may take its place

#pragma unroll
  for (int nd = 0; nd < NOUT / 8; ++nd) {
    const int col = wn * NOUT + nd * 8 + 2 * t;
    const float2 bias = load_bf16x2(b2 + col);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      *reinterpret_cast<uint32_t*>(s_x + (wm * 16 + g + 8 * half) * SX + col) =
          pack_bf16x2(acc[nd][2 * half] + bias.x, acc[nd][2 * half + 1] + bias.y);
    }
  }
  __syncthreads();
  constexpr int kVecs = C / 8;  // 16-byte vectors per row
  for (int i = tid; i < BM * kVecs; i += kThreads) {
    const int r = i / kVecs;
    const int cv = (i % kVecs) * 8;
    if (row0 + r < m) {
      *reinterpret_cast<uint4*>(y + static_cast<long long>(row0 + r) * C + cv) =
          *reinterpret_cast<const uint4*>(s_x + r * SX + cv);
    }
  }
}

template <int C, int BM, int WN, int JC, bool LN>
cudaError_t launch(const bf16* x, const float* gamma, const float* beta, const bf16* w1,
                   const bf16* b1, const bf16* w2, const bf16* b2, bf16* y, int m, int inner,
                   float eps, cudaStream_t stream) {
  using Cfg = FFConfig<C, BM, WN, JC>;
  if (inner % JC) return cudaErrorInvalidValue;
  auto kernel = geglu_ff_kernel<C, BM, WN, JC, LN>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Cfg::kSmemBytes);
  if (err != cudaSuccess) return err;
  const int blocks = (m + BM - 1) / BM;
  kernel<<<blocks, Cfg::kThreads, Cfg::kSmemBytes, stream>>>(x, gamma, beta, w1, b1, w2, b2, y, m,
                                                             inner, eps);
  return cudaGetLastError();
}

template <bool LN>
cudaError_t dispatch(const void* x, const void* gamma, const void* beta, const void* w1,
                     const void* b1, const void* w2, const void* b2, void* y, int m, int c,
                     int inner, float eps, void* stream) {
  if (m < 1 || inner < 1) return cudaErrorInvalidValue;
  const auto* xp = static_cast<const bf16*>(x);
  const auto* gp = static_cast<const float*>(gamma);
  const auto* bp = static_cast<const float*>(beta);
  const auto* w1p = static_cast<const bf16*>(w1);
  const auto* b1p = static_cast<const bf16*>(b1);
  const auto* w2p = static_cast<const bf16*>(w2);
  const auto* b2p = static_cast<const bf16*>(b2);
  auto* yp = static_cast<bf16*>(y);
  auto st = static_cast<cudaStream_t>(stream);
  if (c == 320)
    return launch<320, 64, 2, 64, LN>(xp, gp, bp, w1p, b1p, w2p, b2p, yp, m, inner, eps, st);
  if (c == 640)
    return launch<640, 32, 4, 32, LN>(xp, gp, bp, w1p, b1p, w2p, b2p, yp, m, inner, eps, st);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace ctrlv

// x: (m, c); w1: (2*inner, c), a's rows then g's; b1: (2*inner); w2: (c, inner);
// b2: (c); y: (m, c); all contiguous bf16 on the current device, c in {320, 640},
// inner a multiple of 64. Returns a cudaError_t code.
extern "C" int ctrlv_geglu_ff_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                                  const void* b2, void* y, int m, int c, int inner,
                                  void* stream) {
  return ctrlv::dispatch<false>(x, nullptr, nullptr, w1, b1, w2, b2, y, m, c, inner, 0.f, stream);
}

// The same with LayerNorm(x) in front: gamma and beta are (c) f32.
extern "C" int ctrlv_geglu_ff_ln_fwd(const void* x, const void* gamma, const void* beta,
                                     const void* w1, const void* b1, const void* w2,
                                     const void* b2, void* y, int m, int c, int inner, float eps,
                                     void* stream) {
  return ctrlv::dispatch<true>(x, gamma, beta, w1, b1, w2, b2, y, m, c, inner, eps, stream);
}
