// K6: the fused GEGLU feed-forward, bf16 in and out:
//   [a|g] = x W1^T + b1,  act = a * gelu_erf(g),  y = act W2^T + b2,
// optionally with a LayerNorm of each row of x in front. Replaces the Pallas
// kernels ctrlv_tpu/ops/geglu_ff.py::geglu_ff and ::geglu_ff_ln (_ff_body,
// _ff_ln_kernel). The (M, 2*inner) intermediate and act never reach device
// memory.
//
// What bounds it on an H100: the tensor cores. At (M, C, inner) =
// (128000, 320, 1280) a call is 6*M*C*inner = 0.31 TFLOP against 0.17 GB
// moved (x, y and the three weight matrices once): 0.32 ms at 989 TFLOP/s.
// Inside the card, what feeds them is L2: every block streams all of W1 and
// W2 (6*C*inner bytes: 2.46 MB at C = 320, 9.83 MB at C = 640) for its rows,
// so a block does 2 * (its rows) FLOP per byte it takes from L2, and the
// erf gelu (one per element of act) runs on the CUDA cores beside them.
//
// Arithmetic, as the TPU kernel has it: both halves of the first product
// accumulate in f32, take the bias in f32 and are rounded to bf16; the gelu is
// the erf form on f32 internals, rounded to bf16; a * gelu(g) is rounded to
// bf16; the second product keeps one f32 accumulator over all of `inner`, takes
// its bias in f32 and is rounded once. The LayerNorm in front: f32 mean and
// E[x^2] - mean^2 (clamped at 0) a row, the affine in f32, one rounding.
//
// Design: a warp-specialised back-to-back GEMM from Hopper's TMA, mbarriers
// and wgmma, shaped like mha.cu's flash attention without the softmax. A block
// of three warpgroups owns a tile of rows of x for the whole walk over
// `inner`, which it takes in steps:
//   - the producer warpgroup gives its registers back (setmaxnreg) and one
//     thread issues every copy by TMA into 128-byte-swizzled tiles: x's tile
//     once (64-column slabs), then per step the W1 rows of a and of g for the
//     step's inner columns, one 64-column K slab a stage of a ring ("full":
//     TMA bytes, "empty": an arrival per consumer warp), and per 64 inner
//     columns the (C, 64) slice of W2 through a second ring (boxes of at most
//     256 rows, so 160). W1 is nn.Linear's (2*inner, C), W2 its (C, inner),
//     both read where they lie: each is the K-major B operand of a product;
//   - two consumer warpgroups of 64 rows. First product: a and g of the step
//     as ONE m64n(2*sub) SS wgmma over the slabs (x and the W1 stage both
//     K-major), because the stage holds a's rows and then g's: a column's a
//     and g land in the same thread's registers. Bias, roundings and the gelu
//     in registers. Second product into y's f32 accumulator, 64 rows x 320
//     columns a warpgroup (two m64n160 accumulators, 160 registers):
//       C = 320: a block holds 128 rows, a warpgroup 64 of them; act's
//         accumulator, packed to bf16 pairs, is the A fragment of a
//         register-A wgmma (as mha.cu's S -> P), W2's slice the K-major B;
//       C = 640: a block holds 64 rows (the register file holds no more of
//         y); the warpgroups split y's columns, 320 each, and the step's 64
//         inner columns, 32 each for the first product. Each writes its half
//         of act into a swizzled shared tile, and both run the second product
//         from there (SS wgmma);
//   - C = 320: the warpgroups take turns to issue (named barriers, as in
//     mha.cu), the second product of one step with the first of the next, so
//     one's gelu runs while the other's products hold the tensor cores;
//   - epilogue: y + b2, bf16, into the x tile's shared memory (swizzled),
//     one TMA store a slab, which clips rows past M (those rows arrived as
//     zeros and were computed on, harmlessly);
//   - L2 cache hints: the weights, which every block streams again, are
//     kept (evict_last); x and y, each touched once, leave first.
// No float atomics: two runs on the same input agree to the bit.
//
// The gate (ops/geglu_ff.py::_plan): C_in = C_out in {320, 640}, inner a
// multiple of 64. C = 1280 would need a 64 x 640 accumulator a warpgroup, and
// takes the unfused path.
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

// A block's plan. kS1, kS2: stages of the W1 and W2 rings.
template <int C_, int kS1_, int kS2_, bool kPingPong_>
struct Cfg {
  static constexpr int C = C_, kS1 = kS1_, kS2 = kS2_;
  // inner columns of a consumer's first product: an m64n64 accumulator, a then g
  static constexpr int kSub = 32;
  static constexpr bool kSplitN = C == 640;  // the consumers split y's columns, not its rows
  static constexpr bool kPingPong = kPingPong_ && !kSplitN;
  static constexpr int kBM = kSplitN ? 64 : 128;            // rows of x a block
  static constexpr int kStep = kSplitN ? 2 * kSub : kSub;   // inner columns a step
  static constexpr int kStepsPerW2 = 64 / kStep;            // steps one W2 stage serves
  static constexpr int kSlabs = C / 64;                     // 64-column K slabs of x and W1
  static constexpr int kW1Rows = 2 * kStep;                 // rows of a W1 stage: a and g
  static constexpr int kW1Boxes = kW1Rows / kSub;           // kSub rows a box
  static constexpr int kW2Box = 160;                        // a TMA box has at most 256 rows
  static constexpr int kXBytes = kBM * C * 2;
  static constexpr int kActBytes = kSplitN ? kBM * kRowBytes : 0;
  static constexpr int kW1Stage = kW1Rows * kRowBytes;
  static constexpr int kW2Stage = C * kRowBytes;
  static constexpr int kBarriers = 1 + 2 * kS1 + 2 * kS2;
  // x (then y), act, the rings and the barriers, with 1024 bytes of slack to
  // align them to the swizzle atom
  static constexpr int kSmem =
      1024 + kXBytes + kActBytes + kS2 * kW2Stage + kS1 * kW1Stage + 8 * kBarriers;
  static_assert(C == 320 || C == 640, "C is 320 or 640");
  static_assert(kSmem <= 232448, "more shared memory than a block has");
  // Without ping-pong, each K slab of the first product waits for the one
  // before and releases its stage, so that the ring refills as early as it
  // can; with ping-pong, a turn issues a step's products without waiting for
  // any (a wait would hold the turn until the other warpgroup's products,
  // queued ahead, are done), and the stages are released after it.
  static constexpr bool kWaitEachSlab = !kPingPong;
  static_assert(kPingPong ? kS1 >= kSlabs : kS1 >= 2, "the stages a step holds at once");
};

// The plans, one a width: Cfg<C, W1 stages, W2 stages, ping-pong>, mirrored in
// ops/geglu_ff.py::_PLANS.
using Plan320 = Cfg<320, 8, 2, true>;
using Plan640 = Cfg<640, 3, 1, false>;

struct FFArgs {
  const bf16* b1;      // (2*inner)
  const bf16* b2;      // (C)
  const float* gamma;  // (C), the LayerNorm's
  const float* beta;
  int m, inner;
  float eps;
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

// Byte offset of element (r, c) in a tile of `rows` rows kept as 64-column
// slabs of 128-byte swizzled rows, one slab after another.
__device__ __forceinline__ int swizzled(int r, int c, int rows) {
  return (c / 64) * rows * kRowBytes + r * kRowBytes + ((((c % 64) / 8) ^ (r % 8)) << 4) +
         (c % 8) * 2;
}

template <class K, bool LN>
__global__ void __launch_bounds__(kThreads, 1)
    geglu_ff_kernel(const __grid_constant__ CUtensorMap tm_x,
                    const __grid_constant__ CUtensorMap tm_w1,
                    const __grid_constant__ CUtensorMap tm_w2,
                    const __grid_constant__ CUtensorMap tm_y, const FFArgs a) {
  constexpr int C = K::C, kSub = K::kSub, kBM = K::kBM, kS1 = K::kS1, kS2 = K::kS2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* s_x = smem;                       // [slab][kBM rows][128 B]; y at the end
  unsigned char* s_act = s_x + K::kXBytes;         // C = 640: [kBM rows][128 B]
  unsigned char* s_w2 = s_act + K::kActBytes;      // [stage][C rows][128 B]
  unsigned char* s_w1 = s_w2 + kS2 * K::kW2Stage;  // [stage][kW1Rows rows][128 B]
  uint64_t* bars = reinterpret_cast<uint64_t*>(s_w1 + kS1 * K::kW1Stage);
  uint64_t* x_full = bars;
  uint64_t* full1 = bars + 1;
  uint64_t* empty1 = full1 + kS1;
  uint64_t* full2 = empty1 + kS1;
  uint64_t* empty2 = full2 + kS2;

  const int row0 = blockIdx.x * kBM;
  const int n_steps = a.inner / K::kStep;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(x_full, 1);
    for (int s = 0; s < kS1; ++s) {
      mbar_init(&full1[s], 1);
      mbar_init(&empty1[s], 8);
    }
    for (int s = 0; s < kS2; ++s) {
      mbar_init(&full2[s], 1);
      mbar_init(&empty2[s], 8);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: one thread issues every copy, in the order the consumers
    // take them. L2 priorities: the weights, which every block reads again,
    // stay; x and y, each read or written once, leave first.
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      const uint64_t keep = l2_policy<L2Evict::kLast>(), once = l2_policy<L2Evict::kFirst>();
      mbar_arrive_expect_tx(x_full, K::kXBytes);
      for (int h = 0; h < K::kSlabs; ++h)
        tma_load_3d_hint(s_x + h * kBM * kRowBytes, &tm_x, x_full, h * 64, row0, 0, once);
      int it1 = 0;  // W1 stages issued
      for (int j = 0; j < n_steps; ++j) {
        for (int ks = 0; ks < K::kSlabs; ++ks, ++it1) {
          const int s = it1 % kS1;
          if (it1 >= kS1) mbar_wait(&empty1[s], ((it1 / kS1) - 1) & 1);
          mbar_arrive_expect_tx(&full1[s], K::kW1Stage);
          // box b: the kSub rows of piece b, (consumer, a or g) in that order
          for (int b = 0; b < K::kW1Boxes; ++b) {
            const int src = (b % 2 ? a.inner : 0) + j * K::kStep + (b / 2) * kSub;
            tma_load_3d_hint(s_w1 + s * K::kW1Stage + b * kSub * kRowBytes, &tm_w1, &full1[s],
                             ks * 64, src, 0, keep);
          }
        }
        if (j % K::kStepsPerW2 == 0) {
          const int chunk = j / K::kStepsPerW2, s = chunk % kS2;
          if (chunk >= kS2) mbar_wait(&empty2[s], ((chunk / kS2) - 1) & 1);
          mbar_arrive_expect_tx(&full2[s], K::kW2Stage);
          for (int r = 0; r < C; r += K::kW2Box)
            tma_load_3d_hint(s_w2 + s * K::kW2Stage + r * kRowBytes, &tm_w2, &full2[s],
                             chunk * 64, r, 0, keep);
        }
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int c = wg - 1;
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32, g = lane / 4, tq = lane % 4;
    const int xrow = K::kSplitN ? 0 : 64 * c;   // this warpgroup's first row of the tile
    const int ycol = K::kSplitN ? 320 * c : 0;  // its first column of y
    const int jcol = K::kSplitN ? kSub * c : 0;  // its first inner column of a step
    const uint32_t x_addr = smem_addr(s_x) + xrow * kRowBytes;
    const uint32_t w1_addr = smem_addr(s_w1) + (K::kSplitN ? 2 * kSub * c : 0) * kRowBytes;
    const uint32_t w2_addr = smem_addr(s_w2) + ycol * kRowBytes;
    const uint32_t act_addr = smem_addr(s_act);
    // the consumers of a block: 256 threads on named barrier 3
    auto sync_consumers = [&]() { named_barrier_sync(3, 256); };

    mbar_wait(x_full, 0);
    if constexpr (LN) {
      // A warp a row, in place in the swizzled tile. C = 640: each warpgroup
      // normalises half the rows that both read.
      const int r0 = K::kSplitN ? 32 * c : xrow, rows = K::kSplitN ? 32 : 64;
      for (int r = r0 + warp; r < r0 + rows; r += 4) {
        float sum = 0.f, sq = 0.f;
        for (int q = lane; q < C / 8; q += 32) {
          const uint4 v = *reinterpret_cast<const uint4*>(s_x + swizzled(r, 8 * q, kBM));
          const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float f = __bfloat162float(e[i]);
            sum += f;
            sq += f * f;
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off /= 2) {
          sum += __shfl_xor_sync(0xffffffff, sum, off);
          sq += __shfl_xor_sync(0xffffffff, sq, off);
        }
        const float mean = sum / C;
        const float rstd = rsqrtf(fmaxf(sq / C - mean * mean, 0.f) + a.eps);
        for (int q = lane; q < C / 8; q += 32) {
          uint4* p = reinterpret_cast<uint4*>(s_x + swizzled(r, 8 * q, kBM));
          uint4 v = *p;
          bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int col = 8 * q + i;
            e[i] = __float2bfloat16_rn((__bfloat162float(e[i]) - mean) * rstd * a.gamma[col] +
                                       a.beta[col]);
          }
          *p = v;
        }
      }
      fence_proxy_async_smem();  // the products read the tile through the async proxy
      if constexpr (K::kSplitN) {
        sync_consumers();
      } else {
        named_barrier_sync(1 + c, 128);
      }
    }

    float y[2][80];    // y's accumulator: columns ycol + 160 hh + ...
    float ag[kSub];    // a (columns 0 .. kSub-1) and g (kSub ..) of the step's first product
    uint32_t af[kSub / 16][4];  // C = 320: act of the step, the A operand of the second
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int i = 0; i < 80; ++i) y[hh][i] = 0.f;
#pragma unroll
    for (int i = 0; i < kSub; ++i) ag[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kSub / 16; ++i) af[i][0] = af[i][1] = af[i][2] = af[i][3] = 0u;

    auto fence_regs = [&]() {
      reg_fence(y[0]);
      reg_fence(y[1]);
      reg_fence(ag);
      reg_fence(af);
    };
    // A stage is free once every consumer warp is done with it.
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    // y += act(j) W2(j)^T: 64 rows x 320 columns, K = the step's inner columns.
    auto issue_second = [&](int j) {
      const int chunk = j / K::kStepsPerW2, s = chunk % kS2;
      mbar_wait(&full2[s], (chunk / kS2) & 1);
      const uint32_t b = w2_addr + s * K::kW2Stage + (j % K::kStepsPerW2) * K::kStep * 2;
#pragma unroll
      for (int kk = 0; kk < K::kStep / 16; ++kk)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const uint64_t db = sw128_desc(b + hh * 160 * kRowBytes + kk * 32, 16, 1024);
          if constexpr (K::kSplitN) {
            wgmma_m64n160k16_ss(y[hh], sw128_desc(act_addr + kk * 32, 16, 1024), db, 1);
          } else {
            wgmma_m64n160k16_rs_k(y[hh], af[kk], db, 1);
          }
        }
      wgmma_commit();
    };
    // Bias, roundings and gelu of step j; act into af (C = 320) or into this
    // warpgroup's half of the shared act tile (C = 640). ag[i] is row
    // 16 warp + g + 8 ((i % 4) / 2), column 8 (i / 4) + 2 tq + i % 2.
    auto gate = [&](int j) {
      const bf16* ba = a.b1 + j * K::kStep + jcol;
      const bf16* bg = ba + a.inner;
      float v[kSub / 2];
#pragma unroll
      for (int i = 0; i < kSub / 2; i += 2) {
        const int col = 8 * (i / 4) + 2 * tq;
        const float2 bia = load_bf16x2(ba + col), big = load_bf16x2(bg + col);
        v[i] = geglu_act(ag[i] + bia.x, ag[i + kSub / 2] + big.x);
        v[i + 1] = geglu_act(ag[i + 1] + bia.y, ag[i + 1 + kSub / 2] + big.y);
      }
      if constexpr (K::kSplitN) {
        sync_consumers();  // both warpgroups' products of the step before have read act
#pragma unroll
        for (int i = 0; i < kSub / 2; i += 2) {
          const int r = 16 * warp + g + 8 * ((i % 4) / 2);
          *reinterpret_cast<uint32_t*>(s_act + swizzled(r, jcol + 8 * (i / 4) + 2 * tq, kBM)) =
              pack_bf16x2(v[i], v[i + 1]);
        }
        fence_proxy_async_smem();
        sync_consumers();
      } else {
#pragma unroll
        for (int kk = 0; kk < kSub / 16; ++kk) {
          af[kk][0] = pack_bf16x2(v[8 * kk + 0], v[8 * kk + 1]);
          af[kk][1] = pack_bf16x2(v[8 * kk + 2], v[8 * kk + 3]);
          af[kk][2] = pack_bf16x2(v[8 * kk + 4], v[8 * kk + 5]);
          af[kk][3] = pack_bf16x2(v[8 * kk + 6], v[8 * kk + 7]);
        }
      }
    };
    // Ping-pong (C = 320): a warpgroup issues its products in its turn (named
    // barrier 8 + c, 256 threads), then passes the turn. Each has n_steps + 1
    // turns; warpgroup 1 opens warpgroup 0's first and does not pass its last.
    auto take_turn = [&]() {
      if constexpr (K::kPingPong) named_barrier_sync(8 + c, 256);
    };
    auto pass_turn = [&](bool last) {
      if constexpr (K::kPingPong) {
        if (!(last && c == 1)) named_barrier_arrive(8 + (c + 1) % 2, 256);
      }
    };

    // Step j's second product is the last reader of its W2 stage.
    auto last_of_w2 = [&](int j) {
      return j >= 0 && j % K::kStepsPerW2 == K::kStepsPerW2 - 1;
    };
    // Turn j issues step j-1's second product and step j's first; the gate
    // of step j then runs while the other warpgroup's products hold the
    // tensor cores.
    if (K::kPingPong && c == 1) named_barrier_arrive(8, 256);
    int it1 = 0;  // W1 stages consumed
    for (int j = 0; j <= n_steps; ++j) {
      take_turn();
      fence_regs();
      wgmma_fence();
      if (j > 0) issue_second(j - 1);
      if (j < n_steps) {
        for (int ks = 0; ks < K::kSlabs; ++ks, ++it1) {
          const int s = it1 % kS1;
          mbar_wait(&full1[s], (it1 / kS1) & 1);
          if (ks > 0) {
            fence_regs();
            wgmma_fence();
          }
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_m64n64k16_ss(ag, sw128_desc(x_addr + ks * kBM * kRowBytes + kk * 32, 16, 1024),
                               sw128_desc(w1_addr + s * K::kW1Stage + kk * 32, 16, 1024), ks | kk);
          wgmma_commit();
          if constexpr (K::kWaitEachSlab) {
            wgmma_wait<1>();
            fence_regs();
            if (ks > 0) {
              release(&empty1[(it1 - 1) % kS1]);
            } else if (last_of_w2(j - 1)) {
              release(&empty2[((j - 1) / K::kStepsPerW2) % kS2]);
            }
          }
        }
      }
      pass_turn(j == n_steps);
      wgmma_wait<0>();
      fence_regs();
      if (j < n_steps) {
        if constexpr (K::kWaitEachSlab) {
          release(&empty1[(it1 - 1) % kS1]);
        } else {
          for (int i = K::kSlabs; i > 0; --i) release(&empty1[(it1 - i) % kS1]);
          if (last_of_w2(j - 1)) release(&empty2[((j - 1) / K::kStepsPerW2) % kS2]);
        }
        gate(j);
      }
    }

    // Epilogue: y + b2 in bf16 into the x tile, once every reader of the rows
    // it overwrites is done (C = 320: this warpgroup alone), then one TMA
    // store a slab of this warpgroup's 64 rows x 320 columns.
    if constexpr (K::kSplitN) sync_consumers();
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int i = 0; i < 80; i += 2) {
        const int col = ycol + 160 * hh + 8 * (i / 4) + 2 * tq;
        const int r = xrow + 16 * warp + g + 8 * ((i % 4) / 2);
        const float2 bias = load_bf16x2(a.b2 + col);
        *reinterpret_cast<uint32_t*>(s_x + swizzled(r, col, kBM)) =
            pack_bf16x2(y[hh][i] + bias.x, y[hh][i + 1] + bias.y);
      }
    fence_proxy_async_smem();
    named_barrier_sync(1 + c, 128);
    if (t == 0) {
      const uint64_t once = l2_policy<L2Evict::kFirst>();
      for (int h = ycol / 64; h < ycol / 64 + 5; ++h)
        tma_store_3d_hint(&tm_y, s_x + (h * kBM + xrow) * kRowBytes, h * 64, row0 + xrow, 0,
                          once);
      tma_store_commit();
      tma_store_wait_all();
    }
  }
}

template <class K, bool LN>
cudaError_t launch(const void* x, const float* gamma, const float* beta, const void* w1,
                   const bf16* b1, const void* w2, const bf16* b2, void* y, int m, int inner,
                   float eps, cudaStream_t stream) {
  if (inner % 64) return cudaErrorInvalidValue;
  CUtensorMap tm_x, tm_w1, tm_w2, tm_y;
  cudaError_t err;
  if ((err = encode_tensor_map(&tm_x, x, K::C, m, 1, 64, K::kBM)) != cudaSuccess ||
      (err = encode_tensor_map(&tm_w1, w1, K::C, 2 * inner, 1, 64, K::kSub)) != cudaSuccess ||
      (err = encode_tensor_map(&tm_w2, w2, inner, K::C, 1, 64, K::kW2Box)) != cudaSuccess ||
      (err = encode_tensor_map(&tm_y, y, K::C, m, 1, 64, 64)) != cudaSuccess)
    return err;
  auto kernel = geglu_ff_kernel<K, LN>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, K::kSmem);
  if (err != cudaSuccess) return err;
  // one block a tile of rows
  const unsigned blocks = static_cast<unsigned>((m + K::kBM - 1) / K::kBM);
  kernel<<<blocks, kThreads, K::kSmem, stream>>>(tm_x, tm_w1, tm_w2, tm_y,
                                                  FFArgs{b1, b2, gamma, beta, m, inner, eps});
  return cudaGetLastError();
}

template <bool LN>
cudaError_t dispatch(const void* x, const void* gamma, const void* beta, const void* w1,
                     const void* b1, const void* w2, const void* b2, void* y, int m, int c,
                     int inner, float eps, void* stream) {
  if (m < 1 || inner < 1) return cudaErrorInvalidValue;
  const auto* gp = static_cast<const float*>(gamma);
  const auto* bp = static_cast<const float*>(beta);
  const auto* b1p = static_cast<const bf16*>(b1);
  const auto* b2p = static_cast<const bf16*>(b2);
  auto st = static_cast<cudaStream_t>(stream);
  if (c == 320) return launch<Plan320, LN>(x, gp, bp, w1, b1p, w2, b2p, y, m, inner, eps, st);
  if (c == 640) return launch<Plan640, LN>(x, gp, bp, w1, b1p, w2, b2p, y, m, inner, eps, st);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace ctrlv

// x: (m, c); w1: (2*inner, c), a's rows then g's; b1: (2*inner); w2: (c, inner);
// b2: (c); y: (m, c); all contiguous bf16 on the current device, 16-byte
// aligned, c in {320, 640}, inner a multiple of 64. Returns a cudaError_t code.
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
