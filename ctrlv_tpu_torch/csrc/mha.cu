// K1 and K8: softmax(q k^T * scale) v per head, bf16 in and out, over
// (B, S, H*D) operands with head h at columns h*D (K8's contiguous
// (B, S, H, D) is the same tensor). Replaces the Pallas kernels
// ctrlv_tpu/ops/mha.py::mha_attention (_mha_kernel; entry ctrlv_mha_fwd) and
// ctrlv_tpu/ops/flash_attention.py::flash_attention (_attn_kernel; entry
// ctrlv_flash_fwd). Like them: f32 logits, an online softmax in base 2
// (scale * log2 e) with f32 running max, sum and accumulator, P rounded to
// bf16 before the product with V, the 1/sum folded into the output, one
// rounding of the output. Head dims 64 and 128; any Sq, Sk >= 1; scale >= 0.
//
// What bounds it on an H100: the tensor cores. At the sampler's K1 shape
// (B=50, S=2560, H=5, D=64) a call is 4*B*S^2*H*D = 0.42 TFLOP against
// 0.33 GB moved (0.42 ms at 989 TFLOP/s); K8 at (50, 640, 10, 64) is 52 GFLOP
// against 164 MB, near the edge between the two bounds. At D = 64 the
// exponentials (one per logit, on the special-function unit) and the softmax's
// other f32 work take about as long as the products, so the design is about
// keeping both busy at once.
//
// Design: a persistent, warp-specialised flash-attention forward built from
// Hopper's TMA, mbarriers and wgmma. Against the mma.sync kernel it replaces:
//   1. Products on wgmma: S = Q K^T as m64nNk16 with both operands read from
//      128-byte-swizzled shared memory (K-major), O += P V as m64nDk16 with
//      P from registers; no mma.sync.
//   2. Larger query tiles: 192 query rows a block for K1 at D = 64 (three
//      consumer warpgroups of 64 rows), 128 otherwise, so each K/V byte
//      brought into shared memory serves 128-192 query rows, not 64.
//   3. Copies off the math warps: a producer warpgroup gives its registers
//      back (setmaxnreg) and one elected thread issues every copy by TMA
//      through 3-D tensor maps over (H*D, S, B), 64-column boxes. Q comes
//      once an item; K and V stream through a ring of stages with a "full"
//      mbarrier (TMA bytes) and an "empty" one (an arrival per consumer
//      warp) each. Rows past S arrive as zeros and never from the next batch
//      element; keys past Sk also get a -inf logit.
//   4. No fragment goes through ldmatrix: wgmma reads K and V straight from
//      the swizzled tiles, V MN-major through the descriptor's transpose bit,
//      and P never goes through shared memory.
//   5. Softmax beside the products: each consumer warpgroup issues tile j's
//      S product with tile j-1's P V product and runs tile j's softmax while
//      the latter is in flight; the warpgroups take turns to issue (named
//      barriers), so one's softmax runs while another's products hold the
//      tensor cores.
// The grid is as many blocks as fit on the card, each walking (query tile,
// head, batch element) items, so the next item's copies overlap this one's
// last products and its epilogue: 1/l, bf16, into a swizzled staging tile,
// one TMA store a slab, which clips rows past Sq.
//
// Tiles (tile_plan below, mirrored in ops/mha.py::tile_plan): for K8 where the
// last 128-row query tile would be at most half full (160 tokens are 1.25
// tiles), 64 query rows (one consumer warpgroup) and 64-key tiles, two blocks
// an SM. Four stages at D = 64, two at D = 128 (the Q and staging tiles and
// the ring stay under 227 KB).
#include "hopper_utils.cuh"

#include <math.h>

#include <algorithm>

namespace ctrlv {
namespace {

constexpr int kSlab = 64;          // bf16 columns of a 128-byte swizzled row
constexpr int kSlabRowBytes = 128;

struct TilePlan {
  int block_m;  // query rows a block: 64 per consumer warpgroup
  int block_n;  // keys a tile
  int stages;   // K/V tiles in flight
};

// Pure function of the shape: which instantiation a call takes.
TilePlan tile_plan(int sq, int sk, int head_dim, bool flash) {
  (void)sk;  // every plan streams any number of keys
  const int stages = head_dim == 64 ? 4 : 2;
  if (!flash && head_dim == 64) return {192, 128, stages};
  const int tail = sq % 128;
  const int block = flash && tail >= 1 && tail <= 64 ? 64 : 128;
  return {block, block, stages};
}

template <int D, int kConsumers, int kBlockN, int kStages>
struct Cfg {
  static constexpr int kBlockM = 64 * kConsumers;
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kSlabs = D / kSlab;
  static constexpr int kQBytes = kBlockM * D * 2;
  static constexpr int kTileBytes = kBlockN * D * 2;  // one K or one V tile
  static constexpr int kBarriers = 2 + 2 * kStages;
  // Q, the output's staging tile and the K/V ring, with 1024 bytes of slack
  // to align them to the swizzle atom.
  static constexpr int kSmem = 1024 + 2 * kQBytes + 2 * kStages * kTileBytes + 8 * kBarriers;
  // Registers: the block's pool is (65536 / kThreads, or half that when two
  // blocks share an SM) a thread; the producer keeps 24.
  static constexpr int kMinBlocks = kConsumers == 1 ? 2 : 1;
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = kConsumers == 1 ? 232 : kConsumers == 2 ? 240 : 160;
};

template <int D, int kConsumers, int kBlockN, int kStages>
__global__ void __launch_bounds__(Cfg<D, kConsumers, kBlockN, kStages>::kThreads,
                                  Cfg<D, kConsumers, kBlockN, kStages>::kMinBlocks)
    mha_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_o, int sk, int q_tiles, int heads,
                   int n_items, float scale_log2) {
  using C = Cfg<D, kConsumers, kBlockN, kStages>;
  constexpr bool kPingPong = kConsumers >= 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* s_q = smem;                          // [slab][kBlockM rows][128 B]
  unsigned char* s_o = s_q + C::kQBytes;              // the same, the output staged for TMA
  unsigned char* s_k = s_o + C::kQBytes;              // [stage][slab][kBlockN rows][128 B]
  unsigned char* s_v = s_k + kStages * C::kTileBytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(s_v + kStages * C::kTileBytes);
  uint64_t* q_full = bars;
  uint64_t* q_empty = bars + 1;
  uint64_t* full = bars + 2;
  uint64_t* empty = bars + 2 + kStages;

  const int n_tiles = (sk + kBlockN - 1) / kBlockN;
  const int wg = threadIdx.x / 128;
  // Work item i is (query tile, head, batch element), query tiles fastest so
  // that the blocks in flight share K and V in L2. A block takes items
  // blockIdx.x, + gridDim.x, ...: its Q, K and V copies for the next item
  // overlap the products and the epilogue of the last.
  auto item = [&](int i, int& q0, int& col0, int& b) {
    q0 = (i % q_tiles) * C::kBlockM;
    col0 = ((i / q_tiles) % heads) * D;
    b = i / q_tiles / heads;
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 4 * kConsumers);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kConsumers);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: one thread issues every copy.
    setmaxnreg_dec<C::kProducerRegs>();
    if (threadIdx.x == 0) {
      int kv = 0;  // K/V tiles issued so far, over all items
      for (int i = blockIdx.x, it = 0; i < n_items; i += gridDim.x, ++it) {
        int q0, col0, b;
        item(i, q0, col0, b);
        if (it > 0) mbar_wait(q_empty, (it - 1) & 1);
        mbar_arrive_expect_tx(q_full, C::kQBytes);
        for (int h = 0; h < C::kSlabs; ++h)
          for (int c = 0; c < kConsumers; ++c)
            tma_load_3d(s_q + (h * C::kBlockM + c * 64) * kSlabRowBytes, &tm_q, q_full,
                        col0 + h * kSlab, q0 + c * 64, b);
        for (int j = 0; j < n_tiles; ++j, ++kv) {
          const int s = kv % kStages;
          if (kv >= kStages) mbar_wait(&empty[s], ((kv / kStages) - 1) & 1);
          mbar_arrive_expect_tx(&full[s], 2 * C::kTileBytes);
          for (int h = 0; h < C::kSlabs; ++h) {
            const int off = s * C::kTileBytes + h * kBlockN * kSlabRowBytes;
            tma_load_3d(s_k + off, &tm_k, &full[s], col0 + h * kSlab, j * kBlockN, b);
            tma_load_3d(s_v + off, &tm_v, &full[s], col0 + h * kSlab, j * kBlockN, b);
          }
        }
      }
    }
  } else {
    // Consumer warpgroup c: query rows q0 + 64c .. q0 + 64c + 63 of each item.
    setmaxnreg_inc<C::kConsumerRegs>();
    const int c = wg - 1;
    const int t = threadIdx.x % 128;
    const int warp = t / 32;
    const int lane = t % 32;
    const int g = lane / 4;
    const int tq = lane % 4;
    const uint32_t q_addr = smem_addr(s_q) + c * 64 * kSlabRowBytes;

    float o[D / 2];
    float sc[kBlockN / 2];
    uint32_t pa[kBlockN / 16][4];  // P of the tile before, the A operand of O += P V
#pragma unroll
    for (int i = 0; i < kBlockN / 2; ++i) sc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kBlockN / 16; ++i) pa[i][0] = pa[i][1] = pa[i][2] = pa[i][3] = 0u;
    float row_max[2], row_sum[2];  // max in units of scale * log2 e; sum: this thread's share
    float alpha[2];
    int kv = 0;  // K/V tiles consumed so far, over all items

    // S = Q K^T for tile j: D/16 k-slices, 32 bytes apart within a 64-column slab.
    auto issue_s = [&](int j) {
      const uint32_t k_addr = smem_addr(s_k) + ((kv + j) % kStages) * C::kTileBytes;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int h = kk / 4;
        const uint32_t in_row = (kk % 4) * 32;
        wgmma_ss<kBlockN>(
            sc, sw128_desc(q_addr + h * C::kBlockM * kSlabRowBytes + in_row, 16, 1024),
            sw128_desc(k_addr + h * kBlockN * kSlabRowBytes + in_row, 16, 1024), kk > 0);
      }
      wgmma_commit();
    };
    // O += P V for tile j. 16 keys are two 8-row atoms (2048 bytes); the
    // 64-column slabs of V are kBlockN rows apart.
    auto issue_pv = [&](int j) {
      const uint32_t v_addr = smem_addr(s_v) + ((kv + j) % kStages) * C::kTileBytes;
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk)
        wgmma_rs<D>(o, pa[kk],
                    sw128_desc(v_addr + kk * 16 * kSlabRowBytes, kBlockN * kSlabRowBytes, 1024), 1);
      wgmma_commit();
    };
    auto wait_full = [&](int j) { mbar_wait(&full[(kv + j) % kStages], ((kv + j) / kStages) & 1); };
    auto release = [&](int j) {
      if (lane == 0) mbar_arrive(&empty[(kv + j) % kStages]);
    };
    // Online softmax of tile j over rows g and g + 8 of the warp's 16; leaves
    // P in sc and the rescale of O in alpha. scale > 0, so the max of the raw
    // logits gives the max of the scaled ones. Four partial maxima and sums a
    // row and both rows at once, so the chains are short.
    auto softmax = [&](int j) {
      if ((j + 1) * kBlockN > sk) {
#pragma unroll
        for (int i = 0; i < kBlockN / 2; ++i)
          if (j * kBlockN + (i / 4) * 8 + 2 * tq + (i % 2) >= sk) sc[i] = -INFINITY;
      }
      float part[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int p = 0; p < 4; ++p) part[half][p] = -INFINITY;
#pragma unroll
      for (int nb = 0; nb < kBlockN / 8; ++nb)
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& m = part[half][(nb % 2) * 2 + e];
            m = fmaxf(m, sc[4 * nb + 2 * half + e]);
          }
      float m_new[2];
#pragma unroll
      for (int half = 0; half < 2; ++half)
        m_new[half] =
            fmaxf(fmaxf(part[half][0], part[half][1]), fmaxf(part[half][2], part[half][3]));
#pragma unroll
      for (int half = 0; half < 2; ++half)
        m_new[half] = fmaxf(m_new[half], __shfl_xor_sync(0xffffffff, m_new[half], 1));
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        m_new[half] = fmaxf(m_new[half], __shfl_xor_sync(0xffffffff, m_new[half], 2));
        // Every tile holds at least one valid key, so m_new is finite.
        m_new[half] = fmaxf(row_max[half], m_new[half] * scale_log2);
        alpha[half] = exp2_approx(row_max[half] - m_new[half]);
        row_max[half] = m_new[half];
#pragma unroll
        for (int p = 0; p < 4; ++p) part[half][p] = 0.f;
      }
#pragma unroll
      for (int nb = 0; nb < kBlockN / 8; ++nb)
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = sc[4 * nb + 2 * half + e];
            x = exp2_approx(fmaf(x, scale_log2, -m_new[half]));
            part[half][(nb % 2) * 2 + e] += x;
          }
#pragma unroll
      for (int half = 0; half < 2; ++half)
        row_sum[half] = row_sum[half] * alpha[half] +
                        ((part[half][0] + part[half][1]) + (part[half][2] + part[half][3]));
    };
    // P in bf16: the k16 slice kk of P is the accumulator chunks 2kk, 2kk + 1.
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
        pa[kk][0] = pack_bf16x2(sc[8 * kk + 0], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16x2(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16x2(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16x2(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
    };
    // Before a product is issued: every register it reads or writes settled
    // (the compiler keeps their accesses on this side), then wgmma.fence.
    auto fence_operands = [&]() {
      reg_fence(sc);
      reg_fence(o);
      reg_fence(pa);
      wgmma_fence();
    };
    // Ping-pong of the consumer warpgroups: each issues its products in its
    // turn (named barrier 8 + c, 256 threads), then passes the turn to the
    // next, so that one warpgroup's softmax runs while another's products
    // hold the tensor cores. The last warpgroup hands warpgroup 0 the first
    // turn of every item; each has n_tiles + 1 turns an item and passes all
    // but the last one's last.
    auto take_turn = [&]() {
      if (kPingPong) named_barrier_sync(8 + c, 256);
    };
    auto pass_turn = [&](bool last) {
      if (kPingPong && !(last && c == kConsumers - 1))
        named_barrier_arrive(8 + (c + 1) % kConsumers, 256);
    };

    // Tile j's S product is issued beside tile j-1's P V product, and tile
    // j's softmax runs while the latter is still in flight.
    for (int i = blockIdx.x, it = 0; i < n_items; i += gridDim.x, ++it) {
      int q0, col0, b;
      item(i, q0, col0, b);
#pragma unroll
      for (int k = 0; k < D / 2; ++k) o[k] = 0.f;
      row_max[0] = row_max[1] = -INFINITY;
      row_sum[0] = row_sum[1] = 0.f;
      if (kPingPong && c == kConsumers - 1) named_barrier_arrive(8, 256);
      mbar_wait(q_full, it & 1);
      wait_full(0);
      take_turn();
      fence_operands();
      issue_s(0);
      pass_turn(false);
      wgmma_wait<0>();
      reg_fence(sc);
      if (n_tiles == 1 && lane == 0) mbar_arrive(q_empty);  // Q's last reader is done
      softmax(0);
      pack_p();
      for (int j = 1; j < n_tiles; ++j) {
        wait_full(j);
        take_turn();
        fence_operands();
        issue_s(j);
        issue_pv(j - 1);
        pass_turn(false);
        wgmma_wait<1>();
        reg_fence(sc);
        if (j == n_tiles - 1 && lane == 0) mbar_arrive(q_empty);
        softmax(j);
        wgmma_wait<0>();
        reg_fence(o);
        reg_fence(pa);
        release(j - 1);
#pragma unroll
        for (int nd = 0; nd < D / 8; ++nd) {
          o[4 * nd + 0] *= alpha[0];
          o[4 * nd + 1] *= alpha[0];
          o[4 * nd + 2] *= alpha[1];
          o[4 * nd + 3] *= alpha[1];
        }
        pack_p();
      }
      take_turn();
      fence_operands();
      issue_pv(n_tiles - 1);
      pass_turn(true);
      wgmma_wait<0>();
      reg_fence(o);
      reg_fence(pa);
      release(n_tiles - 1);
      kv += n_tiles;

      // Epilogue: O / l in bf16 into this warpgroup's rows of the staging
      // tile, once the TMA store of the item before has read them; then one
      // TMA store a slab, which clips rows past Sq and runs on while the
      // next item starts.
      float inv[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float l = row_sum[half];
        l += __shfl_xor_sync(0xffffffff, l, 1);
        l += __shfl_xor_sync(0xffffffff, l, 2);
        inv[half] = 1.f / l;
      }
      unsigned char* s_oc = s_o + c * 64 * kSlabRowBytes;
      if (t == 0) tma_store_wait_read();
      named_barrier_sync(1 + c, 128);
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        unsigned char* slab = s_oc + (nd / 8) * C::kBlockM * kSlabRowBytes;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = warp * 16 + g + 8 * half;
          *reinterpret_cast<uint32_t*>(slab + r * kSlabRowBytes + (((nd % 8) ^ (r % 8)) << 4) +
                                       4 * tq) =
              pack_bf16x2(o[4 * nd + 2 * half] * inv[half], o[4 * nd + 2 * half + 1] * inv[half]);
        }
      }
      fence_proxy_async_smem();
      named_barrier_sync(1 + c, 128);
      if (t == 0) {
        for (int h = 0; h < C::kSlabs; ++h)
          tma_store_3d(&tm_o, s_oc + h * C::kBlockM * kSlabRowBytes, col0 + h * kSlab,
                       q0 + c * 64, b);
        tma_store_commit();
      }
    }
    if (t == 0) tma_store_wait_all();
  }
}

template <int D, int kConsumers, int kBlockN, int kStages>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int batch, int sq, int sk,
                   int heads, float scale, cudaStream_t stream) {
  using C = Cfg<D, kConsumers, kBlockN, kStages>;
  const uint64_t cols = static_cast<uint64_t>(heads) * D;
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  cudaError_t err;
  if ((err = encode_tensor_map(&tm_q, q, cols, sq, batch, kSlab, 64)) != cudaSuccess ||
      (err = encode_tensor_map(&tm_k, k, cols, sk, batch, kSlab, kBlockN)) != cudaSuccess ||
      (err = encode_tensor_map(&tm_v, v, cols, sk, batch, kSlab, kBlockN)) != cudaSuccess ||
      (err = encode_tensor_map(&tm_o, o, cols, sq, batch, kSlab, 64)) != cudaSuccess)
    return err;
  auto kernel = mha_fwd_kernel<D, kConsumers, kBlockN, kStages>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return err;
  int device, sms;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  // Persistent: as many blocks as fit on the card at once, each walking items.
  const int q_tiles = (sq + C::kBlockM - 1) / C::kBlockM;
  const long long n_items = static_cast<long long>(q_tiles) * heads * batch;
  if (n_items > 0x7fffffff) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(std::min<long long>(n_items, 1LL * sms * C::kMinBlocks));
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(tm_q, tm_k, tm_v, tm_o, sk, q_tiles, heads,
                                                  static_cast<int>(n_items),
                                                  scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_plan(const TilePlan& p, const void* q, const void* k, const void* v, void* o,
                        int batch, int sq, int sk, int heads, float scale, cudaStream_t st) {
  constexpr int kStages = D == 64 ? 4 : 2;
  if (p.stages != kStages) return cudaErrorInvalidValue;
  if constexpr (D == 64) {
    if (p.block_m == 192 && p.block_n == 128)
      return launch<D, 3, 128, kStages>(q, k, v, o, batch, sq, sk, heads, scale, st);
  }
  if (p.block_m == 128 && p.block_n == 128)
    return launch<D, 2, 128, kStages>(q, k, v, o, batch, sq, sk, heads, scale, st);
  if (p.block_m == 64 && p.block_n == 64)
    return launch<D, 1, 64, kStages>(q, k, v, o, batch, sq, sk, heads, scale, st);
  return cudaErrorInvalidValue;
}

cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, int batch, int sq,
                     int sk, int heads, int head_dim, bool flash, float scale, void* stream) {
  if (batch < 1 || heads < 1 || sq < 1 || sk < 1 || !(scale >= 0.f) || !isfinite(scale))
    return cudaErrorInvalidValue;
  const TilePlan p = tile_plan(sq, sk, head_dim, flash);
  auto st = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return launch_plan<64>(p, q, k, v, o, batch, sq, sk, heads, scale, st);
  if (head_dim == 128) return launch_plan<128>(p, q, k, v, o, batch, sq, sk, heads, scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace ctrlv

// q: (batch, sq, heads*head_dim), k and v: (batch, sk, heads*head_dim), o like q;
// all contiguous bf16 on the current device, 16-byte aligned; scale >= 0.
// Returns a cudaError_t code.
extern "C" int ctrlv_mha_fwd(const void* q, const void* k, const void* v, void* o, int batch,
                             int sq, int sk, int heads, int head_dim, float scale, void* stream) {
  return ctrlv::dispatch(q, k, v, o, batch, sq, sk, heads, head_dim, false, scale, stream);
}

// The same operands seen as (batch, s, heads, head_dim): K8's entry point,
// which may take the 64-row instantiation (tile_plan).
extern "C" int ctrlv_flash_fwd(const void* q, const void* k, const void* v, void* o, int batch,
                               int sq, int sk, int heads, int head_dim, float scale,
                               void* stream) {
  return ctrlv::dispatch(q, k, v, o, batch, sq, sk, heads, head_dim, true, scale, stream);
}
