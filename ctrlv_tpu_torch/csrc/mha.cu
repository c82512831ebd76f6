// K1: spatial multi-head self-attention over (B, S, H*D), heads packed in the
// last axis, bf16 in and out. Replaces the Pallas kernel
// ctrlv_tpu/ops/mha.py::mha_attention (_mha_kernel).
//
// What bounds it on an H100: the tensor cores. At the sampler's shape
// (B=50, S=2560, H=5, D=64) one call is 4*B*S^2*H*D = 0.42 TFLOP against
// 0.33 GB moved.
//
// Design. The TPU kernel keeps all of K/V of one batch element in VMEM
// (3.3 MB at that shape); a Hopper block has at most 227 KB of shared memory.
// So this is a flash-style kernel:
//   - one block of 4 warps per (query tile of 64 rows, head, batch element);
//     each warp owns 16 query rows;
//   - K/V tiles of 64 rows are read straight from the (B, S, H*D) layout at
//     column h*D with row stride H*D (no head-major copy), double-buffered in
//     shared memory with cp.async;
//   - S = Q K^T and O += P V run on the tensor cores (mma.sync m16n8k16 bf16,
//     f32 accumulators); P stays in registers between the two products;
//   - online softmax in base 2 with f32 running max, sum and accumulator;
//     like the TPU kernel, the 1/sum is folded into the output;
//   - ragged query and key tiles are zero-filled on load, masked keys get
//     -inf logits, rows past S are not stored.
// Shared-memory rows are padded by 8 bf16 (16 bytes), so the 8 rows an
// ldmatrix reads fall in different banks.
//
// K8: the same kernel, through an entry point of its own, replaces the Pallas
// kernel ctrlv_tpu/ops/flash_attention.py::flash_attention (_attn_kernel),
// the one-pass attention over (B, S, H, D) at a few hundred tokens (640 and
// 160 in the sampler). A contiguous (B, S, H, D) tensor is the (B, S, H*D)
// tensor read here, so the TPU kernel's transpose to (B*H, S, D) has no
// counterpart. At (50, 640, 10, 64) a call is 52 GFLOP against 164 MB moved:
// about 320 operations a byte, at the edge between the two bounds. Ragged
// tiles are the common case there (160 tokens are 2.5 tiles of 64), so when
// the last 64-row query tile would be at most half full the entry point takes
// the instantiation with 2 warps and 32-row query tiles.
#include "mma_utils.cuh"

#include <math.h>

namespace ctrlv {
namespace {

constexpr int kBlockN = 64;  // keys per tile
constexpr int kPad = 8;

// kWarps warps, 16 query rows each: kBlockM = 16 * kWarps query rows per block.
template <int D, int kWarps>
constexpr int smem_bytes() {
  // Q tile + two stages of K and V tiles.
  return (16 * kWarps + 4 * kBlockN) * (D + kPad) * static_cast<int>(sizeof(bf16));
}

template <int D, int kWarps>
__global__ void __launch_bounds__(kWarps * 32)
    mha_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ o, int sq, int sk, int heads,
                   float scale_log2) {
  constexpr int SROW = D + kPad;
  constexpr int kBlockM = 16 * kWarps;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* s_q = reinterpret_cast<bf16*>(smem_raw);
  bf16* s_k = s_q + kBlockM * SROW;  // [2][kBlockN][SROW]
  bf16* s_v = s_k + 2 * kBlockN * SROW;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;  // fragment row within an 8-row group
  const int t = lane % 4;  // fragment column pair
  const int q0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long ld = static_cast<long long>(heads) * D;

  const bf16* qg = q + static_cast<long long>(b) * sq * ld + h * D;
  const bf16* kg = k + static_cast<long long>(b) * sk * ld + h * D;
  const bf16* vg = v + static_cast<long long>(b) * sk * ld + h * D;
  bf16* og = o + static_cast<long long>(b) * sq * ld + h * D;

  load_tile_async<kBlockM, D, SROW>(s_q, qg, ld, q0, sq, tid, kWarps * 32);
  load_tile_async<kBlockN, D, SROW>(s_k, kg, ld, 0, sk, tid, kWarps * 32);
  load_tile_async<kBlockN, D, SROW>(s_v, vg, ld, 0, sk, tid, kWarps * 32);
  cp_async_commit();

  uint32_t qf[D / 16][4];
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float row_max[2] = {-INFINITY, -INFINITY};
  float row_sum[2] = {0.f, 0.f};  // this thread's share; summed over the quad at the end

  const int n_tiles = (sk + kBlockN - 1) / kBlockN;
  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j & 1;
    if (j + 1 < n_tiles) {
      const int nxt = stage ^ 1;
      load_tile_async<kBlockN, D, SROW>(s_k + nxt * kBlockN * SROW, kg, ld, (j + 1) * kBlockN,
                                        sk, tid, kWarps * 32);
      load_tile_async<kBlockN, D, SROW>(s_v + nxt * kBlockN * SROW, vg, ld, (j + 1) * kBlockN,
                                        sk, tid, kWarps * 32);
    }
    cp_async_commit();  // possibly empty: keeps "all but the newest group" = tile j
    cp_async_wait<1>();
    __syncthreads();

    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int r = warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
        const int c = kk * 16 + (lane / 16) * 8;
        ldmatrix_x4(qf[kk], s_q + r * SROW + c);
      }
    }

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys.
    const bf16* sk_t = s_k + stage * kBlockN * SROW;
    const bf16* sv_t = s_v + stage * kBlockN * SROW;
    float s[kBlockN / 8][4];
#pragma unroll
    for (int i = 0; i < kBlockN / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nb = 0; nb < kBlockN / 16; ++nb) {
        uint32_t bfrag[4];
        const int r = nb * 16 + (lane % 8) + (lane / 16) * 8;
        const int c = kk * 16 + ((lane / 8) % 2) * 8;
        ldmatrix_x4(bfrag, sk_t + r * SROW + c);
        mma_bf16_16816(s[2 * nb], qf[kk], bfrag[0], bfrag[1]);
        mma_bf16_16816(s[2 * nb + 1], qf[kk], bfrag[2], bfrag[3]);
      }
    }

    // Online softmax (base 2) over rows g and g+8 of the warp's 16.
    const bool ragged = (j + 1) * kBlockN > sk;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mx = -INFINITY;
#pragma unroll
      for (int nb = 0; nb < kBlockN / 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = s[nb][2 * half + e] * scale_log2;
          if (ragged && j * kBlockN + nb * 8 + 2 * t + e >= sk) x = -INFINITY;
          s[nb][2 * half + e] = x;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 2));
      // Every tile holds at least one valid key, so m_new is finite.
      const float m_new = fmaxf(row_max[half], mx);
      const float alpha = exp2f(row_max[half] - m_new);
      row_max[half] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int nb = 0; nb < kBlockN / 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(s[nb][2 * half + e] - m_new);
          s[nb][2 * half + e] = p;
          sum += p;
        }
      }
      row_sum[half] = row_sum[half] * alpha + sum;
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        acc[nd][2 * half] *= alpha;
        acc[nd][2 * half + 1] *= alpha;
      }
    }

    // O += P V, with P (rounded to bf16) taken from the S accumulators.
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int nd = 0; nd < D / 16; ++nd) {
        uint32_t bfrag[4];
        const int r = kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
        const int c = nd * 16 + (lane / 16) * 8;
        ldmatrix_x4_trans(bfrag, sv_t + r * SROW + c);
        mma_bf16_16816(acc[2 * nd], pa, bfrag[0], bfrag[1]);
        mma_bf16_16816(acc[2 * nd + 1], pa, bfrag[2], bfrag[3]);
      }
    }
    __syncthreads();  // the next iteration's copy overwrites this stage
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float l = row_sum[half];
    l += __shfl_xor_sync(0xffffffff, l, 1);
    l += __shfl_xor_sync(0xffffffff, l, 2);
    const float inv = 1.f / l;
    const int row = q0 + warp * 16 + g + 8 * half;
    if (row < sq) {
      bf16* orow = og + static_cast<long long>(row) * ld;
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        *reinterpret_cast<uint32_t*>(orow + nd * 8 + 2 * t) =
            pack_bf16x2(acc[nd][2 * half] * inv, acc[nd][2 * half + 1] * inv);
      }
    }
  }
}

template <int D, int kWarps>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int batch, int sq,
                   int sk, int heads, float scale, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D, kWarps>();
  constexpr int kBlockM = 16 * kWarps;
  cudaError_t err = cudaFuncSetAttribute(mha_fwd_kernel<D, kWarps>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBlockM - 1) / kBlockM, heads, batch);
  const float scale_log2 = scale * 1.4426950408889634f;
  mha_fwd_kernel<D, kWarps>
      <<<grid, kWarps * 32, bytes, stream>>>(q, k, v, o, sq, sk, heads, scale_log2);
  return cudaGetLastError();
}

// small_tiles: 32-row query tiles (2 warps) instead of 64-row ones (4 warps).
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, int batch, int sq,
                     int sk, int heads, int head_dim, bool small_tiles, float scale,
                     void* stream) {
  const auto* qp = static_cast<const bf16*>(q);
  const auto* kp = static_cast<const bf16*>(k);
  const auto* vp = static_cast<const bf16*>(v);
  auto* op = static_cast<bf16*>(o);
  auto st = static_cast<cudaStream_t>(stream);
  if (batch < 1 || batch > 65535 || heads < 1 || heads > 65535 || sq < 1 || sk < 1)
    return cudaErrorInvalidValue;
  if (head_dim == 64)
    return small_tiles ? launch<64, 2>(qp, kp, vp, op, batch, sq, sk, heads, scale, st)
                       : launch<64, 4>(qp, kp, vp, op, batch, sq, sk, heads, scale, st);
  if (head_dim == 128)
    return small_tiles ? launch<128, 2>(qp, kp, vp, op, batch, sq, sk, heads, scale, st)
                       : launch<128, 4>(qp, kp, vp, op, batch, sq, sk, heads, scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace ctrlv

// q: (batch, sq, heads*head_dim), k and v: (batch, sk, heads*head_dim), o like q;
// all contiguous bf16 on the current device. Returns a cudaError_t code.
extern "C" int ctrlv_mha_fwd(const void* q, const void* k, const void* v, void* o, int batch,
                             int sq, int sk, int heads, int head_dim, float scale, void* stream) {
  return ctrlv::dispatch(q, k, v, o, batch, sq, sk, heads, head_dim, false, scale, stream);
}

// The same operands seen as (batch, s, heads, head_dim): K8's entry point.
extern "C" int ctrlv_flash_fwd(const void* q, const void* k, const void* v, void* o, int batch,
                               int sq, int sk, int heads, int head_dim, float scale,
                               void* stream) {
  const int tail = sq % 64;
  const bool small_tiles = tail != 0 && tail <= 32;
  return ctrlv::dispatch(q, k, v, o, batch, sq, sk, heads, head_dim, small_tiles, scale, stream);
}
