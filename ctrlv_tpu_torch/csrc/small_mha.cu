// K2: temporal self-attention over (N, F, H*D) with few frames (F <= 64) and
// many pixels (N), heads packed in the last axis, bf16 in and out. Replaces
// the Pallas kernel ctrlv_tpu/ops/mha.py::small_mha_attention (_small_kernel).
//
// What bounds it on an H100: device memory. At the sampler's largest shape
// (N=5120, F=25, H*D=320) one call moves ~0.33 GB for ~4 GFLOP, some 12
// operations a byte, far under the ~295 at which the tensor cores would be
// the limit.
//
// Design. One warp per (pixel n, head h); a block of 4 warps takes 4
// consecutive (n, h) pairs, so together they read neighbouring columns of
// the same rows. Each warp copies its F rows of Q, K and V (D bf16 each, 16
// bytes per cp.async, 8 lanes to a 128-byte row) into its own slice of
// shared memory, zero-filling rows F..FP-1 (FP = F rounded up to 32 or 64).
// The FxF scores never leave registers: for each 16-row slab, S = Q K^T and
// O = P V run on the tensor cores (mma.sync m16n8k16, f32 accumulators),
// the padded keys get -inf logits, and the softmax is exact. As in the TPU
// kernel, P is normalised in f32 before it is rounded to bf16. Each warp
// writes only its head's D columns of rows < F.
//
// K3: the same kernel reads the frames-major layout (B*F, S, H*D), the UNet's
// own, and replaces ctrlv_tpu/ops/mha.py::small_mha_attention_fm
// (_small_fm_kernel). The TPU kernel transposes its (F, nb, HD) slab in VMEM
// so that no transposed copy reaches device memory; here only the addresses
// change: the warp of pixel (b, s) and head h finds its F rows S*H*D elements
// apart, starting at ((b*F)*S + s)*H*D + h*D, and writes its output there.
// Each row is still one 128- or 256-byte segment read with 16-byte loads, and
// the 4 warps of a block still cover neighbouring heads of one pixel, so
// every sector fetched is used; what is lost against K2 is only that a
// warp's rows no longer share a DRAM page.
#include "mma_utils.cuh"

#include <math.h>

namespace ctrlv {
namespace {

constexpr int kWarps = 4;
constexpr int kPad = 8;

template <int FP, int D>
__host__ __device__ constexpr int warp_smem_elems() {
  return 3 * FP * (D + kPad);
}

template <int FP, int D>
__global__ void __launch_bounds__(kWarps * 32)
    small_mha_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ o, int n, int f, int heads,
                         int fm_s, float scale_log2) {
  constexpr int SROW = D + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  const long long pair = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (pair >= static_cast<long long>(n) * heads) return;  // no block-wide barrier below
  const long long pix = pair / heads;
  const int h = static_cast<int>(pair % heads);
  const long long hd = static_cast<long long>(heads) * D;
  // (N, F, H*D): the pixel's rows follow each other. Frames-major
  // (B*F, S, H*D) with S = fm_s: they lie S rows apart.
  const long long ld = fm_s > 0 ? fm_s * hd : hd;
  const long long base =
      (fm_s > 0 ? (pix / fm_s) * f * fm_s + pix % fm_s : pix * f) * hd + h * D;

  bf16* s_q = reinterpret_cast<bf16*>(smem_raw) + warp * warp_smem_elems<FP, D>();
  bf16* s_k = s_q + FP * SROW;
  bf16* s_v = s_k + FP * SROW;
  load_tile_async<FP, D, SROW>(s_q, q + base, ld, 0, f, lane, 32);
  load_tile_async<FP, D, SROW>(s_k, k + base, ld, 0, f, lane, 32);
  load_tile_async<FP, D, SROW>(s_v, v + base, ld, 0, f, lane, 32);
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();

#pragma unroll 1
  for (int m0 = 0; m0 < FP; m0 += 16) {
    if (m0 >= f) break;
    float s[FP / 8][4];
#pragma unroll
    for (int i = 0; i < FP / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4];
      ldmatrix_x4(qa, s_q + (m0 + (lane % 8) + ((lane / 8) % 2) * 8) * SROW + kk * 16 +
                          (lane / 16) * 8);
#pragma unroll
      for (int nb = 0; nb < FP / 16; ++nb) {
        uint32_t bfrag[4];
        ldmatrix_x4(bfrag, s_k + (nb * 16 + (lane % 8) + (lane / 16) * 8) * SROW + kk * 16 +
                               ((lane / 8) % 2) * 8);
        mma_bf16_16816(s[2 * nb], qa, bfrag[0], bfrag[1]);
        mma_bf16_16816(s[2 * nb + 1], qa, bfrag[2], bfrag[3]);
      }
    }

    // Exact softmax over the row's F keys, rows g and g+8 of the slab.
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mx = -INFINITY;
#pragma unroll
      for (int nb = 0; nb < FP / 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = s[nb][2 * half + e] * scale_log2;
          if (nb * 8 + 2 * t + e >= f) x = -INFINITY;
          s[nb][2 * half + e] = x;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 2));
      float sum = 0.f;
#pragma unroll
      for (int nb = 0; nb < FP / 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(s[nb][2 * half + e] - mx);
          s[nb][2 * half + e] = p;
          sum += p;
        }
      }
      sum += __shfl_xor_sync(0xffffffff, sum, 1);
      sum += __shfl_xor_sync(0xffffffff, sum, 2);
      const float inv = 1.f / sum;
#pragma unroll
      for (int nb = 0; nb < FP / 8; ++nb) {
        s[nb][2 * half] *= inv;
        s[nb][2 * half + 1] *= inv;
      }
    }

    float acc[D / 8][4];
#pragma unroll
    for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < FP / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int nd = 0; nd < D / 16; ++nd) {
        uint32_t bfrag[4];
        ldmatrix_x4_trans(bfrag, s_v + (kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * SROW +
                                     nd * 16 + (lane / 16) * 8);
        mma_bf16_16816(acc[2 * nd], pa, bfrag[0], bfrag[1]);
        mma_bf16_16816(acc[2 * nd + 1], pa, bfrag[2], bfrag[3]);
      }
    }

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + g + 8 * half;
      if (row < f) {
        bf16* orow = o + base + row * ld;
#pragma unroll
        for (int nd = 0; nd < D / 8; ++nd) {
          *reinterpret_cast<uint32_t*>(orow + nd * 8 + 2 * t) =
              pack_bf16x2(acc[nd][2 * half], acc[nd][2 * half + 1]);
        }
      }
    }
  }
}

template <int FP, int D>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int n, int f, int heads,
                   int fm_s, float scale, cudaStream_t stream) {
  constexpr int bytes = kWarps * warp_smem_elems<FP, D>() * static_cast<int>(sizeof(bf16));
  cudaError_t err = cudaFuncSetAttribute(small_mha_fwd_kernel<FP, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const long long pairs = static_cast<long long>(n) * heads;
  const long long blocks = (pairs + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const float scale_log2 = scale * 1.4426950408889634f;
  small_mha_fwd_kernel<FP, D><<<static_cast<unsigned>(blocks), kWarps * 32, bytes, stream>>>(
      q, k, v, o, n, f, heads, fm_s, scale_log2);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ctrlv

namespace ctrlv {
namespace {

cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, long long n, int frames,
                     int heads, int head_dim, int fm_s, float scale, void* stream) {
  const auto* qp = static_cast<const bf16*>(q);
  const auto* kp = static_cast<const bf16*>(k);
  const auto* vp = static_cast<const bf16*>(v);
  auto* op = static_cast<bf16*>(o);
  auto st = static_cast<cudaStream_t>(stream);
  if (n < 1 || n > 0x7fffffffLL || frames < 1 || frames > 64 || heads < 1)
    return cudaErrorInvalidValue;
  const int ni = static_cast<int>(n);
  const bool wide = frames > 32;
  if (head_dim == 64)
    return wide ? launch<64, 64>(qp, kp, vp, op, ni, frames, heads, fm_s, scale, st)
                : launch<32, 64>(qp, kp, vp, op, ni, frames, heads, fm_s, scale, st);
  if (head_dim == 128)
    return wide ? launch<64, 128>(qp, kp, vp, op, ni, frames, heads, fm_s, scale, st)
                : launch<32, 128>(qp, kp, vp, op, ni, frames, heads, fm_s, scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace ctrlv

// q, k, v, o: (n, frames, heads*head_dim) contiguous bf16 on the current
// device, 1 <= frames <= 64. Returns a cudaError_t code.
extern "C" int ctrlv_small_mha_fwd(const void* q, const void* k, const void* v, void* o, int n,
                                   int frames, int heads, int head_dim, float scale,
                                   void* stream) {
  return ctrlv::dispatch(q, k, v, o, n, frames, heads, head_dim, 0, scale, stream);
}

// Frames-major: q, k, v, o are (batch*frames, s, heads*head_dim) contiguous
// bf16; attention runs over the frames of each of the batch*s pixels.
extern "C" int ctrlv_small_mha_fm_fwd(const void* q, const void* k, const void* v, void* o,
                                      int batch, int frames, int s, int heads, int head_dim,
                                      float scale, void* stream) {
  if (batch < 1 || s < 1) return cudaErrorInvalidValue;
  return ctrlv::dispatch(q, k, v, o, static_cast<long long>(batch) * s, frames, heads, head_dim,
                         s, scale, stream);
}
