// K5: LayerNorm over the last axis of (T, C) bf16 rows. Replaces the Pallas
// kernel ctrlv_tpu/ops/layer_norm.py::layer_norm (_ln_kernel).
//
// What bounds it on an H100: device memory. Each element is read once and
// written once, with about eight f32 operations between.
//
// Design. Rows are independent, so there is no reduction across blocks and
// no condition on T (the TPU kernel's row blocks had to divide it). One warp
// takes one row: lane l holds the 16-byte vectors l, l + 32, ... of the row
// in registers (C <= 2048 is at most 8 vectors a lane), so the row is read
// from device memory exactly once. Sum and sum of squares accumulate in f32
// and are combined with warp shuffles; mean = s1/C, var = max(s2/C - mean^2,
// 0), rstd = rsqrt(var + eps); y = (x - mean) * rstd * gamma + beta in f32,
// rounded once to bf16. A block holds 4 warps, hence 4 consecutive rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ctrlv {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;

__device__ __forceinline__ void load_params8(const void* p, int i0, int is_bf16, float (&out)[8]) {
  if (is_bf16) {
    const uint4 v = *reinterpret_cast<const uint4*>(static_cast<const bf16*>(p) + i0);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) out[j] = __bfloat162float(e[j]);
  } else {
    const float4 a = *reinterpret_cast<const float4*>(static_cast<const float*>(p) + i0);
    const float4 b = *reinterpret_cast<const float4*>(static_cast<const float*>(p) + i0 + 4);
    out[0] = a.x, out[1] = a.y, out[2] = a.z, out[3] = a.w;
    out[4] = b.x, out[5] = b.y, out[6] = b.z, out[7] = b.w;
  }
}

// NV: 16-byte vectors a lane holds, ceil(C / 256).
template <int NV>
__global__ void __launch_bounds__(kWarps * 32)
    layer_norm_kernel(const bf16* __restrict__ x, const void* __restrict__ gamma,
                      const void* __restrict__ beta, bf16* __restrict__ y, int rows, int c,
                      int params_bf16, float eps) {
  const int lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (row >= rows) return;  // no block-wide barrier below
  const int nvec = c / 8;
  const uint4* xv = reinterpret_cast<const uint4*>(x + row * c);
  uint4* yv = reinterpret_cast<uint4*>(y + row * c);

  uint4 v[NV];
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int idx = lane + 32 * i;
    if (idx < nvec) {
      v[i] = xv[idx];
      const bf16* e = reinterpret_cast<const bf16*>(&v[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float f = __bfloat162float(e[j]);
        s1 += f;
        s2 += f * f;
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s1 += __shfl_xor_sync(0xffffffff, s1, off);
    s2 += __shfl_xor_sync(0xffffffff, s2, off);
  }
  const float mean = s1 / static_cast<float>(c);
  const float var = fmaxf(s2 / static_cast<float>(c) - mean * mean, 0.f);
  const float rstd = rsqrtf(var + eps);

#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int idx = lane + 32 * i;
    if (idx < nvec) {
      float g[8], b[8];
      load_params8(gamma, idx * 8, params_bf16, g);
      load_params8(beta, idx * 8, params_bf16, b);
      bf16* e = reinterpret_cast<bf16*>(&v[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        e[j] = __float2bfloat16((__bfloat162float(e[j]) - mean) * rstd * g[j] + b[j]);
      yv[idx] = v[i];
    }
  }
}

template <int NV>
cudaError_t launch(const bf16* x, const void* gamma, const void* beta, bf16* y, int rows, int c,
                   int params_bf16, float eps, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((static_cast<long long>(rows) + kWarps - 1) / kWarps);
  layer_norm_kernel<NV><<<blocks, kWarps * 32, 0, stream>>>(x, gamma, beta, y, rows, c,
                                                            params_bf16, eps);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ctrlv

// x, y: (rows, width) contiguous bf16, width a multiple of 8 up to 2048;
// gamma, beta: (width,), bf16 or f32, 16-byte aligned. Returns a cudaError_t code.
extern "C" int ctrlv_layer_norm_fwd(const void* x, const void* gamma, const void* beta, void* y,
                                    int rows, int width, int params_bf16, float eps,
                                    void* stream) {
  using ctrlv::bf16;
  if (rows < 1 || width < 8 || width % 8 || width > 2048) return cudaErrorInvalidValue;
  const auto* xp = static_cast<const bf16*>(x);
  auto* yp = static_cast<bf16*>(y);
  auto st = static_cast<cudaStream_t>(stream);
  switch ((width + 255) / 256) {
#define CTRLV_LN_CASE(NV) \
  case NV:                \
    return ctrlv::launch<NV>(xp, gamma, beta, yp, rows, width, params_bf16, eps, st);
    CTRLV_LN_CASE(1)
    CTRLV_LN_CASE(2)
    CTRLV_LN_CASE(3)
    CTRLV_LN_CASE(4)
    CTRLV_LN_CASE(5)
    CTRLV_LN_CASE(6)
    CTRLV_LN_CASE(7)
    CTRLV_LN_CASE(8)
#undef CTRLV_LN_CASE
    default:
      return cudaErrorInvalidValue;
  }
}
