// K5: LayerNorm over the last axis of (T, C) bf16 rows. Replaces the Pallas
// kernel ctrlv_tpu/ops/layer_norm.py::layer_norm (_ln_kernel).
//
// What bounds it on an H100: device memory. Each element is read once and
// written once (4 bytes), with about eight f32 operations between.
//
// Design: a persistent row walker. The grid is sized by the wrapper from the
// SM count (ops/layer_norm.py::_plan), and each warp walks groups of rows in a
// fixed stride until the rows run out. A row of C = 8 * nvec elements is read
// as nvec 16-byte vectors by L lanes, V vectors a lane:
//   L = min(32, the power of two at or above ceil(nvec / 5)), V = ceil(nvec / L),
// so the model's widths 320, 640 and 1280 (40, 80, 160 vectors) are 8, 16
// and 32 lanes x 5 vectors, and a warp takes R = 32 / L = 4, 2 or 1 rows at
// once with every lane loaded. Any other width the gate admits (a multiple of
// 8 up to 2048) gets the same rule, V <= 8. Lane l of a row holds vectors
// l, l + L, ..., so neighbouring lanes read neighbouring 16 bytes.
//   - gamma and beta are loaded once, into registers, for the whole walk;
//   - the next group's vectors are loaded into registers before the current
//     group's statistics and stores, so a load is in flight during the
//     shuffles and the arithmetic (a ring of row groups in shared memory,
//     filled by 1-D bulk copies, lost to it on the card: PERF.md, Findings);
//   - the result goes out as 16-byte stores.
// Statistics as the plain version: f32 sums of x and x^2 over the row (each
// lane its own, then a butterfly over the row's L lanes: a fixed order, the
// same bits every run), mean = s1/C, var = max(s2/C - mean^2, 0),
// rstd = rsqrt(var + eps); y = (x - mean) * rstd * gamma + beta in f32,
// rounded once to bf16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_utils.cuh"  // pack_bf16x2

namespace ctrlv {
namespace {

constexpr int kWarps = 8;  // 256 threads a block

// Eight parameters (gamma or beta) of one 16-byte vector of x, in registers:
// one uint4 of bf16, or two float4 of f32.
template <typename P>
struct Params8;

template <>
struct Params8<bf16> {
  uint4 v;
  __device__ __forceinline__ void load(const void* p, int i0) {
    v = *reinterpret_cast<const uint4*>(static_cast<const bf16*>(p) + i0);
  }
  __device__ __forceinline__ float get(int j) const {
    return __bfloat162float(reinterpret_cast<const bf16*>(&v)[j]);
  }
};

template <>
struct Params8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const void* p, int i0) {
    const float4* q = reinterpret_cast<const float4*>(static_cast<const float*>(p) + i0);
    a = q[0];
    b = q[1];
  }
  __device__ __forceinline__ float get(int j) const {
    switch (j) {
      case 0: return a.x;
      case 1: return a.y;
      case 2: return a.z;
      case 3: return a.w;
      case 4: return b.x;
      case 5: return b.y;
      case 6: return b.z;
      default: return b.w;
    }
  }
};

// Row statistics of the vectors a lane holds, reduced over the row's L lanes.
template <int L, int V>
__device__ __forceinline__ void row_stats(const uint4 (&v)[V], int c, float eps, float& mean,
                                          float& rstd) {
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const bf16* e = reinterpret_cast<const bf16*>(&v[i]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float f = __bfloat162float(e[j]);
      s1 += f;
      s2 += f * f;
    }
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) {
    s1 += __shfl_xor_sync(0xffffffff, s1, off);
    s2 += __shfl_xor_sync(0xffffffff, s2, off);
  }
  mean = s1 / static_cast<float>(c);
  const float var = fmaxf(s2 / static_cast<float>(c) - mean * mean, 0.f);
  rstd = rsqrtf(var + eps);
}

template <int L, int V, typename P>
__device__ __forceinline__ void store_row(const uint4 (&v)[V], const Params8<P> (&g)[V],
                                          const Params8<P> (&b)[V], float mean, float rstd,
                                          uint4* yrow, int li, int nvec) {
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int idx = li + L * i;
    if (idx < nvec) {
      const bf16* e = reinterpret_cast<const bf16*>(&v[i]);
      uint4 o;
      uint32_t* w = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        const float y0 = (__bfloat162float(e[j]) - mean) * rstd * g[i].get(j) + b[i].get(j);
        const float y1 =
            (__bfloat162float(e[j + 1]) - mean) * rstd * g[i].get(j + 1) + b[i].get(j + 1);
        w[j / 2] = pack_bf16x2(y0, y1);
      }
      yrow[idx] = o;
    }
  }
}

template <int L, int V, typename P>
__device__ __forceinline__ void load_params(Params8<P> (&g)[V], Params8<P> (&b)[V],
                                            const void* gamma, const void* beta, int li,
                                            int nvec) {
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int idx = li + L * i;
    if (idx < nvec) {
      g[i].load(gamma, 8 * idx);
      b[i].load(beta, 8 * idx);
    }
  }
}

// The vectors of `row` that lane `li` holds; zeros past the rows or the row.
template <int L, int V>
__device__ __forceinline__ void load_row(uint4 (&v)[V], const bf16* __restrict__ x, long long row,
                                         long long rows, int c, int li, int nvec) {
  const uint4* xv = reinterpret_cast<const uint4*>(x + row * c);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int idx = li + L * i;
    v[i] = row < rows && idx < nvec ? xv[idx] : make_uint4(0, 0, 0, 0);
  }
}

// The next group's vectors are in flight during this one's work.
template <int L, int V, typename P>
__global__ void __launch_bounds__(kWarps * 32)
    ln_walk_kernel(const bf16* __restrict__ x, const void* __restrict__ gamma,
                   const void* __restrict__ beta, bf16* __restrict__ y, long long rows, int c,
                   float eps) {
  constexpr int R = 32 / L;
  const int lane = threadIdx.x % 32, sub = lane / L, li = lane % L;
  const int nvec = c / 8;
  Params8<P> g[V], b[V];
  load_params<L, V, P>(g, b, gamma, beta, li, nvec);
  const long long groups = (rows + R - 1) / R;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  long long grp = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  uint4 cur[V];
  load_row<L, V>(cur, x, grp * R + sub, rows, c, li, nvec);
  for (; grp < groups; grp += stride) {  // warp-uniform: the shuffles see every lane
    uint4 nxt[V];
    load_row<L, V>(nxt, x, (grp + stride) * R + sub, rows, c, li, nvec);
    float mean, rstd;
    row_stats<L, V>(cur, c, eps, mean, rstd);
    const long long row = grp * R + sub;
    if (row < rows)
      store_row<L, V, P>(cur, g, b, mean, rstd, reinterpret_cast<uint4*>(y + row * c), li, nvec);
#pragma unroll
    for (int i = 0; i < V; ++i) cur[i] = nxt[i];
  }
}

template <int L, int V, typename P>
cudaError_t launch(const bf16* x, const void* gamma, const void* beta, bf16* y, long long rows,
                   int c, float eps, int blocks, cudaStream_t stream) {
  ln_walk_kernel<L, V, P><<<blocks, kWarps * 32, 0, stream>>>(x, gamma, beta, y, rows, c, eps);
  return cudaGetLastError();
}

template <typename P>
cudaError_t dispatch(int lanes, int vecs, const bf16* x, const void* gamma, const void* beta,
                     bf16* y, long long rows, int c, float eps, int blocks,
                     cudaStream_t stream) {
  switch (lanes * 16 + vecs) {
#define CTRLV_LN_CASE(L, V) \
  case L * 16 + V:          \
    return launch<L, V, P>(x, gamma, beta, y, rows, c, eps, blocks, stream);
    CTRLV_LN_CASE(1, 1)
    CTRLV_LN_CASE(1, 2)
    CTRLV_LN_CASE(1, 3)
    CTRLV_LN_CASE(1, 4)
    CTRLV_LN_CASE(1, 5)
    CTRLV_LN_CASE(2, 3)
    CTRLV_LN_CASE(2, 4)
    CTRLV_LN_CASE(2, 5)
    CTRLV_LN_CASE(4, 3)
    CTRLV_LN_CASE(4, 4)
    CTRLV_LN_CASE(4, 5)
    CTRLV_LN_CASE(8, 3)
    CTRLV_LN_CASE(8, 4)
    CTRLV_LN_CASE(8, 5)
    CTRLV_LN_CASE(16, 3)
    CTRLV_LN_CASE(16, 4)
    CTRLV_LN_CASE(16, 5)
    CTRLV_LN_CASE(32, 3)
    CTRLV_LN_CASE(32, 4)
    CTRLV_LN_CASE(32, 5)
    CTRLV_LN_CASE(32, 6)
    CTRLV_LN_CASE(32, 7)
    CTRLV_LN_CASE(32, 8)
#undef CTRLV_LN_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace ctrlv

// x, y: (rows, width) contiguous bf16, 16-byte aligned, width a multiple of 8
// up to 2048; gamma, beta: (width,), bf16 or f32, 16-byte aligned; `blocks`:
// the persistent grid. Returns a cudaError_t code.
extern "C" int ctrlv_layer_norm_fwd(const void* x, const void* gamma, const void* beta, void* y,
                                    int rows, int width, int params_bf16, float eps, int blocks,
                                    void* stream) {
  using ctrlv::bf16;
  if (rows < 1 || width < 8 || width % 8 || width > 2048 || blocks < 1)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(y) % 16)
    return cudaErrorMisalignedAddress;
  const int nvec = width / 8;
  int lanes = 1;
  while (lanes < 32 && lanes * 5 < nvec) lanes *= 2;  // the power of two at or above nvec / 5
  const int vecs = (nvec + lanes - 1) / lanes;
  const auto* xp = static_cast<const bf16*>(x);
  auto* yp = static_cast<bf16*>(y);
  auto st = static_cast<cudaStream_t>(stream);
  return params_bf16
             ? ctrlv::dispatch<bf16>(lanes, vecs, xp, gamma, beta, yp, rows, width, eps, blocks,
                                     st)
             : ctrlv::dispatch<float>(lanes, vecs, xp, gamma, beta, yp, rows, width, eps, blocks,
                                      st);
}
