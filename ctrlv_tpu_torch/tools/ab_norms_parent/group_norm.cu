// The design that csrc/group_norm.cu replaced, kept as it was for tools/ab_norms.py,
// which builds it apart and times it against the present one.
//
// K4: GroupNorm with an optional SiLU over channels-first (B, C, *spatial)
// bf16 tensors. Replaces the Pallas kernel
// ctrlv_tpu/ops/group_norm.py::group_norm (_gn_kernel).
//
// What bounds it on an H100: device memory. Each element is read, takes about
// ten f32 operations and is written: 4 bytes moved per element, against the
// ~295 operations a byte at which arithmetic would be the limit.
//
// Design. The TPU kernel is channels-last: it holds one sample's (L, C) slab
// in VMEM and reduces C -> G with one-hot matmuls. Here the layout is
// channels-first, so one (sample, group) is one contiguous run of
// (C/G) * L elements and no group map exists. Two paths, chosen by the run
// length (the wrapper passes `splits`):
//   - splits == 1: one block per run. The run is copied into shared memory
//     with 16-byte loads while f32 sum and sum of squares accumulate, the
//     block reduces them, and the run is normalised out of shared memory:
//     one read and one write of device memory.
//   - splits > 1 (runs beyond shared memory: the temporal ResBlocks, the VAE
//     decoder): a run is cut into `splits` slices so that few long runs
//     still fill 132 SMs. A first kernel writes each slice's partial sums to
//     scratch; a second one adds a run's partials (in a fixed order: no
//     atomics, the same bits every time) and normalises its slice, reading it
//     again, mostly from L2.
// Statistics as the plain version: mean = s1/n, var = max(s2/n - mean^2, 0),
// rstd = rsqrt(var + eps); y = (x - mean) * rstd * gamma + beta in f32, SiLU
// in f32, one rounding to bf16. Runs whose length is not a multiple of 8 (so
// that a run need not start on a 16-byte boundary) take a scalar path.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ctrlv {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 512;

struct Params {
  const void* gamma;
  const void* beta;
  int run;      // elements of one (sample, group)
  int spatial;  // elements of one channel
  int cpg;      // channels per group
  int groups;
  int params_bf16;
  int silu;
  float eps;
};

__device__ __forceinline__ float load_param(const void* p, int i, int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const bf16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

// Sum over the block of (a, b); every thread gets the result.
__device__ __forceinline__ float2 block_sum(float a, float b) {
  __shared__ float red[2][kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffff, a, off);
    b += __shfl_xor_sync(0xffffffff, b, off);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // `red` may still be read from an earlier call
  if (lane == 0) {
    red[0][warp] = a;
    red[1][warp] = b;
  }
  __syncthreads();
  a = lane < kThreads / 32 ? red[0][lane] : 0.f;
  b = lane < kThreads / 32 ? red[1][lane] : 0.f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffff, a, off);
    b += __shfl_xor_sync(0xffffffff, b, off);
  }
  return make_float2(a, b);
}

__device__ __forceinline__ float finish(float x, float mean, float rstd, float g, float b,
                                        int silu) {
  float y = (x - mean) * rstd * g + b;
  if (silu) y = y / (1.f + __expf(-y));
  return y;
}

// Normalise elements [i0, i0 + 8) of a run (i0 a multiple of 8) held in `v`.
__device__ __forceinline__ uint4 apply8(uint4 v, int i0, int group, float mean, float rstd,
                                        const Params& p) {
  bf16* e = reinterpret_cast<bf16*>(&v);
  int c = group * p.cpg + i0 / p.spatial;
  int rem = i0 % p.spatial;
  float g = load_param(p.gamma, c, p.params_bf16);
  float b = load_param(p.beta, c, p.params_bf16);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    e[j] = __float2bfloat16(finish(__bfloat162float(e[j]), mean, rstd, g, b, p.silu));
    if (++rem == p.spatial && j < 7) {
      rem = 0;
      ++c;
      // The run's last element ends the group's last channel: c stays in range.
      g = load_param(p.gamma, c, p.params_bf16);
      b = load_param(p.beta, c, p.params_bf16);
    }
  }
  return v;
}

__device__ __forceinline__ float apply1(float x, int i, int group, float mean, float rstd,
                                        const Params& p) {
  const int c = group * p.cpg + i / p.spatial;
  return finish(x, mean, rstd, load_param(p.gamma, c, p.params_bf16),
                load_param(p.beta, c, p.params_bf16), p.silu);
}

__device__ __forceinline__ void accumulate8(uint4 v, float& s1, float& s2) {
  const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float x = __bfloat162float(e[j]);
    s1 += x;
    s2 += x * x;
  }
}

__device__ __forceinline__ void stats(float s1, float s2, int n, float eps, float& mean,
                                      float& rstd) {
  mean = s1 / static_cast<float>(n);
  const float var = fmaxf(s2 / static_cast<float>(n) - mean * mean, 0.f);
  rstd = rsqrtf(var + eps);
}

// One block per run; the run lives in dynamic shared memory between the
// statistics and the normalisation.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    gn_smem_kernel(const bf16* __restrict__ x, bf16* __restrict__ y, Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long r = blockIdx.x;
  const int group = static_cast<int>(r % p.groups);
  const bf16* xr = x + r * p.run;
  bf16* yr = y + r * p.run;
  const int n = p.run;
  float s1 = 0.f, s2 = 0.f;
  if (VEC) {
    uint4* s = reinterpret_cast<uint4*>(smem_raw);
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    for (int i = threadIdx.x; i < n / 8; i += kThreads) {
      const uint4 v = xv[i];
      s[i] = v;
      accumulate8(v, s1, s2);
    }
  } else {
    bf16* s = reinterpret_cast<bf16*>(smem_raw);
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const bf16 v = xr[i];
      s[i] = v;
      const float f = __bfloat162float(v);
      s1 += f;
      s2 += f * f;
    }
  }
  const float2 tot = block_sum(s1, s2);  // its barriers also publish the copy
  float mean, rstd;
  stats(tot.x, tot.y, p.run, p.eps, mean, rstd);
  if (VEC) {
    const uint4* s = reinterpret_cast<const uint4*>(smem_raw);
    uint4* yv = reinterpret_cast<uint4*>(yr);
    for (int i = threadIdx.x; i < n / 8; i += kThreads)
      yv[i] = apply8(s[i], 8 * i, group, mean, rstd, p);
  } else {
    const bf16* s = reinterpret_cast<const bf16*>(smem_raw);
    for (int i = threadIdx.x; i < n; i += kThreads)
      yr[i] = __float2bfloat16(apply1(__bfloat162float(s[i]), i, group, mean, rstd, p));
  }
}

// Slice `blockIdx.y` of run `blockIdx.x`: [lo, hi), lo a multiple of 8.
__device__ __forceinline__ void slice(int run, int splits, int& lo, int& hi) {
  const long long per = ((static_cast<long long>(run) + splits - 1) / splits + 7) / 8 * 8;
  const long long start = per * blockIdx.y;
  hi = start + per < run ? static_cast<int>(start + per) : run;
  lo = start < hi ? static_cast<int>(start) : hi;
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    gn_partial_kernel(const bf16* __restrict__ x, float* __restrict__ partial, Params p,
                      int splits) {
  const long long r = blockIdx.x;
  const bf16* xr = x + r * p.run;
  int lo, hi;
  slice(p.run, splits, lo, hi);
  float s1 = 0.f, s2 = 0.f;
  if (VEC) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    for (int i = lo / 8 + threadIdx.x; i < hi / 8; i += kThreads) accumulate8(xv[i], s1, s2);
  } else {
    for (int i = lo + threadIdx.x; i < hi; i += kThreads) {
      const float f = __bfloat162float(xr[i]);
      s1 += f;
      s2 += f * f;
    }
  }
  const float2 tot = block_sum(s1, s2);
  if (threadIdx.x == 0) {
    float* out = partial + (r * splits + blockIdx.y) * 2;
    out[0] = tot.x;
    out[1] = tot.y;
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    gn_apply_kernel(const bf16* __restrict__ x, bf16* __restrict__ y,
                    const float* __restrict__ partial, Params p, int splits) {
  const long long r = blockIdx.x;
  const int group = static_cast<int>(r % p.groups);
  const bf16* xr = x + r * p.run;
  bf16* yr = y + r * p.run;
  // Every thread adds the run's partials in the same order: a few hundred
  // cached loads, and no barrier.
  float s1 = 0.f, s2 = 0.f;
  const float* pr = partial + r * splits * 2;
  for (int i = 0; i < splits; ++i) {
    s1 += pr[2 * i];
    s2 += pr[2 * i + 1];
  }
  float mean, rstd;
  stats(s1, s2, p.run, p.eps, mean, rstd);
  int lo, hi;
  slice(p.run, splits, lo, hi);
  if (VEC) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    uint4* yv = reinterpret_cast<uint4*>(yr);
    for (int i = lo / 8 + threadIdx.x; i < hi / 8; i += kThreads)
      yv[i] = apply8(xv[i], 8 * i, group, mean, rstd, p);
  } else {
    for (int i = lo + threadIdx.x; i < hi; i += kThreads)
      yr[i] = __float2bfloat16(apply1(__bfloat162float(xr[i]), i, group, mean, rstd, p));
  }
}

template <bool VEC>
cudaError_t launch(const bf16* x, bf16* y, float* scratch, long long runs, Params p, int splits,
                   cudaStream_t stream) {
  if (splits == 1) {
    const int bytes = p.run * static_cast<int>(sizeof(bf16));
    cudaError_t err = cudaFuncSetAttribute(gn_smem_kernel<VEC>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    gn_smem_kernel<VEC><<<static_cast<unsigned>(runs), kThreads, bytes, stream>>>(x, y, p);
    return cudaGetLastError();
  }
  const dim3 grid(static_cast<unsigned>(runs), splits);
  gn_partial_kernel<VEC><<<grid, kThreads, 0, stream>>>(x, scratch, p, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_apply_kernel<VEC><<<grid, kThreads, 0, stream>>>(x, y, scratch, p, splits);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ctrlv

// x, y: (batch, groups * cpg, spatial...) contiguous bf16, seen as `runs` =
// batch * groups runs of `run` = cpg * spatial elements; gamma, beta: the
// groups * cpg channel parameters, bf16 or f32. With splits > 1, `scratch`
// holds runs * splits * 2 floats. Returns a cudaError_t code.
extern "C" int ctrlv_group_norm_fwd(const void* x, const void* gamma, const void* beta, void* y,
                                    void* scratch, long long runs, long long run,
                                    long long spatial, int cpg, int groups, int splits,
                                    int params_bf16, int silu, float eps, void* stream) {
  using ctrlv::bf16;
  if (runs < 1 || runs > 0x7fffffffLL || run < 1 || run > 0x3fffffffLL || spatial < 1 ||
      cpg < 1 || groups < 1 || run != spatial * cpg || splits < 1 || splits > 65535)
    return cudaErrorInvalidValue;
  if (splits == 1 && run * static_cast<long long>(sizeof(bf16)) > 200 * 1024)
    return cudaErrorInvalidValue;
  if (splits > 1 && scratch == nullptr) return cudaErrorInvalidValue;
  ctrlv::Params p{gamma, beta, static_cast<int>(run), static_cast<int>(spatial), cpg, groups,
                  params_bf16, silu, eps};
  const auto* xp = static_cast<const bf16*>(x);
  auto* yp = static_cast<bf16*>(y);
  auto* sp = static_cast<float*>(scratch);
  auto st = static_cast<cudaStream_t>(stream);
  return run % 8 == 0 ? ctrlv::launch<true>(xp, yp, sp, runs, p, splits, st)
                      : ctrlv::launch<false>(xp, yp, sp, runs, p, splits, st);
}
