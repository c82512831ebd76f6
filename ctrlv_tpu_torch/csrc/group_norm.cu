// K4: GroupNorm with an optional SiLU over channels-first (B, C, *spatial)
// bf16 tensors. Replaces the Pallas kernel
// ctrlv_tpu/ops/group_norm.py::group_norm (_gn_kernel).
//
// What bounds it on an H100: device memory. Each element is read, takes about
// ten f32 operations (fifteen with the SiLU) and is written: 4 bytes moved an
// element, against the ~295 operations a byte at which arithmetic would be
// the limit. So an element should cross device memory twice, once each way.
//
// Design. The TPU kernel is channels-last: it holds one sample's (L, C) slab
// in VMEM and reduces C -> G with one-hot matmuls. Here the layout is
// channels-first, so one (sample, group) is one contiguous run of
// (C/G) * L elements and no group map exists. The wrapper's plan
// (ops/group_norm.py::_plan, a pure function of the shape) picks one of three
// paths and passes its numbers:
//   - short runs (kShort), whose items fit a ring in shared memory: a
//     persistent grid whose blocks walk items of `n` consecutive runs. Thread
//     0 fills a ring of `stages` item buffers with 1-D bulk copies
//     (cp.async.bulk), each signalled on an mbarrier, so the next items are
//     in flight while the block reduces and normalises the current one from
//     shared memory. Each run of an item has kThreads / n threads.
//   - long runs that fit a cluster's shared memory (kCluster): a thread block
//     cluster of `n` CTAs takes one run at a time; CTA `rank` bulk-copies its
//     slice into its own shared memory (in 16 KB chunks, each on its own
//     mbarrier, summed as they land), publishes its partial sums, and after a
//     cluster barrier adds all CTAs' partials from distributed shared memory
//     in rank order. It then normalises its slice from shared memory: one read
//     and one write of device memory. As many clusters as the card holds at
//     once (cudaOccupancyMaxActiveClusters) walk the runs, each chunk copied
//     for the next run as soon as it is normalised for this one; where the
//     card finds no room for one cluster, the launch returns an error and
//     nothing gives way.
//   - runs beyond a cluster (kTwoPass), or whose runs or channels do not start
//     on a 16-byte boundary: `n` slices a run over as many blocks. A first
//     kernel writes each slice's partial sums to scratch; a second adds a
//     run's partials (in a fixed order) and normalises its slice, walking the
//     blocks in reverse, so that the slices the first kernel read last, which
//     may still be in L2, are read first.
// In every path a run's parameters are read once a channel: the short and
// cluster paths fold rstd * gamma and beta into a table of (scale, shift) in
// shared memory; the two-pass path keeps the current channel's in registers.
// Statistics as the plain version: f32 sums of x and x^2 (no atomics; every
// sum adds in a fixed order, so two runs give the same bits), mean = s1/n,
// var = max(s2/n - mean^2, 0), rstd = rsqrt(var + eps); y = (x - mean) *
// (rstd * gamma) + beta in f32, SiLU in f32, one rounding to bf16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_utils.cuh"

namespace ctrlv {
namespace {

constexpr int kThreads = 256;       // the short-run and cluster kernels
constexpr int kSplitThreads = 512;  // the two-pass kernels
constexpr int kHeader = 1024;       // barriers, block sums, statistics; then the table
constexpr int kMaxStages = 8;
constexpr int kChunk = 8192;  // elements of one bulk copy of the cluster kernel (16 KB)
constexpr int kMaxChunks = 16;
constexpr int kMaxCluster = 16;

enum Path { kShort = 0, kCluster = 1, kTwoPass = 2 };

struct Args {
  const bf16* x;
  bf16* y;
  const void* gamma;
  const void* beta;
  long long runs;
  int run;      // elements of one (sample, group)
  int spatial;  // elements of one channel
  int cpg;      // channels per group
  int groups;
  int params_bf16;
  float eps;
  unsigned long long vec_magic;   // vector v of a run lies in channel quot(v, vec_magic)
  unsigned long long elem_magic;  // element i of a run lies in channel quot(i, elem_magic)
};

__host__ __device__ inline int round128(long long bytes) {
  return static_cast<int>((bytes + 127) / 128 * 128);
}

// floor(n / d) for n, d < 2^32 from magic = floor((2^64 - 1) / d) + 1 (0 for d = 1).
__device__ __forceinline__ unsigned quot(unsigned n, unsigned long long magic) {
  return magic ? static_cast<unsigned>(__umul64hi(n, magic)) : n;
}

unsigned long long magic_for(unsigned long long d) { return d <= 1 ? 0 : ~0ull / d + 1; }

__device__ __forceinline__ float load_param(const void* p, int i, int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const bf16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

// SiLU as y / (1 + exp(-y)), as K7 and the plain version: a form through
// tanh.approx (about 2^-11 relative) would lose bf16 ulps where 1 + tanh(y/2)
// cancels, at y below about -4.
template <bool SILU>
__device__ __forceinline__ float finish(float x, float mean, float scale, float shift) {
  const float y = (x - mean) * scale + shift;
  return SILU ? __fdividef(y, 1.f + __expf(-y)) : y;
}

template <bool SILU>
__device__ __forceinline__ uint4 norm8(uint4 v, float mean, float2 t) {
  const bf16* e = reinterpret_cast<const bf16*>(&v);
  uint4 o;
  uint32_t* w = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
  for (int j = 0; j < 8; j += 2)
    w[j / 2] = pack_bf16x2(finish<SILU>(__bfloat162float(e[j]), mean, t.x, t.y),
                           finish<SILU>(__bfloat162float(e[j + 1]), mean, t.x, t.y));
  return o;
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

// Sum of (a, b) over groups of `wpr` consecutive warps; every thread gets its
// group's, added in warp order. `red` holds 2 floats a warp; it may be written
// again only after a later __syncthreads.
__device__ __forceinline__ float2 group_sum(float a, float b, float* red, int wpr) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffff, a, off);
    b += __shfl_xor_sync(0xffffffff, b, off);
  }
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    red[2 * warp] = a;
    red[2 * warp + 1] = b;
  }
  __syncthreads();
  float s1 = 0.f, s2 = 0.f;
  for (int w = warp / wpr * wpr, end = w + wpr; w < end; ++w) {
    s1 += red[2 * w];
    s2 += red[2 * w + 1];
  }
  return make_float2(s1, s2);
}

// (rstd * gamma, beta) of the `cpg` channels of run `r`'s group, from `threads`
// threads numbered `t`.
__device__ __forceinline__ void fill_table(float2* tab, const Args& a, long long r, float rstd,
                                           int t, int threads) {
  const int c0 = static_cast<int>(r % a.groups) * a.cpg;
  for (int q = t; q < a.cpg; q += threads)
    tab[q] = make_float2(rstd * load_param(a.gamma, c0 + q, a.params_bf16),
                         load_param(a.beta, c0 + q, a.params_bf16));
}

// Short runs: a persistent walk over items of `k` runs through a ring of
// `stages` buffers of `stage_bytes`.
template <bool SILU>
__global__ void __launch_bounds__(kThreads)
    gn_short_kernel(Args a, int k, int stages, int stage_bytes) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);    // [kMaxStages]
  float* red = reinterpret_cast<float*>(smem + 64);      // [2 * kThreads / 32]
  float2* tab = reinterpret_cast<float2*>(smem + kHeader);  // [k * cpg]
  unsigned char* ring = smem + kHeader + round128(8LL * k * a.cpg);
  const long long n_items = (a.runs + k - 1) / k;
  const int tpr = kThreads / k;
  const int j = threadIdx.x / tpr, t = threadIdx.x % tpr;
  const int nv = a.run / 8;
  auto issue = [&](long long item, int s) {
    const long long r0 = item * k;
    const long long n = a.runs - r0 < k ? a.runs - r0 : k;
    const uint32_t bytes = static_cast<uint32_t>(n * a.run * 2);
    mbar_arrive_expect_tx(&full[s], bytes);
    bulk_load(ring + s * stage_bytes, a.x + r0 * a.run, bytes, &full[s]);
  };
  long long item = blockIdx.x;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&full[s], 1);
    fence_mbar_init();
    for (int s = 0; s < stages; ++s)
      if (item + static_cast<long long>(s) * gridDim.x < n_items)
        issue(item + static_cast<long long>(s) * gridDim.x, s);
  }
  __syncthreads();
  for (int u = 0; item < n_items; item += gridDim.x, ++u) {
    const int s = u % stages;
    mbar_wait(&full[s], (u / stages) & 1);
    const uint4* xs = reinterpret_cast<const uint4*>(ring + s * stage_bytes) + j * nv;
    const long long r = item * k + j;
    const bool live = r < a.runs;
    float s1 = 0.f, s2 = 0.f;
    if (live)
      for (int v = t; v < nv; v += tpr) accumulate8(xs[v], s1, s2);
    const float2 tot = group_sum(s1, s2, red, tpr / 32);
    float mean, rstd;
    stats(tot.x, tot.y, a.run, a.eps, mean, rstd);
    if (live) fill_table(tab + j * a.cpg, a, r, rstd, t, tpr);
    __syncthreads();
    if (live) {
      const float2* tj = tab + j * a.cpg;
      uint4* yv = reinterpret_cast<uint4*>(a.y + r * a.run);
      for (int v = t; v < nv; v += tpr) yv[v] = norm8<SILU>(xs[v], mean, tj[quot(v, a.vec_magic)]);
    }
    __syncthreads();  // stage s, the table and the block sums are free again
    if (threadIdx.x == 0 && item + static_cast<long long>(stages) * gridDim.x < n_items)
      issue(item + static_cast<long long>(stages) * gridDim.x, s);
  }
}

// Long runs: a cluster of CTAs a run, each CTA a slice of `slice` elements;
// the clusters walk the runs in a stride of the grid's clusters. As soon as
// a chunk of this run is normalised, the next run's chunk is copied into it,
// so the loads of run r + 1 overlap the stores of run r.
template <bool SILU>
__global__ void __launch_bounds__(kThreads) gn_cluster_kernel(Args a, int slice) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // [kMaxChunks]
  float* red = reinterpret_cast<float*>(smem + 128);   // [2 * kThreads / 32]
  float* part = reinterpret_cast<float*>(smem + 192);  // (s1, s2) of this CTA, two runs apart
  float* st = reinterpret_cast<float*>(smem + 208);    // the run's (mean, rstd)
  float2* tab = reinterpret_cast<float2*>(smem + kHeader);  // [cpg]
  uint4* xs = reinterpret_cast<uint4*>(smem + kHeader + round128(8LL * a.cpg));
  const uint32_t rank = cluster_ctarank(), cs = cluster_nctarank();
  const int lo = static_cast<int>(rank) * slice;
  const int n = lo < a.run ? (a.run - lo < slice ? a.run - lo : slice) : 0;
  const int chunks = (n + kChunk - 1) / kChunk;
  if (threadIdx.x == 0) {
    for (int c = 0; c < chunks; ++c) mbar_init(&bars[c], 1);
    fence_mbar_init();
  }
  __syncthreads();
  const unsigned v0 = static_cast<unsigned>(lo / 8);
  auto issue = [&](long long r, int c) {  // chunk c of run r's slice
    const int e = n - c * kChunk < kChunk ? n - c * kChunk : kChunk;
    mbar_arrive_expect_tx(&bars[c], 2 * e);
    bulk_load(xs + c * (kChunk / 8), a.x + r * a.run + lo + c * kChunk, 2 * e, &bars[c]);
  };
  const long long step = gridDim.x / cs;
  int u = 0;
  for (long long r = blockIdx.x / cs; r < a.runs; r += step, ++u) {
    if (threadIdx.x == 0 && u == 0)
      for (int c = 0; c < chunks; ++c) issue(r, c);  // later runs' chunks: below
    float s1 = 0.f, s2 = 0.f;
    for (int c = 0; c < chunks; ++c) {
      mbar_wait(&bars[c], u & 1);
      const int end = c == chunks - 1 ? n / 8 : (c + 1) * (kChunk / 8);
      for (int v = c * (kChunk / 8) + threadIdx.x; v < end; v += kThreads)
        accumulate8(xs[v], s1, s2);
    }
    const float2 tot = group_sum(s1, s2, red, kThreads / 32);
    // Two slots, a run apart: a CTA writes this slot again only after the next
    // run's cluster barrier, which every CTA reaches after reading it here.
    float* pu = part + 2 * (u & 1);
    if (threadIdx.x == 0) {
      pu[0] = tot.x;
      pu[1] = tot.y;
    }
    cluster_arrive();
    cluster_wait();  // every CTA's partial sums of run r are in its shared memory
    if (threadIdx.x == 0) {
      float t1 = 0.f, t2 = 0.f;
      for (uint32_t q = 0; q < cs; ++q) {
        t1 += ld_cluster_f32(pu, q);
        t2 += ld_cluster_f32(pu + 1, q);
      }
      stats(t1, t2, a.run, a.eps, st[0], st[1]);
    }
    __syncthreads();
    const float mean = st[0];
    fill_table(tab, a, r, st[1], threadIdx.x, kThreads);
    __syncthreads();
    uint4* yv = reinterpret_cast<uint4*>(a.y + r * a.run + lo);
    for (int c = 0; c < chunks; ++c) {
      const int end = c == chunks - 1 ? n / 8 : (c + 1) * (kChunk / 8);
      for (int v = c * (kChunk / 8) + threadIdx.x; v < end; v += kThreads)
        yv[v] = norm8<SILU>(xs[v], mean, tab[quot(v0 + v, a.vec_magic)]);
      __syncthreads();  // chunk c is read: the next run's chunk c may land in it
      if (threadIdx.x == 0 && r + step < a.runs) issue(r + step, c);
    }
    __syncthreads();  // the slice, the table, the statistics are free for the next run
  }
  cluster_arrive();
  cluster_wait();  // no CTA leaves while another may still read its partial sums
}

// Slice `sl` of `splits` of a run: [lo, hi), lo a multiple of 8.
__device__ __forceinline__ void slice_of(int run, int splits, int sl, int& lo, int& hi) {
  const long long per = ((static_cast<long long>(run) + splits - 1) / splits + 7) / 8 * 8;
  const long long start = per * sl;
  hi = start + per < run ? static_cast<int>(start + per) : run;
  lo = start < hi ? static_cast<int>(start) : hi;
}

// Sum of (a, b) over the block of kSplitThreads; every thread gets it.
__device__ __forceinline__ float2 block_sum(float a, float b) {
  __shared__ float red[2 * kSplitThreads / 32];
  return group_sum(a, b, red, kSplitThreads / 32);
}

template <bool VEC>
__global__ void __launch_bounds__(kSplitThreads)
    gn_stats_kernel(Args a, int splits, float* __restrict__ partial) {
  const long long r = blockIdx.x / splits;
  const int sl = static_cast<int>(blockIdx.x % splits);
  const bf16* xr = a.x + r * a.run;
  int lo, hi;
  slice_of(a.run, splits, sl, lo, hi);
  float s1 = 0.f, s2 = 0.f;
  if (VEC) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    for (int v = lo / 8 + threadIdx.x; v < hi / 8; v += kSplitThreads) accumulate8(xv[v], s1, s2);
  } else {
    for (int i = lo + threadIdx.x; i < hi; i += kSplitThreads) {
      const float f = __bfloat162float(xr[i]);
      s1 += f;
      s2 += f * f;
    }
  }
  const float2 tot = block_sum(s1, s2);
  if (threadIdx.x == 0) {
    partial[2 * blockIdx.x] = tot.x;
    partial[2 * blockIdx.x + 1] = tot.y;
  }
}

template <bool VEC, bool SILU>
__global__ void __launch_bounds__(kSplitThreads)
    gn_apply_kernel(Args a, int splits, const float* __restrict__ partial) {
  const long long b = gridDim.x - 1 - blockIdx.x;  // the stats pass's last slices first
  const long long r = b / splits;
  const int sl = static_cast<int>(b % splits);
  float s1 = 0.f, s2 = 0.f;
  const float* pr = partial + 2 * r * splits;
  for (int i = 0; i < splits; ++i) {  // every thread in the same order
    s1 += pr[2 * i];
    s2 += pr[2 * i + 1];
  }
  float mean, rstd;
  stats(s1, s2, a.run, a.eps, mean, rstd);
  int lo, hi;
  slice_of(a.run, splits, sl, lo, hi);
  const int c0 = static_cast<int>(r % a.groups) * a.cpg;
  const bf16* xr = a.x + r * a.run;
  bf16* yr = a.y + r * a.run;
  int cached = -1;  // the channel whose (scale, shift) this thread holds
  float2 t = make_float2(0.f, 0.f);
  auto channel = [&](int c) {
    if (c != cached) {
      cached = c;
      t = make_float2(rstd * load_param(a.gamma, c0 + c, a.params_bf16),
                      load_param(a.beta, c0 + c, a.params_bf16));
    }
  };
  if (VEC) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    uint4* yv = reinterpret_cast<uint4*>(yr);
    for (int v = lo / 8 + threadIdx.x; v < hi / 8; v += kSplitThreads) {
      channel(static_cast<int>(quot(v, a.vec_magic)));
      yv[v] = norm8<SILU>(xv[v], mean, t);
    }
  } else {
    for (int i = lo + threadIdx.x; i < hi; i += kSplitThreads) {
      channel(static_cast<int>(quot(i, a.elem_magic)));
      yr[i] = __float2bfloat16(finish<SILU>(__bfloat162float(xr[i]), mean, t.x, t.y));
    }
  }
}

// Shared memory of the short-run and the cluster paths (ops/group_norm.py
// computes the same).
long long short_smem(const Args& a, int k, int stages) {
  return kHeader + round128(8LL * k * a.cpg) + static_cast<long long>(stages) * round128(2LL * k * a.run);
}

int cluster_slice(int run, int cs) { return static_cast<int>(((run + cs - 1LL) / cs + 7) / 8 * 8); }

long long cluster_smem(const Args& a, int cs) {
  return kHeader + round128(8LL * a.cpg) + round128(2LL * cluster_slice(a.run, cs));
}

template <typename K>
cudaError_t allow_smem(K kernel, int smem, int& allowed) {
  if (smem <= allowed) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) allowed = smem;
  return err;
}

// The launch configuration of a cluster launch of `cs` CTAs a run; fills
// `attr`, which `cfg` points to.
cudaLaunchConfig_t cluster_config(long long runs, int cs, int smem, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(runs * cs), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Readies gn_cluster_kernel<SILU> for `smem` bytes and clusters above 8, and
// gives the number of clusters of `cs` that fit the card at once.
template <bool SILU>
cudaError_t cluster_room(int cs, int smem, cudaLaunchConfig_t& cfg, int& clusters) {
  static int allowed = 48 * 1024;
  static bool non_portable = false;
  cudaError_t err = allow_smem(gn_cluster_kernel<SILU>, smem, allowed);
  if (err != cudaSuccess) return err;
  if (cs > 8 && !non_portable) {
    err = cudaFuncSetAttribute(gn_cluster_kernel<SILU>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    non_portable = true;
  }
  return cudaOccupancyMaxActiveClusters(&clusters, gn_cluster_kernel<SILU>, &cfg);
}

template <bool SILU>
cudaError_t launch(const Args& a, int path, int n, int stages, int blocks, int smem,
                   float* scratch, cudaStream_t stream) {
  const bool vec = a.run % 8 == 0 && a.spatial % 8 == 0;
  if (path == kShort) {
    if (!vec || (n != 1 && n != 2 && n != 4 && n != 8) || stages < 1 || stages > kMaxStages ||
        blocks < 1 || smem < short_smem(a, n, stages))
      return cudaErrorInvalidValue;
    static int allowed = 48 * 1024;
    const cudaError_t err = allow_smem(gn_short_kernel<SILU>, smem, allowed);
    if (err != cudaSuccess) return err;
    gn_short_kernel<SILU><<<blocks, kThreads, smem, stream>>>(a, n, stages,
                                                              round128(2LL * n * a.run));
    return cudaGetLastError();
  }
  if (path == kCluster) {
    if (!vec || n < 1 || n > kMaxCluster || a.runs * n > 0x7fffffffLL ||
        smem < cluster_smem(a, n) || cluster_slice(a.run, n) > kMaxChunks * kChunk)
      return cudaErrorInvalidValue;
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = cluster_config(a.runs, n, smem, stream, attr);
    int clusters = 0;
    cudaError_t err = cluster_room<SILU>(n, smem, cfg, clusters);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorInvalidConfiguration;  // no room for one cluster
    // as many clusters as the card holds at once walk the runs
    if (clusters < a.runs) cfg.gridDim.x = static_cast<unsigned>(clusters * n);
    err = cudaLaunchKernelEx(&cfg, gn_cluster_kernel<SILU>, a, cluster_slice(a.run, n));
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  }
  if (path != kTwoPass || n < 1 || n > 65535 || a.runs * n > 0x7fffffffLL || scratch == nullptr)
    return cudaErrorInvalidValue;
  const unsigned grid = static_cast<unsigned>(a.runs * n);
  if (vec) {
    gn_stats_kernel<true><<<grid, kSplitThreads, 0, stream>>>(a, n, scratch);
    gn_apply_kernel<true, SILU><<<grid, kSplitThreads, 0, stream>>>(a, n, scratch);
  } else {
    gn_stats_kernel<false><<<grid, kSplitThreads, 0, stream>>>(a, n, scratch);
    gn_apply_kernel<false, SILU><<<grid, kSplitThreads, 0, stream>>>(a, n, scratch);
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace ctrlv

// x, y: (batch, groups * cpg, spatial...) contiguous bf16, 16-byte aligned,
// seen as `runs` = batch * groups runs of `run` = cpg * spatial elements;
// gamma, beta: the groups * cpg channel parameters, bf16 or f32. The plan:
// `path` 0 (short runs: `n` runs an item, `stages` buffers, `blocks` blocks),
// 1 (a cluster of `n` CTAs a run) or 2 (two passes over `n` slices a run,
// `scratch` holding runs * n * 2 floats); `smem`: the dynamic shared memory of
// a block of paths 0 and 1. Returns a cudaError_t code.
extern "C" int ctrlv_group_norm_fwd(const void* x, const void* gamma, const void* beta, void* y,
                                    void* scratch, long long runs, long long run,
                                    long long spatial, int cpg, int groups, int path, int n,
                                    int stages, int blocks, int smem, int params_bf16, int silu,
                                    float eps, void* stream) {
  using ctrlv::bf16;
  if (runs < 1 || runs > 0x7fffffffLL || run < 1 || run > 0x3fffffffLL || spatial < 1 ||
      cpg < 1 || groups < 1 || run != spatial * cpg || smem < 0 || smem > 232448)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(y) % 16)
    return cudaErrorMisalignedAddress;
  const ctrlv::Args a{static_cast<const bf16*>(x), static_cast<bf16*>(y), gamma, beta, runs,
                      static_cast<int>(run), static_cast<int>(spatial), cpg, groups,
                      params_bf16, eps,
                      ctrlv::magic_for(spatial % 8 == 0 ? spatial / 8 : 1),
                      ctrlv::magic_for(spatial)};
  auto st = static_cast<cudaStream_t>(stream);
  auto* sp = static_cast<float*>(scratch);
  return silu ? ctrlv::launch<true>(a, path, n, stages, blocks, smem, sp, st)
              : ctrlv::launch<false>(a, path, n, stages, blocks, smem, sp, st);
}

// How many clusters of `cluster` CTAs with `smem` bytes of shared memory each
// the card holds at once (into `out`); returns a cudaError_t code.
extern "C" int ctrlv_group_norm_clusters(int cluster, int smem, int* out) {
  if (cluster < 1 || cluster > ctrlv::kMaxCluster || smem < 0 || smem > 232448)
    return cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = ctrlv::cluster_config(cluster, cluster, smem, nullptr, attr);
  return ctrlv::cluster_room<true>(cluster, smem, cfg, *out);
}
