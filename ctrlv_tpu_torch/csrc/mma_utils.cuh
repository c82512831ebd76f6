// Warp-level building blocks shared by the attention kernels (sm_90a):
// 16-byte cp.async copies, ldmatrix fragment loads and the bf16
// mma.sync.m16n8k16 tensor-core product with f32 accumulation.
//
// Fragment layouts (PTX ISA, "Matrix Fragments for mma.m16n8k16"), with
// g = lane / 4 and t = lane % 4:
//   A (16x16, row-major)  a0:(g, 2t..2t+1)  a1:(g+8, 2t..)  a2:(g, 2t+8..)  a3:(g+8, 2t+8..)
//   B (16x8,  col-major)  b0:(k=2t..2t+1, n=g)  b1:(k=2t+8.., n=g)
//   C (16x8,  f32)        c0,c1:(g, 2t..2t+1)   c2,c3:(g+8, 2t..2t+1)
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ctrlv {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global->shared copy; with valid=false the destination is zero-filled
// (src-size 0), which is how ragged rows are padded.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 b16 matrices; lane i gives the row address of matrix i/8, row i%8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a * b on the tensor cores: (16x16 bf16) x (16x8 bf16) -> 16x8 f32.
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values -> one register of two bf16, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy a (ROWS x D) bf16 tile whose rows start `ld` elements apart into shared
// memory with rows SROW elements apart. Rows at or past `nrows` are zero-filled.
// `nthreads` threads with ids `tid` share the copy, 16 bytes per cp.async.
template <int ROWS, int D, int SROW>
__device__ __forceinline__ void load_tile_async(bf16* smem, const bf16* gmem, long long ld,
                                                int row0, int nrows, int tid, int nthreads) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  for (int i = tid; i < ROWS * CHUNKS; i += nthreads) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * 8;
    const bool valid = row0 + r < nrows;
    // An invalid row reads nothing, but its address must still be a legal one.
    const bf16* src = gmem + (valid ? (long long)(row0 + r) * ld : 0) + c;
    cp_async16(smem + r * SROW + c, src, valid);
  }
}

}  // namespace ctrlv
