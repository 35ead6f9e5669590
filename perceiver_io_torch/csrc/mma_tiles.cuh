// Pieces shared by the bf16 tensor-core flash kernels for Hopper (sm_90a),
// flash_forward_mma.cu and flash_backward_mma.cu: blocks of 8 warps, each
// owning 16 rows of a 128-row tile; row-major (rows, D) bf16 tiles in shared
// memory, XOR-swizzled in 16-byte chunks so that every ldmatrix is free of
// bank conflicts, filled by cp.async; fragments by ldmatrix; products by
// mma.sync.m16n8k16 with bf16 inputs and float32 sums.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // warps a block, each owning 16 rows
constexpr int kThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

// Element offset of 16-byte chunk c of row r in a row-major (rows, D) bf16
// tile whose chunks are XOR-swizzled by the row's low three bits.
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  return r * D + ((c ^ (r & 7)) << 3);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; zero-filled when !valid (no bytes read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [0, valid) of a row-major (rows, D) slice into a swizzled (kTile, D)
// tile; rows past `valid` are zeros. Every thread of the block takes part.
template <int D, int kTile>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src, int valid) {
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int i = 0; i < kTile * kChunks / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / kChunks, c = idx % kChunks;
    const bool ok = r < valid;
    cp_async16(smem_addr(dst + swz<D>(r, c)), src + (size_t)(ok ? r : 0) * D + c * 8, ok);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c += a b for one 16 x 8 x 16 tile: a (16 x 16, row-major A-fragment), b
// (16 x 8, column-major B-fragment), bf16 in and float32 sums.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat162 v) { return *reinterpret_cast<uint32_t*>(&v); }

}  // namespace
