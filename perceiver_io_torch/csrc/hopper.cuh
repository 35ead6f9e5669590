// Hopper (sm_90a) building blocks written as inline PTX, shared by the
// kernels that run on wgmma fed by TMA (flash_forward_wide.cu,
// flash_backward_wide.cu, flash_forward_f32.cu and flash_backward_f32.cu):
// mbarriers, the TMA tile load with and without cluster multicast and the
// TMA tile store, the wgmma shared-memory descriptor with its fence, commit
// and wait, the proxy fence for operands stored by threads, the wgmma
// products themselves (bf16, and tf32 with the split of a float32 into TF32
// terms), setmaxnreg, named barriers and the host-side encoding of a tensor
// map. Plain PTX, no CuTe/CUTLASS templates, so that a source that includes
// it compiles in seconds.
//
// Layout convention: every tile in shared memory is stored as boxes of 64
// bf16 channels (or 32 float32 ones: 128 bytes a row) written by TMA with the
// 128-byte swizzle (16-byte chunk c of row r at chunk c ^ (r % 8)), each box
// starting at a multiple of 1024 bytes, so that one 8-row group of a box is
// one swizzle atom of wgmma's SWIZZLE_128B layout.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: the driver function is found at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace hopper {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat162 v) { return *reinterpret_cast<uint32_t*>(&v); }

// ----------------------------------------------------------------- mbarrier
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(arrivals) : "memory");
}
// Makes the initialised barriers visible to the cluster (and to the async proxy).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// One arrival that also announces `bytes` more bytes of TMA transactions.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}
// One arrival on a barrier of this block (release: the arriving thread's
// earlier shared-memory reads are done before the phase can complete).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// One arrival on the barrier at the same offset in the shared memory of cluster block `rank`.
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(smem_u32(bar)),
      "r"(rank)
      : "memory");
}
// Waits until the barrier's phase with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// The same, by a whole warp, as a loop on a warp-uniform vote: ptxas then sees
// no divergent branch between the wgmma issues around it (a try_wait loop on
// each thread's own predicate, between a wgmma and its wait, made ptxas
// serialise every wgmma of flash_forward_f32.cu).
__device__ __forceinline__ void mbar_wait_warp(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!__all_sync(0xffffffffu, done));
}
// The same, acquiring at cluster scope what the arrivals of other blocks released.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// ------------------------------------------------------------------ cluster
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// Every thread of every block of the cluster.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// ---------------------------------------------------------------------- TMA
__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}
// A 3-d box at coordinates (c0, c1, c2) (innermost first) into this block's
// shared memory; its bytes complete on `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], "
      "[%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
// The same box written to the same offset in the shared memory of every
// block of the cluster in `mask`, completing on the barrier at `bar`'s offset in each.
__device__ __forceinline__ void tma_load_3d_multicast(void* dst, const CUtensorMap* map, uint64_t* bar, uint16_t mask,
                                                      int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
      "[%0], [%1, {%4, %5, %6}], [%2], %3;\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "h"(mask), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// This block's shared-memory box (written with the tensor map's swizzle) out
// to coordinates (c0, c1, c2) of the tensor map, as part of the issuing
// thread's bulk-async group; coordinates past the tensor are not written.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0, int c1, int c2) {
  asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// Waits until at most N of the thread's bulk groups still read their shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// Waits until at most N of the thread's bulk groups are still incomplete.
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// -------------------------------------------------------------------- wgmma
// Shared-memory matrix descriptor for the SWIZZLE_128B layout. K-major
// operands (rows of 64 channels, the contraction contiguous): lbo unused (16),
// sbo = 1024 bytes between 8-row groups. MN-major operands (the contraction
// along the rows, as V in P V): lbo = bytes between 64-column boxes, sbo =
// 1024 bytes between 8-row groups.
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo_bytes, uint32_t sbo_bytes) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo_bytes >> 4) << 16) |
         ((uint64_t)(sbo_bytes >> 4) << 32) | (1ull << 62);
}
// The descriptor of the tile `bytes` further on (a multiple of 16) in the
// same layout: the start address is the descriptor's low field, in 16-byte units.
__device__ __forceinline__ uint64_t desc_add(uint64_t desc, uint32_t bytes) { return desc + (bytes >> 4); }
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
// Makes this thread's ordinary stores to shared memory visible to the async
// proxy (wgmma's operand reads): after storing an operand, before the barrier
// that lets a warpgroup multiply it.
__device__ __forceinline__ void fence_async_shared() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pins accumulator registers in place around wgmma's asynchronous writes, so
// that the compiler moves no read or write of them across a fence or wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define F16(i) F4(i), F4(i + 4), F4(i + 8), F4(i + 12)
#define F32(i) F16(i), F16(i + 16)

// wgmma.mma_async m64nNk16 with bf16 inputs and float32 sums (d += A B),
// accumulator layout as mma.sync's m16n8 tiles, warp w of the warpgroup
// holding rows 16 w .. 16 w + 15: ss takes A (64 x 16) and B (16 x N) both
// from shared memory, K-major unless TA (A) or TB (B) is 1, which reads that
// operand MN-major (transposed: the contraction along its rows, as V in P V
// or dO in dV^T = dO^T P); rs takes A from registers (mma.sync's A-fragment
// layout) and B MN-major from shared memory.
template <int N>
struct Wgmma;
template <>
struct Wgmma<16> {
  template <int TA = 0, int TB = 0>
  static __device__ __forceinline__ void ss(float (&d)[8], uint64_t a, uint64_t b) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7}, "
                 "%8, %9, p, 1, 1, %11, %12;\n}\n"
                 : F4(0), F4(4)
                 : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  }
};
template <>
struct Wgmma<32> {
  template <int TA = 0, int TB = 0>
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t a, uint64_t b) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
                 "%16, %17, p, 1, 1, %19, %20;\n}\n"
                 : F16(0)
                 : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  }
};
template <>
struct Wgmma<64> {
  template <int TA = 0, int TB = 0>
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
                 "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
                 "%32, %33, p, 1, 1, %35, %36;\n}\n"
                 : F32(0)
                 : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  }
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
                 "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
                 "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
                 : F32(0)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <>
struct Wgmma<128> {
  template <int TA = 0, int TB = 0>
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a, uint64_t b) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
                 "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
                 "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
                 "%61, %62, %63}, "
                 "%64, %65, p, 1, 1, %67, %68;\n}\n"
                 : F32(0), F32(32)
                 : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  }
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
                 "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
                 "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
                 "%61, %62, %63}, "
                 "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
                 : F32(0), F32(32)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <>
struct Wgmma<192> {
  template <int TA = 0, int TB = 0>
  static __device__ __forceinline__ void ss(float (&d)[96], uint64_t a, uint64_t b) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
                 "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
                 "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
                 "%61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, "
                 "%81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
                 "%96, %97, p, 1, 1, %99, %100;\n}\n"
                 : F32(0), F32(32), F32(64)
                 : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  }
  static __device__ __forceinline__ void rs(float (&d)[96], const uint32_t (&a)[4], uint64_t b) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
                 "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
                 "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
                 "%61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, "
                 "%81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
                 "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
                 : F32(0), F32(32), F32(64)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <>
struct Wgmma<256> {
  template <int TA = 0, int TB = 0>
  static __device__ __forceinline__ void ss(float (&d)[128], uint64_t a, uint64_t b) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
                 "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
                 "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
                 "%61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, "
                 "%81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
                 "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
                 "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
                 "%128, %129, p, 1, 1, %131, %132;\n}\n"
                 : F32(0), F32(32), F32(64), F32(96)
                 : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  }
  static __device__ __forceinline__ void rs(float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
                 "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
                 "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
                 "%61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, "
                 "%81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
                 "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
                 "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
                 "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
                 : F32(0), F32(32), F32(64), F32(96)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// TF32 products for float32-class arithmetic (flash_forward_f32.cu and
// flash_backward_f32.cu): x as a
// TF32 value (cvt.rna: round to nearest, ties away from zero; the low 13 bits
// of the float32 word zero), and x split into hi + lo with lo the TF32
// rounding of x - hi, so that a b ~ lo_a hi_b + hi_a lo_b + hi_a hi_b.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}
// The same split of a finite x in five integer and float operations
// (cvt.rna.tf32.f32 compiles to about five a rounding, as it also passes
// infinities and NaNs through): the float32 word plus 0x1000 with its low 13
// bits cleared is cvt.rna's result for every finite x that does not round
// past the largest float32. For the operands that a kernel splits on its hot
// path; x - hi is exact.
__device__ __forceinline__ void split_tf32_finite(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

// wgmma.mma_async m64nNk8 with tf32 inputs and float32 sums (d += A B): A
// (64 x 8) from registers, warp w of the warpgroup holding rows 16 w .. 16 w
// + 15 as mma.sync's m16n8k8 tf32 A fragment (a0 (g, t), a1 (g + 8, t), a2
// (g, t + 4), a3 (g + 8, t + 4) for lane 4 g + t); B (8 x N) K-major from
// shared memory (tf32 takes no transpose: both operands K-major); the
// accumulator laid out as the bf16 products'.
template <int N>
struct WgmmaTf32;
// With accumulate = 0 the product overwrites d (wgmma's scale-d off).
template <>
struct WgmmaTf32<32> {
  static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b, int accumulate = 1) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
                 "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
                 : F16(0)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
  }
};
template <>
struct WgmmaTf32<64> {
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int accumulate = 1) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
                 "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
                 "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
                 : F32(0)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
  }
};

#undef F4
#undef F16
#undef F32

// ----------------------------------------------------------- registers
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
// Named barrier `id` over `threads` threads (id 0 is __syncthreads').
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ------------------------------------------------------------- host side
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, found through the runtime, so that
// nothing links against libcuda.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                                       &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A tensor map over a contiguous bf16 tensor (outer, rows, cols), boxes of
// (1, box_rows, 64) with the 128-byte swizzle; rows past `rows` (and channels
// past `cols`) read as zeros. Returns false if the driver refuses it.
inline bool bf16_rows_map(CUtensorMap* map, const void* base, uint64_t outer, uint64_t rows, uint64_t cols,
                          uint32_t box_rows) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {cols, rows, outer};
  const cuuint64_t strides[2] = {cols * sizeof(bf16), rows * cols * sizeof(bf16)};
  const cuuint32_t box[3] = {64, box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The same over a contiguous float32 tensor (outer, rows, cols), boxes of
// (1, box_rows, 32): 32 floats are one 128-byte swizzled row.
inline bool f32_rows_map(CUtensorMap* map, const void* base, uint64_t outer, uint64_t rows, uint64_t cols,
                         uint32_t box_rows) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {cols, rows, outer};
  const cuuint64_t strides[2] = {cols * sizeof(float), rows * cols * sizeof(float)};
  const cuuint32_t box[3] = {32, box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
