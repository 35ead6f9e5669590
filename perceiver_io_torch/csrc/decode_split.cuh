// Split-K ("flash-decoding") pieces shared by the decode-attention kernels for
// Hopper (sm_90a): decode_attention.cu (B2) and paged_attention.cu (B3, B4).
//
// Each of those kernels launches a grid over (head, row, split): the live
// slots of one (row, head) are cut into up to S contiguous splits, each split
// is one block of 8 warps, and each block ends with its softmax state (m, l,
// acc) over its own slots. Here:
//   * copy_piece: one global -> shared copy of 16, 8 or 4 bytes by cp.async
//     (plain loads for the odd 1- or 2-byte pieces of tiny int4 heads);
//   * block_merge: the 8 warps' states -> the block's, through shared memory;
//   * put_state, arrive_last, merge_splits: a (row, head) with one split
//     writes its output at once; with several, each block writes its state
//     (put_state) to a workspace record, and the
//     last block to arrive (arrive_last: a __threadfence, then an atomicAdd
//     on the (row, head)'s counter, which that block resets to 0) merges
//     every split in split order, so two runs give the same bits. A split that saw
//     nothing has m = -inf and l = 0 and adds nothing; a (row, head) that
//     saw nothing gets exact zeros (l is clamped at 1e-30, acc stays 0).
// Workspace: one record of D + 2 floats (m, l, acc[D]) per (row*H + head,
// split, query); counters: one int per row*H + head, zero between launches.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxD = 256;  // one output channel per thread in the merges

__device__ __forceinline__ int wrap(int x, int n) { return ((x % n) + n) % n; }

__host__ __device__ __forceinline__ int round16(int x) { return (x + 15) & ~15; }

// The widest piece (16, 8, 4, 2 or 1 bytes) that divides `bytes` and the
// address `base`: every row slice copied at that width stays aligned.
inline int piece_bytes(int bytes, const void* base) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(base);
  for (int v = 16; v > 1; v >>= 1)
    if (bytes % v == 0 && a % v == 0) return v;
  return 1;
}

// The narrow pieces (rows whose bytes or address are not a multiple of 16).
// Inlined: as a call, the ABI's register saves around it spilled up to 68
// bytes in most paged-kernel instances.
__device__ __forceinline__ void copy_narrow(void* dst, const void* src, int vec) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (vec == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
  } else if (vec == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
  } else {
    for (int i = 0; i < vec; ++i) static_cast<uint8_t*>(dst)[i] = static_cast<const uint8_t*>(src)[i];
  }
}

__device__ __forceinline__ void copy_piece(void* dst, const void* src, int vec) {
  if (vec == 16) {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  } else {
    copy_narrow(dst, src, vec);
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// exp(a - b) that is 0, not NaN, when a is -inf
__device__ __forceinline__ float exp_from(float a, float b) { return a == -INFINITY ? 0.f : expf(a - b); }

struct MergeSmem {
  float m[kWarps];
  float l[kWarps];
  float acc[kWarps][kMaxD];
};

// The warps' states (m, l, lane-held channel pairs p = lane + 32 t) -> the
// block's: returns the block's m and l in every thread and its acc (scaled
// to that m) of channel threadIdx.x in *o (for threadIdx.x < D). Every
// thread of the block takes part.
template <int PPL>
__device__ __forceinline__ void block_merge(float m, float l, const float (&acc)[PPL][2], int D, MergeSmem& sm,
                                            float& M, float& L, float& o) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sm.m[warp] = m;
    sm.l[warp] = l;
  }
  __syncthreads();
  M = -INFINITY;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) M = fmaxf(M, sm.m[i]);
  L = 0.f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) L += sm.l[i] * exp_from(sm.m[i], M);
  const float f = exp_from(m, M);
#pragma unroll
  for (int t = 0; t < PPL; ++t) {
    const int p = lane + 32 * t;
    if (2 * p < D) {
      sm.acc[warp][2 * p] = acc[t][0] * f;
      sm.acc[warp][2 * p + 1] = acc[t][1] * f;
    }
  }
  __syncthreads();
  o = 0.f;
  if ((int)threadIdx.x < D) {
#pragma unroll
    for (int i = 0; i < kWarps; ++i) o += sm.acc[i][threadIdx.x];
  }
  __syncthreads();  // sm is reused by the next query's merge
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float* split_record(float* ws, int bh, int S, int n_q, int k, int qi, int D) {
  return ws + (((size_t)bh * S + k) * n_q + qi) * (D + 2);
}

// The block's state of query qi: the output itself when its (row, head) has
// one split, else its workspace record.
template <typename TO>
__device__ __forceinline__ void put_state(float M, float L, float o, TO* out_q, float* ws, int bh, int S, int n_q,
                                          int k, int qi, int D, int n_k) {
  const int c = threadIdx.x;
  if (n_k == 1) {
    if (c < D) store(out_q + c, o * (1.f / fmaxf(L, 1e-30f)));
    return;
  }
  float* rec = split_record(ws, bh, S, n_q, k, qi, D);
  if (c == 0) {
    rec[0] = M;
    rec[1] = L;
  }
  if (c < D) rec[2 + c] = o;
}

// After every put_state of a block with n_k > 1 splits: is this block the
// last of its (row, head) to finish? The last one resets the counter.
__device__ __forceinline__ bool arrive_last(int* counter, int n_k) {
  __shared__ int s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    s_last = atomicAdd(counter, 1) == n_k - 1;
    if (s_last) *counter = 0;
  }
  __syncthreads();
  if (s_last) __threadfence();
  return s_last;
}

// The last block of a (row, head): merge its n_k records of each query in
// split order and write the outputs out_row[qi * D + c].
template <typename TO>
__device__ __forceinline__ void merge_splits(const float* ws, int bh, int S, int n_q, int n_k, int D, TO* out_row) {
  const int c = threadIdx.x;
  for (int qi = 0; qi < n_q; ++qi) {
    const float* rec0 = split_record(const_cast<float*>(ws), bh, S, n_q, 0, qi, D);
    const size_t stride = (size_t)n_q * (D + 2);  // from split k to k + 1
    float M = -INFINITY;
    for (int k = 0; k < n_k; ++k) M = fmaxf(M, __ldcg(rec0 + k * stride));
    float L = 0.f, o = 0.f;
    for (int k = 0; k < n_k; ++k) {
      const float* rec = rec0 + k * stride;
      const float f = exp_from(__ldcg(rec), M);
      L += __ldcg(rec + 1) * f;
      if (c < D) o += __ldcg(rec + 2 + c) * f;
    }
    if (c < D) store(out_row + (size_t)qi * D + c, o * (1.f / fmaxf(L, 1e-30f)));
  }
}

}  // namespace
