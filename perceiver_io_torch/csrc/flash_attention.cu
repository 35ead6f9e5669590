// Flash attention forward (B1a) and backward (B1b) in float32 for Hopper
// (sm_90a): softmax(q k^T + mask) v over (B, H, N, D) heads without
// materialising the (Nq, Nk) score matrix, and its gradients dq, dk, dv.
// Float32 only: the tensor cores have no float32 product. bfloat16 inputs
// take flash_forward_mma.cu (forward) and flash_backward_mma.cu (backward),
// on the tensor cores.
//
// Replaces perceiver_io_tpu/ops/flash.py:splash_mha (the Pallas splash kernel
// built by `_build_kernel` via `make_splash_mha`, forward and backward under
// its custom VJP). The forward entry with causal = 0 is also B5, the port of
// perceiver_io_tpu/parallel/ring_attention.py:_splash_fwd_block: ring
// attention's fully visible blocks, which the TPU runs as the same splash
// kernel with save_residuals=True (its log-sum-exp) and no causal mask; the
// ring merges each block's float32 output through its lse. A ring block's key
// count need not be a multiple of 64 (ragged last tile) and may be all padding
// (o = 0, lse = -inf). Same function, same layouts:
//   q     (B, H, Nq, D)  already scaled and rotated queries, float32
//   k, v  (B, H, Nk, D)  keys and values, float32
//   pad   (B, Nk)        uint8, 1 = padding key (the splash segment id 0), or null
//   o     (B, H, Nq, D)  float32, kept for the backward's delta = rowsum(dO * O)
//   lse   (B, H, Nq)     float32 log-sum-exp of each query's visible scores
// Causal is right-aligned, as splash's CausalMask((Nq, Nk), offset=Nk-Nq):
// query i sees key j iff j <= Nk - Nq + i. A query that sees no key gets an
// output of exact zeros, lse = -inf and zero gradients (never NaN).
//
// What bounds it on an H100: each visible (query, key) pair costs 4*D flops
// forward (scores and value sum) and 10*D backward, against O(D) bytes per
// row read once: in float32 the operations, at the training shapes (D =
// 64-128, 512 queries over 512-2304 keys, causal). These kernels multiply on
// the CUDA cores (67 TFLOP/s), so the design keeps the score matrix out of
// device memory and skips whole tiles that the mask hides:
//   * forward: one block per (batch*head, 64-query tile), 256 threads; a loop
//     over 64-key tiles held in shared memory with the online softmax (running
//     max and sum per row in shared memory, the output tile in registers).
//     Key tiles past the causal bound are never loaded; tiles whose keys are
//     all padding are skipped after one block-wide vote;
//   * backward, FlashAttention-2 style, three kernels: delta = rowsum(dO * O);
//     one block per (batch*head, 64-key tile) recomputes P from q, k and lse
//     over the query tiles that can see it and accumulates dK and dV in
//     registers; one block per (batch*head, 64-query tile) recomputes P and
//     accumulates dQ. No atomics: every gradient is written once, and the
//     result does not depend on the order the blocks run in;
//   * every thread owns a 4 x 4 (or 4 x D/16) register tile of each product,
//     rows ty + 16 i and columns tx + 16 j; shared tiles are padded to an odd
//     row stride so a warp's column reads hit distinct banks.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // query rows per tile
constexpr int kBK = 64;          // key rows per tile
constexpr int kThreads = 256;    // 16 x 16 threads: (ty, tx) = (tid / 16, tid % 16)
constexpr int kLdP = kBK + 1;    // row stride of the (64, 64) score / probability tiles

// Rows [0, valid) of a row-major (rows, D) slice into a (kRows, D + 1) float
// tile; rows past `valid` are zeros.
template <int D, int kRows>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int valid) {
  for (int idx = threadIdx.x; idx < kRows * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    dst[r * (D + 1) + c] = r < valid ? src[(size_t)r * D + c] : 0.f;
  }
}

// acc[i][j] += sum_d A[ty + 16 i][d] * B[tx + 16 j][d]; A, B are (64, D + 1) tiles.
template <int D>
__device__ __forceinline__ void mm_nt(float (&acc)[4][4], const float* A, const float* B, int ty, int tx) {
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][j] += sum_k P[ty + 16 i][k] * B[k][tx + 16 j]; P is (64, kLdP), B (64, D + 1).
template <int D>
__device__ __forceinline__ void mm_nn(float (&acc)[4][D / 16], const float* P, const float* B, int ty, int tx) {
#pragma unroll 4
  for (int kk = 0; kk < kBK; ++kk) {
    float a[4], b[D / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = P[(ty + 16 * i) * kLdP + kk];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) b[j] = B[kk * (D + 1) + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][j] += sum_q P[q][ty + 16 i] * B[q][tx + 16 j]; P is (64, kLdP), B (64, D + 1).
template <int D>
__device__ __forceinline__ void mm_tn(float (&acc)[4][D / 16], const float* P, const float* B, int ty, int tx) {
#pragma unroll 4
  for (int qq = 0; qq < kBQ; ++qq) {
    float a[4], b[D / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = P[qq * kLdP + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) b[j] = B[qq * (D + 1) + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Keys of one tile that are in range and not padding: key_ok[c] for c < kBK,
// written by threads 0..kBK-1. Returns (to every thread) whether any is.
__device__ __forceinline__ int mark_keys(int* key_ok, const uint8_t* __restrict__ pad_row, int k0, int kv) {
  int ok = 0;
  if (threadIdx.x < kBK) {
    const int c = threadIdx.x;
    ok = c < kv && !(pad_row && pad_row[k0 + c]);
    key_ok[c] = ok;
  }
  return __syncthreads_or(ok);
}

// One past the last key that any query of the tile [q0, q0 + kBQ) may see.
__device__ __forceinline__ int key_end(int q0, int Nq, int Nk, int causal) {
  return causal ? min(Nk, max(0, Nk - Nq + q0 + kBQ)) : Nk;
}

// ----------------------------------------------------------------- B1a
template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const uint8_t* __restrict__ pad, float* __restrict__ o, float* __restrict__ lse,
    int H, int Nq, int Nk, int causal) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1;
  float* sQ = smem;
  float* sK = sQ + kBQ * LD;
  float* sV = sK + kBK * LD;
  float* sP = sV + kBK * LD;    // (kBQ, kLdP): scores, then probabilities
  float* sM = sP + kBQ * kLdP;  // running max per query row
  float* sL = sM + kBQ;         // running sum per query row
  float* sA = sL + kBQ;         // this tile's rescale factor per row
  int* sOk = reinterpret_cast<int*>(sA + kBQ);

  const int bh = blockIdx.x, b = bh / H;
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int off = Nk - Nq;
  const float* kb = k + (size_t)bh * Nk * D;
  const float* vb = v + (size_t)bh * Nk * D;
  const uint8_t* pad_row = pad ? pad + (size_t)b * Nk : nullptr;

  load_tile<D, kBQ>(sQ, q + ((size_t)bh * Nq + q0) * D, Nq - q0);
  if (tid < kBQ) {
    sM[tid] = -INFINITY;
    sL[tid] = 0.f;
  }
  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;

  const int k_end = key_end(q0, Nq, Nk, causal);
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    const int kv = min(kBK, Nk - k0);
    load_tile<D, kBK>(sK, kb + (size_t)k0 * D, kv);
    load_tile<D, kBK>(sV, vb + (size_t)k0 * D, kv);
    if (!mark_keys(sOk, pad_row, k0, kv)) continue;  // padding only: nothing to see

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    mm_nt<D>(s, sQ, sK, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, qi = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool vis = sOk[c] && qi < Nq && (!causal || k0 + c <= qi + off);
        sP[r * kLdP + c] = vis ? s[i][j] : -INFINITY;
      }
    }
    __syncthreads();
    if (tid < kBQ) {  // online softmax, one thread per query row
      float* row = sP + tid * kLdP;
      float mx = -INFINITY;
      for (int c = 0; c < kBK; ++c) mx = fmaxf(mx, row[c]);
      const float m_old = sM[tid];
      const float m_new = fmaxf(m_old, mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // no visible key yet
      float sum = 0.f;
      for (int c = 0; c < kBK; ++c) {
        const float p = expf(row[c] - m_use);  // exp(-inf) = 0 for hidden keys
        row[c] = p;
        sum += p;
      }
      const float alpha = expf(m_old - m_use);
      sL[tid] = sL[tid] * alpha + sum;
      sM[tid] = m_new;
      sA[tid] = alpha;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = sA[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] *= alpha;
    }
    mm_nn<D>(acc, sP, sV, ty, tx);
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, qi = q0 + r;
    if (qi >= Nq) continue;
    const float l = sL[r];
    const float inv = l > 0.f ? 1.f / l : 0.f;
    float* orow = o + ((size_t)bh * Nq + qi) * D;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) orow[tx + 16 * j] = acc[i][j] * inv;
  }
  if (tid < kBQ && q0 + tid < Nq) {
    const float l = sL[tid];
    lse[(size_t)bh * Nq + q0 + tid] = l > 0.f ? sM[tid] + logf(l) : -INFINITY;
  }
}

// ----------------------------------------------------------------- B1b
// delta[row] = sum_d dO[row, d] * O[row, d] (O in float32) for 64 rows a block; 4 threads a row.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_delta_kernel(
    const float* __restrict__ o, const float* __restrict__ dout, float* __restrict__ delta, int rows) {
  __shared__ float part[kThreads];
  const int tid = threadIdx.x;
  const int row = blockIdx.x * (kThreads / 4) + tid / 4;
  float s = 0.f;
  if (row < rows) {
    const float* orow = o + (size_t)row * D;
    const float* drow = dout + (size_t)row * D;
    for (int c = tid % 4; c < D; c += 4) s = fmaf(orow[c], drow[c], s);
  }
  part[tid] = s;
  __syncthreads();
  if (tid % 4 == 0 && row < rows) delta[row] = part[tid] + part[tid + 1] + part[tid + 2] + part[tid + 3];
}

// Recompute the tile's probabilities P = exp(S - lse) and dS = P * (dO V^T -
// delta) for queries q0 + r (rows) against keys k0 + c (columns), into sP and
// sdS. sQ, sK, sdO, sV, sLse, sDelta and sOk are filled.
template <int D>
__device__ __forceinline__ void recompute_p_ds(const float* sQ, const float* sK, const float* sdO,
                                               const float* sV, const float* sLse, const float* sDelta,
                                               const int* sOk, float* sP, float* sdS, int q0, int k0,
                                               int Nq, int off, int causal, int ty, int tx) {
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
  mm_nt<D>(s, sQ, sK, ty, tx);
  mm_nt<D>(dp, sdO, sV, ty, tx);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, qi = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      // a visible pair's row has a finite lse; hidden pairs never reach expf
      const bool vis = sOk[c] && qi < Nq && (!causal || k0 + c <= qi + off);
      const float p = vis ? expf(s[i][j] - sLse[r]) : 0.f;
      if (sP) sP[r * kLdP + c] = p;
      sdS[r * kLdP + c] = p * (dp[i][j] - sDelta[r]);
    }
  }
}

// Query rows [q0, q0 + kBQ): their lse and delta into shared memory (zeros past Nq).
__device__ __forceinline__ void load_row_stats(float* sLse, float* sDelta, const float* __restrict__ lse,
                                               const float* __restrict__ delta, size_t base, int valid) {
  if (threadIdx.x < kBQ) {
    const int r = threadIdx.x;
    sLse[r] = r < valid ? lse[base + r] : 0.f;
    sDelta[r] = r < valid ? delta[base + r] : 0.f;
  }
}

// dK, dV for one 64-key tile over every query tile that can see it.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const uint8_t* __restrict__ pad, const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int H, int Nq, int Nk,
    int causal) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1;
  float* sK = smem;
  float* sV = sK + kBK * LD;
  float* sQ = sV + kBK * LD;
  float* sdO = sQ + kBQ * LD;
  float* sP = sdO + kBQ * LD;
  float* sdS = sP + kBQ * kLdP;
  float* sLse = sdS + kBQ * kLdP;
  float* sDelta = sLse + kBQ;
  int* sOk = reinterpret_cast<int*>(sDelta + kBQ);

  const int bh = blockIdx.x, b = bh / H;
  const int k0 = blockIdx.y * kBK;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int off = Nk - Nq;
  const int kv = min(kBK, Nk - k0);
  load_tile<D, kBK>(sK, k + ((size_t)bh * Nk + k0) * D, kv);
  load_tile<D, kBK>(sV, v + ((size_t)bh * Nk + k0) * D, kv);
  const int any = mark_keys(sOk, pad ? pad + (size_t)b * Nk : nullptr, k0, kv);

  float dk_acc[4][D / 16], dv_acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  if (any) {
    // the first query that sees key k0 is k0 - off (causal); start at its tile
    const int q_begin = causal ? max(0, k0 - off) / kBQ * kBQ : 0;
    for (int q0 = q_begin; q0 < Nq; q0 += kBQ) {
      __syncthreads();  // the previous tile's readers are done
      const int nq = min(kBQ, Nq - q0);
      load_tile<D, kBQ>(sQ, q + ((size_t)bh * Nq + q0) * D, nq);
      load_tile<D, kBQ>(sdO, dout + ((size_t)bh * Nq + q0) * D, nq);
      load_row_stats(sLse, sDelta, lse, delta, (size_t)bh * Nq + q0, nq);
      __syncthreads();
      recompute_p_ds<D>(sQ, sK, sdO, sV, sLse, sDelta, sOk, sP, sdS, q0, k0, Nq, off, causal, ty, tx);
      __syncthreads();
      mm_tn<D>(dv_acc, sP, sdO, ty, tx);   // dV[key] += sum_q P[q, key] dO[q]
      mm_tn<D>(dk_acc, sdS, sQ, ty, tx);   // dK[key] += sum_q dS[q, key] Q[q]
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= kv) continue;
    const size_t at = ((size_t)bh * Nk + k0 + r) * D;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      dk[at + tx + 16 * j] = dk_acc[i][j];
      dv[at + tx + 16 * j] = dv_acc[i][j];
    }
  }
}

// dQ for one 64-query tile over the key tiles it can see.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const uint8_t* __restrict__ pad, const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, int H, int Nq, int Nk, int causal) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1;
  float* sQ = smem;
  float* sdO = sQ + kBQ * LD;
  float* sK = sdO + kBQ * LD;
  float* sV = sK + kBK * LD;
  float* sdS = sV + kBK * LD;
  float* sLse = sdS + kBQ * kLdP;
  float* sDelta = sLse + kBQ;
  int* sOk = reinterpret_cast<int*>(sDelta + kBQ);

  const int bh = blockIdx.x, b = bh / H;
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int off = Nk - Nq;
  const int nq = min(kBQ, Nq - q0);
  const uint8_t* pad_row = pad ? pad + (size_t)b * Nk : nullptr;
  load_tile<D, kBQ>(sQ, q + ((size_t)bh * Nq + q0) * D, nq);
  load_tile<D, kBQ>(sdO, dout + ((size_t)bh * Nq + q0) * D, nq);
  load_row_stats(sLse, sDelta, lse, delta, (size_t)bh * Nq + q0, nq);

  float dq_acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) dq_acc[i][j] = 0.f;

  const int k_end = key_end(q0, Nq, Nk, causal);
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    const int kv = min(kBK, Nk - k0);
    load_tile<D, kBK>(sK, k + ((size_t)bh * Nk + k0) * D, kv);
    load_tile<D, kBK>(sV, v + ((size_t)bh * Nk + k0) * D, kv);
    if (!mark_keys(sOk, pad_row, k0, kv)) continue;
    recompute_p_ds<D>(sQ, sK, sdO, sV, sLse, sDelta, sOk, nullptr, sdS, q0, k0, Nq, off, causal, ty, tx);
    __syncthreads();
    mm_nn<D>(dq_acc, sdS, sK, ty, tx);     // dQ[q] += sum_key dS[q, key] K[key]
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= nq) continue;
    float* row = dq + ((size_t)bh * Nq + q0 + r) * D;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) row[tx + 16 * j] = dq_acc[i][j];
  }
}

// --------------------------------------------------------------- launch
template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) * ((kBQ + 2 * kBK) * (D + 1) + kBQ * kLdP + 3 * kBQ) + sizeof(int) * kBK;
}

template <int D>
constexpr size_t bwd_smem() {  // the larger of the two backward kernels' (dkdv)
  return sizeof(float) * (2 * (kBQ + kBK) * (D + 1) + 2 * kBQ * kLdP + 2 * kBQ) + sizeof(int) * kBK;
}

template <int D>
int forward(const void* q, const void* k, const void* v, const void* pad, void* o, void* lse, int B, int H,
            int Nq, int Nk, int causal, cudaStream_t stream) {
  const size_t smem = fwd_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (Nq + kBQ - 1) / kBQ);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const uint8_t*>(pad), static_cast<float*>(o), static_cast<float*>(lse), H, Nq, Nk, causal);
  return (int)cudaGetLastError();
}

template <int D>
int backward(const void* q, const void* k, const void* v, const void* pad, const void* o, const void* lse,
             const void* dout, void* delta, void* dq, void* dk, void* dv, int B, int H, int Nq, int Nk,
             int causal, cudaStream_t stream) {
  const size_t smem = bwd_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err != cudaSuccess) return (int)err;
  const float* tq = static_cast<const float*>(q);
  const float* tk = static_cast<const float*>(k);
  const float* tv = static_cast<const float*>(v);
  const float* tdo = static_cast<const float*>(dout);
  const uint8_t* tpad = static_cast<const uint8_t*>(pad);
  const float* tlse = static_cast<const float*>(lse);
  float* tdelta = static_cast<float*>(delta);
  const int rows = B * H * Nq;
  flash_bwd_delta_kernel<D><<<(rows + kThreads / 4 - 1) / (kThreads / 4), kThreads, 0, stream>>>(
      static_cast<const float*>(o), tdo, tdelta, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_kernel<D><<<dim3(B * H, (Nk + kBK - 1) / kBK), kThreads, smem, stream>>>(
      tq, tk, tv, tpad, tdo, tlse, tdelta, static_cast<float*>(dk), static_cast<float*>(dv), H, Nq, Nk, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<D><<<dim3(B * H, (Nq + kBQ - 1) / kBQ), kThreads, smem, stream>>>(
      tq, tk, tv, tpad, tdo, tlse, tdelta, static_cast<float*>(dq), H, Nq, Nk, causal);
  return (int)cudaGetLastError();
}

bool valid_args(int B, int H, int Nq, int Nk, int D) {
  return B >= 1 && H >= 1 && Nq >= 1 && Nk >= 1 && (D == 64 || D == 128) && (Nq + kBQ - 1) / kBQ <= 65535 &&
         (Nk + kBK - 1) / kBK <= 65535;
}

}  // namespace

// Plain C entry points, bound with ctypes. q, k, v, dout and the gradients
// are float32 (bfloat16 takes flash_forward_mma.cu and
// flash_backward_mma.cu); o and lse are float32; D: 64 or 128; pad: (B, Nk)
// uint8 or null. The Python wrapper checks every pointer, shape and type and
// allocates every output and scratch buffer. Each returns cudaGetLastError()
// after its launches (0 = launched).
extern "C" int flash_attention_forward(const void* q, const void* k, const void* v, const void* pad, void* o,
                                       void* lse, int B, int H, int Nq, int Nk, int D, int causal, void* stream) {
  if (!valid_args(B, H, Nq, Nk, D)) return (int)cudaErrorInvalidValue;
  (void)cudaGetLastError();  // clear a stale error so the one returned is this launch's
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 64 ? forward<64>(q, k, v, pad, o, lse, B, H, Nq, Nk, causal, s)
                 : forward<128>(q, k, v, pad, o, lse, B, H, Nq, Nk, causal, s);
}

// delta: (B, H, Nq) float32 scratch.
extern "C" int flash_attention_backward(const void* q, const void* k, const void* v, const void* pad,
                                        const void* o, const void* lse, const void* dout, void* delta, void* dq,
                                        void* dk, void* dv, int B, int H, int Nq, int Nk, int D, int causal,
                                        void* stream) {
  if (!valid_args(B, H, Nq, Nk, D)) return (int)cudaErrorInvalidValue;
  (void)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 64 ? backward<64>(q, k, v, pad, o, lse, dout, delta, dq, dk, dv, B, H, Nq, Nk, causal, s)
                 : backward<128>(q, k, v, pad, o, lse, dout, delta, dq, dk, dv, B, H, Nq, Nk, causal, s);
}
