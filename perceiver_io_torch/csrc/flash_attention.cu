// Flash attention backward (B1b) in float32 for Hopper (sm_90a): the
// gradients dq, dk, dv of softmax(q k^T + mask) v over (B, H, N, D) heads
// without materialising the (Nq, Nk) score matrix. Float32 only, on the CUDA
// cores. The float32 forward (B1a, and B5 with it) is flash_forward_f32.cu,
// whose float32-class products run on the tensor cores as three TF32
// products; bfloat16 inputs take flash_forward_mma.cu and
// flash_forward_wide.cu (forward) and flash_backward_mma.cu and
// flash_backward_wide.cu (backward), on the tensor cores.
//
// Replaces the backward of perceiver_io_tpu/ops/flash.py:splash_mha (the
// Pallas splash kernels built by `_build_kernel` via `make_splash_mha`, under
// its custom VJP). It takes D = 64, 128, ..., 512 (every multiple of 64; the
// wide heads are the Perceiver IO optical-flow decoder's). Same function,
// same layouts as the forward:
//   q     (B, H, Nq, D)  already scaled and rotated queries, float32
//   k, v  (B, H, Nk, D)  keys and values, float32
//   pad   (B, Nk)        uint8, 1 = padding key (the splash segment id 0), or null
//   o     (B, H, Nq, D)  the forward's float32 output, for delta = rowsum(dO * O)
//   lse   (B, H, Nq)     the forward's float32 log-sum-exp of each query's visible scores
// Causal is right-aligned, as splash's CausalMask((Nq, Nk), offset=Nk-Nq):
// query i sees key j iff j <= Nk - Nq + i. A query that sees no key gets zero
// gradients (never NaN).
//
// What bounds it on an H100: each visible (query, key) pair costs 10*D flops
// against O(D) bytes per row read once: in float32 the operations, at the
// training shapes (D = 64-128, 512 queries over 512-2304 keys, causal). These
// kernels multiply on the CUDA cores (67 TFLOP/s), so the design keeps the
// score matrix out of device memory and skips whole tiles that the mask
// hides. FlashAttention-2 style, three kernels: delta = rowsum(dO * O); one
// block per (batch*head, 64-key tile) recomputes P from q, k and lse over the
// query tiles that can see it and accumulates dK and dV in registers; one
// block per (batch*head, 64-query tile) recomputes P and accumulates dQ.
// Above D = 128 the tiles shrink to 16 queries x 32 keys, so that the float32
// K, V, Q, dO, P and dS tiles fit in 227 KB (201 KB at D = 512) and dK, dV in
// 4 x D/16 registers a thread. No atomics: every gradient is written once,
// and the result does not depend on the order the blocks run in. Every thread
// owns a 4 x 4 (or 4 x D/16) register tile of each product, rows ty + 16 i
// and columns tx + 16 j; shared tiles are padded to an odd row stride so a
// warp's column reads hit distinct banks.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // query rows per tile
constexpr int kBK = 64;          // key rows per tile
constexpr int kThreads = 256;    // 16 x 16 threads: (ty, tx) = (tid / 16, tid % 16)
constexpr int kBWide = 32;       // key rows per tile above D = 128
constexpr int kBWideQ = 16;      // the backward's query rows per tile above D = 128

// Rows [0, valid) of a row-major (rows, D) slice into a (kRows, D + 1) float
// tile; rows past `valid` are zeros.
template <int D, int kRows>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int valid) {
  for (int idx = threadIdx.x; idx < kRows * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    dst[r * (D + 1) + c] = r < valid ? src[(size_t)r * D + c] : 0.f;
  }
}

// acc[i][j] += sum_d A[ty + 16 i][d] * B[tx + 16 j][d]; A is (16 R, D + 1), B (16 C, D + 1).
template <int D, int R, int C>
__device__ __forceinline__ void mm_nt(float (&acc)[R][C], const float* A, const float* B, int ty, int tx) {
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[R], b[C];
#pragma unroll
    for (int i = 0; i < R; ++i) a[i] = A[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < C; ++j) b[j] = B[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][j] += sum_k P[ty + 16 i][k] * B[k][tx + 16 j]; P is (16 R, BK + 1), B (BK, D + 1).
template <int D, int BK = kBK, int R = 4>
__device__ __forceinline__ void mm_nn(float (&acc)[R][D / 16], const float* P, const float* B, int ty, int tx) {
#pragma unroll 4
  for (int kk = 0; kk < BK; ++kk) {
    float a[R], b[D / 16];
#pragma unroll
    for (int i = 0; i < R; ++i) a[i] = P[(ty + 16 * i) * (BK + 1) + kk];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) b[j] = B[kk * (D + 1) + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Keys of one tile that are in range and not padding: key_ok[c] for c < BK,
// written by threads 0..BK-1. Returns (to every thread) whether any is.
template <int BK = kBK>
__device__ __forceinline__ int mark_keys(int* key_ok, const uint8_t* __restrict__ pad_row, int k0, int kv) {
  int ok = 0;
  if (threadIdx.x < BK) {
    const int c = threadIdx.x;
    ok = c < kv && !(pad_row && pad_row[k0 + c]);
    key_ok[c] = ok;
  }
  return __syncthreads_or(ok);
}

// One past the last key that any query of the tile [q0, q0 + bq) may see.
__device__ __forceinline__ int key_end(int q0, int Nq, int Nk, int causal, int bq = kBQ) {
  return causal ? min(Nk, max(0, Nk - Nq + q0 + bq)) : Nk;
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
// delta) for queries q0 + r (BQ rows) against keys k0 + c (BK columns), into
// sP and sdS (row stride BK + 1). sQ, sK, sdO, sV, sLse, sDelta and sOk are
// filled.
template <int D, int BQ, int BK>
__device__ __forceinline__ void recompute_p_ds(const float* sQ, const float* sK, const float* sdO,
                                               const float* sV, const float* sLse, const float* sDelta,
                                               const int* sOk, float* sP, float* sdS, int q0, int k0,
                                               int Nq, int off, int causal, int ty, int tx) {
  constexpr int R = BQ / 16, C = BK / 16, LP = BK + 1;
  float s[R][C], dp[R][C];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) s[i][j] = dp[i][j] = 0.f;
  mm_nt<D>(s, sQ, sK, ty, tx);
  mm_nt<D>(dp, sdO, sV, ty, tx);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = ty + 16 * i, qi = q0 + r;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int c = tx + 16 * j;
      // a visible pair's row has a finite lse; hidden pairs never reach expf
      const bool vis = sOk[c] && qi < Nq && (!causal || k0 + c <= qi + off);
      const float p = vis ? expf(s[i][j] - sLse[r]) : 0.f;
      if (sP) sP[r * LP + c] = p;
      sdS[r * LP + c] = p * (dp[i][j] - sDelta[r]);
    }
  }
}

// Query rows [q0, q0 + BQ): their lse and delta into shared memory (zeros past Nq).
template <int BQ>
__device__ __forceinline__ void load_row_stats(float* sLse, float* sDelta, const float* __restrict__ lse,
                                               const float* __restrict__ delta, size_t base, int valid) {
  if (threadIdx.x < BQ) {
    const int r = threadIdx.x;
    sLse[r] = r < valid ? lse[base + r] : 0.f;
    sDelta[r] = r < valid ? delta[base + r] : 0.f;
  }
}

// acc[i][j] += sum_q P[q][ty + 16 i] * B[q][tx + 16 j]; P is (BQ, LP), B (BQ, D + 1).
template <int D, int BQ, int LP, int R>
__device__ __forceinline__ void mm_tn(float (&acc)[R][D / 16], const float* P, const float* B, int ty, int tx) {
#pragma unroll 4
  for (int qq = 0; qq < BQ; ++qq) {
    float a[R], b[D / 16];
#pragma unroll
    for (int i = 0; i < R; ++i) a[i] = P[qq * LP + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) b[j] = B[qq * (D + 1) + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// dK, dV for one BK-key tile over every BQ-query tile that can see it.
template <int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const uint8_t* __restrict__ pad, const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int H, int Nq, int Nk,
    int causal) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1, LP = BK + 1, R = BK / 16;
  float* sK = smem;
  float* sV = sK + BK * LD;
  float* sQ = sV + BK * LD;
  float* sdO = sQ + BQ * LD;
  float* sP = sdO + BQ * LD;
  float* sdS = sP + BQ * LP;
  float* sLse = sdS + BQ * LP;
  float* sDelta = sLse + BQ;
  int* sOk = reinterpret_cast<int*>(sDelta + BQ);

  const int bh = blockIdx.x, b = bh / H;
  const int k0 = blockIdx.y * BK;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int off = Nk - Nq;
  const int kv = min(BK, Nk - k0);
  load_tile<D, BK>(sK, k + ((size_t)bh * Nk + k0) * D, kv);
  load_tile<D, BK>(sV, v + ((size_t)bh * Nk + k0) * D, kv);
  const int any = mark_keys<BK>(sOk, pad ? pad + (size_t)b * Nk : nullptr, k0, kv);

  float dk_acc[R][D / 16], dv_acc[R][D / 16];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  if (any) {
    // the first query that sees key k0 is k0 - off (causal); start at its tile
    const int q_begin = causal ? max(0, k0 - off) / BQ * BQ : 0;
    for (int q0 = q_begin; q0 < Nq; q0 += BQ) {
      __syncthreads();  // the previous tile's readers are done
      const int nq = min(BQ, Nq - q0);
      load_tile<D, BQ>(sQ, q + ((size_t)bh * Nq + q0) * D, nq);
      load_tile<D, BQ>(sdO, dout + ((size_t)bh * Nq + q0) * D, nq);
      load_row_stats<BQ>(sLse, sDelta, lse, delta, (size_t)bh * Nq + q0, nq);
      __syncthreads();
      recompute_p_ds<D, BQ, BK>(sQ, sK, sdO, sV, sLse, sDelta, sOk, sP, sdS, q0, k0, Nq, off, causal, ty, tx);
      __syncthreads();
      mm_tn<D, BQ, LP>(dv_acc, sP, sdO, ty, tx);   // dV[key] += sum_q P[q, key] dO[q]
      mm_tn<D, BQ, LP>(dk_acc, sdS, sQ, ty, tx);   // dK[key] += sum_q dS[q, key] Q[q]
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
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

// dQ for one BQ-query tile over the BK-key tiles it can see.
template <int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const uint8_t* __restrict__ pad, const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, int H, int Nq, int Nk, int causal) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1, LP = BK + 1, R = BQ / 16;
  float* sQ = smem;
  float* sdO = sQ + BQ * LD;
  float* sK = sdO + BQ * LD;
  float* sV = sK + BK * LD;
  float* sdS = sV + BK * LD;
  float* sLse = sdS + BQ * LP;
  float* sDelta = sLse + BQ;
  int* sOk = reinterpret_cast<int*>(sDelta + BQ);

  const int bh = blockIdx.x, b = bh / H;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int off = Nk - Nq;
  const int nq = min(BQ, Nq - q0);
  const uint8_t* pad_row = pad ? pad + (size_t)b * Nk : nullptr;
  load_tile<D, BQ>(sQ, q + ((size_t)bh * Nq + q0) * D, nq);
  load_tile<D, BQ>(sdO, dout + ((size_t)bh * Nq + q0) * D, nq);
  load_row_stats<BQ>(sLse, sDelta, lse, delta, (size_t)bh * Nq + q0, nq);

  float dq_acc[R][D / 16];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) dq_acc[i][j] = 0.f;

  const int k_end = key_end(q0, Nq, Nk, causal, BQ);
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    const int kv = min(BK, Nk - k0);
    load_tile<D, BK>(sK, k + ((size_t)bh * Nk + k0) * D, kv);
    load_tile<D, BK>(sV, v + ((size_t)bh * Nk + k0) * D, kv);
    if (!mark_keys<BK>(sOk, pad_row, k0, kv)) continue;
    recompute_p_ds<D, BQ, BK>(sQ, sK, sdO, sV, sLse, sDelta, sOk, nullptr, sdS, q0, k0, Nq, off, causal, ty, tx);
    __syncthreads();
    mm_nn<D, BK, R>(dq_acc, sdS, sK, ty, tx);     // dQ[q] += sum_key dS[q, key] K[key]
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = ty + 16 * i;
    if (r >= nq) continue;
    float* row = dq + ((size_t)bh * Nq + q0 + r) * D;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) row[tx + 16 * j] = dq_acc[i][j];
  }
}

// --------------------------------------------------------------- launch
template <int D, int BQ, int BK>
constexpr size_t bwd_smem() {  // the larger of the two backward kernels' (dkdv)
  return sizeof(float) * (2 * (BQ + BK) * (D + 1) + 2 * BQ * (BK + 1) + 2 * BQ) + sizeof(int) * BK;
}

template <int D, int BQ = (D <= 128 ? kBQ : kBWideQ), int BK = (D <= 128 ? kBK : kBWide)>
int backward(const void* q, const void* k, const void* v, const void* pad, const void* o, const void* lse,
             const void* dout, void* delta, void* dq, void* dk, void* dv, int B, int H, int Nq, int Nk,
             int causal, cudaStream_t stream) {
  constexpr size_t smem = bwd_smem<D, BQ, BK>();
  static_assert(smem <= 232448, "the backward's tiles must fit in 227 KB of shared memory");
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D, BQ, BK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D, BQ, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
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
  flash_bwd_dkdv_kernel<D, BQ, BK><<<dim3(B * H, (Nk + BK - 1) / BK), kThreads, smem, stream>>>(
      tq, tk, tv, tpad, tdo, tlse, tdelta, static_cast<float*>(dk), static_cast<float*>(dv), H, Nq, Nk, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<D, BQ, BK><<<dim3(B * H, (Nq + BQ - 1) / BQ), kThreads, smem, stream>>>(
      tq, tk, tv, tpad, tdo, tlse, tdelta, static_cast<float*>(dq), H, Nq, Nk, causal);
  return (int)cudaGetLastError();
}

// bq, bk: the query and key rows of a tile (the grid's y extent is at most 65535)
bool valid_sizes(int B, int H, int Nq, int Nk, int bq, int bk) {
  return B >= 1 && H >= 1 && Nq >= 1 && Nk >= 1 && (Nq + bq - 1) / bq <= 65535 && (Nk + bk - 1) / bk <= 65535;
}

}  // namespace

// Plain C entry point, bound with ctypes. q, k, v, dout and the gradients
// are float32 (bfloat16 takes flash_backward_mma.cu and
// flash_backward_wide.cu); o and lse are float32; delta: (B, H, Nq) float32
// scratch; D: 64, 128, ..., 512; pad: (B, Nk) uint8 or null. The Python
// wrapper checks every pointer, shape and type and allocates every output
// and scratch buffer. Returns cudaGetLastError() after its launches (0 =
// launched).
extern "C" int flash_attention_backward(const void* q, const void* k, const void* v, const void* pad,
                                        const void* o, const void* lse, const void* dout, void* delta, void* dq,
                                        void* dk, void* dv, int B, int H, int Nq, int Nk, int D, int causal,
                                        void* stream) {
  if (!valid_sizes(B, H, Nq, Nk, D <= 128 ? kBQ : kBWideQ, D <= 128 ? kBK : kBWide)) return (int)cudaErrorInvalidValue;
  (void)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return backward<64>(q, k, v, pad, o, lse, dout, delta, dq, dk, dv, B, H, Nq, Nk, causal, s);
    case 128: return backward<128>(q, k, v, pad, o, lse, dout, delta, dq, dk, dv, B, H, Nq, Nk, causal, s);
    case 192: return backward<192>(q, k, v, pad, o, lse, dout, delta, dq, dk, dv, B, H, Nq, Nk, causal, s);
    case 256: return backward<256>(q, k, v, pad, o, lse, dout, delta, dq, dk, dv, B, H, Nq, Nk, causal, s);
    case 320: return backward<320>(q, k, v, pad, o, lse, dout, delta, dq, dk, dv, B, H, Nq, Nk, causal, s);
    case 384: return backward<384>(q, k, v, pad, o, lse, dout, delta, dq, dk, dv, B, H, Nq, Nk, causal, s);
    case 448: return backward<448>(q, k, v, pad, o, lse, dout, delta, dq, dk, dv, B, H, Nq, Nk, causal, s);
    case 512: return backward<512>(q, k, v, pad, o, lse, dout, delta, dq, dk, dv, B, H, Nq, Nk, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
