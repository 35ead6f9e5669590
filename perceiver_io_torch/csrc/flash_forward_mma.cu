// Flash attention forward in bfloat16 on Hopper's tensor cores (sm_90a):
// softmax(q k^T + mask) v over (B, H, N, D) heads, without materialising the
// (Nq, Nk) score matrix. Kernel B1a for bf16 inputs, and kernel B5 with it.
//
// Replaces the forward of perceiver_io_tpu/ops/flash.py:splash_mha (the Pallas
// splash kernel built by `_build_kernel` via `make_splash_mha`) for bfloat16
// inputs, and perceiver_io_tpu/parallel/ring_attention.py:_splash_fwd_block
// (ring attention's fully visible blocks: the same kernel with no causal mask,
// whose float32 output and log-sum-exp the ring merges). The float32 forward
// is flash_forward_f32.cu; the bf16 backward (B1b) is flash_backward_mma.cu.
// Same function, same layouts as flash_forward_f32.cu:
//   q     (B, H, Nq, D)  bfloat16, already scaled and rotated queries
//   k, v  (B, H, Nk, D)  bfloat16 keys and values
//   pad   (B, Nk)        uint8, 1 = padding key (the splash segment id 0), or null
//   o     (B, H, Nq, D)  float32 output (the backward's delta reads it unrounded)
//   lse   (B, H, Nq)     float32 natural log-sum-exp of each query's visible scores
// Causal is right-aligned: query i sees key j iff j <= Nk - Nq + i. A query
// that sees no key gets exact zeros and lse = -inf. Nq and Nk are any sizes;
// a key tile (or a whole row) may be all padding. D is 64 or 128.
//
// What bounds it on an H100: 4 D flops a visible (query, key) pair against
// O(D) bytes a row read once; at the training shapes (512 queries over 512-
// 2304 keys) bytes and bf16 tensor-core flops give about the same floor. The
// design, FlashAttention-2's on mma.sync:
//   * one block per (batch*head, 128-query tile), 8 warps, each owning 16
//     query rows; query tiles are launched heaviest first (reversed index), so
//     the causal tail does not wait on long tiles;
//   * cp.async 16-byte copies: Q once, K and V in 64-key tiles double-buffered
//     (the next tile's copy is in flight while this one is multiplied); rows
//     past Nk are zero-filled by the copy's source size; shared rows are
//     XOR-swizzled in 16-byte chunks so every ldmatrix is free of bank
//     conflicts;
//   * S = Q K^T and O += P V by mma.sync.m16n8k16 (bf16 in, float32 sums):
//     Q's A-fragments are loaded once by ldmatrix and kept in registers, K's
//     B-fragments by ldmatrix, V's by ldmatrix.trans;
//   * the mask and the online softmax in registers: pad flags read once per
//     tile from shared memory, the causal compare only on tiles that straddle
//     the diagonal, tiles past the causal bound never loaded, all-padding
//     tiles skipped after one block-wide vote; a row's running max reduced
//     across its quad by shuffles; exp2 on log2(e)-scaled scores; the sum l
//     of the unrounded float32 p;
//   * P never leaves registers: S's float32 C-fragment becomes the A-fragment
//     of the P V product, packed as bf16x2. kSplitP chooses the rounding: B1a
//     rounds P to bf16 once (its output is cast to bf16, within the bf16
//     limit); B5 writes P = hi + lo as two bf16 terms and two products, so its
//     float32 output holds 1e-4 (one term moves it by up to ~8e-4).
// Next steps (later work): wgmma with TMA loads and warp specialisation.

#include "mma_tiles.cuh"

namespace {

constexpr int kBQ = 16 * kWarps;       // query rows per block, 16 a warp
constexpr int kBK = 64;                // key rows per tile

// ----------------------------------------------------------------- kernel
template <int D, bool kSplitP>
__global__ void __launch_bounds__(kThreads, 1) flash_fwd_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const uint8_t* __restrict__ pad, float* __restrict__ o, float* __restrict__ lse, int H, int Nq, int Nk,
    int causal) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // (kBQ, D)
  bf16* sK = sQ + kBQ * D;                       // 2 stages of (kBK, D)
  bf16* sV = sK + 2 * kBK * D;                   // 2 stages of (kBK, D)
  int* sOk = reinterpret_cast<int*>(sV + 2 * kBK * D);  // 2 stages of kBK key flags

  const int bh = blockIdx.x, b = bh / H;
  const int q0 = (int)(gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest causal tiles first
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;  // the thread's rows g, g + 8 and column pair 2 t4 of each fragment
  const int mat = lane / 8;               // which 8 x 8 matrix of an ldmatrix.x4 this lane addresses
  const int wrow = warp * 16;
  const int off = Nk - Nq;
  const bf16* kb = k + (size_t)bh * Nk * D;
  const bf16* vb = v + (size_t)bh * Nk * D;
  const uint8_t* pad_row = pad ? pad + (size_t)b * Nk : nullptr;
  const int q_rows = min(kBQ, Nq - q0);
  const int k_end = causal ? min(Nk, max(0, off + q0 + q_rows)) : Nk;  // past the causal bound: never loaded
  const int n_tiles = (k_end + kBK - 1) / kBK;

  load_tile<D, kBQ>(sQ, q + ((size_t)bh * Nq + q0) * D, q_rows);
  cp_async_commit();
  int ok = 0;  // threads < kBK: key tid of the next tile is in range and not padding
  if (n_tiles > 0) {
    const int kv = min(kBK, Nk);
    load_tile<D, kBK>(sK, kb, kv);
    load_tile<D, kBK>(sV, vb, kv);
    if (tid < kBK) ok = tid < kv && !(pad_row && pad_row[tid]);
  }
  cp_async_commit();
  cp_async_wait<1>();  // Q has landed
  __syncthreads();
  uint32_t qf[D / 16][4];  // Q's A-fragments, kept for the whole key loop
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) ldsm_x4(qf[kk], smem_addr(sQ + swz<D>(wrow + (lane & 15), 2 * kk + (lane >> 4))));

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of rows g, g + 8 (natural units)
  float l[2] = {0.f, 0.f};              // this thread's part of their running sums
  const int lim = off + q0 + wrow + g;  // the last key row g may see (causal); row g + 8: lim + 8

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK, st = t & 1;
    cp_async_wait<0>();  // tile t has landed (this thread's copies)
    if (tid < kBK) sOk[st * kBK + tid] = ok;
    const int n_ok = __syncthreads_count(tid < kBK && ok);  // every copy and flag of tile t is visible
    if (t + 1 < n_tiles) {  // the next tile's copies fly while this one is multiplied
      const int k1 = k0 + kBK, kv1 = min(kBK, Nk - k1);
      load_tile<D, kBK>(sK + (st ^ 1) * kBK * D, kb + (size_t)k1 * D, kv1);
      load_tile<D, kBK>(sV + (st ^ 1) * kBK * D, vb + (size_t)k1 * D, kv1);
      cp_async_commit();
      if (tid < kBK) ok = tid < kv1 && !(pad_row && pad_row[k1 + tid]);
    }
    if (n_ok == 0) continue;                              // padding only: nothing to see
    if (causal && k0 > off + q0 + wrow + 15) continue;    // past every row of this warp
    const bf16* tK = sK + st * kBK * D;
    const bf16* tV = sV + st * kBK * D;

    // S = Q K^T: (16, kBK) per warp as kBK / 8 C-fragments
    float s[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j) {
        uint32_t bk[4];  // keys 16 j + 0..7 and + 8..15, channels 16 kk + 0..15
        ldsm_x4(bk, smem_addr(tK + swz<D>(16 * j + (mat >> 1) * 8 + (lane & 7), 2 * kk + (mat & 1))));
        mma_bf16(s[2 * j], qf[kk], bk[0], bk[1]);
        mma_bf16(s[2 * j + 1], qf[kk], bk[2], bk[3]);
      }
    }

    // mask: a tile with a hidden key, or one that straddles the warp's diagonal
    if (n_ok < kBK || (causal && k0 + kBK - 1 > off + q0 + wrow)) {
      const int* ok_t = sOk + st * kBK;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * t4 + e;
          const bool key = ok_t[c] != 0;
          if (!key || (causal && k0 + c > lim)) s[j][e] = -INFINITY;
          if (!key || (causal && k0 + c > lim + 8)) s[j][2 + e] = -INFINITY;
        }
      }
    }

    // online softmax: rows g (fragment entries 0, 1) and g + 8 (entries 2, 3)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float shift[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_use = mx[r] == -INFINITY ? 0.f : mx[r];  // no visible key yet: keep exp2 off inf - inf
      alpha[r] = exp2f((m[r] - m_use) * kLog2e);
      shift[r] = m_use * kLog2e;
      m[r] = mx[r];
    }
    uint32_t pa[kBK / 16][4];                      // P as the P V product's A-fragments
    uint32_t pl[kSplitP ? kBK / 16 : 1][4];        // its low bf16 term (kSplitP)
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) p[e] = exp2f(fmaf(s[j][e], kLog2e, -shift[e / 2]));  // exp2(-inf) = 0
      rs[0] += p[0] + p[1];
      rs[1] += p[2] + p[3];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p[2 * r], p[2 * r + 1]);
        pa[j / 2][(j & 1) * 2 + r] = pack(hi);
        if constexpr (kSplitP) {
          const float2 h = __bfloat1622float2(hi);
          pl[j / 2][(j & 1) * 2 + r] = pack(__floats2bfloat162_rn(p[2 * r] - h.x, p[2 * r + 1] - h.y));
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // O += P V: V's B-fragments by ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        uint32_t bv[4];  // keys 16 kk + 0..15, channels 16 j + 0..7 and + 8..15
        ldsm_x4_trans(bv, smem_addr(tV + swz<D>(16 * kk + (mat & 1) * 8 + (lane & 7), 2 * j + (mat >> 1))));
        mma_bf16(acc[2 * j], pa[kk], bv[0], bv[1]);
        mma_bf16(acc[2 * j + 1], pa[kk], bv[2], bv[3]);
        if constexpr (kSplitP) {
          mma_bf16(acc[2 * j], pl[kk], bv[0], bv[1]);
          mma_bf16(acc[2 * j + 1], pl[kk], bv[2], bv[3]);
        }
      }
    }
  }

  // epilogue: o = acc / l, lse = m + log l; rows that saw no key get zeros and -inf
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = q0 + wrow + g + 8 * r;
    if (row >= Nq) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    float* orow = o + ((size_t)bh * Nq + row) * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(orow + 8 * j) = make_float2(acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
    if (t4 == 0) lse[(size_t)bh * Nq + row] = l[r] > 0.f ? m[r] + logf(l[r]) : -INFINITY;
  }
}

// --------------------------------------------------------------- launch
template <int D>
constexpr size_t smem_bytes() {
  return sizeof(bf16) * (kBQ + 4 * kBK) * D + sizeof(int) * 2 * kBK;
}

template <int D, bool kSplitP>
int forward(const void* q, const void* k, const void* v, const void* pad, void* o, void* lse, int B, int H, int Nq,
            int Nk, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_mma_kernel<D, kSplitP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (Nq + kBQ - 1) / kBQ);
  flash_fwd_mma_kernel<D, kSplitP><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const uint8_t*>(pad), static_cast<float*>(o), static_cast<float*>(lse), H, Nq, Nk, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. q, k, v bfloat16 (16-byte aligned,
// contiguous); o, lse float32; D: 64 or 128; pad: (B, Nk) uint8 or null;
// split_p: 1 = P as two bf16 terms (B5), 0 = one (B1a). The Python wrapper
// checks every pointer, shape and type and allocates the outputs. Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int flash_forward_mma(const void* q, const void* k, const void* v, const void* pad, void* o, void* lse,
                                 int B, int H, int Nq, int Nk, int D, int causal, int split_p, void* stream) {
  if (B < 1 || H < 1 || Nq < 1 || Nk < 1 || (D != 64 && D != 128) || (Nq + kBQ - 1) / kBQ > 65535)
    return (int)cudaErrorInvalidValue;
  (void)cudaGetLastError();  // clear a stale error so the one returned is this launch's
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return split_p ? forward<64, true>(q, k, v, pad, o, lse, B, H, Nq, Nk, causal, s)
                   : forward<64, false>(q, k, v, pad, o, lse, B, H, Nq, Nk, causal, s);
  return split_p ? forward<128, true>(q, k, v, pad, o, lse, B, H, Nq, Nk, causal, s)
                 : forward<128, false>(q, k, v, pad, o, lse, B, H, Nq, Nk, causal, s);
}
