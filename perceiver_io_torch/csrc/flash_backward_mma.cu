// Flash attention backward in bfloat16 on Hopper's tensor cores (sm_90a):
// the gradients dq, dk, dv of softmax(q k^T + mask) v over (B, H, N, D)
// heads, without materialising the (Nq, Nk) score matrix. Kernel B1b for
// bf16 inputs.
//
// Replaces the backward of perceiver_io_tpu/ops/flash.py:splash_mha (the
// custom VJP of the Pallas splash kernel, which runs a dQ kernel and a dK/dV
// kernel) for bfloat16 inputs. The float32 backward is flash_backward_f32.cu,
// the float32 forward flash_forward_f32.cu; the bf16 forward is
// flash_forward_mma.cu. Same function, same layouts as the float32 backward:
//   q      (B, H, Nq, D)  bfloat16, already scaled and rotated queries
//   k, v   (B, H, Nk, D)  bfloat16 keys and values
//   pad    (B, Nk)        uint8, 1 = padding key (the splash segment id 0), or null
//   o      (B, H, Nq, D)  float32 forward output (the delta reads it unrounded)
//   lse    (B, H, Nq)     float32 natural log-sum-exp the forward wrote
//   dout   (B, H, Nq, D)  bfloat16 gradient of the output
//   delta  (B, H, Nq)     float32 scratch
//   dq, dk, dv            bfloat16, the shapes of q, k, v
// Causal is right-aligned: query i sees key j iff j <= Nk - Nq + i. A query
// whose lse is -inf (it sees no key) gets zero gradients, never NaN; pad keys
// get exact-zero dK and dV. Nq and Nk are any sizes; D is 64 or 128.
//
// What bounds it on an H100: 10 D flops a visible (query, key) pair (S, dP,
// dV, dK, dQ) against O(D) bytes a row; at the training shapes the bf16
// tensor cores set the floor. The design, FlashAttention-2's backward in two
// deterministic passes on mma.sync (as the TPU's splash runs a dQ and a
// dK/dV kernel), after a delta pass:
//   * delta = rowsum(dO * O) from the float32 O, one pass, 16-byte loads;
//   * dK/dV: one block per (batch*head, 128-key tile), 8 warps, each owning
//     16 key rows; the query tiles that can see the key tile (from its
//     causal bound on) stream through shared memory, Q and dO double-
//     buffered by cp.async; S^T = K Q^T and dP^T = V dO^T (K, V A-fragments
//     and Q, dO B-fragments by ldmatrix), P^T and dS^T = P^T (dP^T - delta)
//     in registers, then dV += P^T dO and dK += dS^T Q (dO, Q by
//     ldmatrix.trans). Pad keys are written as zeros; a block whose keys
//     are all padding (one block-wide vote) computes nothing;
//   * dQ: one block per (batch*head, 128-query tile), heaviest causal tiles
//     first, 8 warps of 16 query rows; key tiles double-buffered up to the
//     causal bound; S = Q K^T and dP = dO V^T, P and dS in registers,
//     dQ += dS K (K by ldmatrix.trans). All-padding key tiles are skipped
//     after one block-wide count; rows past Nq are never stored;
//   * streamed tiles (queries or keys) of 64 rows, 32 at D 128 (kCols), so
//     that the dK/dV pass's 128 float32 accumulators a thread fit in
//     registers without spilling;
//   * shared rows XOR-swizzled in 16-byte chunks (every ldmatrix free of
//     bank conflicts); rows past Nq or Nk zero-filled by the copy's source
//     size; the causal compare only on tiles that straddle a warp's
//     diagonal, and a warp skips a tile it cannot see;
//   * the rounding: P (for dV) and dS (for dK and dQ) enter their products
//     as two bf16 terms, hi + lo (kTerms), from their float32 C-fragments
//     repacked in registers. One term moved dv and dk past B1's bf16 limit
//     where a row sees a few keys (the CPU emulation in
//     tests/test_torch_flash.py); two cost 20 D tensor-core flops a pair
//     against one term's 14 D.
// No atomics: every gradient is written once by one block, so two runs give
// the same bits. Next steps (later work): wgmma with TMA loads.

#include "mma_tiles.cuh"

namespace {

constexpr int kRows = 16 * kWarps;  // rows a block owns: keys (dK/dV pass) or queries (dQ pass)
constexpr int kTerms = 2;           // bf16 terms of P and dS in their products (hi + lo)
// rows of each streamed tile: queries (dK/dV) or keys (dQ); 32 at D = 128
// keeps the dK/dV pass's 128 accumulators a thread from spilling
template <int D>
constexpr int kCols = D == 128 ? 32 : 64;

// A warp's (16, kC) float32 C-fragments x as bf16 A-fragments of the next
// product, in kTerms terms: t[0] = bf16(x), t[1] = bf16(x - t[0]).
template <int kC>
__device__ __forceinline__ void to_a_fragments(const float (&x)[kC / 8][4], uint32_t (&t)[kTerms][kC / 16][4]) {
#pragma unroll
  for (int j = 0; j < kC / 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const __nv_bfloat162 hi = __floats2bfloat162_rn(x[j][2 * r], x[j][2 * r + 1]);
      t[0][j / 2][(j & 1) * 2 + r] = pack(hi);
      if constexpr (kTerms == 2) {
        const float2 h = __bfloat1622float2(hi);
        t[1][j / 2][(j & 1) * 2 + r] = pack(__floats2bfloat162_rn(x[j][2 * r] - h.x, x[j][2 * r + 1] - h.y));
      }
    }
  }
}

// acc (16, D) += a (16, kC; kTerms terms) b, where b is the row-major
// (kC, D) shared tile `tile`: its B-fragments by ldmatrix.trans.
template <int D, int kC>
__device__ __forceinline__ void accumulate_t(float (&acc)[D / 8][4], const uint32_t (&a)[kTerms][kC / 16][4],
                                             const bf16* tile, int lane, int mat) {
#pragma unroll
  for (int kk = 0; kk < kC / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      uint32_t bt[4];  // rows 16 kk + 0..15, channels 16 j + 0..7 and + 8..15
      ldsm_x4_trans(bt, smem_addr(tile + swz<D>(16 * kk + (mat & 1) * 8 + (lane & 7), 2 * j + (mat >> 1))));
#pragma unroll
      for (int h = 0; h < kTerms; ++h) {
        mma_bf16(acc[2 * j], a[h][kk], bt[0], bt[1]);
        mma_bf16(acc[2 * j + 1], a[h][kk], bt[2], bt[3]);
      }
    }
  }
}

// -lse * log2(e) of a query, the shift of its exp2; -inf for a query past Nq
// or one that sees no key (lse = -inf), so that its P is 0.
__device__ __forceinline__ float neg_lse_log2(const float* __restrict__ lse, size_t at, bool valid) {
  const float l = valid ? lse[at] : -INFINITY;
  return l == -INFINITY ? -INFINITY : -l * kLog2e;
}

// ----------------------------------------------------------------- dK, dV
template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dkdv_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const uint8_t* __restrict__ pad, const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Nq, int Nk,
    int causal) {
  constexpr int kC = kCols<D>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);  // (kRows, D)
  bf16* sV = sK + kRows * D;                     // (kRows, D)
  bf16* sQ = sV + kRows * D;                     // 2 stages of (kC, D)
  bf16* sdO = sQ + 2 * kC * D;                   // 2 stages of (kC, D)
  float* sNl = reinterpret_cast<float*>(sdO + 2 * kC * D);  // 2 stages of kC: neg_lse_log2
  float* sDelta = sNl + 2 * kC;                             // 2 stages of kC

  const int bh = blockIdx.x, b = bh / H;
  const int k0 = blockIdx.y * kRows;  // the first key tiles see the most queries: launched first
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;  // the thread's rows g, g + 8 and column pair 2 t4 of each fragment
  const int mat = lane / 8;               // which 8 x 8 matrix of an ldmatrix.x4 this lane addresses
  const int wrow = warp * 16;
  const int off = Nk - Nq;
  const uint8_t* pad_row = pad ? pad + (size_t)b * Nk : nullptr;
  bool key_ok[2];  // this thread's key rows k0 + wrow + g (+ 8) are in range and not padding
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kr = k0 + wrow + g + 8 * r;
    key_ok[r] = kr < Nk && !(pad_row && pad_row[kr]);
  }
  const bool warp_live = __any_sync(0xffffffffu, key_ok[0] || key_ok[1]);
  const bool block_live = __syncthreads_or(key_ok[0] || key_ok[1]);
  // the first query that sees key k0 is k0 - off (causal): start at its tile
  const int q_begin = causal ? max(0, k0 - off) / kC * kC : 0;
  const int n_tiles = block_live ? (Nq - q_begin + kC - 1) / kC : 0;
  const bf16* qb = q + (size_t)bh * Nq * D;
  const bf16* dob = dout + (size_t)bh * Nq * D;

  float nl = 0.f, dl = 0.f;  // threads < kC: the next tile's neg_lse_log2 and delta of query tid
  if (n_tiles > 0) {
    const int kv = min(kRows, Nk - k0);
    load_tile<D, kRows>(sK, k + ((size_t)bh * Nk + k0) * D, kv);
    load_tile<D, kRows>(sV, v + ((size_t)bh * Nk + k0) * D, kv);
    const int nq = min(kC, Nq - q_begin);
    load_tile<D, kC>(sQ, qb + (size_t)q_begin * D, nq);
    load_tile<D, kC>(sdO, dob + (size_t)q_begin * D, nq);
    cp_async_commit();
    if (tid < kC) {
      const size_t at = (size_t)bh * Nq + q_begin + tid;
      nl = neg_lse_log2(lse, at, tid < nq);
      dl = tid < nq ? delta[at] : 0.f;
    }
  }

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = q_begin + t * kC, st = t & 1;
    cp_async_wait<0>();  // tile t has landed (this thread's copies)
    if (tid < kC) {
      sNl[st * kC + tid] = nl;
      sDelta[st * kC + tid] = dl;
    }
    __syncthreads();  // every copy and stat of tile t is visible; tile t - 1's readers are done
    if (t + 1 < n_tiles) {  // the next tile's copies fly while this one is multiplied
      const int q1 = q0 + kC, nq1 = min(kC, Nq - q1);
      load_tile<D, kC>(sQ + (st ^ 1) * kC * D, qb + (size_t)q1 * D, nq1);
      load_tile<D, kC>(sdO + (st ^ 1) * kC * D, dob + (size_t)q1 * D, nq1);
      cp_async_commit();
      if (tid < kC) {
        const size_t at = (size_t)bh * Nq + q1 + tid;
        nl = neg_lse_log2(lse, at, tid < nq1);
        dl = tid < nq1 ? delta[at] : 0.f;
      }
    }
    if (!warp_live) continue;                                // this warp's keys are all padding
    if (causal && k0 + wrow > off + q0 + kC - 1) continue;  // no query of the tile sees them yet
    const bf16* tQ = sQ + st * kC * D;
    const bf16* tdO = sdO + st * kC * D;
    const float* nl_t = sNl + st * kC;
    const float* dl_t = sDelta + st * kC;

    // S^T = K Q^T and dP^T = V dO^T: (16 keys, kC queries) per warp
    float s[kC / 8][4], dp[kC / 8][4];
#pragma unroll
    for (int j = 0; j < kC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    // at D 128 a full unroll spills: ptxas hoists the fragments of every kk
#pragma unroll(D == 128 ? 2 : D / 16)
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];  // the warp's keys, channels 16 kk + 0..15
      ldsm_x4(ka, smem_addr(sK + swz<D>(wrow + (lane & 15), 2 * kk + (lane >> 4))));
      ldsm_x4(va, smem_addr(sV + swz<D>(wrow + (lane & 15), 2 * kk + (lane >> 4))));
#pragma unroll
      for (int j = 0; j < kC / 16; ++j) {
        uint32_t bq[4], bo[4];  // queries 16 j + 0..7 and + 8..15, channels 16 kk + 0..15
        const int at = swz<D>(16 * j + (mat >> 1) * 8 + (lane & 7), 2 * kk + (mat & 1));
        ldsm_x4(bq, smem_addr(tQ + at));
        ldsm_x4(bo, smem_addr(tdO + at));
        mma_bf16(s[2 * j], ka, bq[0], bq[1]);
        mma_bf16(s[2 * j + 1], ka, bq[2], bq[3]);
        mma_bf16(dp[2 * j], va, bo[0], bo[1]);
        mma_bf16(dp[2 * j + 1], va, bo[2], bo[3]);
      }
    }

    // P^T = exp2(S^T log2(e) - lse log2(e)), dS^T = P^T (dP^T - delta): rows
    // kr, kr + 8 (entries 0, 1 and 2, 3), query columns 8 j + 2 t4 + e
    const bool straddle = causal && k0 + wrow + 15 > off + q0;
    const int kr = k0 + wrow + g - off - q0;  // key row g hides query column c iff c < kr
#pragma unroll
    for (int j = 0; j < kC / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * t4 + e;
        const float nlc = nl_t[c], dc = dl_t[c];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float p = exp2f(fmaf(s[j][2 * r + e], kLog2e, nlc));  // exp2(-inf) = 0
          if (straddle && c < kr + 8 * r) p = 0.f;
          s[j][2 * r + e] = p;
          dp[j][2 * r + e] = p * (dp[j][2 * r + e] - dc);
        }
      }
    }
    // dV += P^T dO, then dK += dS^T Q (one product at a time keeps fewer
    // registers live): dO's and Q's B-fragments by ldmatrix.trans
    uint32_t pa[kTerms][kC / 16][4];
    to_a_fragments<kC>(s, pa);
    accumulate_t<D, kC>(dva, pa, tdO, lane, mat);
    to_a_fragments<kC>(dp, pa);
    accumulate_t<D, kC>(dka, pa, tQ, lane, mat);
  }

  // epilogue: bf16 once; pad keys (and a block that saw only padding) get zeros
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + wrow + g + 8 * r;
    if (row >= Nk) continue;
    const size_t at = ((size_t)bh * Nk + row) * D + 2 * t4;
    const __nv_bfloat162 zero = __floats2bfloat162_rn(0.f, 0.f);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + at + 8 * j) =
          key_ok[r] ? __floats2bfloat162_rn(dka[j][2 * r], dka[j][2 * r + 1]) : zero;
      *reinterpret_cast<__nv_bfloat162*>(dv + at + 8 * j) =
          key_ok[r] ? __floats2bfloat162_rn(dva[j][2 * r], dva[j][2 * r + 1]) : zero;
    }
  }
}

// ----------------------------------------------------------------- dQ
template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dq_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const uint8_t* __restrict__ pad, const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq, int H, int Nq, int Nk, int causal) {
  constexpr int kC = kCols<D>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // (kRows, D)
  bf16* sdO = sQ + kRows * D;                    // (kRows, D)
  bf16* sK = sdO + kRows * D;                    // 2 stages of (kC, D)
  bf16* sV = sK + 2 * kC * D;                    // 2 stages of (kC, D)
  int* sOk = reinterpret_cast<int*>(sV + 2 * kC * D);  // 2 stages of kC key flags

  const int bh = blockIdx.x, b = bh / H;
  const int q0 = (int)(gridDim.y - 1 - blockIdx.y) * kRows;  // heaviest causal tiles first
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int mat = lane / 8;
  const int wrow = warp * 16;
  const int off = Nk - Nq;
  const bf16* kb = k + (size_t)bh * Nk * D;
  const bf16* vb = v + (size_t)bh * Nk * D;
  const uint8_t* pad_row = pad ? pad + (size_t)b * Nk : nullptr;
  const int q_rows = min(kRows, Nq - q0);
  const int k_end = causal ? min(Nk, max(0, off + q0 + q_rows)) : Nk;  // past the causal bound: never loaded
  const int n_tiles = (k_end + kC - 1) / kC;

  load_tile<D, kRows>(sQ, q + ((size_t)bh * Nq + q0) * D, q_rows);
  load_tile<D, kRows>(sdO, dout + ((size_t)bh * Nq + q0) * D, q_rows);
  int ok = 0;  // threads < kC: key tid of the next tile is in range and not padding
  if (n_tiles > 0) {
    const int kv = min(kC, Nk);
    load_tile<D, kC>(sK, kb, kv);
    load_tile<D, kC>(sV, vb, kv);
    if (tid < kC) ok = tid < kv && !(pad_row && pad_row[tid]);
  }
  cp_async_commit();
  float nl[2], dl[2];  // rows q0 + wrow + g (+ 8): neg_lse_log2 and delta
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wrow + g + 8 * r;
    const size_t at = (size_t)bh * Nq + row;
    nl[r] = neg_lse_log2(lse, at, row < Nq);
    dl[r] = row < Nq ? delta[at] : 0.f;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const int lim = off + q0 + wrow + g;  // the last key row g may see (causal); row g + 8: lim + 8

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kC, st = t & 1;
    cp_async_wait<0>();  // tile t (and Q, dO) have landed (this thread's copies)
    if (tid < kC) sOk[st * kC + tid] = ok;
    const int n_ok = __syncthreads_count(tid < kC && ok);  // every copy and flag of tile t is visible
    if (t + 1 < n_tiles) {  // the next tile's copies fly while this one is multiplied
      const int k1 = k0 + kC, kv1 = min(kC, Nk - k1);
      load_tile<D, kC>(sK + (st ^ 1) * kC * D, kb + (size_t)k1 * D, kv1);
      load_tile<D, kC>(sV + (st ^ 1) * kC * D, vb + (size_t)k1 * D, kv1);
      cp_async_commit();
      if (tid < kC) ok = tid < kv1 && !(pad_row && pad_row[k1 + tid]);
    }
    if (n_ok == 0) continue;                            // padding only: nothing to see
    if (causal && k0 > off + q0 + wrow + 15) continue;  // past every row of this warp
    const bf16* tK = sK + st * kC * D;
    const bf16* tV = sV + st * kC * D;

    // S = Q K^T and dP = dO V^T: (16 queries, kC keys) per warp
    float s[kC / 8][4], dp[kC / 8][4];
#pragma unroll
    for (int j = 0; j < kC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], oa[4];  // the warp's queries, channels 16 kk + 0..15
      ldsm_x4(qa, smem_addr(sQ + swz<D>(wrow + (lane & 15), 2 * kk + (lane >> 4))));
      ldsm_x4(oa, smem_addr(sdO + swz<D>(wrow + (lane & 15), 2 * kk + (lane >> 4))));
#pragma unroll
      for (int j = 0; j < kC / 16; ++j) {
        uint32_t bk[4], bv[4];  // keys 16 j + 0..7 and + 8..15, channels 16 kk + 0..15
        const int at = swz<D>(16 * j + (mat >> 1) * 8 + (lane & 7), 2 * kk + (mat & 1));
        ldsm_x4(bk, smem_addr(tK + at));
        ldsm_x4(bv, smem_addr(tV + at));
        mma_bf16(s[2 * j], qa, bk[0], bk[1]);
        mma_bf16(s[2 * j + 1], qa, bk[2], bk[3]);
        mma_bf16(dp[2 * j], oa, bv[0], bv[1]);
        mma_bf16(dp[2 * j + 1], oa, bv[2], bv[3]);
      }
    }

    // P and dS = P (dP - delta): a tile with a hidden key, or one that
    // straddles the warp's diagonal, is masked
    const bool mask = n_ok < kC || (causal && k0 + kC - 1 > off + q0 + wrow);
    const int* ok_t = sOk + st * kC;
#pragma unroll
    for (int j = 0; j < kC / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * t4 + e;
        const bool hidden_key = mask && ok_t[c] == 0;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float p = exp2f(fmaf(s[j][2 * r + e], kLog2e, nl[r]));  // exp2(-inf) = 0
          if (hidden_key || (mask && causal && k0 + c > lim + 8 * r)) p = 0.f;
          dp[j][2 * r + e] = p * (dp[j][2 * r + e] - dl[r]);
        }
      }
    }
    // dQ += dS K: K's B-fragments by ldmatrix.trans
    uint32_t da[kTerms][kC / 16][4];
    to_a_fragments<kC>(dp, da);
    accumulate_t<D, kC>(acc, da, tK, lane, mat);
  }
  cp_async_wait<0>();  // a tile with no visible key never waited for its Q and dO copies

  // epilogue: bf16 once; rows past Nq are never stored
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wrow + g + 8 * r;
    if (row >= Nq) continue;
    bf16* qrow = dq + ((size_t)bh * Nq + row) * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(qrow + 8 * j) = __floats2bfloat162_rn(acc[j][2 * r], acc[j][2 * r + 1]);
  }
}

// --------------------------------------------------------------- launch
template <int D>
constexpr size_t smem_bytes() {  // either pass: two (kRows, D) tiles, two stages of two (kCols, D) tiles
  return sizeof(bf16) * (2 * kRows + 4 * kCols<D>) * D + sizeof(float) * 4 * kCols<D>;
}

template <int D>
int backward(const void* q, const void* k, const void* v, const void* pad, const void* o, const void* lse,
             const void* dout, void* delta, void* dq, void* dk, void* dv, int B, int H, int Nq, int Nk, int causal,
             cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dq_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const bf16* tq = static_cast<const bf16*>(q);
  const bf16* tk = static_cast<const bf16*>(k);
  const bf16* tv = static_cast<const bf16*>(v);
  const bf16* tdo = static_cast<const bf16*>(dout);
  const uint8_t* tpad = static_cast<const uint8_t*>(pad);
  const float* tlse = static_cast<const float*>(lse);
  float* tdelta = static_cast<float*>(delta);
  const int rows = B * H * Nq;
  err = launch_delta<D>(static_cast<const float*>(o), tdo, tdelta, rows, stream);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_mma_kernel<D><<<dim3(B * H, (Nk + kRows - 1) / kRows), kThreads, smem, stream>>>(
      tq, tk, tv, tpad, tdo, tlse, tdelta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Nq, Nk, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_mma_kernel<D><<<dim3(B * H, (Nq + kRows - 1) / kRows), kThreads, smem, stream>>>(
      tq, tk, tv, tpad, tdo, tlse, tdelta, static_cast<bf16*>(dq), H, Nq, Nk, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. q, k, v, dout bfloat16 (16-byte
// aligned, contiguous); o, lse float32; delta (B, H, Nq) float32 scratch;
// dq, dk, dv bfloat16; D: 64 or 128; pad: (B, Nk) uint8 or null. The Python
// wrapper checks every pointer, shape and type and allocates every output
// and the scratch. Returns cudaGetLastError() after the launches (0 =
// launched).
extern "C" int flash_backward_mma(const void* q, const void* k, const void* v, const void* pad, const void* o,
                                  const void* lse, const void* dout, void* delta, void* dq, void* dk, void* dv, int B,
                                  int H, int Nq, int Nk, int D, int causal, void* stream) {
  if (B < 1 || H < 1 || Nq < 1 || Nk < 1 || (D != 64 && D != 128) || (Nq + kRows - 1) / kRows > 65535 ||
      (Nk + kRows - 1) / kRows > 65535)
    return (int)cudaErrorInvalidValue;
  (void)cudaGetLastError();  // clear a stale error so the one returned is this launch's
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 64 ? backward<64>(q, k, v, pad, o, lse, dout, delta, dq, dk, dv, B, H, Nq, Nk, causal, s)
                 : backward<128>(q, k, v, pad, o, lse, dout, delta, dq, dk, dv, B, H, Nq, Nk, causal, s);
}
