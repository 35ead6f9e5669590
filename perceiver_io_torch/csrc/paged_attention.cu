// Paged decode attention for Hopper (sm_90a): one query per row (B3) or per
// work item (B4) over a shared KV page pool addressed through a page table,
// with ring-offset visibility, RoPE applied to the keys in-stream, fused
// int8/int4 dequantization and an online softmax, split across blocks
// (flash-decoding) and merged in the same launch.
//
// Replaces, with one templated kernel and two entry points:
//   B3  perceiver_io_tpu/ops/paged_decode_kernel.py:fused_paged_decode_attention
//       (the Pallas kernel `_paged_kernel`): fp and int8 pools, row b reads
//       table row b;
//   B4  perceiver_io_tpu/ops/ragged_paged_kernel.py:fused_ragged_paged_attention
//       (the Pallas kernel `_ragged_kernel`): item w reads its own table row,
//       with its causal bound folded into (start, live) once per block, and
//       also int4 pools.
// Layouts (W rows or items, H heads, D head dim, P pages per row, ps page size):
//   q      (W, H, 1, D)   scaled and rotated queries, TQ (float or bf16)
//   kp, vp (N, ps, H*D)   unrotated pool: TQ, int8, or (N, ps, H*D/2) uint8
//                         nibbles (code + 8, even channel in the low nibble)
//   table  (W, P) int32   physical page of each logical page
//   start, live, cb (W,)  post-append ring offset, live count, causal bound
//   ang    (W, P*ps, r)   float32 angles per physical ring position
//   kscale, vscale (N, H) float32 per-page-per-head scales (quantized pools)
//   out    (W, H, 1, D)   TQ
//   ws, counters          split workspace and per-(row, head) counters
//                         (decode_split.cuh), owned by the Python wrapper
// Physical position r (r < window) holds logical position (r - start) mod
// window and is visible iff that is >= window - live. Codes are multiplied by
// their page's scale BEFORE the rotation. A row that sees nothing (live = 0)
// returns exact zeros: l is clamped at 1e-30 and acc stays 0.
//
// What bounds it on an H100: bytes, in principle. Each live row's key and
// value are read once per (row, head) for one dot product and one axpy, far
// below the ~295 flop/byte where the tensor cores would be the limit, so the
// floor is (live K/V rows + their angles + scales) / 3.35 TB/s. Measured
// (PERF.md §6) it runs 5-22x over that floor: each warp waits for its next
// rows a few times a split, and the launch, the dependent loads before the
// first copy and the in-launch merge cost a fixed part; the rotation's
// sincosf and the angle rows (re-read by every head's block) are a smaller
// part.
//
// Design (split-K flash-decoding):
//   * grid (H, W, S): the live ring interval [s0, s0 + live) of a row touches
//     `count` pages, walked in ring order from the page holding the oldest
//     live position, so a page with no live row is never read (the TPU
//     kernel's dead-page skip). Split k of the row's n_k = max(1, min(S,
//     count)) splits takes walk pages [k count / n_k, (k+1) count / n_k),
//     at least one page each; blocks k >= n_k return at once. The wrapper
//     picks S from the SM count (about 8 blocks an SM) and the window
//     (ops/paged_decode_kernel.py:paged_splits). paged_split_rows there
//     mirrors this arithmetic: the CPU tests check the mirror, and a card
//     test holds it against the splits' workspace records
//     (tests/test_torch_cuda.py);
//   * a block reads its pages' ids and two scales into shared memory once;
//   * each warp streams its own groups of kRows rows (group g to warp
//     g mod 8) through kStages shared-memory buffers filled by cp.async
//     16-byte copies: the next groups' key, value and angle rows load while
//     the current group is scored. Only visible rows are copied, so a partly live
//     page costs no dead reads;
//   * a group's kRows rows are scored together: dequantize, rotate (sincosf,
//     once per pair when its two angles are equal), dot with the query, then
//     the kRows warp-shuffle reductions and exps interleave, and one online-
//     softmax update takes the group;
//   * lane l holds channel pairs p = l, l+32, ...: one rotation pair is one
//     float2 / bf162, two int8 codes, or one int4 byte;
//   * the warps merge through shared memory, then the splits merge in the
//     same launch (decode_split.cuh): the last block of a (row, head) to
//     finish merges every split's (m, l, acc) in split order, so two runs
//     give the same bits.

#include "decode_split.cuh"

namespace {

constexpr int kRows = 4;       // rows a warp scores at once: one buffer of its pipeline
constexpr int kStages = 2;     // buffers a warp cycles through: kStages - 1 groups load while one is scored
constexpr int kMaxPages = 64;  // pages of one split (the wrapper asks for enough splits)

enum PoolKind { kF32 = 0, kBF16 = 1, kInt8 = 2, kInt4 = 3 };

// Bytes of one head's slice of a pool row.
__host__ __device__ __forceinline__ int pool_row_bytes(int kind, int D) {
  return kind == kF32 ? 4 * D : kind == kBF16 ? 2 * D : kind == kInt8 ? D : D / 2;
}

__device__ __forceinline__ float2 load_q(const float* p) { return *reinterpret_cast<const float2*>(p); }

__device__ __forceinline__ float2 load_q(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Channel pair p of a head's row staged in shared memory: raw values, or
// integer codes for quantized pools.
template <int KIND>
__device__ __forceinline__ float2 smem_pair(const uint8_t* row, int p) {
  if constexpr (KIND == kF32) {
    return *reinterpret_cast<const float2*>(row + 8 * p);
  } else if constexpr (KIND == kBF16) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row + 4 * p));
  } else if constexpr (KIND == kInt8) {
    const char2 c = *reinterpret_cast<const char2*>(row + 2 * p);
    return make_float2((float)c.x, (float)c.y);
  } else {
    const uint8_t b = row[p];
    return make_float2((float)((int)(b & 0xF) - 8), (float)((int)(b >> 4) - 8));
  }
}

// PPL: channel pairs per lane (ceil(D / 64)).
template <typename TQ, int KIND, int PPL>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const TQ* __restrict__ q, const uint8_t* __restrict__ kp, const uint8_t* __restrict__ vp,
    const int* __restrict__ table, const int* __restrict__ start_arr, const int* __restrict__ live_arr,
    const int* __restrict__ cb_arr, const float* __restrict__ ang, const float* __restrict__ kscale,
    const float* __restrict__ vscale, TQ* __restrict__ out, float* __restrict__ ws, int* __restrict__ counters,
    int H, int D, int P, int ps, int window, int r, int S, int kvec, int avec) {
  constexpr bool kQuant = KIND == kInt8 || KIND == kInt4;
  constexpr unsigned kAll = 0xffffffffu;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int sm_page[kMaxPages];
  __shared__ float sm_ks[kMaxPages], sm_vs[kMaxPages];
  __shared__ MergeSmem sm_merge;
  const int h = blockIdx.x;
  const int w = blockIdx.y;
  const int k = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int npairs = D / 2;

  int start = start_arr[w];
  int live = live_arr[w];
  if (cb_arr != nullptr) {  // B4: fold the causal bound (fold_causal_bound)
    const int cut = window - 1 - cb_arr[w];
    start = wrap(start - cut, window);
    live -= cut;
  }
  live = min(max(live, 0), window);

  // the ring walk over the live pages, and this block's share of it
  const int pw = (window + ps - 1) / ps;  // pages that hold window positions
  int a0 = 0, count = 0;
  if (live > 0) {
    const int s0 = wrap(start - live, window);
    const int e = s0 + live;
    a0 = s0 / ps;
    count = e <= window ? (e - 1) / ps - a0 + 1 : min(pw, (pw - a0) + (e - window - 1) / ps + 1);
  }
  const int n_k = max(1, min(S, count));
  if (k >= n_k) return;
  const int j0 = k * count / n_k;
  const int npg = (k + 1) * count / n_k - j0;
  for (int i = threadIdx.x; i < npg; i += kThreads) {
    const int page = table[(size_t)w * P + (a0 + j0 + i) % pw];
    sm_page[i] = page;
    if constexpr (kQuant) {
      sm_ks[i] = kscale[(size_t)page * H + h];
      sm_vs[i] = vscale[(size_t)page * H + h];
    }
  }

  float qf[PPL][2], acc[PPL][2];
#pragma unroll
  for (int t = 0; t < PPL; ++t) {
    const int p = lane + 32 * t;
    float2 x = make_float2(0.f, 0.f);
    if (p < npairs) x = load_q(q + ((size_t)w * H + h) * D + 2 * p);
    qf[t][0] = x.x;
    qf[t][1] = x.y;
    acc[t][0] = acc[t][1] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  __syncthreads();

  // this warp's kStages buffers: kRows key rows, kRows value rows, kRows angle rows
  const int kb = pool_row_bytes(KIND, D), kb_pad = round16(kb), ab = 4 * r, ab_pad = round16(ab);
  const int stage_bytes = kRows * (2 * kb_pad + ab_pad);
  uint8_t* wbuf = smem + (size_t)warp * kStages * stage_bytes;
  const size_t pool_row = (size_t)H * kb;
  const uint8_t* kh = kp + (size_t)h * kb;
  const uint8_t* vh = vp + (size_t)h * kb;
  const uint8_t* arow = reinterpret_cast<const uint8_t*>(ang + (size_t)w * P * ps * r);
  const int rows = npg * ps;  // the split's pages, row by row (rows past the window are never visible)
  const int groups = (rows + kRows - 1) / kRows;
  const int dead_below = window - live;

  // Copy group g's visible rows into buffer st. Returns the mask of visible
  // rows; lane u < kRows keeps row u's page scales in ks_l, vs_l.
  auto issue = [&](int g, int st, float& ks_l, float& vs_l) -> uint32_t {
    bool ok = false;
    int prow = 0, rr = 0;
    if (lane < kRows) {
      const int i = g * kRows + lane;
      if (i < rows) {
        const int j = i / ps, o = i - j * ps;
        rr = ((a0 + j0 + j) % pw) * ps + o;
        ok = rr < window && wrap(rr - start, window) >= dead_below;
        prow = sm_page[j] * ps + o;
        if constexpr (kQuant) {
          ks_l = sm_ks[j];
          vs_l = sm_vs[j];
        }
      }
    }
    const uint32_t mask = __ballot_sync(kAll, ok);
    uint8_t* buf = wbuf + st * stage_bytes;
    const int kn = kb / kvec, an = ab / avec;
    // rolled loops (here and around sincosf below): the kernel's hot loop
    // has to fit the instruction caches
#pragma unroll 1
    for (int u = 0; u < kRows; ++u) {
      const int prow_u = __shfl_sync(kAll, prow, u);
      const int rr_u = __shfl_sync(kAll, rr, u);
      if (!(mask >> u & 1)) continue;
      const uint8_t* ksrc = kh + (size_t)prow_u * pool_row;
      const uint8_t* vsrc = vh + (size_t)prow_u * pool_row;
#pragma unroll 1
      for (int c = lane; c < 2 * kn; c += 32) {
        const bool is_v = c >= kn;
        const int off = (is_v ? c - kn : c) * kvec;
        copy_piece(buf + (is_v ? kRows + u : u) * kb_pad + off, (is_v ? vsrc : ksrc) + off, kvec);
      }
      const uint8_t* asrc = arow + (size_t)rr_u * ab;
      uint8_t* adst = buf + 2 * kRows * kb_pad + u * ab_pad;
#pragma unroll 1
      for (int c = lane; c < an; c += 32) copy_piece(adst + c * avec, asrc + c * avec, avec);
    }
    return mask;
  };

  // Score buffer st's visible rows and fold them into (m, l, acc).
  auto compute = [&](int st, uint32_t mask, float ks_l, float vs_l) {
    const uint8_t* buf = wbuf + st * stage_bytes;
    float s[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) s[u] = 0.f;
#pragma unroll 1
    for (int u = 0; u < kRows; ++u) {
      const float ks = kQuant ? __shfl_sync(kAll, ks_l, u) : 1.f;
      if (!(mask >> u & 1)) continue;  // uniform across the warp
      const uint8_t* krow = buf + u * kb_pad;
      const float* arow_s = reinterpret_cast<const float*>(buf + 2 * kRows * kb_pad + u * ab_pad);
      float su = 0.f;
#pragma unroll
      for (int t = 0; t < PPL; ++t) {
        const int p = lane + 32 * t;
        if (p >= npairs) continue;
        const float2 c = smem_pair<KIND>(krow, p);
        float x0 = c.x * ks, x1 = c.y * ks;  // dequantize before rotating
        if (2 * p < r) {
          // [x0, x1] -> [x0 cos a0 - x1 sin a0, x1 cos a1 + x0 sin a1]
          const float2 a = *reinterpret_cast<const float2*>(arow_s + 2 * p);
          float s0f, c0f, s1f, c1f;
          sincosf(a.x, &s0f, &c0f);
          if (a.y == a.x) {
            s1f = s0f;
            c1f = c0f;
          } else {
            sincosf(a.y, &s1f, &c1f);
          }
          const float y0 = x0 * c0f - x1 * s0f;
          const float y1 = x1 * c1f + x0 * s1f;
          x0 = y0;
          x1 = y1;
        }
        su += qf[t][0] * x0 + qf[t][1] * x1;
      }
#pragma unroll
      for (int v = 0; v < kRows; ++v)
        if (v == u) s[v] = su;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int u = 0; u < kRows; ++u) s[u] += __shfl_xor_sync(kAll, s[u], off);
    }
    if (mask == 0) return;
    float mc = -INFINITY;
#pragma unroll
    for (int u = 0; u < kRows; ++u)
      if (mask >> u & 1) mc = fmaxf(mc, s[u]);
    const float m_new = fmaxf(m, mc);
    const float scale = exp_from(m, m_new);
    float pr[kRows], psum = 0.f;
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      pr[u] = (mask >> u & 1) ? expf(s[u] - m_new) : 0.f;
      psum += pr[u];
    }
    l = l * scale + psum;
#pragma unroll
    for (int t = 0; t < PPL; ++t) {
      acc[t][0] *= scale;
      acc[t][1] *= scale;
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const float vs = kQuant ? __shfl_sync(kAll, vs_l, u) : 1.f;
      if (!(mask >> u & 1)) continue;
      const uint8_t* vrow = buf + (kRows + u) * kb_pad;
#pragma unroll
      for (int t = 0; t < PPL; ++t) {
        const int p = lane + 32 * t;
        if (p >= npairs) continue;
        const float2 c = smem_pair<KIND>(vrow, p);
        acc[t][0] += pr[u] * (c.x * vs);
        acc[t][1] += pr[u] * (c.y * vs);
      }
    }
    m = m_new;
  };

  // masks[s], ks[s], vs[s]: the group s places ahead in this warp's pipeline
  uint32_t masks[kStages];
  float ks[kStages], vs[kStages];
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    const int g = warp + s * kWarps;
    masks[s] = g < groups ? issue(g, s, ks[s], vs[s]) : 0u;
    cp_async_commit();
  }
  for (int it = 0, g = warp; g < groups; ++it, g += kWarps) {
    const int ahead = g + (kStages - 1) * kWarps;
    masks[kStages - 1] = ahead < groups ? issue(ahead, (it + kStages - 1) % kStages, ks[kStages - 1],
                                                vs[kStages - 1]) : 0u;
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // group g has landed (this lane's copies)
    __syncwarp();                  // ... and every lane's
    compute(it % kStages, masks[0], ks[0], vs[0]);
    __syncwarp();  // its buffer is free for the group kStages places on
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      masks[s] = masks[s + 1];
      ks[s] = ks[s + 1];
      vs[s] = vs[s + 1];
    }
  }
  cp_async_wait<0>();

  float M, L, o;
  block_merge<PPL>(m, l, acc, D, sm_merge, M, L, o);
  const int bh = w * H + h;
  TQ* out_row = out + (size_t)bh * D;
  put_state(M, L, o, out_row, ws, bh, S, 1, k, 0, D, n_k);
  if (n_k > 1 && arrive_last(counters + bh, n_k)) merge_splits(ws, bh, S, 1, n_k, D, out_row);
}

struct Args {
  const void *q, *kp, *vp, *table, *start, *live, *cb, *ang, *kscale, *vscale;
  void* out;
  void *ws, *counters;
  int W, H, D, P, ps, window, r, S;
  cudaStream_t stream;
};

template <typename TQ, int KIND, int PPL>
int launch(const Args& a) {
  auto kernel = paged_attention_kernel<TQ, KIND, PPL>;
  const int kb = pool_row_bytes(KIND, a.D);
  const int smem = kWarps * kStages * kRows * (2 * round16(kb) + round16(4 * a.r));
  static int smem_allowed = 0;  // dynamic shared memory this kernel may take so far
  if (smem > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_allowed = smem;
  }
  const int kvec_k = piece_bytes(kb, a.kp), kvec_v = piece_bytes(kb, a.vp);
  const int kvec = kvec_k < kvec_v ? kvec_k : kvec_v;
  const int avec = piece_bytes(4 * a.r, a.ang);
  kernel<<<dim3(a.H, a.W, a.S), kThreads, smem, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const uint8_t*>(a.kp), static_cast<const uint8_t*>(a.vp),
      static_cast<const int*>(a.table), static_cast<const int*>(a.start), static_cast<const int*>(a.live),
      static_cast<const int*>(a.cb), static_cast<const float*>(a.ang), static_cast<const float*>(a.kscale),
      static_cast<const float*>(a.vscale), static_cast<TQ*>(a.out), static_cast<float*>(a.ws),
      static_cast<int*>(a.counters), a.H, a.D, a.P, a.ps, a.window, a.r, a.S, kvec, avec);
  return 0;
}

template <typename TQ, int KIND>
int launch_ppl(const Args& a) {
  const int ppl = (a.D / 2 + 31) / 32;
  if (ppl <= 1) return launch<TQ, KIND, 1>(a);
  if (ppl == 2) return launch<TQ, KIND, 2>(a);
  return launch<TQ, KIND, 4>(a);
}

// q_dtype: 0 = float32, 1 = bfloat16. pool_kind: 0 = float32, 1 = bfloat16
// (both must equal the query dtype), 2 = int8, 3 = int4 (quantized pools need
// scales). S splits per (row, head): at least ceil(pages / kMaxPages), and a
// workspace and counters whenever S > 1.
int dispatch(const Args& a, int pool_kind, int q_dtype) {
  if (a.W < 1 || a.H < 1 || a.D < 2 || a.D > kMaxD || a.D % 2 || a.r % 2 || a.r > a.D || a.P < 1 || a.ps < 1 ||
      a.window < 1 || a.window > a.P * a.ps)
    return (int)cudaErrorInvalidValue;
  const bool quant = pool_kind == kInt8 || pool_kind == kInt4;
  if (quant != (a.kscale != nullptr && a.vscale != nullptr)) return (int)cudaErrorInvalidValue;
  const int pw = (a.window + a.ps - 1) / a.ps;
  if (a.S < 1 || a.S > 65535 || a.S * kMaxPages < pw || (a.S > 1 && (a.ws == nullptr || a.counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  (void)cudaGetLastError();  // clear a stale error so the one returned is this launch's
  int err = (int)cudaErrorInvalidValue;
  if (q_dtype == 0) {
    switch (pool_kind) {
      case kF32: err = launch_ppl<float, kF32>(a); break;
      case kInt8: err = launch_ppl<float, kInt8>(a); break;
      case kInt4: err = launch_ppl<float, kInt4>(a); break;
      default: break;
    }
  } else if (q_dtype == 1) {
    switch (pool_kind) {
      case kBF16: err = launch_ppl<__nv_bfloat16, kBF16>(a); break;
      case kInt8: err = launch_ppl<__nv_bfloat16, kInt8>(a); break;
      case kInt4: err = launch_ppl<__nv_bfloat16, kInt4>(a); break;
      default: break;
    }
  }
  return err != 0 ? err : (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, bound with ctypes; every pointer is checked by the
// Python wrapper. Each returns cudaGetLastError() after its launch. splits,
// ws (float32) and counters (int32, zero) come from the wrapper's
// per-(device, stream) workspace.

// B3: row b reads table row b; visibility from (start, live) alone.
extern "C" int paged_decode_attention(const void* q, const void* kp, const void* vp, const void* table,
                                      const void* start, const void* live, const void* ang, const void* kscale,
                                      const void* vscale, void* out, int W, int H, int D, int P, int ps,
                                      int window, int r, int pool_kind, int q_dtype, int splits, void* ws,
                                      void* counters, void* stream) {
  const Args a{q, kp, vp, table, start, live, nullptr, ang, kscale, vscale, out, ws, counters,
               W, H, D, P, ps, window, r, splits, static_cast<cudaStream_t>(stream)};
  return dispatch(a, pool_kind, q_dtype);
}

// B4: work item w reads its own table row; cb (W,) is each item's causal
// bound (the last visible logical position), folded into (start, live).
extern "C" int ragged_paged_attention(const void* q, const void* kp, const void* vp, const void* table,
                                      const void* start, const void* live, const void* cb, const void* ang,
                                      const void* kscale, const void* vscale, void* out, int W, int H, int D,
                                      int P, int ps, int window, int r, int pool_kind, int q_dtype, int splits,
                                      void* ws, void* counters, void* stream) {
  if (cb == nullptr) return (int)cudaErrorInvalidValue;
  const Args a{q, kp, vp, table, start, live, cb, ang, kscale, vscale, out, ws, counters,
               W, H, D, P, ps, window, r, splits, static_cast<cudaStream_t>(stream)};
  return dispatch(a, pool_kind, q_dtype);
}
