// Cached-decode attention for Hopper (sm_90a): n_q <= 8 queries over a dense,
// left-aligned, UNROTATED key/value cache, with RoPE applied to the keys
// in-stream, the pad/causal/live visibility bound and an online softmax,
// split across blocks (flash-decoding) and merged in the same launch.
//
// Replaces perceiver_io_tpu/ops/decode_kernel.py:fused_decode_attention (the
// Pallas kernel `_kernel`). Same function, same layouts:
//   q    (B, H, n_q, D)  scaled and rotated queries, dtype T
//   k, v (B, cap, H*D)   unrotated keys and values, dtype T
//   ang  (B, cap, r)     float32 rotary angles per slot (pairwise repeated)
//   pad  (B, cap)        uint8/bool, 1 = pad slot
//   qpos (B,) or scalar  absolute position of the LAST query
//   live (B,), scalar or absent: slots below qpos + 1 - live are dead
//   out  (B, H, n_q, D)  dtype T
//   ws, counters         split workspace and per-(row, head) counters
//                        (decode_split.cuh), owned by the Python wrapper
// Query qi sees slot j iff j <= qpos - (n_q-1-qi), pad[j] == 0 and
// j >= qpos + 1 - live. A query that sees no slot gets zeros (the sum of
// weights is clamped at 1e-30, as in the Pallas kernel).
//
// What bounds it on an H100: bytes, in principle. Every slot's key and value
// row is read once per (batch row, head) and used for at most 8 dot
// products, far below the ~295 flop/byte at which the tensor cores would be
// the limit, so the floor is (K + V + angles) / 3.35 TB/s. Measured (PERF.md
// §6) it runs ~4x over that floor at n_q 1: each warp waits for its next
// slots about 8 times a split, and the launch, the dependent loads before
// the first copy and the in-launch merge cost a fixed part; the rotation's
// sincosf and the angle rows (re-read by every head's block) are a smaller
// part. The design streams each row once and keeps nothing in device memory
// between slots but the splits' softmax states.
//
// Design (split-K flash-decoding):
//   * grid (H, B, S): the slots [lo, hi] with lo = max(qpos + 1 - live, 0)
//     and hi = min(qpos, cap - 1) (so dead left-pad slots are never read)
//     are cut into n_k = max(1, min(S, n / min_slots)) contiguous splits
//     of n / n_k slots, at least min_slots each where n allows; blocks
//     k >= n_k return at once. The wrapper picks S from the SM count (about 2
//     blocks an SM) and the capacity (ops/decode_kernel.py:decode_splits).
//     decode_split_rows there mirrors this arithmetic: the CPU tests check
//     the mirror, and a card test holds it against the splits' workspace
//     records (tests/test_torch_cuda.py);
//   * each warp streams its own groups of U slots (group g to warp g mod 8)
//     through kStages shared-memory buffers filled by cp.async 16-byte
//     copies: the next groups' key, value and angle rows load while the
//     current group is scored; a pad slot is never copied;
//   * per group: rotate each slot's key pairs once (sincosf, once per pair
//     when its two angles are equal), dot with every query, run the U x n_q
//     warp-shuffle reductions interleaved, then one online-softmax update per
//     query under its causal bound;
//   * lane l holds channel pairs p = l, l+32, ... (adjacent channels 2p, 2p+1
//     share one rotation, the repo's rotate_half convention);
//   * the warps merge through shared memory, then the splits merge in the
//     same launch (decode_split.cuh): the last block of a (row, head) to
//     finish merges every split's (m, l, acc) in split order, so two runs
//     give the same bits.

#include "decode_split.cuh"

namespace {

// slots a warp scores at once (one buffer of its pipeline): fewer for many
// queries, whose scores and sums take registers
__host__ __device__ constexpr int group_rows(int nq) { return nq >= 8 ? 2 : 4; }
constexpr int kStages = 2;  // buffers a warp cycles through: kStages - 1 groups load while one is scored

// pad flags of a split, staged in shared memory by the block: the most slots
// one split may hold (the C entry rejects splits that could be longer; the
// wrapper's hold at most 512)
constexpr int kPadSlots = 1024;

__device__ __forceinline__ float2 load_pair(const float* p) { return *reinterpret_cast<const float2*>(p); }

__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// PPL: channel pairs per lane (ceil(D / 64)); NQ: query capacity (>= n_q).
// Heads up to 128 wide keep at least 2 blocks an SM for many queries (their
// sums take registers) and 3 for few; wider heads would spill under either.
// At 8 queries and D 128 the bound of 2 spills 20-28 bytes; one slot a group
// (no spill) and one block an SM (no bound) both ran slower on the H100.
template <typename T, int PPL, int NQ>
__global__ void __launch_bounds__(kThreads, PPL >= 4 ? 1 : NQ >= 4 ? 2 : 3) decode_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ ang, const uint8_t* __restrict__ pad,
    const int* __restrict__ qpos_arr, int qpos_scalar,
    const int* __restrict__ live_arr, int live_scalar, int has_live,
    T* __restrict__ out, float* __restrict__ ws, int* __restrict__ counters,
    int H, int n_q, int D, int cap, int r, int S, int min_slots, int kvec, int avec) {
  constexpr int U = group_rows(NQ);
  constexpr unsigned kAll = 0xffffffffu;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ MergeSmem sm_merge;
  __shared__ uint8_t sm_pad[kPadSlots];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int npairs = D / 2;

  const int q_last = qpos_arr ? qpos_arr[b] : qpos_scalar;
  int lo = 0;
  if (has_live) {
    const int lv = live_arr ? live_arr[b] : live_scalar;
    lo = max(q_last + 1 - lv, 0);
  }
  const int hi = min(q_last, cap - 1);
  const int n = max(hi - lo + 1, 0);
  const int n_k = max(1, min(S, n / min_slots));
  if (split >= n_k) return;
  const int j_lo = lo + (int)((long long)split * n / n_k);
  const int j_hi = lo + (int)((long long)(split + 1) * n / n_k);
  const uint8_t* pb = pad + (size_t)b * cap;
  for (int i = threadIdx.x; i < j_hi - j_lo; i += kThreads) sm_pad[i] = pb[j_lo + i];

  float qf[NQ][PPL][2];
  float acc[NQ][PPL][2];
  float m[NQ], l[NQ];
#pragma unroll
  for (int qi = 0; qi < NQ; ++qi) {
    m[qi] = -INFINITY;
    l[qi] = 0.f;
#pragma unroll
    for (int t = 0; t < PPL; ++t) {
      const int p = lane + 32 * t;
      float2 x = make_float2(0.f, 0.f);
      if (qi < n_q && p < npairs) x = load_pair(q + (((size_t)b * H + h) * n_q + qi) * D + 2 * p);
      qf[qi][t][0] = x.x;
      qf[qi][t][1] = x.y;
      acc[qi][t][0] = 0.f;
      acc[qi][t][1] = 0.f;
    }
  }

  // this warp's kStages buffers: U key rows, U value rows, U angle rows
  const int kb = D * (int)sizeof(T), kb_pad = round16(kb), ab = 4 * r, ab_pad = round16(ab);
  const int stage_bytes = U * (2 * kb_pad + ab_pad);
  uint8_t* wbuf = smem + (size_t)warp * kStages * stage_bytes;
  const size_t slot_bytes = (size_t)H * kb;
  const uint8_t* kh = reinterpret_cast<const uint8_t*>(k) + (size_t)b * cap * slot_bytes + (size_t)h * kb;
  const uint8_t* vh = reinterpret_cast<const uint8_t*>(v) + (size_t)b * cap * slot_bytes + (size_t)h * kb;
  const uint8_t* arow = reinterpret_cast<const uint8_t*>(ang + (size_t)b * cap * r);
  const int groups = (j_hi - j_lo + U - 1) / U;
  __syncthreads();  // the staged pad flags

  // Copy group g's slots that are not padding into buffer st; returns their mask.
  auto issue = [&](int g, int st) -> uint32_t {
    bool ok = false;
    if (lane < U) {
      const int j = j_lo + g * U + lane;
      ok = j < j_hi && sm_pad[j - j_lo] == 0;
    }
    const uint32_t mask = __ballot_sync(kAll, ok);
    uint8_t* buf = wbuf + st * stage_bytes;
    const int kn = kb / kvec, an = ab / avec;
    // rolled loops (here and around sincosf below): the kernel's hot loop
    // has to fit the instruction caches
#pragma unroll 1
    for (int u = 0; u < U; ++u) {
      if (!(mask >> u & 1)) continue;
      const size_t j = (size_t)(j_lo + g * U + u);
      const uint8_t* ksrc = kh + j * slot_bytes;
      const uint8_t* vsrc = vh + j * slot_bytes;
#pragma unroll 1
      for (int c = lane; c < 2 * kn; c += 32) {
        const bool is_v = c >= kn;
        const int off = (is_v ? c - kn : c) * kvec;
        copy_piece(buf + (is_v ? U + u : u) * kb_pad + off, (is_v ? vsrc : ksrc) + off, kvec);
      }
      const uint8_t* asrc = arow + j * ab;
      uint8_t* adst = buf + 2 * U * kb_pad + u * ab_pad;
#pragma unroll 1
      for (int c = lane; c < an; c += 32) copy_piece(adst + c * avec, asrc + c * avec, avec);
    }
    return mask;
  };

  // Score buffer st's slots (group g) and fold them into each query's state.
  auto compute = [&](int st, uint32_t mask, int g) {
    if (mask == 0) return;
    const uint8_t* buf = wbuf + st * stage_bytes;
    float s[U][NQ];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int qi = 0; qi < NQ; ++qi) s[u][qi] = 0.f;
    }
#pragma unroll 1
    for (int u = 0; u < U; ++u) {
      if (!(mask >> u & 1)) continue;
      float2 kr[PPL];
#pragma unroll
      for (int t = 0; t < PPL; ++t) {
        const int p = lane + 32 * t;
        kr[t] = make_float2(0.f, 0.f);
        if (p >= npairs) continue;
        kr[t] = load_pair(reinterpret_cast<const T*>(buf + u * kb_pad) + 2 * p);
        if (2 * p < r) {
          // [x0, x1] -> [x0 cos a0 - x1 sin a0, x1 cos a1 + x0 sin a1]
          const float2 a = *reinterpret_cast<const float2*>(buf + 2 * U * kb_pad + u * ab_pad + 8 * p);
          float s0, c0, s1, c1;
          sincosf(a.x, &s0, &c0);
          if (a.y == a.x) {
            s1 = s0;
            c1 = c0;
          } else {
            sincosf(a.y, &s1, &c1);
          }
          const float x0 = kr[t].x, x1 = kr[t].y;
          kr[t].x = x0 * c0 - x1 * s0;
          kr[t].y = x1 * c1 + x0 * s1;
        }
      }
      float sq[NQ];
#pragma unroll
      for (int qi = 0; qi < NQ; ++qi) {
        sq[qi] = 0.f;
#pragma unroll
        for (int t = 0; t < PPL; ++t) sq[qi] += qf[qi][t][0] * kr[t].x + qf[qi][t][1] * kr[t].y;
      }
#pragma unroll
      for (int v = 0; v < U; ++v)
        if (v == u) {
#pragma unroll
          for (int qi = 0; qi < NQ; ++qi) s[v][qi] = sq[qi];
        }
    }
    float2 vv[U][PPL];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int t = 0; t < PPL; ++t) {
        const int p = lane + 32 * t;
        vv[u][t] = make_float2(0.f, 0.f);
        if ((mask >> u & 1) && p < npairs)
          vv[u][t] = load_pair(reinterpret_cast<const T*>(buf + (U + u) * kb_pad) + 2 * p);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int qi = 0; qi < NQ; ++qi) s[u][qi] += __shfl_xor_sync(kAll, s[u][qi], off);
      }
    }
    const int j0 = j_lo + g * U;
#pragma unroll
    for (int qi = 0; qi < NQ; ++qi) {
      if (qi >= n_q) break;
      const int bound = q_last - (n_q - 1 - qi);  // causal bound of query qi
      uint32_t vis = 0;
#pragma unroll
      for (int u = 0; u < U; ++u)
        if ((mask >> u & 1) && j0 + u <= bound) vis |= 1u << u;
      if (vis == 0) continue;
      float mc = -INFINITY;
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (vis >> u & 1) mc = fmaxf(mc, s[u][qi]);
      const float m_new = fmaxf(m[qi], mc);
      const float scale = exp_from(m[qi], m_new);
      float pr[U], psum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        pr[u] = (vis >> u & 1) ? expf(s[u][qi] - m_new) : 0.f;
        psum += pr[u];
      }
      l[qi] = l[qi] * scale + psum;
#pragma unroll
      for (int t = 0; t < PPL; ++t) {
        float a0 = acc[qi][t][0] * scale, a1 = acc[qi][t][1] * scale;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          a0 += pr[u] * vv[u][t].x;
          a1 += pr[u] * vv[u][t].y;
        }
        acc[qi][t][0] = a0;
        acc[qi][t][1] = a1;
      }
      m[qi] = m_new;
    }
  };

  uint32_t masks[kStages];  // masks[s]: the group s places ahead in this warp's pipeline
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    const int g = warp + s * kWarps;
    masks[s] = g < groups ? issue(g, s) : 0u;
    cp_async_commit();
  }
  for (int it = 0, g = warp; g < groups; ++it, g += kWarps) {
    const int ahead = g + (kStages - 1) * kWarps;
    masks[kStages - 1] = ahead < groups ? issue(ahead, (it + kStages - 1) % kStages) : 0u;
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // group g has landed (this lane's copies)
    __syncwarp();                  // ... and every lane's
    compute(it % kStages, masks[0], g);
    __syncwarp();  // its buffer is free for the group kStages places on
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) masks[s] = masks[s + 1];
  }
  cp_async_wait<0>();

  const int bh = b * H + h;
  T* out_row = out + (size_t)bh * n_q * D;
#pragma unroll
  for (int qi = 0; qi < NQ; ++qi) {
    if (qi >= n_q) break;
    float M, L, o;
    block_merge<PPL>(m[qi], l[qi], acc[qi], D, sm_merge, M, L, o);
    put_state(M, L, o, out_row + (size_t)qi * D, ws, bh, S, n_q, split, qi, D, n_k);
  }
  if (n_k > 1 && arrive_last(counters + bh, n_k)) merge_splits(ws, bh, S, n_q, n_k, D, out_row);
}

struct Args {
  const void *q, *k, *v, *ang, *pad, *qpos, *live;
  int qpos_scalar, live_scalar, has_live;
  void *out, *ws, *counters;
  int B, H, n_q, D, cap, r, S, min_slots;
  cudaStream_t stream;
};

template <typename T, int PPL, int NQ>
int launch(const Args& a) {
  auto kernel = decode_attention_kernel<T, PPL, NQ>;
  const int kb = a.D * (int)sizeof(T);
  const int smem = kWarps * kStages * group_rows(NQ) * (2 * round16(kb) + round16(4 * a.r));
  static int smem_allowed = 0;  // dynamic shared memory this kernel may take so far
  if (smem > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_allowed = smem;
  }
  const int kvec_k = piece_bytes(kb, a.k), kvec_v = piece_bytes(kb, a.v);
  const int kvec = kvec_k < kvec_v ? kvec_k : kvec_v;
  const int avec = piece_bytes(4 * a.r, a.ang);
  kernel<<<dim3(a.H, a.B, a.S), kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const float*>(a.ang), static_cast<const uint8_t*>(a.pad), static_cast<const int*>(a.qpos),
      a.qpos_scalar, static_cast<const int*>(a.live), a.live_scalar, a.has_live, static_cast<T*>(a.out),
      static_cast<float*>(a.ws), static_cast<int*>(a.counters), a.H, a.n_q, a.D, a.cap, a.r, a.S, a.min_slots,
      kvec, avec);
  return 0;
}

template <typename T, int PPL>
int launch_nq(const Args& a) {
  if (a.n_q <= 1) return launch<T, PPL, 1>(a);
  if (a.n_q <= 2) return launch<T, PPL, 2>(a);
  if (a.n_q <= 4) return launch<T, PPL, 4>(a);
  return launch<T, PPL, 8>(a);
}

template <typename T>
int launch_ppl(const Args& a) {
  const int ppl = (a.D / 2 + 31) / 32;
  if (ppl <= 1) return launch_nq<T, 1>(a);
  if (ppl == 2) return launch_nq<T, 2>(a);
  return launch_nq<T, 4>(a);
}

}  // namespace

// Plain C entry point, bound with ctypes. dtype: 0 = float32, 1 = bfloat16.
// qpos / live: device pointers to (B,) int32, or null to use the scalar
// (live is ignored unless has_live). splits S per (row, head), at least
// min_slots slots a split where the row has them; ws (float32) and counters
// (int32, zero) come from the wrapper's per-(device, stream) workspace and
// may be null when S == 1. Every pointer is checked by the Python wrapper.
// Returns cudaGetLastError() after the launch.
extern "C" int decode_attention(const void* q, const void* k, const void* v, const void* ang,
                                const void* pad, const void* qpos, int qpos_scalar,
                                const void* live, int live_scalar, int has_live, void* out,
                                int B, int H, int n_q, int D, int cap, int r, int dtype,
                                int splits, int min_slots, void* ws, void* counters, void* stream) {
  if (n_q < 1 || n_q > 8 || D < 2 || D > kMaxD || D % 2 || r % 2 || r > D || B < 1 || H < 1 || cap < 1)
    return (int)cudaErrorInvalidValue;
  if (splits < 1 || splits > 65535 || min_slots < 1 || (splits > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  // The longest split a row can get: n / n_k slots, with n_k = S when the
  // row has S * min_slots slots or more, else n < (n_k + 1) * min_slots. n is
  // at most cap, or exactly known when qpos and live are scalars.
  int span = cap;
  if (qpos == nullptr && (live == nullptr || !has_live)) {
    const int lo = has_live ? (qpos_scalar + 1 - live_scalar > 0 ? qpos_scalar + 1 - live_scalar : 0) : 0;
    const int hi = qpos_scalar < cap - 1 ? qpos_scalar : cap - 1;
    span = hi - lo + 1 > 0 ? hi - lo + 1 : 0;
  }
  if ((span + splits - 1) / splits > kPadSlots || 2 * min_slots - 1 > kPadSlots) return (int)cudaErrorInvalidValue;
  (void)cudaGetLastError();  // clear a stale error so the one returned is this launch's
  const Args a{q, k, v, ang, pad, qpos, live, qpos_scalar, live_scalar, has_live, out, ws, counters,
               B, H, n_q, D, cap, r, splits, min_slots, static_cast<cudaStream_t>(stream)};
  int err = (int)cudaErrorInvalidValue;
  if (dtype == 0) err = launch_ppl<float>(a);
  else if (dtype == 1) err = launch_ppl<__nv_bfloat16>(a);
  return err != 0 ? err : (int)cudaGetLastError();
}
