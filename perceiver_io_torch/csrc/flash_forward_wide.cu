// Flash attention forward in bfloat16 on Hopper (sm_90a) for wide heads:
// D = 192, 256, ..., 512 (every multiple of 64 above 128). Kernel B1a for
// bf16 inputs at those widths (and B5 with it); heads of 64 and 128 channels
// take flash_forward_mma.cu, float32 inputs flash_forward_f32.cu.
//
// Replaces the forward of perceiver_io_tpu/ops/flash.py:splash_mha (the Pallas
// splash kernel built by `_build_kernel` via `make_splash_mha`) at the head
// widths the TPU's splash takes and flash_forward_mma.cu does not: splash
// admits every D % 64 == 0, with no upper limit, because VMEM holds many
// megabytes. The shape that needs it is the Perceiver IO optical-flow
// decoder's single 512-channel head, 182,528 pixel queries over 2,048
// latents, full mask (perceiver_io_tpu/models/vision/optical_flow/backend.py:
// official_41m_config). Function and layouts:
//   q     (B, H, Nq, D)  bfloat16, already scaled and rotated queries
//   k, v  (B, H, Nk, D)  bfloat16 keys and values
//   pad   (B, Nk)        uint8, 1 = padding key (the splash segment id 0), or null
//   o     (B, H, Nq, D)  bfloat16 with P in one term (a forward whose output is
//                        only cast, as splash writes q's dtype), float32 with P
//                        in two (split_p: B1b's delta and the ring's merge read it)
//   lse   (B, H, Nq)     float32 natural log-sum-exp of each query's visible scores
// Causal is right-aligned (query i sees key j iff j <= Nk - Nq + i); a query
// that sees no key gets exact zeros and lse = -inf; Nq and Nk are any sizes.
//
// What bounds it on an H100: 4 D flops a visible (query, key) pair against
// O(D) bytes a row read once; at the flow decoder's shape (6 patches) that is
// 4.6e12 flops against 3.4 GB, so the tensor cores' rate sets the floor
// (4.6 ms at 989 TFLOP/s). Second comes the L2: every 64-query block reads
// its head's whole K and V, 4 MB at Nk = 2,048 and D = 512; a cluster of two
// blocks reads it once for 128 queries (36 GB from L2 at 6 patches).
//
// The design, against the six limits of the mma.sync kernel it replaces
// (Q re-read by ldmatrix at every k-step, S computed twice, 255 registers
// with spills, a cp.async double buffer issued by every thread, K and V
// streamed from L2 once per 64 queries, a float32 output that was only cast):
//   * warp specialisation (limit 4): 384 threads as three warpgroups. The
//     producer warpgroup lowers its registers to kProducerRegs by setmaxnreg
//     and one of its threads issues every TMA load; the two consumer
//     warpgroups raise theirs to kConsumerRegs. A block owns 64 query rows of
//     one (batch, head): both consumers hold all 64 rows, consumer c the
//     output columns of its 64-channel boxes (o_boxes);
//   * TMA into a ring of stages (limits 1, 4): Q is loaded once a block, K
//     and V in key tiles through full and empty mbarriers; TMA's 128-byte
//     swizzle caps a box at 64 channels, so a row of D channels is D / 64
//     boxes, each (rows, 64) box at a multiple of 1024 bytes; rows past Nq or
//     Nk are zero-filled by TMA (3-d tensor maps over (B H, N, D)) and masked;
//   * S on wgmma, computed once (limits 1, 2): S = Q K^T is wgmma m64nKBk16
//     with both operands in shared memory; the contraction over D is split by
//     whole boxes (s_boxes), each consumer writes its float32 partial S to
//     shared memory and, after a named barrier between the two, adds the
//     other's to its own: float addition commutes, so both hold the same bits
//     of S and run the same online softmax with no exchange of P, max or sum.
//     4 D executed flops a pair (6 D with two-term P), not 6 D (8 D);
//   * P V on wgmma with P from registers (limits 1, 3): O[:, own columns] +=
//     P V[:, own columns], P as the A operand in registers (one bf16 term, or
//     hi and lo with kSplitP), V's tile MN-major in shared memory (the
//     descriptor's transpose bit); a consumer holds at most 64 x 256 float32
//     of O (128 registers a thread) and ptxas spills nothing. Each consumer
//     issues S(t + 1) before P(t) V(t), so that the S exchange and softmax
//     of one tile run while the tensor cores multiply the other's P V;
//   * a cluster of two blocks (limit 5): neighbouring query tiles of one
//     (batch, head); each block loads half of every K and V tile (kBK / 2
//     rows of every box) and multicasts it to both, so a K/V byte leaves L2
//     once per 128 queries. The pair streams keys up to the larger of its
//     two causal bounds; a block skips the tiles past its own and masks the
//     rest. When the query-tile count is odd the grid is padded to whole
//     clusters: the spare block issues its half of every load and every
//     barrier arrival and writes nothing. An empty barrier counts the
//     consumer warps of both blocks, so no stage is refilled until both have
//     read it, and each producer waits for its last stages' release before
//     it exits, so no remote write or arrival reaches a finished block;
//   * a bf16 output for inference (limit 6): without kSplitP the kernel
//     writes o in bf16 (the caller only casts it); with it o stays float32.
//     lse is float32 both ways.
// Uneven splits (D 192, 320, 448: an odd number of boxes) stay on whole
// boxes, because an MN-major SWIZZLE_128B operand starts at a box: consumer 0
// takes the larger half of the output's columns (wgmma N = 128, 192, 256)
// and the smaller half of S's contraction, consumer 1 the reverse, so both
// do the same work per tile with one-term P. No atomics: the S exchange adds
// in a fixed order and two runs give the same bits.
//
// Tiles and shared memory per width (smem_bytes: 1024 bytes of alignment
// slack + Q + stages x (K + V) + the S exchange, double-buffered + mbarriers):
//   D 192: 64-key tiles, 2 stages, 189,512 bytes
//   D 256: 64-key tiles, 2 stages, 230,472 bytes
//   D 320: 32-key tiles, 3 stages, 197,736 bytes
//   D 384: 32-key tiles, 3 stages, 230,504 bytes
//   D 448: 32-key tiles, 2 stages, 205,896 bytes
//   D 512: 32-key tiles, 2 stages, 230,472 bytes
// (of the 232,448 a block may have).

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBQ = 64;             // query rows a block (one wgmma M)
constexpr int kThreads = 3 * 128;   // the producer warpgroup, then the two consumers
constexpr int kProducerRegs = 40;   // setmaxnreg: 128 x 40 + 256 x 232 <= 65,536
constexpr int kConsumerRegs = 232;
constexpr int kClusterBlocks = 2;
constexpr int kExchangeBarrier = 1;  // named barrier between the two consumer warpgroups
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
__host__ __device__ constexpr int key_tile() {  // keys a tile
  return D <= 256 ? 64 : 32;
}

template <int D>
__host__ __device__ constexpr int stages() {  // K/V stages in the ring
  return D <= 256 ? 2 : D <= 384 ? 3 : 2;
}

// 64-channel boxes of consumer c: of the output's columns (consumer 0 the
// larger half, from box 0) and of S's contraction (consumer 0 the smaller
// half, from box 0); consumer 1 takes the boxes after consumer 0's.
template <int D>
__host__ __device__ constexpr int o_boxes(int c) {
  return c == 0 ? (D / 64 + 1) / 2 : D / 64 / 2;
}
template <int D>
__host__ __device__ constexpr int s_boxes(int c) {
  return c == 0 ? D / 64 / 2 : (D / 64 + 1) / 2;
}

template <int D>
__host__ __device__ constexpr size_t smem_bytes() {
  return 1024 + sizeof(bf16) * kBQ * D + stages<D>() * 2 * sizeof(bf16) * key_tile<D>() * D +
         2 * 2 * sizeof(float) * kBQ * key_tile<D>() + sizeof(uint64_t) * (1 + 4 * stages<D>());
}

// The block's view of its shared memory and of the problem.
template <int D>
struct Tiles {
  bf16* q;          // D / 64 boxes of (kBQ, 64)
  bf16* k;          // stages x D / 64 boxes of (kBK, 64)
  bf16* v;          // the same
  float* exchange;  // [2 buffers][2 consumers][kBK / 8][128 threads][4]
  uint64_t* q_full;
  uint64_t* k_full;   // [stages]
  uint64_t* v_full;   // [stages]
  uint64_t* k_empty;  // [stages]
  uint64_t* v_empty;  // [stages]
};

template <int D>
__device__ __forceinline__ Tiles<D> carve(unsigned char* raw) {
  constexpr int kBK = key_tile<D>(), kStages = stages<D>();
  unsigned char* base = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);  // the same offset in both blocks
  Tiles<D> t;
  t.q = reinterpret_cast<bf16*>(base);
  t.k = t.q + kBQ * D;
  t.v = t.k + kStages * kBK * D;
  t.exchange = reinterpret_cast<float*>(t.v + kStages * kBK * D);
  t.q_full = reinterpret_cast<uint64_t*>(t.exchange + 2 * 2 * kBQ * kBK);
  t.k_full = t.q_full + 1;
  t.v_full = t.k_full + kStages;
  t.k_empty = t.v_full + kStages;
  t.v_empty = t.k_empty + kStages;
  return t;
}

struct Problem {
  int bh, q0, Nq, Nk, causal;
  int n_tiles;    // key tiles the pair streams
  int blk_keys;   // keys past which no row of this block sees anything
  bool active;    // the block has query rows (not the spare block of an odd count)
};

// ------------------------------------------------------------ producer
// K runs a tile ahead of V: K(t + 1) is loaded before V(t), because the
// consumers multiply S(t + 1) = Q K(t + 1)^T while P(t) V(t) runs. K and V
// stages are released apart (K once S has read it, V once P V has), each
// by every consumer warp of both blocks.
template <int D>
__device__ __forceinline__ void produce(const Tiles<D>& sm, const Problem& pb, const CUtensorMap* tm_q,
                                        const CUtensorMap* tm_k, const CUtensorMap* tm_v) {
  constexpr int kBK = key_tile<D>(), kStages = stages<D>(), kHalf = kBK / 2;
  const int rank = (int)cluster_rank();
  // this block's half (kHalf rows of every box) of tile t of one tensor, multicast to both blocks
  auto load = [&](const CUtensorMap* map, bf16* ring, uint64_t* full, uint64_t* empty, int t) {
    const int st = t % kStages;
    mbar_wait_cluster(empty + st, ((t / kStages) & 1) ^ 1);  // the stage's last use is released
    mbar_arrive_expect_tx(full + st, sizeof(bf16) * kBK * D);  // both halves land here
#pragma unroll
    for (int b = 0; b < D / 64; ++b)
      tma_load_3d_multicast(ring + (st * D / 64 + b) * kBK * 64 + rank * kHalf * 64, map, full + st, 0x3, 64 * b,
                            t * kBK + rank * kHalf, pb.bh);
  };
  if (pb.n_tiles == 0) return;
  if (pb.active) {
    mbar_arrive_expect_tx(sm.q_full, sizeof(bf16) * kBQ * D);
#pragma unroll
    for (int b = 0; b < D / 64; ++b) tma_load_3d(sm.q + b * kBQ * 64, tm_q, sm.q_full, 64 * b, pb.q0, pb.bh);
  }
  load(tm_k, sm.k, sm.k_full, sm.k_empty, 0);
  for (int t = 0; t < pb.n_tiles; ++t) {
    if (t + 1 < pb.n_tiles) load(tm_k, sm.k, sm.k_full, sm.k_empty, t + 1);
    load(tm_v, sm.v, sm.v_full, sm.v_empty, t);
  }
  // stay until every stage's last use is released: then no consumer of the
  // other block arrives here, and no multicast writes here, after this block ends
  for (int st = 0; st < kStages && st < pb.n_tiles; ++st) {
    const int uses = (pb.n_tiles - st + kStages - 1) / kStages;
    mbar_wait_cluster(sm.k_empty + st, (uses & 1) ^ 1);
    mbar_wait_cluster(sm.v_empty + st, (uses & 1) ^ 1);
  }
}

// ------------------------------------------------------------ consumers
// Releases a stage in both blocks of the cluster: one arrival a warp (after
// its wgmma wait) on the empty barrier at the same offset in each block.
__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < kClusterBlocks; ++r) mbar_arrive_cluster(empty, r);
  }
}

// Zeroes s for a partial S (before the wgmma fence that precedes issue_scores).
template <int R>
__device__ __forceinline__ void zero_scores(float (&s)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) s[i] = 0.f;
  fence_regs(s);
}

// Issues consumer C's partial S = Q K^T of the tile in stage st over its
// channel boxes into s (zeroed, after a wgmma fence), as one commit group.
template <int D, int C>
__device__ __forceinline__ void issue_scores(const Tiles<D>& sm, int st, float (&s)[key_tile<D>() / 2]) {
  constexpr int kBK = key_tile<D>();
  constexpr int kSB = s_boxes<D>(C), kSB0 = C == 0 ? 0 : s_boxes<D>(0);
#pragma unroll
  for (int b = kSB0; b < kSB0 + kSB; ++b) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Wgmma<kBK>::ss(s, wgmma_desc(sm.q + b * kBQ * 64 + kk * 16, 16, 1024),
                     wgmma_desc(sm.k + (st * D / 64 + b) * kBK * 64 + kk * 16, 16, 1024));
  }
  wgmma_commit();
}

// A thread's rows (row0 and row0 + 8) in consumer C's online softmax, and
// P of one tile as the P V product's A-fragments (hi, and lo with kSplitP).
struct RowStats {
  float m[2] = {-INFINITY, -INFINITY};  // running max (natural units)
  float l[2] = {0.f, 0.f};              // this thread's part of the running sums
  float alpha[2] = {1.f, 1.f};          // the factor O's rows take before the tile's P V
};
template <int D, bool kSplitP>
struct PTile {
  uint32_t hi[key_tile<D>() / 16][4];
  uint32_t lo[kSplitP ? key_tile<D>() / 16 : 1][4];
};

// Tile t's scores, once this consumer's partial s has completed: adds the
// other consumer's partial (through shared memory, after a named barrier
// between the two), masks, and runs the online softmax: s becomes the
// tile's float32 P, and rows takes its alpha, m and l. Both consumers'
// fragments hold the same (row, key) pairs a thread, and both add the same
// two float32 partials, so both get the same bits. The exchange buffers
// alternate by tile: a consumer writes buffer t % 2 again only at tile t +
// 2, past the barrier of tile t + 1, which the other consumer reaches only
// once it has read tile t's.
template <int D, int C>
__device__ __forceinline__ void softmax_tile(const Tiles<D>& sm, const Problem& pb, const uint8_t* __restrict__ pad_row,
                                             int t, float (&s)[key_tile<D>() / 2], RowStats& rows, int tid,
                                             int warp, int t4, int lim) {
  constexpr int kBK = key_tile<D>();
  const int k0 = t * kBK;
  float* mine = sm.exchange + ((t & 1) * 2 + C) * kBQ * kBK;
  const float* theirs = sm.exchange + ((t & 1) * 2 + (1 - C)) * kBQ * kBK;
#pragma unroll
  for (int i = 0; i < kBK / 8; ++i)
    *reinterpret_cast<float4*>(mine + (i * 128 + tid) * 4) = make_float4(s[4 * i], s[4 * i + 1], s[4 * i + 2],
                                                                         s[4 * i + 3]);
  named_sync(kExchangeBarrier, 256);
#pragma unroll
  for (int i = 0; i < kBK / 8; ++i) {
    const float4 x = *reinterpret_cast<const float4*>(theirs + (i * 128 + tid) * 4);
    s[4 * i] += x.x;
    s[4 * i + 1] += x.y;
    s[4 * i + 2] += x.z;
    s[4 * i + 3] += x.w;
  }

  // mask: a tile with a key past Nk or a pad flag, or one that straddles the warp's diagonal
  const int off = pb.Nk - pb.Nq;
  if (k0 + kBK > pb.Nk || pad_row || (pb.causal && k0 + kBK - 1 > off + pb.q0 + 16 * warp)) {
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * j + 2 * t4 + e;
        const bool ok = key < pb.Nk && !(pad_row && pad_row[key]);
        if (!ok || (pb.causal && key > lim)) s[4 * j + e] = -INFINITY;
        if (!ok || (pb.causal && key > lim + 8)) s[4 * j + 2 + e] = -INFINITY;
      }
    }
  }

  // online softmax: rows row0 (entries 4 j, 4 j + 1) and row0 + 8 (4 j + 2, 4 j + 3)
  float mx[2] = {rows.m[0], rows.m[1]};
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  float shift[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_use = mx[r] == -INFINITY ? 0.f : mx[r];  // no visible key yet: keep exp2 off inf - inf
    rows.alpha[r] = exp2f((rows.m[r] - m_use) * kLog2e);
    shift[r] = m_use * kLog2e;
    rows.m[r] = mx[r];
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[4 * j + e] = exp2f(fmaf(s[4 * j + e], kLog2e, -shift[e / 2]));  // exp2(-inf) = 0
    rs[0] += s[4 * j] + s[4 * j + 1];
    rs[1] += s[4 * j + 2] + s[4 * j + 3];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) rows.l[r] = rows.l[r] * rows.alpha[r] + rs[r];
}

// The float32 P of a tile (softmax_tile's s) as the P V product's A-fragments:
// rounded to bf16, and with kSplitP its remainder as a second bf16 term.
template <int D, bool kSplitP>
__device__ __forceinline__ void pack_p(const float (&s)[key_tile<D>() / 2], PTile<D, kSplitP>& p) {
#pragma unroll
  for (int j = 0; j < key_tile<D>() / 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float x = s[4 * j + 2 * r], y = s[4 * j + 2 * r + 1];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(x, y);
      p.hi[j / 2][(j & 1) * 2 + r] = pack_bf16(hi);
      if constexpr (kSplitP) {
        const float2 h = __bfloat1622float2(hi);
        p.lo[j / 2][(j & 1) * 2 + r] = pack_bf16(__floats2bfloat162_rn(x - h.x, y - h.y));
      }
    }
  }
}

// Consumer C: tiles [0, n_mine) in a software pipeline, S(t + 1) issued to
// the tensor cores before P(t) V(t), so that O's rescale runs while S(t + 1)
// does and the exchange and softmax of tile t + 1 while P(t) V(t) does; P(t
// + 1) is packed into A-fragments only once P(t) V(t) has finished (ptxas
// serialises every wgmma of a kernel in which another instruction writes the
// input registers of a wgmma still in flight, or issues a wgmma in a branch
// of its own). Then the tiles past this block's causal bound (all of them in
// the spare block) are only waited for and released; then the epilogue.
template <int D, bool kSplitP, int C>
__device__ __forceinline__ void consume(const Tiles<D>& sm, const Problem& pb, const uint8_t* __restrict__ pad_row,
                                        std::conditional_t<kSplitP, float, bf16>* __restrict__ o,
                                        float* __restrict__ lse) {
  constexpr int kBK = key_tile<D>(), kStages = stages<D>();
  constexpr int kOB = o_boxes<D>(C), kOB0 = C == 0 ? 0 : o_boxes<D>(0);
  constexpr int kON = 64 * kOB;  // output columns this consumer owns
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int row0 = 16 * warp + g;  // this thread's rows row0 and row0 + 8 of the tile
  const int lim = pb.Nk - pb.Nq + pb.q0 + row0;  // the last key row0 sees (causal); row0 + 8: lim + 8
  // tiles with a key some row of this block sees: a prefix of the pair's
  const int n_mine = pb.active ? min(pb.n_tiles, (pb.blk_keys + kBK - 1) / kBK) : 0;

  float acc[kON / 2];
#pragma unroll
  for (int i = 0; i < kON / 2; ++i) acc[i] = 0.f;
  RowStats rows;
  PTile<D, kSplitP> p;  // P of the tile whose P V is next
  if (n_mine > 0) {  // the prologue: S(0) and its softmax
    float s[kBK / 2];
    mbar_wait(sm.q_full, 0);
    mbar_wait(sm.k_full, 0);
    zero_scores(s);
    wgmma_fence();
    issue_scores<D, C>(sm, 0, s);
    wgmma_wait<0>();
    fence_regs(s);
    release(sm.k_empty, lane);
    softmax_tile<D, C>(sm, pb, pad_row, 0, s, rows, tid, warp, t4, lim);
    pack_p(s, p);
  }
  // one tile, with (kNext) or without the next tile's S; the last tile is
  // peeled off so that no wgmma sits in a branch (ptxas serialises those)
  auto step = [&](int t, auto next_tag) {
    constexpr bool kNext = decltype(next_tag)::value;
    const int st = t % kStages, st1 = (t + 1) % kStages;
    float s[kBK / 2];
    if constexpr (kNext) mbar_wait(sm.k_full + st1, ((t + 1) / kStages) & 1);
    mbar_wait(sm.v_full + st, (t / kStages) & 1);
    if constexpr (kNext) {
      zero_scores(s);
      wgmma_fence();
      issue_scores<D, C>(sm, st1, s);
    }
    // O's rows take this tile's factors (none to take where every factor is exactly 1)
    if (__any_sync(0xffffffffu, rows.alpha[0] != 1.f || rows.alpha[1] != 1.f)) {
#pragma unroll
      for (int j = 0; j < kON / 8; ++j) {
        acc[4 * j] *= rows.alpha[0];
        acc[4 * j + 1] *= rows.alpha[0];
        acc[4 * j + 2] *= rows.alpha[1];
        acc[4 * j + 3] *= rows.alpha[1];
      }
    }
    fence_regs(acc);
    wgmma_fence();
    // O[:, own columns] += P V[:, own columns]
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t dv = wgmma_desc(sm.v + (st * D / 64 + kOB0) * kBK * 64 + kk * 16 * 64, kBK * 128, 1024);
      Wgmma<kON>::rs(acc, p.hi[kk], dv);
      if constexpr (kSplitP) Wgmma<kON>::rs(acc, p.lo[kk], dv);
    }
    wgmma_commit();
    if constexpr (kNext) {  // tile t + 1's softmax while P(t) V(t) runs; P(t) is replaced once it has
      wgmma_wait<1>();
      fence_regs(s);
      release(sm.k_empty + st1, lane);
      softmax_tile<D, C>(sm, pb, pad_row, t + 1, s, rows, tid, warp, t4, lim);
      wgmma_wait<0>();
      fence_regs(acc);
      pack_p(s, p);
    } else {
      wgmma_wait<0>();
      fence_regs(acc);
    }
    release(sm.v_empty + st, lane);
  };
  for (int t = 0; t + 1 < n_mine; ++t) step(t, std::true_type{});
  if (n_mine > 0) step(n_mine - 1, std::false_type{});
  for (int t = n_mine; t < pb.n_tiles; ++t) {
    const int st = t % kStages;
    const uint32_t parity = (t / kStages) & 1;
    mbar_wait(sm.k_full + st, parity);
    release(sm.k_empty + st, lane);
    mbar_wait(sm.v_full + st, parity);
    release(sm.v_empty + st, lane);
  }

  // epilogue: o = acc / l over this consumer's columns, lse = m + log l
  // (consumer 0); rows that saw no key get zeros and -inf
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = rows.l[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = pb.q0 + row0 + 8 * r;
    if (!pb.active || row >= pb.Nq) continue;
    const float inv = l > 0.f ? 1.f / l : 0.f;
    const size_t at = ((size_t)pb.bh * pb.Nq + row) * D + kOB0 * 64 + 2 * t4;
#pragma unroll
    for (int j = 0; j < kON / 8; ++j) {
      const float x = acc[4 * j + 2 * r] * inv, y = acc[4 * j + 2 * r + 1] * inv;
      if constexpr (kSplitP)
        *reinterpret_cast<float2*>(o + at + 8 * j) = make_float2(x, y);
      else
        *reinterpret_cast<__nv_bfloat162*>(o + at + 8 * j) = __floats2bfloat162_rn(x, y);
    }
    if (C == 0 && t4 == 0) lse[(size_t)pb.bh * pb.Nq + row] = l > 0.f ? rows.m[r] + logf(l) : -INFINITY;
  }
}

// ----------------------------------------------------------------- kernel
template <int D, bool kSplitP>
__global__ void __cluster_dims__(kClusterBlocks, 1, 1) __launch_bounds__(kThreads, 1)
    flash_fwd_wide_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v, const uint8_t* __restrict__ pad,
                          std::conditional_t<kSplitP, float, bf16>* __restrict__ o, float* __restrict__ lse, int H,
                          int Nq, int Nk, int causal) {
  constexpr int kBK = key_tile<D>(), kStages = stages<D>();
  static_assert(D % 64 == 0 && D >= 192 && D <= 512, "D must be a multiple of 64 in 192..512");
  static_assert(smem_bytes<D>() <= 232448, "the tiles must fit in 227 KB of shared memory");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Tiles<D> sm = carve<D>(smem_raw);

  Problem pb;
  pb.bh = blockIdx.y;
  // heaviest causal tiles first; the two blocks of a cluster take tiles 2p and 2p + 1
  const int tile = causal ? (int)(gridDim.x - 1 - blockIdx.x) : (int)blockIdx.x;
  const int pair0 = (tile & ~1) * kBQ;  // the pair's first query row (always < Nq)
  pb.q0 = tile * kBQ;
  pb.Nq = Nq;
  pb.Nk = Nk;
  pb.causal = causal;
  pb.active = pb.q0 < Nq;
  const int off = Nk - Nq;
  const int pair_keys = causal ? min(Nk, max(0, off + min(Nq, pair0 + 2 * kBQ))) : Nk;
  pb.blk_keys = causal ? min(Nk, max(0, off + min(Nq, pb.q0 + kBQ))) : Nk;
  pb.n_tiles = (pair_keys + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    mbar_init(sm.q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(sm.k_full + st, 1);  // the producer's arrival; bytes from both blocks
      mbar_init(sm.v_full + st, 1);
      mbar_init(sm.k_empty + st, 2 * 4 * kClusterBlocks);  // every consumer warp of both blocks
      mbar_init(sm.v_empty + st, 2 * 4 * kClusterBlocks);
    }
    mbar_init_fence();
  }
  cluster_sync();  // the barriers of both blocks exist before any load or remote arrival

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      tma_prefetch(&tm_q);
      tma_prefetch(&tm_k);
      tma_prefetch(&tm_v);
      produce<D>(sm, pb, &tm_q, &tm_k, &tm_v);
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const uint8_t* pad_row = pad ? pad + (size_t)(pb.bh / H) * Nk : nullptr;
    if (wg == 1)
      consume<D, kSplitP, 0>(sm, pb, pad_row, o, lse);
    else
      consume<D, kSplitP, 1>(sm, pb, pad_row, o, lse);
  }
}

// --------------------------------------------------------------- launch
template <int D, bool kSplitP>
int forward(const void* q, const void* k, const void* v, const void* pad, void* o, void* lse, int B, int H, int Nq,
            int Nk, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = flash_fwd_wide_kernel<D, kSplitP>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tm_q, tm_k, tm_v;
  const uint64_t bh = (uint64_t)B * H;
  if (!bf16_rows_map(&tm_q, q, bh, Nq, D, kBQ) || !bf16_rows_map(&tm_k, k, bh, Nk, D, key_tile<D>() / 2) ||
      !bf16_rows_map(&tm_v, v, bh, Nk, D, key_tile<D>() / 2))
    return (int)cudaErrorNotSupported;  // the driver refused a tensor map
  const int tiles = (Nq + kBQ - 1) / kBQ;
  const dim3 grid(kClusterBlocks * ((tiles + kClusterBlocks - 1) / kClusterBlocks), B * H);
  kernel<<<grid, kThreads, smem, stream>>>(tm_q, tm_k, tm_v, static_cast<const uint8_t*>(pad),
                                           static_cast<std::conditional_t<kSplitP, float, bf16>*>(o),
                                           static_cast<float*>(lse), H, Nq, Nk, causal);
  return (int)cudaGetLastError();
}

template <int D>
int forward_width(const void* q, const void* k, const void* v, const void* pad, void* o, void* lse, int B, int H,
                  int Nq, int Nk, int causal, int split_p, cudaStream_t s) {
  return split_p ? forward<D, true>(q, k, v, pad, o, lse, B, H, Nq, Nk, causal, s)
                 : forward<D, false>(q, k, v, pad, o, lse, B, H, Nq, Nk, causal, s);
}

}  // namespace

// Plain C entry point, bound with ctypes. q, k, v bfloat16 (16-byte aligned,
// contiguous); lse float32; split_p = 0: P as one bf16 term and o bfloat16
// (a forward whose output is only cast); split_p = 1: P as two bf16 terms
// and o float32 (B5, or a B1a whose output will be differentiated). D: 192,
// 256, 320, 384, 448 or 512; pad: (B, Nk) uint8 or null. The Python wrapper
// checks every pointer, shape and type and allocates the outputs. Returns
// cudaGetLastError() after the launch (0 = launched), cudaErrorNotSupported
// if the driver refused a tensor map.
extern "C" int flash_forward_wide(const void* q, const void* k, const void* v, const void* pad, void* o,
                                  void* lse, int B, int H, int Nq, int Nk, int D, int causal, int split_p,
                                  void* stream) {
  if (B < 1 || H < 1 || Nq < 1 || Nk < 1 || (long long)B * H > 65535) return (int)cudaErrorInvalidValue;
  (void)cudaGetLastError();  // clear a stale error so the one returned is this launch's
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 192: return forward_width<192>(q, k, v, pad, o, lse, B, H, Nq, Nk, causal, split_p, s);
    case 256: return forward_width<256>(q, k, v, pad, o, lse, B, H, Nq, Nk, causal, split_p, s);
    case 320: return forward_width<320>(q, k, v, pad, o, lse, B, H, Nq, Nk, causal, split_p, s);
    case 384: return forward_width<384>(q, k, v, pad, o, lse, B, H, Nq, Nk, causal, split_p, s);
    case 448: return forward_width<448>(q, k, v, pad, o, lse, B, H, Nq, Nk, causal, split_p, s);
    case 512: return forward_width<512>(q, k, v, pad, o, lse, B, H, Nq, Nk, causal, split_p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
