// Flash attention backward in bfloat16 on Hopper (sm_90a) for wide heads:
// D = 192, 256, ..., 512 (every multiple of 64 above 128). Kernel B1b for
// bf16 inputs at those widths; heads of 64 and 128 channels take
// flash_backward_mma.cu, float32 inputs flash_backward_f32.cu.
//
// Replaces the backward of perceiver_io_tpu/ops/flash.py:splash_mha (the
// custom VJP of the Pallas splash kernel, which runs a dK/dV kernel and a dQ
// kernel) at the head widths the TPU's splash takes and flash_backward_mma.cu
// does not. The shape that needs it is the training step of the Perceiver IO
// optical-flow decoder: one 512-channel head, 182,528 pixel queries over
// 2,048 latents a patch, full mask (perceiver_io_tpu/models/vision/
// optical_flow/backend.py:official_41m_config). Same function as
// flash_backward_mma.cu; layouts:
//   q      (B, H, Nq, D)  bfloat16, already scaled and rotated queries
//   k, v   (B, H, Nk, D)  bfloat16 keys and values
//   pad    (B, Nk)        uint8, 1 = padding key (the splash segment id 0), or null
//   o      (B, H, Nq, D)  float32 forward output (the delta reads it unrounded)
//   lse    (B, H, Nq)     float32 natural log-sum-exp the forward wrote
//   dout   (B, H, Nq, D)  bfloat16 gradient of the output
//   delta  (B, H, Nq)     float32 scratch
//   ws     2 x (B*H, S, Nk, D) float32 scratch: each query split's partial dK, then dV
//   ds     2 x (B*H, Nk, Nq64) bfloat16 scratch: dS^T's hi, then lo term (Nq64: Nq
//          rounded up to a multiple of 64), written by the dK/dV pass, read by the dQ pass
//   dq, dk, dv            bfloat16, the shapes of q, k, v
// Causal is right-aligned: query i sees key j iff j <= Nk - Nq + i. A query
// whose lse is -inf (it sees no key) gets zero gradients, never NaN; pad keys
// get exact-zero dK and dV. Nq and Nk are any sizes.
//
// What bounds it on an H100. Counted: 10 D flops a visible (query, key) pair
// (S, dP, dV, dK, dQ), 1.9e12 a patch at the flow decoder (1.94 ms on the
// bf16 tensor cores) against 0.94 GB moved once (0.28 ms): the operations.
// Executed: P and dS enter their products as two bf16 terms (kTerms; one
// term fails B1's bf16 limit at D 512): 12 D a pair in the dK/dV pass (S,
// dP, 2 x dV, 2 x dK) and 4 D in the dQ pass (2 x dQ), 16 D in all (6.19 ms
// at the flow decoder's 2 patches; the mma.sync kernel, which recomputed S
// and dP in its dQ pass, executed 20 D, 7.74 ms). Bytes: the dK/dV pass
// streams its split's Q and dO through L2 once per cluster of 2 x 32 keys
// (~24 GB at 2 patches), the dQ pass the head's K once per cluster of 2 x
// 64 queries (~6 GB); the dS scratch adds 4 bytes a pair written and read
// once through HBM (3.0 GB each way at 2 patches).
//
// The design, one limit of the mma.sync kernel it replaces at a time:
//   * wgmma for every product (limit: mma.sync fed by ldmatrix), each
//     taking a descriptor built once a tile plus a compile-time offset (the
//     products are held by their issue rate as much as by the tensor cores:
//     building both descriptors from pointers at every product cost 0.9 ms
//     of the dK/dV pass at the flow decoder). S and dP are ss products with
//     both operands in shared memory, each 64-channel box's products issued
//     as soon as that box has landed (a full barrier a box); dV^T = dO^T P
//     and dK^T = Q^T dS read dO and Q MN-major (the transpose bit of A) and
//     P^T and dS^T from shared memory, because each consumer computes the
//     scores of half the block's keys and the products need all of them;
//     dQ = dS K reads dS^T MN-major as A and K MN-major as B (as the
//     forward's P V reads V);
//   * TMA into rings of stages with warp specialisation (limit: cp.async by
//     every thread, two block barriers a tile): 384 threads, a producer
//     warpgroup at kProducerRegs (setmaxnreg) one thread of which issues
//     every load, and two consumer warpgroups at kConsumerRegs. The dK/dV
//     pass loads K and V of the block's keys once and streams Q and dO, each
//     in its own ring with full and empty mbarriers, so that dO's stage is
//     released once dV^T is done and Q's once dK^T is. 3-d tensor maps over
//     (B H, N, D) with 64-channel boxes and the 128-byte swizzle zero-fill
//     rows past Nq or Nk, which are masked. The only block-level
//     synchronisation left is one named barrier between the two consumers a
//     tile, once P and dS are stored; they are double-buffered, so a
//     consumer writes a buffer again only past the next tile's barrier,
//     which the other reaches only once its products of that buffer are done;
//   * whole sums in each consumer, no float32 partial crossing (limit: the
//     per-tile chain of a partial exchange): in the dK/dV pass consumer c
//     computes S and dP of keys [16 c, 16 c + 16) over the full contraction
//     and stores its P and dS as two bf16 terms (hi, and lo = x - hi); the
//     phase-2 products are split by the output's 64-channel boxes, consumer 0
//     taking the larger half (out_boxes). (Splitting S and dP between the
//     consumers by product instead, at N = 32, made the scores faster and the
//     pass slower: P's hand-off serialised the two consumers. Interleaving
//     the two score products' accumulator chains was slower too.)
//   * dS written once, not recomputed (limit: the dQ pass's own S and dP at
//     N = 16, a third of the tensor peak, and its P/dS chain between two
//     pipeline drains): one thread of the dK/dV pass sends each tile's dS^T
//     terms from shared memory to a bf16 scratch (2 x B H x Nk x Nq64) by TMA
//     store, and the dQ pass is a GEMM over them, dQ = dS_hi K + dS_lo K, at
//     m64n256 from a ring of dQ stages. Its key tiles are the dK/dV pass's
//     32-key blocks, so it reads only the dS tiles that pass wrote: a block
//     writes every query tile from the first that sees one of its keys;
//   * a cluster of two blocks multicasting the streamed tiles (limit: bytes
//     through L2): in the dK/dV pass neighbouring key tiles of one (split,
//     batch*head) share Q and dO, in the dQ pass neighbouring query tiles of
//     one batch*head share K; each block loads half the rows of every box of
//     a shared tile and multicasts it to both. The pair streams the union of
//     its two causal ranges (dK/dV: from the first query that sees the lower
//     key tile; dQ: up to the last key the higher query tile sees); a block
//     waits for and releases the tiles it does not see (a prefix in dK/dV, a
//     suffix in dQ) without multiplying them. A spare block (an odd tile
//     count pads the grid to whole clusters) issues its half of every load
//     and every release and writes nothing. An empty barrier counts the
//     consumer warps of both blocks, and each producer stays until its
//     stages' last uses are released, so no remote write or arrival reaches
//     a finished block. Padding keys are masked, never skipped, so both
//     blocks stream the same tiles.
// Which layout for the dK/dV products: dK and dV of 64 keys x 512 channels in
// float32 are the whole register file, and wgmma's M is 64 rows, so the
// block keeps 32 keys and computes dK^T and dV^T (M = channels, N = the 32
// keys, K = the tile's queries): each consumer holds at most 4 boxes x 2 x
// 16 = 128 accumulators a thread. P^T and dS^T are stored key by query,
// K-major for B, and dS^T goes to the scratch in the same layout. The
// workspace keeps the (key, channel) layout that the reduce reads. The dQ
// pass keeps 64 queries by the consumer's columns (at most 64 x 256
// float32, 128 registers a thread), as o in the forward.
// Deterministic: no atomics; the dK/dV pass's query splits write float32
// partials that a reduce kernel adds in split order (and writes pad keys'
// zeros), so two runs give the same bits. The delta pass (mma_tiles.cuh's,
// shared with flash_backward_mma.cu) reads the float32 O.
//
// Stages and shared memory per width (dK/dV: kDkdvKeys = 32 keys a block,
// kDkdvCols = 64-query tiles, bytes = 1024 of alignment slack + K and V +
// stages x (Q, dO) + the double-buffered P^T and dS^T terms + mbarriers; dQ:
// kDqRows = 64 queries a block, kDqKeys = 32-key tiles, bytes = 1024 +
// stages x (dS^T terms, K) + mbarriers), and consumer 0's float32
// accumulators a thread (dK/dV: dK^T and dV^T, S, dP; dQ: dQ; consumer 0
// takes the larger half of an odd box count):
//   D 192: dK/dV 3 stages, 206,024 bytes, 64 + 8 + 8 accumulators; dQ 6 stages, 124,000 bytes, 64 accumulators
//   D 256: dK/dV 2 stages, 197,800 bytes, 64 + 8 + 8 accumulators; dQ 6 stages, 148,576 bytes, 64 accumulators
//   D 320: dK/dV 1 stage, 156,776 bytes, 96 + 8 + 8 accumulators; dQ 4 stages, 115,776 bytes, 96 accumulators
//   D 384: dK/dV 1 stage, 181,368 bytes, 96 + 8 + 8 accumulators; dQ 4 stages, 132,160 bytes, 96 accumulators
//   D 448: dK/dV 1 stage, 205,960 bytes, 128 + 8 + 8 accumulators; dQ 4 stages, 148,544 bytes, 128 accumulators
//   D 512: dK/dV 1 stage, 230,552 bytes, 128 + 8 + 8 accumulators; dQ 4 stages, 164,928 bytes, 128 accumulators
// (of the 232,448 bytes a block may have and kConsumerRegs registers a
// thread). With one dK/dV stage the next tile's loads wait for the last uses
// of the stage: dO's ring is released first, once dV^T is done, so its load
// overlaps dK^T.

#include "hopper.cuh"
#include "mma_tiles.cuh"  // launch_delta: the delta pass shared with flash_backward_mma.cu

namespace {

using namespace hopper;

constexpr int kTerms = 2;                 // bf16 terms of P and dS in their products (hi + lo)
constexpr int kBlockThreads = 3 * 128;    // the producer warpgroup, then the two consumers
constexpr int kProducerRegs = 40;         // setmaxnreg: 128 x 40 + 256 x 232 <= 65,536
constexpr int kConsumerRegs = 232;
constexpr int kClusterBlocks = 2;
constexpr int kReadyBarrier = 1;          // named barrier between the two consumer warpgroups
constexpr int kReleases = 2 * 4 * kClusterBlocks;  // arrivals that free a stage: every consumer warp of both blocks

// dK/dV pass: resident key rows a block (the phase-2 products' N), streamed query rows a tile (the score products' M)
constexpr int kDkdvKeys = 32;
constexpr int kDkdvCols = 64;
// dQ pass: query rows a block, key rows a streamed tile (the dK/dV pass's
// key blocks, so that it reads only the dS^T tiles that pass wrote)
constexpr int kDqRows = 64;
constexpr int kDqKeys = kDkdvKeys;
template <int D>
__host__ __device__ constexpr int dkdv_stages() {
  return D <= 192 ? 3 : D <= 256 ? 2 : 1;
}
template <int D>
__host__ __device__ constexpr int dq_stages() {
  return D <= 256 ? 6 : 4;
}
// 64-channel boxes of the output a consumer owns in the phase-2 products:
// consumer 0 the larger half, from box 0; consumer 1 the boxes after.
template <int D>
__host__ __device__ constexpr int out_boxes(int c) {
  return c == 0 ? (D / 64 + 1) / 2 : D / 64 / 2;
}

template <int D>
__host__ __device__ constexpr size_t dkdv_smem_bytes() {  // K, V; stages x (Q, dO); 2 x (P, dS) x terms; barriers
  return 1024 +
         sizeof(bf16) * (2 * kDkdvKeys * D + dkdv_stages<D>() * 2 * kDkdvCols * D + 2 * 2 * kTerms * kDkdvKeys * 64) +
         sizeof(uint64_t) * (1 + dkdv_stages<D>() * (2 * D / 64 + 2));
}
template <int D>
__host__ __device__ constexpr size_t dq_smem_bytes() {  // stages x (dS^T terms, K); barriers
  return 1024 + sizeof(bf16) * dq_stages<D>() * (kTerms * kDqKeys * 64 + kDqKeys * D) +
         sizeof(uint64_t) * 2 * dq_stages<D>();
}

// Parts switched off, one bit each, by perceiver_io_torch/profile_wide_backward.py
// (a build that times what each part costs; it computes wrong values). 0 in
// every build the port loads.
#ifndef B1B_OFF
#define B1B_OFF 0
#endif
constexpr unsigned kOff = B1B_OFF;
constexpr unsigned kOffLoads = 1;    // streamed tiles after the first stages: none loaded (stale data)
constexpr unsigned kOffScores = 2;   // the S and dP products
constexpr unsigned kOffPds = 4;      // P = exp(S - lse), the mask, dS = P (dP - delta)
constexpr unsigned kOffStores = 8;   // the stores of P and dS to shared memory
constexpr unsigned kOffPhase2 = 16;  // the dV, dK and dQ products
constexpr unsigned kOffTranspose = 32;  // dV^T and dK^T read dO and Q K-major (wrong values: their cost alone)

// In a build with parts switched off, folds values into a sum that the
// kernel writes out only if it equals an impossible value, so that ptxas
// keeps the products whose results nothing else reads. Nothing in the
// kernel the port loads.
template <int R>
__device__ __forceinline__ void keep(float& sum, const float (&x)[R]) {
  if constexpr (kOff != 0) {
#pragma unroll
    for (int i = 0; i < R; ++i) sum += x[i];
  }
}
__device__ __forceinline__ void keep_out(float sum, float* dst) {
  if constexpr (kOff != 0) {
    if (sum == -1.2345e-30f) *dst = sum;
  }
}

// Byte offset of element (row, col) of a (rows, 64) bf16 tile with the
// 128-byte swizzle, the tile at a multiple of 1024 bytes.
__device__ __forceinline__ uint32_t swz128(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}

// -lse * log2(e) of a query, the shift of its exp2; -inf for a query past Nq
// or one that sees no key (lse = -inf), so that its P is 0.
__device__ __forceinline__ float neg_lse_log2(const float* __restrict__ lse, size_t at, bool valid) {
  const float l = valid ? lse[at] : -INFINITY;
  return l == -INFINITY ? -INFINITY : -l * kLog2e;
}

// ------------------------------------------------------------ producer side
// Tile t of a streamed tensor into stage t % kStages of its ring: this
// block's half (kRows / 2 rows of every 64-channel box, from row row0 +
// rank kRows / 2) multicast to both blocks, once every consumer warp of both
// blocks has released the stage's last use. Box b completes on full[stage
// D / 64 + b], so that a consumer can multiply the first boxes while the
// rest still land.
template <int D, int kRows, int kStages>
__device__ __forceinline__ void stream_tile(const CUtensorMap* map, bf16* ring, uint64_t* full, uint64_t* empty, int t,
                                            int row0, int bh, int rank) {
  constexpr int kHalf = kRows / 2;
  const int st = t % kStages;
  mbar_wait_cluster(empty + st, ((t / kStages) & 1) ^ 1);
  uint64_t* box_full = full + st * D / 64;
  if constexpr ((kOff & kOffLoads) != 0) {
    if (t >= kStages) {
#pragma unroll
      for (int b = 0; b < D / 64; ++b) mbar_arrive_expect_tx(box_full + b, 0);
      return;
    }
  }
#pragma unroll
  for (int b = 0; b < D / 64; ++b) {
    mbar_arrive_expect_tx(box_full + b, sizeof(bf16) * kRows * 64);  // both halves land here
    tma_load_3d_multicast(ring + (st * D / 64 + b) * kRows * 64 + rank * kHalf * 64, map, box_full + b, 0x3, 64 * b,
                          row0 + rank * kHalf, bh);
  }
}

// Stays until every stage's last use is released: then no consumer of the
// other block arrives here, and no multicast writes here, after this block ends.
template <int kStages>
__device__ __forceinline__ void drain(uint64_t* empty, int n_tiles) {
  for (int st = 0; st < kStages && st < n_tiles; ++st) {
    const int uses = (n_tiles - st + kStages - 1) / kStages;
    mbar_wait_cluster(empty + st, (uses & 1) ^ 1);
  }
}

// A resident (rows, D) tile of this block alone, as D / 64 boxes, completing on `full`.
template <int D, int kRows>
__device__ __forceinline__ void load_resident(bf16* dst, const CUtensorMap* map, uint64_t* full, int row0, int bh) {
#pragma unroll
  for (int b = 0; b < D / 64; ++b) tma_load_3d(dst + b * kRows * 64, map, full, 64 * b, row0, bh);
}

// ------------------------------------------------------------ consumer side
// Releases a stage in both blocks of the cluster: one arrival a warp (after
// its wgmma wait) on the empty barrier at the same offset in each block.
__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < kClusterBlocks; ++r) mbar_arrive_cluster(empty, r);
  }
}

// A tile this block does not multiply: every box waited for, and the stage
// released, in both rings (full_a and full_b: the stage's box barriers).
template <int D>
__device__ __forceinline__ void pass_tile(uint64_t* full_a, uint64_t* empty_a, uint64_t* full_b, uint64_t* empty_b,
                                          uint32_t parity, int lane) {
#pragma unroll
  for (int b = 0; b < D / 64; ++b) mbar_wait(full_a + b, parity);
  release(empty_a, lane);
#pragma unroll
  for (int b = 0; b < D / 64; ++b) mbar_wait(full_b + b, parity);
  release(empty_b, lane);
}

template <int R>
__device__ __forceinline__ void zero(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0.f;
  fence_regs(d);
}

// A score product of a consumer, as one commit group: acc (64 rows of the
// A tiles by N rows of the B tiles from row b0) = A B^T summed over the D
// channels; A and B K-major boxes of kARows and kBRows rows, A's box `box`
// multiplied once a_full[box] has completed its phase of this parity.
template <int D, int N, int kARows, int kBRows>
__device__ __forceinline__ void issue_score(float (&acc)[N / 2], const bf16* a, uint64_t* a_full, uint32_t parity,
                                            const bf16* b, int b0) {
  const uint64_t da = wgmma_desc(a, 16, 1024), db = wgmma_desc(b + b0 * 64, 16, 1024);
#pragma unroll
  for (int box = 0; box < D / 64; ++box) {
    mbar_wait(a_full + box, parity);
    if constexpr ((kOff & kOffScores) == 0) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Wgmma<N>::ss(acc, desc_add(da, sizeof(bf16) * (box * kARows * 64 + kk * 16)),
                     desc_add(db, sizeof(bf16) * (box * kBRows * 64 + kk * 16)));
    }
  }
  wgmma_commit();
}

// A term of P or dS, x rounded to bf16 (hi) or its remainder (lo).
__device__ __forceinline__ bf16 term(float x, int h) {
  const bf16 hi = __float2bfloat16_rn(x);
  return h == 0 ? hi : __float2bfloat16_rn(x - __bfloat162float(hi));
}

// --------------------------------------------------------------- dK, dV
template <int D>
struct DkdvSmem {
  bf16* k;           // D / 64 boxes of (kDkdvKeys, 64): the block's keys
  bf16* v;           // the same
  bf16* q;           // stages x D / 64 boxes of (kDkdvCols, 64)
  bf16* dout;        // the same
  bf16* pds;         // [2 buffers][P hi, P lo, dS hi, dS lo] of (kDkdvKeys, 64): P^T, dS^T key by query
  uint64_t* kv_full;
  uint64_t* q_full;   // [stages][D / 64]: a barrier per box
  uint64_t* q_empty;  // [stages]
  uint64_t* o_full;   // [stages][D / 64]
  uint64_t* o_empty;  // [stages]
};

template <int D>
__device__ __forceinline__ DkdvSmem<D> carve_dkdv(unsigned char* raw) {
  constexpr int kSt = dkdv_stages<D>();
  unsigned char* base = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);  // the same offset in both blocks
  DkdvSmem<D> t;
  t.k = reinterpret_cast<bf16*>(base);
  t.v = t.k + kDkdvKeys * D;
  t.q = t.v + kDkdvKeys * D;
  t.dout = t.q + kSt * kDkdvCols * D;
  t.pds = t.dout + kSt * kDkdvCols * D;
  t.kv_full = reinterpret_cast<uint64_t*>(t.pds + 2 * 2 * kTerms * kDkdvKeys * 64);
  t.q_full = t.kv_full + 1;
  t.q_empty = t.q_full + kSt * D / 64;
  t.o_full = t.q_empty + kSt;
  t.o_empty = t.o_full + kSt * D / 64;
  return t;
}

struct DkdvProblem {
  int bh, BH, k0, Nq, Nk, causal, split, splits;
  int q_begin;  // the pair's first query row (a multiple of kDkdvCols)
  int n_tiles;  // query tiles the pair streams
  int n_skip;   // leading tiles no key of this block sees (all of them in a spare block)
};

// K and V of the block's keys once, then dO and Q of every tile of the pair;
// dO runs first, as dP (and its ring's release) comes first in a tile.
template <int D>
__device__ __forceinline__ void dkdv_produce(const DkdvSmem<D>& sm, const DkdvProblem& pb, const CUtensorMap* tm_q,
                                             const CUtensorMap* tm_o, const CUtensorMap* tm_k,
                                             const CUtensorMap* tm_v) {
  constexpr int kSt = dkdv_stages<D>();
  const int rank = (int)cluster_rank();
  if (pb.n_tiles == 0) return;
  if (pb.n_skip < pb.n_tiles) {
    mbar_arrive_expect_tx(sm.kv_full, 2 * sizeof(bf16) * kDkdvKeys * D);
    load_resident<D, kDkdvKeys>(sm.k, tm_k, sm.kv_full, pb.k0, pb.bh);
    load_resident<D, kDkdvKeys>(sm.v, tm_v, sm.kv_full, pb.k0, pb.bh);
  }
  for (int t = 0; t < pb.n_tiles; ++t) {
    const int row0 = pb.q_begin + t * kDkdvCols;
    stream_tile<D, kDkdvCols, kSt>(tm_o, sm.dout, sm.o_full, sm.o_empty, t, row0, pb.bh, rank);
    stream_tile<D, kDkdvCols, kSt>(tm_q, sm.q, sm.q_full, sm.q_empty, t, row0, pb.bh, rank);
  }
  drain<kSt>(sm.o_empty, pb.n_tiles);
  drain<kSt>(sm.q_empty, pb.n_tiles);
}

// acc[b] (the channels of box kOB0 + b by the block's 32 keys) += A^T T over
// a tile's 64 queries, as one commit group: A the streamed tile (Q or dO),
// its box read MN-major (transposed), T a pair of terms of P^T or dS^T (key
// by query) read K-major.
template <int kOB, int kOB0>
__device__ __forceinline__ void issue_dkdv_phase2(float (&acc)[kOB][kDkdvKeys / 2], const bf16* a,
                                                  const bf16* terms) {
  if constexpr ((kOff & kOffPhase2) == 0) {
    const uint64_t da = wgmma_desc(a + kOB0 * kDkdvCols * 64, kDkdvCols * 128, 1024);
    const uint64_t dt = wgmma_desc(terms, 16, 1024);
#pragma unroll
    for (int kk = 0; kk < kDkdvCols / 16; ++kk) {
#pragma unroll
      for (int b = 0; b < kOB; ++b) {
#pragma unroll
        for (int h = 0; h < kTerms; ++h)
          Wgmma<kDkdvKeys>::template ss<(kOff & kOffTranspose) == 0, 0>(
              acc[b], desc_add(da, sizeof(bf16) * (b * kDkdvCols * 64 + kk * 16 * 64)),
              desc_add(dt, sizeof(bf16) * (h * kDkdvKeys * 64 + kk * 16)));
      }
    }
  }
  wgmma_commit();
}

// Consumer C. Per tile: dP = dO V^T and S = Q K^T for the tile's 64
// queries by keys [16 C, 16 C + 16) of the block, each box's products
// issued as soon as that box has landed; P = exp2(S log2(e) - lse log2(e))
// masked, dS = P (dP - delta); both stored key by query as two bf16 terms;
// after the named barrier dV^T += dO^T P and dK^T += Q^T dS over this
// consumer's channel boxes and all 32 keys, and one thread of consumer 0
// sends the tile's dS^T to the scratch the dQ pass reads. dO's stage is
// released once dV^T is done, Q's once dK^T is. Then the epilogue: the
// split's partial sums into the workspace (zeros for a block that saw no
// query), keys past Nk never written, pad keys left to the reduce.
template <int D, int C>
__device__ __forceinline__ void dkdv_consume(const DkdvSmem<D>& sm, const DkdvProblem& pb, const CUtensorMap* tm_ds,
                                             const uint8_t* __restrict__ pad_row, const float* __restrict__ lse,
                                             const float* __restrict__ delta, float* __restrict__ ws_k,
                                             float* __restrict__ ws_v) {
  constexpr int kSt = dkdv_stages<D>();
  constexpr int kOB = out_boxes<D>(C), kOB0 = C == 0 ? 0 : out_boxes<D>(0);
  constexpr int kH = kDkdvKeys / 2;  // keys of the score products a consumer computes
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int off = pb.Nk - pb.Nq;
  const bool storer = C == 0 && tid == 0;  // the thread that sends dS^T to the dQ pass
  // the thread's keys in the score products: C kH + 8 j + 2 t4 + e
  bool key_ok[kH / 8][2];
#pragma unroll
  for (int j = 0; j < kH / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = pb.k0 + C * kH + 8 * j + 2 * t4 + e;
      key_ok[j][e] = key < pb.Nk && !(pad_row && pad_row[key]);
    }

  float dv[kOB][kDkdvKeys / 2], dk[kOB][kDkdvKeys / 2];  // dV^T and dK^T: channels of box kOB0 + b by the 32 keys
#pragma unroll
  for (int b = 0; b < kOB; ++b) {
    zero(dv[b]);
    zero(dk[b]);
  }
  float sink = 0.f;
  for (int t = 0; t < pb.n_skip; ++t) {
    const int st = t % kSt;
    pass_tile<D>(sm.o_full + st * D / 64, sm.o_empty + st, sm.q_full + st * D / 64, sm.q_empty + st, (t / kSt) & 1,
                 lane);
  }
  if (pb.n_skip < pb.n_tiles) mbar_wait(sm.kv_full, 0);
  for (int t = pb.n_skip; t < pb.n_tiles; ++t) {
    const int st = t % kSt;
    const uint32_t parity = (t / kSt) & 1;
    const int q0 = pb.q_begin + t * kDkdvCols;
    float nl[2], dl[2];  // rows q0 + 16 warp + g (+ 8): neg_lse_log2 and delta
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + 16 * warp + g + 8 * r;
      const size_t at = (size_t)pb.bh * pb.Nq + row;
      nl[r] = neg_lse_log2(lse, at, row < pb.Nq);
      dl[r] = row < pb.Nq ? delta[at] : 0.f;
    }
    const bf16* tq = sm.q + st * D / 64 * kDkdvCols * 64;
    const bf16* to = sm.dout + st * D / 64 * kDkdvCols * 64;
    float s[kH / 2], dp[kH / 2];
    zero(s);
    zero(dp);
    wgmma_fence();
    issue_score<D, kH, kDkdvCols, kDkdvKeys>(dp, to, sm.o_full + st * D / 64, parity, sm.v, C * kH);
    issue_score<D, kH, kDkdvCols, kDkdvKeys>(s, tq, sm.q_full + st * D / 64, parity, sm.k, C * kH);
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    keep(sink, s);
    keep(sink, dp);

    // P and dS, stored key by query (P^T, dS^T) in buffer t % 2
    bf16* buf = sm.pds + (t & 1) * 2 * kTerms * kDkdvKeys * 64;
#pragma unroll
    for (int j = 0; j < kH / 8; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * r + e, key = C * kH + 8 * j + 2 * t4 + e, row = 16 * warp + g + 8 * r;
          float p = s[i], ds = dp[i];
          if constexpr ((kOff & kOffPds) == 0) {
            const bool visible = key_ok[j][e] && !(pb.causal && pb.k0 + key > off + q0 + row);
            p = visible ? exp2f(fmaf(s[i], kLog2e, nl[r])) : 0.f;  // exp2(-inf) = 0
            ds = p * (dp[i] - dl[r]);
          }
          if constexpr ((kOff & kOffStores) != 0) {
            sink += p + ds;
          } else {
            const uint32_t at = swz128(key, row) / 2;
#pragma unroll
            for (int h = 0; h < kTerms; ++h) {
              buf[h * kDkdvKeys * 64 + at] = term(p, h);
              buf[(kTerms + h) * kDkdvKeys * 64 + at] = term(ds, h);
            }
          }
        }
      }
    }
    fence_async_shared();
    if (storer) bulk_wait_read<0>();  // the last tile's store has read its buffer, which the next tile refills
    named_sync(kReadyBarrier, 256);   // both consumers' P^T and dS^T are stored
    if constexpr ((kOff & kOffStores) == 0) {
      if (storer) {
#pragma unroll
        for (int h = 0; h < kTerms; ++h)
          tma_store_3d(tm_ds, buf + (kTerms + h) * kDkdvKeys * 64, q0, pb.k0, h * pb.BH + pb.bh);
        bulk_commit();
      }
    }

#pragma unroll
    for (int b = 0; b < kOB; ++b) {
      fence_regs(dv[b]);
      fence_regs(dk[b]);
    }
    wgmma_fence();
    issue_dkdv_phase2<kOB, kOB0>(dv, to, buf);                              // dV^T += dO^T P
    issue_dkdv_phase2<kOB, kOB0>(dk, tq, buf + kTerms * kDkdvKeys * 64);  // dK^T += Q^T dS
    wgmma_wait<1>();
#pragma unroll
    for (int b = 0; b < kOB; ++b) fence_regs(dv[b]);
    release(sm.o_empty + st, lane);
    wgmma_wait<0>();
#pragma unroll
    for (int b = 0; b < kOB; ++b) fence_regs(dk[b]);
    release(sm.q_empty + st, lane);
  }

  if (C == 0 && tid == 0) bulk_wait<0>();  // every dS^T store has landed
  // epilogue: accumulator (channel 64 (kOB0 + b) + 16 warp + g + 8 r, key 8 j + 2 t4 + e)
  keep_out(sink, ws_k);
  if (pb.k0 >= pb.Nk) return;  // the spare block
  const size_t base = ((size_t)pb.bh * pb.splits + pb.split) * pb.Nk;
#pragma unroll
  for (int b = 0; b < kOB; ++b) {
#pragma unroll
    for (int j = 0; j < kDkdvKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = pb.k0 + 8 * j + 2 * t4 + e;
        if (key >= pb.Nk) continue;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const size_t at = (base + key) * D + (kOB0 + b) * 64 + 16 * warp + g + 8 * r;
          ws_k[at] = dk[b][4 * j + 2 * r + e];
          ws_v[at] = dv[b][4 * j + 2 * r + e];
        }
      }
    }
  }
}

// One cluster of two blocks per pair of neighbouring key tiles, for each
// (query split, batch*head): each block's split partial dK and dV, float32,
// into ws_k and ws_v at [bh][split][key][:].
template <int D>
__global__ void __cluster_dims__(kClusterBlocks, 1, 1) __launch_bounds__(kBlockThreads, 1)
    flash_bwd_wide_dkdv_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_o,
                               const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                               const __grid_constant__ CUtensorMap tm_ds, const uint8_t* __restrict__ pad,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               float* __restrict__ ws_k, float* __restrict__ ws_v, int H, int Nq, int Nk, int causal,
                               int split_len) {
  constexpr int kSt = dkdv_stages<D>();
  static_assert(D % 64 == 0 && D >= 192 && D <= 512, "D must be a multiple of 64 in 192..512");
  static_assert(dkdv_smem_bytes<D>() <= 232448, "the tiles must fit in 227 KB of shared memory");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const DkdvSmem<D> sm = carve_dkdv<D>(smem_raw);

  DkdvProblem pb;
  pb.bh = blockIdx.z;
  pb.BH = gridDim.z;
  pb.k0 = blockIdx.x * kDkdvKeys;
  pb.Nq = Nq;
  pb.Nk = Nk;
  pb.causal = causal;
  pb.split = blockIdx.y;
  pb.splits = gridDim.y;
  // the split's query tiles from the first that sees key k (causal); split_len is a multiple of kDkdvCols
  const int q_lo = pb.split * split_len, q_hi = min(Nq, q_lo + split_len), off = Nk - Nq;
  auto first_row = [&](int k) { return causal ? max(q_lo, max(0, k - off) / kDkdvCols * kDkdvCols) : q_lo; };
  pb.q_begin = first_row((blockIdx.x & ~1) * kDkdvKeys);
  pb.n_tiles = q_hi > pb.q_begin ? (q_hi - pb.q_begin + kDkdvCols - 1) / kDkdvCols : 0;
  pb.n_skip = pb.k0 < Nk ? min(pb.n_tiles, (first_row(pb.k0) - pb.q_begin) / kDkdvCols) : pb.n_tiles;

  if (threadIdx.x == 0) {
    mbar_init(sm.kv_full, 1);
    for (int st = 0; st < kSt; ++st) {
      for (int b = 0; b < D / 64; ++b) {
        mbar_init(sm.q_full + st * D / 64 + b, 1);  // the producer's arrival; bytes from both blocks
        mbar_init(sm.o_full + st * D / 64 + b, 1);
      }
      mbar_init(sm.q_empty + st, kReleases);
      mbar_init(sm.o_empty + st, kReleases);
    }
    mbar_init_fence();
  }
  cluster_sync();  // the barriers of both blocks exist before any load or remote arrival

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      tma_prefetch(&tm_q);
      tma_prefetch(&tm_o);
      tma_prefetch(&tm_k);
      tma_prefetch(&tm_v);
      dkdv_produce<D>(sm, pb, &tm_q, &tm_o, &tm_k, &tm_v);
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const uint8_t* pad_row = pad ? pad + (size_t)(pb.bh / H) * Nk : nullptr;
    if (wg == 1)
      dkdv_consume<D, 0>(sm, pb, &tm_ds, pad_row, lse, delta, ws_k, ws_v);
    else
      dkdv_consume<D, 1>(sm, pb, &tm_ds, pad_row, lse, delta, ws_k, ws_v);
  }
}

// dK and dV = the splits' partial sums added in split order, bf16; pad keys
// exact zeros. Four channels a thread.
__global__ void __launch_bounds__(256) flash_bwd_wide_reduce_kernel(
    const float* __restrict__ ws_k, const float* __restrict__ ws_v, const uint8_t* __restrict__ pad,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Nk, int D, int splits, size_t total4) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total4) return;
  const size_t e = i * 4, row = e / D;  // row over (B*H, Nk)
  const size_t bh = row / Nk, key = row % Nk;
  const bool ok = !(pad && pad[(bh / H) * Nk + key]);
  float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
  for (int s = 0; s < splits; ++s) {
    const size_t at = (bh * splits + s) * Nk * D + (e - bh * Nk * D);
    const float4 a = *reinterpret_cast<const float4*>(ws_k + at);
    const float4 c = *reinterpret_cast<const float4*>(ws_v + at);
    sk.x += a.x, sk.y += a.y, sk.z += a.z, sk.w += a.w;
    sv.x += c.x, sv.y += c.y, sv.z += c.z, sv.w += c.w;
  }
  const __nv_bfloat162 zero2 = __floats2bfloat162_rn(0.f, 0.f);
  __nv_bfloat162* k2 = reinterpret_cast<__nv_bfloat162*>(dk + e);
  __nv_bfloat162* v2 = reinterpret_cast<__nv_bfloat162*>(dv + e);
  k2[0] = ok ? __floats2bfloat162_rn(sk.x, sk.y) : zero2;
  k2[1] = ok ? __floats2bfloat162_rn(sk.z, sk.w) : zero2;
  v2[0] = ok ? __floats2bfloat162_rn(sv.x, sv.y) : zero2;
  v2[1] = ok ? __floats2bfloat162_rn(sv.z, sv.w) : zero2;
}

// ------------------------------------------------------------------- dQ
template <int D>
struct DqSmem {
  bf16* ds;  // stages x [dS^T hi, dS^T lo] of (kDqKeys, 64): key by query
  bf16* k;   // stages x D / 64 boxes of (kDqKeys, 64)
  uint64_t* full;   // [stages]
  uint64_t* empty;  // [stages]
};

template <int D>
__device__ __forceinline__ DqSmem<D> carve_dq(unsigned char* raw) {
  constexpr int kSt = dq_stages<D>();
  unsigned char* base = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);  // the same offset in both blocks
  DqSmem<D> t;
  t.ds = reinterpret_cast<bf16*>(base);
  t.k = t.ds + kSt * kTerms * kDqKeys * 64;
  t.full = reinterpret_cast<uint64_t*>(t.k + kSt * kDqKeys * D);
  t.empty = t.full + kSt;
  return t;
}

struct DqProblem {
  int bh, q0, BH;
  int n_tiles;  // key tiles the pair streams
  int n_mine;   // the prefix of them some row of this block sees (none in a spare block)
};

// For every key tile of the pair: this block's dS^T terms (only for the
// tiles it multiplies: the dK/dV pass wrote exactly those) and its half of
// K, multicast to both blocks.
template <int D>
__device__ __forceinline__ void dq_produce(const DqSmem<D>& sm, const DqProblem& pb, const CUtensorMap* tm_ds,
                                           const CUtensorMap* tm_k) {
  constexpr int kSt = dq_stages<D>(), kHalf = kDqKeys / 2;
  const int rank = (int)cluster_rank();
  for (int t = 0; t < pb.n_tiles; ++t) {
    const int st = t % kSt;
    const bool mine = t < pb.n_mine;
    mbar_wait_cluster(sm.empty + st, ((t / kSt) & 1) ^ 1);
    if constexpr ((kOff & kOffLoads) != 0) {
      if (t >= kSt) {
        mbar_arrive_expect_tx(sm.full + st, 0);
        continue;
      }
    }
    mbar_arrive_expect_tx(sm.full + st, sizeof(bf16) * (kDqKeys * D + (mine ? kTerms * kDqKeys * 64 : 0)));
    if (mine) {
#pragma unroll
      for (int h = 0; h < kTerms; ++h)
        tma_load_3d(sm.ds + (st * kTerms + h) * kDqKeys * 64, tm_ds, sm.full + st, pb.q0, t * kDqKeys,
                    h * pb.BH + pb.bh);
    }
#pragma unroll
    for (int b = 0; b < D / 64; ++b)
      tma_load_3d_multicast(sm.k + (st * D / 64 + b) * kDqKeys * 64 + rank * kHalf * 64, tm_k, sm.full + st, 0x3,
                            64 * b, t * kDqKeys + rank * kHalf, pb.bh);
  }
  drain<kSt>(sm.empty, pb.n_tiles);
}

// Consumer C: dQ[:, own columns] += dS_hi K[:, own columns] + dS_lo K[:,
// own columns] over the key tiles this block sees, dS^T read MN-major as A
// and K MN-major as B, one tile's products in flight while the next tile's
// are issued; the tiles past this block's causal bound (all of them in a
// spare block) are only waited for and released. Then dQ in bf16.
template <int D, int C>
__device__ __forceinline__ void dq_consume(const DqSmem<D>& sm, const DqProblem& pb, int Nq,
                                           bf16* __restrict__ dq) {
  constexpr int kSt = dq_stages<D>();
  constexpr int kOB = out_boxes<D>(C), kOB0 = C == 0 ? 0 : out_boxes<D>(0), kON = 64 * kOB;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  float acc[kON / 2];
  zero(acc);
  for (int t = 0; t < pb.n_mine; ++t) {
    const int st = t % kSt;
    mbar_wait(sm.full + st, (t / kSt) & 1);
    fence_regs(acc);
    wgmma_fence();
    if constexpr ((kOff & kOffPhase2) == 0) {
      const uint64_t dk = wgmma_desc(sm.k + (st * D / 64 + kOB0) * kDqKeys * 64, kDqKeys * 128, 1024);
      const uint64_t dd = wgmma_desc(sm.ds + st * kTerms * kDqKeys * 64, kDqKeys * 128, 1024);
#pragma unroll
      for (int kk = 0; kk < kDqKeys / 16; ++kk) {
#pragma unroll
        for (int h = 0; h < kTerms; ++h)
          Wgmma<kON>::template ss<1, 1>(acc, desc_add(dd, sizeof(bf16) * (h * kDqKeys * 64 + kk * 16 * 64)),
                                        desc_add(dk, sizeof(bf16) * kk * 16 * 64));
      }
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous tile's products are done: its stage is free
    fence_regs(acc);
    if (t > 0) release(sm.empty + (t - 1) % kSt, lane);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if (pb.n_mine > 0) release(sm.empty + (pb.n_mine - 1) % kSt, lane);
  for (int t = pb.n_mine; t < pb.n_tiles; ++t) {
    const int st = t % kSt;
    mbar_wait(sm.full + st, (t / kSt) & 1);
    release(sm.empty + st, lane);
  }

  // epilogue: bf16 once; rows past Nq (and a spare block's) never stored
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = pb.q0 + 16 * warp + g + 8 * r;
    if (row >= Nq) continue;
    bf16* qrow = dq + ((size_t)pb.bh * Nq + row) * D + kOB0 * 64 + 2 * t4;
#pragma unroll
    for (int j = 0; j < kON / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(qrow + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

// One cluster of two blocks per pair of neighbouring 64-query tiles of a
// batch*head, heaviest causal pairs first.
template <int D>
__global__ void __cluster_dims__(kClusterBlocks, 1, 1) __launch_bounds__(kBlockThreads, 1)
    flash_bwd_wide_dq_kernel(const __grid_constant__ CUtensorMap tm_ds, const __grid_constant__ CUtensorMap tm_k,
                             bf16* __restrict__ dq, int Nq, int Nk, int causal) {
  constexpr int kSt = dq_stages<D>();
  static_assert(D % 64 == 0 && D >= 192 && D <= 512, "D must be a multiple of 64 in 192..512");
  static_assert(dq_smem_bytes<D>() <= 232448, "the tiles must fit in 227 KB of shared memory");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const DqSmem<D> sm = carve_dq<D>(smem_raw);

  DqProblem pb;
  pb.bh = blockIdx.y;
  pb.BH = gridDim.y;
  // heaviest causal tiles first; the two blocks of a cluster take tiles 2p and 2p + 1
  const int tile = causal ? (int)(gridDim.x - 1 - blockIdx.x) : (int)blockIdx.x;
  const int pair0 = (tile & ~1) * kDqRows;  // the pair's first query row (always < Nq)
  pb.q0 = tile * kDqRows;
  const int off = Nk - Nq;
  const int pair_keys = causal ? min(Nk, max(0, off + min(Nq, pair0 + 2 * kDqRows))) : Nk;
  const int blk_keys = causal ? min(Nk, max(0, off + min(Nq, pb.q0 + kDqRows))) : Nk;
  pb.n_tiles = (pair_keys + kDqKeys - 1) / kDqKeys;
  pb.n_mine = pb.q0 < Nq ? min(pb.n_tiles, (blk_keys + kDqKeys - 1) / kDqKeys) : 0;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kSt; ++st) {
      mbar_init(sm.full + st, 1);  // the producer's arrival; bytes from both blocks
      mbar_init(sm.empty + st, kReleases);
    }
    mbar_init_fence();
  }
  cluster_sync();  // the barriers of both blocks exist before any load or remote arrival

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      tma_prefetch(&tm_ds);
      tma_prefetch(&tm_k);
      dq_produce<D>(sm, pb, &tm_ds, &tm_k);
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    if (wg == 1)
      dq_consume<D, 0>(sm, pb, Nq, dq);
    else
      dq_consume<D, 1>(sm, pb, Nq, dq);
  }
}

// --------------------------------------------------------------- launch
template <int D>
int backward(const void* q, const void* k, const void* v, const void* pad, const void* o, const void* lse,
             const void* dout, void* delta, void* ws, void* ds, void* dq, void* dk, void* dv, int B, int H, int Nq,
             int Nk, int causal, int splits, cudaStream_t stream) {
  constexpr size_t smem_kv = dkdv_smem_bytes<D>(), smem_q = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_wide_dkdv_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_wide_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_q);
  if (err != cudaSuccess) return (int)err;
  const uint64_t bh = (uint64_t)B * H;
  const int q_tiles = (Nq + kDkdvCols - 1) / kDkdvCols;
  // dK/dV: Q and dO in multicast halves of a query tile, K and V in the block's keys, dS^T
  // out by (64 queries, 32 keys) boxes; dQ: dS^T in by the same boxes, K in multicast halves
  CUtensorMap kv_q, kv_o, kv_k, kv_v, ds_t, q_k;
  if (!bf16_rows_map(&kv_q, q, bh, Nq, D, kDkdvCols / 2) || !bf16_rows_map(&kv_o, dout, bh, Nq, D, kDkdvCols / 2) ||
      !bf16_rows_map(&kv_k, k, bh, Nk, D, kDkdvKeys) || !bf16_rows_map(&kv_v, v, bh, Nk, D, kDkdvKeys) ||
      !bf16_rows_map(&ds_t, ds, 2 * bh, Nk, (uint64_t)q_tiles * kDkdvCols, kDkdvKeys) ||
      !bf16_rows_map(&q_k, k, bh, Nk, D, kDqKeys / 2))
    return (int)cudaErrorNotSupported;  // the driver refused a tensor map
  const uint8_t* tpad = static_cast<const uint8_t*>(pad);
  const float* tlse = static_cast<const float*>(lse);
  float* tdelta = static_cast<float*>(delta);
  const int BH = B * H;
  err = launch_delta<D>(static_cast<const float*>(o), static_cast<const bf16*>(dout), tdelta, BH * Nq, stream);
  if (err != cudaSuccess) return (int)err;
  const int key_tiles = (Nk + kDkdvKeys - 1) / kDkdvKeys;
  const int split_len = (q_tiles + splits - 1) / splits * kDkdvCols;
  float* ws_k = static_cast<float*>(ws);
  float* ws_v = ws_k + (size_t)BH * splits * Nk * D;
  const dim3 grid_kv(kClusterBlocks * ((key_tiles + kClusterBlocks - 1) / kClusterBlocks), splits, BH);
  flash_bwd_wide_dkdv_kernel<D><<<grid_kv, kBlockThreads, smem_kv, stream>>>(
      kv_q, kv_o, kv_k, kv_v, ds_t, tpad, tlse, tdelta, ws_k, ws_v, H, Nq, Nk, causal, split_len);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t total4 = (size_t)BH * Nk * D / 4;
  flash_bwd_wide_reduce_kernel<<<(unsigned)((total4 + 255) / 256), 256, 0, stream>>>(
      ws_k, ws_v, tpad, static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Nk, D, splits, total4);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_q(kClusterBlocks * ((q_tiles + kClusterBlocks - 1) / kClusterBlocks), BH);
  flash_bwd_wide_dq_kernel<D><<<grid_q, kBlockThreads, smem_q, stream>>>(ds_t, q_k, static_cast<bf16*>(dq), Nq, Nk,
                                                                        causal);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. q, k, v, dout bfloat16 (16-byte
// aligned, contiguous); o, lse float32; delta (B, H, Nq) float32 scratch; ws
// 2 x B x H x splits x Nk x D float32 scratch; ds 2 x B x H x Nk x Nq64
// bfloat16 scratch (Nq64: Nq rounded up to a multiple of 64); dq, dk, dv bfloat16; D: 192,
// 256, 320, 384, 448 or 512; pad: (B, Nk) uint8 or null; splits: the dK/dV
// pass's query splits (1 to 65535). The Python wrapper checks every
// pointer, shape and type and allocates every output and the scratch.
// Returns cudaGetLastError() after the launches (0 = launched),
// cudaErrorNotSupported if the driver refused a tensor map.
extern "C" int flash_backward_wide(const void* q, const void* k, const void* v, const void* pad, const void* o,
                                   const void* lse, const void* dout, void* delta, void* ws, void* ds, void* dq,
                                   void* dk, void* dv, int B, int H, int Nq, int Nk, int D, int causal, int splits,
                                   void* stream) {
  if (B < 1 || H < 1 || Nq < 1 || Nk < 1 || B * H > 65535 || splits < 1 || splits > 65535)
    return (int)cudaErrorInvalidValue;
  (void)cudaGetLastError();  // clear a stale error so the one returned is this launch's
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 192: return backward<192>(q, k, v, pad, o, lse, dout, delta, ws, ds, dq, dk, dv, B, H, Nq, Nk, causal, splits, s);
    case 256: return backward<256>(q, k, v, pad, o, lse, dout, delta, ws, ds, dq, dk, dv, B, H, Nq, Nk, causal, splits, s);
    case 320: return backward<320>(q, k, v, pad, o, lse, dout, delta, ws, ds, dq, dk, dv, B, H, Nq, Nk, causal, splits, s);
    case 384: return backward<384>(q, k, v, pad, o, lse, dout, delta, ws, ds, dq, dk, dv, B, H, Nq, Nk, causal, splits, s);
    case 448: return backward<448>(q, k, v, pad, o, lse, dout, delta, ws, ds, dq, dk, dv, B, H, Nq, Nk, causal, splits, s);
    case 512: return backward<512>(q, k, v, pad, o, lse, dout, delta, ws, ds, dq, dk, dv, B, H, Nq, Nk, causal, splits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
