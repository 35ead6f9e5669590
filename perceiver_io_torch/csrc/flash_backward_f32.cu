// Flash attention backward in float32 on Hopper (sm_90a), every head width
// D = 64, 128, ..., 512: kernel B1b for float32 inputs.
//
// Replaces the backward of perceiver_io_tpu/ops/flash.py:splash_mha (the
// Pallas splash dK/dV and dQ kernels under its custom VJP, built by
// `_build_kernel` via `make_splash_mha`) for float32 inputs. Function and
// layouts (as ops/flash.py:_backward_plain computes it):
//   q, dout (B, H, Nq, D)  float32, q already scaled and rotated
//   k, v    (B, H, Nk, D)  float32
//   pad     (B, Nk)        uint8, 1 = padding key (the splash segment id 0), or null
//   o, lse  the forward's float32 output (B, H, Nq, D) and log-sum-exp (B, H, Nq)
//   dq, dk, dv             float32, the shapes of q, k and v
// P = exp(Q K^T - lse) over the visible pairs, delta = rowsum(dO * O) from the
// float32 O, dS = P * (dO V^T - delta), dQ = dS K, dK = dS^T Q, dV = P^T dO.
// Causal is right-aligned (query i sees key j iff j <= Nk - Nq + i); pad keys
// get exact-zero dK and dV; a query with lse = -inf gets zero gradients; Nq
// and Nk are any sizes. No atomics: two runs give the same bits.
//
// What bounds it on an H100: 10 D flops a visible (query, key) pair (S, dP,
// dV, dK, dQ: five products of 2 D) against O(D) bytes a row, so the rate of
// float32-class products. The tensor cores have no float32 product, but three
// TF32 products give float32-class sums (x = hi + lo, both TF32 by cvt.rna;
// a b ~ lo_a hi_b + hi_a lo_b + hi_a hi_b): 495 / 3 = 165 TFLOP/s, against 67
// on the CUDA cores. At the optical-flow decoder's patch (182,528 queries over
// 2,048 keys, D 512) that floor is 11.60 ms (28.57 ms on the CUDA cores).
//
// The design (the five products, and which operand each takes from where):
// tf32 wgmma takes both shared-memory operands K-major and has no transpose
// bit; A may come from registers, loaded by each thread in any order. So Q
// and dO, the large tensors, are only ever A operands, loaded by TMA as
// float32 boxes and split into hi and lo in registers (no TF32 copy of them
// is written), and every B operand is a TF32 pair in shared memory:
//   * S = Q K^T and dP = dO V^T (M = queries, N = keys, contraction over D):
//     A = Q or dO read row by row, B = K or V as hi and lo terms, written by a
//     pre-pass (flash_bwd_f32_split_kernel) with every 8-group of channels
//     reordered 0, 2, 4, 6, 1, 3, 5, 7, so that a thread reads its A fragment
//     of a k = 8 slice as one 8-byte load a row (as flash_forward_f32.cu);
//   * dV^T = dO^T P and dK^T = Q^T dS (M = channels, N = keys, contraction
//     over queries): A = dO or Q read transposed from the same float32 boxes,
//     B = P^T and dS^T as hi and lo terms, which the consumers write to
//     shared memory themselves (128-byte swizzle, then fence.proxy.async);
//   * dQ = dS K (M = queries, N = channels, contraction over keys), in a pass
//     of its own: A = dS, which the dK/dV pass writes once in float32 to a
//     scratch (4 bytes a pair: 1.5 GB at the flow decoder's patch) and TMA
//     brings back, split in registers; B = K^T as hi and lo terms, its keys
//     reordered by 8-group so that the A fragment is again one 8-byte load.
// Shared memory, not the products, sets the tiles: K and V of 32 keys x 512
// channels as hi and lo terms are 256 KB, Q and dO of 64 rows at D 512 as
// much again, past the 232,448 bytes a block may have. So nothing is
// resident: everything streams through one ring of 16 KB slots, each a
// 128-byte box of 32 channels (Q and dO: 128 query rows in float32; K and V:
// the block's keys as hi and lo terms), and each query tile takes two sweeps:
//   sweep 1, per 32-channel box b: Q_b, K_b: S; then P (masked, rows with
//   lse = -inf zero), whose hi and lo terms go to shared memory as P^T and
//   are all that is kept of it (a named barrier of both consumers first);
//   then per box dO_b, V_b: dP; dS = (hi + lo) (dP - delta) to the scratch,
//   and its terms to shared memory as dS^T (then the barrier again);
//   sweep 2, per 64-channel m-tile j: dO_2j, dO_2j+1, Q_2j, Q_2j+1: consumer
//   0 computes dV^T's m-tile j, consumer 1 dK^T's.
// Q and dO are therefore read twice a tile from L2, K and V once; at 128
// queries a tile and 64 keys a block (32 above D 128) that is 48 bytes a
// visible pair at D 128 and 320 at D 512.
//   * dK/dV pass grid: (key blocks, query splits, batch*head). Each block
//     owns a key block (64 keys up to D 128, 32 above: the running dK^T and
//     dV^T of 64 keys x 512 channels would be 256 registers a thread) and
//     walks the 128-query tiles from the first one that sees its first key;
//     `splits` blocks share that range (enough blocks for the card when the
//     heads and key blocks are few, as at the flow decoder's 64 key blocks),
//     each writing float32 partials that a reduce kernel adds in split order.
//     384 threads: a producer warpgroup (setmaxnreg 24; one thread issues
//     every TMA load) and two consumer warpgroups (240), each owning 64 of
//     the tile's rows for S and dP, and all of dV^T (consumer 0) or dK^T
//     (consumer 1) over the tile's 128 queries;
//   * dQ pass grid: (128-query tiles, column parts, batch*head); each
//     consumer owns 64 of the tile's rows and every column of the block's
//     part of D (all of it up to D 256, half above: its running sums stay
//     within 128 registers); per live 32-key tile one dS box and the part's
//     K^T boxes (hi and lo) stream through a ring of 16 KB slots, each K^T
//     box serving 128 rows (64 rows a block, one part, streamed K^T 4 x as
//     often and took 6.1 of the flow decoder's 52 ms);
//   * fresh accumulators: the tensor cores truncate their float32 sums, and
//     over a long chain of products that error grows to several times the
//     plain float32 version's (PERF.md §6). So S and dP take a fresh
//     accumulator (wgmma's scale-d off) every 16 channels (an error in S
//     moves dS by |dP - delta| ~ sqrt(D) times as much), dV^T and dK^T every
//     kChainQueries queries, and dQ every 32-key tile; each is added to the
//     running sums in registers, rounded, once its products have completed
//     (the CPU emulation of this arithmetic: tests/test_torch_flash.py);
//   * ptxas's rules (flash_forward_f32.cu): every wait on a full barrier is a
//     loop on a warp-uniform vote (hopper.cuh's mbar_wait_warp), the wgmma
//     fence comes after it, and the A fragments rotate through two register
//     sets, each k = 8 slice its own commit group that waits only for the one
//     before it, so no instruction writes a register that a wgmma in flight
//     reads;
//   * a slot read by the threads (the A operands) is released by one arrival
//     a consumer warp, after its reads.
// Work: the dK/dV pass executes 8 D flops (times three TF32 products) a pair
// of every 128-query x key-block tile it visits, the dQ pass 2 D a pair of
// every 128 x 32 tile: 10 D a pair, the count of the bound, apart from the
// masked pairs of the tiles on the causal diagonal and the ragged edges;
// the pre-pass, delta and the reduce are O((Nq + Nk) D).
//
// Tiles and shared memory per width (bytes = 1024 of alignment slack + P^T
// and dS^T as hi and lo terms (dK/dV) + the ring's slots + mbarriers), and
// consumer 0's float32 accumulators a thread in the dK/dV pass at its peak,
// sweep 1 (dV^T's m-tiles + S or dP + a box's own), and its register sets of
// A fragments (two, or one at D 448-512, of 8 registers):
//   D 64: 64-key blocks, 6 slots, 230,496 bytes, 32 + 32 + 32 accumulators, 2 A sets; dQ 13 slots, 214,224 bytes
//   D 128: 64-key blocks, 6 slots, 230,496 bytes, 64 + 32 + 32 accumulators, 2 A sets; dQ 13 slots, 214,224 bytes
//   D 192: 32-key blocks, 10 slots, 230,560 bytes, 48 + 16 + 16 accumulators, 2 A sets; dQ 13 slots, 214,224 bytes
//   D 256: 32-key blocks, 10 slots, 230,560 bytes, 64 + 16 + 16 accumulators, 2 A sets; dQ 13 slots, 214,224 bytes
//   D 320: 32-key blocks, 10 slots, 230,560 bytes, 80 + 16 + 16 accumulators, 2 A sets; dQ 13 slots, 214,224 bytes
//   D 384: 32-key blocks, 10 slots, 230,560 bytes, 96 + 16 + 16 accumulators, 2 A sets; dQ 13 slots, 214,224 bytes
//   D 448: 32-key blocks, 10 slots, 230,560 bytes, 112 + 16 + 16 accumulators, 1 A set; dQ 13 slots, 214,224 bytes
//   D 512: 32-key blocks, 10 slots, 230,560 bytes, 128 + 16 + 16 accumulators, 1 A set; dQ 13 slots, 214,224 bytes
// (of the 232,448 bytes a block may have; a dQ consumer holds D / 2 (D 64-256)
// or D / 4 running sums, a box's own 16 and dS's 4 slices of A fragments).

#include "hopper.cuh"

// Parts switched off for perceiver_io_torch/profile_wide_backward.py's float32
// mode (wrong values, timing only); 0 in the port's builds.
#ifndef B1B_F32_OFF
#define B1B_F32_OFF 0
#endif

namespace {

using namespace hopper;

constexpr unsigned kOff = B1B_F32_OFF;
constexpr unsigned kOffLoads = 1;     // only the rings' first fill is loaded
constexpr unsigned kOffScores = 2;    // no S = Q K^T and dP = dO V^T products
constexpr unsigned kOffProducts = 4;  // no dV^T = dO^T P, dK^T = Q^T dS and dQ = dS K products
constexpr unsigned kOffSplit = 8;     // one TF32 term a product (hi hi) instead of three
constexpr unsigned kOffALoads = 16;   // the dK/dV pass's A fragments split from constants, not loaded

constexpr int kThreads = 3 * 128;  // the producer warpgroup, then the two consumers
constexpr int kProducerRegs = 24;  // setmaxnreg: 128 x 24 + 256 x 240 <= 65,536
constexpr int kConsumerRegs = 240;
constexpr int kBox = 32;             // float32 channels (or keys) of one 128-byte box row
constexpr int kQTile = 128;          // dK/dV pass: query rows a tile, 64 a consumer
constexpr int kChainQueries = 32;    // dK/dV pass: queries a fresh dV^T / dK^T accumulator sums
constexpr int kScoreSlices = 2;      // S and dP: k = 8 slices (16 channels) a fresh accumulator sums
constexpr int kSlot = 16384;         // dK/dV pass: bytes of a ring slot (one Q or dO box of kQTile rows)
constexpr int kDqRows = 128;         // dQ pass: query rows a block, 64 a consumer
constexpr int kDqKeys = 32;          // dQ pass: keys a tile
constexpr int kDqSlot = 16384;       // dQ pass: bytes of a ring slot (a dS box, or a K^T box as hi and lo)
constexpr int kDqStages = 13;        // dQ pass: slots in its ring
constexpr int kWarpArrivals = 8;     // a slot is released by each consumer warp
constexpr int kPdsBarrier = 1;       // named barrier of the two consumer warpgroups

// Keys a dK/dV block.
template <int D>
__host__ __device__ constexpr int key_block() {
  return D <= 128 ? 64 : 32;
}

// Slots in the dK/dV ring.
template <int D>
__host__ __device__ constexpr int dkdv_stages() {
  return D <= 128 ? 6 : 10;
}

// P^T and dS^T, each as hi and lo terms.
template <int D>
__host__ __device__ constexpr int pds_bytes() {
  return 4 * key_block<D>() * kQTile * sizeof(float);
}

template <int D>
__host__ __device__ constexpr size_t dkdv_smem() {
  return 1024 + pds_bytes<D>() + dkdv_stages<D>() * kSlot + sizeof(uint64_t) * 2 * dkdv_stages<D>();
}

// The dQ pass's blocks a query tile: each takes D / dq_parts output columns
// for both consumers' rows (its running sums, D / (2 dq_parts) registers a
// thread, at most 128).
template <int D>
__host__ __device__ constexpr int dq_parts() {
  return D > 256 ? 2 : 1;
}

__host__ __device__ constexpr size_t dq_smem() {
  return 1024 + kDqStages * kDqSlot + sizeof(uint64_t) * 2 * kDqStages;
}

// A ring of kStages slots of kBytes, with its full and empty barriers; slab n
// (the n-th the producer issues) lives in slot n % kStages.
template <int kStages, int kBytes>
struct Ring {
  unsigned char* slots;  // 1024-byte aligned
  uint64_t* bars;        // [full x kStages][empty x kStages]
  __device__ __forceinline__ unsigned char* slot(int n) const { return slots + (n % kStages) * kBytes; }
  __device__ __forceinline__ uint64_t* full(int n) const { return bars + n % kStages; }
  __device__ __forceinline__ uint64_t* empty(int n) const { return bars + kStages + n % kStages; }
  // a consumer warp waits until slab n has landed
  __device__ __forceinline__ void wait(int n) const { mbar_wait_warp(full(n), (n / kStages) & 1); }
  // a consumer warp is done with slab n (its reads and its wgmma have completed)
  __device__ __forceinline__ void release(int n, int lane) const {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(n));
  }
  // the producer: slab n's slot is free again; it expects `bytes`
  // (true: load it; false: under kOffLoads a stale slot stands in)
  __device__ __forceinline__ bool acquire(int n, uint32_t bytes) const {
    mbar_wait(empty(n), ((n / kStages) & 1) ^ 1);
    const bool load = !((kOff & kOffLoads) && n >= kStages);
    mbar_arrive_expect_tx(full(n), load ? bytes : 0);
    return load;
  }
  __device__ __forceinline__ void init() const {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bars + st, 1);                       // the producer's arrival, with the bytes
      mbar_init(bars + kStages + st, kWarpArrivals);  // every consumer warp
    }
  }
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// The three TF32 products of one k = 8 slice into d: lo_a hi_b, hi_a lo_b,
// hi_a hi_b (one, hi hi, under kOffSplit); with fresh, the first overwrites d.
template <int N, int R>
__device__ __forceinline__ void mma3(float (&d)[R], const uint32_t (&hi)[4], const uint32_t (&lo)[4], uint64_t b_hi,
                                     uint64_t b_lo, bool fresh) {
  if constexpr (!(kOff & kOffSplit)) {
    WgmmaTf32<N>::rs(d, lo, b_hi, !fresh);
    WgmmaTf32<N>::rs(d, hi, b_lo);
    WgmmaTf32<N>::rs(d, hi, b_hi);
  } else {
    WgmmaTf32<N>::rs(d, hi, b_hi, !fresh);
  }
}

// A thread's A fragment of k = 8 slice kk from a float32 box (rows of 128
// bytes, 128-byte swizzle) whose columns pair with a B operand reordered by
// 8-group: rows row and row + 8 (row % 8 = g), columns 8 kk + 2 t4 and
// 8 kk + 2 t4 + 1 (one 8-byte load a row), split into hi and lo (finite
// inputs: as cvt.rna rounds them).
__device__ __forceinline__ void load_a_rows(const unsigned char* box, int row, int kk, int g, int t4,
                                            uint32_t (&a)[2][4]) {
  const unsigned char* at = box + row * 128 + (t4 & 1) * 8 + (((2 * kk + (t4 >> 1)) ^ g) << 4);
  const float2 x0 = *reinterpret_cast<const float2*>(at);
  const float2 x1 = *reinterpret_cast<const float2*>(at + 8 * 128);
  split_tf32_finite(x0.x, a[0][0], a[1][0]);
  split_tf32_finite(x1.x, a[0][1], a[1][1]);
  split_tf32_finite(x0.y, a[0][2], a[1][2]);
  split_tf32_finite(x1.y, a[0][3], a[1][3]);
}

// Pins A fragments in place once split: the compiler may not sink their
// integer split past a later barrier wait, where the fence it then inserts
// for the wgmma that reads them lies in a divergent path (ptxas serialised
// every wgmma of the dQ pass for it).
template <int S>
__device__ __forceinline__ void pin_a(uint32_t (&a)[S][2][4]) {
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[s][t][e])::"memory");
}

// Element (row, column c) of a float32 box (rows of 128 bytes, 128-byte swizzle).
__device__ __forceinline__ float box_at(const unsigned char* box, int row, int c) {
  return *reinterpret_cast<const float*>(box + row * 128 + (((c >> 2) ^ (row & 7)) << 4) + (c & 3) * 4);
}

// ================================================================ dK/dV pass
struct DkdvProblem {
  int bh, k0, Nq, Nk, Nk4, off, causal;
  int t_lo, t_hi;  // the query tiles of this block's split
};

// Register sets of A fragments in rotation (1: each k = 8 slice waits for
// the one before it): at D 448-512 the running dK^T (or dV^T) sums take
// 112-128 registers a thread, and two sets spilled.
template <int D>
__host__ __device__ constexpr int a_sets() {
  return D >= 448 ? 1 : 2;
}

// Slice kk's products are committed: wait until those of the slices before
// the register set it will reuse have completed (all, with one set).
template <int kSets>
__device__ __forceinline__ void wait_for_set() {
  wgmma_wait<kSets - 1>();
}

// Slice kk of a run of k = 8 slices, chains of kChain slices each into a
// fresh accumulator `part`, is committed: at a chain's end wait for its
// products and add them to out, rounded; else wait for what the next slice's
// register set needs.
template <int kChain, int kSets, bool kOn, int R>
__device__ __forceinline__ void chain_step(int kk, float (&out)[R], float (&part)[R]) {
  if ((kk + 1) % kChain == 0) {
    wgmma_wait<0>();
    fence_regs(part);
    if constexpr (kOn) {
#pragma unroll
      for (int i = 0; i < R; ++i) out[i] += part[i];
    }
  } else {
    wait_for_set<kSets>();
  }
}

// One 32-channel box of a score product into out (S = Q K^T or dP = dO V^T
// over this consumer's 64 rows): slab na holds the A side (the box of Q or dO,
// kQTile rows), nb the B side (the box of K or V as hi and lo terms). Four
// k = 8 slices, each loaded and split into the next of a_sets register sets,
// its own commit group. Each kScoreSlices slices' three terms go to a fresh
// accumulator that is added to out, rounded, once they have completed. Then
// both slabs are released. (An error in S moves dS by |dP - delta| ~
// sqrt(D) times as much, so S and dP take short chains of truncated sums.)
template <int D, typename R>
__device__ __forceinline__ void score_box(const R& ring, int na, int nb, float (&out)[key_block<D>() / 2], int row,
                                          int g, int t4, int lane) {
  constexpr int BK = key_block<D>(), kSets = a_sets<D>();
  float part[BK / 2];
  uint32_t a[kSets][2][4];  // [register set][hi, lo][a0..a3]
  ring.wait(na);
  ring.wait(nb);
  const unsigned char* abox = ring.slot(na);
  const unsigned char* bbox = ring.slot(nb);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (!(kOff & kOffALoads)) {
      load_a_rows(abox, row, kk, g, t4, a[kk % kSets]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(float(kk + e + row), a[kk % kSets][0][e], a[kk % kSets][1][e]);
    }
    if constexpr (!(kOff & kOffScores)) {
      wgmma_fence();
      const uint64_t b_hi = wgmma_desc(bbox + kk * 32, 16, 1024);
      mma3<BK>(part, a[kk % kSets][0], a[kk % kSets][1], b_hi, desc_add(b_hi, BK * 128), kk % kScoreSlices == 0);
    }
    wgmma_commit();
    chain_step<kScoreSlices, kSets, !(kOff & kOffScores)>(kk, out, part);
  }
  ring.release(na, lane);
  ring.release(nb, lane);
}

// m-tile j of dV^T = dO^T P (or dK^T = Q^T dS) over the tile's kQTile
// queries into acc: the A side is read transposed from the two float32 boxes
// of channels 64 j .. 64 j + 63 (slabs n0, n0 + 1: warps 0-1 read the first,
// 2-3 the second), the B side is P^T (or dS^T) as hi and lo terms in shared
// memory (pds_hi, pds_lo: kQTile / 32 boxes of 32 queries x BK key rows).
// Every kChainQueries queries go to a fresh accumulator added to acc, rounded.
template <int D, typename R>
__device__ __forceinline__ void transposed_products(const R& ring, int n0, const unsigned char* pds_hi,
                                                    const unsigned char* pds_lo, float (&acc)[key_block<D>() / 2],
                                                    int warp, int g, int t4, int lane) {
  constexpr int BK = key_block<D>(), kChain = kChainQueries / 8, kSets = a_sets<D>();
  ring.wait(n0);
  ring.wait(n0 + 1);
  const unsigned char* box = ring.slot(warp < 2 ? n0 : n0 + 1);
  const int c = 16 * (warp & 1) + g;  // the channel of A's rows g; rows g + 8: c + 8
  float part[BK / 2];
  uint32_t a[kSets][2][4];
#pragma unroll
  for (int kk = 0; kk < kQTile / 8; ++kk) {
    uint32_t(&x)[2][4] = a[kk % kSets];
    const int q = 8 * kk + t4;  // A's columns t4 and t4 + 4: queries q and q + 4
    if constexpr (!(kOff & kOffALoads)) {
      split_tf32_finite(box_at(box, q, c), x[0][0], x[1][0]);
      split_tf32_finite(box_at(box, q, c + 8), x[0][1], x[1][1]);
      split_tf32_finite(box_at(box, q + 4, c), x[0][2], x[1][2]);
      split_tf32_finite(box_at(box, q + 4, c + 8), x[0][3], x[1][3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(float(q + e + c), x[0][e], x[1][e]);
    }
    if constexpr (!(kOff & kOffProducts)) {
      wgmma_fence();
      const int at = (kk / 4) * BK * 128 + (kk % 4) * 32;
      mma3<BK>(part, x[0], x[1], wgmma_desc(pds_hi + at, 16, 1024), wgmma_desc(pds_lo + at, 16, 1024),
               kk % kChain == 0);
    }
    wgmma_commit();
    chain_step<kChain, kSets, !(kOff & kOffProducts)>(kk, acc, part);
  }
  ring.release(n0, lane);
  ring.release(n0 + 1, lane);
}

// The producer (one thread): per query tile, sweep 1's Q_b, K_b for every
// 32-channel box b, then its dO_b, V_b, then sweep 2's dO_2j, dO_2j+1, Q_2j,
// Q_2j+1 for every 64-channel m-tile j.
template <int D, typename R>
__device__ __forceinline__ void produce_dkdv(const R& ring, const DkdvProblem& pb, const CUtensorMap* tm_q,
                                             const CUtensorMap* tm_do, const CUtensorMap* tm_k,
                                             const CUtensorMap* tm_v, int BH) {
  constexpr int BK = key_block<D>();
  int n = 0;
  auto rows = [&](const CUtensorMap* tm, int b, int q0) {  // a Q or dO box: kQTile rows x 32 channels
    if (ring.acquire(n, kQTile * 128)) tma_load_3d(ring.slot(n), tm, ring.full(n), kBox * b, q0, pb.bh);
    ++n;
  };
  auto keys = [&](const CUtensorMap* tm, int b) {  // a K or V box: the block's keys as hi and lo terms
    if (ring.acquire(n, 2 * BK * 128)) {
      tma_load_3d(ring.slot(n), tm, ring.full(n), kBox * b, pb.k0, pb.bh);
      tma_load_3d(ring.slot(n) + BK * 128, tm, ring.full(n), kBox * b, pb.k0, BH + pb.bh);
    }
    ++n;
  };
#pragma unroll 1
  for (int t = pb.t_lo; t < pb.t_hi; ++t) {
    const int q0 = t * kQTile;
#pragma unroll 1
    for (int b = 0; b < D / kBox; ++b) {
      rows(tm_q, b, q0);
      keys(tm_k, b);
    }
#pragma unroll 1
    for (int b = 0; b < D / kBox; ++b) {
      rows(tm_do, b, q0);
      keys(tm_v, b);
    }
#pragma unroll 1
    for (int j = 0; j < D / 64; ++j) {
      rows(tm_do, 2 * j, q0);
      rows(tm_do, 2 * j + 1, q0);
      rows(tm_q, 2 * j, q0);
      rows(tm_q, 2 * j + 1, q0);
    }
  }
}

// Where element i of a score accumulator (rows row + 8 r, keys 8 j + 2 t4 + e,
// i = 4 j + 2 r + e) lies in a term of P^T or dS^T: key rows of 32-query
// boxes, 128-byte swizzle.
template <int BK>
__device__ __forceinline__ int term_at(int i, int row, int t4) {
  const int ql = row + 8 * ((i / 2) % 2), key = 8 * (i / 4) + 2 * t4 + i % 2;
  return (ql / 32) * BK * 128 + key * 128 + ((((ql % 32) >> 2) ^ (key & 7)) << 4) + (ql & 3) * 4;
}

// Consumer C (rows 64 C .. 64 C + 63 of each tile for S and dP; dV^T for C 0,
// dK^T for C 1): every tile of the split, then its partial dV (or dK) out,
// (key, channel) rows, pad keys exact zeros. A tile: S, then P (kept only as
// its hi and lo terms in shared memory, so that S's registers are free for
// dP), then dP and dS = (hi + lo) (dP - delta), then sweep 2.
template <int D, int C, typename R>
__device__ __forceinline__ void consume_dkdv(const R& ring, unsigned char* pds, const DkdvProblem& pb,
                                             const uint8_t* __restrict__ pad_row, const float* __restrict__ lse,
                                             const float* __restrict__ delta, float* __restrict__ ds,
                                             float* __restrict__ out) {
  constexpr int BK = key_block<D>(), kM = D / 64;
  constexpr int kTerm = BK * kQTile * sizeof(float);  // bytes of one term of P^T or dS^T
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int row = 64 * C + 16 * warp + g;  // this thread's rows row and row + 8 of a tile
  float acc[kM][BK / 2];
#pragma unroll
  for (int j = 0; j < kM; ++j)
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) acc[j][i] = 0.f;

  int n = 0;
#pragma unroll 1
  for (int t = pb.t_lo; t < pb.t_hi; ++t) {
    const int q0 = t * kQTile;
    {  // S, then P^T as hi and lo terms; both consumers' last tile's products have completed before the stores
      float s[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
#pragma unroll 1
      for (int b = 0; b < D / kBox; ++b, n += 2) score_box<D>(ring, n, n + 1, s, row, g, t4, lane);
      float l[2];  // the rows' lse (0 for a row past Nq or one that sees no key: its P is 0)
      bool row_ok[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int q = q0 + row + 8 * r;
        const float x = q < pb.Nq ? lse[(size_t)pb.bh * pb.Nq + q] : -INFINITY;
        row_ok[r] = x != -INFINITY;
        l[r] = row_ok[r] ? x : 0.f;
      }
      named_sync(kPdsBarrier, 256);
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int key = pb.k0 + 8 * (i / 4) + 2 * t4 + i % 2, r = (i / 2) % 2;
        const bool vis = key < pb.Nk && !(pad_row && pad_row[key]) && row_ok[r] &&
                         (!pb.causal || key <= pb.off + q0 + row + 8 * r);
        uint32_t hi, lo;
        split_tf32(vis ? expf(s[i] - l[r]) : 0.f, hi, lo);
        const int at = term_at<BK>(i, row, t4);
        *reinterpret_cast<uint32_t*>(pds + at) = hi;
        *reinterpret_cast<uint32_t*>(pds + kTerm + at) = lo;
      }
    }
    {  // dP, dS = P (dP - delta) with P = hi + lo as stored; dS to the scratch the dQ pass reads, dS^T as terms
      float dp[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) dp[i] = 0.f;
#pragma unroll 1
      for (int b = 0; b < D / kBox; ++b, n += 2) score_box<D>(ring, n, n + 1, dp, row, g, t4, lane);
      float dl[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int q = q0 + row + 8 * r;
        dl[r] = q < pb.Nq ? delta[(size_t)pb.bh * pb.Nq + q] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int at = term_at<BK>(i, row, t4);
        const float p = __uint_as_float(*reinterpret_cast<const uint32_t*>(pds + at)) +
                        __uint_as_float(*reinterpret_cast<const uint32_t*>(pds + kTerm + at));
        dp[i] = p * (dp[i] - dl[(i / 2) % 2]);
        uint32_t hi, lo;
        split_tf32(dp[i], hi, lo);
        *reinterpret_cast<uint32_t*>(pds + 2 * kTerm + at) = hi;
        *reinterpret_cast<uint32_t*>(pds + 3 * kTerm + at) = lo;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int q = q0 + row + 8 * r;
        if (q >= pb.Nq) continue;
        float* ds_row = ds + ((size_t)pb.bh * pb.Nq + q) * pb.Nk4;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          const int key = pb.k0 + 8 * j + 2 * t4;
          if (key < pb.Nk4)
            *reinterpret_cast<float2*>(ds_row + key) = make_float2(dp[4 * j + 2 * r], dp[4 * j + 2 * r + 1]);
        }
      }
    }
    fence_async_shared();
    named_sync(kPdsBarrier, 256);
    // sweep 2: per m-tile, slabs dO_2j, dO_2j+1, Q_2j, Q_2j+1
    const unsigned char* b_hi = pds + (C == 0 ? 0 : 2 * kTerm);
#pragma unroll
    for (int j = 0; j < kM; ++j, n += 4) {
      if constexpr (C == 0) {
        transposed_products<D>(ring, n, b_hi, b_hi + kTerm, acc[j], warp, g, t4, lane);
        ring.wait(n + 2);
        ring.wait(n + 3);
        ring.release(n + 2, lane);
        ring.release(n + 3, lane);
      } else {
        ring.wait(n);
        ring.wait(n + 1);
        ring.release(n, lane);
        ring.release(n + 1, lane);
        transposed_products<D>(ring, n + 2, b_hi, b_hi + kTerm, acc[j], warp, g, t4, lane);
      }
    }
  }

  // (key, channel) out: acc[j]'s rows are channels 64 j + 16 warp + g (+ 8), its columns the block's keys
#pragma unroll
  for (int j = 0; j < kM; ++j) {
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = pb.k0 + 8 * i + 2 * t4 + e;
        if (key >= pb.Nk) continue;
        const bool ok = !(pad_row && pad_row[key]);
        float* at = out + ((size_t)pb.bh * pb.Nk + key) * D + 64 * j + 16 * warp + g;
        at[0] = ok ? acc[j][4 * i + e] : 0.f;
        at[8] = ok ? acc[j][4 * i + 2 + e] : 0.f;
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_f32_dkdv_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
                              const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                              const uint8_t* __restrict__ pad, const float* __restrict__ lse,
                              const float* __restrict__ delta, float* __restrict__ ds, float* __restrict__ dk,
                              float* __restrict__ dv, int H, int Nq, int Nk, int causal) {
  constexpr int BK = key_block<D>(), kStages = dkdv_stages<D>();
  static_assert(D % 64 == 0 && D >= 64 && D <= 512, "D must be a multiple of 64 in 64..512");
  static_assert(dkdv_smem<D>() <= 232448, "the dK/dV pass must fit in 227 KB of shared memory");
  using R = Ring<kStages, kSlot>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  unsigned char* pds = base;
  const R ring{base + pds_bytes<D>(), reinterpret_cast<uint64_t*>(base + pds_bytes<D>() + kStages * kSlot)};

  DkdvProblem pb;
  pb.bh = blockIdx.z;
  pb.k0 = blockIdx.x * BK;
  pb.Nq = Nq;
  pb.Nk = Nk;
  pb.Nk4 = (Nk + 3) / 4 * 4;
  pb.off = Nk - Nq;
  pb.causal = causal;
  const uint8_t* pad_row = pad ? pad + (size_t)(pb.bh / H) * Nk : nullptr;
  // the block's keys: some in range, not padding, and seen by some query
  bool any = false;
  for (int e = threadIdx.x % 32; e < BK; e += 32) {
    const int key = pb.k0 + e;
    any |= key < Nk && !(pad_row && pad_row[key]);
  }
  const bool live = __any_sync(0xffffffffu, any) && (!causal || pb.k0 <= pb.off + Nq - 1);
  const int t_begin = causal ? max(0, pb.k0 - pb.off) / kQTile : 0;
  const int n_tiles = live ? (Nq + kQTile - 1) / kQTile - t_begin : 0;
  const int splits = gridDim.y, split = blockIdx.y;
  pb.t_lo = t_begin + (int)((long long)n_tiles * split / splits);
  pb.t_hi = t_begin + (int)((long long)n_tiles * (split + 1) / splits);
  const size_t part = (size_t)gridDim.z * Nk * D;  // one split's partial of dK (or dV)
  float* out_k = splits == 1 ? dk : dk + (size_t)split * part;  // with splits, dk and dv are the workspace's halves
  float* out_v = splits == 1 ? dv : dv + (size_t)split * part;

  if (threadIdx.x == 0) {
    ring.init();
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      tma_prefetch(&tm_q);
      tma_prefetch(&tm_do);
      tma_prefetch(&tm_k);
      tma_prefetch(&tm_v);
      produce_dkdv<D>(ring, pb, &tm_q, &tm_do, &tm_k, &tm_v, (int)gridDim.z);
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    if (wg == 1)
      consume_dkdv<D, 0>(ring, pds, pb, pad_row, lse, delta, ds, out_v);
    else
      consume_dkdv<D, 1>(ring, pds, pb, pad_row, lse, delta, ds, out_k);
  }
}

// dK and dV = the splits' partial sums (ws: [dK, dV][split][B H][Nk][D]),
// added in split order. Four channels a thread.
__global__ void __launch_bounds__(256) flash_bwd_f32_reduce_kernel(const float* __restrict__ ws,
                                                                   float* __restrict__ dk, float* __restrict__ dv,
                                                                   int splits, size_t part4) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= part4) return;
  const float4* wk = reinterpret_cast<const float4*>(ws) + i;
  const float4* wv = wk + (size_t)splits * part4;
  float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
  for (int s = 0; s < splits; ++s) {
    const float4 a = wk[s * part4], c = wv[s * part4];
    sk.x += a.x, sk.y += a.y, sk.z += a.z, sk.w += a.w;
    sv.x += c.x, sv.y += c.y, sv.z += c.z, sv.w += c.w;
  }
  reinterpret_cast<float4*>(dk)[i] = sk;
  reinterpret_cast<float4*>(dv)[i] = sv;
}

// =================================================================== dQ pass
// The first 32-key tile at or after t with a key that is in range and not
// padding (n_tiles if none), the same to every lane of the calling warp.
__device__ __forceinline__ int next_live(int t, int n_tiles, const uint8_t* __restrict__ pad_row, int Nk, int lane) {
  if (pad_row == nullptr) return t;
  for (; t < n_tiles; ++t) {
    const int key = t * kDqKeys + lane;
    if (__any_sync(0xffffffffu, key < Nk && !pad_row[key])) break;
  }
  return t;
}

struct DqProblem {
  int bh, q0, Nq, n_tiles;
  int box0;  // the block's first 32-column box
};

// The producer warp (lane 0 issues): per live 32-key tile, its dS box
// (kDqRows rows x 32 keys), then the block's K^T boxes (32 channel rows x
// 32 keys, hi and lo).
template <int D, typename R>
__device__ __forceinline__ void produce_dq(const R& ring, const DqProblem& pb, const uint8_t* __restrict__ pad_row,
                                           int Nk, const CUtensorMap* tm_ds, const CUtensorMap* tm_kt, int BH,
                                           int lane) {
  constexpr int kBoxes = D / kBox / dq_parts<D>();
  int n = 0;
  for (int t = next_live(0, pb.n_tiles, pad_row, Nk, lane); t < pb.n_tiles;
       t = next_live(t + 1, pb.n_tiles, pad_row, Nk, lane)) {
#pragma unroll 1
    for (int i = 0; i <= kBoxes; ++i, ++n) {
      if (lane == 0) {
        if (i == 0) {
          if (ring.acquire(n, kDqRows * 128)) tma_load_3d(ring.slot(n), tm_ds, ring.full(n), kDqKeys * t, pb.q0, pb.bh);
        } else if (ring.acquire(n, 2 * kBox * 128)) {
          const int box = pb.box0 + i - 1;
          tma_load_3d(ring.slot(n), tm_kt, ring.full(n), kDqKeys * t, kBox * box, pb.bh);
          tma_load_3d(ring.slot(n) + kBox * 128, tm_kt, ring.full(n), kDqKeys * t, kBox * box, BH + pb.bh);
        }
      }
    }
  }
}

// Consumer C: rows 64 C .. 64 C + 63 of the tile, the block's columns: per
// live tile, dS's A fragments (4 slices, hi and lo) from its box, then for
// each of the block's K^T boxes a fresh accumulator over the tile's 32 keys
// added to its dQ columns, rounded.
template <int D, int C, typename R>
__device__ __forceinline__ void consume_dq(const R& ring, const DqProblem& pb, const uint8_t* __restrict__ pad_row,
                                           int Nk, float* __restrict__ dq) {
  constexpr int kBoxes = D / kBox / dq_parts<D>();
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int row = 64 * C + 16 * warp + g;
  float acc[kBoxes][16];
#pragma unroll
  for (int j = 0; j < kBoxes; ++j)
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[j][i] = 0.f;
  int n = 0;
  for (int t = next_live(0, pb.n_tiles, pad_row, Nk, lane); t < pb.n_tiles;
       t = next_live(t + 1, pb.n_tiles, pad_row, Nk, lane)) {
    uint32_t a[4][2][4];  // dS: [slice][hi, lo][a0..a3]
    ring.wait(n);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) load_a_rows(ring.slot(n), row, kk, g, t4, a[kk]);
    pin_a(a);
    ring.release(n, lane);  // the K^T boxes that follow may take every other slot of the ring
    ++n;
#pragma unroll
    for (int j = 0; j < kBoxes; ++j, ++n) {
      ring.wait(n);
      float part[16];
      if constexpr (!(kOff & kOffProducts)) {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t b_hi = wgmma_desc(ring.slot(n) + kk * 32, 16, 1024);
          mma3<32>(part, a[kk][0], a[kk][1], b_hi, desc_add(b_hi, kBox * 128), kk == 0);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(part);
      if constexpr (!(kOff & kOffProducts)) {
#pragma unroll
        for (int e = 0; e < 16; ++e) acc[j][e] += part[e];
      }
      ring.release(n, lane);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = pb.q0 + row + 8 * r;
    if (q >= pb.Nq) continue;
    float* at = dq + ((size_t)pb.bh * pb.Nq + q) * D + kBox * pb.box0 + 2 * t4;
#pragma unroll
    for (int j = 0; j < kBoxes; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float2*>(at + 32 * j + 8 * i) = make_float2(acc[j][4 * i + 2 * r], acc[j][4 * i + 2 * r + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_f32_dq_kernel(const __grid_constant__ CUtensorMap tm_ds, const __grid_constant__ CUtensorMap tm_kt,
                            const uint8_t* __restrict__ pad, float* __restrict__ dq, int H, int Nq, int Nk,
                            int causal) {
  static_assert(dq_smem() <= 232448, "the dQ pass must fit in 227 KB of shared memory");
  using R = Ring<kDqStages, kDqSlot>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  const R ring{base, reinterpret_cast<uint64_t*>(base + kDqStages * kDqSlot)};
  DqProblem pb;
  pb.bh = blockIdx.z;
  pb.q0 = blockIdx.x * kDqRows;
  pb.Nq = Nq;
  pb.box0 = blockIdx.y * (D / kBox / dq_parts<D>());
  const int keys = causal ? min(Nk, max(0, Nk - Nq + min(Nq, pb.q0 + kDqRows))) : Nk;
  pb.n_tiles = (keys + kDqKeys - 1) / kDqKeys;
  const uint8_t* pad_row = pad ? pad + (size_t)(pb.bh / H) * Nk : nullptr;
  if (threadIdx.x == 0) {
    ring.init();
    mbar_init_fence();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x < 32) {
      if (threadIdx.x == 0) {
        tma_prefetch(&tm_ds);
        tma_prefetch(&tm_kt);
      }
      produce_dq<D>(ring, pb, pad_row, Nk, &tm_ds, &tm_kt, (int)gridDim.z, (int)threadIdx.x);
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    if (wg == 1)
      consume_dq<D, 0>(ring, pb, pad_row, Nk, dq);
    else
      consume_dq<D, 1>(ring, pb, pad_row, Nk, dq);
  }
}

// ============================================================ small kernels
// delta[row] = sum_d dO[row, d] * O[row, d] (O in float32), 64 rows a block, 4 threads a row.
__global__ void __launch_bounds__(256) flash_bwd_f32_delta_kernel(const float* __restrict__ o,
                                                                  const float* __restrict__ dout,
                                                                  float* __restrict__ delta, int rows, int D) {
  __shared__ float part[256];
  const int tid = threadIdx.x;
  const int row = blockIdx.x * 64 + tid / 4;
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

// Where element c of an 8-group is stored: 0, 2, 4, 6, 1, 3, 5, 7 -> 0 .. 7.
__device__ __forceinline__ int permuted(int c) {
  return (c & ~7) | ((c & 1) ? 4 + ((c & 7) >> 1) : (c & 7) >> 1);
}

// The pre-pass: K and V as hi and lo TF32 terms, channels of every 8-group
// reordered (kt, vt: 2 x (B H, Nk, D) each), and K transposed as hi and lo
// terms, keys of every 8-group reordered and zeros past Nk (ktt: 2 x (B H, D,
// Nk8)). One block a 32-key x 32-channel tile of one head.
__global__ void __launch_bounds__(256) flash_bwd_f32_split_kernel(const float* __restrict__ k,
                                                                  const float* __restrict__ v, float* __restrict__ kt,
                                                                  float* __restrict__ vt, float* __restrict__ ktt,
                                                                  int BH, int Nk, int Nk8, int D) {
  __shared__ float tile[32][33];
  const int key0 = blockIdx.x * 32, ch0 = blockIdx.y * 32, bh = blockIdx.z;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const size_t half = (size_t)BH * Nk * D, t_half = (size_t)BH * D * Nk8;
  for (int r = ty; r < 32; r += 8) {
    const int key = key0 + r;
    float x = 0.f;
    if (key < Nk) {
      const size_t at = ((size_t)bh * Nk + key) * D + ch0 + tx;
      const size_t to = ((size_t)bh * Nk + key) * D + ch0 + permuted(tx);
      uint32_t hi, lo;
      x = k[at];
      split_tf32(x, hi, lo);
      kt[to] = __uint_as_float(hi);
      kt[half + to] = __uint_as_float(lo);
      split_tf32(v[at], hi, lo);
      vt[to] = __uint_as_float(hi);
      vt[half + to] = __uint_as_float(lo);
    }
    tile[r][tx] = x;
  }
  __syncthreads();
  for (int r = ty; r < 32; r += 8) {
    const int key = key0 + tx;
    if (key >= Nk8) continue;
    uint32_t hi, lo;
    split_tf32(tile[tx][r], hi, lo);
    const size_t to = ((size_t)bh * D + ch0 + r) * Nk8 + key0 + permuted(tx);
    ktt[to] = __uint_as_float(hi);
    ktt[t_half + to] = __uint_as_float(lo);
  }
}

// --------------------------------------------------------------- launch
template <int D>
int backward(const void* q, const void* k, const void* v, const void* pad, const void* o, const void* lse,
             const void* dout, void* delta, void* scratch, void* ds, void* ws, void* dq, void* dk, void* dv, int B,
             int H, int Nq, int Nk, int causal, int splits, cudaStream_t stream) {
  constexpr int BK = key_block<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_f32_dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)dkdv_smem<D>());
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_f32_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)dq_smem());
  if (err != cudaSuccess) return (int)err;
  const int BH = B * H, Nk8 = (Nk + 7) / 8 * 8, Nk4 = (Nk + 3) / 4 * 4;
  float* kt = static_cast<float*>(scratch);
  float* vt = kt + 2 * (size_t)BH * Nk * D;
  float* ktt = vt + 2 * (size_t)BH * Nk * D;
  CUtensorMap tm_q, tm_do, tm_k, tm_v, tm_ds, tm_kt;
  if (!f32_rows_map(&tm_q, q, BH, Nq, D, kQTile) || !f32_rows_map(&tm_do, dout, BH, Nq, D, kQTile) ||
      !f32_rows_map(&tm_k, kt, 2 * BH, Nk, D, BK) || !f32_rows_map(&tm_v, vt, 2 * BH, Nk, D, BK) ||
      !f32_rows_map(&tm_ds, ds, BH, Nq, Nk4, kDqRows) || !f32_rows_map(&tm_kt, ktt, 2 * BH, D, Nk8, kBox))
    return (int)cudaErrorNotSupported;  // the driver refused a tensor map
  const int rows = BH * Nq;
  flash_bwd_f32_delta_kernel<<<(rows + 63) / 64, 256, 0, stream>>>(static_cast<const float*>(o),
                                                                    static_cast<const float*>(dout),
                                                                    static_cast<float*>(delta), rows, D);
  flash_bwd_f32_split_kernel<<<dim3((Nk8 + 31) / 32, D / 32, BH), 256, 0, stream>>>(
      static_cast<const float*>(k), static_cast<const float*>(v), kt, vt, ktt, BH, Nk, Nk8, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  float* out_k = splits == 1 ? static_cast<float*>(dk) : static_cast<float*>(ws);
  float* out_v = splits == 1 ? static_cast<float*>(dv) : static_cast<float*>(ws) + (size_t)splits * BH * Nk * D;
  flash_bwd_f32_dkdv_kernel<D><<<dim3((Nk + BK - 1) / BK, splits, BH), kThreads, dkdv_smem<D>(), stream>>>(
      tm_q, tm_do, tm_k, tm_v, static_cast<const uint8_t*>(pad), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(ds), out_k, out_v, H, Nq, Nk, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (splits > 1) {
    const size_t part4 = (size_t)BH * Nk * D / 4;
    flash_bwd_f32_reduce_kernel<<<(unsigned)((part4 + 255) / 256), 256, 0, stream>>>(
        static_cast<const float*>(ws), static_cast<float*>(dk), static_cast<float*>(dv), splits, part4);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  flash_bwd_f32_dq_kernel<D><<<dim3((Nq + kDqRows - 1) / kDqRows, dq_parts<D>(), BH), kThreads, dq_smem(), stream>>>(
      tm_ds, tm_kt, static_cast<const uint8_t*>(pad), static_cast<float*>(dq), H, Nq, Nk, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. q, k, v, dout, o, the gradients and
// the buffers float32, q and dout 16-byte aligned, all contiguous; lse float32;
// delta: (B, H, Nq); scratch: 4 B H Nk D + 2 B H D Nk8 floats (K and V as
// terms, K^T as terms; Nk8 = Nk rounded up to 8); ds: B H Nq Nk4 floats (Nk4 =
// Nk rounded up to 4), 16-byte aligned; ws: 2 splits B H Nk D floats when
// splits > 1 (else unused). D: 64, 128, ..., 512; pad: (B, Nk) uint8 or null.
// The Python wrapper checks every pointer, shape and type and allocates every
// buffer. Returns cudaGetLastError() after the launches (0 = launched),
// cudaErrorNotSupported if the driver refused a tensor map.
extern "C" int flash_backward_f32(const void* q, const void* k, const void* v, const void* pad, const void* o,
                                  const void* lse, const void* dout, void* delta, void* scratch, void* ds, void* ws,
                                  void* dq, void* dk, void* dv, int B, int H, int Nq, int Nk, int D, int causal,
                                  int splits, void* stream) {
  if (B < 1 || H < 1 || Nq < 1 || Nk < 1 || splits < 1 || splits > 65535 || (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  (void)cudaGetLastError();  // clear a stale error so the one returned is this call's
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define B1B_F32_CASE(W)                                                                                          \
  case W:                                                                                                        \
    return backward<W>(q, k, v, pad, o, lse, dout, delta, scratch, ds, ws, dq, dk, dv, B, H, Nq, Nk, causal, \
                       splits, s);
  switch (D) {
    B1B_F32_CASE(64)
    B1B_F32_CASE(128)
    B1B_F32_CASE(192)
    B1B_F32_CASE(256)
    B1B_F32_CASE(320)
    B1B_F32_CASE(384)
    B1B_F32_CASE(448)
    B1B_F32_CASE(512)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef B1B_F32_CASE
}
