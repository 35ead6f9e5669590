// Flash attention forward in float32 on Hopper (sm_90a), every head width
// D = 64, 128, ..., 512: kernel B1a for float32 inputs, and B5 with it.
//
// Replaces the forward of perceiver_io_tpu/ops/flash.py:splash_mha (the Pallas
// splash kernel built by `_build_kernel` via `make_splash_mha`) for float32
// inputs, training and inference, and the float32 blocks of
// perceiver_io_tpu/parallel/ring_attention.py:_splash_fwd_block (B5: the same
// entry with no causal mask; a block may have a ragged last key tile or be
// all padding). Function and layouts:
//   q     (B, H, Nq, D)  float32, already scaled and rotated queries
//   k, v  (B, H, Nk, D)  float32 keys and values
//   pad   (B, Nk)        uint8, 1 = padding key (the splash segment id 0), or null
//   o     (B, H, Nq, D)  float32 (B1b's delta and the ring's merge read it)
//   lse   (B, H, Nq)     float32 natural log-sum-exp of each query's visible scores
// Causal is right-aligned (query i sees key j iff j <= Nk - Nq + i); a query
// that sees no key gets exact zeros and lse = -inf; Nq and Nk are any sizes.
// Key tiles past a block's causal bound are never loaded, and tiles whose
// keys are all padding are skipped. No atomics: two runs give the same bits.
//
// What bounds it on an H100: 4 D flops a visible (query, key) pair against
// O(D) bytes a row read once, so the rate of float32-class products sets the
// floor. The CUDA cores give 67 TFLOP/s; the tensor cores have no float32
// product, but give TF32 (10 explicit mantissa bits) at 495 TFLOP/s, and
// three TF32 products give float32-class sums: each operand x is split into
// hi = tf32(x) and lo = tf32(x - hi) (|x - hi - lo| <= 2^-22 |x|), and
// a b ~ lo_a hi_b + hi_a lo_b + hi_a hi_b, the small terms first, every sum
// in float32 (about 2^-21 relative a product, against 2^-11 for one TF32
// term). That floor is 495 / 3 = 165 TFLOP/s: 4.64 ms for the optical-flow
// decoder's patch (182,528 queries over 2,048 keys at D = 512), against
// 11.43 ms on the CUDA cores. Second comes the L2: every block reads its
// head's K and V as hi and lo terms, 16 MB a block at the flow decoder.
//
// The design:
//   * a pre-pass (flash_f32_split_kernel) writes, into a scratch the wrapper
//     allocates, K as hi and lo terms (2 x (B H, Nk, D)) and V transposed
//     as hi and lo terms (2 x (B H, D, Nk8), Nk8 = Nk rounded up to 8, the
//     extra keys zeros): wgmma takes tf32 only K-major for both operands, and
//     O = P V contracts over keys, so its B operand must be V^T with keys
//     contiguous. Within every 8-group of K's channels and of V^T's keys
//     the pre-pass stores element c at position c / 2 (c even) or 4 + c / 2
//     (c odd): then a thread's two adjacent accumulator columns (2 t, 2 t + 1)
//     are exactly the A fragment's columns t and t + 4, so P goes from S's
//     accumulator into P V's A operand with no shuffle, and a thread loads
//     its Q fragment of a k = 8 slice as one 8-byte read a row. The pre-pass
//     is part of every call's time;
//   * Q stays in shared memory once, in float32 (128 KB at D = 512: hi and lo
//     would not fit); a consumer loads each k = 8 slice of its Q fragment
//     from it and splits it in registers, as the A operand of S = Q K^T (tf32
//     takes A from registers). Two register sets alternate over the slices,
//     each slice its own commit group that waits only for the one before it,
//     so no instruction writes a register that a wgmma in flight reads (one
//     set at D 448-512, where O's half takes 112-128 registers a thread and
//     two spilled);
//   * ptxas serialises every wgmma of a kernel in which a non-wgmma
//     instruction touches a wgmma's registers in flight, a wgmma depends on
//     a fence it must insert in a divergent path, or a stage holds too many
//     registers (its notes C7514, C7520, C7519; each measured slower). So
//     every wait on a full barrier is a loop on a warp-uniform vote
//     (hopper.cuh's mbar_wait_warp), the wgmma fence comes after that wait,
//     and S takes at most two register sets of one slice (four sets, or
//     groups of two or four slices, drew notes or spills);
//   * warp specialisation: 384 threads as three warpgroups. The producer
//     warpgroup lowers its registers by setmaxnreg and its first warp issues
//     every TMA load; the two consumer warpgroups raise theirs;
//   * TMA into a ring of slabs: a slab is one 128-byte box (32 float32
//     channels of kBK keys for K, 32 keys of 32 channel rows for V^T) as a hi
//     and a lo term, swizzled by 128 bytes; a tile of kBK keys is D / 32 K
//     slabs and D / 32 V slabs. The ring holds kStages slabs, so at D = 448
//     -512, where Q takes 128 KB, K and V still stream. A consumer warpgroup
//     releases a slab with one arrival a block, once its last products have
//     completed. Each slab costs a wait, an arrival and its loads on one
//     producer thread; at the flow decoder that protocol, with no data and no
//     products, takes about two fifths of the kernel's time;
//   * two layouts of the consumers: up to D = 128 each consumer owns 64
//     query rows of a 128-row block and all of D (64-key tiles: S is
//     m64n64k8, P V m64n32k8 a 32-channel slab); above, as
//     flash_forward_wide.cu, both own the same 64 rows: consumer c computes
//     S over its half of D's boxes, the two exchange their float32 partials
//     through shared memory (a named barrier between them; float addition
//     commutes, so both hold the same bits and run the same online softmax),
//     and consumer c owns the output columns of its half (32-key tiles, so
//     that O's 64 x 256 float32 half, S and the P terms fit the registers);
//   * P V from registers: the softmax's float32 P is split into hi and lo A
//     fragments in registers; O[:, own columns] += P V^T slab by slab;
//   * fresh accumulators: the tensor cores truncate their float32 sums, and
//     along one chain of sums over D and over every key that error grows to
//     several times the plain float32 version's (PERF.md §6). So each
//     32-channel slab of S and each tile's P V over a
//     32-column slab start from zero (wgmma's scale-d off) in one of two
//     alternating accumulators (one at D 448-512: each slab then waits for
//     its own products), and are added to S, and to O's rescaled rows, in
//     registers with rounding once they have completed;
//   * a cluster of two blocks: neighbouring query tiles of one (batch, head);
//     each block loads half of every box's rows and multicasts it to both, so
//     a K/V byte leaves L2 once for both. The pair streams keys up to the
//     larger of its two causal bounds; a consumer past its own bound only
//     waits for and releases its slabs. An odd query-tile count pads the grid
//     with a spare block that issues its half of every load and every
//     release and writes nothing; each producer waits for its ring's last
//     releases before it exits.
//
// Tiles and shared memory per width (smem_bytes: 1024 bytes of alignment
// slack + Q + the ring + the S exchange, double-buffered + mbarriers):
//   D 64: 128 query rows, 64-key tiles, 4 slabs, 99,400 bytes
//   D 128: 128 query rows, 64-key tiles, 8 slabs, 197,768 bytes
//   D 192: 64 query rows, 32-key tiles, 18 slabs, 230,696 bytes
//   D 256: 64 query rows, 32-key tiles, 16 slabs, 230,664 bytes
//   D 320: 64 query rows, 32-key tiles, 14 slabs, 230,632 bytes
//   D 384: 64 query rows, 32-key tiles, 12 slabs, 230,600 bytes
//   D 448: 64 query rows, 32-key tiles, 10 slabs, 230,568 bytes
//   D 512: 64 query rows, 32-key tiles, 8 slabs, 230,536 bytes
// (of the 232,448 a block may have).

#include "hopper.cuh"

// Parts switched off for perceiver_io_torch/profile_wide_forward.py's float32
// mode (wrong values, timing only); 0 in the port's builds.
#ifndef B1A_F32_OFF
#define B1A_F32_OFF 0
#endif

namespace {

using namespace hopper;

constexpr unsigned kOff = B1A_F32_OFF;
constexpr unsigned kOffLoads = 1;   // only the ring's first fill is loaded
constexpr unsigned kOffScores = 2;  // no S = Q K^T products
constexpr unsigned kOffSplit = 4;   // one TF32 term a product (hi hi) instead of three
constexpr unsigned kOffPv = 8;      // no O += P V products

constexpr int kThreads = 3 * 128;  // the producer warpgroup, then the two consumers
constexpr int kProducerRegs = 24;  // setmaxnreg: 128 x 24 + 256 x 240 <= 65,536
constexpr int kConsumerRegs = 240;
constexpr int kClusterBlocks = 2;
constexpr int kBox = 32;             // float32 channels (or keys) of one 128-byte box row
constexpr int kExchangeBarrier = 1;  // named barrier between the two consumer warpgroups
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
__host__ __device__ constexpr bool split_d() {  // both consumers on the same rows, D split between them
  return D > 128;
}

template <int D>
__host__ __device__ constexpr int block_rows() {  // query rows a block
  return split_d<D>() ? 64 : 128;
}

template <int D>
__host__ __device__ constexpr int key_tile() {  // keys a tile
  return split_d<D>() ? 32 : 64;
}

template <int D>
__host__ __device__ constexpr int stages() {  // slabs in the ring
  return D <= 64    ? 4
         : D <= 128  ? 8
         : D <= 192  ? 18
         : D <= 256  ? 16
         : D <= 320  ? 14
         : D <= 384  ? 12
         : D <= 448  ? 10
                     : 8;
}

template <int D>
__host__ __device__ constexpr int q_sets() {  // rotating register sets of Q's split k = 8 slices
  return D >= 448 ? 1 : 2;
}

template <int D>
__host__ __device__ constexpr int pv_parts() {  // P V's slab accumulators in rotation (1: each slab waits for its own)
  return D >= 448 ? 1 : 2;  // at D 448-512 O's half takes 112-128 registers a thread, and two spilled
}

template <int D>
__host__ __device__ constexpr int slab_bytes() {  // a hi and a lo box of kBK x 32 floats
  return 2 * key_tile<D>() * kBox * sizeof(float);
}

template <int D>
__host__ __device__ constexpr size_t smem_bytes() {
  return 1024 + sizeof(float) * block_rows<D>() * D + stages<D>() * slab_bytes<D>() +
         (split_d<D>() ? 2 * 2 * sizeof(float) * 64 * key_tile<D>() : 0) +
         sizeof(uint64_t) * (1 + 2 * stages<D>());
}

// The block's view of its shared memory: one base address, the regions at
// constant offsets from it (one register, not one a region).
template <int D>
struct Tiles {
  unsigned char* base;  // 1024-byte aligned, at the same offset in both blocks
  static constexpr size_t kQ = sizeof(float) * block_rows<D>() * D;
  static constexpr size_t kRing = size_t(stages<D>()) * slab_bytes<D>();
  static constexpr size_t kExchange = split_d<D>() ? 2 * 2 * sizeof(float) * 64 * key_tile<D>() : 0;
  __device__ __forceinline__ float* q() const {  // D / 32 boxes of (block_rows, 32)
    return reinterpret_cast<float*>(base);
  }
  __device__ __forceinline__ char* ring() const {  // stages x slab_bytes
    return reinterpret_cast<char*>(base + kQ);
  }
  __device__ __forceinline__ float* exchange() const {  // [2 buffers][2 consumers][kBK / 8][128 threads][4]
    return reinterpret_cast<float*>(base + kQ + kRing);
  }
  __device__ __forceinline__ uint64_t* q_full() const {
    return reinterpret_cast<uint64_t*>(base + kQ + kRing + kExchange);
  }
  __device__ __forceinline__ uint64_t* full() const { return q_full() + 1; }                   // [stages]
  __device__ __forceinline__ uint64_t* empty() const { return q_full() + 1 + stages<D>(); }  // [stages]
};

template <int D>
__device__ __forceinline__ Tiles<D> carve(unsigned char* raw) {
  return Tiles<D>{raw + ((1024 - (smem_u32(raw) & 1023)) & 1023)};
}

struct Problem {
  int bh, q0, Nq, Nk, causal;
  int n_tiles;  // key tiles the pair streams (those that are all padding are skipped)
  bool active;  // the block has query rows (not the spare block of an odd count)
};

// The first tile at or after t with a key that is in range and not padding
// (n_tiles if none), the same to every lane of the calling warp.
template <int kBK>
__device__ __forceinline__ int next_live(int t, int n_tiles, const uint8_t* __restrict__ pad_row, int Nk, int lane) {
  if (pad_row == nullptr) return t;
  for (; t < n_tiles; ++t) {
    bool any = false;
#pragma unroll
    for (int e = lane; e < kBK; e += 32) {
      const int key = t * kBK + e;
      any |= key < Nk && !pad_row[key];
    }
    if (__any_sync(0xffffffffu, any)) break;
  }
  return t;
}

// Slab i (0 <= i < D / 32) of a tile's K (or V^T) half: its 32-channel box.
// With split_d the two consumers' boxes alternate, so that both are fed at once.
template <int D>
__host__ __device__ constexpr int slab_box(int i) {
  return split_d<D>() ? (i % 2) * (D / 64) + i / 2 : i;
}

// ------------------------------------------------------------ producer
// One warp; lane 0 issues. Per live tile: its D / 32 K slabs, then its D / 32
// V^T slabs, each into the next ring slot once both blocks have released it.
template <int D>
__device__ __forceinline__ void produce(const Tiles<D>& sm, const Problem& pb, const uint8_t* __restrict__ pad_row,
                                        const CUtensorMap* tm_q, const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                        int BH, int lane) {
  constexpr int kBK = key_tile<D>(), kStages = stages<D>(), kRows = block_rows<D>();
  constexpr int kBoxBytes = kBK * kBox * sizeof(float);  // one term of a slab
  const int rank = (int)cluster_rank();
  bool q_loaded = false;
  int n = 0;  // slabs issued
  for (int t = next_live<kBK>(0, pb.n_tiles, pad_row, pb.Nk, lane); t < pb.n_tiles;
       t = next_live<kBK>(t + 1, pb.n_tiles, pad_row, pb.Nk, lane)) {
    if (!q_loaded && pb.active && lane == 0) {
      mbar_arrive_expect_tx(sm.q_full(), sizeof(float) * kRows * D);
#pragma unroll
      for (int b = 0; b < D / kBox; ++b)
        tma_load_3d(sm.q() + b * kRows * kBox, tm_q, sm.q_full(), kBox * b, pb.q0, pb.bh);
    }
    q_loaded = true;
#pragma unroll 1
    for (int i = 0; i < 2 * (D / kBox); ++i, ++n) {
      const int st = n % kStages;
      mbar_wait_cluster(sm.empty() + st, ((n / kStages) & 1) ^ 1);  // the slot's last use is released
      if (lane == 0) {
        char* slab = sm.ring() + st * slab_bytes<D>();
        if ((kOff & kOffLoads) && n >= kStages) {  // stale slabs: only the loads' cost is missing
          mbar_arrive_expect_tx(sm.full() + st, 0);
          continue;
        }
        mbar_arrive_expect_tx(sm.full() + st, slab_bytes<D>());  // both halves land here
        const int box = slab_box<D>(i % (D / kBox));
#pragma unroll
        for (int term = 0; term < 2; ++term) {
          if (i < D / kBox) {  // K: kBK key rows of 32 channels; this block's half of the rows
            tma_load_3d_multicast(slab + term * kBoxBytes + rank * (kBK / 2) * 128, tm_k, sm.full() + st, 0x3,
                                  kBox * box, t * kBK + rank * (kBK / 2), term * BH + pb.bh);
          } else {  // V^T: 32 channel rows of kBK / 32 boxes of 32 keys; this block's half of the rows
#pragma unroll
            for (int kb = 0; kb < kBK / kBox; ++kb)
              tma_load_3d_multicast(slab + term * kBoxBytes + kb * kBox * 128 + rank * 16 * 128, tm_v,
                                    sm.full() + st, 0x3, t * kBK + kBox * kb, kBox * box + rank * 16,
                                    term * BH + pb.bh);
          }
        }
      }
    }
  }
  // stay until every slot's last use is released (then no consumer of the
  // other block arrives here, and no multicast writes here, after this block
  // ends), and until Q has landed
  for (int st = 0; st < kStages && st < n; ++st) {
    const int uses = (n - st + kStages - 1) / kStages;
    mbar_wait_cluster(sm.empty() + st, (uses & 1) ^ 1);
  }
  if (q_loaded && pb.active) mbar_wait_warp(sm.q_full(), 0);
}

// ------------------------------------------------------------ consumers
// Releases a slot in both blocks of the cluster: one arrival a consumer
// warpgroup in each block, by thread 64 r of the warpgroup for block r (as
// CUTLASS's consumer release does: a warpgroup's wgmma has completed, smem
// reads and all, once the signalling thread's wgmma wait has returned).
__device__ __forceinline__ void release(uint64_t* empty, int tid) {
#pragma unroll
  for (int r = 0; r < kClusterBlocks; ++r)
    if (tid == 64 * r) mbar_arrive_cluster(empty, r);
}

struct RowStats {
  float m[2] = {-INFINITY, -INFINITY};  // running max (natural units) of rows row0, row0 + 8
  float l[2] = {0.f, 0.f};              // this thread's part of the running sums
  float alpha[2] = {1.f, 1.f};          // the factor O's rows take before the tile's P V
};

// The three TF32 products of one k = 8 slice into d: lo_a hi_b, hi_a lo_b,
// hi_a hi_b (one, hi hi, under kOffSplit); with fresh, the first overwrites
// d. b_hi and b_lo describe the slice of the slab's hi and lo boxes.
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

// Consumer C's part of tile t's S = Q K^T into s: over its K slabs (all of
// them, or with split_d its half of D's boxes), four k = 8 slices a slab,
// each slice's Q fragment loaded from shared memory and split into the next
// of q_sets rotating register sets, and its products committed as a group
// that waits only for the groups before it that used other sets, so no
// instruction writes a register that a wgmma in flight reads. The tensor
// cores' float32 sums truncate, and over a long chain of products that error
// grows with the chain, so each slab's products go to a fresh accumulator of
// their own (two alternate when a slab's last group may still run while the
// next slab's first is issued) that is added to s, rounded, once they have
// completed; then the slab is released. All have been when this returns.
template <int D, int C>
__device__ __forceinline__ void scores(const Tiles<D>& sm, int n0, float (&s)[key_tile<D>() / 2], int qrow, int g,
                                       int t4, int tid) {
  constexpr int kBK = key_tile<D>(), kStages = stages<D>(), kRows = block_rows<D>();
  constexpr int kSlabs = split_d<D>() ? D / 64 : D / kBox;  // this consumer's K slabs
  constexpr int kBoxBytes = kBK * kBox * sizeof(float);
  constexpr int kSets = q_sets<D>(), kParts = kSets == 1 ? 1 : 2;
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) s[i] = 0.f;
  float part[kParts][kBK / 2];
  uint32_t qa[kSets][2][4];  // [register set][hi, lo][a0..a3]
  const char* qrow0 = reinterpret_cast<const char*>(sm.q()) + qrow * 128 + (t4 & 1) * 8;
  // slab jd's products have completed: add them to s and release the slab
  auto finish = [&](int jd) {
    fence_regs(part[jd % kParts]);
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) s[i] += part[jd % kParts][i];
    release(sm.empty() + (n0 + (split_d<D>() ? 2 * jd + C : jd)) % kStages, tid);
  };
#pragma unroll
  for (int j = 0; j < kSlabs; ++j) {
    const int i = split_d<D>() ? 2 * j + C : j;  // the slab's place in the tile
    const int n = n0 + i, st = n % kStages;
    const int box = slab_box<D>(i);
    mbar_wait_warp(sm.full() + st, (n / kStages) & 1);
    const char* slab = sm.ring() + st * slab_bytes<D>();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int slice = 4 * j + kk;
      uint32_t(&a)[2][4] = qa[slice % kSets];
      // rows qrow and qrow + 8, channels 32 box + 8 kk + 2 t4 (+1): one 8-byte read each
      const char* at = qrow0 + box * kRows * 128 + (((2 * kk + (t4 >> 1)) ^ g) << 4);
      const float2 x0 = *reinterpret_cast<const float2*>(at);
      const float2 x1 = *reinterpret_cast<const float2*>(at + 8 * 128);
      split_tf32(x0.x, a[0][0], a[1][0]);
      split_tf32(x1.x, a[0][1], a[1][1]);
      split_tf32(x0.y, a[0][2], a[1][2]);
      split_tf32(x1.y, a[0][3], a[1][3]);
      if constexpr (!(kOff & kOffScores)) {
        wgmma_fence();
        const uint64_t b_hi = wgmma_desc(slab + kk * 32, 16, 1024);
        mma3<kBK>(part[j % kParts], a[0], a[1], b_hi, desc_add(b_hi, kBoxBytes), kk == 0);
      }
      wgmma_commit();
      // slices up to slice - (kSets - 1) have completed (then the next slice may
      // write its set); a slab whose last slice is among them is finished
      wgmma_wait<kSets - 1>();
      const int done = slice - (kSets - 1);
      if (done >= 0 && done % 4 == 3) finish(done / 4);
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int jd = 0; jd < kSlabs; ++jd)  // the slabs whose last slice completed only now
    if (4 * jd + 3 > 4 * kSlabs - 1 - (kSets - 1)) finish(jd);
}

// Tile t's online softmax, once this consumer's s holds its S (with split_d
// its partial, to which the other consumer's is added first through shared
// memory: buffers alternate by tile, so a consumer writes buffer t % 2 again
// only past the barrier of tile t + 1, which the other passes only once it
// has read tile t's). s becomes the tile's float32 P; rows takes its alpha,
// m and l.
template <int D, int C>
__device__ __forceinline__ void softmax_tile(const Tiles<D>& sm, const Problem& pb, const uint8_t* __restrict__ pad_row,
                                             int t, int parity, float (&s)[key_tile<D>() / 2], RowStats& rows,
                                             int tid, int t4, int lim, int row_lo) {
  constexpr int kBK = key_tile<D>();
  const int k0 = t * kBK;
  if constexpr (split_d<D>()) {
    float* mine = sm.exchange() + (parity * 2 + C) * 64 * kBK;
    const float* theirs = sm.exchange() + (parity * 2 + (1 - C)) * 64 * kBK;
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
  }
  // mask: a tile with a key past Nk or a pad flag, or one that reaches past the warp's first row's diagonal
  if (k0 + kBK > pb.Nk || pad_row || (pb.causal && k0 + kBK - 1 > row_lo)) {
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

// Consumer C's part of tile t's O[:, own columns] = alpha O + P V: P
// (softmax_tile's s) split into hi and lo A fragments (slice j's columns t4
// and t4 + 4 are the accumulator's keys 8 j + 2 t4 and 8 j + 2 t4 + 1, which
// the pre-pass stored at those places), then one commit group a V^T slab of
// 32 output columns into a fresh accumulator (two alternate, as in scores:
// no chain of truncating sums across tiles), which is added to O's rescaled
// columns, rounded, once it has completed; then the slab is released. All
// have been when this returns.
template <int D, int C>
__device__ __forceinline__ void pv(const Tiles<D>& sm, int n0, const float (&s)[key_tile<D>() / 2],
                                   float (&acc)[(split_d<D>() ? D / 64 : D / kBox) * 16], const RowStats& rows,
                                   int tid) {
  constexpr int kBK = key_tile<D>(), kStages = stages<D>();
  constexpr int kSlabs = split_d<D>() ? D / 64 : D / kBox;  // this consumer's V^T slabs (32 columns each)
  constexpr int kBoxBytes = kBK * kBox * sizeof(float);
  uint32_t pa[kBK / 8][2][4];  // [slice][hi, lo][a0..a3]
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
    split_tf32(s[4 * j], pa[j][0][0], pa[j][1][0]);
    split_tf32(s[4 * j + 2], pa[j][0][1], pa[j][1][1]);
    split_tf32(s[4 * j + 1], pa[j][0][2], pa[j][1][2]);
    split_tf32(s[4 * j + 3], pa[j][0][3], pa[j][1][3]);
  }
  constexpr int kParts = pv_parts<D>();
  float part[kParts][16];  // the slabs' own accumulators, in rotation
  // slab jd's products have completed: O's columns of the slab take them, and the slab is released
  auto finish = [&](int jd) {
    fence_regs(part[jd % kParts]);
#pragma unroll
    for (int e = 0; e < 16; ++e)
      acc[16 * jd + e] = fmaf(acc[16 * jd + e], rows.alpha[(e / 2) & 1], part[jd % kParts][e]);
    const int i = D / kBox + (split_d<D>() ? 2 * jd + C : jd);
    release(sm.empty() + (n0 + i) % kStages, tid);
  };
#pragma unroll
  for (int j = 0; j < kSlabs; ++j) {
    const int i = D / kBox + (split_d<D>() ? 2 * j + C : j);
    const int n = n0 + i, st = n % kStages;
    mbar_wait_warp(sm.full() + st, (n / kStages) & 1);
    const char* slab = sm.ring() + st * slab_bytes<D>();
    wgmma_fence();  // after the wait: a fence before it made ptxas insert its own in the wait's loop
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {
      const uint64_t b_hi = wgmma_desc(slab + (kk / 4) * kBox * 128 + (kk % 4) * 32, 16, 1024);
      if constexpr (!(kOff & kOffPv)) mma3<32>(part[j % kParts], pa[kk][0], pa[kk][1], b_hi, desc_add(b_hi, kBoxBytes), kk == 0);
    }
    wgmma_commit();
    if (kParts == 1) {
      wgmma_wait<0>();
      finish(j);
    } else if (j > 0) {
      wgmma_wait<1>();
      finish(j - 1);
    }
  }
  if (kParts > 1) {
    wgmma_wait<0>();
    finish(kSlabs - 1);
  }
}

// Consumer C: the live tiles below its causal bound, each S, softmax, O's
// rescale, P V; then the live tiles past it (all of them in the spare
// block), whose slabs it only waits for and releases; then the epilogue.
template <int D, int C>
__device__ __forceinline__ void consume(const Tiles<D>& sm, const Problem& pb, const uint8_t* __restrict__ pad_row,
                                        float* __restrict__ o, float* __restrict__ lse) {
  constexpr int kBK = key_tile<D>(), kStages = stages<D>();
  constexpr int kSlabs = split_d<D>() ? D / 64 : D / kBox;  // this consumer's K slabs, and its V^T slabs
  constexpr int kCol0 = split_d<D>() ? C * (D / 2) : 0;      // its first output column
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int rows0 = split_d<D>() ? 0 : 64 * C;  // its first row in the block
  const int qrow = rows0 + 16 * warp + g;       // this thread's rows qrow and qrow + 8 in the block
  const int off = pb.Nk - pb.Nq;
  const int lim = off + pb.q0 + qrow;            // the last key row qrow sees (causal); qrow + 8: lim + 8
  const int row_lo = off + pb.q0 + rows0 + 16 * warp;  // the last key the warp's first row sees
  // tiles with a key some row of this consumer sees: a prefix of the pair's
  const int first = pb.q0 + rows0;
  const int keys = !pb.active || first >= pb.Nq ? 0
                   : pb.causal                   ? min(pb.Nk, max(0, off + min(pb.Nq, first + 64)))
                                                 : pb.Nk;
  const int n_mine = min(pb.n_tiles, (keys + kBK - 1) / kBK);

  float acc[kSlabs * 16];
#pragma unroll
  for (int i = 0; i < kSlabs * 16; ++i) acc[i] = 0.f;
  RowStats rows;
  int n0 = 0;       // slabs of the live tiles before this one
  int parity = 0;   // the exchange buffer: live tiles computed so far, mod 2
  int t = next_live<kBK>(0, pb.n_tiles, pad_row, pb.Nk, lane);
  if (t < n_mine) mbar_wait_warp(sm.q_full(), 0);
  for (; t < n_mine; t = next_live<kBK>(t + 1, pb.n_tiles, pad_row, pb.Nk, lane)) {
    float s[kBK / 2];
    scores<D, C>(sm, n0, s, qrow, g, t4, tid);
    softmax_tile<D, C>(sm, pb, pad_row, t, parity, s, rows, tid, t4, lim, row_lo);
    pv<D, C>(sm, n0, s, acc, rows, tid);
    n0 += 2 * (D / kBox);
    parity ^= 1;
  }
  for (; t < pb.n_tiles; t = next_live<kBK>(t + 1, pb.n_tiles, pad_row, pb.Nk, lane)) {
    for (int part = 0; part < 2; ++part) {
      for (int j = 0; j < kSlabs; ++j) {
        const int n = n0 + part * (D / kBox) + (split_d<D>() ? 2 * j + C : j), st = n % kStages;
        mbar_wait_warp(sm.full() + st, (n / kStages) & 1);
        release(sm.empty() + st, tid);
      }
    }
    n0 += 2 * (D / kBox);
  }

  // epilogue: o = acc / l over this consumer's columns, lse = m + log l
  // (with split_d consumer 0 alone); rows that saw no key get zeros and -inf
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = rows.l[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = pb.q0 + qrow + 8 * r;
    if (!pb.active || row >= pb.Nq) continue;
    const float inv = l > 0.f ? 1.f / l : 0.f;
    const size_t at = ((size_t)pb.bh * pb.Nq + row) * D + kCol0 + 2 * t4;
#pragma unroll
    for (int j = 0; j < kSlabs * 4; ++j)
      *reinterpret_cast<float2*>(o + at + 8 * j) = make_float2(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
    if ((!split_d<D>() || C == 0) && t4 == 0)
      lse[(size_t)pb.bh * pb.Nq + row] = l > 0.f ? rows.m[r] + logf(l) : -INFINITY;
  }
}

// ----------------------------------------------------------------- kernels
template <int D>
__global__ void __cluster_dims__(kClusterBlocks, 1, 1) __launch_bounds__(kThreads, 1)
    flash_fwd_f32_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v, const uint8_t* __restrict__ pad,
                         float* __restrict__ o, float* __restrict__ lse, int H, int Nq, int Nk, int causal) {
  constexpr int kBK = key_tile<D>(), kStages = stages<D>(), kRows = block_rows<D>();
  static_assert(D % 64 == 0 && D >= 64 && D <= 512, "D must be a multiple of 64 in 64..512");
  static_assert(smem_bytes<D>() <= 232448, "the tiles must fit in 227 KB of shared memory");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Tiles<D> sm = carve<D>(smem_raw);

  Problem pb;
  pb.bh = blockIdx.y;
  // heaviest causal tiles first; the two blocks of a cluster take tiles 2p and 2p + 1
  const int tile = causal ? (int)(gridDim.x - 1 - blockIdx.x) : (int)blockIdx.x;
  const int pair0 = (tile & ~1) * kRows;  // the pair's first query row (always < Nq)
  pb.q0 = tile * kRows;
  pb.Nq = Nq;
  pb.Nk = Nk;
  pb.causal = causal;
  pb.active = pb.q0 < Nq;
  const int pair_keys = causal ? min(Nk, max(0, Nk - Nq + min(Nq, pair0 + 2 * kRows))) : Nk;
  pb.n_tiles = (pair_keys + kBK - 1) / kBK;
  const uint8_t* pad_row = pad ? pad + (size_t)(pb.bh / H) * Nk : nullptr;

  if (threadIdx.x == 0) {
    mbar_init(sm.q_full(), 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(sm.full() + st, 1);  // the producer's arrival; bytes from both blocks
      mbar_init(sm.empty() + st, (split_d<D>() ? 1 : 2) * kClusterBlocks);  // the slot's consumer warpgroups, both blocks
    }
    mbar_init_fence();
  }
  cluster_sync();  // the barriers of both blocks exist before any load or remote arrival

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x < 32) {
      if (threadIdx.x == 0) {
        tma_prefetch(&tm_q);
        tma_prefetch(&tm_k);
        tma_prefetch(&tm_v);
      }
      produce<D>(sm, pb, pad_row, &tm_q, &tm_k, &tm_v, (int)(gridDim.y), (int)threadIdx.x);
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    if (wg == 1)
      consume<D, 0>(sm, pb, pad_row, o, lse);
    else
      consume<D, 1>(sm, pb, pad_row, o, lse);
  }
}

// The pre-pass: K as hi and lo TF32 terms, channels of every 8-group in the
// order 0, 2, 4, 6, 1, 3, 5, 7 (kt: 2 x (B H, Nk, D)); V transposed, as hi
// and lo terms, keys of every 8-group in the same order and zeros past Nk
// (vt: 2 x (B H, D, Nk8)). One block a 32-key x 32-channel tile of one head.
__device__ __forceinline__ int permuted(int c) {  // where element c of an 8-group is stored
  return (c & ~7) | ((c & 1) ? 4 + ((c & 7) >> 1) : (c & 7) >> 1);
}

__global__ void __launch_bounds__(256) flash_f32_split_kernel(const float* __restrict__ k, const float* __restrict__ v,
                                                              float* __restrict__ kt, float* __restrict__ vt, int BH,
                                                              int Nk, int Nk8, int D) {
  __shared__ float tile[32][33];
  const int key0 = blockIdx.x * 32, ch0 = blockIdx.y * 32, bh = blockIdx.z;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const size_t k_half = (size_t)BH * Nk * D, v_half = (size_t)BH * D * Nk8;
  for (int r = ty; r < 32; r += 8) {
    const int key = key0 + r;
    const size_t at = ((size_t)bh * Nk + key) * D + ch0 + tx;
    float x = 0.f;
    if (key < Nk) {
      uint32_t hi, lo;
      split_tf32(k[at], hi, lo);
      const size_t to = ((size_t)bh * Nk + key) * D + ch0 + permuted(tx);
      kt[to] = __uint_as_float(hi);
      kt[k_half + to] = __uint_as_float(lo);
      x = v[at];
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
    vt[to] = __uint_as_float(hi);
    vt[v_half + to] = __uint_as_float(lo);
  }
}

// --------------------------------------------------------------- launch
template <int D>
int forward(const void* q, const void* k, const void* v, const void* pad, void* scratch, void* o, void* lse, int B,
            int H, int Nq, int Nk, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  constexpr int kRows = block_rows<D>();
  auto kernel = flash_fwd_f32_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int BH = B * H, Nk8 = (Nk + 7) / 8 * 8;
  float* kt = static_cast<float*>(scratch);
  float* vt = kt + 2 * (size_t)BH * Nk * D;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!f32_rows_map(&tm_q, q, BH, Nq, D, kRows) || !f32_rows_map(&tm_k, kt, 2 * BH, Nk, D, key_tile<D>() / 2) ||
      !f32_rows_map(&tm_v, vt, 2 * BH, D, Nk8, 16))
    return (int)cudaErrorNotSupported;  // the driver refused a tensor map
  flash_f32_split_kernel<<<dim3((Nk8 + 31) / 32, D / 32, BH), 256, 0, stream>>>(
      static_cast<const float*>(k), static_cast<const float*>(v), kt, vt, BH, Nk, Nk8, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int tiles = (Nq + kRows - 1) / kRows;
  const dim3 grid(kClusterBlocks * ((tiles + kClusterBlocks - 1) / kClusterBlocks), BH);
  kernel<<<grid, kThreads, smem, stream>>>(tm_q, tm_k, tm_v, static_cast<const uint8_t*>(pad),
                                           static_cast<float*>(o), static_cast<float*>(lse), H, Nq, Nk, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. q, k, v float32 (16-byte aligned,
// contiguous); o and lse float32; scratch: 2 B H Nk D + 2 B H D Nk8 float32
// (Nk8 = Nk rounded up to a multiple of 8), 16-byte aligned. D: 64, 128, ...,
// 512; pad: (B, Nk) uint8 or null. The Python wrapper checks every pointer,
// shape and type and allocates the outputs and the scratch. Returns
// cudaGetLastError() after the launches (0 = launched),
// cudaErrorNotSupported if the driver refused a tensor map.
extern "C" int flash_forward_f32(const void* q, const void* k, const void* v, const void* pad, void* scratch,
                                 void* o, void* lse, int B, int H, int Nq, int Nk, int D, int causal, void* stream) {
  if (B < 1 || H < 1 || Nq < 1 || Nk < 1 || (long long)B * H > 65535) return (int)cudaErrorInvalidValue;
  (void)cudaGetLastError();  // clear a stale error so the one returned is this launch's
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return forward<64>(q, k, v, pad, scratch, o, lse, B, H, Nq, Nk, causal, s);
    case 128: return forward<128>(q, k, v, pad, scratch, o, lse, B, H, Nq, Nk, causal, s);
    case 192: return forward<192>(q, k, v, pad, scratch, o, lse, B, H, Nq, Nk, causal, s);
    case 256: return forward<256>(q, k, v, pad, scratch, o, lse, B, H, Nq, Nk, causal, s);
    case 320: return forward<320>(q, k, v, pad, scratch, o, lse, B, H, Nq, Nk, causal, s);
    case 384: return forward<384>(q, k, v, pad, scratch, o, lse, B, H, Nq, Nk, causal, s);
    case 448: return forward<448>(q, k, v, pad, scratch, o, lse, B, H, Nq, Nk, causal, s);
    case 512: return forward<512>(q, k, v, pad, scratch, o, lse, B, H, Nq, Nk, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
