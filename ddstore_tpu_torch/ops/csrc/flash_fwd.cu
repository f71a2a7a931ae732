// Flash-attention forward for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (ddstore_tpu_torch/ops/_build.py).
//
// Replaces the TPU kernel ddstore_tpu/ops/attention.py:_flash_kernel
// (:92-153, launched by _fwd_impl :169-210, pallas_call :182). It computes
// the same thing: for each (batch, head, query tile) an online softmax over
// the key/value tiles with a running max m, denominator l and accumulator
// acc in f32; causal tiles entirely in the future are skipped and only
// tiles that straddle the diagonal (or the ragged end of the keys) are
// masked, by the reference's liveness rule (_causal_liveness :40-50);
// global q_offset/kv_offset shift the causal frontier. A row masked so far
// keeps m = -inf without NaN, and a fully masked row ends as out 0 and
// lse -inf. out has the input dtype; lse is a thin f32 (B*H, S) tensor
// (the TPU's 128-lane lse padding is not carried over).
//
// What changes against the TPU: the TPU's sequential grid axis over key
// tiles becomes a loop inside the block, since nothing carries over
// between CUDA blocks; and the kernel masks the ragged last key tile and
// guards the ragged last query tile itself, so any length that is a
// multiple of 8 works without the TPU's block-divisibility rule. As the
// TPU's grid folds B*H into one axis (:177), every kernel's blocks lie on
// grid x alone, (tile block, batch, head) folded by sm90::tile_major:
// CUDA caps grid y and z at 65,535, which B, H and a long sequence's tile
// blocks each pass. The C entries return sm90::kErrGrid where x's
// 2^31 - 1 would not hold the grid.
//
// Head dims and dtypes: the TPU kernel takes any D (its block's last dim is
// the array's) and any float dtype. Here d is any multiple of 8 from 8 up
// (the wrapper zero-pads other head dims to the next multiple of 8 and
// slices the result back), in bf16, fp16 or f32. The 16-bit kernels are
// templated on the element type (sm90::Bf16, sm90::F16: the same tiles,
// barriers and register budgets, only the PTX type and the conversions
// differ), in four instantiations each, all TMA + wgmma: the tile widths
// 64 (d <= 64), 128 (d <= 128) and 256 (d <= 256), and past d = 256
// chunks of 256 (below). Their tensor maps declare the true d, so that TMA
// zero-fills the tile's columns past it (zero columns of Q and K leave the
// scores as they are, zero columns of V give zero columns of O, and the
// stores skip every column past d). The f32 kernel (TMA + 3xTF32 wgmma,
// after a split pass) owns O in blocks of 64, 128 or 256 columns (every d
// past 128), its features streamed in chunks of 32. Shared memory and
// registers are sized by the tile or chunk, never by d.
//
// Bound on the H100 SXM: the work is 4*B*H*Sq*Sk*D FLOPs (QK^T and PV,
// about half of that for causal) against 989 TFLOP/s in bf16, and the
// bytes are q, k, v read once and out, lse written once against 3.35 TB/s.
// At the LM's shape, (B, H, S, D) = (8, 16, 2048, 64) causal, that is
// 6.9e10 FLOP = 0.0695 ms against 1.35e8 B = 0.040 ms: operations bound it
// (and at (8, 4, 2048, 256) and (8, 2, 2048, 512) the same 0.0695 ms). In
// f32 the same products run as three TF32 products each at 495 TFLOP/s,
// 3 x 6.876e10 FLOP = 0.4167 ms (on the CUDA cores at 67 TFLOP/s, 1.026
// ms); its bytes, twice bf16's, take 0.08 ms.
//
// Design:
// * bf16, d <= 256: one block per (kWG x 64 query rows, head, batch), with
//   kWG = 3 consumer warpgroups at D = 64 and 2 at D = 128 and 256, plus
//   one producer warpgroup. The producer gives most of its registers to the
//   consumers (setmaxnreg), and one of its threads loads the Q tile once
//   and then streams K and V tiles by TMA into a ring of shared stages: 128
//   keys and 3 stages up to D = 128, 64 keys and 2 stages at D = 256 (a 64
//   KB Q tile and 64 KB stages). K and V of a stage each have a "full"
//   mbarrier, completed by TMA, and an "empty" one that hands them back: K
//   once S of the tile is done, V once P V is, so the next K loads a whole
//   softmax before the V beside it is free. Each consumer warpgroup owns 64
//   query rows: S = Q K^T is wgmma SS (both K-major), the online softmax
//   runs on the S accumulators in registers (exp2 on the SFU, the scale
//   folded into one FMA), and O += P V is wgmma RS with P packed to bf16
//   from the S accumulators and V read MN-major straight from its TMA tile
//   (no transpose in shared memory; at D = 256 one m64n256k16 a k-step, O
//   being 128 registers a thread). A software pipeline inside each
//   warpgroup issues S of tile i together with P V of tile i - 1, so the
//   tensor cores run that product while the softmax of tile i runs. Query
//   tiles launch heaviest first (the tile index, grid x's slowest part,
//   runs backwards), and each warpgroup skips the products of key tiles
//   its 64 rows cannot see. Tiles are 128-byte swizzled boxes of 64
//   columns; D = 128 is two boxes, D = 256 four (sm90.cuh). D = 256 takes
//   FlashAttention-3's shape (128 query rows, two consumer warpgroups)
//   with 64-key tiles: P of 64 keys is 16 registers beside O's 128 and
//   S's 32.
//   Left out: warp-specialised ping-pong between the consumer warpgroups
//   (softmax of one overlapping the products of the other on purpose, not
//   by chance), overlap of the next S product with this tile's softmax,
//   persistent blocks, a TMA store of out, 80-key tiles at D = 256 (a
//   third 64 KB stage does not fit), and tiles narrower than 64 features:
//   at d = 32 the tensor cores do the work of d = 64.
// * The same kernel in fp16: P is rounded to fp16 (2^-11) where bf16 rounds
//   it to bf16 (2^-8), as the reference rounds it to the input dtype.
// * bf16 and fp16, d > 256 (flash_fwd_chunked_kernel): a warpgroup's
//   registers hold 64 rows of O only up to 256 features, so O is taken in
//   nc = ceil(d / 256) chunks, one block per (128 query rows, chunk oc,
//   head, batch), the chunk index folded into the query-tile index
//   (a tile's chunks launch side by side, and share Q and K in L2). The
//   block has the D = 256 shape: two consumer warpgroups of 64 rows, each
//   holding its rows' chunk oc of O (128 registers a thread), and one
//   producer warpgroup, setmaxnreg 24 / 240. For each 64-key tile, one
//   producer thread streams the nc pairs (Q chunk c, 64 KB; K chunk c, 32
//   KB) through two 96 KB slots, and a second thread V's chunk oc (32 KB)
//   into a slot of its own, so that neither stream waits behind the other
//   (224 KB in all, sized by the chunk, not by d). Each consumer sums S =
//   Q_c K_c^T over the chunks in order (wgmma SS m64n64, each chunk's slot
//   handed back once its product is done), then runs the online softmax
//   and O += P V as at D = 256 (RS m64n256k16, issued after the next
//   tile's last S chunk, so that it runs during that tile's softmax).
//   Every chunk's block forms the same S in the same order, so m, l and P
//   agree bit for bit, and chunk 0 stores lse. What it costs: S is formed
//   nc times (at d 512, 1.5x the forward's minimal work), and Q is read
//   again for every key tile (from L2). Left out: a cluster of the nc
//   blocks sharing S through distributed shared memory, and overlap of a
//   tile's S chunks with one another (each waits for the one before).
// * f32 (flash_fwd_tf32_kernel, below): the tensor cores take f32 only as
//   TF32 (10 mantissa bits, about 5e-4 a product, which misses f32's 1e-4
//   a row), so each product runs as three TF32 products (hi hi + hi lo +
//   lo hi, about 2^-21 a product). A split pass writes hi and lo of Q, K
//   and V^T once a call into scratch planes (V transposed, since TF32
//   wgmma reads both operands K-major, each group of 8 keys in the order
//   P's accumulators hold them as A fragments); splitting a landed tile
//   in the kernel, as the f32 backward does, would split each K/V tile
//   once for every query block that reads it. The block has the 16-bit
//   kernels' shape (two consumer warpgroups of 64 rows, a producer thread
//   streaming TMA loads through a ring of stages): S summed a 32-feature
//   chunk at a time, each chunk afresh on the tensor cores and added in
//   f32 (a long tensor-core sum loses bits toward zero), the online
//   softmax on the accumulators, P split in registers, and each tile's P
//   V summed afresh and added into O in f32. Past d = 128 a block owns
//   256 columns of O (a chunk of them past 256) and forms S over all of
//   d; the features stream in chunks of 32, so shared memory does not
//   grow with d. Bound by the split pass's bytes (three f32 planes in, six
//   out) and by the chunk-at-a-time waits inside a warpgroup (S and P V of
//   a warpgroup never overlap; the other warpgroup fills the gaps).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // (B*H, Sq), contiguous
  // element strides of (batch, head, sequence); the feature stride is 1
  long long sqb, sqh, sqs;
  long long skb, skh, sks;
  long long svb, svh, svs;
  long long sob, soh, sos;
  int h, sq, sk;
  int d;  // head dim, a multiple of 8 up to the instantiation's width
  int causal;
  long long q_offset, kv_offset;
  float scale;
};

// The reference's single causal classification of a (query tile, key
// tile) pair: live = any unmasked entry; diag = straddles the diagonal.
template <int BQ, int BK>
__device__ __forceinline__ void causal_liveness(long long q_lo,
                                                long long k_lo, bool& live,
                                                bool& diag) {
  live = k_lo <= q_lo + BQ - 1;
  diag = live && (k_lo + BK - 1 > q_lo);
}

// ---------------------------------------------------------------------------
// bf16 and fp16, d <= 256: TMA tile ring + wgmma

// One block: kWG consumer warpgroups of 64 query rows each and one
// producer warpgroup. Three consumers at D = 64 (more warps to hide the
// softmax's latencies), two at D = 128 and 256 (their O accumulators take
// the registers of the third). setmaxnreg moves the producer's registers
// to the consumers: 32 + 3 x 160 per 128 threads at D = 64, 40 + 2 x 232
// at 128, 24 + 2 x 240 at 256 (O alone is 128 registers a thread there).
// Key tiles of kBN keys run through a ring of kStages stages: 128 keys and
// three stages up to D = 128; at D = 256, 64 keys and two stages, which is
// what fits beside the 64 KB Q tile (a stage holds 64 KB of K and V).
template <int D>
struct FwdCfg {
  static constexpr int kWG = D == 64 ? 3 : 2;
  static constexpr int kBM = 64 * kWG;  // query rows per block
  static constexpr int kBN = D == 256 ? 64 : 128;  // keys per tile
  static constexpr int kStages = D == 256 ? 2 : 3;
  static constexpr int kConsumers = 128 * kWG;
  static constexpr int kThreads = kConsumers + 128;
  static constexpr int kProducerRegs = kWG == 3 ? 32 : D == 256 ? 24 : 40;
  static constexpr int kConsumerRegs = kWG == 3 ? 160 : D == 256 ? 240 : 232;
  // Shared memory, from a 1024-byte aligned base: the Q tile, then per
  // stage a K tile and a V tile, then the barriers. A tile is D / 64
  // boxes of its rows x 128 bytes.
  static constexpr int kKBox = kBN * 128;
  static constexpr int kQBox = kBM * 128;
  static constexpr int kKT = (D / 64) * kKBox;
  static constexpr int kQT = (D / 64) * kQBox;
  static constexpr int kQ = 0;
  static constexpr int kKV = kQT;  // stage s: K at kKV + 2 s kKT, V after
  static constexpr int kBar = kKV + kStages * 2 * kKT;
  // q_full, then full and empty barriers of K and of V per stage
  static constexpr int kBytes = kBar + (1 + 4 * kStages) * 8 + 1024;
  static_assert(kBytes <= 232448, "shared memory of one H100 block");
};

struct FwdParams {
  CUtensorMap q;     // boxes of 64 features x kBM rows
  CUtensorMap k, v;  // boxes of 64 features x kBN rows
  void* o;           // E::T
  float* lse;
  long long sob, soh, sos;
  int h, sq, sk;
  int d;  // true head dim: the stores skip the tile's columns past it
  int causal;
  long long q_offset, kv_offset;
  float scale;  // nonzero (the C entry maps 0 to a tiny positive scale)
  sm90::Fold fold;  // the grid's blocks on x (sm90::GridPos)
};

// Key tiles [0, n) of BN keys that rows [q_lo, q_lo + rows) of the
// (global) query sequence run over: all of them, or (causal) up to the
// last live one.
template <int BN>
__device__ __forceinline__ int fwd_key_tiles(const FwdParams& p,
                                             long long q_lo, int rows) {
  const int nk = (p.sk + BN - 1) / BN;
  if (!p.causal) return nk;
  const long long x = q_lo + rows - 1 - p.kv_offset;
  if (x < 0) return 0;
  return static_cast<int>(x / BN + 1 < nk ? x / BN + 1 : nk);
}

// The online softmax of one tile of BN keys starting at key k0, on the raw
// scores in sc (the m64nBN accumulators of rows row0: e = 0, 1 and row0 +
// 8: e = 2, 3, of a warpgroup whose 64 rows start at global position q_lo;
// keys k0 + 8 j + 2 t + e % 2). Only diagonal and ragged tiles are masked,
// in a pass of their own, with the masked scores set to a fill whose
// product with sl2 is -inf. The row max of S sl2 is the max of the raw
// scores times sl2 (their min if sl2 < 0), and P = exp2(S sl2 - m) takes
// one FMA. Leaves P in sc, updates the running max m_r (log2 units) and
// this thread's share of the denominators l_r, and leaves in corr the
// factor the O accumulators must be rescaled by.
template <int BN>
__device__ __forceinline__ void online_softmax(
    const FwdParams& p, float (&sc)[BN / 2], float (&m_r)[2],
    float (&l_r)[2], float (&corr)[2], float sl2, long long q_lo, int row0,
    int k0, int t) {
  const float fill = sl2 > 0.f ? -INFINITY : INFINITY;
  bool live = true, diag = false;
  if (p.causal) causal_liveness<64, BN>(q_lo, p.kv_offset + k0, live, diag);
  if (diag || k0 + BN > p.sk) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + 8 * (e >> 1);
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        if (col >= p.sk ||
            (p.causal && p.kv_offset + col > p.q_offset + row))
          sc[4 * j + e] = fill;
      }
  }
  float mt[2][2];  // two chains per row
  if (sl2 > 0.f) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mt[hr][0] = fmaxf(sc[2 * hr], sc[2 * hr + 1]);
      mt[hr][1] = fmaxf(sc[4 + 2 * hr], sc[4 + 2 * hr + 1]);
#pragma unroll
      for (int j = 2; j < BN / 8; ++j)
        mt[hr][j & 1] = fmaxf(mt[hr][j & 1], fmaxf(sc[4 * j + 2 * hr],
                                                   sc[4 * j + 2 * hr + 1]));
    }
  } else {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mt[hr][0] = fminf(sc[2 * hr], sc[2 * hr + 1]);
      mt[hr][1] = fminf(sc[4 + 2 * hr], sc[4 + 2 * hr + 1]);
#pragma unroll
      for (int j = 2; j < BN / 8; ++j)
        mt[hr][j & 1] = fminf(mt[hr][j & 1], fminf(sc[4 * j + 2 * hr],
                                                   sc[4 * j + 2 * hr + 1]));
    }
  }
  float safe[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float mx = sl2 > 0.f ? fmaxf(mt[hr][0], mt[hr][1])
                         : fminf(mt[hr][0], mt[hr][1]);
    mx *= sl2;
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_r[hr], mx);
    // Rows masked so far keep m = -inf; subtracting 0 instead keeps
    // exp2(-inf - 0) = 0 exact, with no inf - inf.
    safe[hr] = m_new == -INFINITY ? 0.f : m_new;
    corr[hr] = m_r[hr] == -INFINITY ? 0.f
                                    : sm90::exp2_approx(m_r[hr] - safe[hr]);
    m_r[hr] = m_new;
  }
  float sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pr =
          sm90::exp2_approx(fmaf(sc[4 * j + e], sl2, -safe[e >> 1]));
      sc[4 * j + e] = pr;
      sum[e >> 1][e & 1] += pr;
    }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr)
    l_r[hr] = l_r[hr] * corr[hr] + (sum[hr][0] + sum[hr][1]);
}

// The S accumulators of key columns [16 kk, 16 kk + 16), rounded to E, are
// the A fragment of k-step kk of P V.
template <class E, int BN>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BN / 16][4],
                                       const float (&sc)[BN / 2]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kk][r] = sm90::pack<E>(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
}

// O's accumulators (64 rows x D columns of a warpgroup) times each row's
// correction factor.
template <int D>
__device__ __forceinline__ void rescale(float (&o)[D / 2],
                                        const float (&corr)[2]) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    o[4 * j] *= corr[0];
    o[4 * j + 1] *= corr[0];
    o[4 * j + 2] *= corr[1];
    o[4 * j + 3] *= corr[1];
  }
}

// The epilogue: rows row0 and row0 + 8 of O (the accumulators of columns
// f0 + 8 j + 2 t, those below d) divided by their sums and stored in E,
// and, where store_lse, their lse = m ln 2 + log l (-inf for a row masked
// throughout). Rows past Sq are not stored.
template <int D, class E>
__device__ __forceinline__ void store_rows(const FwdParams& p,
                                           const float (&o)[D / 2],
                                           const float (&m_r)[2],
                                           const float (&l_r)[2], int bb,
                                           int hh, int row0, int t, int f0,
                                           bool store_lse) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float l = l_r[hr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float lc = fmaxf(l, 1e-30f);
    const float inv = 1.f / lc;
    const int row = row0 + 8 * hr;
    if (row < p.sq) {
      typename E::T* op = static_cast<typename E::T*>(p.o) +
                          static_cast<long long>(bb) * p.sob +
                          static_cast<long long>(hh) * p.soh +
                          static_cast<long long>(row) * p.sos + f0;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        if (f0 + 8 * j < p.d)
          *reinterpret_cast<typename E::T2*>(op + 8 * j + 2 * t) =
              E::pack2(o[4 * j + 2 * hr] * inv, o[4 * j + 2 * hr + 1] * inv);
      if (store_lse && t == 0)
        p.lse[(static_cast<long long>(bb) * p.h + hh) * p.sq + row] =
            m_r[hr] == -INFINITY ? -INFINITY : m_r[hr] * kLn2 + logf(lc);
    }
  }
}

template <int D, class E>
__global__ void __launch_bounds__(FwdCfg<D>::kThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ FwdParams p) {
  using C = FwdCfg<D>;
  constexpr int BN = C::kBN, S = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sm90::align1024(smem_raw);
  // K and V of a stage have barriers of their own: K is handed back once
  // S = Q K^T is done, V only after P V, so that the producer can load the
  // next K tile a whole softmax earlier.
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::kBar);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + S;
  uint64_t* k_empty = v_full + S;
  uint64_t* v_empty = k_empty + S;

  const sm90::GridPos pos = sm90::tile_major(p.fold);
  const int hh = pos.h, bb = pos.b;
  const int q0 = (p.fold.tiles.d - 1 - pos.t) * C::kBM;  // heaviest first
  const int n = fwd_key_tiles<BN>(p, p.q_offset + q0, C::kBM);
  const int tid = threadIdx.x;

  if (tid == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&k_full[s], 1);
      sm90::mbar_init(&v_full[s], 1);
      sm90::mbar_init(&k_empty[s], C::kConsumers);
      sm90::mbar_init(&v_empty[s], C::kConsumers);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= C::kConsumers) {
    // Producer warpgroup: one thread issues every load.
    sm90::reg_dealloc<C::kProducerRegs>();
    if (tid == C::kConsumers) {
      sm90::mbar_arrive_expect_tx(q_full, C::kQT);
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        sm90::tma_load_4d(smem + C::kQ + c * C::kQBox, &p.q, q_full, c * 64,
                          q0, hh, bb);
      for (int i = 0; i < n; ++i) {
        const int s = i % S;
        const uint32_t vacant = ((i / S) & 1) ^ 1;
        uint8_t* ks = smem + C::kKV + s * 2 * C::kKT;
        sm90::mbar_wait(&k_empty[s], vacant);
        sm90::mbar_arrive_expect_tx(&k_full[s], C::kKT);
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          sm90::tma_load_4d(ks + c * C::kKBox, &p.k, &k_full[s], c * 64,
                            i * BN, hh, bb);
        sm90::mbar_wait(&v_empty[s], vacant);
        sm90::mbar_arrive_expect_tx(&v_full[s], C::kKT);
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          sm90::tma_load_4d(ks + C::kKT + c * C::kKBox, &p.v, &v_full[s],
                            c * 64, i * BN, hh, bb);
      }
    }
  } else {
    // Consumer warpgroup w: query rows [64 w, 64 w + 64) of the block.
    sm90::reg_alloc<C::kConsumerRegs>();
    const int w = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int r0 = 64 * w + 16 * warp + g;  // rows r0 and r0 + 8
    const uint8_t* qs = smem + C::kQ + w * 64 * 128;
    const float sl2 = p.scale * kLog2e;
    const long long q_lo = p.q_offset + q0 + 64 * w;
    // Tiles [0, nw) are live for these 64 rows; a causal tail of the
    // block's tiles may lie wholly in their future.
    const int nw = fwd_key_tiles<BN>(p, q_lo, 64) < n
                       ? fwd_key_tiles<BN>(p, q_lo, 64)
                       : n;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m_r[2] = {-INFINITY, -INFINITY};  // running max of S sl2
    float l_r[2] = {0.f, 0.f};  // this thread's share of the row sums
    float sc[BN / 2];            // S of one tile, then its P in f32
    uint32_t pa[BN / 16][4];     // P in E: the A fragments of P V
    float corr[2];

    auto stage = [&](int i) {
      return smem + C::kKV + (i % S) * 2 * C::kKT;
    };
    // S = Q K^T of tile i, 64 rows x BN keys (issued, not waited).
    auto issue_s = [&](int i) {
      const uint8_t* ks = stage(i);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm90::Wgmma<BN, E>::ss(
            sc, sm90::desc_k(qs + (kk / 4) * C::kQBox + (kk % 4) * 32),
            sm90::desc_k(ks + (kk / 4) * C::kKBox + (kk % 4) * 32), kk > 0);
      sm90::wgmma_commit();
    };
    // O += P V of tile i: V's keys run down its rows (MN-major).
    auto issue_pv = [&](int i) {
      const uint8_t* vs = stage(i) + C::kKT;
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        sm90::Wgmma<D, E>::rs_mn(o, pa[kk],
                              sm90::desc_mn(vs + kk * 16 * 128, C::kKBox),
                              1);
      sm90::wgmma_commit();
    };
    auto softmax = [&](int i) {
      online_softmax<BN>(p, sc, m_r, l_r, corr, sl2, q_lo, q0 + r0, i * BN,
                         t);
    };
    auto wait_k = [&](int i) {
      sm90::mbar_wait(&k_full[i % S], (i / S) & 1);
    };
    auto wait_v = [&](int i) {
      sm90::mbar_wait(&v_full[i % S], (i / S) & 1);
    };

    // Software pipeline over the live tiles: while the softmax of tile i
    // runs on the CUDA cores, the tensor cores run O += P V of tile i - 1
    // (and the other warpgroups' products).
    sm90::mbar_wait(q_full, 0);
    if (nw > 0) {
      wait_k(0);
      issue_s(0);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);
      sm90::mbar_arrive(&k_empty[0]);
      softmax(0);
      pack_p<E, BN>(pa, sc);
      for (int i = 1; i < nw; ++i) {
        wait_k(i);
        issue_s(i);
        wait_v(i - 1);
        issue_pv(i - 1);
        sm90::wgmma_wait<1>();  // S of tile i; P V of tile i - 1 in flight
        sm90::fence_regs(sc);
        sm90::mbar_arrive(&k_empty[i % S]);  // K of tile i may be refilled
        softmax(i);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(o);
        sm90::mbar_arrive(&v_empty[(i - 1) % S]);
        rescale<D>(o, corr);
        pack_p<E, BN>(pa, sc);
      }
      wait_v(nw - 1);
      issue_pv(nw - 1);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
      sm90::mbar_arrive(&v_empty[(nw - 1) % S]);
    }
    for (int i = nw; i < n; ++i) {  // tiles only other warpgroups see
      wait_k(i);
      sm90::mbar_arrive(&k_empty[i % S]);
      wait_v(i);
      sm90::mbar_arrive(&v_empty[i % S]);
    }
    store_rows<D, E>(p, o, m_r, l_r, bb, hh, q0 + r0, t, 0, true);
  }
}

// The 16-bit kernels' parameters: tensor maps of Q in boxes of `bm` rows,
// of K and V in boxes of `bn`, all spanning the true d (TMA zero-fills
// the boxes past it).
template <class E>
int fwd_params(FwdParams& p, const Args& a, int b, int bm, int bn) {
  int err = sm90::encode_rows<E>(&p.q, a.q, a.d, a.sq, a.h, b, a.sqs, a.sqh,
                                 a.sqb, bm);
  if (!err)
    err = sm90::encode_rows<E>(&p.k, a.k, a.d, a.sk, a.h, b, a.sks, a.skh,
                               a.skb, bn);
  if (!err)
    err = sm90::encode_rows<E>(&p.v, a.v, a.d, a.sk, a.h, b, a.svs, a.svh,
                               a.svb, bn);
  if (err) return err;
  p.o = a.o;
  p.lse = a.lse;
  p.sob = a.sob;
  p.soh = a.soh;
  p.sos = a.sos;
  p.h = a.h;
  p.sq = a.sq;
  p.sk = a.sk;
  p.d = a.d;
  p.causal = a.causal;
  p.q_offset = a.q_offset;
  p.kv_offset = a.kv_offset;
  // A zero scale makes every score 0; 1e-30 gives exp2(S 1e-30 log2e - m)
  // = 1 exactly as well, and keeps masked scores at -inf (fill * scale).
  p.scale = a.scale == 0.f ? 1e-30f : a.scale;
  return 0;
}

template <int D, class E>
int launch_wgmma(const Args& a, int b, cudaStream_t stream) {
  using C = FwdCfg<D>;
  const int nt = (a.sq + C::kBM - 1) / C::kBM;
  const unsigned blocks = sm90::folded_blocks(nt, b, a.h);
  if (blocks == 0) return sm90::kErrGrid;
  FwdParams p;
  const int err = fwd_params<E>(p, a, b, C::kBM, C::kBN);
  if (err) return err;
  p.fold = sm90::fold(nt, b, a.h);
  constexpr int bytes = C::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<D, E>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(blocks);
  flash_fwd_wgmma_kernel<D, E><<<grid, C::kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 and fp16, d > 256: TMA + wgmma in chunks of 256 features

// One block per (128 query rows, chunk oc of O's nc = ceil(d / 256)
// feature chunks, head, batch), in FwdCfg<256>'s shape: two consumer
// warpgroups of 64 rows, each holding its rows' chunk oc of O as 128
// registers a thread, and one producer warpgroup (setmaxnreg 24 / 240).
// For each 64-key tile, warp 0 of the producer streams the nc pairs (Q
// chunk c, 64 KB; K chunk c, 32 KB) through two 96 KB slots, and warp 1
// streams V's chunk oc (32 KB) into a slot of its own, so that neither
// stream waits behind the other. S = Q K^T sums the chunks in order (wgmma
// SS m64n64), then the softmax and P V run as at D = 256. Shared memory is
// sized by the chunk, never by d.
struct FwdChunkCfg {
  static constexpr int kBM = 128;  // query rows per block
  static constexpr int kBN = 64;   // keys per tile
  static constexpr int kSlots = 2;
  static constexpr int kQBox = kBM * 128;
  static constexpr int kKBox = kBN * 128;
  static constexpr int kQT = 4 * kQBox;  // a 256-feature chunk of Q
  static constexpr int kKT = 4 * kKBox;  // of K or V
  static constexpr int kSlot = kQT + kKT;
  static constexpr int kV = kSlots * kSlot;
  static constexpr int kBar = kV + kKT;
  // qk_full and qk_empty per slot, then v_full and v_empty
  static constexpr int kBytes = kBar + (2 * kSlots + 2) * 8 + 1024;
  static_assert(kBytes <= 232448, "shared memory of one H100 block");
};

template <class E>
__global__ void __launch_bounds__(FwdCfg<256>::kThreads, 1)
    flash_fwd_chunked_kernel(const __grid_constant__ FwdParams p) {
  using C = FwdChunkCfg;
  using W = FwdCfg<256>;
  constexpr int BN = C::kBN, S = C::kSlots;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sm90::align1024(smem_raw);
  uint64_t* qk_full = reinterpret_cast<uint64_t*>(smem + C::kBar);
  uint64_t* qk_empty = qk_full + S;
  uint64_t* v_full = qk_empty + S;
  uint64_t* v_empty = v_full + 1;

  const sm90::GridPos pos = sm90::tile_major(p.fold);
  const int hh = pos.h, bb = pos.b;
  const int tid = threadIdx.x;
  // The block's query tile and chunk of O; the tile blocks run backwards
  // (heaviest tiles first), a tile's chunks side by side. Each role works
  // these out after its setmaxnreg, so that nothing stays live across it.
  auto place = [&](int& nc, int& q0, int& oc) {
    nc = (p.d + 255) / 256;
    const int z = p.fold.tiles.d - 1 - pos.t;
    q0 = z / nc * C::kBM;
    oc = z % nc;
  };

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&qk_full[s], 1);
      sm90::mbar_init(&qk_empty[s], W::kConsumers);
    }
    sm90::mbar_init(v_full, 1);
    sm90::mbar_init(v_empty, W::kConsumers);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= W::kConsumers) {
    sm90::reg_dealloc<W::kProducerRegs>();
    int nc, q0, oc;
    place(nc, q0, oc);
    const int n = fwd_key_tiles<BN>(p, p.q_offset + q0, C::kBM);
    if (tid == W::kConsumers) {
      // the Q and K chunk pairs of every tile, through the slots
      int s = 0;
      uint32_t phase = 0;
      for (int i = 0; i < n; ++i)
        for (int c = 0; c < nc; ++c) {
          sm90::mbar_wait(&qk_empty[s], phase ^ 1);
          sm90::mbar_arrive_expect_tx(&qk_full[s], C::kSlot);
          uint8_t* st = smem + s * C::kSlot;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            sm90::tma_load_4d(st + j * C::kQBox, &p.q, &qk_full[s],
                              256 * c + 64 * j, q0, hh, bb);
            sm90::tma_load_4d(st + C::kQT + j * C::kKBox, &p.k, &qk_full[s],
                              256 * c + 64 * j, i * BN, hh, bb);
          }
          if (++s == S) {
            s = 0;
            phase ^= 1;
          }
        }
    } else if (tid == W::kConsumers + 32) {
      // V's chunk oc of every tile
      for (int i = 0; i < n; ++i) {
        sm90::mbar_wait(v_empty, (i & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(v_full, C::kKT);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sm90::tma_load_4d(smem + C::kV + j * C::kKBox, &p.v, v_full,
                            256 * oc + 64 * j, i * BN, hh, bb);
      }
    }
  } else {
    // Consumer warpgroup w: query rows [64 w, 64 w + 64) of the block.
    sm90::reg_alloc<W::kConsumerRegs>();
    int nc, q0, oc;
    place(nc, q0, oc);
    const int n = fwd_key_tiles<BN>(p, p.q_offset + q0, C::kBM);
    const int w = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    const int t = lane % 4;
    const int r0 = 64 * w + 16 * warp + lane / 4;  // rows r0 and r0 + 8
    const float sl2 = p.scale * kLog2e;
    const long long q_lo = p.q_offset + q0 + 64 * w;
    // Tiles [0, nw) are live for these 64 rows.
    const int nw = fwd_key_tiles<BN>(p, q_lo, 64) < n
                       ? fwd_key_tiles<BN>(p, q_lo, 64)
                       : n;

    float o[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) o[i] = 0.f;
    float m_r[2] = {-INFINITY, -INFINITY};
    float l_r[2] = {0.f, 0.f};
    float sc[BN / 2];
    uint32_t pa[BN / 16][4];
    float corr[2];
    // the slot of the next Q and K chunk pair, and its pass round the ring
    int s = 0;
    uint32_t phase = 0;
    auto next_slot = [&]() {
      if (++s == S) {
        s = 0;
        phase ^= 1;
      }
    };
    // S += Q_c K_c^T from the current slot (issued, not waited); the
    // first chunk's first k-step overwrites S.
    auto issue_s = [&](int c) {
      const uint8_t* qs = smem + s * C::kSlot + w * 64 * 128;
      const uint8_t* ks = smem + s * C::kSlot + C::kQT;
      sm90::mbar_wait(&qk_full[s], phase);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 16; ++kk)
        sm90::Wgmma<BN, E>::ss(
            sc, sm90::desc_k(qs + (kk / 4) * C::kQBox + (kk % 4) * 32),
            sm90::desc_k(ks + (kk / 4) * C::kKBox + (kk % 4) * 32),
            (c | kk) != 0);
      sm90::wgmma_commit();
    };
    // Every chunk of S but the last, each waited for and its slot handed
    // back; the last one's product stays in flight.
    auto issue_s_tile = [&]() {
      for (int c = 0; c + 1 < nc; ++c) {
        issue_s(c);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(sc);
        sm90::mbar_arrive(&qk_empty[s]);
        next_slot();
      }
      issue_s(nc - 1);
    };
    auto issue_pv = [&]() {
      const uint8_t* vs = smem + C::kV;
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        sm90::Wgmma<256, E>::rs_mn(
            o, pa[kk], sm90::desc_mn(vs + kk * 16 * 128, C::kKBox), 1);
      sm90::wgmma_commit();
    };
    auto softmax = [&](int i) {
      online_softmax<BN>(p, sc, m_r, l_r, corr, sl2, q_lo, q0 + r0, i * BN,
                         t);
    };

    // The forward's pipeline: while the softmax of tile i runs, the tensor
    // cores run O += P V of tile i - 1.
    if (nw > 0) {
      issue_s_tile();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);
      sm90::mbar_arrive(&qk_empty[s]);
      next_slot();
      softmax(0);
      pack_p<E, BN>(pa, sc);
      for (int i = 1; i < nw; ++i) {
        issue_s_tile();
        sm90::mbar_wait(v_full, (i - 1) & 1);
        issue_pv();
        sm90::wgmma_wait<1>();  // S of tile i; P V of tile i - 1 in flight
        sm90::fence_regs(sc);
        sm90::mbar_arrive(&qk_empty[s]);
        next_slot();
        softmax(i);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(o);
        sm90::mbar_arrive(v_empty);
        rescale<256>(o, corr);
        pack_p<E, BN>(pa, sc);
      }
      sm90::mbar_wait(v_full, (nw - 1) & 1);
      issue_pv();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
      sm90::mbar_arrive(v_empty);
    }
    for (int i = nw; i < n; ++i) {  // tiles only the other warpgroup sees
      for (int c = 0; c < nc; ++c) {
        sm90::mbar_wait(&qk_full[s], phase);
        sm90::mbar_arrive(&qk_empty[s]);
        next_slot();
      }
      sm90::mbar_wait(v_full, i & 1);
      sm90::mbar_arrive(v_empty);
    }
    // Every chunk's block formed the same S in the same order, so the same
    // m, l and P: chunk 0 stores lse.
    store_rows<256, E>(p, o, m_r, l_r, bb, hh, q0 + r0, t, 256 * oc,
                       oc == 0);
  }
}

template <class E>
int launch_chunked(const Args& a, int b, cudaStream_t stream) {
  using C = FwdChunkCfg;
  const int nc = (a.d + 255) / 256;
  const long long nt =
      static_cast<long long>((a.sq + C::kBM - 1) / C::kBM) * nc;
  const unsigned blocks = sm90::folded_blocks(nt, b, a.h);
  if (blocks == 0) return sm90::kErrGrid;
  FwdParams p;
  const int err = fwd_params<E>(p, a, b, C::kBM, C::kBN);
  if (err) return err;
  p.fold = sm90::fold(nt, b, a.h);
  constexpr int bytes = C::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_chunked_kernel<E>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(blocks);
  flash_fwd_chunked_kernel<E>
      <<<grid, FwdCfg<256>::kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// f32: the split pass, then TMA + 3xTF32 wgmma

// Every f32 product x y runs as three TF32 products on the tensor cores,
// x_hi y_hi + x_hi y_lo + x_lo y_hi, with x_hi = rna_tf32(x) and x_lo =
// rna_tf32(x - x_hi) (sm90.cuh: about 2^-21 relative a product). The split
// pass (tf32_split_kernel, launched by the wrapper before the forward on
// the same stream) writes hi and lo of Q, K and V once a call into planes
// in scratch: Q as (2, B*H, Sq, d) rows, K as (2, B*H, Sk, d), V transposed
// as (2, B*H, d, Sk8), Sk8 = Sk rounded up to a multiple of 8 (at least 8),
// each group of 8 keys in tf32_kpos order and keys past Sk zero. A key
// tile of K and V is read by up to Sq / 128 query blocks; split there, it
// would be split once for each.

constexpr int kSplitThreads = 256;

struct SplitParams {
  const float* x[3];  // q, k, v
  long long sb[3], sh[3], ss[3];  // their element strides; feature stride 1
  float* planes[3];               // hi planes of Q, K, V^T; lo right after
  int rows[3];                    // sq, sk, sk
  int h, bh, d, sk8;
};

// Floats of one plane of Q, K or V^T.
__host__ __device__ inline long long plane_floats(long long bh, int d,
                                                  int s) {
  return bh * d * s;
}

// One block per (32 rows or keys, 32 features, head, batch, operand z):
// the tile is read along its rows into shared memory, split, and written
// along the rows of the plane (Q, K) or along the keys of V^T's rows.
__global__ void __launch_bounds__(kSplitThreads)
    tf32_split_kernel(const __grid_constant__ SplitParams p) {
  __shared__ float tile[32][33];
  const int z = blockIdx.z;
  const int rows = p.rows[z];
  const int extent = z == 2 ? p.sk8 : rows;  // rows (keys) of the plane
  const int ft = (p.d + 31) / 32;
  const int r0 = static_cast<int>(blockIdx.x) / ft * 32;
  const int f0 = static_cast<int>(blockIdx.x) % ft * 32;
  if (r0 >= extent) return;
  const long long lo = plane_floats(p.bh, p.d, extent);
  for (int bh = blockIdx.y; bh < p.bh; bh += gridDim.y) {
    const float* x = p.x[z] + static_cast<long long>(bh / p.h) * p.sb[z] +
                     static_cast<long long>(bh % p.h) * p.sh[z];
    __syncthreads();  // the previous head's tile is read
    for (int e = threadIdx.x; e < 32 * 32; e += kSplitThreads) {
      const int r = e / 32, f = e % 32;
      tile[r][f] = r0 + r < rows && f0 + f < p.d
                       ? x[(r0 + r) * p.ss[z] + f0 + f]
                       : 0.f;
    }
    __syncthreads();
    float* out = p.planes[z] + plane_floats(bh, p.d, extent);
    for (int e = threadIdx.x; e < 32 * 32; e += kSplitThreads) {
      // Q, K: row r, feature f; V^T: feature f (row), key r (column)
      const int r = z == 2 ? e % 32 : e / 32, f = z == 2 ? e / 32 : e % 32;
      if (r0 + r >= extent || f0 + f >= p.d) continue;
      const long long at =
          z == 2 ? static_cast<long long>(f0 + f) * extent +
                       sm90::tf32_kpos(r0 + r)
                 : static_cast<long long>(r0 + r) * p.d + f0 + f;
      const float v = tile[r][f], h = sm90::tf32_rna(v);
      out[at] = h;
      out[at + lo] = sm90::tf32_rna(v - h);
    }
  }
}

// One block per (128 query rows, chunk oc of O's columns, head, batch),
// in FwdCfg<256>'s shape: two consumer warpgroups of 64 rows and a
// producer warpgroup whose one thread issues every TMA load, setmaxnreg
// 24 / 240. O's columns come in blocks of DO = 64 or 128 (d <= DO) or 256
// (any d past 128: nco = ceil(d / 256) blocks a query tile, every chunk's
// block forming the same S in the same order, chunk 0 storing lse).
// Shared memory does not grow with d: for each tile of BN keys (64 at DO
// <= 128; 32 at 256, where O takes 128 registers a thread and P's hi and
// lo fragments of 64 keys with them spilled) a ring of slots streams nc =
// ceil(d / 32) S items, then no = ceil(DO' / 32) P V items (DO' the
// block's columns below d):
// * S item c: K's BN rows x features [32 c, 32 c + 32), hi and lo (BN x
//   128 bytes each); at DO = 256 also Q's 128 rows of the same features
//   (16 KB each). At DO <= 128 Q's planes stay resident (64 or 128 KB).
// * P V item o: V^T's rows f0 + [32 o, 32 o + 32) x the tile's keys, hi
//   and lo, each in 32-key boxes (4 KB).
// Each consumer forms S = Q K^T a chunk at a time, each chunk summed
// afresh by 12 products m64nBNk8 (sm90::tf32_ss_chunk) and added in f32;
// the online softmax on the accumulators, as the 16-bit kernels run it;
// P split into A fragments (tf32_frags), and each chunk of 32 columns of
// P V summed afresh (tf32_rs, m64n32k8) and added into O in f32. Each item
// is waited out before the next (the other warpgroup's products fill the
// gap). Left out: overlap of S with P V inside a warpgroup, a resident Q
// past 128 (its 256 KB do not fit), persistent blocks.
template <int DO>
struct F32Cfg {
  static constexpr int kBN = DO == 256 ? 32 : 64;  // keys per tile
  static constexpr bool kResident = DO <= 128;
  static constexpr int kQPlane = 128 * 128;  // 128 rows x 32 floats
  static constexpr int kKPlane = kBN * 128;  // BN rows x 32 floats
  static constexpr int kVBoxes = kBN / 32;   // of V^T, a plane
  static constexpr int kVItem = 2 * kVBoxes * sm90::kTfBox;
  static constexpr int kSItem = (kResident ? 0 : 2 * kQPlane) + 2 * kKPlane;
  static constexpr int kSlot = kSItem > kVItem ? kSItem : kVItem;
  static constexpr int kQ = 0;  // resident Q: chunk c's hi at 2 c kQPlane
  static constexpr int kRing = kResident ? (DO / 32) * 2 * kQPlane : 0;
  static constexpr int kStages = DO == 64 ? 8 : DO == 128 ? 6 : 5;
  static constexpr int kBar = kRing + kStages * kSlot;
  // q_full, then full and empty per stage
  static constexpr int kBytes = kBar + (1 + 2 * kStages) * 8 + 1024;
  static_assert(kBytes <= 232448, "shared memory of one H100 block");
};

// The f32 output of store_rows.
struct F32Out {
  using T = float;
  using T2 = float2;
  static __device__ __forceinline__ T2 pack2(float lo, float hi) {
    return make_float2(lo, hi);
  }
};

template <int DO>
__global__ void __launch_bounds__(FwdCfg<256>::kThreads, 1)
    flash_fwd_tf32_kernel(const __grid_constant__ FwdParams p) {
  using C = F32Cfg<DO>;
  using W = FwdCfg<256>;
  constexpr int BN = C::kBN, S = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sm90::align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::kBar);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + S;

  const sm90::GridPos pos = sm90::tile_major(p.fold);
  const int hh = pos.h, bb = pos.b;
  const int tid = threadIdx.x;
  // The block's query tile and columns of O (heaviest tiles first, a
  // tile's chunks side by side), its S and P V items a key tile, and its
  // key tiles. Each role works these out after its setmaxnreg, so that
  // nothing stays live across it.
  auto place = [&](int& q0, int& f0, int& nc, int& no, int& n) {
    const int nco = (p.d + DO - 1) / DO;
    const int z = p.fold.tiles.d - 1 - pos.t;
    q0 = z / nco * 128;
    f0 = z % nco * DO;
    nc = (p.d + 31) / 32;
    const int left = p.d - f0;
    no = ((left < DO ? left : DO) + 31) / 32;
    n = fwd_key_tiles<BN>(p, p.q_offset + q0, 128);
  };

  if (tid == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], W::kConsumers);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= W::kConsumers) {
    // Producer warpgroup: one thread issues every load.
    sm90::reg_dealloc<W::kProducerRegs>();
    if (tid == W::kConsumers) {
      int q0, f0, nc, no, n;
      place(q0, f0, nc, no, n);
      const int bh = bb * p.h + hh, per = nc + no;
      if constexpr (C::kResident) {
        sm90::mbar_arrive_expect_tx(q_full, nc * 2 * C::kQPlane);
        for (int c = 0; c < nc; ++c)
          for (int pl = 0; pl < 2; ++pl)
            sm90::tma_load_4d(smem + C::kQ + (2 * c + pl) * C::kQPlane, &p.q,
                              q_full, 32 * c, q0, bh, pl);
      }
      for (int j = 0; j < n * per; ++j) {
        const int s = j % S, k0 = j / per * BN, c = j % per;
        sm90::mbar_wait(&empty[s], ((j / S) & 1) ^ 1);
        uint8_t* st = smem + C::kRing + s * C::kSlot;
        if (c < nc) {
          sm90::mbar_arrive_expect_tx(&full[s], C::kSItem);
          if constexpr (!C::kResident) {
            for (int pl = 0; pl < 2; ++pl)
              sm90::tma_load_4d(st + pl * C::kQPlane, &p.q, &full[s], 32 * c,
                                q0, bh, pl);
            st += 2 * C::kQPlane;
          }
          for (int pl = 0; pl < 2; ++pl)
            sm90::tma_load_4d(st + pl * C::kKPlane, &p.k, &full[s], 32 * c,
                              k0, bh, pl);
        } else {
          sm90::mbar_arrive_expect_tx(&full[s], C::kVItem);
          for (int pl = 0; pl < 2; ++pl)
            for (int x = 0; x < C::kVBoxes; ++x)
              sm90::tma_load_4d(st + (C::kVBoxes * pl + x) * sm90::kTfBox,
                                &p.v, &full[s], k0 + 32 * x,
                                f0 + 32 * (c - nc), bh, pl);
        }
      }
    }
  } else {
    // Consumer warpgroup w: query rows [64 w, 64 w + 64) of the block.
    sm90::reg_alloc<W::kConsumerRegs>();
    int q0, f0, nc, no, n;
    place(q0, f0, nc, no, n);
    const int w = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    const int t = lane % 4;
    const int r0 = 64 * w + 16 * warp + lane / 4;  // rows r0 and r0 + 8
    const float sl2 = p.scale * kLog2e;
    const long long q_lo = p.q_offset + q0 + 64 * w;
    // Tiles [0, nw) are live for these 64 rows.
    const int nw = fwd_key_tiles<BN>(p, q_lo, 64) < n
                       ? fwd_key_tiles<BN>(p, q_lo, 64)
                       : n;

    float o[DO / 2];
#pragma unroll
    for (int i = 0; i < DO / 2; ++i) o[i] = 0.f;
    float m_r[2] = {-INFINITY, -INFINITY};  // running max of S sl2
    float l_r[2] = {0.f, 0.f};  // this thread's share of the row sums
    float sc[BN / 2];  // S of one tile, then its P in f32
    float cs[BN / 2];  // a chunk of S
    float pv[16];      // a chunk of P V
    float corr[2];
    int j = 0;  // the next item
    auto wait_item = [&]() {
      sm90::mbar_wait(&full[j % S], (j / S) & 1);
      return smem + C::kRing + (j % S) * C::kSlot;
    };
    auto release = [&]() {
      sm90::mbar_arrive(&empty[j % S]);
      ++j;
    };

    if constexpr (C::kResident) sm90::mbar_wait(q_full, 0);
    for (int i = 0; i < nw; ++i) {
      for (int c = 0; c < nc; ++c) {
        const uint8_t* st = wait_item();
        const uint8_t* qh = C::kResident ? smem + C::kQ + 2 * c * C::kQPlane
                                         : st;
        const uint8_t* kh = C::kResident ? st : st + 2 * C::kQPlane;
        qh += w * 64 * 128;  // this warpgroup's rows
        sm90::wgmma_fence();
        sm90::tf32_ss_chunk<BN>(cs, qh, qh + C::kQPlane, kh,
                                kh + C::kKPlane);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(cs);
        release();
        if (c == 0) {
#pragma unroll
          for (int x = 0; x < BN / 2; ++x) sc[x] = cs[x];
        } else {
          sm90::tf32_add(sc, cs);
        }
      }
      online_softmax<BN>(p, sc, m_r, l_r, corr, sl2, q_lo, q0 + r0, i * BN,
                         t);
      rescale<DO>(o, corr);
      uint32_t fh[BN / 8][4], fl[BN / 8][4];
      sm90::tf32_frags(fh, fl, sc);
#pragma unroll
      for (int ob = 0; ob < DO / 32; ++ob) {
        if (ob < no) {
          const uint8_t* st = wait_item();
          sm90::wgmma_fence();
          sm90::tf32_rs<BN / 8>(pv, fh, fl, st,
                                st + C::kVBoxes * sm90::kTfBox);
          sm90::wgmma_commit();
          sm90::wgmma_wait<0>();
          sm90::fence_regs(pv);
          release();
#pragma unroll
          for (int x = 0; x < 16; ++x) o[16 * ob + x] += pv[x];
        }
      }
    }
    for (int i = nw; i < n; ++i)  // tiles only the other warpgroup sees
      for (int x = 0; x < nc + no; ++x) {
        wait_item();
        release();
      }
    store_rows<DO, F32Out>(p, o, m_r, l_r, bb, hh, q0 + r0, t, f0, f0 == 0);
  }
}

// The f32 kernel's parameters: tensor maps of the split pass's planes in
// `scratch` (Q in boxes of 32 features x 128 rows, K of 32 x bn, V^T of
// 32 keys x 32 feature rows), the two planes of each its outermost dim.
int tf32_fwd_params(FwdParams& p, const Args& a, int b, float* scratch,
                    int bn) {
  const int bh = b * a.h, sk8 = a.sk < 8 ? 8 : (a.sk + 7) / 8 * 8;
  float* qp = scratch;
  float* kp = qp + 2 * plane_floats(bh, a.d, a.sq);
  float* vp = kp + 2 * plane_floats(bh, a.d, a.sk);
  int err = sm90::encode_f32_tile(&p.q, qp, a.d, a.sq, bh, 2, a.d,
                                  static_cast<long long>(a.sq) * a.d,
                                  plane_floats(bh, a.d, a.sq), 128);
  if (!err)
    err = sm90::encode_f32_tile(&p.k, kp, a.d, a.sk, bh, 2, a.d,
                                static_cast<long long>(a.sk) * a.d,
                                plane_floats(bh, a.d, a.sk), bn);
  if (!err)
    err = sm90::encode_f32_tile(&p.v, vp, sk8, a.d, bh, 2, sk8,
                                static_cast<long long>(a.d) * sk8,
                                plane_floats(bh, a.d, sk8), 32);
  if (err) return err;
  p.o = a.o;
  p.lse = a.lse;
  p.sob = a.sob;
  p.soh = a.soh;
  p.sos = a.sos;
  p.h = a.h;
  p.sq = a.sq;
  p.sk = a.sk;
  p.d = a.d;
  p.causal = a.causal;
  p.q_offset = a.q_offset;
  p.kv_offset = a.kv_offset;
  p.scale = a.scale == 0.f ? 1e-30f : a.scale;  // as fwd_params
  return 0;
}

template <int DO>
int launch_tf32(const Args& a, int b, float* scratch, cudaStream_t stream) {
  using C = F32Cfg<DO>;
  const int nco = (a.d + DO - 1) / DO;
  const long long nt = (a.sq + 127) / 128 * static_cast<long long>(nco);
  const unsigned blocks = sm90::folded_blocks(nt, b, a.h);
  if (blocks == 0) return sm90::kErrGrid;
  FwdParams p;
  const int err = tf32_fwd_params(p, a, b, scratch, C::kBN);
  if (err) return err;
  p.fold = sm90::fold(nt, b, a.h);
  constexpr int bytes = C::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_tf32_kernel<DO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(blocks);
  flash_fwd_tf32_kernel<DO>
      <<<grid, FwdCfg<256>::kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int launch_split(const Args& a, int b, float* scratch, cudaStream_t stream) {
  SplitParams p;
  const int bh = b * a.h, sk8 = a.sk < 8 ? 8 : (a.sk + 7) / 8 * 8;
  const void* x[3] = {a.q, a.k, a.v};
  const long long sb[3] = {a.sqb, a.skb, a.svb}, sh[3] = {a.sqh, a.skh, a.svh},
                  ss[3] = {a.sqs, a.sks, a.svs};
  const int rows[3] = {a.sq, a.sk, a.sk};
  float* at = scratch;
  for (int z = 0; z < 3; ++z) {
    p.x[z] = static_cast<const float*>(x[z]);
    p.sb[z] = sb[z];
    p.sh[z] = sh[z];
    p.ss[z] = ss[z];
    p.planes[z] = at;
    p.rows[z] = rows[z];
    at += 2 * plane_floats(bh, a.d, z == 2 ? sk8 : rows[z]);
  }
  p.h = a.h;
  p.bh = bh;
  p.d = a.d;
  p.sk8 = sk8;
  const int extent = a.sq > sk8 ? a.sq : sk8;
  dim3 grid((extent + 31) / 32 * ((a.d + 31) / 32), bh < 65535 ? bh : 65535,
            3);
  tf32_split_kernel<<<grid, kSplitThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation of head dim a.d in a 16-bit type E: tile widths 64,
// 128 and 256, and chunks of 256 past it (all TMA + wgmma).
template <class E>
int launch16(const Args& a, int b, cudaStream_t stream) {
  if (a.d <= 64) return launch_wgmma<64, E>(a, b, stream);
  if (a.d <= 128) return launch_wgmma<128, E>(a, b, stream);
  if (a.d <= 256) return launch_wgmma<256, E>(a, b, stream);
  return launch_chunked<E>(a, b, stream);
}

// f32: O's columns in blocks of 64, 128, or 256 past 128.
int launch(const Args& a, int b, int dtype, float* scratch,
           cudaStream_t stream) {
  if (dtype == 1) return launch16<sm90::Bf16>(a, b, stream);
  if (dtype == 2) return launch16<sm90::F16>(a, b, stream);
  if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (a.d <= 64) return launch_tf32<64>(a, b, scratch, stream);
  if (a.d <= 128) return launch_tf32<128>(a, b, scratch, stream);
  return launch_tf32<256>(a, b, scratch, stream);
}

int make_args(Args& a, const void* q, const void* k, const void* v, void* o,
              void* lse, const long long* st, int b, int h, int sq, int sk,
              int d, int dtype, int causal, long long q_offset,
              long long kv_offset, float scale) {
  if (dtype < 0 || dtype > 2 || d < 8 || d % 8 != 0 || b <= 0 || h <= 0 ||
      sq <= 0 || sk < 0 || st == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(b) * h > 0x7fffffffLL) return sm90::kErrGrid;
  a = Args{q,      k,      v,      o,      static_cast<float*>(lse),
           st[0],  st[1],  st[2],  st[3],  st[4],  st[5],
           st[6],  st[7],  st[8],  st[9],  st[10], st[11],
           h,      sq,     sk,     d,      causal, q_offset, kv_offset,
           scale};
  return 0;
}

}  // namespace

extern "C" {

// Both entries take the same arguments. Pointers: q, k, v, out (the input
// dtype), lse (f32, (B*H, Sq) contiguous) and scratch; strides: 12 element
// strides, (batch, head, sequence) of q, k, v and out. dtype: 0 = float32,
// 1 = bfloat16, 2 = float16; d a multiple of 8 from 8 up. In 16 bits the
// base pointers are 16-byte aligned and the strides multiples of 8
// elements (TMA's rule), and scratch is unused. In f32, scratch holds
// flash_fwd_scratch_floats(...) floats: flash_fwd_split writes Q's, K's
// and V's planes there, and flash_fwd, launched after it on the same
// stream, reads them. Returns the CUDA error of the launch (0 = success),
// sm90::kErrGrid where B * H or the launch grid passes 2^31 - 1, or a
// tensor-map error (flash_fwd_error_string).
int flash_fwd(const void* q, const void* k, const void* v, void* o,
              void* lse, void* scratch, const long long* strides, int b,
              int h, int sq, int sk, int d, int dtype, int causal,
              long long q_offset, long long kv_offset, float scale,
              void* stream) {
  Args a;
  const int bad = make_args(a, q, k, v, o, lse, strides, b, h, sq, sk, d,
                            dtype, causal, q_offset, kv_offset, scale);
  if (bad) return bad;
  return launch(a, b, dtype, static_cast<float*>(scratch),
                static_cast<cudaStream_t>(stream));
}

int flash_fwd_split(const void* q, const void* k, const void* v, void* o,
                    void* lse, void* scratch, const long long* strides,
                    int b, int h, int sq, int sk, int d, int dtype,
                    int causal, long long q_offset, long long kv_offset,
                    float scale, void* stream) {
  Args a;
  const int bad = make_args(a, q, k, v, o, lse, strides, b, h, sq, sk, d,
                            dtype, causal, q_offset, kv_offset, scale);
  if (bad) return bad;
  if (dtype != 0 || scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_split(a, b, static_cast<float*>(scratch),
                      static_cast<cudaStream_t>(stream));
}

// The floats of the f32 forward's scratch: hi and lo planes of Q (B*H x Sq
// x d), K (B*H x Sk x d) and V^T (B*H x d x Sk8).
long long flash_fwd_scratch_floats(int b, int h, int sq, int sk, int d) {
  const int sk8 = sk < 8 ? 8 : (sk + 7) / 8 * 8;
  const long long bh = static_cast<long long>(b) * h;
  return 2 * (plane_floats(bh, d, sq) + plane_floats(bh, d, sk) +
              plane_floats(bh, d, sk8));
}

const char* flash_fwd_error_string(int code) {
  return sm90::error_string(code);
}

}  // extern "C"
