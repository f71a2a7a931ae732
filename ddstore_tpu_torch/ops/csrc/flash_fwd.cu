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
// multiple of 8 works without the TPU's block-divisibility rule.
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
// stores skip every column past d). The f32 kernel takes the widths 64,
// 128, 256 and chunks of 256, with loads and stores masked at d. Shared
// memory and registers are sized by the tile or chunk, never by d.
//
// Bound on the H100 SXM: the work is 4*B*H*Sq*Sk*D FLOPs (QK^T and PV,
// about half of that for causal) against 989 TFLOP/s in bf16, and the
// bytes are q, k, v read once and out, lse written once against 3.35 TB/s.
// At the LM's shape, (B, H, S, D) = (8, 16, 2048, 64) causal, that is
// 6.9e10 FLOP = 0.0695 ms against 1.35e8 B = 0.040 ms: operations bound it
// (and at (8, 4, 2048, 256) and (8, 2, 2048, 512) the same 0.0695 ms).
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
//   tiles launch heaviest first (the grid's slowest axis runs backwards),
//   and each warpgroup skips the products of key tiles its 64 rows cannot
//   see. Tiles are 128-byte swizzled boxes of 64 columns; D = 128 is two
//   boxes, D = 256 four (sm90.cuh). D = 256 takes FlashAttention-3's
//   shape (128 query rows, two consumer warpgroups) with 64-key tiles: P
//   of 64 keys is 16 registers beside O's 128 and S's 32.
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
//   head, batch), the grid's chunk axis folded into the query-tile axis
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
// * f32: the same algorithm on the CUDA cores (16 query rows x 32-key
//   tiles per block, one dot product per score), exact in f32; wgmma has
//   no f32 input type, and the LM runs in bf16. Past d = 256 the same
//   chunk loop as above, in chunks of 256.

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

  const int hh = blockIdx.x, bb = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * C::kBM;  // heaviest first
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
  FwdParams p;
  const int err = fwd_params<E>(p, a, b, C::kBM, C::kBN);
  if (err) return err;
  constexpr int bytes = C::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<D, E>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(a.h, b, (a.sq + C::kBM - 1) / C::kBM);
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

  const int hh = blockIdx.x, bb = blockIdx.y;
  const int tid = threadIdx.x;
  // The block's query tile and chunk of O; the grid's slowest axis runs
  // backwards (heaviest tiles first), a tile's chunks side by side. Each
  // role works these out after its setmaxnreg, so that nothing stays live
  // across it.
  auto place = [&](int& nc, int& q0, int& oc) {
    nc = (p.d + 255) / 256;
    const int z = gridDim.z - 1 - blockIdx.z;
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
  FwdParams p;
  const int err = fwd_params<E>(p, a, b, C::kBM, C::kBN);
  if (err) return err;
  constexpr int bytes = C::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_chunked_kernel<E>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nc = (a.d + 255) / 256;
  dim3 grid(a.h, b, (a.sq + C::kBM - 1) / C::kBM * nc);
  flash_fwd_chunked_kernel<E>
      <<<grid, FwdCfg<256>::kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// f32: CUDA cores

constexpr int kSBQ = 16;  // query rows per block
constexpr int kSBK = 32;  // keys per tile
constexpr int kF32Threads = 128;
// 128 threads: thread = (row r = tid / 8, lane-in-row c8 = tid % 8); a row's
// 8 threads are adjacent lanes of one warp.

// Dynamic shared memory, in floats: Q [kSBQ][D + 1], K [kSBK][D + 1], V
// [kSBK][D], P [kSBQ][kSBK + 1] (84 KB at D = 256). D is the tile's width:
// the head dim's (d <= 256), or one chunk of it (d > 256).
template <int D>
struct F32Smem {
  static constexpr int kK = kSBQ * (D + 1);
  static constexpr int kV = kK + kSBK * (D + 1);
  static constexpr int kP = kV + kSBK * D;
  static constexpr int kBytes = (kP + kSBQ * (kSBK + 1)) * 4;
};

// kChunked = false: d <= D, one tile. kChunked = true: d > D, in nc =
// ceil(d / D) chunks of D = 256; the block's blockIdx.x % nc is the chunk
// oc of O it owns, S = Q K^T sums over the chunks staged in turn, and P V
// takes V's chunk oc. Every chunk's block forms the same S in the same
// order; chunk 0 stores lse.
template <int D, bool kChunked>
__global__ void __launch_bounds__(kF32Threads)
    flash_fwd_f32_kernel(Args a) {
  using L = F32Smem<D>;
  extern __shared__ __align__(16) uint8_t smem_f32[];
  float* base = reinterpret_cast<float*>(smem_f32);
  auto q_s = reinterpret_cast<float(*)[D + 1]>(base);
  auto k_s = reinterpret_cast<float(*)[D + 1]>(base + L::kK);
  auto v_s = reinterpret_cast<float(*)[D]>(base + L::kV);
  auto p_s = reinterpret_cast<float(*)[kSBK + 1]>(base + L::kP);

  int nc = 1, oc = 0, qt = blockIdx.x;
  if constexpr (kChunked) {
    nc = (a.d + D - 1) / D;
    qt = blockIdx.x / nc;
    oc = blockIdx.x % nc;
  }
  const int q0 = qt * kSBQ;
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x, r = tid / 8, c8 = tid % 8;
  const float* qp = static_cast<const float*>(a.q) + bb * a.sqb + hh * a.sqh;
  const float* kp = static_cast<const float*>(a.k) + bb * a.skb + hh * a.skh;
  const float* vp = static_cast<const float*>(a.v) + bb * a.svb + hh * a.svh;
  float* op = static_cast<float*>(a.o) + bb * a.sob + hh * a.soh;

  // Columns past d are zero: they add nothing to the scores, and give
  // zero columns of out, which are not stored.
  if constexpr (!kChunked) {
    for (int e = tid; e < kSBQ * D; e += kF32Threads) {
      const int rr = e / D, d = e % D;
      q_s[rr][d] =
          q0 + rr < a.sq && d < a.d ? qp[(q0 + rr) * a.sqs + d] : 0.f;
    }
  }

  float m = -INFINITY, l = 0.f;  // l: this thread's share of the row's sum
  float acc[D / 8];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j] = 0.f;

  const long long q_lo = a.q_offset + q0;
  const int nk = (a.sk + kSBK - 1) / kSBK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kSBK;
    bool diag = false;
    if (a.causal) {
      bool live;
      causal_liveness<kSBQ, kSBK>(q_lo, a.kv_offset + k0, live, diag);
      if (!live) break;
    }
    const bool masked = diag || (k0 + kSBK > a.sk);
    float s[kSBK / 8];
    if constexpr (kChunked) {
#pragma unroll
      for (int i = 0; i < kSBK / 8; ++i) s[i] = 0.f;
      for (int c = 0; c < nc; ++c) {
        // the previous chunk's (or tile's) q_s/k_s/v_s reads are done
        __syncthreads();
        sm90::stage_rows_f32<kSBQ, D, D + 1, kF32Threads>(
            &q_s[0][0], qp, a.sqs, q0, a.sq, c * D, a.d, tid);
        sm90::stage_rows_f32<kSBK, D, D + 1, kF32Threads>(
            &k_s[0][0], kp, a.sks, k0, a.sk, c * D, a.d, tid);
        if (c == 0)
          sm90::stage_rows_f32<kSBK, D, D, kF32Threads>(
              &v_s[0][0], vp, a.svs, k0, a.sk, oc * D, a.d, tid);
        __syncthreads();
#pragma unroll
        for (int i = 0; i < kSBK / 8; ++i) {
          const int col = c8 + 8 * i;
          float dot = s[i];
#pragma unroll 16
          for (int d = 0; d < D; ++d) dot = fmaf(q_s[r][d], k_s[col][d], dot);
          s[i] = dot;
        }
      }
    } else {
      __syncthreads();  // the previous tile's k_s/v_s reads are done
      for (int e = tid; e < kSBK * D; e += kF32Threads) {
        const int rr = e / D, d = e % D;
        const bool in = k0 + rr < a.sk && d < a.d;
        k_s[rr][d] = in ? kp[(k0 + rr) * a.sks + d] : 0.f;
        v_s[rr][d] = in ? vp[(k0 + rr) * a.svs + d] : 0.f;
      }
      __syncthreads();
    }

    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < kSBK / 8; ++i) {
      const int col = c8 + 8 * i;
      float dot = 0.f;
      if constexpr (kChunked) {
        dot = s[i];
      } else {
#pragma unroll 16
        for (int d = 0; d < D; ++d) dot = fmaf(q_s[r][d], k_s[col][d], dot);
      }
      dot *= a.scale;
      if (masked && (k0 + col >= a.sk ||
                     (a.causal && a.kv_offset + k0 + col >
                                      a.q_offset + q0 + r)))
        dot = -INFINITY;
      s[i] = dot;
      mx = fmaxf(mx, dot);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
    const float m_new = fmaxf(m, mx);
    const float safe = m_new == -INFINITY ? 0.f : m_new;
    const float corr = m == -INFINITY ? 0.f : expf(m - safe);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kSBK / 8; ++i) {
      const float p = expf(s[i] - safe);
      p_s[r][c8 + 8 * i] = p;
      sum += p;
    }
    l = l * corr + sum;
    m = m_new;
    __syncwarp();  // a row's p_s is written and read by its own 8 lanes
#pragma unroll
    for (int j = 0; j < D / 8; ++j) acc[j] *= corr;
    for (int c = 0; c < kSBK; ++c) {
      const float p = p_s[r][c];
#pragma unroll
      for (int j = 0; j < D / 8; ++j) acc[j] = fmaf(p, v_s[c][c8 + 8 * j], acc[j]);
    }
    __syncwarp();  // p_s is rewritten by the next tile
  }

  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  l += __shfl_xor_sync(0xffffffffu, l, 4);
  const float lc = fmaxf(l, 1e-30f);
  const int row = q0 + r;
  const int f0 = oc * D;  // this block's columns of O
  if (row < a.sq) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      if (f0 + 8 * j < a.d) op[row * a.sos + f0 + c8 + 8 * j] = acc[j] / lc;
    if (c8 == 0 && oc == 0)
      a.lse[(static_cast<long long>(bb) * a.h + hh) * a.sq + row] =
          m == -INFINITY ? -INFINITY : m + logf(lc);
  }
}

template <int D, bool kChunked>
int launch_f32(const Args& a, int b, cudaStream_t stream) {
  constexpr int bytes = F32Smem<D>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<D, kChunked>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nc = kChunked ? (a.d + D - 1) / D : 1;
  dim3 grid((a.sq + kSBQ - 1) / kSBQ * nc, a.h, b);
  flash_fwd_f32_kernel<D, kChunked><<<grid, kF32Threads, bytes, stream>>>(a);
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

int launch(const Args& a, int b, int dtype, cudaStream_t stream) {
  if (dtype == 1) return launch16<sm90::Bf16>(a, b, stream);
  if (dtype == 2) return launch16<sm90::F16>(a, b, stream);
  if (a.d <= 64) return launch_f32<64, false>(a, b, stream);
  if (a.d <= 128) return launch_f32<128, false>(a, b, stream);
  if (a.d <= 256) return launch_f32<256, false>(a, b, stream);
  return launch_f32<256, true>(a, b, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16; d a multiple of 8 from 8
// up. Strides are in elements; in 16 bits the base pointers are 16-byte
// aligned and the strides multiples of 8 elements (TMA's rule). Returns the
// CUDA error of the launch (0 = success), or a tensor-map error
// (flash_fwd_error_string).
int flash_fwd(const void* q, const void* k, const void* v, void* o,
              void* lse, long long sqb, long long sqh, long long sqs,
              long long skb, long long skh, long long sks, long long svb,
              long long svh, long long svs, long long sob, long long soh,
              long long sos, int b, int h, int sq, int sk, int d, int dtype,
              int causal, long long q_offset, long long kv_offset,
              float scale, void* stream) {
  if (dtype < 0 || dtype > 2 || d < 8 || d % 8 != 0 || b <= 0 || h <= 0 ||
      sq <= 0 || sk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q,   k,   v,   o,   static_cast<float*>(lse),
         sqb, sqh, sqs, skb, skh,
         sks, svb, svh, svs, sob,
         soh, sos, h,   sq,  sk,
         d,   causal, q_offset, kv_offset, scale};
  return launch(a, b, dtype, static_cast<cudaStream_t>(stream));
}

const char* flash_fwd_error_string(int code) {
  return sm90::error_string(code);
}

}  // extern "C"
