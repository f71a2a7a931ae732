// Flash-attention backward for Hopper (sm_90a): the dq kernel and the dk/dv
// kernel, with a plain C interface loaded through ctypes
// (ddstore_tpu_torch/ops/_build.py).
//
// Replaces the TPU kernels of ddstore_tpu/ops/attention.py:
// * _bwd_dq_kernel (:213-260, pallas_call :363): for each query row,
//   dq = sum_k (p * (dp - c)) k * scale;
// * _bwd_dkv_kernel (:263-313, pallas_call :381): for each key row,
//   dv = sum_q p^T do and dk = sum_q (p * (dp - c))^T q * scale;
// with p = exp(s - lse) recomputed from the forward's f32 lse (a
// fully-masked row, lse = -inf, takes lse = 1e30 so that its p is exactly
// 0), dp = do v^T, and c = rowsum(do * out) - dlse formed by the caller.
// Causal tiles use the forward's liveness rule (_causal_liveness :40-50):
// dead tiles are skipped, only tiles on the diagonal (or ragged) are
// masked, and global q_offset/kv_offset shift the frontier. lse and c are
// thin f32 (B*H, Sq) tensors; the TPU's 128-lane dta packing is not
// carried over.
//
// What changes against the TPU: each TPU kernel's sequential grid axis
// becomes a loop inside the CUDA block, since nothing carries over between
// blocks. The dq kernel takes one block per (query tile, head, batch) and
// loops over the key tiles up to the last live one; the dk/dv kernel takes
// one block per (128-key tile, head, batch) and loops over the query tiles
// from the first one that can see it. The two kernels write disjoint
// outputs, so there are no atomics and the gradients are deterministic
// (bit-identical from launch to launch). Every output row is written, as
// zero where no live pair reaches it (keys no query sees, fully-masked
// query rows), and ragged last tiles of any length that is a multiple of 8
// are masked in the kernel.
//
// Head dims and dtypes: d is any multiple of 8 from 8 up (the wrapper
// zero-pads other head dims and slices the gradients back), in bf16, fp16
// or f32. The 16-bit kernels are templated on the element type (sm90::Bf16,
// sm90::F16: the same tiles, barriers and register budgets; P and dS are
// rounded to the input dtype before their products, as the reference
// rounds them), in four instantiations each: tile widths 64, 128 and 256
// of the TMA + wgmma kernels, whose tensor maps declare the true d so that
// TMA zero-fills the tiles' columns past it (zero columns of Q, K, V and
// dO leave S and dP as they are, and give zero columns of dQ, dK and dV,
// which the stores skip), and past d = 256 simpler kernels on mma.sync
// (below) in chunks of 256. The f32 kernels take the widths 64, 128, 256
// and chunks of 256, with loads and stores masked at d. Shared memory and
// registers are sized by the tile or chunk, never by d.
//
// Bound on the H100 SXM at the LM's shape, (B, H, S, D) = (8, 16, 2048,
// 64) bf16 causal, 2.686e8 live score pairs: dq does 3 products of 2*D
// FLOP a pair (s, dp, dq), 1.03e11 FLOP = 0.104 ms at 989 TFLOP/s, against
// about 170 MB of bytes (q, k, v, do, lse, c read, dq written) = 0.051 ms
// at 3.35 TB/s; dk/dv does 4 (s, dp, dv, dk), 1.375e11 FLOP = 0.139 ms,
// against about 203 MB = 0.061 ms. Both are bound by operations, and by
// the same counts at (8, 4, 2048, 256).
//
// Design, and what it leaves on the table. The 16-bit kernels up to d = 256
// (bf16 below; fp16 the same) are a TMA tile ring + wgmma (sm90.cuh) in
// blocks of three warpgroups: warpgroup 2 gives up its registers
// (setmaxnreg, 24 left against 240 for each consumer) and one of its
// threads issues every TMA load; at d <= 128 warpgroups 0 and 1 each own
// 64 rows of the block's resident operand, at 129-256 half its features.
// * bf16 dq: one block per 128 queries. The producer loads Q and dO once,
//   then streams the K and V tiles through a ring of three shared stages
//   completed on mbarriers ("full" when TMA has landed, "empty" when both
//   consumers are done). Each consumer reads its rows' lse and c once into
//   registers. S = Q K^T and dP = dO V^T are wgmma SS (both K-major, as the
//   forward forms S); P = exp2(S scale log2e - lse log2e) and dS = P (dP -
//   c) are formed on the accumulators; dQ += dS K is wgmma RS with dS
//   packed to bf16 in registers and K read MN-major from the same ring
//   stage the S product read K-major (the forward's P V with K in V's
//   place: no transposed copy of K). The same software pipeline as dk/dv:
//   S and dP of tile i are issued with dQ of tile i - 1, and dS of tile i
//   is formed while the latter runs. Key tiles are 64 keys at either head
//   dim: 128 at D = 64 fits in registers but ran slower on the H100 at
//   the LM's shape, and at D = 128 would not fit in shared memory beside
//   the resident Q and dO. High query tiles, which see the most keys
//   under the causal mask, launch first.
//   Left out: ping-pong between the consumer warpgroups, persistent
//   blocks, a TMA store of dq, and a dq fused into the dk/dv kernel (its
//   atomic adds would make the gradients differ from run to run).
// * bf16 dk/dv: one block per 128 keys. The producer loads K and V once,
//   then streams the query tiles (Q, dO and their lse and c slices)
//   through the same kind of ring. The consumers own 64 key rows each and
//   work with keys as rows: S^T = K Q^T and dP^T = V dO^T are wgmma SS
//   (K-major); P^T = exp2(S^T scale log2e - lse log2e) and dS^T = P^T (dP^T
//   - c) are formed on the accumulators; dV += P^T dO and dK += dS^T Q are
//   wgmma RS with P^T and dS^T packed to bf16 in registers and dO and Q
//   read MN-major from the same tiles the first two products read K-major.
//   A software pipeline keeps the tensor cores busy inside a warpgroup:
//   the S^T and dP^T products of tile i are issued with dV and dK of tile
//   i - 1, and P^T, dS^T of tile i are formed while the latter run. Query
//   tiles are 64 rows at D = 64 and 32 at D = 128 (two D-wide accumulators
//   must fit in registers with no spills). Low key tiles, which see the
//   most queries under the causal mask, launch first.
//   Left out: warp-specialised ping-pong between the consumer warpgroups,
//   K and V held in registers as A fragments (the SS products re-read
//   them from shared memory for every query tile), persistent blocks, a
//   fused dq, and tiles narrower than 64 features.
// * bf16 and fp16 dk/dv, 128 < d <= 256: the same producer and ring, with
//   the features split over the warpgroups (flash_bwd_dkv_split_kernel):
//   one block per 64 keys, each warpgroup owning 128 features of dK and dV
//   (64 + 64 registers a thread). S^T and dP^T of a 64-query tile are
//   formed once, each warpgroup forming 32 queries' worth (wgmma m64n32);
//   P^T and dS^T go through shared memory as E (rounded where the
//   reference rounds them) and feed both warpgroups' dV and dK products as
//   SS wgmma. Two ring stages of 64 KB (Q, dO) are what fits beside the
//   resident K and V; so that the load of tile i + 2 overlaps the work of
//   tile i + 1, dV and dK of tile i are issued before S^T and dP^T of tile
//   i + 1 and hand the stage back as soon as they are done. Left out:
//   overlap of the P^T, dS^T forming with the products (the two
//   warpgroups meet at a named barrier every tile), persistent blocks.
// * bf16 and fp16 dq, 128 < d <= 256 (flash_bwd_dq_split_kernel): the
//   split dk/dv kernel with the roles of queries and keys swapped. One
//   block per 64 queries, each warpgroup owning 128 features of dQ (64
//   registers a thread); Q and dO stay resident, 64-key K and V tiles
//   stream through two 64 KB stages. S and dP of a tile are formed once,
//   each warpgroup forming 32 keys' worth (wgmma m64n32); dS goes through
//   two shared buffers as E (rounded where the reference rounds it) and
//   feeds both warpgroups' dQ products as SS wgmma, K read MN-major from
//   the stage the S product read K-major. dQ of tile i is issued before S
//   and dP of tile i + 1 and hands the stage back as soon as it is done.
//   Left out: as in the split dk/dv kernel, overlap of the dS forming with
//   the products (one named barrier a tile), persistent blocks.
// * bf16 and fp16 dq and dk/dv at d > 256: right rather than fast, on
//   mma.sync m16n8k16 with plain 16-byte loads into padded shared rows
//   (columns past d zero) and ldmatrix.trans for the operands whose
//   contracted dim runs down their rows, the features in nc = ceil(d /
//   256) chunks. dq: one block of 4 warps per 64 queries (16 a warp) and
//   chunk of dQ, 32-key K and V tiles; dQ's 128 accumulators a thread for
//   16 rows x 256 features fit beside S and dP of a 32-key tile. dk/dv:
//   each block owns 64 keys and one of ceil(d / 128) parts (128 features)
//   of dK and dV (a grid axis folded into the tile axis). For each
//   streamed tile a block stages the chunks of both operands in turn into
//   the same shared rows and sums S and dP (S^T and dP^T) over them, then
//   takes the chunk its output needs (staged again unless it was the
//   last). Every block forms the same S in the same order, so P is the
//   same in each; the outputs stay disjoint, so the gradients stay
//   bit-deterministic.
// * f32: the same algorithm on the CUDA cores, one dot product per score
//   (the tensor cores take no f32 inputs); exact in f32, for checking the
//   math without bf16 rounding. The LM runs in bf16. Past d = 256 the
//   same chunk loop, in chunks of 256 for dQ, dK and dV alike.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kSafeLse = 1e30f;  // lse of a fully-masked row

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;  // (B*H, Sq), contiguous
  const float* c;    // (B*H, Sq), contiguous
  void* o1;          // dq (dq kernel) or dk (dk/dv kernel)
  void* o2;          // dv (dk/dv kernel)
  // element strides of (batch, head, sequence); the feature stride is 1
  long long sqb, sqh, sqs;
  long long skb, skh, sks;
  long long svb, svh, svs;
  long long sdb, sdh, sds;
  long long s1b, s1h, s1s;
  long long s2b, s2h, s2s;
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

// True where the (query row, key col) pair is masked: a key past Sk, a
// query past Sq, or (causal) a key in the query's future.
__device__ __forceinline__ bool pair_masked(const Args& a, int row, int col) {
  return col >= a.sk || row >= a.sq ||
         (a.causal && a.kv_offset + col > a.q_offset + row);
}

// lse of a row, with fully-masked rows (lse = -inf) and rows past Sq
// taken as 1e30, so that their p = exp(s - lse) is exactly 0. P is Args
// or DqParams (both carry lse, c and sq).
template <class P>
__device__ __forceinline__ float safe_lse(const P& a, long long bh, int row) {
  if (row >= a.sq) return kSafeLse;
  const float l = a.lse[bh * a.sq + row];
  return l == -INFINITY ? kSafeLse : l;
}

template <class P>
__device__ __forceinline__ float row_c(const P& a, long long bh, int row) {
  return row < a.sq ? a.c[bh * a.sq + row] : 0.f;
}

// ---------------------------------------------------------------------------
// bf16: TMA tile ring + wgmma, in blocks of three warpgroups (dq and dk/dv)

constexpr int kStages = 3;  // ring stages of the streamed tiles
constexpr int kBlockThreads = 384;
constexpr int kConsumers = 256;  // warpgroups 0 and 1; warpgroup 2 produces
// setmaxnreg moves registers from the producer to the consumers within
// what the launch gave the block (168 a thread for 384 threads): 24 + 2 x
// 240 = 3 x 168. Asking for more than that pool would wait forever; with
// 232 the D = 128 dk/dv consumers spill.
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

// dq: one block per (128 queries, head, batch); warpgroups 0 and 1 own 64
// query rows each. Q and dO stay resident in shared memory; K and V tiles
// of 64 keys stream through the ring: three stages, since while tile i is
// formed tile i - 1's K is still read by dQ, and tile i + 1 loads.
constexpr int kDqBM = 128;
constexpr int kDqBN = 64;

struct DqParams {
  CUtensorMap q, dout;  // boxes of 64 features x the block's query rows
  CUtensorMap k, v;     // boxes of 64 features x 64 rows
  const float* lse;     // (B*H, Sq), contiguous
  const float* c;       // (B*H, Sq), contiguous
  void* dq;             // E::T
  long long s1b, s1h, s1s;
  int h, sq, sk;
  int d;  // true head dim: the stores skip the tile's columns past it
  int causal;
  long long q_offset, kv_offset;
  float scale;
};

// Shared memory, from a 1024-byte aligned base: Q, dO, then per stage a K
// and a V tile, then the barriers. A Q or dO tile is D / 64 boxes of 128
// rows x 128 bytes; a K or V tile D / 64 boxes of 64 rows x 128 bytes.
template <int D>
struct DqSmem {
  static constexpr int kQBox = kDqBM * 128;
  static constexpr int kQT = (D / 64) * kQBox;
  static constexpr int kKBox = kDqBN * 128;
  static constexpr int kKT = (D / 64) * kKBox;
  static constexpr int kQ = 0;
  static constexpr int kDo = kQT;
  static constexpr int kRing = 2 * kQT;  // stage s: K at kRing + 2 s kKT
  static constexpr int kBar = kRing + kStages * 2 * kKT;
  static constexpr int kBytes = kBar + (1 + 2 * kStages) * 8 + 1024;
};

// Key tiles [0, n) of 64 keys that `rows` query rows from global position
// q_lo run over: all of them, or (causal) up to the last live one; none
// when rows <= 0 (rows past Sq only).
__device__ __forceinline__ int dq_key_tiles(const DqParams& p,
                                            long long q_lo, int rows) {
  if (rows <= 0) return 0;
  const int nk = (p.sk + kDqBN - 1) / kDqBN;
  if (!p.causal) return nk;
  const long long x = q_lo + rows - 1 - p.kv_offset;
  if (x < 0) return 0;
  return static_cast<int>(x / kDqBN + 1 < nk ? x / kDqBN + 1 : nk);
}

template <int D, class E>
__global__ void __launch_bounds__(kBlockThreads, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ DqParams p) {
  using L = DqSmem<D>;
  constexpr int BN = kDqBN;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sm90::align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int hh = blockIdx.x, bb = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kDqBM;  // heaviest first
  const int n = dq_key_tiles(p, p.q_offset + q0,
                                 p.sq - q0 < kDqBM ? p.sq - q0 : kDqBM);
  const int tid = threadIdx.x;

  if (tid == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kConsumers);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // Producer warpgroup: one thread issues every load.
    sm90::reg_dealloc<kProducerRegs>();
    if (tid == kConsumers) {
      sm90::mbar_arrive_expect_tx(q_full, 2 * L::kQT);
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        sm90::tma_load_4d(smem + L::kQ + c * L::kQBox, &p.q, q_full, c * 64,
                          q0, hh, bb);
        sm90::tma_load_4d(smem + L::kDo + c * L::kQBox, &p.dout, q_full,
                          c * 64, q0, hh, bb);
      }
      for (int i = 0; i < n; ++i) {
        const int s = i % kStages;
        sm90::mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&full[s], 2 * L::kKT);
        uint8_t* ks = smem + L::kRing + s * 2 * L::kKT;
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          sm90::tma_load_4d(ks + c * L::kKBox, &p.k, &full[s], c * 64,
                            i * BN, hh, bb);
          sm90::tma_load_4d(ks + L::kKT + c * L::kKBox, &p.v, &full[s],
                            c * 64, i * BN, hh, bb);
        }
      }
    }
  } else {
    // Consumer warpgroup w: query rows [64 w, 64 w + 64) of the block.
    sm90::reg_alloc<kConsumerRegs>();
    const int w = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int r0 = q0 + 64 * w + 16 * warp + g;  // query rows r0 and r0 + 8
    const uint8_t* qs = smem + L::kQ + w * 64 * 128;
    const uint8_t* dos = smem + L::kDo + w * 64 * 128;
    const long long bh = static_cast<long long>(bb) * p.h + hh;
    const long long q_lo = p.q_offset + q0 + 64 * w;
    // Tiles [0, nw) are live for these 64 rows: a causal tail of the
    // block's tiles may lie wholly in their future, and rows past Sq need
    // none.
    const int left = p.sq - q0 - 64 * w;
    const int nw = dq_key_tiles(p, q_lo, left < 64 ? left : 64);

    float lse2[2], cr[2];  // per row: lse in log2 units, c
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      lse2[hr] = safe_lse(p, bh, r0 + 8 * hr) * kLog2e;
      cr[hr] = row_c(p, bh, r0 + 8 * hr);
    }
    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    const float sl2 = p.scale * kLog2e;

    float s[BN / 2], dp[BN / 2];  // S and dP of one tile; then dS in dp
    uint32_t da[BN / 16][4];      // dS in E: the A fragments of dS K

    auto stage = [&](int i) {
      return smem + L::kRing + (i % kStages) * 2 * L::kKT;
    };
    auto wait_full = [&](int i) {
      sm90::mbar_wait(&full[i % kStages], (i / kStages) & 1);
    };
    // S = Q K^T and dP = dO V^T of tile i, 64 rows x BN keys (issued, not
    // waited).
    auto issue_sdp = [&](int i) {
      const uint8_t* ks = stage(i);
      const uint8_t* vs = ks + L::kKT;
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int ka = (kk / 4) * L::kQBox + (kk % 4) * 32;
        const int kb = (kk / 4) * L::kKBox + (kk % 4) * 32;
        sm90::Wgmma<BN, E>::ss(s, sm90::desc_k(qs + ka),
                               sm90::desc_k(ks + kb), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int ka = (kk / 4) * L::kQBox + (kk % 4) * 32;
        const int kb = (kk / 4) * L::kKBox + (kk % 4) * 32;
        sm90::Wgmma<BN, E>::ss(dp, sm90::desc_k(dos + ka),
                               sm90::desc_k(vs + kb), kk > 0);
      }
      sm90::wgmma_commit();
    };
    // dQ += dS K of tile i: K's keys run down its rows (MN-major), read
    // from the tile the S product read K-major.
    auto issue_dq = [&](int i) {
      const uint8_t* ks = stage(i);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        sm90::Wgmma<D, E>::rs_mn(dq, da[kk],
                                 sm90::desc_mn(ks + kk * 16 * 128, L::kKBox),
                                 1);
      sm90::wgmma_commit();
    };
    // P = exp2(S scale log2e - lse log2e) and dS = P (dP - c) of tile i,
    // into dp (rows r0: e = 0, 1; r0 + 8: e = 2, 3). Only diagonal and
    // ragged tiles are masked: TMA's zero fill past Sk scores 0, not -inf,
    // so keys >= Sk are masked here. Rows past Sq take lse = 1e30 (p = 0)
    // and are never written.
    auto grads = [&](int i) {
      const int k0 = i * BN;
      bool live = true, diag = false;
      if (p.causal)
        causal_liveness<64, BN>(q_lo, p.kv_offset + k0, live, diag);
      const bool masked = diag || k0 + BN > p.sk;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = fmaf(s[4 * j + e], sl2, -lse2[e >> 1]);
          if (masked) {
            const int key = k0 + 8 * j + 2 * t + (e & 1);
            const int row = r0 + 8 * (e >> 1);
            if (key >= p.sk ||
                (p.causal && p.kv_offset + key > p.q_offset + row))
              x = -INFINITY;
          }
          dp[4 * j + e] =
              sm90::exp2_approx(x) * (dp[4 * j + e] - cr[e >> 1]);
        }
    };
    // The accumulators of key columns [16 kk, 16 kk + 16) are the A
    // fragment of k-step kk of dS K.
    auto pack = [&]() {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          da[kk][r] =
              sm90::pack<E>(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
    };
    // dQ of tile i waited for; then its stage may be refilled.
    auto finish_dq = [&](int i) {
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dq);
      sm90::mbar_arrive(&empty[i % kStages]);
    };

    // Software pipeline over the live tiles: while dS of tile i is formed
    // on the CUDA cores, the tensor cores run dQ of tile i - 1 (and the
    // other warpgroup's products).
    sm90::mbar_wait(q_full, 0);
    if (nw > 0) {
      wait_full(0);
      issue_sdp(0);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(s);
      sm90::fence_regs(dp);
      grads(0);
      pack();
      for (int i = 1; i < nw; ++i) {
        wait_full(i);
        issue_sdp(i);
        issue_dq(i - 1);
        // S, dP of tile i done; dQ of tile i - 1 still in flight
        sm90::wgmma_wait<1>();
        sm90::fence_regs(s);
        sm90::fence_regs(dp);
        grads(i);
        finish_dq(i - 1);
        pack();
      }
      issue_dq(nw - 1);
      finish_dq(nw - 1);
    }
    for (int i = nw; i < n; ++i) {  // tiles only the other warpgroup sees
      wait_full(i);
      sm90::mbar_arrive(&empty[i % kStages]);
    }

    // Every row below Sq is written: 0 where no live key reaches it.
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = r0 + 8 * hr;
      if (row < p.sq) {
        typename E::T* dqp = static_cast<typename E::T*>(p.dq) +
                             static_cast<long long>(bb) * p.s1b +
                             static_cast<long long>(hh) * p.s1h +
                             static_cast<long long>(row) * p.s1s;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          if (8 * j < p.d)
            *reinterpret_cast<typename E::T2*>(dqp + 8 * j + 2 * t) =
                E::pack2(dq[4 * j + 2 * hr] * p.scale,
                         dq[4 * j + 2 * hr + 1] * p.scale);
      }
    }
  }
}

// dk/dv: one block per (128 keys, head, batch); warpgroups 0 and 1 own 64
// key rows each. K and V stay resident in shared memory; query tiles of Q,
// dO and their lse and c slices stream through the ring: three stages,
// since while tile i is formed tile i - 1's stage is still read by dV and
// dK, and tile i + 1 loads. BQ = 64 queries at D = 64, 32 at D = 128 (to
// bound the registers of the two D-wide accumulators).
constexpr int kDkvBN = 128;

template <int D>
__host__ __device__ constexpr int dkv_bq() {
  return D == 64 ? 64 : 32;
}

struct DkvParams {
  CUtensorMap q, dout;  // boxes of 64 features x BQ rows
  CUtensorMap k, v;     // boxes of 64 features x 128 rows
  CUtensorMap lse, c;   // (B*H, Sq) f32, boxes of BQ
  void* dk;             // E::T
  void* dv;             // E::T
  long long s1b, s1h, s1s;
  long long s2b, s2h, s2s;
  int h, sq, sk;
  int d;  // true head dim: the stores skip the tile's columns past it
  int causal;
  long long q_offset, kv_offset;
  float scale;
};

// Shared memory, from a 1024-byte aligned base: K, V, then per stage Q,
// dO, lse and c, then the barriers. A K or V tile is D / 64 boxes of 128
// rows x 128 bytes; a Q or dO tile D / 64 boxes of BQ rows x 128 bytes.
template <int D>
struct DkvSmem {
  static constexpr int kBQ = dkv_bq<D>();
  static constexpr int kKBox = kDkvBN * 128;
  static constexpr int kKV = (D / 64) * kKBox;
  static constexpr int kQBox = kBQ * 128;
  static constexpr int kQT = (D / 64) * kQBox;
  static constexpr int kStage = (2 * kQT + 2 * kBQ * 4 + 1023) / 1024 * 1024;
  static constexpr int kK = 0;
  static constexpr int kV = kKV;
  static constexpr int kRing = 2 * kKV;
  static constexpr int kBar = kRing + kStages * kStage;
  static constexpr int kBytes = kBar + (1 + 2 * kStages) * 8 + 1024;
  static constexpr int kStageTx = 2 * kQT + 2 * kBQ * 4;
};

template <int D, class E>
__global__ void __launch_bounds__(kBlockThreads, 1)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ DkvParams p) {
  using L = DkvSmem<D>;
  constexpr int BQ = L::kBQ;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sm90::align1024(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  const int hh = blockIdx.x, bb = blockIdx.y;
  const int k0 = blockIdx.z * kDkvBN;  // low key tiles, the heaviest, first
  const int tid = threadIdx.x;

  // The first query tile that can see this block's keys: its last query
  // q_offset + q0 + BQ - 1 must reach the block's first key.
  int it0 = 0;
  if (p.causal) {
    const long long x = p.kv_offset + k0 - p.q_offset;
    it0 = x <= 0 ? 0 : static_cast<int>(x / BQ);
  }
  const int nq = (p.sq + BQ - 1) / BQ;
  const int n = nq > it0 ? nq - it0 : 0;

  if (tid == 0) {
    sm90::mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kConsumers);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // Producer warpgroup: one thread issues every load.
    sm90::reg_dealloc<kProducerRegs>();
    if (tid == kConsumers) {
      const int bh = bb * p.h + hh;
      sm90::mbar_arrive_expect_tx(kv_full, 2 * L::kKV);
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        sm90::tma_load_4d(smem + L::kK + c * L::kKBox, &p.k, kv_full, c * 64,
                          k0, hh, bb);
        sm90::tma_load_4d(smem + L::kV + c * L::kKBox, &p.v, kv_full, c * 64,
                          k0, hh, bb);
      }
      // stage s of the ring, and the parity of its pass round the ring
      int s = 0;
      uint32_t phase = 0;
      for (int q0 = it0 * BQ; q0 < it0 * BQ + n * BQ; q0 += BQ) {
        sm90::mbar_wait(&empty[s], phase ^ 1);
        sm90::mbar_arrive_expect_tx(&full[s], L::kStageTx);
        uint8_t* st = smem + L::kRing + s * L::kStage;
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          sm90::tma_load_4d(st + c * L::kQBox, &p.q, &full[s], c * 64, q0,
                            hh, bb);
          sm90::tma_load_4d(st + L::kQT + c * L::kQBox, &p.dout, &full[s],
                            c * 64, q0, hh, bb);
        }
        sm90::tma_load_2d(st + 2 * L::kQT, &p.lse, &full[s], q0, bh);
        sm90::tma_load_2d(st + 2 * L::kQT + BQ * 4, &p.c, &full[s], q0, bh);
        if (++s == kStages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // Consumer warpgroup w: key rows [64 w, 64 w + 64) of the block.
    sm90::reg_alloc<kConsumerRegs>();
    const int w = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int r0 = k0 + 64 * w + 16 * warp + g;  // key rows r0 and r0 + 8
    const uint8_t* ks = smem + L::kK + w * 64 * 128;
    const uint8_t* vs = smem + L::kV + w * 64 * 128;

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    const float sl2 = p.scale * kLog2e;
    const long long k_lo = p.kv_offset + k0 + 64 * w;
    // Causal liveness only grows with the query tile: tiles [0, i0) of the
    // block's run are dead for these 64 keys (the block's first key may
    // see queries these keys do not), tiles [i0, n) live.
    int i0 = 0;
    if (p.causal)
      while (i0 < n && p.q_offset + (it0 + i0) * BQ + BQ - 1 < k_lo) ++i0;

    float st[BQ / 2], dpt[BQ / 2];  // S^T, dP^T; then P^T, dS^T in f32
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];  // P^T, dS^T: A fragments

    auto stage = [&](int i) {
      return smem + L::kRing + (i % kStages) * L::kStage;
    };
    auto wait_full = [&](int i) {
      sm90::mbar_wait(&full[i % kStages], (i / kStages) & 1);
    };
    // S^T = K Q^T and dP^T = V dO^T of tile i, 64 keys x BQ queries
    // (issued, not waited).
    auto issue_sdp = [&](int i) {
      const uint8_t* qs = stage(i);
      const uint8_t* dos = qs + L::kQT;
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int ka = (kk / 4) * L::kKBox + (kk % 4) * 32;
        const int kb = (kk / 4) * L::kQBox + (kk % 4) * 32;
        sm90::Wgmma<BQ, E>::ss(st, sm90::desc_k(ks + ka),
                               sm90::desc_k(qs + kb), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int ka = (kk / 4) * L::kKBox + (kk % 4) * 32;
        const int kb = (kk / 4) * L::kQBox + (kk % 4) * 32;
        sm90::Wgmma<BQ, E>::ss(dpt, sm90::desc_k(vs + ka),
                               sm90::desc_k(dos + kb), kk > 0);
      }
      sm90::wgmma_commit();
    };
    // dV += P^T dO and dK += dS^T Q of tile i: dO and Q read MN-major
    // (their queries run down the rows) from the tiles the first two
    // products read K-major.
    auto issue_dkv = [&](int i) {
      const uint8_t* qs = stage(i);
      const uint8_t* dos = qs + L::kQT;
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        sm90::Wgmma<D, E>::rs_mn(
            dv, pa[kk], sm90::desc_mn(dos + kk * 16 * 128, L::kQBox), 1);
        sm90::Wgmma<D, E>::rs_mn(
            dk, da[kk], sm90::desc_mn(qs + kk * 16 * 128, L::kQBox), 1);
      }
      sm90::wgmma_commit();
    };
    // P^T = exp2(S^T scale log2e - lse log2e) and dS^T = P^T (dP^T - c) of
    // tile i, in place; the query is the column. lse -inf (a fully-masked
    // row) is taken as 1e30; rows past Sq read TMA's zero fill and are
    // masked, as are keys past Sk and (on the diagonal) future keys.
    auto grads = [&](int i) {
      const int q0 = (it0 + i) * BQ;
      const float* lse_s =
          reinterpret_cast<const float*>(stage(i) + 2 * L::kQT);
      const float* c_s = lse_s + BQ;
      bool live = true, diag = false;
      if (p.causal)
        causal_liveness<BQ, 64>(p.q_offset + q0, k_lo, live, diag);
      const bool masked = diag || q0 + BQ > p.sq || k0 + 64 * w + 64 > p.sk;
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const float2 l =
            *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * t);
        const float2 c = *reinterpret_cast<const float2*>(c_s + 8 * j + 2 * t);
        const float l2[2] = {(l.x == -INFINITY ? kSafeLse : l.x) * kLog2e,
                             (l.y == -INFINITY ? kSafeLse : l.y) * kLog2e};
        const float cc[2] = {c.x, c.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = fmaf(st[4 * j + e], sl2, -l2[e & 1]);
          if (masked) {
            const int key = r0 + 8 * (e >> 1);
            const int row = q0 + 8 * j + 2 * t + (e & 1);
            if (key >= p.sk || row >= p.sq ||
                (p.causal && p.kv_offset + key > p.q_offset + row))
              x = -INFINITY;
          }
          const float pr = sm90::exp2_approx(x);
          st[4 * j + e] = pr;
          dpt[4 * j + e] = pr * (dpt[4 * j + e] - cc[e & 1]);
        }
      }
    };
    // The accumulators of query columns [16 kk, 16 kk + 16) are the A
    // fragments of k-step kk of dV and dK.
    auto pack = [&]() {
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pa[kk][r] =
              sm90::pack<E>(st[8 * kk + 2 * r], st[8 * kk + 2 * r + 1]);
          da[kk][r] =
              sm90::pack<E>(dpt[8 * kk + 2 * r], dpt[8 * kk + 2 * r + 1]);
        }
    };

    sm90::mbar_wait(kv_full, 0);
    for (int i = 0; i < i0; ++i) {  // tiles only the other warpgroup sees
      wait_full(i);
      sm90::mbar_arrive(&empty[i % kStages]);
    }
    // Software pipeline over the live tiles: while P^T and dS^T of tile i
    // are formed on the CUDA cores, the tensor cores run dV and dK of tile
    // i - 1 (and the other warpgroup's products).
    // dV and dK of tile i waited for; then its stage may be refilled.
    auto finish_dkv = [&](int i) {
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dv);
      sm90::fence_regs(dk);
      sm90::mbar_arrive(&empty[i % kStages]);
    };
    if (i0 < n) {
      wait_full(i0);
      issue_sdp(i0);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(st);
      sm90::fence_regs(dpt);
      grads(i0);
      pack();
      for (int i = i0 + 1; i < n; ++i) {
        wait_full(i);
        issue_sdp(i);
        issue_dkv(i - 1);
        // S^T, dP^T of tile i done; dV, dK of tile i - 1 still in flight
        sm90::wgmma_wait<1>();
        sm90::fence_regs(st);
        sm90::fence_regs(dpt);
        grads(i);
        finish_dkv(i - 1);
        pack();
      }
      issue_dkv(n - 1);
      finish_dkv(n - 1);
    }

    // Every key row below Sk is written: 0 where no query sees it.
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = r0 + 8 * hr;
      if (row < p.sk) {
        typename E::T* dkp = static_cast<typename E::T*>(p.dk) +
                             static_cast<long long>(bb) * p.s1b +
                             static_cast<long long>(hh) * p.s1h +
                             static_cast<long long>(row) * p.s1s;
        typename E::T* dvp = static_cast<typename E::T*>(p.dv) +
                             static_cast<long long>(bb) * p.s2b +
                             static_cast<long long>(hh) * p.s2h +
                             static_cast<long long>(row) * p.s2s;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          if (8 * j >= p.d) continue;
          *reinterpret_cast<typename E::T2*>(dkp + 8 * j + 2 * t) =
              E::pack2(dk[4 * j + 2 * hr] * p.scale,
                       dk[4 * j + 2 * hr + 1] * p.scale);
          *reinterpret_cast<typename E::T2*>(dvp + 8 * j + 2 * t) =
              E::pack2(dv[4 * j + 2 * hr], dv[4 * j + 2 * hr + 1]);
        }
      }
    }
  }
}

// dk/dv at 128 < d <= 256: two D-wide accumulators (dK and dV, 256
// registers a thread for 64 keys) do not fit one warpgroup, so the
// warpgroups split the features. One block per (64 keys, head, batch);
// warpgroup w owns features [128 w, 128 w + 128) of dK and dV for all 64
// keys (64 + 64 registers a thread). K and V stay resident (32 KB each);
// query tiles of 64 (Q, dO: 32 KB each, with their lse and c slices)
// stream through a ring of two stages, which is what fits. S^T and dP^T
// of a tile are formed once, split by queries: warpgroup w forms keys x
// queries [32 w, 32 w + 32) of both (wgmma m64n32, SS), P^T and dS^T in
// f32 on its accumulators, rounds them to E where the reference rounds
// them, and writes them into shared tiles in the 128-byte swizzled
// K-major layout; after a named barrier over the two warpgroups, each
// multiplies the whole P^T and dS^T (A from shared memory) by its 128
// features of dO and Q (B MN-major from the streamed tiles). P^T and dS^T
// are double-buffered, so one barrier a tile keeps a warpgroup from
// overwriting what the other still reads: the buffer of tile i was last
// read by dV and dK of tile i - 2, which both warpgroups waited for before
// they reached the barrier of tile i - 1.
constexpr int kSplitBN = 64;  // keys per block
constexpr int kSplitBQ = 64;  // queries per streamed tile
constexpr int kSplitStages = 2;

// Shared memory, from a 1024-byte aligned base: K, V, then per stage Q and
// dO, then two buffers of P^T and dS^T, then per stage lse and c, then the
// barriers. A tile of 64 rows x 256 features is four boxes of 64 rows x 128
// bytes; P^T and dS^T (64 keys x 64 queries) one box each.
struct DkvSplitSmem {
  static constexpr int kBox = 64 * 128;
  static constexpr int kTile = 4 * kBox;
  static constexpr int kK = 0;
  static constexpr int kV = kTile;
  static constexpr int kRing = 2 * kTile;  // stage s: Q at kRing + 2 s kTile
  static constexpr int kPds = kRing + kSplitStages * 2 * kTile;
  static constexpr int kLc = kPds + 2 * 2 * kBox;  // stage s: lse, then c
  static constexpr int kBar = kLc + kSplitStages * 2 * kSplitBQ * 4;
  static constexpr int kBytes = kBar + (1 + 2 * kSplitStages) * 8 + 1024;
  static constexpr int kStageTx = 2 * kTile + 2 * kSplitBQ * 4;
  static_assert(kBytes <= 232448, "shared memory of one H100 block");
};

template <class E>
__global__ void __launch_bounds__(kBlockThreads, 1)
    flash_bwd_dkv_split_kernel(const __grid_constant__ DkvParams p) {
  using L = DkvSplitSmem;
  constexpr int BQ = kSplitBQ, S = kSplitStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sm90::align1024(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + S;

  const int hh = blockIdx.x, bb = blockIdx.y;
  const int k0 = blockIdx.z * kSplitBN;  // low key tiles, the heaviest, first
  const int tid = threadIdx.x;
  // The query tiles [it0, it0 + n) that can see this block's keys: the
  // last query q_offset + q0 + BQ - 1 of tile it0 reaches the block's
  // first key. Both warpgroups run every tile from there. Each role works
  // them out after its setmaxnreg, so that nothing stays live across it.
  auto tiles = [&](int& it0, int& n) {
    it0 = 0;
    if (p.causal) {
      const long long x = p.kv_offset + k0 - p.q_offset;
      it0 = x <= 0 ? 0 : static_cast<int>(x / BQ);
    }
    const int nq = (p.sq + BQ - 1) / BQ;
    n = nq > it0 ? nq - it0 : 0;
  };

  if (tid == 0) {
    sm90::mbar_init(kv_full, 1);
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kConsumers);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // Producer warpgroup: one thread issues every load.
    sm90::reg_dealloc<kProducerRegs>();
    if (tid == kConsumers) {
      int it0, n;
      tiles(it0, n);
      const int bh = bb * p.h + hh;
      sm90::mbar_arrive_expect_tx(kv_full, 2 * L::kTile);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        sm90::tma_load_4d(smem + L::kK + c * L::kBox, &p.k, kv_full, c * 64,
                          k0, hh, bb);
        sm90::tma_load_4d(smem + L::kV + c * L::kBox, &p.v, kv_full, c * 64,
                          k0, hh, bb);
      }
      for (int i = 0; i < n; ++i) {
        const int s = i % S, q0 = (it0 + i) * BQ;
        sm90::mbar_wait(&empty[s], ((i / S) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&full[s], L::kStageTx);
        uint8_t* st = smem + L::kRing + s * 2 * L::kTile;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          sm90::tma_load_4d(st + c * L::kBox, &p.q, &full[s], c * 64, q0, hh,
                            bb);
          sm90::tma_load_4d(st + L::kTile + c * L::kBox, &p.dout, &full[s],
                            c * 64, q0, hh, bb);
        }
        uint8_t* lc = smem + L::kLc + s * 2 * BQ * 4;
        sm90::tma_load_2d(lc, &p.lse, &full[s], q0, bh);
        sm90::tma_load_2d(lc + BQ * 4, &p.c, &full[s], q0, bh);
      }
    }
  } else {
    // Consumer warpgroup w: features [128 w, 128 w + 128) of dK and dV for
    // the block's 64 keys; queries [32 w, 32 w + 32) of each tile's S^T
    // and dP^T.
    sm90::reg_alloc<kConsumerRegs>();
    int it0, n;
    tiles(it0, n);
    const int w = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    const int r0 = 16 * warp + lane / 4;  // key rows r0, r0 + 8 of the block
    // queries qb + 8 j and qb + 8 j + 1 of a tile's S^T accumulators
    const int qb = 32 * w + 2 * (lane % 4);
    const uint8_t* ks = smem + L::kK;
    const uint8_t* vs = smem + L::kV;

    float dk[64], dv[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;
    const float sl2 = p.scale * kLog2e;
    float st[16], dpt[16];  // S^T, dP^T; then P^T, dS^T in f32

    auto stage = [&](int i) {
      return smem + L::kRing + (i % S) * 2 * L::kTile;
    };
    auto wait_full = [&](int i) {
      sm90::mbar_wait(&full[i % S], (i / S) & 1);
    };
    // S^T = K Q^T and dP^T = V dO^T of tile i, 64 keys x this warpgroup's
    // 32 queries (issued, not waited).
    auto issue_sdp = [&](int i) {
      const uint8_t* qs = stage(i) + w * 32 * 128;
      const uint8_t* dos = qs + L::kTile;
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 16; ++kk) {
        const int off = (kk / 4) * L::kBox + (kk % 4) * 32;
        sm90::Wgmma<32, E>::ss(st, sm90::desc_k(ks + off),
                               sm90::desc_k(qs + off), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < 16; ++kk) {
        const int off = (kk / 4) * L::kBox + (kk % 4) * 32;
        sm90::Wgmma<32, E>::ss(dpt, sm90::desc_k(vs + off),
                               sm90::desc_k(dos + off), kk > 0);
      }
      sm90::wgmma_commit();
    };
    // P^T = exp2(S^T scale log2e - lse log2e) and dS^T = P^T (dP^T - c) of
    // tile i, in place; the query is the column. lse -inf (a fully-masked
    // row) is taken as 1e30; rows past Sq read TMA's zero fill and are
    // masked, as are keys past Sk and (on the diagonal) future keys.
    auto grads = [&](int i) {
      const int q0 = (it0 + i) * BQ;
      const float* lse_s = reinterpret_cast<const float*>(
          smem + L::kLc + (i % S) * 2 * BQ * 4);
      const float* c_s = lse_s + BQ;
      bool live = true, diag = false;
      if (p.causal)
        causal_liveness<BQ, kSplitBN>(p.q_offset + q0, p.kv_offset + k0,
                                      live, diag);
      const bool masked = diag || q0 + BQ > p.sq || k0 + kSplitBN > p.sk;
      // In a masked tile, relative to this thread's first key and query:
      // keys at or past Sk, queries at or past Sq, and (causal) keys in
      // the query's future, kv_offset + key > q_offset + row, i.e. key -
      // row above `ahead` (the offsets' gap at the thread's first pair,
      // clamped to an int: -31 <= key - row <= 8 here; without causal it
      // is above every key - row).
      int key_end = 0, row_end = 0, ahead = 0;
      if (masked) {
        key_end = p.sk - k0 - r0;
        row_end = p.sq - q0 - qb;
        const long long gap = p.causal ? p.q_offset - p.kv_offset + q0 +
                                             qb - k0 - r0
                                       : 1ll << 40;
        ahead = static_cast<int>(gap > (1 << 30)    ? (1 << 30)
                                 : gap < -(1 << 30) ? -(1 << 30)
                                                    : gap);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = qb + 8 * j;  // query within the tile
        const float2 l = *reinterpret_cast<const float2*>(lse_s + qc);
        const float2 c = *reinterpret_cast<const float2*>(c_s + qc);
        const float l2[2] = {(l.x == -INFINITY ? kSafeLse : l.x) * kLog2e,
                             (l.y == -INFINITY ? kSafeLse : l.y) * kLog2e};
        const float cc[2] = {c.x, c.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = fmaf(st[4 * j + e], sl2, -l2[e & 1]);
          if (masked) {
            const int key = 8 * (e >> 1);       // past this thread's first
            const int row = 8 * j + (e & 1);    // key and query
            if (key >= key_end || row >= row_end || key - row > ahead)
              x = -INFINITY;
          }
          const float pr = sm90::exp2_approx(x);
          st[4 * j + e] = pr;
          dpt[4 * j + e] = pr * (dpt[4 * j + e] - cc[e & 1]);
        }
      }
    };
    // This warpgroup's queries of P^T and dS^T of tile i, rounded to E,
    // into buffer i % 2; then the barrier after which both warpgroups'
    // halves are there for the async proxy.
    auto store_pds = [&](int i) {
      uint8_t* ps = smem + L::kPds + (i & 1) * 2 * L::kBox;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // rows r0 and r0 + 8 (8 rows = 1024 bytes further, the same
        // swizzle), of P^T and then of dS^T one box further
        uint8_t* at = ps + sm90::sw128_offset(r0, qb + 8 * j);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          *reinterpret_cast<uint32_t*>(at + hr * 1024) =
              sm90::pack<E>(st[4 * j + 2 * hr], st[4 * j + 2 * hr + 1]);
          *reinterpret_cast<uint32_t*>(at + L::kBox + hr * 1024) =
              sm90::pack<E>(dpt[4 * j + 2 * hr], dpt[4 * j + 2 * hr + 1]);
        }
      }
      sm90::fence_proxy_async();
      sm90::bar_sync(1, kConsumers);
    };
    // dV += P^T dO and dK += dS^T Q of tile i over this warpgroup's
    // features: P^T and dS^T K-major from their shared tiles, dO and Q
    // MN-major (their queries run down the rows) from the streamed tiles.
    auto issue_dkv = [&](int i) {
      const uint8_t* qs = stage(i) + 2 * w * L::kBox;
      const uint8_t* dos = qs + L::kTile;
      const uint8_t* ps = smem + L::kPds + (i & 1) * 2 * L::kBox;
      const uint8_t* dss = ps + L::kBox;
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        sm90::Wgmma<128, E>::ss_mn(
            dv, sm90::desc_k(ps + kk * 32),
            sm90::desc_mn(dos + kk * 16 * 128, L::kBox), 1);
        sm90::Wgmma<128, E>::ss_mn(
            dk, sm90::desc_k(dss + kk * 32),
            sm90::desc_mn(qs + kk * 16 * 128, L::kBox), 1);
      }
      sm90::wgmma_commit();
    };

    // Per tile: dV and dK of tile i are issued, then S^T and dP^T of tile
    // i + 1; once the former are done the stage goes back to the producer
    // (the load of tile i + 2 then has the rest of the tile's time), and
    // P^T, dS^T of tile i + 1 are formed when the latter are.
    sm90::mbar_wait(kv_full, 0);
    if (n > 0) {
      wait_full(0);
      issue_sdp(0);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(st);
      sm90::fence_regs(dpt);
      grads(0);
      for (int i = 0; i + 1 < n; ++i) {
        store_pds(i);
        issue_dkv(i);
        wait_full(i + 1);
        issue_sdp(i + 1);
        sm90::wgmma_wait<1>();  // dV, dK of tile i done
        sm90::fence_regs(dv);
        sm90::fence_regs(dk);
        sm90::mbar_arrive(&empty[i % S]);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(st);
        sm90::fence_regs(dpt);
        grads(i + 1);
      }
      store_pds(n - 1);
      issue_dkv(n - 1);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dv);
      sm90::fence_regs(dk);
      sm90::mbar_arrive(&empty[(n - 1) % S]);
    }

    // Every key row below Sk is written: 0 where no query sees it.
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = k0 + r0 + 8 * hr;
      if (row < p.sk) {
        typename E::T* dkp = static_cast<typename E::T*>(p.dk) +
                             static_cast<long long>(bb) * p.s1b +
                             static_cast<long long>(hh) * p.s1h +
                             static_cast<long long>(row) * p.s1s;
        typename E::T* dvp = static_cast<typename E::T*>(p.dv) +
                             static_cast<long long>(bb) * p.s2b +
                             static_cast<long long>(hh) * p.s2h +
                             static_cast<long long>(row) * p.s2s;
        const int t = threadIdx.x % 4;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = 128 * w + 8 * j;
          if (col >= p.d) continue;
          *reinterpret_cast<typename E::T2*>(dkp + col + 2 * t) =
              E::pack2(dk[4 * j + 2 * hr] * p.scale,
                       dk[4 * j + 2 * hr + 1] * p.scale);
          *reinterpret_cast<typename E::T2*>(dvp + col + 2 * t) =
              E::pack2(dv[4 * j + 2 * hr], dv[4 * j + 2 * hr + 1]);
        }
      }
    }
  }
}

// dq at 128 < d <= 256: dQ is 128 registers a thread for 64 query rows at
// d 256 beside S and dP, too many for one warpgroup, so, as in the split
// dk/dv kernel with the roles of queries and keys swapped, the warpgroups
// split the features. One block per (64 queries, head, batch); warpgroup
// w owns features [128 w, 128 w + 128) of dQ for all 64 queries (64
// registers a thread). Q and dO stay resident (32 KB each); key tiles of
// 64 (K, V: 32 KB each) stream through a ring of two stages. S and dP of
// a tile are formed once, split by keys: warpgroup w forms queries x keys
// [32 w, 32 w + 32) of both (wgmma m64n32, SS, both K-major), P and dS in
// f32 on its accumulators, and writes dS, rounded to E where the reference
// rounds it, into a shared tile in the 128-byte swizzled K-major layout
// (queries as rows); after a named barrier over the two warpgroups, each
// multiplies the whole dS (A from shared memory) by its 128 features of
// the streamed K tile (B MN-major). dS is double-buffered, as the split
// kernel's P^T and dS^T are: the buffer of tile i was last read by dQ of
// tile i - 2, which both warpgroups waited for before they reached the
// barrier of tile i - 1.
constexpr int kDqSplitBM = 64;  // queries per block; key tiles of kDqBN
constexpr int kDqSplitStages = 2;

// Shared memory, from a 1024-byte aligned base: Q, dO, then per stage K
// and V, then the two dS buffers, then the barriers. A tile of 64 rows x
// 256 features is four boxes of 64 rows x 128 bytes; dS (64 queries x 64
// keys) one box.
struct DqSplitSmem {
  static constexpr int kBox = 64 * 128;
  static constexpr int kTile = 4 * kBox;
  static constexpr int kQ = 0;
  static constexpr int kDo = kTile;
  static constexpr int kRing = 2 * kTile;  // stage s: K at kRing + 2 s kTile
  static constexpr int kDs = kRing + kDqSplitStages * 2 * kTile;
  static constexpr int kBar = kDs + 2 * kBox;
  static constexpr int kBytes = kBar + (1 + 2 * kDqSplitStages) * 8 + 1024;
  static_assert(kBytes <= 232448, "shared memory of one H100 block");
  static_assert(kDqBN == 64 && kDqSplitBM == 64, "boxes of 64 rows");
};

template <class E>
__global__ void __launch_bounds__(kBlockThreads, 1)
    flash_bwd_dq_split_kernel(const __grid_constant__ DqParams p) {
  using L = DqSplitSmem;
  constexpr int BN = kDqBN, S = kDqSplitStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sm90::align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + S;

  const int hh = blockIdx.x, bb = blockIdx.y;
  const int tid = threadIdx.x;
  // The block's first query (high query tiles, which see the most keys
  // under the causal mask, launch first) and the key tiles [0, n) it runs
  // over. Each role works them out after its setmaxnreg, so that nothing
  // stays live across it.
  auto tiles = [&](int& q0, int& n) {
    q0 = (gridDim.z - 1 - blockIdx.z) * kDqSplitBM;
    n = dq_key_tiles(p, p.q_offset + q0,
                     p.sq - q0 < kDqSplitBM ? p.sq - q0 : kDqSplitBM);
  };

  if (tid == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kConsumers);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // Producer warpgroup: one thread issues every load.
    sm90::reg_dealloc<kProducerRegs>();
    if (tid == kConsumers) {
      int q0, n;
      tiles(q0, n);
      sm90::mbar_arrive_expect_tx(q_full, 2 * L::kTile);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        sm90::tma_load_4d(smem + L::kQ + c * L::kBox, &p.q, q_full, c * 64,
                          q0, hh, bb);
        sm90::tma_load_4d(smem + L::kDo + c * L::kBox, &p.dout, q_full,
                          c * 64, q0, hh, bb);
      }
      for (int i = 0; i < n; ++i) {
        const int s = i % S;
        sm90::mbar_wait(&empty[s], ((i / S) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&full[s], 2 * L::kTile);
        uint8_t* st = smem + L::kRing + s * 2 * L::kTile;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          sm90::tma_load_4d(st + c * L::kBox, &p.k, &full[s], c * 64, i * BN,
                            hh, bb);
          sm90::tma_load_4d(st + L::kTile + c * L::kBox, &p.v, &full[s],
                            c * 64, i * BN, hh, bb);
        }
      }
    }
  } else {
    // Consumer warpgroup w: features [128 w, 128 w + 128) of dQ for the
    // block's 64 queries; keys [32 w, 32 w + 32) of each tile's S and dP.
    sm90::reg_alloc<kConsumerRegs>();
    int q0, n;
    tiles(q0, n);
    const int w = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    const int r0 = 16 * warp + lane / 4;  // query rows r0, r0 + 8 of the block
    // keys kb + 8 j and kb + 8 j + 1 of a tile's S accumulators
    const int kb = 32 * w + 2 * (lane % 4);
    const uint8_t* qs = smem + L::kQ;
    const uint8_t* dos = smem + L::kDo;
    const long long bh = static_cast<long long>(bb) * p.h + hh;

    float lse2[2], cr[2];  // per row: lse in log2 units, c
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      lse2[hr] = safe_lse(p, bh, q0 + r0 + 8 * hr) * kLog2e;
      cr[hr] = row_c(p, bh, q0 + r0 + 8 * hr);
    }
    float dq[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dq[i] = 0.f;
    const float sl2 = p.scale * kLog2e;
    float s[16], dp[16];  // S, dP; then dS in dp

    auto stage = [&](int i) {
      return smem + L::kRing + (i % S) * 2 * L::kTile;
    };
    auto wait_full = [&](int i) {
      sm90::mbar_wait(&full[i % S], (i / S) & 1);
    };
    // S = Q K^T and dP = dO V^T of tile i, the block's 64 queries x this
    // warpgroup's 32 keys (issued, not waited).
    auto issue_sdp = [&](int i) {
      const uint8_t* ks = stage(i) + w * 32 * 128;
      const uint8_t* vs = ks + L::kTile;
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 16; ++kk) {
        const int off = (kk / 4) * L::kBox + (kk % 4) * 32;
        sm90::Wgmma<32, E>::ss(s, sm90::desc_k(qs + off),
                               sm90::desc_k(ks + off), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < 16; ++kk) {
        const int off = (kk / 4) * L::kBox + (kk % 4) * 32;
        sm90::Wgmma<32, E>::ss(dp, sm90::desc_k(dos + off),
                               sm90::desc_k(vs + off), kk > 0);
      }
      sm90::wgmma_commit();
    };
    // P = exp2(S scale log2e - lse log2e) and dS = P (dP - c) of tile i,
    // into dp. Only diagonal and ragged tiles are masked: TMA's zero fill
    // past Sk scores 0, not -inf, so keys at or past Sk are masked here, as
    // are (causal) keys in the query's future. Rows past Sq take lse = 1e30
    // (p = 0) and are never written.
    auto grads = [&](int i) {
      const int k0 = i * BN;
      bool live = true, diag = false;
      if (p.causal)
        causal_liveness<kDqSplitBM, BN>(p.q_offset + q0, p.kv_offset + k0,
                                        live, diag);
      const bool masked = diag || k0 + BN > p.sk;
      // In a masked tile, relative to this thread's first query and key:
      // keys at or past Sk, and (causal) keys in the query's future,
      // kv_offset + key > q_offset + row, i.e. key - row above `ahead` (the
      // offsets' gap at the thread's first pair, clamped to an int; without
      // causal it is above every key - row).
      int key_end = 0, ahead = 0;
      if (masked) {
        key_end = p.sk - k0 - kb;
        const long long gap = p.causal ? p.q_offset - p.kv_offset + q0 +
                                             r0 - k0 - kb
                                       : 1ll << 40;
        ahead = static_cast<int>(gap > (1 << 30)    ? (1 << 30)
                                 : gap < -(1 << 30) ? -(1 << 30)
                                                    : gap);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = fmaf(s[4 * j + e], sl2, -lse2[e >> 1]);
          if (masked) {
            const int key = 8 * j + (e & 1);  // past this thread's first
            const int row = 8 * (e >> 1);     // key and query
            if (key >= key_end || key - row > ahead) x = -INFINITY;
          }
          dp[4 * j + e] = sm90::exp2_approx(x) * (dp[4 * j + e] - cr[e >> 1]);
        }
    };
    // This warpgroup's keys of dS of tile i, rounded to E, into buffer i %
    // 2; then the barrier after which both warpgroups' halves are there for
    // the async proxy.
    auto store_ds = [&](int i) {
      uint8_t* ds = smem + L::kDs + (i & 1) * L::kBox;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // rows r0 and r0 + 8 (8 rows = 1024 bytes further, the same
        // swizzle)
        uint8_t* at = ds + sm90::sw128_offset(r0, kb + 8 * j);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          *reinterpret_cast<uint32_t*>(at + hr * 1024) =
              sm90::pack<E>(dp[4 * j + 2 * hr], dp[4 * j + 2 * hr + 1]);
      }
      sm90::fence_proxy_async();
      sm90::bar_sync(1, kConsumers);
    };
    // dQ += dS K of tile i over this warpgroup's features: dS K-major from
    // its shared tile, K MN-major (its keys run down the rows) from the
    // streamed tile the S product read K-major.
    auto issue_dq = [&](int i) {
      const uint8_t* ks = stage(i) + 2 * w * L::kBox;
      const uint8_t* ds = smem + L::kDs + (i & 1) * L::kBox;
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        sm90::Wgmma<128, E>::ss_mn(
            dq, sm90::desc_k(ds + kk * 32),
            sm90::desc_mn(ks + kk * 16 * 128, L::kBox), 1);
      sm90::wgmma_commit();
    };

    // Per tile: dQ of tile i is issued, then S and dP of tile i + 1; once
    // the former is done the stage goes back to the producer (the load of
    // tile i + 2 then has the rest of the tile's time), and dS of tile
    // i + 1 is formed when the latter are.
    sm90::mbar_wait(q_full, 0);
    if (n > 0) {
      wait_full(0);
      issue_sdp(0);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(s);
      sm90::fence_regs(dp);
      grads(0);
      for (int i = 0; i + 1 < n; ++i) {
        store_ds(i);
        issue_dq(i);
        wait_full(i + 1);
        issue_sdp(i + 1);
        sm90::wgmma_wait<1>();  // dQ of tile i done
        sm90::fence_regs(dq);
        sm90::mbar_arrive(&empty[i % S]);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(s);
        sm90::fence_regs(dp);
        grads(i + 1);
      }
      store_ds(n - 1);
      issue_dq(n - 1);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dq);
      sm90::mbar_arrive(&empty[(n - 1) % S]);
    }

    // Every row below Sq is written: 0 where no live key reaches it.
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = q0 + r0 + 8 * hr;
      if (row < p.sq) {
        typename E::T* dqp = static_cast<typename E::T*>(p.dq) +
                             static_cast<long long>(bb) * p.s1b +
                             static_cast<long long>(hh) * p.s1h +
                             static_cast<long long>(row) * p.s1s;
        const int t = threadIdx.x % 4;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = 128 * w + 8 * j;
          if (col >= p.d) continue;
          *reinterpret_cast<typename E::T2*>(dqp + col + 2 * t) =
              E::pack2(dq[4 * j + 2 * hr] * p.scale,
                       dq[4 * j + 2 * hr + 1] * p.scale);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 and fp16, d > 256: mma.sync, in chunks of 256 features

constexpr int kWideD = 256;  // a chunk's width; columns past d are zero
constexpr int kWideThreads = 128;
constexpr int kWideST = kWideD + 8;  // row stride: conflict-free fragments

// The columns of feature chunk c (kWideD wide) below the true d.
__device__ __forceinline__ int chunk_cols(int d, int c) {
  const int left = d - c * kWideD;
  return left < kWideD ? left : kWideD;
}

// dq: one block per (64 queries, chunk, head, batch), 4 warps x 16 query
// rows; K and V tiles of 32 keys.
constexpr int kWideDqBQ = 64;
constexpr int kWideDqBK = 32;
constexpr int kWideDqBytes = (2 * kWideDqBQ + 2 * kWideDqBK) * kWideST * 2;

// In nc = ceil(d / kWideD) chunks; the block's blockIdx.x % nc is the
// chunk oc of dQ it owns, S = Q K^T and dP = dO V^T sum over the chunks
// (each staged in turn into the same shared rows), and dQ += dS K takes
// K's chunk oc (staged again unless it was the last one).
template <class E>
__global__ void __launch_bounds__(kWideThreads)
    flash_bwd_dq_wide_kernel(Args a) {
  using T = typename E::T;
  constexpr int ST = kWideST, BQ = kWideDqBQ, BK = kWideDqBK;
  extern __shared__ __align__(16) uint8_t smem_dq_wide[];
  auto* q_s = reinterpret_cast<T*>(smem_dq_wide);
  T* do_s = q_s + BQ * ST;
  T* k_s = do_s + BQ * ST;
  T* v_s = k_s + BK * ST;

  const int nc = (a.d + kWideD - 1) / kWideD;
  const int q0 = blockIdx.x / nc * BQ, oc = blockIdx.x % nc;
  const int hh = blockIdx.y, bb = blockIdx.z;
  const long long bh = static_cast<long long>(bb) * a.h + hh;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = warp * 16;
  const T* qp = static_cast<const T*>(a.q) + bb * a.sqb + hh * a.sqh;
  const T* kp = static_cast<const T*>(a.k) + bb * a.skb + hh * a.skh;
  const T* vp = static_cast<const T*>(a.v) + bb * a.svb + hh * a.svh;
  const T* dp_ = static_cast<const T*>(a.dout) + bb * a.sdb + hh * a.sdh;
  T* dqp = static_cast<T*>(a.o1) + bb * a.s1b + hh * a.s1h;

  // Rows g and g + 8 of this warp's 16.
  float lse2[2], cr[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    lse2[hr] = safe_lse(a, bh, q0 + wr + g + 8 * hr) * kLog2e;
    cr[hr] = row_c(a, bh, q0 + wr + g + 8 * hr);
  }
  float acc[kWideD / 8][4];
#pragma unroll
  for (int dt = 0; dt < kWideD / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

  const float sl2 = a.scale * kLog2e;
  const long long q_lo = a.q_offset + q0;
  const int nk = (a.sk + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    bool diag = false;
    if (a.causal) {
      bool live;
      causal_liveness<BQ, BK>(q_lo, a.kv_offset + k0, live, diag);
      if (!live) break;  // every later tile lies further in the future
    }
    const bool masked = diag || k0 + BK > a.sk || q0 + BQ > a.sq;

    // S = Q K^T and dP = dO V^T: 16 rows x 32 keys per warp, over the
    // features of the tiles in shared memory.
    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
    auto sdp = [&]() {
#pragma unroll
      for (int kk = 0; kk < kWideD / 16; ++kk) {
        uint32_t qf[4], dof[4];
        sm90::load_a<ST>(qf, q_s, wr, kk, g, t);
        sm90::load_a<ST>(dof, do_s, wr, kk, g, t);
#pragma unroll
        for (int nt = 0; nt < BK / 8; ++nt) {
          const int off = (nt * 8 + g) * ST + kk * 16 + 2 * t;
          sm90::mma16816<E>(s[nt], qf, sm90::ld32(&k_s[off]),
                            sm90::ld32(&k_s[off + 8]));
          sm90::mma16816<E>(dp[nt], dof, sm90::ld32(&v_s[off]),
                            sm90::ld32(&v_s[off + 8]));
        }
      }
    };
    for (int c = 0; c < nc; ++c) {
      // the previous chunk's (or tile's) shared reads are done
      __syncthreads();
      const int cols = chunk_cols(a.d, c);
      sm90::stage_rows<BQ, kWideD, ST, kWideThreads>(
          q_s, qp + c * kWideD, a.sqs, q0, a.sq, cols, tid);
      sm90::stage_rows<BQ, kWideD, ST, kWideThreads>(
          do_s, dp_ + c * kWideD, a.sds, q0, a.sq, cols, tid);
      sm90::stage_rows<BK, kWideD, ST, kWideThreads>(
          k_s, kp + c * kWideD, a.sks, k0, a.sk, cols, tid);
      sm90::stage_rows<BK, kWideD, ST, kWideThreads>(
          v_s, vp + c * kWideD, a.svs, k0, a.sk, cols, tid);
      __syncthreads();
      sdp();
    }
    if (oc != nc - 1) {  // dQ's chunk of K
      __syncthreads();
      sm90::stage_rows<BK, kWideD, ST, kWideThreads>(
          k_s, kp + oc * kWideD, a.sks, k0, a.sk, chunk_cols(a.d, oc), tid);
      __syncthreads();
    }

    // dS = P (dP - c), P = exp2(S scale log2e - lse log2e).
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1;
        float x = s[nt][e] * sl2;
        if (masked &&
            pair_masked(a, q0 + wr + g + 8 * hr, k0 + nt * 8 + 2 * t + (e & 1)))
          x = -INFINITY;
        s[nt][e] = exp2f(x - lse2[hr]) * (dp[nt][e] - cr[hr]);
      }

    // dQ += dS K: dS re-packed as A fragments over the keys; K's keys run
    // down its rows (ldmatrix.trans).
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t da[4] = {
          sm90::pack<E>(s[2 * kk][0], s[2 * kk][1]),
          sm90::pack<E>(s[2 * kk][2], s[2 * kk][3]),
          sm90::pack<E>(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          sm90::pack<E>(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dt = 0; dt < kWideD / 8; dt += 2) {
        uint32_t b[4];
        sm90::load_b_kmajor_x2<ST>(b, k_s, kk, dt, lane);
        sm90::mma16816<E>(acc[dt], da, b[0], b[1]);
        sm90::mma16816<E>(acc[dt + 1], da, b[2], b[3]);
      }
    }
  }

  // Every row below Sq is written: 0 where no live key reaches it. This
  // block's columns: [oc kWideD, oc kWideD + kWideD) below d.
  const int f0 = oc * kWideD;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = q0 + wr + g + 8 * hr;
    if (row < a.sq) {
#pragma unroll
      for (int dt = 0; dt < kWideD / 8; ++dt)
        if (f0 + 8 * dt < a.d)
          *reinterpret_cast<typename E::T2*>(dqp + row * a.s1s + f0 + dt * 8 +
                                             2 * t) =
              E::pack2(acc[dt][2 * hr] * a.scale,
                       acc[dt][2 * hr + 1] * a.scale);
    }
  }
}

// dk/dv, d > 256: one block per (64 keys, a part of kWidePart features,
// head, batch), 4 warps x 16 key rows; query tiles of 32. The block's part
// of dK and dV takes 128 accumulators a thread.
constexpr int kWideDkvBK = 64;
constexpr int kWideDkvBQ = 32;
constexpr int kWidePart = kWideD / 2;
constexpr int kWideDkvBytes =
    (2 * kWideDkvBK + 2 * kWideDkvBQ) * kWideST * 2 + 2 * kWideDkvBQ * 4;

// The parts of kWidePart features dK and dV are split into.
__host__ __device__ __forceinline__ int dkv_parts(int d) {
  return (d + kWidePart - 1) / kWidePart;
}

// In nc = ceil(d / kWideD) chunks; the block's blockIdx.x % parts is its
// part of dK and dV, S^T = K Q^T and dP^T = V dO^T sum over the chunks (K,
// V, Q and dO staged in turn into the same shared rows), and dV, dK take
// the part's columns of dO and Q (their chunk staged again unless it was
// the last one).
template <class E>
__global__ void __launch_bounds__(kWideThreads)
    flash_bwd_dkv_wide_kernel(Args a) {
  using T = typename E::T;
  constexpr int ST = kWideST, BK = kWideDkvBK, BQ = kWideDkvBQ;
  extern __shared__ __align__(16) uint8_t smem_dkv_wide[];
  auto* k_s = reinterpret_cast<T*>(smem_dkv_wide);
  T* v_s = k_s + BK * ST;
  T* q_s = v_s + BK * ST;
  T* do_s = q_s + BQ * ST;
  auto* lse_s = reinterpret_cast<float*>(do_s + BQ * ST);  // log2 units
  float* c_s = lse_s + BQ;

  // This block's keys and features [f0, f0 + kWidePart), which lie in
  // chunk pc at column fc.
  const int parts = dkv_parts(a.d);
  const int nc = (a.d + kWideD - 1) / kWideD;
  const int k0 = (blockIdx.x / parts) * BK;
  const int f0 = (blockIdx.x % parts) * kWidePart;
  const int pc = f0 / kWideD;
  const int fc = f0 - pc * kWideD;
  const int hh = blockIdx.y, bb = blockIdx.z;
  const long long bh = static_cast<long long>(bb) * a.h + hh;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = warp * 16;
  const T* qp = static_cast<const T*>(a.q) + bb * a.sqb + hh * a.sqh;
  const T* kp = static_cast<const T*>(a.k) + bb * a.skb + hh * a.skh;
  const T* vp = static_cast<const T*>(a.v) + bb * a.svb + hh * a.svh;
  const T* dp_ = static_cast<const T*>(a.dout) + bb * a.sdb + hh * a.sdh;
  T* dkp = static_cast<T*>(a.o1) + bb * a.s1b + hh * a.s1h;
  T* dvp = static_cast<T*>(a.o2) + bb * a.s2b + hh * a.s2h;

  float dk[kWidePart / 8][4], dv[kWidePart / 8][4];
#pragma unroll
  for (int dt = 0; dt < kWidePart / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dt][e] = dv[dt][e] = 0.f;

  // The first query tile that can see this key tile: its last query
  // q_offset + q0 + BQ - 1 must reach the tile's first key.
  const long long k_lo = a.kv_offset + k0;
  int it0 = 0;
  if (a.causal) {
    const long long x = k_lo - a.q_offset;
    it0 = x <= 0 ? 0 : static_cast<int>(x / BQ);
  }
  const float sl2 = a.scale * kLog2e;
  const int nq = (a.sq + BQ - 1) / BQ;
  for (int it = it0; it < nq; ++it) {
    const int q0 = it * BQ;
    bool diag = false;
    if (a.causal) {
      bool live;
      causal_liveness<BQ, BK>(a.q_offset + q0, k_lo, live, diag);
      if (!live) continue;
    }
    const bool masked = diag || q0 + BQ > a.sq || k0 + BK > a.sk;

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x 32 queries per warp, over
    // the features of the tiles in shared memory.
    float st[BQ / 8][4], dpt[BQ / 8][4];
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
    auto sdp = [&]() {
#pragma unroll
      for (int kk = 0; kk < kWideD / 16; ++kk) {
        uint32_t kf[4], vf[4];
        sm90::load_a<ST>(kf, k_s, wr, kk, g, t);
        sm90::load_a<ST>(vf, v_s, wr, kk, g, t);
#pragma unroll
        for (int nt = 0; nt < BQ / 8; ++nt) {
          const int off = (nt * 8 + g) * ST + kk * 16 + 2 * t;
          sm90::mma16816<E>(st[nt], kf, sm90::ld32(&q_s[off]),
                            sm90::ld32(&q_s[off + 8]));
          sm90::mma16816<E>(dpt[nt], vf, sm90::ld32(&do_s[off]),
                            sm90::ld32(&do_s[off + 8]));
        }
      }
    };
    auto stage_lse_c = [&]() {
      for (int r = tid; r < BQ; r += kWideThreads) {
        lse_s[r] = safe_lse(a, bh, q0 + r) * kLog2e;
        c_s[r] = row_c(a, bh, q0 + r);
      }
    };
    for (int c = 0; c < nc; ++c) {
      // the previous chunk's (or tile's) shared reads are done
      __syncthreads();
      const int cols = chunk_cols(a.d, c);
      sm90::stage_rows<BK, kWideD, ST, kWideThreads>(
          k_s, kp + c * kWideD, a.sks, k0, a.sk, cols, tid);
      sm90::stage_rows<BK, kWideD, ST, kWideThreads>(
          v_s, vp + c * kWideD, a.svs, k0, a.sk, cols, tid);
      sm90::stage_rows<BQ, kWideD, ST, kWideThreads>(
          q_s, qp + c * kWideD, a.sqs, q0, a.sq, cols, tid);
      sm90::stage_rows<BQ, kWideD, ST, kWideThreads>(
          do_s, dp_ + c * kWideD, a.sds, q0, a.sq, cols, tid);
      if (c == 0) stage_lse_c();
      __syncthreads();
      sdp();
    }
    if (pc != nc - 1) {  // the part's chunk of Q and dO
      __syncthreads();
      const int cols = chunk_cols(a.d, pc);
      sm90::stage_rows<BQ, kWideD, ST, kWideThreads>(
          q_s, qp + pc * kWideD, a.sqs, q0, a.sq, cols, tid);
      sm90::stage_rows<BQ, kWideD, ST, kWideThreads>(
          do_s, dp_ + pc * kWideD, a.sds, q0, a.sq, cols, tid);
      __syncthreads();
    }

    // P^T and dS^T = P^T (dP^T - c); the query is the column here.
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = nt * 8 + 2 * t + (e & 1);  // query within the tile
        float x = st[nt][e] * sl2;
        if (masked && pair_masked(a, q0 + qc, k0 + wr + g + 8 * (e >> 1)))
          x = -INFINITY;
        const float pr = exp2f(x - lse_s[qc]);
        st[nt][e] = pr;
        dpt[nt][e] = pr * (dpt[nt][e] - c_s[qc]);
      }

    // dV += P^T dO and dK += dS^T Q over this block's features: the
    // accumulators re-packed as A fragments over the queries; dO and Q
    // read with their queries down the rows (ldmatrix.trans).
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      const uint32_t pa[4] = {
          sm90::pack<E>(st[2 * kk][0], st[2 * kk][1]),
          sm90::pack<E>(st[2 * kk][2], st[2 * kk][3]),
          sm90::pack<E>(st[2 * kk + 1][0], st[2 * kk + 1][1]),
          sm90::pack<E>(st[2 * kk + 1][2], st[2 * kk + 1][3])};
      const uint32_t da[4] = {
          sm90::pack<E>(dpt[2 * kk][0], dpt[2 * kk][1]),
          sm90::pack<E>(dpt[2 * kk][2], dpt[2 * kk][3]),
          sm90::pack<E>(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
          sm90::pack<E>(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3])};
#pragma unroll
      for (int dt = 0; dt < kWidePart / 8; dt += 2) {
        uint32_t b[4];
        sm90::load_b_kmajor_x2<ST>(b, do_s + fc, kk, dt, lane);
        sm90::mma16816<E>(dv[dt], pa, b[0], b[1]);
        sm90::mma16816<E>(dv[dt + 1], pa, b[2], b[3]);
        sm90::load_b_kmajor_x2<ST>(b, q_s + fc, kk, dt, lane);
        sm90::mma16816<E>(dk[dt], da, b[0], b[1]);
        sm90::mma16816<E>(dk[dt + 1], da, b[2], b[3]);
      }
    }
  }

  // Every key row below Sk is written: 0 where no query sees it.
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = k0 + wr + g + 8 * hr;
    if (row < a.sk) {
#pragma unroll
      for (int dt = 0; dt < kWidePart / 8; ++dt) {
        const int col = f0 + dt * 8 + 2 * t;
        if (f0 + 8 * dt >= a.d) continue;
        *reinterpret_cast<typename E::T2*>(dkp + row * a.s1s + col) =
            E::pack2(dk[dt][2 * hr] * a.scale, dk[dt][2 * hr + 1] * a.scale);
        *reinterpret_cast<typename E::T2*>(dvp + row * a.s2s + col) =
            E::pack2(dv[dt][2 * hr], dv[dt][2 * hr + 1]);
      }
    }
  }
}

template <class E>
int launch_dq_wide(const Args& a, int b, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_wide_kernel<E>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kWideDqBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nc = (a.d + kWideD - 1) / kWideD;
  dim3 grid((a.sq + kWideDqBQ - 1) / kWideDqBQ * nc, a.h, b);
  flash_bwd_dq_wide_kernel<E><<<grid, kWideThreads, kWideDqBytes, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <class E>
int launch_dkv_wide(const Args& a, int b, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_wide_kernel<E>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kWideDkvBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(dkv_parts(a.d) * ((a.sk + kWideDkvBK - 1) / kWideDkvBK), a.h, b);
  flash_bwd_dkv_wide_kernel<E><<<grid, kWideThreads, kWideDkvBytes, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// f32: CUDA cores. 128 threads = 16 rows x 8 lanes; a row's 8 threads are
// adjacent lanes of one warp, and lane c8 of a row takes the columns
// c8 + 8 i of the streamed tile and the features c8 + 8 j. Loads zero the
// features past d (they add nothing to a dot product), and stores skip
// them. D is the tiles' width: the head dim's (d <= 256), or one chunk of
// it (d > 256: kChunked, below).

constexpr int kThreads = 128;
constexpr int kSRows = 16;   // rows per block (queries for dq, keys for dk/dv)
constexpr int kSDkvBQ = 16;  // queries per tile of the dk/dv kernel

// Keys per tile of the dq kernel: 32 at D = 64, 16 at the wider tiles.
template <int D>
__host__ __device__ constexpr int dq_f32_bk() {
  return D == 64 ? 32 : 16;
}

// Dynamic shared memory of the dq kernel, in floats: Q and dO [kSRows][D +
// 1], K and V [BK][D + 1], dS [kSRows][BK + 1] (67 KB at D = 256).
template <int D>
struct F32DqSmem {
  static constexpr int kBK = dq_f32_bk<D>();
  static constexpr int kDo = kSRows * (D + 1);
  static constexpr int kK = 2 * kSRows * (D + 1);
  static constexpr int kV = kK + kBK * (D + 1);
  static constexpr int kDs = kV + kBK * (D + 1);
  static constexpr int kBytes = (kDs + kSRows * (kBK + 1)) * 4;
};

// The dk/dv kernel's, in floats: K and V [kSRows][D + 1], Q and dO
// [kSDkvBQ][D + 1], P and dS [kSRows][kSDkvBQ + 1], lse and c [kSDkvBQ].
template <int D>
struct F32DkvSmem {
  static constexpr int kV = kSRows * (D + 1);
  static constexpr int kQ = 2 * kSRows * (D + 1);
  static constexpr int kDo = kQ + kSDkvBQ * (D + 1);
  static constexpr int kP = kDo + kSDkvBQ * (D + 1);
  static constexpr int kDs = kP + kSRows * (kSDkvBQ + 1);
  static constexpr int kLse = kDs + kSRows * (kSDkvBQ + 1);
  static constexpr int kC = kLse + kSDkvBQ;
  static constexpr int kBytes = (kC + kSDkvBQ) * 4;
};

__device__ __forceinline__ float dot_row(const float* x, const float* y,
                                         int d, float acc = 0.f) {
#pragma unroll 16
  for (int i = 0; i < d; ++i) acc = fmaf(x[i], y[i], acc);
  return acc;
}

// A chunk of rows of an f32 operand into a shared tile of row stride D + 1
// (sm90::stage_rows_f32).
template <int R, int D>
__device__ __forceinline__ void stage_f32(float (*dst)[D + 1],
                                          const float* src,
                                          long long row_stride, int r0, int n,
                                          int c0, int d, int tid) {
  sm90::stage_rows_f32<R, D, D + 1, kThreads>(&dst[0][0], src, row_stride,
                                              r0, n, c0, d, tid);
}

// kChunked = false: d <= D, one tile; Q and dO stay in shared memory.
// kChunked = true: d > D, in nc = ceil(d / D) chunks of D = 256; the
// block's blockIdx.x % nc is the chunk oc of dQ it owns, S and dP sum over
// the chunks staged in turn, and dQ += dS K takes K's chunk oc (staged
// again unless it was the last one).
template <int D, bool kChunked>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_f32_kernel(Args a) {
  using L = F32DqSmem<D>;
  constexpr int BK = L::kBK;
  extern __shared__ __align__(16) uint8_t smem_dq_f32[];
  float* base = reinterpret_cast<float*>(smem_dq_f32);
  auto q_s = reinterpret_cast<float(*)[D + 1]>(base);
  auto do_s = reinterpret_cast<float(*)[D + 1]>(base + L::kDo);
  auto k_s = reinterpret_cast<float(*)[D + 1]>(base + L::kK);
  auto v_s = reinterpret_cast<float(*)[D + 1]>(base + L::kV);
  auto ds_s = reinterpret_cast<float(*)[BK + 1]>(base + L::kDs);

  int nc = 1, oc = 0, qt = blockIdx.x;
  if constexpr (kChunked) {
    nc = (a.d + D - 1) / D;
    qt = blockIdx.x / nc;
    oc = blockIdx.x % nc;
  }
  const int q0 = qt * kSRows;
  const int hh = blockIdx.y, bb = blockIdx.z;
  const long long bh = static_cast<long long>(bb) * a.h + hh;
  const int tid = threadIdx.x, r = tid / 8, c8 = tid % 8;
  const float* qp = static_cast<const float*>(a.q) + bb * a.sqb + hh * a.sqh;
  const float* kp = static_cast<const float*>(a.k) + bb * a.skb + hh * a.skh;
  const float* vp = static_cast<const float*>(a.v) + bb * a.svb + hh * a.svh;
  const float* dp_ =
      static_cast<const float*>(a.dout) + bb * a.sdb + hh * a.sdh;
  float* dqp = static_cast<float*>(a.o1) + bb * a.s1b + hh * a.s1h;

  if constexpr (!kChunked) {
    for (int e = tid; e < kSRows * D; e += kThreads) {
      const int rr = e / D, d = e % D;
      const bool in = q0 + rr < a.sq && d < a.d;
      q_s[rr][d] = in ? qp[(q0 + rr) * a.sqs + d] : 0.f;
      do_s[rr][d] = in ? dp_[(q0 + rr) * a.sds + d] : 0.f;
    }
  }
  const int row = q0 + r;
  const float lse = safe_lse(a, bh, row);
  const float cr = row_c(a, bh, row);
  float acc[D / 8];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j] = 0.f;

  const long long q_lo = a.q_offset + q0;
  const int nk = (a.sk + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    bool diag = false;
    if (a.causal) {
      bool live;
      causal_liveness<kSRows, BK>(q_lo, a.kv_offset + k0, live, diag);
      if (!live) break;
    }
    const bool masked = diag || k0 + BK > a.sk || q0 + kSRows > a.sq;
    float qk[BK / 8], dov[BK / 8];  // S and dP over the chunks so far
    if constexpr (kChunked) {
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) qk[i] = dov[i] = 0.f;
      for (int c = 0; c < nc; ++c) {
        // the previous chunk's (or tile's) shared reads are done
        __syncthreads();
        stage_f32<kSRows, D>(q_s, qp, a.sqs, q0, a.sq, c * D, a.d, tid);
        stage_f32<kSRows, D>(do_s, dp_, a.sds, q0, a.sq, c * D, a.d, tid);
        stage_f32<BK, D>(k_s, kp, a.sks, k0, a.sk, c * D, a.d, tid);
        stage_f32<BK, D>(v_s, vp, a.svs, k0, a.sk, c * D, a.d, tid);
        __syncthreads();
#pragma unroll
        for (int i = 0; i < BK / 8; ++i) {
          const int col = c8 + 8 * i;
          qk[i] = dot_row(q_s[r], k_s[col], D, qk[i]);
          dov[i] = dot_row(do_s[r], v_s[col], D, dov[i]);
        }
      }
      if (oc != nc - 1) {  // dQ's chunk of K
        __syncthreads();
        stage_f32<BK, D>(k_s, kp, a.sks, k0, a.sk, oc * D, a.d, tid);
        __syncthreads();
      }
    } else {
      __syncthreads();  // the previous tile's k_s/v_s reads are done
      for (int e = tid; e < BK * D; e += kThreads) {
        const int rr = e / D, d = e % D;
        const bool in = k0 + rr < a.sk && d < a.d;
        k_s[rr][d] = in ? kp[(k0 + rr) * a.sks + d] : 0.f;
        v_s[rr][d] = in ? vp[(k0 + rr) * a.svs + d] : 0.f;
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
      const int col = c8 + 8 * i;
      float s = (kChunked ? qk[i] : dot_row(q_s[r], k_s[col], D)) * a.scale;
      if (masked && pair_masked(a, row, k0 + col)) s = -INFINITY;
      const float p = expf(s - lse);
      ds_s[r][col] =
          p * ((kChunked ? dov[i] : dot_row(do_s[r], v_s[col], D)) - cr);
    }
    __syncwarp();  // a row's ds_s is written and read by its own 8 lanes
    for (int col = 0; col < BK; ++col) {
      const float ds = ds_s[r][col];
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        acc[j] = fmaf(ds, k_s[col][c8 + 8 * j], acc[j]);
    }
  }
  const int f0 = oc * D;  // this block's columns of dQ
  if (row < a.sq) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      if (f0 + 8 * j < a.d)
        dqp[row * a.s1s + f0 + c8 + 8 * j] = acc[j] * a.scale;
  }
}

// kChunked = false: d <= D, one tile; K and V stay in shared memory.
// kChunked = true: d > D, in nc = ceil(d / D) chunks of D = 256; the
// block's blockIdx.x % nc is the chunk oc of dK and dV it owns, S^T and
// dP^T sum over the chunks (K, V, Q and dO staged in turn), and dV, dK
// take dO's and Q's chunk oc (staged again unless it was the last one).
template <int D, bool kChunked>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_f32_kernel(Args a) {
  using L = F32DkvSmem<D>;
  extern __shared__ __align__(16) uint8_t smem_dkv_f32[];
  float* base = reinterpret_cast<float*>(smem_dkv_f32);
  auto k_s = reinterpret_cast<float(*)[D + 1]>(base);
  auto v_s = reinterpret_cast<float(*)[D + 1]>(base + L::kV);
  auto q_s = reinterpret_cast<float(*)[D + 1]>(base + L::kQ);
  auto do_s = reinterpret_cast<float(*)[D + 1]>(base + L::kDo);
  auto p_s = reinterpret_cast<float(*)[kSDkvBQ + 1]>(base + L::kP);
  auto ds_s = reinterpret_cast<float(*)[kSDkvBQ + 1]>(base + L::kDs);
  float* lse_s = base + L::kLse;
  float* c_s = base + L::kC;

  int nc = 1, oc = 0, kt = blockIdx.x;
  if constexpr (kChunked) {
    nc = (a.d + D - 1) / D;
    kt = blockIdx.x / nc;
    oc = blockIdx.x % nc;
  }
  const int k0 = kt * kSRows;
  const int hh = blockIdx.y, bb = blockIdx.z;
  const long long bh = static_cast<long long>(bb) * a.h + hh;
  const int tid = threadIdx.x, r = tid / 8, c8 = tid % 8;
  const float* qp = static_cast<const float*>(a.q) + bb * a.sqb + hh * a.sqh;
  const float* kp = static_cast<const float*>(a.k) + bb * a.skb + hh * a.skh;
  const float* vp = static_cast<const float*>(a.v) + bb * a.svb + hh * a.svh;
  const float* dp_ =
      static_cast<const float*>(a.dout) + bb * a.sdb + hh * a.sdh;
  float* dkp = static_cast<float*>(a.o1) + bb * a.s1b + hh * a.s1h;
  float* dvp = static_cast<float*>(a.o2) + bb * a.s2b + hh * a.s2h;

  if constexpr (!kChunked) {
    for (int e = tid; e < kSRows * D; e += kThreads) {
      const int rr = e / D, d = e % D;
      const bool in = k0 + rr < a.sk && d < a.d;
      k_s[rr][d] = in ? kp[(k0 + rr) * a.sks + d] : 0.f;
      v_s[rr][d] = in ? vp[(k0 + rr) * a.svs + d] : 0.f;
    }
  }
  const int key = k0 + r;
  float dk[D / 8], dv[D / 8];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) dk[j] = dv[j] = 0.f;

  const long long k_lo = a.kv_offset + k0;
  int it0 = 0;
  if (a.causal) {
    const long long x = k_lo - a.q_offset;
    it0 = x <= 0 ? 0 : static_cast<int>(x / kSDkvBQ);
  }
  const int nq = (a.sq + kSDkvBQ - 1) / kSDkvBQ;
  for (int it = it0; it < nq; ++it) {
    const int q0 = it * kSDkvBQ;
    bool diag = false;
    if (a.causal) {
      bool live;
      causal_liveness<kSDkvBQ, kSRows>(a.q_offset + q0, k_lo, live, diag);
      if (!live) continue;
    }
    const bool masked = diag || q0 + kSDkvBQ > a.sq || k0 + kSRows > a.sk;
    float kq[kSDkvBQ / 8], vdo[kSDkvBQ / 8];  // S^T, dP^T over the chunks
    if constexpr (kChunked) {
#pragma unroll
      for (int i = 0; i < kSDkvBQ / 8; ++i) kq[i] = vdo[i] = 0.f;
      for (int c = 0; c < nc; ++c) {
        // the previous chunk's (or tile's) shared reads are done
        __syncthreads();
        stage_f32<kSRows, D>(k_s, kp, a.sks, k0, a.sk, c * D, a.d, tid);
        stage_f32<kSRows, D>(v_s, vp, a.svs, k0, a.sk, c * D, a.d, tid);
        stage_f32<kSDkvBQ, D>(q_s, qp, a.sqs, q0, a.sq, c * D, a.d, tid);
        stage_f32<kSDkvBQ, D>(do_s, dp_, a.sds, q0, a.sq, c * D, a.d, tid);
        if (c == 0) {
          for (int rr = tid; rr < kSDkvBQ; rr += kThreads) {
            lse_s[rr] = safe_lse(a, bh, q0 + rr);
            c_s[rr] = row_c(a, bh, q0 + rr);
          }
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < kSDkvBQ / 8; ++i) {
          const int qc = c8 + 8 * i;
          kq[i] = dot_row(k_s[r], q_s[qc], D, kq[i]);
          vdo[i] = dot_row(v_s[r], do_s[qc], D, vdo[i]);
        }
      }
      if (oc != nc - 1) {  // the chunk oc of Q and dO
        __syncthreads();
        stage_f32<kSDkvBQ, D>(q_s, qp, a.sqs, q0, a.sq, oc * D, a.d, tid);
        stage_f32<kSDkvBQ, D>(do_s, dp_, a.sds, q0, a.sq, oc * D, a.d, tid);
        __syncthreads();
      }
    } else {
      __syncthreads();  // the previous tile's q_s/do_s reads are done
      for (int e = tid; e < kSDkvBQ * D; e += kThreads) {
        const int rr = e / D, d = e % D;
        const bool in = q0 + rr < a.sq && d < a.d;
        q_s[rr][d] = in ? qp[(q0 + rr) * a.sqs + d] : 0.f;
        do_s[rr][d] = in ? dp_[(q0 + rr) * a.sds + d] : 0.f;
      }
      for (int rr = tid; rr < kSDkvBQ; rr += kThreads) {
        lse_s[rr] = safe_lse(a, bh, q0 + rr);
        c_s[rr] = row_c(a, bh, q0 + rr);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < kSDkvBQ / 8; ++i) {
      const int qc = c8 + 8 * i;
      float s = (kChunked ? kq[i] : dot_row(k_s[r], q_s[qc], D)) * a.scale;
      if (masked && pair_masked(a, q0 + qc, key)) s = -INFINITY;
      const float p = expf(s - lse_s[qc]);
      p_s[r][qc] = p;
      ds_s[r][qc] =
          p * ((kChunked ? vdo[i] : dot_row(v_s[r], do_s[qc], D)) - c_s[qc]);
    }
    __syncwarp();
    for (int qc = 0; qc < kSDkvBQ; ++qc) {
      const float p = p_s[r][qc], ds = ds_s[r][qc];
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        dv[j] = fmaf(p, do_s[qc][c8 + 8 * j], dv[j]);
        dk[j] = fmaf(ds, q_s[qc][c8 + 8 * j], dk[j]);
      }
    }
    __syncwarp();  // p_s/ds_s are rewritten by the next tile
  }
  const int f0 = oc * D;  // this block's columns of dK and dV
  if (key < a.sk) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (f0 + 8 * j >= a.d) continue;
      dkp[key * a.s1s + f0 + c8 + 8 * j] = dk[j] * a.scale;
      dvp[key * a.s2s + f0 + c8 + 8 * j] = dv[j];
    }
  }
}

// The dq kernels' parameters: tensor maps of Q and dO in boxes of `bm`
// rows, of K and V in boxes of `bn`.
template <class E>
int dq_params(DqParams& p, const Args& a, int b, int bm, int bn) {
  int err = sm90::encode_rows<E>(&p.q, a.q, a.d, a.sq, a.h, b, a.sqs, a.sqh,
                                 a.sqb, bm);
  if (!err)
    err = sm90::encode_rows<E>(&p.dout, a.dout, a.d, a.sq, a.h, b, a.sds,
                               a.sdh, a.sdb, bm);
  if (!err)
    err = sm90::encode_rows<E>(&p.k, a.k, a.d, a.sk, a.h, b, a.sks, a.skh,
                               a.skb, bn);
  if (!err)
    err = sm90::encode_rows<E>(&p.v, a.v, a.d, a.sk, a.h, b, a.svs, a.svh,
                               a.svb, bn);
  if (err) return err;
  p.lse = a.lse;
  p.c = a.c;
  p.dq = a.o1;
  p.s1b = a.s1b;
  p.s1h = a.s1h;
  p.s1s = a.s1s;
  p.h = a.h;
  p.sq = a.sq;
  p.sk = a.sk;
  p.d = a.d;
  p.causal = a.causal;
  p.q_offset = a.q_offset;
  p.kv_offset = a.kv_offset;
  p.scale = a.scale;
  return 0;
}

template <int D, class E>
int launch_dq_wgmma(const Args& a, int b, cudaStream_t st) {
  DqParams p;
  const int err = dq_params<E>(p, a, b, kDqBM, kDqBN);
  if (err) return err;
  constexpr int bytes = DqSmem<D>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma_kernel<D, E>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(a.h, b, (a.sq + kDqBM - 1) / kDqBM);
  flash_bwd_dq_wgmma_kernel<D, E><<<grid, kBlockThreads, bytes, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <class E>
int launch_dq_split(const Args& a, int b, cudaStream_t st) {
  DqParams p;
  const int err = dq_params<E>(p, a, b, kDqSplitBM, kDqBN);
  if (err) return err;
  constexpr int bytes = DqSplitSmem::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_split_kernel<E>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(a.h, b, (a.sq + kDqSplitBM - 1) / kDqSplitBM);
  flash_bwd_dq_split_kernel<E><<<grid, kBlockThreads, bytes, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The dk/dv kernels' parameters: tensor maps of Q and dO in boxes of `bq`
// rows, of K and V in boxes of `bk`, of lse and c in boxes of `bq`.
template <class E>
int dkv_params(DkvParams& p, const Args& a, int b, int bq, int bk) {
  int err = sm90::encode_rows<E>(&p.q, a.q, a.d, a.sq, a.h, b, a.sqs, a.sqh,
                                 a.sqb, bq);
  if (!err)
    err = sm90::encode_rows<E>(&p.dout, a.dout, a.d, a.sq, a.h, b, a.sds,
                               a.sdh, a.sdb, bq);
  if (!err)
    err = sm90::encode_rows<E>(&p.k, a.k, a.d, a.sk, a.h, b, a.sks, a.skh,
                               a.skb, bk);
  if (!err)
    err = sm90::encode_rows<E>(&p.v, a.v, a.d, a.sk, a.h, b, a.svs, a.svh,
                               a.svb, bk);
  const long long rows = static_cast<long long>(b) * a.h;
  if (!err) err = sm90::encode_f32_rows(&p.lse, a.lse, a.sq, rows, bq);
  if (!err) err = sm90::encode_f32_rows(&p.c, a.c, a.sq, rows, bq);
  if (err) return err;
  p.dk = a.o1;
  p.dv = a.o2;
  p.s1b = a.s1b;
  p.s1h = a.s1h;
  p.s1s = a.s1s;
  p.s2b = a.s2b;
  p.s2h = a.s2h;
  p.s2s = a.s2s;
  p.h = a.h;
  p.sq = a.sq;
  p.sk = a.sk;
  p.d = a.d;
  p.causal = a.causal;
  p.q_offset = a.q_offset;
  p.kv_offset = a.kv_offset;
  p.scale = a.scale;
  return 0;
}

template <int D, class E>
int launch_dkv_wgmma(const Args& a, int b, cudaStream_t st) {
  DkvParams p;
  const int err = dkv_params<E>(p, a, b, dkv_bq<D>(), kDkvBN);
  if (err) return err;
  constexpr int bytes = DkvSmem<D>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_wgmma_kernel<D, E>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(a.h, b, (a.sk + kDkvBN - 1) / kDkvBN);
  flash_bwd_dkv_wgmma_kernel<D, E><<<grid, kBlockThreads, bytes, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <class E>
int launch_dkv_split(const Args& a, int b, cudaStream_t st) {
  DkvParams p;
  const int err = dkv_params<E>(p, a, b, kSplitBQ, kSplitBN);
  if (err) return err;
  constexpr int bytes = DkvSplitSmem::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_split_kernel<E>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(a.h, b, (a.sk + kSplitBN - 1) / kSplitBN);
  flash_bwd_dkv_split_kernel<E><<<grid, kBlockThreads, bytes, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kChunked>
int launch_dq_f32(const Args& a, int b, cudaStream_t st) {
  constexpr int bytes = F32DqSmem<D>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_f32_kernel<D, kChunked>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nc = kChunked ? (a.d + D - 1) / D : 1;
  dim3 grid((a.sq + kSRows - 1) / kSRows * nc, a.h, b);
  flash_bwd_dq_f32_kernel<D, kChunked><<<grid, kThreads, bytes, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kChunked>
int launch_dkv_f32(const Args& a, int b, cudaStream_t st) {
  constexpr int bytes = F32DkvSmem<D>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_f32_kernel<D, kChunked>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nc = kChunked ? (a.d + D - 1) / D : 1;
  dim3 grid((a.sk + kSRows - 1) / kSRows * nc, a.h, b);
  flash_bwd_dkv_f32_kernel<D, kChunked><<<grid, kThreads, bytes, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation of head dim a.d in a 16-bit type E. dq: tile widths 64
// and 128 (TMA + wgmma), 256 (TMA + wgmma, the features split over the
// warpgroups), and chunks of 256 past it (mma.sync). dk/dv: the same up to
// 256, and parts of 128 features past it (mma.sync).
template <class E>
int launch_dq16(const Args& a, int b, cudaStream_t st) {
  if (a.d <= 64) return launch_dq_wgmma<64, E>(a, b, st);
  if (a.d <= 128) return launch_dq_wgmma<128, E>(a, b, st);
  if (a.d <= 256) return launch_dq_split<E>(a, b, st);
  return launch_dq_wide<E>(a, b, st);
}

template <class E>
int launch_dkv16(const Args& a, int b, cudaStream_t st) {
  if (a.d <= 64) return launch_dkv_wgmma<64, E>(a, b, st);
  if (a.d <= 128) return launch_dkv_wgmma<128, E>(a, b, st);
  if (a.d <= 256) return launch_dkv_split<E>(a, b, st);
  return launch_dkv_wide<E>(a, b, st);
}

int launch_dq(const Args& a, int b, int dtype, cudaStream_t st) {
  if (dtype == 1) return launch_dq16<sm90::Bf16>(a, b, st);
  if (dtype == 2) return launch_dq16<sm90::F16>(a, b, st);
  if (a.d <= 64) return launch_dq_f32<64, false>(a, b, st);
  if (a.d <= 128) return launch_dq_f32<128, false>(a, b, st);
  if (a.d <= 256) return launch_dq_f32<256, false>(a, b, st);
  return launch_dq_f32<256, true>(a, b, st);
}

int launch_dkv(const Args& a, int b, int dtype, cudaStream_t st) {
  if (dtype == 1) return launch_dkv16<sm90::Bf16>(a, b, st);
  if (dtype == 2) return launch_dkv16<sm90::F16>(a, b, st);
  if (a.d <= 64) return launch_dkv_f32<64, false>(a, b, st);
  if (a.d <= 128) return launch_dkv_f32<128, false>(a, b, st);
  if (a.d <= 256) return launch_dkv_f32<256, false>(a, b, st);
  return launch_dkv_f32<256, true>(a, b, st);
}

int make_args(Args& a, const void* q, const void* k, const void* v,
              const void* dout, const void* lse, const void* c, void* o1,
              void* o2, const long long* st, int b, int h, int sq, int sk,
              int d, int dtype, int causal, long long q_offset,
              long long kv_offset, float scale) {
  if (dtype < 0 || dtype > 2 || d < 8 || d % 8 != 0 || b <= 0 || h <= 0 ||
      sq <= 0 || sk < 0 || st == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  a = Args{q,      k,      v,      dout,   static_cast<const float*>(lse),
           static_cast<const float*>(c),   o1,     o2,
           st[0],  st[1],  st[2],  st[3],  st[4],  st[5],
           st[6],  st[7],  st[8],  st[9],  st[10], st[11],
           st[12], st[13], st[14], st[15], st[16], st[17],
           h,      sq,     sk,     d,      causal, q_offset, kv_offset,
           scale};
  return 0;
}

}  // namespace

extern "C" {

// Both entries take the same arguments. Pointers: q, k, v, do (the input
// dtype), lse and c (f32, (B*H, Sq) contiguous), then the outputs: dq and
// NULL for flash_bwd_dq, dk and dv for flash_bwd_dkv. strides: 18 element
// strides, (batch, head, sequence) of q, k, v, do, out1, out2 (out2's are
// ignored by flash_bwd_dq). dtype: 0 = float32, 1 = bfloat16, 2 =
// float16; d a multiple of 8 from 8 up. Returns the CUDA error of the
// launch (0 = success).
int flash_bwd_dq(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* c, void* dq,
                 void* unused, const long long* strides, int b, int h, int sq,
                 int sk, int d, int dtype, int causal, long long q_offset,
                 long long kv_offset, float scale, void* stream) {
  Args a;
  const int bad = make_args(a, q, k, v, dout, lse, c, dq, unused, strides, b,
                            h, sq, sk, d, dtype, causal, q_offset, kv_offset,
                            scale);
  if (bad) return bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return launch_dq(a, b, dtype, st);
}

int flash_bwd_dkv(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* c, void* dk,
                  void* dv, const long long* strides, int b, int h, int sq,
                  int sk, int d, int dtype, int causal, long long q_offset,
                  long long kv_offset, float scale, void* stream) {
  Args a;
  const int bad = make_args(a, q, k, v, dout, lse, c, dk, dv, strides, b, h,
                            sq, sk, d, dtype, causal, q_offset, kv_offset,
                            scale);
  if (bad) return bad;
  if (sk == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return launch_dkv(a, b, dtype, st);
}

const char* flash_bwd_error_string(int code) {
  return sm90::error_string(code);
}

}  // extern "C"
