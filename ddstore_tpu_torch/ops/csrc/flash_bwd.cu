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
// from the first one that can see it. As the TPU's grids fold B*H into one
// axis (ddstore_tpu/ops/attention.py:366, :384), every kernel's blocks lie
// on grid x alone, (tile block, batch, head) folded by sm90::GridPos: CUDA
// caps grid y and z at 65,535, which B, H and a long sequence's tile
// blocks each pass. The two kernels write disjoint outputs, so there are
// no atomics and the gradients are deterministic (bit-identical from
// launch to launch). Every output row is written, as
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
// which the stores skip), and past d = 256 chunks of 256 (the split
// kernels' blocks, below). The f32 kernels (3xTF32, below) take the
// features in chunks of 32 and own dQ, dK and dV in blocks of 64, 128 or
// 256 columns (256 past it). Shared memory and registers are sized by the
// tile or chunk, never by d.
//
// Bound on the H100 SXM at the LM's shape, (B, H, S, D) = (8, 16, 2048,
// 64) bf16 causal, 2.686e8 live score pairs: dq does 3 products of 2*D
// FLOP a pair (s, dp, dq), 1.03e11 FLOP = 0.104 ms at 989 TFLOP/s, against
// about 170 MB of bytes (q, k, v, do, lse, c read, dq written) = 0.051 ms
// at 3.35 TB/s; dk/dv does 4 (s, dp, dv, dk), 1.375e11 FLOP = 0.139 ms,
// against about 203 MB = 0.061 ms. Both are bound by operations, and by
// the same counts at (8, 4, 2048, 256). In f32 the same products run as
// three TF32 products each (below) at 495 TFLOP/s: dq 3 x 1.031e11 FLOP =
// 0.625 ms, dk/dv 3 x 1.375e11 = 0.833 ms (on the CUDA cores at 67
// TFLOP/s they would be 1.539 and 2.052 ms), at every d with H = 1024 / d;
// f32 bytes (twice bf16's) take 0.10 and 0.12 ms.
//
// Design, and what it leaves on the table. The 16-bit kernels at every d
// (bf16 below; fp16 the same) are a TMA tile ring + wgmma (sm90.cuh) in
// blocks of three warpgroups: warpgroup 2 gives up its registers
// (setmaxnreg, 24 left against 240 for each consumer) and one of its
// threads issues every TMA load; at d <= 128 warpgroups 0 and 1 each own
// 64 rows of the block's resident operand, past 128 half its features (of
// a 256-feature chunk past 256).
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
// * bf16 and fp16 dk/dv at d > 256 (flash_bwd_dkv_chunked_kernel): the
//   split dk/dv kernel in nc = ceil(d / 256) chunks. One block per (64
//   keys, chunk oc of dK's and dV's columns); nothing is resident: for
//   each 64-query tile one producer thread streams the (K_c, Q_c) and
//   (V_c, dO_c) pairs of every chunk through three 64 KB slots, chunk oc
//   last, whose two slots stay held for dV += P^T dO_oc and dK += dS^T
//   Q_oc. S^T and dP^T are summed over the chunks (each warpgroup 32
//   queries), P^T and dS^T formed once and exchanged as in the split
//   kernel. A block forms S^T and dP^T over all d and dV, dK over its 256
//   columns: at d 512, 3072 feature-products a (key, query) pair against
//   the minimal 2048. Left out: a cluster of the chunks' blocks sharing
//   P^T and dS^T, overlap of a pair's products with the next pair's wait,
//   persistent blocks.
// * bf16 and fp16 dq at d > 256 (flash_bwd_dq_chunked_kernel): the split
//   dq kernel in nc = ceil(d / 256) chunks, as the chunked dk/dv kernel
//   carries the split one. One block per (64 queries, chunk oc of dQ's
//   columns); nothing is resident: for each live 64-key tile one producer
//   thread streams the (Q_c, K_c) and (dO_c, V_c) pairs of every chunk
//   through three 64 KB slots, chunk oc last, whose (Q, K) slot stays held
//   for dQ += dS K_oc. S and dP are summed over the chunks (each warpgroup
//   32 keys), dS formed once and exchanged as in the split kernel; lse and
//   c are the block's own rows, in registers. A block forms S and dP over
//   all d and dQ over its 256 columns: at d 512, 2560 feature-products a
//   (query, key) pair against the minimal 1536. Q_c and dO_c are streamed
//   again for every key tile (64 rows x d of each is 128 KB at d 512, too
//   much to keep beside a ring). Left out: a cluster of the chunks' blocks
//   sharing dS, overlap of a pair's products with the next pair's wait,
//   persistent blocks.
// * f32 (flash_bwd_dq_tf32_kernel, flash_bwd_dkv_tf32_kernel, below): the
//   tensor cores take f32 products as TF32 (10 mantissa bits, about 5e-4 a
//   product, which misses f32's 1e-4 a row), so each f32 product a b runs
//   as three TF32 products a_hi b_hi + a_hi b_lo + a_lo b_hi (hi =
//   rna_tf32(x), lo = rna_tf32(x - hi): about 2^-21 a product), and each
//   chunk of 4 k-steps is summed afresh on the tensor cores and added in
//   f32 on the CUDA cores. TF32 wgmma reads both operands K-major only, so
//   the operand whose contracted dim runs down its rows (K in dS K, Q and
//   dO in dS^T Q and P^T dO) is written transposed by the producer
//   warpgroup as it splits the landed tile; the transposed tiles store
//   each group of 8 columns in the order the accumulators' A fragments
//   hold them (tf32_kpos), so dS, P^T and dS^T feed the products from
//   registers as they are. dq forms dP on the FP64 tensor cores
//   (mma.sync m16n8k4 in f64: exact products, sums at 2^-53) and rounds
//   dP - c to f32 once: the first query's dQ row is p (dP - c) k with dP
//   equal to c up to rounding, so any f32 sum of dP would leave only its
//   own rounding there; the plain version forms the same arithmetic.
//   Bound by the split: a landed f32 tile is split (and transposed) by 96
//   producer threads, which at d 256 cost dk/dv more than its products,
//   and the streamed side is split again for every tile of the other side.

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
  sm90::Fold fold;  // the grid's blocks on x (sm90::GridPos)
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

  const sm90::GridPos pos = sm90::tile_major(p.fold);
  const int hh = pos.h, bb = pos.b;
  const int q0 = (p.fold.tiles.d - 1 - pos.t) * kDqBM;  // heaviest first
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
  sm90::Fold fold;  // the grid's blocks on x (sm90::GridPos)
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

  const sm90::GridPos pos = sm90::tile_major(p.fold);
  const int hh = pos.h, bb = pos.b;
  const int k0 = pos.t * kDkvBN;  // low key tiles, the heaviest, first
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
// they reached the barrier of tile i - 1. Past d = 256 the same block, in
// chunks of 256 features (flash_bwd_dkv_chunked_kernel, below), shares
// the pieces that follow.
constexpr int kSplitBN = 64;  // keys per block
constexpr int kSplitBQ = 64;  // queries per streamed tile
constexpr int kSplitStages = 2;
constexpr int kSplitBox = 64 * 128;  // 64 rows x 64 16-bit features

// P^T = exp2(S^T scale log2e - lse log2e) and dS^T = P^T (dP^T - c) of the
// query tile from q0, in place; the query is the column. lse -inf (a
// fully-masked row) is taken as 1e30; rows past Sq read TMA's zero fill and
// are masked, as are keys past Sk and (on the diagonal) future keys. r0 is
// this thread's first key row within the block of keys from k0, qb its
// first query within the tile (queries qb + 8 j and qb + 8 j + 1 of the
// accumulators); lse_s and c_s the tile's slices.
__device__ __forceinline__ void split_grads(const DkvParams& p,
                                            float (&st)[16],
                                            float (&dpt)[16],
                                            const float* lse_s,
                                            const float* c_s, int q0,
                                            int k0, int r0, int qb,
                                            float sl2) {
  bool live = true, diag = false;
  if (p.causal)
    causal_liveness<kSplitBQ, kSplitBN>(p.q_offset + q0, p.kv_offset + k0,
                                        live, diag);
  const bool masked = diag || q0 + kSplitBQ > p.sq || k0 + kSplitBN > p.sk;
  // In a masked tile, relative to this thread's first key and query: keys
  // at or past Sk, queries at or past Sq, and (causal) keys in the query's
  // future, kv_offset + key > q_offset + row, i.e. key - row above `ahead`
  // (the offsets' gap at the thread's first pair, clamped to an int: -31
  // <= key - row <= 8 here; without causal it is above every key - row).
  int key_end = 0, row_end = 0, ahead = 0;
  if (masked) {
    key_end = p.sk - k0 - r0;
    row_end = p.sq - q0 - qb;
    const long long gap = p.causal ? p.q_offset - p.kv_offset + q0 + qb -
                                         k0 - r0
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
        const int key = 8 * (e >> 1);     // past this thread's first
        const int row = 8 * j + (e & 1);  // key and query
        if (key >= key_end || row >= row_end || key - row > ahead)
          x = -INFINITY;
      }
      const float pr = sm90::exp2_approx(x);
      st[4 * j + e] = pr;
      dpt[4 * j + e] = pr * (dpt[4 * j + e] - cc[e & 1]);
    }
  }
}

// This warpgroup's queries of P^T and dS^T, rounded to E, into the buffer
// at ps (P^T, then dS^T one box further); then the barrier after which
// both warpgroups' halves are there for the async proxy.
template <class E>
__device__ __forceinline__ void split_store_pds(uint8_t* ps,
                                                const float (&st)[16],
                                                const float (&dpt)[16],
                                                int r0, int qb) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // rows r0 and r0 + 8 (8 rows = 1024 bytes further, the same swizzle)
    uint8_t* at = ps + sm90::sw128_offset(r0, qb + 8 * j);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      *reinterpret_cast<uint32_t*>(at + hr * 1024) =
          sm90::pack<E>(st[4 * j + 2 * hr], st[4 * j + 2 * hr + 1]);
      *reinterpret_cast<uint32_t*>(at + kSplitBox + hr * 1024) =
          sm90::pack<E>(dpt[4 * j + 2 * hr], dpt[4 * j + 2 * hr + 1]);
    }
  }
  sm90::fence_proxy_async();
  sm90::bar_sync(1, kConsumers);
}

// dV += P^T dO and dK += dS^T Q over this warpgroup's 128 features: P^T
// and dS^T K-major from the buffer at ps, dO and Q MN-major (their queries
// run down the rows) from the streamed tiles, qs and dos at the
// warpgroup's first feature box (issued and committed, not waited).
template <class E>
__device__ __forceinline__ void split_issue_dkv(float (&dv)[64],
                                                float (&dk)[64],
                                                const uint8_t* ps,
                                                const uint8_t* qs,
                                                const uint8_t* dos) {
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kSplitBQ / 16; ++kk) {
    sm90::Wgmma<128, E>::ss_mn(dv, sm90::desc_k(ps + kk * 32),
                               sm90::desc_mn(dos + kk * 16 * 128, kSplitBox),
                               1);
    sm90::Wgmma<128, E>::ss_mn(dk, sm90::desc_k(ps + kSplitBox + kk * 32),
                               sm90::desc_mn(qs + kk * 16 * 128, kSplitBox),
                               1);
  }
  sm90::wgmma_commit();
}

// Rows `row` and row + 8 of dK and dV (every key row below Sk: 0 where no
// query sees it), this thread's columns of the warpgroup's 128 from f0.
template <class E>
__device__ __forceinline__ void split_store_rows(const DkvParams& p,
                                                 const float (&dk)[64],
                                                 const float (&dv)[64],
                                                 int bb, int hh, int row,
                                                 int f0) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr, row += 8) {
    if (row >= p.sk) continue;
    typename E::T* dkp = static_cast<typename E::T*>(p.dk) +
                         static_cast<long long>(bb) * p.s1b +
                         static_cast<long long>(hh) * p.s1h +
                         static_cast<long long>(row) * p.s1s;
    typename E::T* dvp = static_cast<typename E::T*>(p.dv) +
                         static_cast<long long>(bb) * p.s2b +
                         static_cast<long long>(hh) * p.s2h +
                         static_cast<long long>(row) * p.s2s;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = f0 + 8 * j;
      if (col >= p.d) continue;
      *reinterpret_cast<typename E::T2*>(dkp + col + 2 * t) =
          E::pack2(dk[4 * j + 2 * hr] * p.scale,
                   dk[4 * j + 2 * hr + 1] * p.scale);
      *reinterpret_cast<typename E::T2*>(dvp + col + 2 * t) =
          E::pack2(dv[4 * j + 2 * hr], dv[4 * j + 2 * hr + 1]);
    }
  }
}

// The query tiles [it0, it0 + n) of kSplitBQ that can see the block's keys
// from k0: the last query q_offset + q0 + BQ - 1 of tile it0 reaches the
// block's first key. Both warpgroups run every tile from there.
__device__ __forceinline__ void split_query_tiles(const DkvParams& p, int k0,
                                                  int& it0, int& n) {
  it0 = 0;
  if (p.causal) {
    const long long x = p.kv_offset + k0 - p.q_offset;
    it0 = x <= 0 ? 0 : static_cast<int>(x / kSplitBQ);
  }
  const int nq = (p.sq + kSplitBQ - 1) / kSplitBQ;
  n = nq > it0 ? nq - it0 : 0;
}

// Shared memory, from a 1024-byte aligned base: K, V, then per stage Q and
// dO, then two buffers of P^T and dS^T, then per stage lse and c, then the
// barriers. A tile of 64 rows x 256 features is four boxes of 64 rows x 128
// bytes; P^T and dS^T (64 keys x 64 queries) one box each.
struct DkvSplitSmem {
  static constexpr int kBox = kSplitBox;
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

  const sm90::GridPos pos = sm90::tile_major(p.fold);
  const int hh = pos.h, bb = pos.b;
  const int k0 = pos.t * kSplitBN;  // low key tiles, the heaviest, first
  const int tid = threadIdx.x;

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
      // (worked out after setmaxnreg, so that nothing stays live across it)
      int it0, n;
      split_query_tiles(p, k0, it0, n);
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
    split_query_tiles(p, k0, it0, n);
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
    auto grads = [&](int i) {
      const float* lse_s = reinterpret_cast<const float*>(
          smem + L::kLc + (i % S) * 2 * BQ * 4);
      split_grads(p, st, dpt, lse_s, lse_s + BQ, (it0 + i) * BQ, k0, r0, qb,
                  sl2);
    };
    auto pds = [&](int i) { return smem + L::kPds + (i & 1) * 2 * L::kBox; };
    auto issue_dkv = [&](int i) {
      const uint8_t* qs = stage(i) + 2 * w * L::kBox;
      split_issue_dkv<E>(dv, dk, pds(i), qs, qs + L::kTile);
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
        split_store_pds<E>(pds(i), st, dpt, r0, qb);
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
      split_store_pds<E>(pds(n - 1), st, dpt, r0, qb);
      issue_dkv(n - 1);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dv);
      sm90::fence_regs(dk);
      sm90::mbar_arrive(&empty[(n - 1) % S]);
    }
    split_store_rows<E>(p, dk, dv, bb, hh, k0 + r0, 128 * w);
  }
}

// dk/dv at d > 256: the split kernel's block in nc = ceil(d / 256) chunks
// of 256 features. One block per (64 keys, chunk oc of dK's and dV's
// columns, head, batch), the chunk index folded into the key-tile
// index; warpgroup w owns features 256 oc + [128 w, 128 w + 128) of dK and
// dV (64 + 64 registers a thread), as in the split kernel. Nothing is
// resident: for each 64-query tile the producer streams, through a ring
// of three 64 KB slots, the pairs (K_c, Q_c) and (V_c, dO_c) of every
// chunk c (each 64 rows x 256 features), in the order oc + 1, ..., nc - 1,
// 0, ..., oc. Each consumer sums S^T = K Q^T over the (K_c, Q_c) pairs and
// dP^T = V dO^T over the (V_c, dO_c) pairs for its 32 queries (wgmma m64n32
// SS, each pair's slot handed back once its product is done), forms P^T
// and dS^T once as the split kernel does, and multiplies them into dV and
// dK by dO_oc and Q_oc, which the last two slots of the tile still hold
// (handed back once dV and dK are done, while the next tile's first pair
// already loads into the third slot). The tile's lse and c slices come
// with its last pair. A block forms S^T and dP^T over all d and dV, dK
// over its 256 columns: at d 512, 2 (2 x 512) + 2 (2 x 256) = 3072
// feature-products a (key, query) pair, against the minimal 2048.
constexpr int kChunkSlots = 3;

// Shared memory, from a 1024-byte aligned base: the slots (a pair of 64-row
// chunk tiles, four boxes each), two buffers of P^T and dS^T, per slot lse
// and c, then the barriers.
struct DkvChunkSmem {
  static constexpr int kTile = 4 * kSplitBox;
  static constexpr int kSlot = 2 * kTile;
  static constexpr int kPds = kChunkSlots * kSlot;
  static constexpr int kLc = kPds + 2 * 2 * kSplitBox;  // slot s: lse, then c
  static constexpr int kBar = kLc + kChunkSlots * 2 * kSplitBQ * 4;
  static constexpr int kBytes = kBar + 2 * kChunkSlots * 8 + 1024;
  static_assert(kBytes <= 232448, "shared memory of one H100 block");
};

template <class E>
__global__ void __launch_bounds__(kBlockThreads, 1)
    flash_bwd_dkv_chunked_kernel(const __grid_constant__ DkvParams p) {
  using L = DkvChunkSmem;
  constexpr int BQ = kSplitBQ, S = kChunkSlots;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sm90::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* empty = full + S;

  const sm90::GridPos pos = sm90::tile_major(p.fold);
  const int hh = pos.h, bb = pos.b;
  const int tid = threadIdx.x;
  // The block's keys and chunk of dK and dV, low key tiles (the heaviest)
  // first, a tile's chunks side by side. Each role works these out after
  // its setmaxnreg, so that nothing stays live across it.
  auto place = [&](int& nc, int& k0, int& oc) {
    nc = (p.d + 255) / 256;
    k0 = pos.t / nc * kSplitBN;
    oc = pos.t % nc;
  };

  if (tid == 0) {
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
      int nc, k0, oc, it0, n;
      place(nc, k0, oc);
      split_query_tiles(p, k0, it0, n);
      const int bh = bb * p.h + hh, per = 2 * nc;
      for (int j = 0; j < n * per; ++j) {
        const int s = j % S, x = j % per, q0 = (it0 + j / per) * BQ;
        const int c = (oc + 1 + x / 2) % nc;
        const bool last = x == per - 1;
        sm90::mbar_wait(&empty[s], ((j / S) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&full[s],
                                    L::kSlot + (last ? 2 * BQ * 4 : 0));
        uint8_t* st = smem + s * L::kSlot;
        const CUtensorMap* keys = x & 1 ? &p.v : &p.k;
        const CUtensorMap* queries = x & 1 ? &p.dout : &p.q;
#pragma unroll
        for (int b4 = 0; b4 < 4; ++b4) {
          sm90::tma_load_4d(st + b4 * kSplitBox, keys, &full[s],
                            256 * c + 64 * b4, k0, hh, bb);
          sm90::tma_load_4d(st + L::kTile + b4 * kSplitBox, queries,
                            &full[s], 256 * c + 64 * b4, q0, hh, bb);
        }
        if (last) {
          uint8_t* lc = smem + L::kLc + s * 2 * BQ * 4;
          sm90::tma_load_2d(lc, &p.lse, &full[s], q0, bh);
          sm90::tma_load_2d(lc + BQ * 4, &p.c, &full[s], q0, bh);
        }
      }
    }
  } else {
    // Consumer warpgroup w: features 256 oc + [128 w, 128 w + 128) of dK
    // and dV for the block's 64 keys; queries [32 w, 32 w + 32) of each
    // tile's S^T and dP^T.
    sm90::reg_alloc<kConsumerRegs>();
    int nc, k0, oc, it0, n;
    place(nc, k0, oc);
    split_query_tiles(p, k0, it0, n);
    const int w = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    const int r0 = 16 * warp + lane / 4;  // key rows r0, r0 + 8 of the block
    const int qb = 32 * w + 2 * (lane % 4);

    float dk[64], dv[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;
    const float sl2 = p.scale * kLog2e;
    float st[16], dpt[16];  // S^T, dP^T; then P^T, dS^T in f32
    int j = 0;              // the next item of the ring
    auto slot = [&](int jj) { return smem + (jj % S) * L::kSlot; };

    for (int i = 0; i < n; ++i) {
      for (int ci = 0; ci < nc; ++ci, j += 2) {
        // S^T += K_c Q_c^T, then dP^T += V_c dO_c^T, 64 keys x this
        // warpgroup's 32 queries; the tile's first pair overwrites
        const uint8_t* ks = slot(j);
        const uint8_t* vs = slot(j + 1);
        const int qo = L::kTile + w * 32 * 128;
        sm90::mbar_wait(&full[j % S], (j / S) & 1);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 16; ++kk) {
          const int off = (kk / 4) * kSplitBox + (kk % 4) * 32;
          sm90::Wgmma<32, E>::ss(st, sm90::desc_k(ks + off),
                                 sm90::desc_k(ks + qo + off), (ci | kk) > 0);
        }
        sm90::wgmma_commit();
        // dV and dK of the tile before are done (at its first pair; else
        // nothing older is in flight): its Q_oc and dO_oc go back, which
        // frees the slot the (V_c, dO_c) pair loads into
        sm90::wgmma_wait<1>();
        sm90::fence_regs(dv);
        sm90::fence_regs(dk);
        if (ci == 0 && i > 0) {
          sm90::mbar_arrive(&empty[(j - 2) % S]);
          sm90::mbar_arrive(&empty[(j - 1) % S]);
        }
        sm90::mbar_wait(&full[(j + 1) % S], ((j + 1) / S) & 1);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 16; ++kk) {
          const int off = (kk / 4) * kSplitBox + (kk % 4) * 32;
          sm90::Wgmma<32, E>::ss(dpt, sm90::desc_k(vs + off),
                                 sm90::desc_k(vs + qo + off), (ci | kk) > 0);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(st);
        sm90::fence_regs(dpt);
        if (ci + 1 < nc) {
          sm90::mbar_arrive(&empty[j % S]);
          sm90::mbar_arrive(&empty[(j + 1) % S]);
        }
      }
      const float* lse_s = reinterpret_cast<const float*>(
          smem + L::kLc + ((j - 1) % S) * 2 * BQ * 4);
      split_grads(p, st, dpt, lse_s, lse_s + BQ, (it0 + i) * BQ, k0, r0, qb,
                  sl2);
      uint8_t* ps = smem + L::kPds + (i & 1) * 2 * kSplitBox;
      split_store_pds<E>(ps, st, dpt, r0, qb);
      // dV += P^T dO_oc, dK += dS^T Q_oc (issued, not waited)
      split_issue_dkv<E>(dv, dk, ps,
                         slot(j - 2) + L::kTile + 2 * w * kSplitBox,
                         slot(j - 1) + L::kTile + 2 * w * kSplitBox);
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dv);
    sm90::fence_regs(dk);
    if (n > 0) {
      sm90::mbar_arrive(&empty[(j - 2) % S]);
      sm90::mbar_arrive(&empty[(j - 1) % S]);
    }
    split_store_rows<E>(p, dk, dv, bb, hh, k0 + r0, 256 * oc + 128 * w);
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
// barrier of tile i - 1. Past d = 256 the same block, in chunks of 256
// features (flash_bwd_dq_chunked_kernel, below), shares the pieces that
// follow.
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

// The pieces the split dq kernel and the chunked one (below) share. A
// consumer thread holds query rows r0 and r0 + 8 of the block's 64, and
// keys kb + 8 j and kb + 8 j + 1 (j < 4) of its warpgroup's 32 of a key
// tile (kb = 32 w + 2 (lane % 4)).

// lse (in log2 units) and c of the thread's rows of the block from q0.
__device__ __forceinline__ void dq_row_stats(const DqParams& p, long long bh,
                                             int q0, int r0,
                                             float (&lse2)[2],
                                             float (&cr)[2]) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    lse2[hr] = safe_lse(p, bh, q0 + r0 + 8 * hr) * kLog2e;
    cr[hr] = row_c(p, bh, q0 + r0 + 8 * hr);
  }
}

// P = exp2(S scale log2e - lse log2e) and dS = P (dP - c) of the key tile
// from k0 for the block's queries from q0, into dp. Only diagonal and
// ragged tiles are masked: TMA's zero fill past Sk scores 0, not -inf, so
// keys at or past Sk are masked here, as are (causal) keys in the query's
// future. Rows past Sq take lse = 1e30 (p = 0) and are never written.
__device__ __forceinline__ void dq_split_grads(const DqParams& p,
                                               const float (&s)[16],
                                               float (&dp)[16],
                                               const float (&lse2)[2],
                                               const float (&cr)[2], int q0,
                                               int k0, int r0, int kb,
                                               float sl2) {
  bool live = true, diag = false;
  if (p.causal)
    causal_liveness<kDqSplitBM, kDqBN>(p.q_offset + q0, p.kv_offset + k0,
                                       live, diag);
  const bool masked = diag || k0 + kDqBN > p.sk;
  // In a masked tile, relative to this thread's first query and key: keys
  // at or past Sk, and (causal) keys in the query's future, kv_offset + key
  // > q_offset + row, i.e. key - row above `ahead` (the offsets' gap at the
  // thread's first pair, clamped to an int; without causal it is above
  // every key - row).
  int key_end = 0, ahead = 0;
  if (masked) {
    key_end = p.sk - k0 - kb;
    const long long gap = p.causal ? p.q_offset - p.kv_offset + q0 + r0 -
                                         k0 - kb
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
}

// This warpgroup's keys of dS, rounded to E, into the shared tile at ds
// (queries as rows, the 128-byte swizzled K-major layout); then the
// barrier after which both warpgroups' halves are there for the async
// proxy.
template <class E>
__device__ __forceinline__ void dq_store_ds(uint8_t* ds, const float (&dp)[16],
                                            int r0, int kb) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // rows r0 and r0 + 8 (8 rows = 1024 bytes further, the same swizzle)
    uint8_t* at = ds + sm90::sw128_offset(r0, kb + 8 * j);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      *reinterpret_cast<uint32_t*>(at + hr * 1024) =
          sm90::pack<E>(dp[4 * j + 2 * hr], dp[4 * j + 2 * hr + 1]);
  }
  sm90::fence_proxy_async();
  sm90::bar_sync(1, kConsumers);
}

// dQ += dS K over this warpgroup's 128 features: dS K-major from its
// shared tile, K MN-major (its keys run down the rows) from a streamed
// tile the S product read K-major, ks at the warpgroup's first feature
// box (issued and committed, not waited).
template <class E>
__device__ __forceinline__ void dq_issue_dq(float (&dq)[64],
                                            const uint8_t* ds,
                                            const uint8_t* ks) {
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kDqBN / 16; ++kk)
    sm90::Wgmma<128, E>::ss_mn(dq, sm90::desc_k(ds + kk * 32),
                               sm90::desc_mn(ks + kk * 16 * 128, 64 * 128),
                               1);
  sm90::wgmma_commit();
}

// Rows `row` and row + 8 of dQ (every row below Sq: 0 where no live key
// reaches it), this thread's columns of the warpgroup's 128 from f0 below
// d.
template <class E>
__device__ __forceinline__ void dq_store_rows(const DqParams& p,
                                              const float (&dq)[64], int bb,
                                              int hh, int row, int f0) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr, row += 8) {
    if (row >= p.sq) continue;
    typename E::T* dqp = static_cast<typename E::T*>(p.dq) +
                         static_cast<long long>(bb) * p.s1b +
                         static_cast<long long>(hh) * p.s1h +
                         static_cast<long long>(row) * p.s1s;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = f0 + 8 * j;
      if (col >= p.d) continue;
      *reinterpret_cast<typename E::T2*>(dqp + col + 2 * t) =
          E::pack2(dq[4 * j + 2 * hr] * p.scale,
                   dq[4 * j + 2 * hr + 1] * p.scale);
    }
  }
}

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

  const sm90::GridPos pos = sm90::tile_major(p.fold);
  const int hh = pos.h, bb = pos.b;
  const int tid = threadIdx.x;
  // The block's first query (high query tiles, which see the most keys
  // under the causal mask, launch first) and the key tiles [0, n) it runs
  // over. Each role works them out after its setmaxnreg, so that nothing
  // stays live across it.
  auto tiles = [&](int& q0, int& n) {
    q0 = (p.fold.tiles.d - 1 - pos.t) * kDqSplitBM;
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
    dq_row_stats(p, bh, q0, r0, lse2, cr);
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
    auto grads = [&](int i) {
      dq_split_grads(p, s, dp, lse2, cr, q0, i * BN, r0, kb, sl2);
    };
    auto store_ds = [&](int i) {
      dq_store_ds<E>(smem + L::kDs + (i & 1) * L::kBox, dp, r0, kb);
    };
    auto issue_dq = [&](int i) {
      dq_issue_dq<E>(dq, smem + L::kDs + (i & 1) * L::kBox,
                     stage(i) + 2 * w * L::kBox);
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

    dq_store_rows<E>(p, dq, bb, hh, q0 + r0, 128 * w);
  }
}

// dq at d > 256: the split dq kernel's block in nc = ceil(d / 256) chunks
// of 256 features, as flash_bwd_dkv_chunked_kernel carries the split dk/dv
// kernel. One block per (64 queries, chunk oc of dQ's columns, head,
// batch), the chunk index folded into the query-tile index; warpgroup
// w owns features 256 oc + [128 w, 128 w + 128) of dQ (64 registers a
// thread), as in the split kernel. Nothing is resident: for each live
// 64-key tile the producer streams, through the dk/dv kernel's ring of
// three 64 KB slots, the pairs (Q_c, K_c) and (dO_c, V_c) of every chunk c
// (each 64 rows x 256 features), in the order oc + 1, ..., nc - 1, 0, ...,
// oc. Each consumer sums S = Q K^T over the (Q_c, K_c) pairs and dP = dO
// V^T over the (dO_c, V_c) pairs for its 32 keys (wgmma m64n32 SS), forms
// P and dS once as the split kernel does, and multiplies dS into dQ by
// K_oc, which the tile's last (Q, K) slot still holds (handed back once dQ
// is done, after the next tile's first S product is issued, while that
// tile's first pair has already landed in a free slot). Every other slot
// goes back as soon as its product is done. lse and c are the block's own
// rows, read once into registers. A block forms S and dP over all d and
// dQ over its 256 columns: at d 512, 2 (2 x 512) + 2 x 256 = 2560
// feature-products a (query, key) pair over the two blocks, against the
// minimal 1536. Each chunk's block sums S in its own chunk order, so P
// differs between them by f32 rounding; each dQ column is written by one
// block, so the result is the same bits from launch to launch.
//
// Shared memory, from a 1024-byte aligned base: the slots (a pair of 64-row
// chunk tiles, four boxes each), two dS buffers, then the barriers.
struct DqChunkSmem {
  static constexpr int kBox = 64 * 128;
  static constexpr int kTile = 4 * kBox;
  static constexpr int kSlot = 2 * kTile;
  static constexpr int kDs = kChunkSlots * kSlot;
  static constexpr int kBar = kDs + 2 * kBox;
  static constexpr int kBytes = kBar + 2 * kChunkSlots * 8 + 1024;
  static_assert(kBytes <= 232448, "shared memory of one H100 block");
};

template <class E>
__global__ void __launch_bounds__(kBlockThreads, 1)
    flash_bwd_dq_chunked_kernel(const __grid_constant__ DqParams p) {
  using L = DqChunkSmem;
  constexpr int BN = kDqBN, S = kChunkSlots;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sm90::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* empty = full + S;

  const sm90::GridPos pos = sm90::tile_major(p.fold);
  const int hh = pos.h, bb = pos.b;
  const int tid = threadIdx.x;
  // The block's queries and chunk of dQ (high query tiles, which see the
  // most keys under the causal mask, first; a tile's chunks side by side)
  // and the key tiles [0, n) it runs over. Each role works these out after
  // its setmaxnreg, so that nothing stays live across it.
  auto place = [&](int& nc, int& q0, int& oc, int& n) {
    nc = (p.d + 255) / 256;
    const int z = pos.t;
    q0 = (p.fold.tiles.d / nc - 1 - z / nc) * kDqSplitBM;
    oc = z % nc;
    n = dq_key_tiles(p, p.q_offset + q0,
                     p.sq - q0 < kDqSplitBM ? p.sq - q0 : kDqSplitBM);
  };

  if (tid == 0) {
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
      int nc, q0, oc, n;
      place(nc, q0, oc, n);
      const int per = 2 * nc;
      for (int j = 0; j < n * per; ++j) {
        const int s = j % S, x = j % per, k0 = j / per * BN;
        const int c = (oc + 1 + x / 2) % nc;
        sm90::mbar_wait(&empty[s], ((j / S) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&full[s], L::kSlot);
        uint8_t* st = smem + s * L::kSlot;
        const CUtensorMap* queries = x & 1 ? &p.dout : &p.q;
        const CUtensorMap* keys = x & 1 ? &p.v : &p.k;
#pragma unroll
        for (int b4 = 0; b4 < 4; ++b4) {
          sm90::tma_load_4d(st + b4 * L::kBox, queries, &full[s],
                            256 * c + 64 * b4, q0, hh, bb);
          sm90::tma_load_4d(st + L::kTile + b4 * L::kBox, keys, &full[s],
                            256 * c + 64 * b4, k0, hh, bb);
        }
      }
    }
  } else {
    // Consumer warpgroup w: features 256 oc + [128 w, 128 w + 128) of dQ
    // for the block's 64 queries; keys [32 w, 32 w + 32) of each tile's S
    // and dP.
    sm90::reg_alloc<kConsumerRegs>();
    int nc, q0, oc, n;
    place(nc, q0, oc, n);
    const int w = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    const int r0 = 16 * warp + lane / 4;  // query rows r0, r0 + 8 of the block
    // keys kb + 8 j and kb + 8 j + 1 of a tile's S accumulators
    const int kb = 32 * w + 2 * (lane % 4);
    const long long bh = static_cast<long long>(bb) * p.h + hh;

    float lse2[2], cr[2];  // per row: lse in log2 units, c
    dq_row_stats(p, bh, q0, r0, lse2, cr);
    float dq[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dq[i] = 0.f;
    const float sl2 = p.scale * kLog2e;
    float s[16], dp[16];  // S, dP; then dS in dp
    int j = 0;            // the next item of the ring
    auto slot = [&](int jj) { return smem + (jj % S) * L::kSlot; };

    for (int i = 0; i < n; ++i) {
      for (int ci = 0; ci < nc; ++ci, j += 2) {
        // S += Q_c K_c^T, then dP += dO_c V_c^T, the block's 64 queries x
        // this warpgroup's 32 keys; the tile's first pair overwrites
        const uint8_t* qk = slot(j);
        const uint8_t* dov = slot(j + 1);
        const int ko = L::kTile + w * 32 * 128;
        sm90::mbar_wait(&full[j % S], (j / S) & 1);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 16; ++kk) {
          const int off = (kk / 4) * L::kBox + (kk % 4) * 32;
          sm90::Wgmma<32, E>::ss(s, sm90::desc_k(qk + off),
                                 sm90::desc_k(qk + ko + off), (ci | kk) > 0);
        }
        sm90::wgmma_commit();
        // dQ of the tile before is done (at its first pair; else nothing
        // older is in flight): its K_oc goes back, which frees the slot
        // the (dO_c, V_c) pair loads into
        sm90::wgmma_wait<1>();
        sm90::fence_regs(dq);
        if (ci == 0 && i > 0) sm90::mbar_arrive(&empty[(j - 2) % S]);
        sm90::mbar_wait(&full[(j + 1) % S], ((j + 1) / S) & 1);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 16; ++kk) {
          const int off = (kk / 4) * L::kBox + (kk % 4) * 32;
          sm90::Wgmma<32, E>::ss(dp, sm90::desc_k(dov + off),
                                 sm90::desc_k(dov + ko + off), (ci | kk) > 0);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(s);
        sm90::fence_regs(dp);
        sm90::mbar_arrive(&empty[(j + 1) % S]);
        if (ci + 1 < nc) sm90::mbar_arrive(&empty[j % S]);
      }
      dq_split_grads(p, s, dp, lse2, cr, q0, i * BN, r0, kb, sl2);
      uint8_t* ds = smem + L::kDs + (i & 1) * L::kBox;
      dq_store_ds<E>(ds, dp, r0, kb);
      // dQ += dS K_oc (issued, not waited)
      dq_issue_dq<E>(dq, ds, slot(j - 2) + L::kTile + 2 * w * L::kBox);
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dq);
    if (n > 0) sm90::mbar_arrive(&empty[(j - 2) % S]);
    dq_store_rows<E>(p, dq, bb, hh, q0 + r0, 256 * oc + 128 * w);
  }
}

// ---------------------------------------------------------------------------
// f32: 3xTF32 wgmma + TMA, the features in chunks of 32 (dq and dk/dv)
//
// Every f32 product x y runs as three TF32 products on the tensor cores,
// x_hi y_hi + x_hi y_lo + x_lo y_hi, with x_hi = rna_tf32(x) and x_lo =
// rna_tf32(x - x_hi) (CUTLASS's "3xTF32"): about 2^-21 relative a product,
// summed in f32 (but dq's dP, exact products summed in f64 on the FP64
// tensor cores: dq_dp_chunk). A block is three warpgroups, as the 16-bit
// kernels': two consumers and a producer whose warp 0 starts every TMA
// load (one thread) and whose warps 1-3 split each landed tile: hi over
// the raw tile in place, lo into a tile of the same layout, and, for the
// operand whose contracted dim runs down its rows, both parts transposed
// (tf32 wgmma reads both operands K-major only). Nothing is resident: each
// streamed tile comes as a run of items through a ring of stages of six
// or eight 64-row x 32 float tiles (8 KB each, one 128-byte swizzle box):
// first one item per 32 feature chunk of all d (S and dP, or S^T and
// dP^T, summed over them), then one item per 32 feature chunk of the
// block's output columns (the transposed operand of dQ, or of dK and dV).
// So shared memory does not grow with d; the output accumulators do (D / 2
// floats a thread; at D = 256 dq keeps three of its eight chunks in shared
// memory), and past d = 256 a block owns a chunk of 256 output columns and
// forms S again.

constexpr int kTfConverters = 96;  // warps 1-3 of the producer warpgroup
// setmaxnreg within the launch's 3 x 168: the converters need more than
// the TMA thread's 24.
constexpr int kTfProducerRegs = 56;
constexpr int kTfConsumerRegs = 224;
constexpr int kTfTile = 8192;  // 64 rows x 32 floats

struct Tf32Params {
  CUtensorMap q, dout, k, v;  // boxes of 32 features x 64 (or BQ) rows
  const float* lse;           // (B*H, Sq), contiguous
  const float* c;             // (B*H, Sq), contiguous
  void* o1;                   // dq (dq kernel) or dk (dk/dv kernel)
  void* o2;                   // dv (dk/dv kernel)
  long long s1b, s1h, s1s;
  long long s2b, s2h, s2s;
  int h, sq, sk;
  int d;  // true head dim: columns past it are zero-filled and not stored
  int causal;
  long long q_offset, kv_offset;
  float scale;
  sm90::Fold fold;  // the grid's blocks on x (sm90::GridPos)
};

// Splits a landed tile of `rows` rows in place: hi over it, lo into `lo`
// at the same offsets (so in the same swizzled layout).
__device__ __forceinline__ void tf32_split(uint8_t* t, uint8_t* lo, int rows,
                                           int ct) {
  for (int ch = ct; ch < rows * 8; ch += kTfConverters) {
    const float4 x = *reinterpret_cast<const float4*>(t + 16 * ch);
    float4 h, l;
    h.x = sm90::tf32_rna(x.x);
    h.y = sm90::tf32_rna(x.y);
    h.z = sm90::tf32_rna(x.z);
    h.w = sm90::tf32_rna(x.w);
    l.x = sm90::tf32_rna(x.x - h.x);
    l.y = sm90::tf32_rna(x.y - h.y);
    l.z = sm90::tf32_rna(x.z - h.z);
    l.w = sm90::tf32_rna(x.w - h.w);
    *reinterpret_cast<float4*>(t + 16 * ch) = h;
    *reinterpret_cast<float4*>(lo + 16 * ch) = l;
  }
}

__device__ __forceinline__ float lane_of(const float4& x, int c) {
  return c == 0 ? x.x : c == 1 ? x.y : c == 2 ? x.z : x.w;
}

// Splits a landed tile of `rows` rows x 32 features into hi and lo tiles of
// 32 feature rows x `rows` columns (boxes of 32 columns, kTfBox apart),
// each group of 8 columns in tf32_kpos order. A unit of work is rows 8 a +
// 2 i + e (i = 0..3) of four features: tf32_kpos puts those rows in four
// adjacent columns, so each feature's four values are one 16-byte store.
__device__ __forceinline__ void tf32_split_t(const uint8_t* t, uint8_t* hi,
                                             uint8_t* lo, int rows, int ct) {
  for (int u = ct; u < rows * 2; u += kTfConverters) {
    const int fq = u & 7, e = (u >> 3) & 1, r0 = 8 * (u >> 4) + e;
    const int pos = sm90::tf32_kpos(r0);  // rows r0 + 2 i land at pos + i
    float4 x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + 2 * i;
      x[i] = *reinterpret_cast<const float4*>(t + r * 128 +
                                              ((fq ^ (r & 7)) << 4));
    }
    const int box = (pos >> 5) * sm90::kTfBox;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int f = 4 * fq + c;
      const float v[4] = {lane_of(x[0], c), lane_of(x[1], c),
                          lane_of(x[2], c), lane_of(x[3], c)};
      float4 h, l;
      h.x = sm90::tf32_rna(v[0]);
      h.y = sm90::tf32_rna(v[1]);
      h.z = sm90::tf32_rna(v[2]);
      h.w = sm90::tf32_rna(v[3]);
      l.x = sm90::tf32_rna(v[0] - h.x);
      l.y = sm90::tf32_rna(v[1] - h.y);
      l.z = sm90::tf32_rna(v[2] - h.z);
      l.w = sm90::tf32_rna(v[3] - h.w);
      const uint32_t off = box + sm90::sw128_f32_offset(f, pos & 31);
      *reinterpret_cast<float4*>(hi + off) = h;
      *reinterpret_cast<float4*>(lo + off) = l;
    }
  }
}

// dP += dO V^T over one 32-feature chunk on the FP64 tensor cores, for the
// dq kernel, into the m64n32 accumulator layout of a warpgroup's 32 keys
// (kb, the first of them in the tile; dp[j] the n-tile of keys kb + 8 j..)
// and this thread's rows ra, ra + 8 (ra % 8 = g). Each f32 value of the
// chunk's raw (swizzled) tiles is converted to f64 as it is loaded
// (exactly), and k-step (h, kk) gives slot t of the k4 step feature 8 t +
// 4 h + kk: thread t reads the 16-byte chunk 2 t + h of its dO rows and V
// keys, so the eight lanes of a quarter warp (g = 2 i, 2 i + 1, t = 0..3)
// hit eight distinct chunks under the 128-byte swizzle (no bank
// conflict). A row of dQ with one live key is p (dP - c) k with dP equal
// to c up to rounding (the first query's, with no lse cotangent): from an
// f32 dP that row would be the dot product's rounding alone, so dP is
// formed exactly here and dP - c rounded once, as the plain version forms
// it.
__device__ __forceinline__ void dq_dp_chunk(double (&dp)[4][4],
                                            const uint8_t* dos,
                                            const uint8_t* vs, int ra, int kb,
                                            int g, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t sw = ((2 * t + h) ^ g) << 4;  // rows ra, ra + 8, keys
    const float4 a0 = *reinterpret_cast<const float4*>(dos + ra * 128 + sw);
    const float4 a1 =
        *reinterpret_cast<const float4*>(dos + (ra + 8) * 128 + sw);
    float4 b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(vs + (kb + 8 * j + g) * 128 +
                                              sw);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const double x0 = lane_of(a0, kk), x1 = lane_of(a1, kk);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sm90::dmma_m16n8k4(dp[j], x0, x1, lane_of(b[j], kk));
    }
  }
}

// The shared memory of both kernels: a ring of STAGES stages of TILES
// tiles, then (dk/dv) two exchange buffers of XBYTES, then the barriers.
template <int STAGES, int TILES, int XBYTES>
struct TfSmem {
  static constexpr int kStages = STAGES;
  static constexpr int kStageBytes = TILES * kTfTile;
  static constexpr int kX = STAGES * kStageBytes;
  static constexpr int kBar = kX + 2 * XBYTES;
  static constexpr int kBytes = kBar + (3 * STAGES + 4) * 8 + 1024;
  static_assert(kBytes <= 232448, "over the H100's shared memory a block");
};

// How many of the dq kernel's last chunks of 32 dQ columns each consumer
// thread sums in shared memory rather than in registers (16 floats a
// chunk, kConsumers apart; once per key tile and chunk), and its ring's
// stages. At D = 256 dQ's 128 registers beside dP's 32 in f64 spilled,
// and so did they with one or two chunks in shared memory; three need a
// stage of the ring (48 KB) for their 48 KB.
template <int D>
constexpr int kDqSmemChunks = D == 256 ? 3 : 0;
template <int D>
constexpr int kDqStages = D == 256 ? 3 : 4;

// dq: 6 tiles a stage (dO and V stay raw), kDqStages stages, then dQ's
// chunks of kDqSmemChunks (16 KB each); dk/dv: 8 tiles a stage and the
// exchange buffers of P^T, so 3.
template <int D>
using TfDqSmem = TfSmem<kDqStages<D>, 6, kDqSmemChunks<D> * 8192>;
template <int BQ>
using TfDkvSmem = TfSmem<3, 8, 64 * BQ * 4>;

// The producer warpgroup of both kernels: warp 0's first thread issues the
// loads of every item (load(j, stage, full barrier)) as their stages free
// up, warps 1-3 split each landed item (convert(j, stage)) and mark it
// ready. (All four warps splitting, with the loads issued between splits,
// ran slower: the ring then waits on the splits to be refilled.)
template <class L, class Load, class Convert>
__device__ __forceinline__ void tf32_producer(int items, uint64_t* full,
                                              uint64_t* ready,
                                              uint64_t* empty, uint8_t* smem,
                                              Load load, Convert convert) {
  sm90::reg_dealloc<kTfProducerRegs>();
  const int pt = threadIdx.x - kConsumers;
  if (pt == 0) {
    for (int j = 0; j < items; ++j) {
      const int s = j % L::kStages;
      sm90::mbar_wait(&empty[s], ((j / L::kStages) & 1) ^ 1);
      load(j, smem + s * L::kStageBytes, &full[s]);
    }
  } else if (pt >= 32) {
    for (int j = 0; j < items; ++j) {
      const int s = j % L::kStages;
      sm90::mbar_wait(&full[s], (j / L::kStages) & 1);
      convert(j, smem + s * L::kStageBytes, pt - 32);
      sm90::fence_proxy_async();
      sm90::mbar_arrive(&ready[s]);
    }
  }
}

template <int STAGES>
__device__ __forceinline__ void tf32_init_barriers(uint64_t* bar) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&bar[s], 1);                         // full
      sm90::mbar_init(&bar[STAGES + s], kTfConverters);    // ready
      sm90::mbar_init(&bar[2 * STAGES + s], kConsumers);   // empty
    }
    for (int i = 0; i < 4; ++i)  // the dk/dv kernel's exchange
      sm90::mbar_init(&bar[3 * STAGES + i], 128);
    sm90::fence_barrier_init();
  }
  __syncthreads();
}

// dq: one block per (64 queries, chunk of D columns of dQ, head, batch).
// Both consumer warpgroups own the block's 64 query rows and split each
// 64-key tile: warpgroup w takes keys [32 w, 32 w + 32), forms its S
// (m64n32 on the tensor cores, summed over the feature chunks) and, after
// each chunk's S, its dP on the FP64 tensor cores (dq_dp_chunk), then P
// and dS on the accumulators, and adds dS K into its own dQ (the
// transposed K chunk, m64n32 a chunk of dQ's columns). At the end
// warpgroup 1 hands its dQ to warpgroup 0 through shared memory, which
// adds it and stores (a fixed order: bit-identical from launch to
// launch). Item order per key tile:
// nc items {Q, dO, K, V} of feature chunk c (tiles 0, 1: Q hi, lo; 2: dO
// raw; 3, 4: K hi, lo; 5: V raw), then no items {K} of output chunk o
// (tile 0 raw, tiles 1, 2 K^T hi, lo, 64 keys in two boxes).
template <int D>
__global__ void __launch_bounds__(kBlockThreads, 1)
    flash_bwd_dq_tf32_kernel(const __grid_constant__ Tf32Params p) {
  using L = TfDqSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sm90::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* ready = full + L::kStages;
  uint64_t* empty = ready + L::kStages;

  const sm90::GridPos pos = sm90::head_major(p.fold);
  const int nco = (p.d + D - 1) / D;
  const int tiles = p.fold.tiles.d / nco;
  const int q0 = (tiles - 1 - pos.t / nco) * 64;
  const int f0 = pos.t % nco * D;  // this block's columns of dQ
  const int hh = pos.h, bb = pos.b;
  const int nc = (p.d + 31) / 32;
  const int no = ((p.d - f0 < D ? p.d - f0 : D) + 31) / 32;
  // key tiles [0, n): all, or (causal) up to the last one a row sees
  int n = (p.sk + 63) / 64;
  if (p.causal) {
    const int rows = p.sq - q0 < 64 ? p.sq - q0 : 64;
    const long long x = p.q_offset + q0 + rows - 1 - p.kv_offset;
    n = x < 0 ? 0 : static_cast<int>(x / 64 + 1 < n ? x / 64 + 1 : n);
  }
  const int per = nc + no;
  tf32_init_barriers<L::kStages>(full);

  if (threadIdx.x >= kConsumers) {
    auto load = [&](int j, uint8_t* st, uint64_t* bar) {
      const int i = j / per, c = j % per;
      if (c < nc) {
        sm90::mbar_arrive_expect_tx(bar, 4 * kTfTile);
        sm90::tma_load_4d(st, &p.q, bar, 32 * c, q0, hh, bb);
        sm90::tma_load_4d(st + 2 * kTfTile, &p.dout, bar, 32 * c, q0, hh,
                          bb);
        sm90::tma_load_4d(st + 3 * kTfTile, &p.k, bar, 32 * c, 64 * i, hh,
                          bb);
        sm90::tma_load_4d(st + 5 * kTfTile, &p.v, bar, 32 * c, 64 * i, hh,
                          bb);
      } else {
        sm90::mbar_arrive_expect_tx(bar, kTfTile);
        sm90::tma_load_4d(st, &p.k, bar, f0 + 32 * (c - nc), 64 * i, hh, bb);
      }
    };
    auto convert = [&](int j, uint8_t* st, int ct) {
      if (j % per < nc) {
        tf32_split(st, st + kTfTile, 64, ct);
        tf32_split(st + 3 * kTfTile, st + 4 * kTfTile, 64, ct);
      } else {
        tf32_split_t(st, st + kTfTile, st + 2 * kTfTile, 64, ct);
      }
    };
    tf32_producer<L>(n * per, full, ready, empty, smem, load, convert);
  } else {
    sm90::reg_alloc<kTfConsumerRegs>();
    const int w = threadIdx.x / 128, lt = threadIdx.x % 128;
    const int warp = lt / 32, g = (lt % 32) / 4, t = lt % 4;
    const int r0 = q0 + 16 * warp + g;  // query rows r0 and r0 + 8
    const long long bh = static_cast<long long>(bb) * p.h + hh;
    const float sl2 = p.scale * kLog2e;
    // dQ's chunks o < kR in registers, the rest in shared memory: element
    // i of chunk kR + m at dqx[(16 m + i) * kConsumers]
    constexpr int kR = D / 32 - kDqSmemChunks<D>;
    float dq[D / 32][16];
    float* dqx = reinterpret_cast<float*>(smem + L::kX) + threadIdx.x;
#pragma unroll
    for (int o = 0; o < D / 32; ++o)
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        if (o < kR)
          dq[o][i] = 0.f;
        else
          dqx[(16 * (o - kR) + i) * kConsumers] = 0.f;
      }
    float s[16];      // S of a key tile, then dS
    double dp[4][4];  // dP of a key tile, exact products summed in f64
    float cs[16];     // a chunk's S; a chunk of dS K

    int j = 0;
    auto wait_ready = [&](int jj) {
      sm90::mbar_wait(&ready[jj % L::kStages], (jj / L::kStages) & 1);
      return smem + (jj % L::kStages) * L::kStageBytes;
    };
    for (int i = 0; i < n; ++i) {
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        s[x] = 0.f;
        dp[x / 4][x % 4] = 0.0;
      }
      for (int c = 0; c < nc; ++c, ++j) {
        const uint8_t* st = wait_ready(j);
        const int kb = w * 32 * 128;  // this warpgroup's 32 keys
        sm90::wgmma_fence();
        sm90::tf32_ss_chunk<32>(cs, st, st + kTfTile,
                                st + 3 * kTfTile + kb,
                                st + 4 * kTfTile + kb);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(cs);
        sm90::tf32_add(s, cs);
        // dP once S is in (cs then free): the f64 mma.sync shares the
        // tensor cores with the S wgmma, and formed while that ran it made
        // the kernel slower
        dq_dp_chunk(dp, st + 2 * kTfTile, st + 5 * kTfTile, 16 * warp + g,
                    32 * w, g, t);
        sm90::mbar_arrive(&empty[j % L::kStages]);
      }
      // P = exp2(S scale log2e - lse log2e), dS = P (dP - c), dP - c
      // rounded to f32 once; masked only on tiles that straddle the
      // diagonal or run past Sk. (lse and c are read again each tile: no
      // registers held across the loop.)
      float lse2[2], cr[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        lse2[hr] = safe_lse(p, bh, r0 + 8 * hr) * kLog2e;
        cr[hr] = row_c(p, bh, r0 + 8 * hr);
      }
      const int k0 = 64 * i + 32 * w;
      const bool masked =
          k0 + 32 > p.sk ||
          (p.causal && p.kv_offset + k0 + 31 > p.q_offset + q0);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = fmaf(s[4 * jj + e], sl2, -lse2[e >> 1]);
          if (masked) {
            const int key = k0 + 8 * jj + 2 * t + (e & 1);
            const int row = r0 + 8 * (e >> 1);
            if (key >= p.sk ||
                (p.causal && p.kv_offset + key > p.q_offset + row))
              x = -INFINITY;
          }
          s[4 * jj + e] = sm90::exp2_approx(x) *
                          static_cast<float>(dp[jj][e] - cr[e >> 1]);
        }
      uint32_t fh[4][4], fl[4][4];
      sm90::tf32_frags(fh, fl, s);
#pragma unroll
      for (int o = 0; o < D / 32; ++o) {
        if (o < no) {
          const uint8_t* st = wait_ready(j);
          sm90::wgmma_fence();
          sm90::tf32_rs<4>(cs, fh, fl, st + kTfTile + w * sm90::kTfBox,
                           st + 2 * kTfTile + w * sm90::kTfBox);
          sm90::wgmma_commit();
          sm90::wgmma_wait<0>();
          sm90::fence_regs(cs);
          sm90::mbar_arrive(&empty[j % L::kStages]);
          if (o < kR) {
            sm90::tf32_add(dq[o], cs);
          } else {
#pragma unroll
            for (int x = 0; x < 16; ++x)
              dqx[(16 * (o - kR) + x) * kConsumers] += cs[x];
          }
          ++j;
        }
      }
    }

    // Warpgroup 1's dQ into the (now idle) ring, warpgroup 0 adds it in
    // (and, of the chunks in shared memory, warpgroup 1's slots beside its
    // own) and stores every row below Sq (0 where no live key reaches it).
    float* red = reinterpret_cast<float*>(smem);
    sm90::bar_sync(1, kConsumers);
    if (w == 1) {
#pragma unroll
      for (int o = 0; o < kR; ++o)
#pragma unroll
        for (int i = 0; i < 16; ++i) red[(16 * o + i) * 128 + lt] = dq[o][i];
    }
    sm90::bar_sync(1, kConsumers);
    if (w == 0) {
      float* dqp = static_cast<float*>(p.o1) +
                   static_cast<long long>(bb) * p.s1b +
                   static_cast<long long>(hh) * p.s1h;
#pragma unroll
      for (int o = 0; o < D / 32; ++o)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int col = f0 + 32 * o + 8 * jj;
          if (col >= p.d) continue;
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int row = r0 + 8 * hr;
            const int i = 4 * jj + 2 * hr;
            float x[2];
#pragma unroll
            for (int e = 0; e < 2; ++e)
              x[e] = o < kR ? dq[o][i + e] + red[(16 * o + i + e) * 128 + lt]
                            : dqx[(16 * (o - kR) + i + e) * kConsumers] +
                                  dqx[(16 * (o - kR) + i + e) * kConsumers +
                                      128];
            if (row < p.sq)
              *reinterpret_cast<float2*>(
                  dqp + static_cast<long long>(row) * p.s1s + col + 2 * t) =
                  make_float2(x[0] * p.scale, x[1] * p.scale);
          }
        }
    }
  }
}

// dk/dv: one block per (64 keys, chunk of D columns of dK and dV, head,
// batch); query tiles of BQ rows stream. The two consumer warpgroups own
// the block's 64 key rows and split the work by output: warpgroup 0 forms
// S^T = K Q^T and P^T (exp2 against each query's lse), hands P^T to
// warpgroup 1 through one of two exchange buffers, and adds P^T dO into
// dV; warpgroup 1 forms dP^T = V dO^T, dS^T = P^T (dP^T - c) and adds
// dS^T Q into dK. Item order per query tile: nc items {K, V, Q, dO} of
// feature chunk c (tiles 0-7: K hi, lo, V hi, lo, Q hi, lo, dO hi, lo),
// then no items {Q, dO} of output chunk o (tiles 0, 1 raw, tiles 2-5 Q^T
// hi, lo and dO^T hi, lo, BQ queries in boxes of 32).
template <int D, int BQ>
__global__ void __launch_bounds__(kBlockThreads, 1)
    flash_bwd_dkv_tf32_kernel(const __grid_constant__ Tf32Params p) {
  using L = TfDkvSmem<BQ>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sm90::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* ready = full + L::kStages;
  uint64_t* empty = ready + L::kStages;
  uint64_t* xfull = empty + L::kStages;  // two each
  uint64_t* xempty = xfull + 2;

  const sm90::GridPos pos = sm90::head_major(p.fold);
  const int nco = (p.d + D - 1) / D;
  const int k0 = pos.t / nco * 64;  // low keys first
  const int f0 = pos.t % nco * D;   // this block's columns of dK, dV
  const int hh = pos.h, bb = pos.b;
  const int nc = (p.d + 31) / 32;
  const int no = ((p.d - f0 < D ? p.d - f0 : D) + 31) / 32;
  // query tiles [it0, nq): (causal) from the first one that sees a key
  const int nq = (p.sq + BQ - 1) / BQ;
  int it0 = 0;
  if (p.causal) {
    const long long x = p.kv_offset + k0 - p.q_offset;
    it0 = x <= 0 ? 0 : static_cast<int>(x / BQ < nq ? x / BQ : nq);
  }
  const int per = nc + no;
  const int items = (nq - it0) * per;
  tf32_init_barriers<L::kStages>(full);

  if (threadIdx.x >= kConsumers) {
    auto load = [&](int j, uint8_t* st, uint64_t* bar) {
      const int q0 = (it0 + j / per) * BQ, c = j % per;
      if (c < nc) {
        sm90::mbar_arrive_expect_tx(bar, 2 * kTfTile + 2 * BQ * 128);
        sm90::tma_load_4d(st, &p.k, bar, 32 * c, k0, hh, bb);
        sm90::tma_load_4d(st + 2 * kTfTile, &p.v, bar, 32 * c, k0, hh, bb);
        sm90::tma_load_4d(st + 4 * kTfTile, &p.q, bar, 32 * c, q0, hh, bb);
        sm90::tma_load_4d(st + 6 * kTfTile, &p.dout, bar, 32 * c, q0, hh,
                          bb);
      } else {
        const int f = f0 + 32 * (c - nc);
        sm90::mbar_arrive_expect_tx(bar, 2 * BQ * 128);
        sm90::tma_load_4d(st, &p.q, bar, f, q0, hh, bb);
        sm90::tma_load_4d(st + kTfTile, &p.dout, bar, f, q0, hh, bb);
      }
    };
    auto convert = [&](int j, uint8_t* st, int ct) {
      if (j % per < nc) {
#pragma unroll 1
        for (int t = 0; t < 8; t += 2)
          tf32_split(st + t * kTfTile, st + (t + 1) * kTfTile,
                     t < 4 ? 64 : BQ, ct);
      } else {
        tf32_split_t(st, st + 2 * kTfTile, st + 3 * kTfTile, BQ, ct);
        tf32_split_t(st + kTfTile, st + 4 * kTfTile, st + 5 * kTfTile, BQ,
                     ct);
      }
    };
    tf32_producer<L>(items, full, ready, empty, smem, load, convert);
  } else {
    sm90::reg_alloc<kTfConsumerRegs>();
    const int w = threadIdx.x / 128, lt = threadIdx.x % 128;
    const int warp = lt / 32, g = (lt % 32) / 4, t = lt % 4;
    const int key0 = k0 + 16 * warp + g;  // key rows key0 and key0 + 8
    const long long bh = static_cast<long long>(bb) * p.h + hh;
    const float sl2 = p.scale * kLog2e;
    float acc[D / 32][16];  // dV (warpgroup 0) or dK (warpgroup 1)
#pragma unroll
    for (int o = 0; o < D / 32; ++o)
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[o][i] = 0.f;
    float a[BQ / 2], ca[BQ / 2];  // S^T (dP^T), then P^T (dS^T); a chunk's
    float cacc[16];               // a chunk of P^T dO (dS^T Q)
    float* xb = reinterpret_cast<float*>(smem + L::kX);

    int j = 0;
    auto wait_ready = [&](int jj) {
      sm90::mbar_wait(&ready[jj % L::kStages], (jj / L::kStages) & 1);
      return smem + (jj % L::kStages) * L::kStageBytes;
    };
    for (int it = it0; it < nq; ++it) {
      const int q0 = it * BQ;
      // lse (log2 units, warpgroup 0) or c (warpgroup 1) of this thread's
      // query columns 8 jj + 2 t + e, read while the products run
      float col[BQ / 4];
#pragma unroll
      for (int jj = 0; jj < BQ / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int q = q0 + 8 * jj + 2 * t + e;
          col[2 * jj + e] =
              w == 0 ? safe_lse(p, bh, q) * kLog2e : row_c(p, bh, q);
        }
#pragma unroll
      for (int x = 0; x < BQ / 2; ++x) a[x] = 0.f;
      for (int c = 0; c < nc; ++c, ++j) {
        const uint8_t* st = wait_ready(j);
        const int x = 2 * w * kTfTile;  // K (warpgroup 0) or V, and Q or dO
        sm90::wgmma_fence();
        sm90::tf32_ss_chunk<BQ>(ca, st + x, st + x + kTfTile,
                                st + 4 * kTfTile + x,
                                st + 5 * kTfTile + x);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(ca);
        sm90::mbar_arrive(&empty[j % L::kStages]);
        sm90::tf32_add(a, ca);
      }
      const int ti = it - it0, xi = ti & 1;
      float* xbuf = xb + xi * 64 * BQ;
      if (w == 0) {
        // P^T, masked only on tiles that straddle the diagonal or run past
        // Sq (keys past Sk are never stored)
        const bool masked =
            q0 + BQ > p.sq ||
            (p.causal && p.kv_offset + k0 + 63 > p.q_offset + q0);
#pragma unroll
        for (int jj = 0; jj < BQ / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = fmaf(a[4 * jj + e], sl2, -col[2 * jj + (e & 1)]);
            if (masked) {
              const int q = q0 + 8 * jj + 2 * t + (e & 1);
              const int key = key0 + 8 * (e >> 1);
              if (q >= p.sq ||
                  (p.causal && p.kv_offset + key > p.q_offset + q))
                x = -INFINITY;
            }
            a[4 * jj + e] = sm90::exp2_approx(x);
          }
        sm90::mbar_wait(&xempty[xi], ((ti >> 1) & 1) ^ 1);
#pragma unroll
        for (int i = 0; i < BQ / 2; ++i) xbuf[i * 128 + lt] = a[i];
        sm90::mbar_arrive(&xfull[xi]);
      } else {
        sm90::mbar_wait(&xfull[xi], (ti >> 1) & 1);
#pragma unroll
        for (int jj = 0; jj < BQ / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * jj + e;
            a[i] = xbuf[i * 128 + lt] * (a[i] - col[2 * jj + (e & 1)]);
          }
        sm90::mbar_arrive(&xempty[xi]);
      }
      uint32_t fh[BQ / 8][4], fl[BQ / 8][4];
      sm90::tf32_frags(fh, fl, a);
      // dV += P^T dO (warpgroup 0: dO^T, tiles 4, 5), dK += dS^T Q (1: Q^T,
      // tiles 2, 3)
      const int tb = (w == 0 ? 4 : 2) * kTfTile;
#pragma unroll
      for (int o = 0; o < D / 32; ++o) {
        if (o < no) {
          const uint8_t* st = wait_ready(j);
          sm90::wgmma_fence();
          sm90::tf32_rs<BQ / 8>(cacc, fh, fl, st + tb,
                                st + tb + kTfTile);
          sm90::wgmma_commit();
          sm90::wgmma_wait<0>();
          sm90::fence_regs(cacc);
          sm90::mbar_arrive(&empty[j % L::kStages]);
          sm90::tf32_add(acc[o], cacc);
          ++j;
        }
      }
    }

    // every key row below Sk, 0 where no live query reaches it
    float* out = static_cast<float*>(w == 0 ? p.o2 : p.o1) +
                 static_cast<long long>(bb) * (w == 0 ? p.s2b : p.s1b) +
                 static_cast<long long>(hh) * (w == 0 ? p.s2h : p.s1h);
    const long long rs = w == 0 ? p.s2s : p.s1s;
    const float sc = w == 0 ? 1.f : p.scale;
#pragma unroll
    for (int o = 0; o < D / 32; ++o)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int col = f0 + 32 * o + 8 * jj;
        if (col >= p.d) continue;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int key = key0 + 8 * hr;
          const int i = 4 * jj + 2 * hr;
          if (key < p.sk)
            *reinterpret_cast<float2*>(out + key * rs + col + 2 * t) =
                make_float2(acc[o][i] * sc, acc[o][i + 1] * sc);
        }
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
  const int nt = (a.sq + kDqBM - 1) / kDqBM;
  const unsigned blocks = sm90::folded_blocks(nt, b, a.h);
  if (blocks == 0) return sm90::kErrGrid;
  DqParams p;
  const int err = dq_params<E>(p, a, b, kDqBM, kDqBN);
  if (err) return err;
  p.fold = sm90::fold(nt, b, a.h);
  constexpr int bytes = DqSmem<D>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma_kernel<D, E>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(blocks);
  flash_bwd_dq_wgmma_kernel<D, E><<<grid, kBlockThreads, bytes, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <class E>
int launch_dq_chunked(const Args& a, int b, cudaStream_t st) {
  const int nc = (a.d + 255) / 256;
  const long long nt =
      static_cast<long long>((a.sq + kDqSplitBM - 1) / kDqSplitBM) * nc;
  const unsigned blocks = sm90::folded_blocks(nt, b, a.h);
  if (blocks == 0) return sm90::kErrGrid;
  DqParams p;
  const int err = dq_params<E>(p, a, b, kDqSplitBM, kDqBN);
  if (err) return err;
  p.fold = sm90::fold(nt, b, a.h);
  constexpr int bytes = DqChunkSmem::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_chunked_kernel<E>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(blocks);
  flash_bwd_dq_chunked_kernel<E><<<grid, kBlockThreads, bytes, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <class E>
int launch_dq_split(const Args& a, int b, cudaStream_t st) {
  const int nt = (a.sq + kDqSplitBM - 1) / kDqSplitBM;
  const unsigned blocks = sm90::folded_blocks(nt, b, a.h);
  if (blocks == 0) return sm90::kErrGrid;
  DqParams p;
  const int err = dq_params<E>(p, a, b, kDqSplitBM, kDqBN);
  if (err) return err;
  p.fold = sm90::fold(nt, b, a.h);
  constexpr int bytes = DqSplitSmem::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_split_kernel<E>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(blocks);
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
  const int nt = (a.sk + kDkvBN - 1) / kDkvBN;
  const unsigned blocks = sm90::folded_blocks(nt, b, a.h);
  if (blocks == 0) return sm90::kErrGrid;
  DkvParams p;
  const int err = dkv_params<E>(p, a, b, dkv_bq<D>(), kDkvBN);
  if (err) return err;
  p.fold = sm90::fold(nt, b, a.h);
  constexpr int bytes = DkvSmem<D>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_wgmma_kernel<D, E>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(blocks);
  flash_bwd_dkv_wgmma_kernel<D, E><<<grid, kBlockThreads, bytes, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <class E>
int launch_dkv_chunked(const Args& a, int b, cudaStream_t st) {
  const int nc = (a.d + 255) / 256;
  const long long nt =
      static_cast<long long>((a.sk + kSplitBN - 1) / kSplitBN) * nc;
  const unsigned blocks = sm90::folded_blocks(nt, b, a.h);
  if (blocks == 0) return sm90::kErrGrid;
  DkvParams p;
  const int err = dkv_params<E>(p, a, b, kSplitBQ, kSplitBN);
  if (err) return err;
  p.fold = sm90::fold(nt, b, a.h);
  constexpr int bytes = DkvChunkSmem::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_chunked_kernel<E>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(blocks);
  flash_bwd_dkv_chunked_kernel<E><<<grid, kBlockThreads, bytes, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <class E>
int launch_dkv_split(const Args& a, int b, cudaStream_t st) {
  const int nt = (a.sk + kSplitBN - 1) / kSplitBN;
  const unsigned blocks = sm90::folded_blocks(nt, b, a.h);
  if (blocks == 0) return sm90::kErrGrid;
  DkvParams p;
  const int err = dkv_params<E>(p, a, b, kSplitBQ, kSplitBN);
  if (err) return err;
  p.fold = sm90::fold(nt, b, a.h);
  constexpr int bytes = DkvSplitSmem::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_split_kernel<E>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(blocks);
  flash_bwd_dkv_split_kernel<E><<<grid, kBlockThreads, bytes, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The f32 kernels' parameters: tensor maps of Q and dO in boxes of `bq`
// rows, of K and V in boxes of 64, 32 features a box.
int tf32_params(Tf32Params& p, const Args& a, int b, int bq) {
  int err = sm90::encode_f32_tile(&p.q, a.q, a.d, a.sq, a.h, b, a.sqs,
                                  a.sqh, a.sqb, bq);
  if (!err)
    err = sm90::encode_f32_tile(&p.dout, a.dout, a.d, a.sq, a.h, b, a.sds,
                                a.sdh, a.sdb, bq);
  if (!err)
    err = sm90::encode_f32_tile(&p.k, a.k, a.d, a.sk, a.h, b, a.sks, a.skh,
                                a.skb, 64);
  if (!err)
    err = sm90::encode_f32_tile(&p.v, a.v, a.d, a.sk, a.h, b, a.svs, a.svh,
                                a.svb, 64);
  if (err) return err;
  p.lse = a.lse;
  p.c = a.c;
  p.o1 = a.o1;
  p.o2 = a.o2;
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

template <int D>
int launch_dq_tf32(const Args& a, int b, cudaStream_t st) {
  const int nco = (a.d + D - 1) / D;
  const long long nt = static_cast<long long>((a.sq + 63) / 64) * nco;
  const unsigned blocks = sm90::folded_blocks(nt, b, a.h);
  if (blocks == 0) return sm90::kErrGrid;
  Tf32Params p;
  const int err = tf32_params(p, a, b, 64);
  if (err) return err;
  p.fold = sm90::fold(nt, b, a.h);
  constexpr int bytes = TfDqSmem<D>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_tf32_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(blocks);
  flash_bwd_dq_tf32_kernel<D><<<grid, kBlockThreads, bytes, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int BQ>
int launch_dkv_tf32(const Args& a, int b, cudaStream_t st) {
  const int nco = (a.d + D - 1) / D;
  const long long nt = static_cast<long long>((a.sk + 63) / 64) * nco;
  const unsigned blocks = sm90::folded_blocks(nt, b, a.h);
  if (blocks == 0) return sm90::kErrGrid;
  Tf32Params p;
  const int err = tf32_params(p, a, b, BQ);
  if (err) return err;
  p.fold = sm90::fold(nt, b, a.h);
  constexpr int bytes = TfDkvSmem<BQ>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_tf32_kernel<D, BQ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(blocks);
  flash_bwd_dkv_tf32_kernel<D, BQ><<<grid, kBlockThreads, bytes, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation of head dim a.d in a 16-bit type E, every one on TMA +
// wgmma. dq and dk/dv alike: tile widths 64 and 128, 256 (the features
// split over the warpgroups), and chunks of 256 past it (the split
// kernel's block, its chunk pairs streamed through three slots).
template <class E>
int launch_dq16(const Args& a, int b, cudaStream_t st) {
  if (a.d <= 64) return launch_dq_wgmma<64, E>(a, b, st);
  if (a.d <= 128) return launch_dq_wgmma<128, E>(a, b, st);
  if (a.d <= 256) return launch_dq_split<E>(a, b, st);
  return launch_dq_chunked<E>(a, b, st);
}

template <class E>
int launch_dkv16(const Args& a, int b, cudaStream_t st) {
  if (a.d <= 64) return launch_dkv_wgmma<64, E>(a, b, st);
  if (a.d <= 128) return launch_dkv_wgmma<128, E>(a, b, st);
  if (a.d <= 256) return launch_dkv_split<E>(a, b, st);
  return launch_dkv_chunked<E>(a, b, st);
}

int launch_dq(const Args& a, int b, int dtype, cudaStream_t st) {
  if (dtype == 1) return launch_dq16<sm90::Bf16>(a, b, st);
  if (dtype == 2) return launch_dq16<sm90::F16>(a, b, st);
  if (a.d <= 64) return launch_dq_tf32<64>(a, b, st);
  if (a.d <= 128) return launch_dq_tf32<128>(a, b, st);
  return launch_dq_tf32<256>(a, b, st);  // chunks of 256 past it
}

int launch_dkv(const Args& a, int b, int dtype, cudaStream_t st) {
  if (dtype == 1) return launch_dkv16<sm90::Bf16>(a, b, st);
  if (dtype == 2) return launch_dkv16<sm90::F16>(a, b, st);
  if (a.d <= 64) return launch_dkv_tf32<64, 64>(a, b, st);
  if (a.d <= 128) return launch_dkv_tf32<128, 64>(a, b, st);
  return launch_dkv_tf32<256, 32>(a, b, st);  // chunks of 256 past it
}

int make_args(Args& a, const void* q, const void* k, const void* v,
              const void* dout, const void* lse, const void* c, void* o1,
              void* o2, const long long* st, int b, int h, int sq, int sk,
              int d, int dtype, int causal, long long q_offset,
              long long kv_offset, float scale) {
  if (dtype < 0 || dtype > 2 || d < 8 || d % 8 != 0 || b <= 0 || h <= 0 ||
      sq <= 0 || sk < 0 || st == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(b) * h > 0x7fffffffLL) return sm90::kErrGrid;
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
// launch (0 = success), sm90::kErrGrid where B * H or the launch grid
// passes 2^31 - 1, or a tensor-map error (flash_bwd_error_string).
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
