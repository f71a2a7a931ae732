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
// Bound on the H100 SXM: the work is 4*B*H*Sq*Sk*D FLOPs (QK^T and PV,
// about half of that for causal) against 989 TFLOP/s in bf16, and the
// bytes are q, k, v read once and out, lse written once against 3.35 TB/s.
// At the LM's shape, (B, H, S, D) = (8, 16, 2048, 64) causal, that is
// 6.9e10 FLOP = 0.0695 ms against 1.35e8 B = 0.040 ms: operations bound it.
//
// Design:
// * bf16: one block per (kWG x 64 query rows, head, batch), with kWG = 3
//   consumer warpgroups at D = 64 and 2 at D = 128, plus one producer
//   warpgroup. The producer gives most of its registers to the consumers
//   (setmaxnreg), and one of its threads loads the Q tile once and then
//   streams 128-key K and V tiles by TMA into a ring of kStages = 3 shared
//   stages, each completed on its "full" mbarrier and handed back on its
//   "empty" one. Each consumer warpgroup owns 64 query rows: S = Q K^T is
//   wgmma SS (both K-major), the online softmax runs on the S accumulators
//   in registers (exp2 on the SFU, the scale folded into one FMA), and
//   O += P V is wgmma RS with P packed to bf16 from the S accumulators and
//   V read MN-major straight from its TMA tile (no transpose in shared
//   memory). A software pipeline inside each warpgroup issues S of tile i
//   together with P V of tile i - 1, so the tensor cores run that product
//   while the softmax of tile i runs. Query tiles launch heaviest first
//   (the grid's slowest axis runs backwards), and each warpgroup skips the
//   products of key tiles its 64 rows cannot see. Tiles are 128-byte
//   swizzled boxes of 64 columns; D = 128 is two boxes (sm90.cuh).
//   Left out: warp-specialised ping-pong between the consumer warpgroups
//   (softmax of one overlapping the products of the other on purpose, not
//   by chance), overlap of the next S product with this tile's softmax,
//   persistent blocks, and a TMA store of out.
// * f32: the same algorithm on the CUDA cores (16 query rows x 32-key
//   tiles per block, one dot product per score), exact in f32; wgmma has
//   no f32 input type, and the LM runs in bf16.

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
// bf16: TMA tile ring + wgmma

constexpr int kBN = 128;  // keys per tile
constexpr int kStages = 3;

// One block: kWG consumer warpgroups of 64 query rows each and one
// producer warpgroup. Three consumers at D = 64 (more warps to hide the
// softmax's latencies), two at D = 128 (its O accumulator takes the
// registers of the third). setmaxnreg moves the producer's registers to
// the consumers: 32 + 3 x 160 or 40 + 2 x 232 per 128 threads.
template <int D>
struct FwdCfg {
  static constexpr int kWG = D == 64 ? 3 : 2;
  static constexpr int kBM = 64 * kWG;  // query rows per block
  static constexpr int kConsumers = 128 * kWG;
  static constexpr int kThreads = kConsumers + 128;
  static constexpr int kProducerRegs = kWG == 3 ? 32 : 40;
  static constexpr int kConsumerRegs = kWG == 3 ? 160 : 232;
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
  static constexpr int kBytes = kBar + (1 + 2 * kStages) * 8 + 1024;
};

struct FwdParams {
  CUtensorMap q;     // boxes of 64 features x kBM rows
  CUtensorMap k, v;  // boxes of 64 features x kBN rows
  __nv_bfloat16* o;
  float* lse;
  long long sob, soh, sos;
  int h, sq, sk;
  int causal;
  long long q_offset, kv_offset;
  float scale;  // nonzero (the C entry maps 0 to a tiny positive scale)
};

// Key tiles [0, n) that rows [q_lo, q_lo + rows) of the (global) query
// sequence run over: all of them, or (causal) up to the last live one.
__device__ __forceinline__ int fwd_key_tiles(const FwdParams& p,
                                             long long q_lo, int rows) {
  const int nk = (p.sk + kBN - 1) / kBN;
  if (!p.causal) return nk;
  const long long x = q_lo + rows - 1 - p.kv_offset;
  if (x < 0) return 0;
  return static_cast<int>(x / kBN + 1 < nk ? x / kBN + 1 : nk);
}

template <int D>
__global__ void __launch_bounds__(FwdCfg<D>::kThreads, 1)
    flash_fwd_bf16_kernel(const __grid_constant__ FwdParams p) {
  using C = FwdCfg<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sm90::align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::kBar);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int hh = blockIdx.x, bb = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * C::kBM;  // heaviest first
  const int n = fwd_key_tiles(p, p.q_offset + q0, C::kBM);
  const int tid = threadIdx.x;

  if (tid == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], C::kConsumers);
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
        const int s = i % kStages;
        sm90::mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&full[s], 2 * C::kKT);
        uint8_t* ks = smem + C::kKV + s * 2 * C::kKT;
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          sm90::tma_load_4d(ks + c * C::kKBox, &p.k, &full[s], c * 64,
                            i * kBN, hh, bb);
          sm90::tma_load_4d(ks + C::kKT + c * C::kKBox, &p.v, &full[s],
                            c * 64, i * kBN, hh, bb);
        }
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
    // Masked scores are set to fill, so that fill * sl2 = -inf.
    const float fill = sl2 > 0.f ? -INFINITY : INFINITY;
    const long long q_lo = p.q_offset + q0 + 64 * w;
    // Tiles [0, nw) are live for these 64 rows; a causal tail of the
    // block's tiles may lie wholly in their future.
    const int nw = fwd_key_tiles(p, q_lo, 64) < n ? fwd_key_tiles(p, q_lo, 64)
                                                  : n;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m_r[2] = {-INFINITY, -INFINITY};  // running max of S sl2
    float l_r[2] = {0.f, 0.f};  // this thread's share of the row sums
    float sc[kBN / 2];           // S of one tile, then its P in f32
    uint32_t pa[kBN / 16][4];    // P in bf16: the A fragments of P V
    float corr[2];

    auto stage = [&](int i) {
      return smem + C::kKV + (i % kStages) * 2 * C::kKT;
    };
    // S = Q K^T of tile i, 64 rows x 128 keys (issued, not waited).
    auto issue_s = [&](int i) {
      const uint8_t* ks = stage(i);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm90::Wgmma<kBN>::ss(
            sc, sm90::desc_k(qs + (kk / 4) * C::kQBox + (kk % 4) * 32),
            sm90::desc_k(ks + (kk / 4) * C::kKBox + (kk % 4) * 32), kk > 0);
      sm90::wgmma_commit();
    };
    // O += P V of tile i: V's keys run down its rows (MN-major).
    auto issue_pv = [&](int i) {
      const uint8_t* vs = stage(i) + C::kKT;
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        sm90::Wgmma<D>::rs_mn(o, pa[kk],
                              sm90::desc_mn(vs + kk * 16 * 128, C::kKBox),
                              1);
      sm90::wgmma_commit();
    };
    // The online softmax of tile i on the raw scores in sc (rows r0: e = 0,
    // 1; r0 + 8: e = 2, 3). Only diagonal and ragged tiles are masked, in
    // a pass of their own. The row max of S sl2 is the max of the raw
    // scores times sl2 (their min if sl2 < 0), and P = exp2(S sl2 - m)
    // takes one FMA; the masked fill gives P = 0. Leaves P in sc, and in
    // corr the factor O must be rescaled by.
    auto softmax = [&](int i) {
      const int k0 = i * kBN;
      bool live = true, diag = false;
      if (p.causal)
        causal_liveness<64, kBN>(q_lo, p.kv_offset + k0, live, diag);
      if (diag || k0 + kBN > p.sk) {
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = q0 + r0 + 8 * (e >> 1);
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
          for (int j = 2; j < kBN / 8; ++j)
            mt[hr][j & 1] = fmaxf(mt[hr][j & 1], fmaxf(sc[4 * j + 2 * hr],
                                                       sc[4 * j + 2 * hr + 1]));
        }
      } else {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          mt[hr][0] = fminf(sc[2 * hr], sc[2 * hr + 1]);
          mt[hr][1] = fminf(sc[4 + 2 * hr], sc[4 + 2 * hr + 1]);
#pragma unroll
          for (int j = 2; j < kBN / 8; ++j)
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
      for (int j = 0; j < kBN / 8; ++j)
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
    };
    // The S accumulators of key columns [16 kk, 16 kk + 16) are the A
    // fragment of k-step kk of P V.
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = sm90::pack_bf16(sc[8 * kk + 2 * r],
                                      sc[8 * kk + 2 * r + 1]);
    };
    auto wait_full = [&](int i) {
      sm90::mbar_wait(&full[i % kStages], (i / kStages) & 1);
    };

    // Software pipeline over the live tiles: while the softmax of tile i
    // runs on the CUDA cores, the tensor cores run O += P V of tile i - 1
    // (and the other warpgroups' products).
    sm90::mbar_wait(q_full, 0);
    if (nw > 0) {
      wait_full(0);
      issue_s(0);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);
      softmax(0);
      pack_p();
      for (int i = 1; i < nw; ++i) {
        wait_full(i);
        issue_s(i);
        issue_pv(i - 1);
        sm90::wgmma_wait<1>();  // S of tile i; P V of tile i - 1 in flight
        sm90::fence_regs(sc);
        softmax(i);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(o);
        sm90::mbar_arrive(&empty[(i - 1) % kStages]);  // may be refilled
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o[4 * j] *= corr[0];
          o[4 * j + 1] *= corr[0];
          o[4 * j + 2] *= corr[1];
          o[4 * j + 3] *= corr[1];
        }
        pack_p();
      }
      issue_pv(nw - 1);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
      sm90::mbar_arrive(&empty[(nw - 1) % kStages]);
    }
    for (int i = nw; i < n; ++i) {  // tiles only other warpgroups see
      wait_full(i);
      sm90::mbar_arrive(&empty[i % kStages]);
    }

#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float l = l_r[hr];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float lc = fmaxf(l, 1e-30f);
      const float inv = 1.f / lc;
      const int row = q0 + r0 + 8 * hr;
      if (row < p.sq) {
        __nv_bfloat16* op = p.o + static_cast<long long>(bb) * p.sob +
                            static_cast<long long>(hh) * p.soh +
                            static_cast<long long>(row) * p.sos;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(op + 8 * j + 2 * t) =
              __floats2bfloat162_rn(o[4 * j + 2 * hr] * inv,
                                    o[4 * j + 2 * hr + 1] * inv);
        if (t == 0)
          p.lse[(static_cast<long long>(bb) * p.h + hh) * p.sq + row] =
              m_r[hr] == -INFINITY ? -INFINITY : m_r[hr] * kLn2 + logf(lc);
      }
    }
  }
}

template <int D>
int launch_bf16(const Args& a, int b, cudaStream_t stream) {
  using C = FwdCfg<D>;
  FwdParams p;
  int err = sm90::encode_rows_bf16(&p.q, a.q, D, a.sq, a.h, b, a.sqs, a.sqh,
                                   a.sqb, C::kBM);
  if (!err)
    err = sm90::encode_rows_bf16(&p.k, a.k, D, a.sk, a.h, b, a.sks, a.skh,
                                 a.skb, kBN);
  if (!err)
    err = sm90::encode_rows_bf16(&p.v, a.v, D, a.sk, a.h, b, a.svs, a.svh,
                                 a.svb, kBN);
  if (err) return err;
  p.o = static_cast<__nv_bfloat16*>(a.o);
  p.lse = a.lse;
  p.sob = a.sob;
  p.soh = a.soh;
  p.sos = a.sos;
  p.h = a.h;
  p.sq = a.sq;
  p.sk = a.sk;
  p.causal = a.causal;
  p.q_offset = a.q_offset;
  p.kv_offset = a.kv_offset;
  // A zero scale makes every score 0; 1e-30 gives exp2(S 1e-30 log2e - m)
  // = 1 exactly as well, and keeps masked scores at -inf (fill * scale).
  p.scale = a.scale == 0.f ? 1e-30f : a.scale;
  constexpr int bytes = C::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(a.h, b, (a.sq + C::kBM - 1) / C::kBM);
  flash_fwd_bf16_kernel<D><<<grid, C::kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// f32: CUDA cores

constexpr int kSBQ = 16;  // query rows per block
constexpr int kSBK = 32;  // keys per tile
constexpr int kF32Threads = 128;
// 128 threads: thread = (row r = tid / 8, lane-in-row c8 = tid % 8); a row's
// 8 threads are adjacent lanes of one warp.

template <int D>
__global__ void __launch_bounds__(kF32Threads)
    flash_fwd_f32_kernel(Args a) {
  __shared__ float q_s[kSBQ][D + 1];
  __shared__ float k_s[kSBK][D + 1];
  __shared__ float v_s[kSBK][D];
  __shared__ float p_s[kSBQ][kSBK + 1];

  const int q0 = blockIdx.x * kSBQ;
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x, r = tid / 8, c8 = tid % 8;
  const float* qp = static_cast<const float*>(a.q) + bb * a.sqb + hh * a.sqh;
  const float* kp = static_cast<const float*>(a.k) + bb * a.skb + hh * a.skh;
  const float* vp = static_cast<const float*>(a.v) + bb * a.svb + hh * a.svh;
  float* op = static_cast<float*>(a.o) + bb * a.sob + hh * a.soh;

  for (int e = tid; e < kSBQ * D; e += kF32Threads) {
    const int rr = e / D, d = e % D;
    q_s[rr][d] = q0 + rr < a.sq ? qp[(q0 + rr) * a.sqs + d] : 0.f;
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
    __syncthreads();  // the previous tile's k_s/v_s reads are done
    for (int e = tid; e < kSBK * D; e += kF32Threads) {
      const int rr = e / D, d = e % D;
      const bool in = k0 + rr < a.sk;
      k_s[rr][d] = in ? kp[(k0 + rr) * a.sks + d] : 0.f;
      v_s[rr][d] = in ? vp[(k0 + rr) * a.svs + d] : 0.f;
    }
    __syncthreads();

    float s[kSBK / 8];
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < kSBK / 8; ++i) {
      const int col = c8 + 8 * i;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) dot = fmaf(q_s[r][d], k_s[col][d], dot);
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
  if (row < a.sq) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) op[row * a.sos + c8 + 8 * j] = acc[j] / lc;
    if (c8 == 0)
      a.lse[(static_cast<long long>(bb) * a.h + hh) * a.sq + row] =
          m == -INFINITY ? -INFINITY : m + logf(lc);
  }
}

template <int D>
int launch(const Args& a, int b, int dtype, cudaStream_t stream) {
  if (dtype == 1) return launch_bf16<D>(a, b, stream);
  dim3 grid((a.sq + kSBQ - 1) / kSBQ, a.h, b);
  flash_fwd_f32_kernel<D><<<grid, kF32Threads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; d in {64, 128}. Strides are in
// elements; in bf16 the base pointers are 16-byte aligned and the strides
// multiples of 8 elements (TMA's rule). Returns the CUDA error of the
// launch (0 = success), or a tensor-map error (flash_fwd_error_string).
int flash_fwd(const void* q, const void* k, const void* v, void* o,
              void* lse, long long sqb, long long sqh, long long sqs,
              long long skb, long long skh, long long sks, long long svb,
              long long svh, long long svs, long long sob, long long soh,
              long long sos, int b, int h, int sq, int sk, int d, int dtype,
              int causal, long long q_offset, long long kv_offset,
              float scale, void* stream) {
  if ((dtype != 0 && dtype != 1) || (d != 64 && d != 128) || b <= 0 ||
      h <= 0 || sq <= 0 || sk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q,   k,   v,   o,   static_cast<float*>(lse),
         sqb, sqh, sqs, skb, skh,
         sks, svb, svh, svs, sob,
         soh, sos, h,   sq,  sk,
         causal, q_offset, kv_offset, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return d == 64 ? launch<64>(a, b, dtype, st) : launch<128>(a, b, dtype, st);
}

const char* flash_fwd_error_string(int code) {
  return sm90::error_string(code);
}

}  // extern "C"
