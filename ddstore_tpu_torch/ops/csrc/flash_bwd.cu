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
// blocks. The dq kernel takes one block per (b*h, 64-query tile) and loops
// over the key tiles up to the last live one; the dk/dv kernel takes one
// block per (128-key tile, head, batch) and loops over the query tiles
// from the first one that can see it. The two kernels write disjoint
// outputs, so there are no atomics and the gradients are deterministic
// (bit-identical from launch to launch). Every output row is written, as
// zero where no live pair reaches it (keys no query sees, fully-masked
// query rows), and ragged last tiles of any length that is a multiple of 8
// are masked in the kernel.
//
// Bound on the H100 SXM at the LM's shape, (B, H, S, D) = (8, 16, 2048,
// 64) bf16 causal, 2.686e8 live score pairs: dq does 3 products of 2*D
// FLOP a pair (s, dp, dq), 1.03e11 FLOP = 0.104 ms at 989 TFLOP/s, against
// about 170 MB of bytes (q, k, v, do, lse, c read, dq written) = 0.051 ms
// at 3.35 TB/s; dk/dv does 4 (s, dp, dv, dk), 1.375e11 FLOP = 0.139 ms,
// against about 203 MB = 0.061 ms. Both are bound by operations.
//
// Design, and what it leaves on the table:
// * bf16 dk/dv: TMA tile ring + wgmma (sm90.cuh). One block of three
//   warpgroups per 128 keys; warpgroup 2 gives up its registers
//   (setmaxnreg, 24 left against 240 for each consumer) and one of its
//   threads loads K and V once by TMA, then streams the query tiles (Q, dO
//   and their lse and c slices) through a ring of three shared stages
//   completed on mbarriers ("full" when TMA has landed, "empty" when both
//   consumers are done). Warpgroups 0 and 1 own 64 key rows each and work
//   with keys as rows: S^T = K Q^T and dP^T = V dO^T are wgmma SS
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
//   them from shared memory for every query tile), persistent blocks, and
//   a fused dq (atomic dq would make the gradients run-dependent).
// * bf16 dq: 4 warps of mma.sync m16n8k16 (bf16 in, f32 accumulate);
//   each warp owns 16 query rows. S and dP are recomputed; dS re-packs
//   from the accumulators as the A fragments of dQ += dS K, and K is read
//   transposed with ldmatrix.trans. Left out: everything the dk/dv kernel
//   has (TMA, a ring of asynchronous tile loads, wgmma, warp
//   specialisation); the tile loads here are synchronous.
// * f32: the same algorithm on the CUDA cores, one dot product per score
//   (the tensor cores take no f32 inputs); exact in f32, for checking the
//   math without bf16 rounding. The LM runs in bf16.

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
// taken as 1e30, so that their p = exp(s - lse) is exactly 0.
__device__ __forceinline__ float safe_lse(const Args& a, long long bh,
                                          int row) {
  if (row >= a.sq) return kSafeLse;
  const float l = a.lse[bh * a.sq + row];
  return l == -INFINITY ? kSafeLse : l;
}

// The same in log2 units, for exp2.
__device__ __forceinline__ float safe_lse2(const Args& a, long long bh,
                                           int row) {
  return safe_lse(a, bh, row) * kLog2e;
}

__device__ __forceinline__ float row_c(const Args& a, long long bh, int row) {
  return row < a.sq ? a.c[bh * a.sq + row] : 0.f;
}

// ---------------------------------------------------------------------------
// bf16 dq: tensor cores through mma.sync

constexpr int kThreads = 128;
constexpr int kPad = 8;  // bf16 of row padding: conflict-free fragment reads

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a * b for one 16x8x16 tile: a row-major 16x16, b column-major 16x8.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory, transposed: lane i gives the
// address of row i % 8 of matrix i / 8, and receives in register m the
// elements (2 * (i % 4), i / 4) and (2 * (i % 4) + 1, i / 4) of matrix m,
// i.e. the mma B fragment of a matrix stored with k along its rows.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4],
                                          const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The A fragment of rows [r0, r0 + 16), k columns [kk * 16, kk * 16 + 16)
// of a row-major bf16 tile in shared memory with row stride ST.
template <int ST>
__device__ __forceinline__ void load_a(uint32_t (&f)[4],
                                       const __nv_bfloat16* s, int r0, int kk,
                                       int g, int t) {
  f[0] = ld32(&s[(r0 + g) * ST + kk * 16 + 2 * t]);
  f[1] = ld32(&s[(r0 + g + 8) * ST + kk * 16 + 2 * t]);
  f[2] = ld32(&s[(r0 + g) * ST + kk * 16 + 8 + 2 * t]);
  f[3] = ld32(&s[(r0 + g + 8) * ST + kk * 16 + 8 + 2 * t]);
}

// Copy rows [r0, r0 + R) of a (seq, D) bf16 operand into a shared tile of
// row stride ST; rows past n are zero.
template <int R, int D, int ST>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           long long row_stride, int r0,
                                           int n, int tid) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  for (int ch = tid; ch < R * CPR; ch += kThreads) {
    const int r = ch / CPR, cc = ch % CPR;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < n)
      val = *reinterpret_cast<const uint4*>(src + (r0 + r) * row_stride +
                                            cc * 8);
    *reinterpret_cast<uint4*>(&dst[r * ST + cc * 8]) = val;
  }
}

// dq: one block per (64-query tile, head, batch); 4 warps x 16 rows.
constexpr int kDqBQ = 64;
constexpr int kDqBK = 64;

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_bf16_kernel(Args a) {
  constexpr int ST = D + kPad;
  __shared__ __align__(16) __nv_bfloat16 k_s[kDqBK * ST];
  __shared__ __align__(16) __nv_bfloat16 v_s[kDqBK * ST];

  const int q0 = blockIdx.x * kDqBQ;
  const int hh = blockIdx.y, bb = blockIdx.z;
  const long long bh = static_cast<long long>(bb) * a.h + hh;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = warp * 16;
  const auto* qp =
      static_cast<const __nv_bfloat16*>(a.q) + bb * a.sqb + hh * a.sqh;
  const auto* kp =
      static_cast<const __nv_bfloat16*>(a.k) + bb * a.skb + hh * a.skh;
  const auto* vp =
      static_cast<const __nv_bfloat16*>(a.v) + bb * a.svb + hh * a.svh;
  const auto* dp_ =
      static_cast<const __nv_bfloat16*>(a.dout) + bb * a.sdb + hh * a.sdh;
  auto* dqp = static_cast<__nv_bfloat16*>(a.o1) + bb * a.s1b + hh * a.s1h;

  // Q and dO tiles through shared memory into A fragments kept for the
  // whole key loop.
  stage_rows<kDqBQ, D, ST>(k_s, qp, a.sqs, q0, a.sq, tid);
  stage_rows<kDqBQ, D, ST>(v_s, dp_, a.sds, q0, a.sq, tid);
  __syncthreads();
  uint32_t qf[D / 16][4], dof[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    load_a<ST>(qf[kk], k_s, wr, kk, g, t);
    load_a<ST>(dof[kk], v_s, wr, kk, g, t);
  }
  __syncthreads();

  // Rows g and g + 8 of this warp's 16.
  float lse2[2], cr[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    lse2[hr] = safe_lse2(a, bh, q0 + wr + g + 8 * hr);
    cr[hr] = row_c(a, bh, q0 + wr + g + 8 * hr);
  }
  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

  const float sl2 = a.scale * kLog2e;
  const long long q_lo = a.q_offset + q0;
  const int nk = (a.sk + kDqBK - 1) / kDqBK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kDqBK;
    bool diag = false;
    if (a.causal) {
      bool live;
      causal_liveness<kDqBQ, kDqBK>(q_lo, a.kv_offset + k0, live, diag);
      if (!live) break;  // every later tile lies further in the future
    }
    const bool masked = diag || k0 + kDqBK > a.sk || q0 + kDqBQ > a.sq;
    stage_rows<kDqBK, D, ST>(k_s, kp, a.sks, k0, a.sk, tid);
    stage_rows<kDqBK, D, ST>(v_s, vp, a.svs, k0, a.sk, tid);
    __syncthreads();

    // S = Q K^T and dP = dO V^T: 16 rows x 64 keys per warp.
    float s[kDqBK / 8][4], dp[kDqBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kDqBK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int nt = 0; nt < kDqBK / 8; ++nt) {
        const int off = (nt * 8 + g) * ST + kk * 16 + 2 * t;
        mma16816(s[nt], qf[kk], ld32(&k_s[off]), ld32(&k_s[off + 8]));
        mma16816(dp[nt], dof[kk], ld32(&v_s[off]), ld32(&v_s[off + 8]));
      }

    // dS = P * (dP - c), P = exp2(S * scale * log2e - lse * log2e).
#pragma unroll
    for (int nt = 0; nt < kDqBK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1;
        float x = s[nt][e] * sl2;
        if (masked &&
            pair_masked(a, q0 + wr + g + 8 * hr, k0 + nt * 8 + 2 * t + (e & 1)))
          x = -INFINITY;
        const float p = exp2f(x - lse2[hr]);
        s[nt][e] = p * (dp[nt][e] - cr[hr]);
      }

    // dQ += dS K: dS re-packed as A fragments over the keys; K read
    // transposed (keys along k) with ldmatrix.trans.
#pragma unroll
    for (int kk = 0; kk < kDqBK / 16; ++kk) {
      const uint32_t da[4] = {
          sm90::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          sm90::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          sm90::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          sm90::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const int mat = lane / 8, r = lane % 8;
#pragma unroll
      for (int dt = 0; dt < D / 8; dt += 2) {
        uint32_t b[4];
        ldsm_x4_t(b, &k_s[(kk * 16 + (mat & 1) * 8 + r) * ST +
                          (dt + (mat >> 1)) * 8]);
        mma16816(acc[dt], da, b[0], b[1]);
        mma16816(acc[dt + 1], da, b[2], b[3]);
      }
    }
    __syncthreads();  // the next tile overwrites k_s and v_s
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = q0 + wr + g + 8 * hr;
    if (row < a.sq) {
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
        *reinterpret_cast<__nv_bfloat162*>(dqp + row * a.s1s + dt * 8 +
                                           2 * t) =
            __floats2bfloat162_rn(acc[dt][2 * hr] * a.scale,
                                  acc[dt][2 * hr + 1] * a.scale);
    }
  }
}

// dk/dv: TMA tile ring + wgmma. One block of three warpgroups per
// (128 keys, head, batch); warpgroups 0 and 1 own 64 key rows each, and
// warpgroup 2 produces. K and V stay resident in shared memory; query
// tiles of Q, dO and their lse and c slices stream through a ring of
// kDkvStages stages: three, since while tile i is formed tile i - 1's
// stage is still read by dV and dK, and tile i + 1 loads. BQ = 64 queries
// at D = 64, 32 at D = 128 (to bound the registers of the two D-wide
// accumulators).
constexpr int kDkvBN = 128;
constexpr int kDkvStages = 3;
constexpr int kDkvThreads = 384;
constexpr int kDkvConsumers = 256;
// setmaxnreg moves registers from the producer to the consumers within
// what the launch gave the block (168 a thread for 384 threads): 24 + 2 x
// 240 = 3 x 168. Asking for more than that pool would wait forever; with
// 232 the D = 128 consumers spill.
constexpr int kDkvProducerRegs = 24;
constexpr int kDkvConsumerRegs = 240;

template <int D>
__host__ __device__ constexpr int dkv_bq() {
  return D == 64 ? 64 : 32;
}

struct DkvParams {
  CUtensorMap q, dout;  // boxes of 64 features x BQ rows
  CUtensorMap k, v;     // boxes of 64 features x 128 rows
  CUtensorMap lse, c;   // (B*H, Sq) f32, boxes of BQ
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  long long s1b, s1h, s1s;
  long long s2b, s2h, s2s;
  int h, sq, sk;
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
  static constexpr int kBar = kRing + kDkvStages * kStage;
  static constexpr int kBytes = kBar + (1 + 2 * kDkvStages) * 8 + 1024;
  static constexpr int kStageTx = 2 * kQT + 2 * kBQ * 4;
};

template <int D>
__global__ void __launch_bounds__(kDkvThreads, 1)
    flash_bwd_dkv_bf16_kernel(const __grid_constant__ DkvParams p) {
  using L = DkvSmem<D>;
  constexpr int BQ = L::kBQ;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sm90::align1024(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kDkvStages;

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
    for (int s = 0; s < kDkvStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kDkvConsumers);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= kDkvConsumers) {
    // Producer warpgroup: one thread issues every load.
    sm90::reg_dealloc<kDkvProducerRegs>();
    if (tid == kDkvConsumers) {
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
        if (++s == kDkvStages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // Consumer warpgroup w: key rows [64 w, 64 w + 64) of the block.
    sm90::reg_alloc<kDkvConsumerRegs>();
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
      return smem + L::kRing + (i % kDkvStages) * L::kStage;
    };
    auto wait_full = [&](int i) {
      sm90::mbar_wait(&full[i % kDkvStages], (i / kDkvStages) & 1);
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
        sm90::Wgmma<BQ>::ss(st, sm90::desc_k(ks + ka), sm90::desc_k(qs + kb),
                            kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int ka = (kk / 4) * L::kKBox + (kk % 4) * 32;
        const int kb = (kk / 4) * L::kQBox + (kk % 4) * 32;
        sm90::Wgmma<BQ>::ss(dpt, sm90::desc_k(vs + ka),
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
        sm90::Wgmma<D>::rs_mn(dv, pa[kk],
                              sm90::desc_mn(dos + kk * 16 * 128, L::kQBox), 1);
        sm90::Wgmma<D>::rs_mn(dk, da[kk],
                              sm90::desc_mn(qs + kk * 16 * 128, L::kQBox), 1);
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
              sm90::pack_bf16(st[8 * kk + 2 * r], st[8 * kk + 2 * r + 1]);
          da[kk][r] =
              sm90::pack_bf16(dpt[8 * kk + 2 * r], dpt[8 * kk + 2 * r + 1]);
        }
    };

    sm90::mbar_wait(kv_full, 0);
    for (int i = 0; i < i0; ++i) {  // tiles only the other warpgroup sees
      wait_full(i);
      sm90::mbar_arrive(&empty[i % kDkvStages]);
    }
    // Software pipeline over the live tiles: while P^T and dS^T of tile i
    // are formed on the CUDA cores, the tensor cores run dV and dK of tile
    // i - 1 (and the other warpgroup's products).
    // dV and dK of tile i waited for; then its stage may be refilled.
    auto finish_dkv = [&](int i) {
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dv);
      sm90::fence_regs(dk);
      sm90::mbar_arrive(&empty[i % kDkvStages]);
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
        __nv_bfloat16* dkp = p.dk + static_cast<long long>(bb) * p.s1b +
                             static_cast<long long>(hh) * p.s1h +
                             static_cast<long long>(row) * p.s1s;
        __nv_bfloat16* dvp = p.dv + static_cast<long long>(bb) * p.s2b +
                             static_cast<long long>(hh) * p.s2h +
                             static_cast<long long>(row) * p.s2s;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          *reinterpret_cast<__nv_bfloat162*>(dkp + 8 * j + 2 * t) =
              __floats2bfloat162_rn(dk[4 * j + 2 * hr] * p.scale,
                                    dk[4 * j + 2 * hr + 1] * p.scale);
          *reinterpret_cast<__nv_bfloat162*>(dvp + 8 * j + 2 * t) =
              __floats2bfloat162_rn(dv[4 * j + 2 * hr], dv[4 * j + 2 * hr + 1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores. 128 threads = 16 rows x 8 lanes; a row's 8 threads are
// adjacent lanes of one warp, and lane c8 of a row takes the columns
// c8 + 8 i of the streamed tile and the features c8 + 8 j.

constexpr int kSRows = 16;   // rows per block (queries for dq, keys for dk/dv)
constexpr int kSDkvBQ = 16;  // queries per tile of the dk/dv kernel

// Keys per tile of the dq kernel: 32, or 16 at D = 128 to stay within
// 48 KB of static shared memory.
template <int D>
__host__ __device__ constexpr int dq_f32_bk() {
  return D == 64 ? 32 : 16;
}

__device__ __forceinline__ float dot_row(const float* x, const float* y,
                                         int d) {
  float acc = 0.f;
#pragma unroll 16
  for (int i = 0; i < d; ++i) acc = fmaf(x[i], y[i], acc);
  return acc;
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_f32_kernel(Args a) {
  constexpr int BK = dq_f32_bk<D>();
  __shared__ float q_s[kSRows][D + 1];
  __shared__ float do_s[kSRows][D + 1];
  __shared__ float k_s[BK][D + 1];
  __shared__ float v_s[BK][D + 1];
  __shared__ float ds_s[kSRows][BK + 1];

  const int q0 = blockIdx.x * kSRows;
  const int hh = blockIdx.y, bb = blockIdx.z;
  const long long bh = static_cast<long long>(bb) * a.h + hh;
  const int tid = threadIdx.x, r = tid / 8, c8 = tid % 8;
  const float* qp = static_cast<const float*>(a.q) + bb * a.sqb + hh * a.sqh;
  const float* kp = static_cast<const float*>(a.k) + bb * a.skb + hh * a.skh;
  const float* vp = static_cast<const float*>(a.v) + bb * a.svb + hh * a.svh;
  const float* dp_ =
      static_cast<const float*>(a.dout) + bb * a.sdb + hh * a.sdh;
  float* dqp = static_cast<float*>(a.o1) + bb * a.s1b + hh * a.s1h;

  for (int e = tid; e < kSRows * D; e += kThreads) {
    const int rr = e / D, d = e % D;
    const bool in = q0 + rr < a.sq;
    q_s[rr][d] = in ? qp[(q0 + rr) * a.sqs + d] : 0.f;
    do_s[rr][d] = in ? dp_[(q0 + rr) * a.sds + d] : 0.f;
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
    __syncthreads();  // the previous tile's k_s/v_s reads are done
    for (int e = tid; e < BK * D; e += kThreads) {
      const int rr = e / D, d = e % D;
      const bool in = k0 + rr < a.sk;
      k_s[rr][d] = in ? kp[(k0 + rr) * a.sks + d] : 0.f;
      v_s[rr][d] = in ? vp[(k0 + rr) * a.svs + d] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
      const int col = c8 + 8 * i;
      float s = dot_row(q_s[r], k_s[col], D) * a.scale;
      if (masked && pair_masked(a, row, k0 + col)) s = -INFINITY;
      const float p = expf(s - lse);
      ds_s[r][col] = p * (dot_row(do_s[r], v_s[col], D) - cr);
    }
    __syncwarp();  // a row's ds_s is written and read by its own 8 lanes
    for (int col = 0; col < BK; ++col) {
      const float ds = ds_s[r][col];
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        acc[j] = fmaf(ds, k_s[col][c8 + 8 * j], acc[j]);
    }
  }
  if (row < a.sq) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      dqp[row * a.s1s + c8 + 8 * j] = acc[j] * a.scale;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_f32_kernel(Args a) {
  __shared__ float k_s[kSRows][D + 1];
  __shared__ float v_s[kSRows][D + 1];
  __shared__ float q_s[kSDkvBQ][D + 1];
  __shared__ float do_s[kSDkvBQ][D + 1];
  __shared__ float p_s[kSRows][kSDkvBQ + 1];
  __shared__ float ds_s[kSRows][kSDkvBQ + 1];
  __shared__ float lse_s[kSDkvBQ], c_s[kSDkvBQ];

  const int k0 = blockIdx.x * kSRows;
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

  for (int e = tid; e < kSRows * D; e += kThreads) {
    const int rr = e / D, d = e % D;
    const bool in = k0 + rr < a.sk;
    k_s[rr][d] = in ? kp[(k0 + rr) * a.sks + d] : 0.f;
    v_s[rr][d] = in ? vp[(k0 + rr) * a.svs + d] : 0.f;
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
    __syncthreads();  // the previous tile's q_s/do_s reads are done
    for (int e = tid; e < kSDkvBQ * D; e += kThreads) {
      const int rr = e / D, d = e % D;
      const bool in = q0 + rr < a.sq;
      q_s[rr][d] = in ? qp[(q0 + rr) * a.sqs + d] : 0.f;
      do_s[rr][d] = in ? dp_[(q0 + rr) * a.sds + d] : 0.f;
    }
    for (int rr = tid; rr < kSDkvBQ; rr += kThreads) {
      lse_s[rr] = safe_lse(a, bh, q0 + rr);
      c_s[rr] = row_c(a, bh, q0 + rr);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kSDkvBQ / 8; ++i) {
      const int qc = c8 + 8 * i;
      float s = dot_row(k_s[r], q_s[qc], D) * a.scale;
      if (masked && pair_masked(a, q0 + qc, key)) s = -INFINITY;
      const float p = expf(s - lse_s[qc]);
      p_s[r][qc] = p;
      ds_s[r][qc] = p * (dot_row(v_s[r], do_s[qc], D) - c_s[qc]);
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
  if (key < a.sk) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      dkp[key * a.s1s + c8 + 8 * j] = dk[j] * a.scale;
      dvp[key * a.s2s + c8 + 8 * j] = dv[j];
    }
  }
}

template <int D>
cudaError_t launch_dq(const Args& a, int b, int dtype, cudaStream_t st) {
  if (dtype == 1) {
    dim3 grid((a.sq + kDqBQ - 1) / kDqBQ, a.h, b);
    flash_bwd_dq_bf16_kernel<D><<<grid, kThreads, 0, st>>>(a);
  } else {
    dim3 grid((a.sq + kSRows - 1) / kSRows, a.h, b);
    flash_bwd_dq_f32_kernel<D><<<grid, kThreads, 0, st>>>(a);
  }
  return cudaGetLastError();
}

template <int D>
int launch_dkv_bf16(const Args& a, int b, cudaStream_t st) {
  constexpr int BQ = dkv_bq<D>();
  DkvParams p;
  int err = sm90::encode_rows_bf16(&p.q, a.q, D, a.sq, a.h, b, a.sqs, a.sqh,
                                   a.sqb, BQ);
  if (!err)
    err = sm90::encode_rows_bf16(&p.dout, a.dout, D, a.sq, a.h, b, a.sds,
                                 a.sdh, a.sdb, BQ);
  if (!err)
    err = sm90::encode_rows_bf16(&p.k, a.k, D, a.sk, a.h, b, a.sks, a.skh,
                                 a.skb, kDkvBN);
  if (!err)
    err = sm90::encode_rows_bf16(&p.v, a.v, D, a.sk, a.h, b, a.svs, a.svh,
                                 a.svb, kDkvBN);
  const long long rows = static_cast<long long>(b) * a.h;
  if (!err) err = sm90::encode_f32_rows(&p.lse, a.lse, a.sq, rows, BQ);
  if (!err) err = sm90::encode_f32_rows(&p.c, a.c, a.sq, rows, BQ);
  if (err) return err;
  p.dk = static_cast<__nv_bfloat16*>(a.o1);
  p.dv = static_cast<__nv_bfloat16*>(a.o2);
  p.s1b = a.s1b;
  p.s1h = a.s1h;
  p.s1s = a.s1s;
  p.s2b = a.s2b;
  p.s2h = a.s2h;
  p.s2s = a.s2s;
  p.h = a.h;
  p.sq = a.sq;
  p.sk = a.sk;
  p.causal = a.causal;
  p.q_offset = a.q_offset;
  p.kv_offset = a.kv_offset;
  p.scale = a.scale;
  constexpr int bytes = DkvSmem<D>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_bf16_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(a.h, b, (a.sk + kDkvBN - 1) / kDkvBN);
  flash_bwd_dkv_bf16_kernel<D><<<grid, kDkvThreads, bytes, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const Args& a, int b, int dtype, cudaStream_t st) {
  if (dtype == 1) return launch_dkv_bf16<D>(a, b, st);
  dim3 grid((a.sk + kSRows - 1) / kSRows, a.h, b);
  flash_bwd_dkv_f32_kernel<D><<<grid, kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int make_args(Args& a, const void* q, const void* k, const void* v,
              const void* dout, const void* lse, const void* c, void* o1,
              void* o2, const long long* st, int b, int h, int sq, int sk,
              int d, int dtype, int causal, long long q_offset,
              long long kv_offset, float scale) {
  if ((dtype != 0 && dtype != 1) || (d != 64 && d != 128) || b <= 0 ||
      h <= 0 || sq <= 0 || sk < 0 || st == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  a = Args{q,      k,      v,      dout,   static_cast<const float*>(lse),
           static_cast<const float*>(c),   o1,     o2,
           st[0],  st[1],  st[2],  st[3],  st[4],  st[5],
           st[6],  st[7],  st[8],  st[9],  st[10], st[11],
           st[12], st[13], st[14], st[15], st[16], st[17],
           h,      sq,     sk,     causal, q_offset, kv_offset, scale};
  return 0;
}

}  // namespace

extern "C" {

// Both entries take the same arguments. Pointers: q, k, v, do (the input
// dtype), lse and c (f32, (B*H, Sq) contiguous), then the outputs: dq and
// NULL for flash_bwd_dq, dk and dv for flash_bwd_dkv. strides: 18 element
// strides, (batch, head, sequence) of q, k, v, do, out1, out2 (out2's are
// ignored by flash_bwd_dq). dtype: 0 = float32, 1 = bfloat16; d in {64,
// 128}. Returns the CUDA error of the launch (0 = success).
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
  const cudaError_t err =
      d == 64 ? launch_dq<64>(a, b, dtype, st) : launch_dq<128>(a, b, dtype, st);
  return static_cast<int>(err);
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
  return d == 64 ? launch_dkv<64>(a, b, dtype, st)
                 : launch_dkv<128>(a, b, dtype, st);
}

const char* flash_bwd_error_string(int code) {
  return sm90::error_string(code);
}

}  // extern "C"
