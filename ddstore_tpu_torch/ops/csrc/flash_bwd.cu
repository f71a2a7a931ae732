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
// block per (b*h, 64-key tile) and loops over the query tiles from the
// first one that can see it. The two kernels write disjoint outputs, so
// there are no atomics and the gradients are deterministic. Every output
// row is written, as zero where no live pair reaches it (keys no query
// sees, fully-masked query rows), and ragged last tiles of any length
// that is a multiple of 8 are masked in the kernel.
//
// Bound on the H100 SXM at the LM's shape, (B, H, S, D) = (8, 16, 2048,
// 64) bf16 causal, 2.686e8 live score pairs: dq does 3 products of 2*D
// FLOP a pair (s, dp, dq), 1.03e11 FLOP = 0.104 ms at 989 TFLOP/s, against
// about 170 MB of bytes (q, k, v, do, lse, c read, dq written) = 0.051 ms
// at 3.35 TB/s; dk/dv does 4 (s, dp, dv, dk), 1.375e11 FLOP = 0.139 ms,
// against about 203 MB = 0.061 ms. Both are bound by operations.
//
// Design, and what it leaves on the table:
// * bf16: 4 warps of mma.sync m16n8k16 (bf16 in, f32 accumulate); each
//   warp owns 16 rows of the block's tile. The recomputed P and dS never
//   leave registers: the accumulators of one product are re-packed as the
//   A fragments of the next (as flash_fwd.cu feeds P into PV). The dk/dv
//   kernel works with keys as rows (S^T = K Q^T, dP^T = V dO^T) so that
//   P^T and dS^T land in the accumulators that feed dV += P^T dO and
//   dK += dS^T Q. Operands needed in both layouts (K in the dq kernel, Q
//   and dO in the dk/dv kernel) are kept once in shared memory and read
//   transposed with ldmatrix.trans. Left out: wgmma and TMA, a ring of
//   tiles with asynchronous copies (the tile loads here are synchronous),
//   warp specialisation, larger tiles, and one fused kernel with atomic dq
//   (which would make the gradients run-dependent).
// * f32: the same algorithm on the CUDA cores, one dot product per score
//   (mma has no f32 input type); exact in f32, for checking the math
//   without bf16 rounding. The LM runs in bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
// bf16: tensor cores through mma.sync

constexpr int kThreads = 128;
constexpr int kPad = 8;  // bf16 of row padding: conflict-free fragment reads

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in bits 0-15
  return *reinterpret_cast<uint32_t*>(&v);
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
      const uint32_t da[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
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

// dk/dv: one block per (64-key tile, head, batch); 4 warps x 16 key rows;
// query tiles of BQ (64 at D = 64, 32 at D = 128 to bound registers).
constexpr int kDkvBK = 64;

template <int D>
__host__ __device__ constexpr int dkv_bq() {
  return D == 64 ? 64 : 32;
}

template <int D>
__host__ __device__ constexpr int dkv_smem_bytes() {
  return (2 * kDkvBK + 2 * dkv_bq<D>()) * (D + kPad) * 2 +
         2 * dkv_bq<D>() * 4;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_bf16_kernel(Args a) {
  constexpr int ST = D + kPad;
  constexpr int BQ = dkv_bq<D>();
  extern __shared__ __align__(16) unsigned char smem[];
  auto* k_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* v_s = k_s + kDkvBK * ST;
  __nv_bfloat16* q_s = v_s + kDkvBK * ST;
  __nv_bfloat16* do_s = q_s + BQ * ST;
  auto* lse_s = reinterpret_cast<float*>(do_s + BQ * ST);  // log2 units
  float* c_s = lse_s + BQ;

  const int k0 = blockIdx.x * kDkvBK;
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
  auto* dkp = static_cast<__nv_bfloat16*>(a.o1) + bb * a.s1b + hh * a.s1h;
  auto* dvp = static_cast<__nv_bfloat16*>(a.o2) + bb * a.s2b + hh * a.s2h;

  // K and V stay in shared memory for the whole query loop; their A
  // fragments are read from there at each use.
  stage_rows<kDkvBK, D, ST>(k_s, kp, a.sks, k0, a.sk, tid);
  stage_rows<kDkvBK, D, ST>(v_s, vp, a.svs, k0, a.sk, tid);

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dt][e] = dv[dt][e] = 0.f;

  // The first query tile that can see this key tile: its last query
  // q_offset + q0 + BQ - 1 must reach the tile's first key.
  const long long k_lo = a.kv_offset + k0;
  int it0 = 0;
  if (a.causal) {
    const long long x = k_lo - a.q_offset;  // q0 + BQ - 1 >= x
    it0 = x <= 0 ? 0 : static_cast<int>(x / BQ);
  }
  const float sl2 = a.scale * kLog2e;
  const int nq = (a.sq + BQ - 1) / BQ;
  for (int it = it0; it < nq; ++it) {
    const int q0 = it * BQ;
    bool diag = false;
    if (a.causal) {
      bool live;
      causal_liveness<BQ, kDkvBK>(a.q_offset + q0, k_lo, live, diag);
      if (!live) continue;
    }
    const bool masked = diag || q0 + BQ > a.sq || k0 + kDkvBK > a.sk;
    __syncthreads();  // the previous tile's q_s/do_s reads are done
    stage_rows<BQ, D, ST>(q_s, qp, a.sqs, q0, a.sq, tid);
    stage_rows<BQ, D, ST>(do_s, dp_, a.sds, q0, a.sq, tid);
    for (int r = tid; r < BQ; r += kThreads) {
      lse_s[r] = safe_lse2(a, bh, q0 + r);
      c_s[r] = row_c(a, bh, q0 + r);
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x BQ queries per warp.
    float st[BQ / 8][4], dpt[BQ / 8][4];
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t kf[4], vf[4];
      load_a<ST>(kf, k_s, wr, kk, g, t);
      load_a<ST>(vf, v_s, wr, kk, g, t);
#pragma unroll
      for (int nt = 0; nt < BQ / 8; ++nt) {
        const int off = (nt * 8 + g) * ST + kk * 16 + 2 * t;
        mma16816(st[nt], kf, ld32(&q_s[off]), ld32(&q_s[off + 8]));
        mma16816(dpt[nt], vf, ld32(&do_s[off]), ld32(&do_s[off + 8]));
      }
    }

    // P^T and dS^T = P^T * (dP^T - c); the query is the column here.
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = nt * 8 + 2 * t + (e & 1);  // query within the tile
        float x = st[nt][e] * sl2;
        if (masked && pair_masked(a, q0 + qc, k0 + wr + g + 8 * (e >> 1)))
          x = -INFINITY;
        const float p = exp2f(x - lse_s[qc]);
        st[nt][e] = p;
        dpt[nt][e] = p * (dpt[nt][e] - c_s[qc]);
      }

    // dV += P^T dO and dK += dS^T Q: the accumulators re-packed as A
    // fragments over the queries; dO and Q read transposed.
    const int mat = lane / 8, r = lane % 8;
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(st[2 * kk][0], st[2 * kk][1]),
                              pack_bf16(st[2 * kk][2], st[2 * kk][3]),
                              pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]),
                              pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3])};
      const uint32_t da[4] = {
          pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]),
          pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]),
          pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
          pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3])};
      const int row_off = (kk * 16 + (mat & 1) * 8 + r) * ST;
#pragma unroll
      for (int dt = 0; dt < D / 8; dt += 2) {
        uint32_t b[4];
        ldsm_x4_t(b, &do_s[row_off + (dt + (mat >> 1)) * 8]);
        mma16816(dv[dt], pa, b[0], b[1]);
        mma16816(dv[dt + 1], pa, b[2], b[3]);
        ldsm_x4_t(b, &q_s[row_off + (dt + (mat >> 1)) * 8]);
        mma16816(dk[dt], da, b[0], b[1]);
        mma16816(dk[dt + 1], da, b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = k0 + wr + g + 8 * hr;
    if (row < a.sk) {
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        *reinterpret_cast<__nv_bfloat162*>(dkp + row * a.s1s + dt * 8 +
                                           2 * t) =
            __floats2bfloat162_rn(dk[dt][2 * hr] * a.scale,
                                  dk[dt][2 * hr + 1] * a.scale);
        *reinterpret_cast<__nv_bfloat162*>(dvp + row * a.s2s + dt * 8 +
                                           2 * t) =
            __floats2bfloat162_rn(dv[dt][2 * hr], dv[dt][2 * hr + 1]);
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
cudaError_t launch_dkv(const Args& a, int b, int dtype, cudaStream_t st) {
  if (dtype == 1) {
    constexpr int bytes = dkv_smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_bf16_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    dim3 grid((a.sk + kDkvBK - 1) / kDkvBK, a.h, b);
    flash_bwd_dkv_bf16_kernel<D><<<grid, kThreads, bytes, st>>>(a);
  } else {
    dim3 grid((a.sk + kSRows - 1) / kSRows, a.h, b);
    flash_bwd_dkv_f32_kernel<D><<<grid, kThreads, 0, st>>>(a);
  }
  return cudaGetLastError();
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
  const cudaError_t err = d == 64 ? launch_dkv<64>(a, b, dtype, st)
                                  : launch_dkv<128>(a, b, dtype, st);
  return static_cast<int>(err);
}

const char* flash_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
