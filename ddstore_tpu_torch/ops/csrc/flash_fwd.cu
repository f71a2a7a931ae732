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
// At the LM's shapes (S = 2048, D = 64) the FLOPs bound it.
//
// Design, and what it leaves on the table:
// * bf16: one block of 4 warps takes 64 query rows (16 per warp) and loops
//   over 64-key tiles staged in shared memory (V stored transposed so that
//   its mma B fragments are contiguous words). QK^T and PV run on the
//   tensor cores with mma.sync m16n8k16 (bf16 in, f32 accumulate); P stays
//   in registers, its S fragments re-packed as the A fragments of PV.
//   Left out: wgmma and TMA (Hopper's full tensor-core rate), a ring of
//   tiles with asynchronous copies overlapping the math, warp
//   specialisation, larger tiles, and exp2 via FMA tricks.
// * f32: the same algorithm on the CUDA cores (16 query rows x 32-key
//   tiles per block, one dot product per score), exact in f32; mma has no
//   f32 input type, and the LM runs in bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
// bf16: tensor cores through mma.sync

constexpr int kBQ = 64;  // query rows per block (4 warps x 16)
constexpr int kBK = 64;  // keys per tile
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

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_bf16_kernel(Args a) {
  constexpr int KS = D + kPad;    // row stride of k_s (and of the Q stage)
  constexpr int VS = kBK + kPad;  // row stride of vt_s (V transposed)
  constexpr int CPR = D / 8;      // 16-byte chunks per row
  __shared__ __align__(16) __nv_bfloat16 k_s[kBK * KS];
  __shared__ __align__(16) __nv_bfloat16 vt_s[D * VS];

  const int q0 = blockIdx.x * kBQ;
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // mma group and thread-in-group
  const int wr = warp * 16;              // this warp's first row in the tile
  const __nv_bfloat16* qp =
      static_cast<const __nv_bfloat16*>(a.q) + bb * a.sqb + hh * a.sqh;
  const __nv_bfloat16* kp =
      static_cast<const __nv_bfloat16*>(a.k) + bb * a.skb + hh * a.skh;
  const __nv_bfloat16* vp =
      static_cast<const __nv_bfloat16*>(a.v) + bb * a.svb + hh * a.svh;
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(a.o) + bb * a.sob +
                      hh * a.soh;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  // Stage the Q tile through k_s (rows past Sq are zero) and keep this
  // warp's 16 rows as mma A fragments for the whole key loop.
  for (int c = tid; c < kBQ * CPR; c += kThreads) {
    const int r = c / CPR, cc = c % CPR;
    uint4 val = zero;
    if (q0 + r < a.sq)
      val = *reinterpret_cast<const uint4*>(qp + (q0 + r) * a.sqs + cc * 8);
    *reinterpret_cast<uint4*>(&k_s[r * KS + cc * 8]) = val;
  }
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    qf[kk][0] = ld32(&k_s[(wr + g) * KS + kk * 16 + 2 * t]);
    qf[kk][1] = ld32(&k_s[(wr + g + 8) * KS + kk * 16 + 2 * t]);
    qf[kk][2] = ld32(&k_s[(wr + g) * KS + kk * 16 + 8 + 2 * t]);
    qf[kk][3] = ld32(&k_s[(wr + g + 8) * KS + kk * 16 + 8 + 2 * t]);
  }
  __syncthreads();

  // Rows g and g+8 of this warp's 16: running max (log2 units) and this
  // thread's share of the running denominator (summed over the 4 threads
  // of a row at the end).
  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

  const float sl2 = a.scale * kLog2e;
  const long long q_lo = a.q_offset + q0;
  const int nk = (a.sk + kBK - 1) / kBK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK;
    bool diag = false;
    if (a.causal) {
      bool live;
      causal_liveness<kBQ, kBK>(q_lo, a.kv_offset + k0, live, diag);
      if (!live) break;  // every later tile lies further in the future
    }
    const bool masked = diag || (k0 + kBK > a.sk);

    // K rows as they are; V transposed (keys contiguous per feature).
    // Keys past Sk are zero: their p is 0, and 0 * garbage could be NaN.
    for (int c = tid; c < kBK * CPR; c += kThreads) {
      const int r = c / CPR, cc = c % CPR;
      uint4 val = zero;
      if (k0 + r < a.sk)
        val = *reinterpret_cast<const uint4*>(kp + (k0 + r) * a.sks + cc * 8);
      *reinterpret_cast<uint4*>(&k_s[r * KS + cc * 8]) = val;
    }
    for (int c = tid; c < kBK * CPR; c += kThreads) {
      const int r = c % kBK, cc = c / kBK;
      uint4 val = zero;
      if (k0 + r < a.sk)
        val = *reinterpret_cast<const uint4*>(vp + (k0 + r) * a.svs + cc * 8);
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int i = 0; i < 8; ++i) vt_s[(cc * 8 + i) * VS + r] = ve[i];
    }
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys per warp, 8 n-tiles of 8 keys.
    float s[kBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt)
        mma16816(s[nt], qf[kk], ld32(&k_s[(nt * 8 + g) * KS + kk * 16 + 2 * t]),
                 ld32(&k_s[(nt * 8 + g) * KS + kk * 16 + 8 + 2 * t]));

    // Scale into log2 units; mask only diagonal and ragged tiles.
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] *= sl2;
        if (masked) {
          const int row = q0 + wr + g + (e >> 1) * 8;
          const int col = k0 + nt * 8 + 2 * t + (e & 1);
          if (col >= a.sk ||
              (a.causal && a.kv_offset + col > a.q_offset + row))
            s[nt][e] = -INFINITY;
        }
      }

    // Online softmax for rows g (e = 0, 1) and g + 8 (e = 2, 3).
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * hr], s[nt][2 * hr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[hr], mx);
      // Rows masked so far keep m = -inf; subtracting 0 instead keeps
      // exp2(-inf - 0) = 0 exact, with no inf - inf.
      const float safe = m_new == -INFINITY ? 0.f : m_new;
      const float corr = m_r[hr] == -INFINITY ? 0.f : exp2f(m_r[hr] - safe);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
        for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
          const float p = exp2f(s[nt][e] - safe);
          s[nt][e] = p;
          sum += p;
        }
      l_r[hr] = l_r[hr] * corr + sum;
      m_r[hr] = m_new;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        acc[dt][2 * hr] *= corr;
        acc[dt][2 * hr + 1] *= corr;
      }
    }

    // acc += P V: the S accumulators of n-tiles 2kk, 2kk+1 are exactly the
    // A fragment of keys [16kk, 16kk + 16).
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
        mma16816(acc[dt], pa,
                 ld32(&vt_s[(dt * 8 + g) * VS + kk * 16 + 2 * t]),
                 ld32(&vt_s[(dt * 8 + g) * VS + kk * 16 + 8 + 2 * t]));
    }
    __syncthreads();  // the next tile overwrites k_s and vt_s
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float l = l_r[hr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float lc = fmaxf(l, 1e-30f);
    const float inv = 1.f / lc;
    const int row = q0 + wr + g + 8 * hr;
    if (row < a.sq) {
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
        *reinterpret_cast<__nv_bfloat162*>(op + row * a.sos + dt * 8 +
                                           2 * t) =
            __floats2bfloat162_rn(acc[dt][2 * hr] * inv,
                                  acc[dt][2 * hr + 1] * inv);
      if (t == 0)
        a.lse[(static_cast<long long>(bb) * a.h + hh) * a.sq + row] =
            m_r[hr] == -INFINITY ? -INFINITY : m_r[hr] * kLn2 + logf(lc);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores

constexpr int kSBQ = 16;  // query rows per block
constexpr int kSBK = 32;  // keys per tile
// 128 threads: thread = (row r = tid / 8, lane-in-row c8 = tid % 8); a row's
// 8 threads are adjacent lanes of one warp.

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32_kernel(Args a) {
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

  for (int e = tid; e < kSBQ * D; e += kThreads) {
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
    for (int e = tid; e < kSBK * D; e += kThreads) {
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
cudaError_t launch(const Args& a, int b, int dtype, cudaStream_t stream) {
  if (dtype == 1) {
    dim3 grid((a.sq + kBQ - 1) / kBQ, a.h, b);
    flash_fwd_bf16_kernel<D><<<grid, kThreads, 0, stream>>>(a);
  } else {
    dim3 grid((a.sq + kSBQ - 1) / kSBQ, a.h, b);
    flash_fwd_f32_kernel<D><<<grid, kThreads, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; d in {64, 128}. Strides are in
// elements. Returns the CUDA error of the launch (0 = success).
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
  cudaError_t err = d == 64 ? launch<64>(a, b, dtype, st)
                            : launch<128>(a, b, dtype, st);
  return static_cast<int>(err);
}

const char* flash_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
