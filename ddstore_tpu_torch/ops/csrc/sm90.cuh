// Raw-PTX building blocks for Hopper (sm_90a) kernels, shared by
// flash_fwd.cu and flash_bwd.cu: mbarriers, TMA tile loads, 128-byte
// swizzled wgmma shared-memory descriptors, the wgmma.mma_async shapes the
// kernels use (bf16 or fp16 in, f32 accumulate; and tf32 in for the f32
// kernels, with the rounding to tf32 and the three-product split), the
// f64 mma.sync of the FP64 tensor cores (the f32 dq kernel's dP),
// setmaxnreg, named barriers and the proxy fence for operands written by
// threads, the element types Bf16 and F16, the launch grid folded onto x
// (GridPos, Fold, folded_blocks), and on the host the tensor-map encoders
// (16-bit rows, f32 tiles, thin f32 rows). No CuTe/CUTLASS: each
// source builds in seconds.
//
// Shared-memory tiles are what a TMA load with CU_TENSOR_MAP_SWIZZLE_128B
// writes: rows of 64 16-bit elements (128 bytes), the 16-byte chunks of
// row r XORed with r % 8, each box 1024-byte aligned. A tile wider than 64
// columns (D = 128, 256) is two or four such boxes, one after the other.
// A tile that threads write for a wgmma to read (the dk/dv kernel's P^T and
// dS^T, the dq kernel's dS, at d > 128) takes the same layout
// (sw128_offset). The tensor map's feature dim is the operand's true head
// dim d (a multiple of 8, at most the tile's width; past 256, the whole
// width, read a chunk at a time), so TMA fills the columns past d with
// zeros: zero columns of Q and K leave every score as it is, and zero
// columns of V, dO and Q give zero columns of O, dQ, dK and dV, which the
// kernels' stores skip. Descriptors:
// * K-major (the contracted dimension along a row, as Q and K rows are in
//   Q K^T): SBO = 1024 bytes (8 rows), LBO unused; the k16 step inside a
//   box is +32 bytes on the start address, and steps 4..7 of D = 128 start
//   in the second box (steps 4 j..4 j + 3 in box j).
// * MN-major (the contracted dimension down the rows, as V's keys are in
//   P V): SBO = 1024 bytes (8 rows of k), LBO = the bytes from one 64-column
//   box to the next along N; the k16 step is +16 rows = 2048 bytes.
//
// Host side: cuTensorMapEncodeTiled is taken from the driver through
// cudaGetDriverEntryPoint(ByVersion), so nothing links against libcuda.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

// ---------------------------------------------------------------------------
// device

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Division by a divisor d >= 1 fixed for a launch, of dividends in [0,
// 2^31), as one multiply-high and a shift: q = umulhi(x, m) >> s with m =
// ceil(2^(31 + l) / d), s = l - 1, l = ceil(log2 d) (Granlund and
// Montgomery's round-up method); m = 0 marks d = 1 (q = x). fast_div
// computes m and s on the host.
struct FastDiv {
  int d;
  unsigned m, s;
};

__device__ __forceinline__ int div_by(int x, const FastDiv& f) {
  return f.m == 0u ? x
                   : static_cast<int>(
                         __umulhi(static_cast<unsigned>(x), f.m) >> f.s);
}

// The counts a block decodes its place on a grid folded onto x from: the
// tile blocks of a head (a query or key tile, times the chunks of the
// output past 256), B * H, and H.
struct Fold {
  FastDiv tiles, nbh, heads;
};

// A block's place on a launch grid folded onto x: tile block t of head h
// of batch b.
struct GridPos {
  int t, b, h;
};

// x = t * nbh + b * heads + h: every (batch, head) of tile block 0, then
// of block 1, ... -- the order in which blocks of a grid (heads, B,
// tiles) on (x, y, z) are dispatched.
__device__ __forceinline__ GridPos tile_major(const Fold& f) {
  const int x = static_cast<int>(blockIdx.x);
  const int t = div_by(x, f.nbh), bh = x - t * f.nbh.d;
  const int b = div_by(bh, f.heads);
  return {t, b, bh - b * f.heads.d};
}

// x = (b * heads + h) * tiles + t: a head's tile blocks side by side, the
// order of a grid (tiles, heads, B) on (x, y, z).
__device__ __forceinline__ GridPos head_major(const Fold& f) {
  const int x = static_cast<int>(blockIdx.x);
  const int bh = div_by(x, f.tiles), b = div_by(bh, f.heads);
  return {x - bh * f.tiles.d, b, bh - b * f.heads.d};
}

// The dynamic shared memory rounded up to 1024 bytes (the swizzle atom);
// kernels allocate 1024 bytes of slack for it.
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA traffic on this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Spin until the phase of parity `parity` has completed (a fresh barrier
// is in phase 0, so waiting on parity 1 returns at once).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: one box of a 4-D (or 2-D) tensor map into shared memory, completing
// `bytes` of the barrier's expected transaction count. Coordinates are in
// elements, innermost first; boxes past the tensor's edge are zero-filled.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
      "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// The 64-bit wgmma descriptor of a 128-byte-swizzled tile at `p`.
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  const uint32_t a = smem_u32(p);
  return static_cast<uint64_t>((a & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32) |
         (1ull << 62);  // layout type 1: 128-byte swizzle
}

// K-major operand (rows of the tile run along M or N).
__device__ __forceinline__ uint64_t desc_k(const void* p) {
  return desc_sw128(p, 16, 1024);
}

// MN-major operand (rows of the tile run along K); `box_bytes` apart are
// the 64-column boxes along N.
__device__ __forceinline__ uint64_t desc_mn(const void* p,
                                            uint32_t box_bytes) {
  return desc_sw128(p, box_bytes, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins accumulator registers in place across the asynchronous wgmma: the
// compiler may not move their reads or writes over this point.
template <int K>
__device__ __forceinline__ void fence_regs(float (&r)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Makes this thread's generic-proxy writes to shared memory visible to
// the async proxy (a wgmma that reads them as an operand).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barrier `id` (1..15; 0 is __syncthreads) over `threads` threads
// of the block, a multiple of 32.
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Byte offset of the 16-bit element (r, c) in a tile of rows of 64
// elements laid out as a TMA load with the 128-byte swizzle writes them
// (the 16-byte chunks of row r XORed with r % 8); `c` even, so that two
// adjacent elements lie in one 32-bit word.
__device__ __forceinline__ uint32_t sw128_offset(int r, int c) {
  return r * 128 + ((((c >> 3) ^ (r & 7)) << 4) | ((c & 7) << 1));
}

template <uint32_t R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <uint32_t R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// 2^x by the SFU (ex2.approx.ftz: about 2 ulp; 2^-inf = +0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The 16-bit element types of the tensor-core kernels. Each names its
// storage type and pair, the pack of two floats (round to nearest even,
// by the conversion intrinsics only), the TMA data type, and kF16, which
// picks the PTX type of the wgmma strings (".bf16.bf16" or
// ".f16.f16", both with f32 accumulation at every shape used here; see
// SM90_TYPED). fp16 and bf16 share every bit layout the kernels rest on:
// 16-bit elements, the 128-byte swizzle and the fragments. So a
// kernel templated on one runs the other with the same tiles, barriers and
// setmaxnreg budgets.
struct Bf16 {
  using T = __nv_bfloat16;
  using T2 = __nv_bfloat162;
  static constexpr bool kF16 = false;
  static constexpr CUtensorMapDataType kTma = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static __device__ __forceinline__ T2 pack2(float lo, float hi) {
    return __floats2bfloat162_rn(lo, hi);  // .x (lo) in bits 0-15
  }
};

struct F16 {
  using T = __half;
  using T2 = __half2;
  static constexpr bool kF16 = true;
  static constexpr CUtensorMapDataType kTma = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  static __device__ __forceinline__ T2 pack2(float lo, float hi) {
    return __floats2half2_rn(lo, hi);  // .x (lo) in bits 0-15
  }
};

// Expands the asm statement macro M with E's PTX type name.
#define SM90_TYPED(E, M)     \
  do {                       \
    if constexpr (E::kF16) { \
      M("f16");              \
    } else {                 \
      M("bf16");             \
    }                        \
  } while (0)

// Two floats rounded to E and packed into one register, lo in bits 0-15.
template <class E>
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  typename E::T2 v = E::pack2(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// wgmma.mma_async m64nNk16, E (bf16 or fp16) in, f32 accumulate, over one
// warpgroup. d holds N / 2 floats a thread: d[4 j + e] is row 16 w + g + 8
// (e / 2), column 8 j + 2 t + (e % 2) of the 64 x N tile, for warp w of
// the warpgroup, g = lane / 4, t = lane % 4 (a 16 x 8 fragment layout,
// N / 8 times). scale_d = 0 overwrites d, 1 accumulates.
// * ss: a and b from shared memory, both K-major (transpose flags 0);
// * rs_mn: a from registers, the m16n8k16 A fragment of each warp's 16 rows
//   ({row g, k 2t..2t+1}, {g + 8, 2t..}, {g, 2t + 8..}, {g + 8, 2t + 8..}
//   as packed pairs of E), b MN-major (transpose flag 1); only the widths
//   the kernels use (N = D: 64, 128 and 256);
// * ss_mn: a from shared memory K-major, b MN-major (N = 128 only).
template <int N, class E>
struct Wgmma;

template <class E>
struct Wgmma<32, E> {
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t da,
                                            uint64_t db, int scale_d) {
#define SM90_ASM(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}," \
      " %16, %17, p, 1, 1, 0, 0;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
        "+f"(d[15]) \
      : "l"(da), "l"(db), "r"(scale_d))
    SM90_TYPED(E, SM90_ASM);
#undef SM90_ASM
  }
};

template <class E>
struct Wgmma<64, E> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
#define SM90_ASM(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}," \
      " %32, %33, p, 1, 1, 0, 0;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
        "+f"(d[30]), "+f"(d[31]) \
      : "l"(da), "l"(db), "r"(scale_d))
    SM90_TYPED(E, SM90_ASM);
#undef SM90_ASM
  }
  static __device__ __forceinline__ void rs_mn(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
#define SM90_ASM(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}," \
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
        "+f"(d[30]), "+f"(d[31]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))
    SM90_TYPED(E, SM90_ASM);
#undef SM90_ASM
  }
};

template <class E>
struct Wgmma<128, E> {
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da,
                                            uint64_t db, int scale_d) {
#define SM90_ASM(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31," \
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47," \
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}," \
      " %64, %65, p, 1, 1, 0, 0;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "l"(da), "l"(db), "r"(scale_d))
    SM90_TYPED(E, SM90_ASM);
#undef SM90_ASM
  }
  static __device__ __forceinline__ void rs_mn(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
#define SM90_ASM(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31," \
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47," \
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}," \
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))
    SM90_TYPED(E, SM90_ASM);
#undef SM90_ASM
  }
  // a from shared memory K-major, b MN-major (transpose flags 0, 1): the
  // dk/dv kernel's P^T dO and dS^T Q and the dq kernel's dS K at d > 128,
  // P^T, dS^T and dS staged in shared memory.
  static __device__ __forceinline__ void ss_mn(float (&d)[64], uint64_t da,
                                               uint64_t db, int scale_d) {
#define SM90_ASM(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31," \
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47," \
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}," \
      " %64, %65, p, 1, 1, 0, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "l"(da), "l"(db), "r"(scale_d))
    SM90_TYPED(E, SM90_ASM);
#undef SM90_ASM
  }
};

template <class E>
struct Wgmma<256, E> {
  static __device__ __forceinline__ void rs_mn(float (&d)[128],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
#define SM90_ASM(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31," \
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47," \
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63," \
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79," \
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95," \
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111," \
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}," \
      " {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), \
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), \
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), \
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), \
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), \
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), \
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), \
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), \
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), \
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), \
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), \
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))
    SM90_TYPED(E, SM90_ASM);
#undef SM90_ASM
  }
};

// ---------------------------------------------------------------------------
// TF32 (the f32 kernels' three-product split)

// x rounded to TF32 (10 explicit mantissa bits, round to nearest, ties away
// from zero), as an f32 whose 13 low mantissa bits are zero: what the
// tensor core reads of it, exactly.
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// Byte offset of the f32 element (r, c) in a tile of rows of 32 floats
// laid out as a TMA load with the 128-byte swizzle writes them (the
// 16-byte chunks of row r XORed with r % 8), from a 1024-byte aligned base.
__device__ __forceinline__ uint32_t sw128_f32_offset(int r, int c) {
  return r * 128 + ((((c >> 2) ^ (r & 7)) << 4) | ((c & 3) << 2));
}

// wgmma.mma_async m64nNk8, tf32 in, f32 accumulate, over one warpgroup. tf32
// has no transpose flags: both operands are K-major, in rows of 32 floats
// (128 bytes, the 128-byte swizzle), so a k8 step is +32 bytes on the start
// address as a k16 step of a 16-bit tile is (desc_k). d as in Wgmma.
// * ss: a and b from shared memory (N = 32 and 64);
// * rs: a from registers, each warp's 16 rows as the m16n8k8 .tf32 A
//   fragment: {row g, k t}, {g + 8, t}, {g, t + 4}, {g + 8, t + 4}, for
//   g = lane / 4, t = lane % 4 (N = 32).
template <int N>
struct Tf32;

template <>
struct Tf32<32> {
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  static __device__ __forceinline__ void rs(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  }
};

template <>
struct Tf32<64> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

// The 3xTF32 products of the f32 kernels (flash_fwd.cu, flash_bwd.cu).
//
// The tensor cores round each k-step's sum into the accumulator toward
// zero, about an ulp of the running sum and always the same way: summed in
// one accumulator over the 64 k-steps of d = 512, dQ's rows missed the f32
// tolerance of 1e-4. So each chunk of at most 8 k-steps (32 features of a
// score, 32 or 64 keys or queries of an output) is summed afresh on the
// tensor cores, the small products (hi lo, lo hi) first, then hi hi, and
// added into the running f32 sum on the CUDA cores (tf32_add).

constexpr int kTfBox = 4096;  // a transposed tile's box: 32 rows x 32 floats

// The position of column k of a transposed tile along its contracted dim.
// A TF32 A fragment holds k t and t + 4 of each group of 8 where the f32
// accumulator it is formed from holds columns 2 t and 2 t + 1 (columns are
// keys in P V and dS K, queries in P^T dO and dS^T Q), so the transposed B
// tiles store each group of 8 in the order 0, 2, 4, 6, 1, 3, 5, 7 and the
// accumulators feed the products as they are.
__host__ __device__ __forceinline__ int tf32_kpos(int k) {
  return (k & ~7) | ((k & 1) << 2) | ((k & 7) >> 1);
}

// The A fragments of an accumulator of m64n32 or m64n64 (d[4 j + e]: row
// g + 8 (e / 2), column 8 j + 2 t + e % 2), hi and lo: k-step kk is
// columns 8 kk..8 kk + 7, its fragment {d[4 kk], d[4 kk + 2], d[4 kk + 1],
// d[4 kk + 3]} (tf32_kpos). Formed before the products' fence, so that no
// instruction defines a register a product reads while it runs.
template <int KS>
__device__ __forceinline__ void tf32_frags(uint32_t (&fh)[KS][4],
                                           uint32_t (&fl)[KS][4],
                                           const float (&d)[4 * KS]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x = d[4 * kk + ((r & 1) << 1) + (r >> 1)];
      const float h = tf32_rna(x);
      fh[kk][r] = __float_as_uint(h);
      fl[kk][r] = __float_as_uint(tf32_rna(x - h));
    }
}

// acc = A B^T over one 32-feature chunk: A and B K-major tiles with hi and
// lo parts, rows of 32 floats (a k-step is +32 bytes).
template <int N>
__device__ __forceinline__ void tf32_ss_chunk(float (&acc)[N / 2],
                                              const uint8_t* ah,
                                              const uint8_t* al,
                                              const uint8_t* bh,
                                              const uint8_t* bl) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int o = 32 * kk;
    Tf32<N>::ss(acc, desc_k(ah + o), desc_k(bl + o), kk > 0);
    Tf32<N>::ss(acc, desc_k(al + o), desc_k(bh + o), 1);
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    Tf32<N>::ss(acc, desc_k(ah + 32 * kk), desc_k(bh + 32 * kk), 1);
}

// acc = A B over K = 8 KS: A the fragments of tf32_frags, B a transposed
// tile (hi, lo) of 32 rows, its k-steps 32 bytes apart within a box,
// boxes kTfBox apart.
template <int KS>
__device__ __forceinline__ void tf32_rs(float (&acc)[16],
                                        const uint32_t (&fh)[KS][4],
                                        const uint32_t (&fl)[KS][4],
                                        const uint8_t* bh, const uint8_t* bl) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int o = (kk / 4) * kTfBox + 32 * (kk % 4);
    Tf32<32>::rs(acc, fl[kk], desc_k(bh + o), kk > 0);
    Tf32<32>::rs(acc, fh[kk], desc_k(bl + o), 1);
  }
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    Tf32<32>::rs(acc, fh[kk], desc_k(bh + (kk / 4) * kTfBox + 32 * (kk % 4)),
                 1);
}

template <int K>
__device__ __forceinline__ void tf32_add(float (&sum)[K],
                                         const float (&x)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) sum[i] += x[i];
}

// ---------------------------------------------------------------------------
// FP64 tensor cores (the f32 dq kernel's dP)

// d += a b over one warp: mma.sync m16n8k4 in f64 (DMMA, at the FP64 CUDA
// cores' 67 TFLOP/s), for g = lane / 4, t = lane % 4: a0 = A[g][t], a1 =
// A[g + 8][t], b = B[t][g], d = {D[g][2 t], D[g][2 t + 1], D[g + 8][2 t],
// D[g + 8][2 t + 1]}, the m16n8 accumulator layout of wgmma's (Wgmma's d,
// 8 columns at a time). A product of two doubles converted from floats is
// exact (24 + 24 significant bits < 53), so only the sums round, at 2^-53.
__device__ __forceinline__ void dmma_m16n8k4(double (&d)[4], double a0,
                                             double a1, double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b));
}

// ---------------------------------------------------------------------------
// host

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// Error codes the C entries return beside CUDA's own: kErrGrid when a
// launch grid would pass grid x's 2^31 - 1 blocks (folded_blocks) or B * H
// passes 2^31 - 1, kErrNoEncoder when the driver does not export
// cuTensorMapEncodeTiled, kErrEncode + r when it refuses a map with
// CUresult r.
constexpr int kErrGrid = 9998;
constexpr int kErrNoEncoder = 9999;
constexpr int kErrEncode = 10000;

// The blocks of a launch grid folded onto x (tile_major, head_major): nt
// blocks for each of b * h (batch, head) pairs, or 0 when they pass
// grid x's 2^31 - 1 (the caller then returns kErrGrid). Grid y and z stay
// 1: CUDA caps them at 65,535, which B, H and a long axis's tile count
// each pass.
inline unsigned folded_blocks(long long nt, int b, int h) {
  const long long n = nt * b * h;
  return n <= 0x7fffffffLL ? static_cast<unsigned>(n) : 0u;
}

inline FastDiv fast_div(int d) {
  int l = 0;
  while ((1LL << l) < d) ++l;
  if (l == 0) return {1, 0u, 0u};
  return {d, static_cast<unsigned>(((1ULL << (31 + l)) + d - 1) / d),
          static_cast<unsigned>(l - 1)};
}

// The Fold of a grid of nt tile blocks for each of b * h heads (within
// folded_blocks' limit).
inline Fold fold(long long nt, int b, int h) {
  return {fast_div(static_cast<int>(nt)), fast_div(b * h), fast_div(h)};
}

inline EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A (B, H, S, d) operand of element type E (bf16 or fp16) with element
// strides (sb, sh, ss) and unit feature stride, read in boxes of 64
// features x `rows` rows with the 128-byte swizzle; features past d (d <
// 64, or a second box past d) are zero-filled. Dims innermost first: (d,
// S, H, B). Returns 0 or an error code as above.
template <class E>
inline int encode_rows(CUtensorMap* map, const void* base, int d, int s,
                       int h, int b, long long ss, long long sh, long long sb,
                       int rows) {
  const EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(s > 0 ? s : 1),
                              static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r =
      fn(map, E::kTma, 4, const_cast<void*>(base),
         dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode + static_cast<int>(r);
}

// A contiguous f32 (rows, n) tensor read in boxes of `box` elements of one
// row, unswizzled (the thin lse and c rows of the backward).
inline int encode_f32_rows(CUtensorMap* map, const void* base, int n,
                           long long rows, int box) {
  const EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(n) * 4};
  const cuuint32_t boxd[2] = {static_cast<cuuint32_t>(box), 1};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base),
         dims, strides, boxd, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode + static_cast<int>(r);
}

// A (B, H, S, d) f32 operand with element strides (sb, sh, ss) and unit
// feature stride, read in boxes of 32 features (128 bytes) x `rows` rows
// with the 128-byte swizzle (the 3xTF32 backward kernels); features past d
// and rows past S are zero-filled. Returns 0 or an error code as above.
inline int encode_f32_tile(CUtensorMap* map, const void* base, int d, int s,
                           int h, int b, long long ss, long long sh,
                           long long sb, int rows) {
  const EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(s > 0 ? s : 1),
                              static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 4,
                                 static_cast<cuuint64_t>(sh) * 4,
                                 static_cast<cuuint64_t>(sb) * 4};
  const cuuint32_t box[4] = {32, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(base),
         dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode + static_cast<int>(r);
}

inline const char* error_string(int code) {
  if (code == kErrGrid)
    return "the launch grid passes 2^31 - 1 blocks (B * H x the tile "
           "blocks of a head), grid x's limit";
  if (code == kErrNoEncoder)
    return "the driver does not export cuTensorMapEncodeTiled";
  if (code >= kErrEncode)
    return "cuTensorMapEncodeTiled refused a tensor map (code - 10000 is "
           "its CUresult)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // namespace sm90
