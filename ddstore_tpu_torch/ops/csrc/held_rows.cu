// The row passes of the held-expert layer (models/moe.py RoutedExperts,
// wrapped by ops/held.py), in bf16 with f32 arithmetic. They replace no
// kernel of the JAX package, which has no held-expert layer; they exist so
// that the layer's step never waits on the host. The grouped products run
// over buffers of a fixed number of rows (tokens x min(top_k, held), the
// most a dropless layer can send here), of which the held assignments, in
// expert order, fill the first n = offs[groups - 1]; n stays on the device.
// Each pass touches those n rows alone:
//
//   held_scatter:     xs[pos[t, j]] = x[t] for every held choice j of token
//                     t (pos[t, j] < 0: not held here), one block a token;
//   held_combine:     out[t] = sum over t's held choices of gate[t, j] *
//                     ys[pos[t, j]] (gate 1 without gates), in f32, stored
//                     f32 or bf16, one block a token, in choice order;
//   held_combine_bwd: dys[pos[t, j]] = bf16(gate[t, j] * dy[t]) and
//                     dgates[t, j] = dy[t] . ys[pos[t, j]] (0 where not
//                     held), one block a token;
//   held_swiglu:      act[r] = silu(gate) * up of gu[r] = [gate | up];
//   held_swiglu_bwd:  dgu[r] from gu[r] and d act[r];
//
// the last two walk rows r < n over a fixed grid. Every pass is bound by
// device memory (a few flops a byte): the token passes read each token's
// row once and each held row once; rows past n are never read or written,
// so a pass costs the assignments that came here, not the buffer's size.
// Rows are moved 8 bf16 (16 bytes) a thread: d and h are multiples of 8,
// and the buffers 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxTopK = 16;
constexpr int kTokenThreads = 256;
constexpr int kRowThreads = 128;
// the row passes' grid: 8 blocks on each of the H100's 132 SMs
constexpr int kRowBlocks = 1056;

__device__ __forceinline__ void load8(const bf16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(bf16* p, const float* in) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void store8(float* p, const float* in) {
  *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(in[4], in[5], in[6],
                                                   in[7]);
}

__device__ __forceinline__ float sigmoid(float g) {
  return 1.f / (1.f + expf(-g));
}

// token t's choices into shared memory: their rows (-1: not held) and
// gates (1 without gates)
__device__ __forceinline__ void load_choices(const long long* pos,
                                             const float* gates, long long t,
                                             int k, long long* sp,
                                             float* sg) {
  if (threadIdx.x < k) {
    sp[threadIdx.x] = pos[t * k + threadIdx.x];
    sg[threadIdx.x] = gates ? gates[t * k + threadIdx.x] : 1.f;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kTokenThreads)
    held_scatter_kernel(const bf16* x, const long long* pos, bf16* xs, int k,
                        int d) {
  __shared__ long long sp[kMaxTopK];
  __shared__ float sg[kMaxTopK];
  const long long t = blockIdx.x;
  load_choices(pos, nullptr, t, k, sp, sg);
  for (int c = threadIdx.x * 8; c < d; c += blockDim.x * 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(x + t * d + c);
    for (int j = 0; j < k; ++j)
      if (sp[j] >= 0) *reinterpret_cast<uint4*>(xs + sp[j] * d + c) = raw;
  }
}

template <typename Out>
__global__ void __launch_bounds__(kTokenThreads)
    held_combine_kernel(const bf16* ys, const long long* pos,
                        const float* gates, Out* out, int k, int d) {
  __shared__ long long sp[kMaxTopK];
  __shared__ float sg[kMaxTopK];
  const long long t = blockIdx.x;
  load_choices(pos, gates, t, k, sp, sg);
  for (int c = threadIdx.x * 8; c < d; c += blockDim.x * 8) {
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int j = 0; j < k; ++j) {
      if (sp[j] < 0) continue;
      float v[8];
      load8(ys + sp[j] * d + c, v);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] += sg[j] * v[i];
    }
    store8(out + t * d + c, acc);
  }
}

__global__ void __launch_bounds__(kTokenThreads)
    held_combine_bwd_kernel(const float* dy, const bf16* ys,
                            const long long* pos, const float* gates,
                            bf16* dys, float* dgates, int k, int d) {
  __shared__ long long sp[kMaxTopK];
  __shared__ float sg[kMaxTopK];
  __shared__ float part[kMaxTopK][kTokenThreads / 32];
  const long long t = blockIdx.x;
  load_choices(pos, gates, t, k, sp, sg);
  float dot[kMaxTopK];
#pragma unroll
  for (int j = 0; j < kMaxTopK; ++j) dot[j] = 0.f;
  for (int c = threadIdx.x * 8; c < d; c += blockDim.x * 8) {
    float g[8];
    load8(dy + t * d + c, g);
#pragma unroll
    for (int j = 0; j < kMaxTopK; ++j) {
      if (j >= k || sp[j] < 0) continue;
      float v[8], s[8];
      load8(ys + sp[j] * d + c, v);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        dot[j] += g[i] * v[i];
        s[i] = sg[j] * g[i];
      }
      store8(dys + sp[j] * d + c, s);
    }
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < kMaxTopK; ++j) {
    float v = dot[j];
#pragma unroll
    for (int o = 16; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) part[j][warp] = v;
  }
  __syncthreads();
  if (threadIdx.x < k) {
    float s = 0.f;
    for (int w = 0; w < kTokenThreads / 32; ++w) s += part[threadIdx.x][w];
    dgates[t * k + threadIdx.x] = sp[threadIdx.x] >= 0 ? s : 0.f;
  }
}

__global__ void __launch_bounds__(kRowThreads)
    held_swiglu_kernel(const bf16* gu, const int* offs, int groups,
                       bf16* act, int h) {
  const long long n = offs[groups - 1];
  for (long long r = blockIdx.x; r < n; r += gridDim.x) {
    const bf16* row = gu + r * 2 * h;
    for (int c = threadIdx.x * 8; c < h; c += blockDim.x * 8) {
      float g[8], u[8], a[8];
      load8(row + c, g);
      load8(row + h + c, u);
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = g[i] * sigmoid(g[i]) * u[i];
      store8(act + r * h + c, a);
    }
  }
}

__global__ void __launch_bounds__(kRowThreads)
    held_swiglu_bwd_kernel(const bf16* gu, const bf16* da, const int* offs,
                           int groups, bf16* dgu, int h) {
  const long long n = offs[groups - 1];
  for (long long r = blockIdx.x; r < n; r += gridDim.x) {
    const bf16* row = gu + r * 2 * h;
    for (int c = threadIdx.x * 8; c < h; c += blockDim.x * 8) {
      float g[8], u[8], a[8], dg[8], du[8];
      load8(row + c, g);
      load8(row + h + c, u);
      load8(da + r * h + c, a);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float s = sigmoid(g[i]);
        dg[i] = a[i] * u[i] * s * (1.f + g[i] * (1.f - s));
        du[i] = a[i] * g[i] * s;
      }
      store8(dgu + r * 2 * h + c, dg);
      store8(dgu + r * 2 * h + h + c, du);
    }
  }
}

int bad_width(int k, int width) {
  return (k < 1 || k > kMaxTopK || width < 8 || width % 8)
             ? static_cast<int>(cudaErrorInvalidValue) : 0;
}

}  // namespace

extern "C" {

// Every entry launches on `stream` and returns the launch's CUDA error (0 =
// success), or cudaErrorInvalidValue where top_k passes 16 or a width is
// not a multiple of 8. Pointers: x, xs, ys, dys, gu, da, act, dgu bf16; dy,
// gates, dgates, out (out_f32 = 1) f32, else bf16; pos int64 (t, k); offs
// int32 (groups). Rows are contiguous.
int held_scatter(const void* x, const void* pos, void* xs, int t, int k,
                 int d, void* stream) {
  if (const int bad = bad_width(k, d)) return bad;
  if (t < 1) return 0;
  dim3 grid(t);
  held_scatter_kernel<<<grid, kTokenThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const long long*>(pos),
      static_cast<bf16*>(xs), k, d);
  return static_cast<int>(cudaGetLastError());
}

int held_combine(const void* ys, const void* pos, const void* gates,
                 void* out, int out_f32, int t, int k, int d,
                 void* stream) {
  if (const int bad = bad_width(k, d)) return bad;
  if (t < 1) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto y = static_cast<const bf16*>(ys);
  auto p = static_cast<const long long*>(pos);
  auto g = static_cast<const float*>(gates);
  if (out_f32) {
    dim3 grid(t);
    held_combine_kernel<float><<<grid, kTokenThreads, 0, s>>>(
        y, p, g, static_cast<float*>(out), k, d);
  } else {
    dim3 grid(t);
    held_combine_kernel<bf16><<<grid, kTokenThreads, 0, s>>>(
        y, p, g, static_cast<bf16*>(out), k, d);
  }
  return static_cast<int>(cudaGetLastError());
}

int held_combine_bwd(const void* dy, const void* ys, const void* pos,
                     const void* gates, void* dys, void* dgates, int t,
                     int k, int d, void* stream) {
  if (const int bad = bad_width(k, d)) return bad;
  if (t < 1) return 0;
  dim3 grid(t);
  held_combine_bwd_kernel<<<grid, kTokenThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dy), static_cast<const bf16*>(ys),
      static_cast<const long long*>(pos), static_cast<const float*>(gates),
      static_cast<bf16*>(dys), static_cast<float*>(dgates), k, d);
  return static_cast<int>(cudaGetLastError());
}

int held_swiglu(const void* gu, const void* offs, int groups, void* act,
                int h, void* stream) {
  if (const int bad = bad_width(1, h)) return bad;
  if (groups < 1) return 0;
  dim3 grid(kRowBlocks);
  held_swiglu_kernel<<<grid, kRowThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(gu), static_cast<const int*>(offs), groups,
      static_cast<bf16*>(act), h);
  return static_cast<int>(cudaGetLastError());
}

int held_swiglu_bwd(const void* gu, const void* da, const void* offs,
                    int groups, void* dgu, int h, void* stream) {
  if (const int bad = bad_width(1, h)) return bad;
  if (groups < 1) return 0;
  dim3 grid(kRowBlocks);
  held_swiglu_bwd_kernel<<<grid, kRowThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(gu), static_cast<const bf16*>(da),
      static_cast<const int*>(offs), groups, static_cast<bf16*>(dgu), h);
  return static_cast<int>(cudaGetLastError());
}

const char* held_rows_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
