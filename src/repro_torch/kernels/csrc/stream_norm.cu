// One-pass row layernorm / rmsnorm over [M, D], float32 or bfloat16 in and
// out, float32 statistics.
//
// Replaces repro/kernels/stream_norm/kernel.py::stream_norm (body
// _norm_kernel).  The TPU kernel streams a tile of rows through VMEM once:
// sum and sum of squares in one traversal, var = max(E[x^2] - mean^2, 0),
// then (x - mean) * rsqrt(var + eps) * scale + bias (layernorm) or
// x * rsqrt(E[x^2] + eps) * scale (rmsnorm, bias ignored).
//
// On the card one block takes one row.  Each thread loads its elements
// (four at a time where D % 4 == 0 and the pointers are aligned, one at a
// time otherwise), adds them to its sum and sum of squares in float32 and
// keeps them in shared memory; a warp-shuffle then shared-memory reduction
// gives the row's statistics, and the same thread normalises the values it
// cached.  So x is read from device memory once, as on the TPU.  A row
// wider than MAX_CACHED_D does not fit the cache and is read a second time
// for the apply.  bfloat16 is widened to float32 on load and rounded to
// nearest even on store, as torch's .to(torch.bfloat16) does.
//
// Bound on the card: memory.  Each element is read once and written once
// against about eight operations.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// D * 4 bytes of row cache and the reduction buffer (272 bytes) stay within the
// 48 KB of shared memory a block gets without opting in
constexpr int MAX_CACHED_D = 12160;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// four consecutive elements (16-byte aligned for float, 8-byte for bf16)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 lo = __bfloat1622float2(q[0]), hi = __bfloat1622float2(q[1]);
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(v.x, v.y);
  q[1] = __floats2bfloat162_rn(v.z, v.w);
}

// (a, b) summed over the block (blockDim.x a multiple of 32); every thread
// gets the result.  red holds 33 entries.
__device__ float2 block_sum2(float a, float b, float2* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, nw = blockDim.x / 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  if (lane == 0) red[warp] = make_float2(a, b);
  __syncthreads();
  if (warp == 0) {
    a = lane < nw ? red[lane].x : 0.f;
    b = lane < nw ? red[lane].y : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, o);
      b += __shfl_xor_sync(0xffffffffu, b, o);
    }
    if (lane == 0) red[32] = make_float2(a, b);
  }
  __syncthreads();
  return red[32];
}

template <typename T>
__global__ void stream_norm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                                   const float* __restrict__ bias, T* __restrict__ out, int D,
                                   float eps, int rms, int vec, int cached) {
  extern __shared__ float4 row4[];  // [D] floats when cached
  float* row = reinterpret_cast<float*>(row4);
  __shared__ float2 red[33];
  const T* xr = x + (size_t)blockIdx.x * D;
  T* yr = out + (size_t)blockIdx.x * D;
  const int tid = threadIdx.x, nt = blockDim.x;

  float s = 0.f, q = 0.f;
  if (vec) {
    for (int i = 4 * tid; i < D; i += 4 * nt) {
      const float4 v = load4(xr + i);
      s += (v.x + v.y) + (v.z + v.w);
      q = fmaf(v.x, v.x, fmaf(v.y, v.y, fmaf(v.z, v.z, fmaf(v.w, v.w, q))));
      if (cached) row4[i / 4] = v;
    }
  } else {
    for (int i = tid; i < D; i += nt) {
      const float v = to_f32(xr[i]);
      s += v;
      q = fmaf(v, v, q);
      if (cached) row[i] = v;
    }
  }
  const float2 t = block_sum2(s, q, red);
  const float mean = t.x / (float)D, msq = t.y / (float)D;
  const float shift = rms ? 0.f : mean;
  const float rstd = rsqrtf(rms ? msq + eps : fmaxf(msq - mean * mean, 0.f) + eps);

  // each thread normalises the elements it loaded: no barrier on the cache
  if (vec) {
    for (int i = 4 * tid; i < D; i += 4 * nt) {
      const float4 v = cached ? row4[i / 4] : load4(xr + i);
      const float4 g = load4(scale + i);
      const float4 b = bias != nullptr ? load4(bias + i) : make_float4(0.f, 0.f, 0.f, 0.f);
      store4(yr + i,
             make_float4((v.x - shift) * rstd * g.x + b.x, (v.y - shift) * rstd * g.y + b.y,
                         (v.z - shift) * rstd * g.z + b.z, (v.w - shift) * rstd * g.w + b.w));
    }
  } else {
    for (int i = tid; i < D; i += nt) {
      const float v = cached ? row[i] : to_f32(xr[i]);
      store1(yr + i, (v - shift) * rstd * scale[i] + (bias != nullptr ? bias[i] : 0.f));
    }
  }
}

bool aligned(const void* p, size_t n) { return reinterpret_cast<uintptr_t>(p) % n == 0; }

template <typename T>
int launch(const T* x, const float* scale, const float* bias, T* out, int M, int D, float eps,
           int rms, cudaStream_t stream) {
  const int vec = D % 4 == 0 && aligned(x, 4 * sizeof(T)) && aligned(out, 4 * sizeof(T)) &&
                  aligned(scale, 16) && (bias == nullptr || aligned(bias, 16));
  const int cached = D <= MAX_CACHED_D;
  const int work = vec ? D / 4 : D;
  const int threads = work >= 1024 ? 1024 : (work + 31) / 32 * 32;
  const size_t smem = cached ? (size_t)(D + 3) / 4 * sizeof(float4) : 0;
  stream_norm_kernel<T><<<M, threads, smem, stream>>>(x, scale, bias, out, D, eps, rms, vec,
                                                      cached);
  return (int)cudaGetLastError();
}

}  // namespace

// x/out [M, D]; scale [D] float32; bias [D] float32 or null (zeros; pass null
// for rmsnorm, which ignores it); rms = 0 layernorm, 1 rmsnorm
extern "C" int stream_norm_f32(const float* x, const float* scale, const float* bias, float* out,
                               int M, int D, float eps, int rms, cudaStream_t stream) {
  return launch(x, scale, bias, out, M, D, eps, rms, stream);
}

extern "C" int stream_norm_bf16(const __nv_bfloat16* x, const float* scale, const float* bias,
                                __nv_bfloat16* out, int M, int D, float eps, int rms,
                                cudaStream_t stream) {
  return launch(x, scale, bias, out, M, D, eps, rms, stream);
}
