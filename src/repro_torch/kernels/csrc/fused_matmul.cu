// Fused matrix product out[M, N] = epilogue(a[M, K] @ b[K, N]) with float32
// accumulation, float32 or bfloat16 operands (the output takes their type),
// and optional per-row (sum, sum of squares) of the float32 result.
//
// Replaces repro/kernels/fused_matmul/kernel.py::fused_matmul (body
// _fused_kernel).  The TPU kernel walks a (M, N, K) grid in order, carries
// the accumulator in VMEM across K steps, applies the epilogue (none, bias,
// GELU in its sigmoid form y * sigmoid(1.702 y), SiLU) at the last K step
// and revisits each M tile's stats block across the N steps.  Its blocks
// shrink to divisors of M, N and K.
//
// On the card blocks run in parallel and in no order, so nothing is carried
// between them:
//   * each block computes one 64 x 64 output tile over the whole of K,
//     staging 16-deep slices of a and b in shared memory (float32, widened
//     from bfloat16 on load); 256 threads each own 4 x 4 outputs;
//   * loads and stores are predicated, so ragged M, N and K need no
//     divisors;
//   * the epilogue runs on the accumulators in registers, and the result is
//     rounded once to the output type on store;
//   * with stats, each block sums its rows over its 64 columns (the f32
//     result after the epilogue, before the cast) and writes them to
//     partials[n tile, 2, M]; a second launch adds the partials over the N
//     tiles in a fixed order into stats[2, M].  No float atomics, so the
//     stats are the same from run to run.
//
// Bound on the card: operations at the widths used (2*M*N*K against a few
// MB); this first version runs them on the float32 CUDA cores.  Tensor
// cores (wgmma) and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;   // output rows per block
constexpr int BN = 64;   // output columns per block
constexpr int BK = 16;   // depth of one shared-memory stage
constexpr int NT = 256;  // threads: 16 x 16, each 4 rows x 4 columns

enum Epilogue { NONE = 0, BIAS = 1, GELU = 2, SILU = 3 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(NT) fused_matmul_kernel(
    const T* __restrict__ a, const T* __restrict__ b, const float* __restrict__ bias,
    T* __restrict__ out, float* __restrict__ partials, int M, int N, int K, int epilogue) {
  __shared__ __align__(16) float As[BK][BM + 4];  // a slice, transposed; rows 16-byte aligned
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;  // outputs: rows ty*4 + i, columns tx*4 + j
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  // loads: a rows ar + 16*i at depth ak (64 B runs of a row); b rows bk + 4*i at column bn
  const int ak = tid % 16, ar = tid / 16;
  const int bk = tid / 64, bn = tid % 64;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + ar + 16 * i, k = k0 + ak;
      As[ak][ar + 16 * i] = (m < M && k < K) ? to_f32(a[(size_t)m * K + k]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + bk + 4 * i, n = n0 + bn;
      Bs[bk + 4 * i][bn] = (k < K && n < N) ? to_f32(b[(size_t)k * N + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float ar4[4] = {av.x, av.y, av.z, av.w}, br4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar4[i], br4[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue in registers, then the row sums of this tile's valid columns
  float rs[4], rq[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    rs[i] = 0.f;
    rq[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= N) continue;
      float y = acc[i][j];
      if (epilogue != NONE && bias != nullptr) y += bias[n];
      if (epilogue == GELU) {
        y = y * (1.f / (1.f + expf(-1.702f * y)));
      } else if (epilogue == SILU) {
        y = y * (1.f / (1.f + expf(-y)));
      }
      rs[i] += y;
      rq[i] = fmaf(y, y, rq[i]);
      if (m < M) store1(out + (size_t)m * N + n, y);
    }
  }
  if (partials == nullptr) return;
  // the 16 threads of one ty are one half-warp: reduce over tx in a fixed order
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], o);
      rq[i] += __shfl_xor_sync(0xffffffffu, rq[i], o);
    }
    const int m = m0 + ty * 4 + i;
    if (tx == 0 && m < M) {
      partials[((size_t)blockIdx.y * 2) * M + m] = rs[i];
      partials[((size_t)blockIdx.y * 2 + 1) * M + m] = rq[i];
    }
  }
}

// stats[s, m] = sum over tiles t of partials[t, s, m], t in order
__global__ void stats_reduce_kernel(const float* __restrict__ partials, float* __restrict__ stats,
                                    int M, int n_tiles) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 2 * M) return;
  float s = 0.f;
  for (int t = 0; t < n_tiles; ++t) s += partials[(size_t)t * 2 * M + i];
  stats[i] = s;
}

template <typename T>
int launch(const T* a, const T* b, const float* bias, T* out, float* partials, float* stats, int M,
           int N, int K, int epilogue, cudaStream_t stream) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  fused_matmul_kernel<T><<<grid, NT, 0, stream>>>(a, b, bias, out,
                                                  stats != nullptr ? partials : nullptr, M, N, K,
                                                  epilogue);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || stats == nullptr) return (int)err;
  stats_reduce_kernel<<<(2 * M + 255) / 256, 256, 0, stream>>>(partials, stats, M, (int)grid.y);
  return (int)cudaGetLastError();
}

}  // namespace

// a [M, K], b [K, N], out [M, N] of one type; bias [N] float32 or null (read
// unless epilogue is NONE); partials [ceil(N / 64), 2, M] and stats [2, M]
// float32, both null without stats; epilogue 0 none, 1 bias, 2 gelu, 3 silu
extern "C" int fused_matmul_f32(const float* a, const float* b, const float* bias, float* out,
                                float* partials, float* stats, int M, int N, int K, int epilogue,
                                cudaStream_t stream) {
  return launch(a, b, bias, out, partials, stats, M, N, K, epilogue, stream);
}

extern "C" int fused_matmul_bf16(const __nv_bfloat16* a, const __nv_bfloat16* b,
                                 const float* bias, __nv_bfloat16* out, float* partials,
                                 float* stats, int M, int N, int K, int epilogue,
                                 cudaStream_t stream) {
  return launch(a, b, bias, out, partials, stats, M, N, K, epilogue, stream);
}
