// Group norm with an optional fused SiLU epilogue on the (L, C) layout,
// float32 in and out.
//
// Replaces repro/kernels/stream_norm/kernel.py::stream_group_norm.  The TPU
// kernel holds a whole [L, C] batch element in VMEM; on the card one batch
// element is up to 8.4 MB (the VAE's 65536 x 32), far beyond a block's
// 227 KB of shared memory, and one block per batch element would leave most
// SMs idle.  So the work is split in three launches:
//   1. stats: one block per (chunk of rows, batch) reads its rows once,
//      coalesced along C, and writes a partial (sum, sum of squares) per
//      group;
//   2. finalize: per (batch, group), reduce the partials and form the JAX
//      one-pass statistics, mean = E[x], var = max(E[x^2] - mean^2, 0),
//      rstd = 1 / sqrt(var + eps);
//   3. apply: elementwise (x - mean) * rstd * scale + bias, then y*sigmoid(y)
//      when SiLU is fused.
// A group's channels are contiguous (reshape(b, l, G, C/G)).
//
// Bound on the card: memory.  It moves x twice in and once out against a few
// operations per element; the partials are a few KB.
#include <cuda_runtime.h>

namespace {

__global__ void gn_stats_kernel(const float* __restrict__ x, float* __restrict__ partials, int L,
                                int C, int G, int chunk_rows) {
  extern __shared__ float sm[];  // [2 * max(blockDim.x, C)]
  const int T = blockDim.x, tid = threadIdx.x;
  const int chunk = blockIdx.x, b = blockIdx.y, n_chunks = gridDim.x;
  const int r0 = chunk * chunk_rows;
  const int r1 = min(L, r0 + chunk_rows);
  const float* xb = x + (size_t)b * L * C;
  const int width = max(T, C);

  if (C >= T) {
    for (int c = tid; c < C; c += T) {
      float s = 0.f, q = 0.f;
      for (int r = r0; r < r1; ++r) {
        const float v = xb[(size_t)r * C + c];
        s += v;
        q = fmaf(v, v, q);
      }
      sm[c] = s;
      sm[width + c] = q;
    }
  } else {
    // several rows in parallel: thread (sub, c) takes rows r0 + sub, r0 + sub + rp, ...
    const int rp = T / C;
    const int c = tid % C, sub = tid / C;
    float s = 0.f, q = 0.f;
    if (sub < rp) {
      for (int r = r0 + sub; r < r1; r += rp) {
        const float v = xb[(size_t)r * C + c];
        s += v;
        q = fmaf(v, v, q);
      }
      sm[sub * C + c] = s;
      sm[width + sub * C + c] = q;
    }
    __syncthreads();
    if (tid < C) {  // only thread c touches column c of both halves
      s = 0.f;
      q = 0.f;
      for (int k = 0; k < rp; ++k) {
        s += sm[k * C + tid];
        q += sm[width + k * C + tid];
      }
      sm[tid] = s;
      sm[width + tid] = q;
    }
  }
  __syncthreads();
  const int cg = C / G;
  for (int g = tid; g < G; g += T) {
    float s = 0.f, q = 0.f;
    for (int j = 0; j < cg; ++j) {
      s += sm[g * cg + j];
      q += sm[width + g * cg + j];
    }
    float* p = partials + ((size_t)(b * G + g) * n_chunks + chunk) * 2;
    p[0] = s;
    p[1] = q;
  }
}

__global__ void gn_finalize_kernel(const float* __restrict__ partials, float* __restrict__ stats,
                                   int L, int C, int G, int n_chunks, float eps) {
  const int b = blockIdx.x;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    const float* p = partials + (size_t)(b * G + g) * n_chunks * 2;
    float s = 0.f, q = 0.f;
    for (int k = 0; k < n_chunks; ++k) {
      s += p[2 * k];
      q += p[2 * k + 1];
    }
    const float n = (float)L * (float)(C / G);
    const float mean = s / n;
    const float var = fmaxf(q / n - mean * mean, 0.f);
    stats[(b * G + g) * 2] = mean;
    stats[(b * G + g) * 2 + 1] = 1.f / sqrtf(var + eps);
  }
}

__global__ void gn_apply_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                                const float* __restrict__ bias, const float* __restrict__ stats,
                                float* __restrict__ out, size_t total, int L, int C, int G,
                                int silu) {
  const int cg = C / G;
  const size_t per_batch = (size_t)L * C;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int c = (int)(i % C);
    const int b = (int)(i / per_batch);
    const float* st = stats + (b * G + c / cg) * 2;
    float y = (x[i] - st[0]) * st[1];
    y = y * scale[c] + bias[c];
    if (silu) y = y * (1.f / (1.f + expf(-y)));
    out[i] = y;
  }
}

}  // namespace

// x/out [B, L, C]; scale/bias [C]; partials [B * G * ceil(L / chunk_rows) * 2]; stats [B * G * 2]
extern "C" int group_norm_f32(const float* x, const float* scale, const float* bias, float* out,
                              float* partials, float* stats, int B, int L, int C, int G,
                              int chunk_rows, float eps, int silu, cudaStream_t stream) {
  const int n_chunks = (L + chunk_rows - 1) / chunk_rows;
  const int T = C >= 256 ? min(1024, (C + 31) / 32 * 32) : 256;
  const size_t smem = 2 * (size_t)max(T, C) * sizeof(float);
  gn_stats_kernel<<<dim3(n_chunks, B), T, smem, stream>>>(x, partials, L, C, G, chunk_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_finalize_kernel<<<B, 32, 0, stream>>>(partials, stats, L, C, G, n_chunks, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t total = (size_t)B * L * C;
  const int blocks = (int)min((total + 255) / 256, (size_t)132 * 32);
  gn_apply_kernel<<<blocks, 256, 0, stream>>>(x, scale, bias, stats, out, total, L, C, G, silu);
  return (int)cudaGetLastError();
}
