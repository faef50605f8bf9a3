// Group norm with an optional fused SiLU epilogue on the (L, C) layout,
// float32 in and out, in one launch.
//
// Replaces repro/kernels/stream_norm/kernel.py::stream_group_norm.  The TPU
// kernel holds a whole [L, C] batch element in VMEM and computes the JAX
// one-pass statistics, mean = E[x], var = max(E[x^2] - mean^2, 0),
// rstd = 1 / sqrt(var + eps), then (x - mean) * rstd * scale + bias and
// y * sigmoid(y) when SiLU is fused.  A group's channels are contiguous
// (reshape(b, l, G, C/G)).
//
// Bound on the card: memory (one read and one write of x against a few
// operations an element).  The design, on thread-block clusters:
//   * groups are independent, so the channels are cut into slices of whole
//     groups, and each (batch element, slice) gets one cluster of up to 16
//     blocks that split its rows; the grid is (cluster, slices, B);
//   * each block copies its rows of the slice into shared memory once
//     (16-byte cp.async where the slice, C and x allow it, else 4-byte),
//     sums each column over its rows, then each group over its columns,
//     all in a fixed order;
//   * after cluster.sync() every block reads all ranks' group partials
//     over distributed shared memory in rank order, so every block forms
//     the same statistics bit for bit: no float atomics, no second launch;
//   * the apply pass reads x from shared memory and writes out with
//     16-byte stores, so x crosses HBM once each way.  Where a block's rows
//     would not fit (on_chip = 0), the statistics and the apply pass each
//     read x from global memory (the second read mostly from L2).
// The plan (slice width, cluster size, rows a block, on chip or not) is
// stream_norm/ops.py::group_norm_plan; group_norm_smem states the shared
// memory it needs, which the plan restates.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int T = 128;           // threads a block
constexpr int MAX_CLUSTER = 16;  // non-portable above 8
constexpr int SMEM_LIMIT = 232448;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
template <int W>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  if constexpr (W == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
                 : "memory");
  }
}

// floats of shared memory: cached rows, per-column sums [2][RP][sw] (at
// most 2 * max(4T, sw)), per-column scale / bias, group partials and group
// statistics [gps][2] each
__host__ __device__ constexpr long smem_floats(int rows, int sw, int gps, int on_chip) {
  return (on_chip ? (long)rows * sw : 0) + 2L * (sw > 4 * T ? sw : 4 * T) + 2L * sw + 4L * gps;
}

// W consecutive floats (a float4 where the slice allows 16-byte access)
template <int W>
struct Vec {
  float v[W];
};
template <int W>
__device__ __forceinline__ Vec<W> load(const float* p, bool global) {
  Vec<W> r;
  if constexpr (W == 4) {
    const float4 f = global ? __ldg(reinterpret_cast<const float4*>(p))
                            : *reinterpret_cast<const float4*>(p);
    r.v[0] = f.x;
    r.v[1] = f.y;
    r.v[2] = f.z;
    r.v[3] = f.w;
  } else {
    r.v[0] = global ? __ldg(p) : *p;
  }
  return r;
}
template <int W>
__device__ __forceinline__ void store(float* p, const Vec<W>& r) {
  if constexpr (W == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r.v[0], r.v[1], r.v[2], r.v[3]);
  } else {
    *p = r.v[0];
  }
}

// W = 4: 16-byte copies, loads and stores (sw, C and both pointers allow
// it); W = 1: 4-byte ones.  Thread (rp, u) takes units u, u + nu, ... of W
// columns, over rows rp, rp + RP, ...: neighbouring threads take
// neighbouring columns of a row, and the unit's coefficients stay in
// registers across its rows.
template <int W>
__global__ void __launch_bounds__(T) group_norm_kernel(
    const float* __restrict__ x, const float* __restrict__ scale, const float* __restrict__ bias,
    float* __restrict__ out, int L, int C, int G, int gps, int rows_per_block, float eps,
    int silu, int on_chip) {
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), cs = (int)cluster.num_blocks();
  const int tid = threadIdx.x, slice = blockIdx.y, b = blockIdx.z;
  const int cgw = C / G, sw = gps * cgw, c0 = slice * sw;
  const int r0 = rank * rows_per_block;
  const int nr = max(0, min(L, r0 + rows_per_block) - r0);
  const size_t base = ((size_t)b * L + r0) * C + c0;
  const float* xb = x + base;
  float* ob = out + base;

  float* cache = sm;  // [rows_per_block][sw]
  float* colsum = sm + (on_chip ? (long)rows_per_block * sw : 0);
  float* csc = colsum + 2 * max(4 * T, sw);
  float* cbi = csc + sw;
  float* part = cbi + sw;       // this block's (sum, sum of squares) per group
  float* gst = part + 2 * gps;  // (mean, rstd) per group

  const int q = sw / W, nu = min(T, q), RP = T / nu;
  const int u0 = tid % nu, rp = tid / nu;
  const bool active = rp < RP;
  if (on_chip && active) {
    for (int u = u0; u < q; u += nu)
      for (int r = rp; r < nr; r += RP)
        cp_async<W>(cache + r * sw + u * W, xb + (size_t)r * C + u * W);
  }
  if (on_chip) asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int c = tid; c < sw; c += T) {
    csc[c] = scale[c0 + c];
    cbi[c] = bias[c0 + c];
  }
  if (on_chip) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // column sums over this thread's rows, then group sums over columns,
  // every sum in a fixed order
  if (active) {
    for (int u = u0; u < q; u += nu) {
      float s[W], sq[W];
#pragma unroll
      for (int j = 0; j < W; ++j) s[j] = sq[j] = 0.f;
#pragma unroll 4
      for (int r = rp; r < nr; r += RP) {
        const Vec<W> v = on_chip ? load<W>(cache + r * sw + u * W, false)
                                 : load<W>(xb + (size_t)r * C + u * W, true);
#pragma unroll
        for (int j = 0; j < W; ++j) {
          s[j] += v.v[j];
          sq[j] = fmaf(v.v[j], v.v[j], sq[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < W; ++j) {
        colsum[rp * sw + u * W + j] = s[j];
        colsum[(RP + rp) * sw + u * W + j] = sq[j];
      }
    }
  }
  __syncthreads();
  for (int gl = tid; gl < gps; gl += T) {
    float s = 0.f, sq = 0.f;
    for (int k = 0; k < RP; ++k)
      for (int j = 0; j < cgw; ++j) {
        s += colsum[k * sw + gl * cgw + j];
        sq += colsum[(RP + k) * sw + gl * cgw + j];
      }
    part[2 * gl] = s;
    part[2 * gl + 1] = sq;
  }
  cluster.sync();  // every rank's partials are written

  // the same sums in the same (rank) order in every block of the cluster
  const float n = (float)L * (float)cgw;
  for (int gl = tid; gl < gps; gl += T) {
    float s = 0.f, sq = 0.f;
    for (int k = 0; k < cs; ++k) {
      const float* p = cluster.map_shared_rank(part, k);
      s += p[2 * gl];
      sq += p[2 * gl + 1];
    }
    const float mean = s / n;
    const float var = fmaxf(sq / n - mean * mean, 0.f);
    gst[2 * gl] = mean;
    gst[2 * gl + 1] = 1.f / sqrtf(var + eps);
  }
  // done with the other ranks' shared memory: arrive now, and wait for the
  // others only before exiting, so no block leaves while one still reads it
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  __syncthreads();

  // y = (x - mean) * (rstd * scale) + bias, then y * sigmoid(y)
  if (active) {
    for (int u = u0; u < q; u += nu) {
      float m[W], a[W], bb[W];
#pragma unroll
      for (int j = 0; j < W; ++j) {
        const int c = u * W + j, gl = c / cgw;
        m[j] = gst[2 * gl];
        a[j] = gst[2 * gl + 1] * csc[c];
        bb[j] = cbi[c];
      }
#pragma unroll 4
      for (int r = rp; r < nr; r += RP) {
        Vec<W> v = on_chip ? load<W>(cache + r * sw + u * W, false)
                           : load<W>(xb + (size_t)r * C + u * W, true);
#pragma unroll
        for (int j = 0; j < W; ++j) {
          float y = fmaf(v.v[j] - m[j], a[j], bb[j]);
          if (silu) y = y * (1.f / (1.f + expf(-y)));
          v.v[j] = y;
        }
        store<W>(ob + (size_t)r * C + u * W, v);
      }
    }
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// Shared memory (bytes) of one block: rows_per_block rows of a slice sw
// channels wide holding gps groups, the rows cached or not.
extern "C" long group_norm_smem(int rows_per_block, int sw, int gps, int on_chip) {
  return 4 * smem_floats(rows_per_block, sw, gps, on_chip);
}

// x/out [B, L, C]; scale/bias [C].  gps groups a slice (dividing G), a
// cluster of `cluster` blocks per (batch element, slice), each taking
// rows_per_block rows (cluster * rows_per_block >= L); on_chip caches the
// rows in shared memory.  One launch.
extern "C" int group_norm_f32(const float* x, const float* scale, const float* bias, float* out,
                              int B, int L, int C, int G, int gps, int cluster,
                              int rows_per_block, int on_chip, float eps, int silu,
                              cudaStream_t stream) {
  if (G <= 0 || C % G != 0 || gps <= 0 || G % gps != 0 || cluster < 1 ||
      cluster > MAX_CLUSTER || (long)cluster * rows_per_block < L)
    return (int)cudaErrorInvalidValue;
  const int sw = gps * (C / G);
  const long smem = group_norm_smem(rows_per_block, sw, gps, on_chip);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const bool vec = sw % 4 == 0 && C % 4 == 0 && aligned16(x) && aligned16(out);
  auto kernel = vec ? group_norm_kernel<4> : group_norm_kernel<1>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, G / gps, B);
  cfg.blockDim = dim3(T);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, x, scale, bias, out, L, C, G, gps, rows_per_block, eps,
                           silu, on_chip);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
