// Fused matrix product out[M, N] = epilogue(a[M, K] @ b[K, N]) with float32
// accumulation, float32 or bfloat16 operands (the output takes their type),
// and optional per-row (sum, sum of squares) of the float32 result.
//
// Replaces repro/kernels/fused_matmul/kernel.py::fused_matmul (body
// _fused_kernel).  The TPU kernel walks a (M, N, K) grid in order, carries
// the accumulator in VMEM across K steps, applies the epilogue (none, bias,
// GELU in its sigmoid form y * sigmoid(1.702 y), SiLU) at the last K step
// and revisits each M tile's stats block across the N steps.
//
// Bound on the card: operations (2*M*N*K against a few MB) on the tensor
// cores.  On the card blocks run in parallel and in no order, so each block
// computes one output tile over the whole of K, and three routes share the
// epilogue and the stats (fused_matmul/ops.py::matmul_plan picks one):
//   * bfloat16, wgmma: a 128 x 128 tile, one producer warp filling a 3-stage
//     ring of 64-deep slices by 16-byte cp.async (zero-fill past M, N and
//     K), each stage signalled by an mbarrier, two blocks an SM; two
//     consumer warpgroups of 64 rows issue wgmma.m64n128k16.f32.bf16.bf16
//     with both operands in shared memory in the 128-byte-swizzled layouts:
//     a K-major, b N-major through the instruction's transpose bit, so b is
//     read as it lies in memory;
//   * float32, 3xTF32 on wgmma: tf32 wgmma takes B only K-major, so a first
//     launch splits b per call into K-major hi / lo halves (x = hi + lo,
//     hi = tf32(x), lo = tf32(x - hi); nothing cached across calls), and
//     the product runs as uniconv.cu's does: a 128 x BN tile (128, four k8
//     steps a stage, or 160, two), a 4-stage cp.async ring, A split in
//     registers, a*b ~ a_lo*b_hi + a_hi*b_lo + a_hi*b_hi, each stage's
//     products in a fresh tensor-core sum folded into the float32
//     accumulator with an ordinary add;
//   * small products (the time MLP's M = 4; fewer 128 x 128 tiles than a
//     quarter of the SMs), either type: a 64 x 64 SIMT tile on the float32
//     CUDA cores, each stage's loads issued a stage ahead into registers.
// Loads are predicated (4-byte, or 2-byte for bfloat16, copies where a row
// does not start on a 16-byte boundary), so ragged M, N and K need no
// divisors.  The tensor routes stage the raw tile in shared memory and
// finish it row by row (bias, activation, row stats, one rounding to the
// output type, wide stores).  With stats, each block sums its rows over its
// columns (the float32 result after the epilogue, before the cast) in a
// fixed order into partials[n tile, 2, M]; a last launch adds the partials
// over the N tiles in order into stats[2, M].  No float atomics, so the
// results are the same on every run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Epilogue { NONE = 0, BIAS = 1, GELU = 2, SILU = 3 };
enum Route { SIMT = 0, TENSOR = 1 };
constexpr int SMEM_LIMIT = 232448;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ float epilogue_at(float y, int n, const float* bias, int epilogue) {
  if (epilogue != NONE && bias != nullptr) y += bias[n];
  // sigmoid from the fast exponential and reciprocal (a few 1e-7 relative)
  if (epilogue == GELU) {
    y = y * __frcp_rn(1.f + __expf(-1.702f * y));
  } else if (epilogue == SILU) {
    y = y * __frcp_rn(1.f + __expf(-y));
  }
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 16- and 4-byte async copies; src-size 0 writes zeros and reads nothing
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// small M: a 64 x 64 SIMT tile on the float32 CUDA cores
namespace simt {
constexpr int BM = 64;   // output rows per block
constexpr int BN = 64;   // output columns per block
constexpr int BK = 32;   // depth of one shared-memory stage
constexpr int NT = 256;  // threads: 16 x 16, each 4 rows x 4 columns
}  // namespace simt

template <typename T>
__global__ void __launch_bounds__(simt::NT) simt_kernel(
    const T* __restrict__ a, const T* __restrict__ b, const float* __restrict__ bias,
    T* __restrict__ out, float* __restrict__ partials, int M, int N, int K, int epilogue) {
  using namespace simt;
  __shared__ __align__(16) float As[BK][BM + 4];  // a slice, transposed; rows 16-byte aligned
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;  // outputs: rows ty*4 + i, columns tx*4 + j
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // a stage's loads land in registers one stage ahead, so the next stage's
  // global loads are in flight while this one is computed: a along its
  // rows, b along its columns
  constexpr int LA = BM * BK / NT, LB = BK * BN / NT;
  float ra[LA], rb[LB];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < LA; ++i) {
      const int e = tid + NT * i, r = e / BK, kk = e % BK, m = m0 + r, k = k0 + kk;
      ra[i] = (m < M && k < K) ? to_f32(a[(size_t)m * K + k]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < LB; ++i) {
      const int e = tid + NT * i, kk = e / BN, c = e % BN, k = k0 + kk, n = n0 + c;
      rb[i] = (k < K && n < N) ? to_f32(b[(size_t)k * N + n]) : 0.f;
    }
  };
  fetch(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < LA; ++i) {
      const int e = tid + NT * i;
      As[e % BK][e / BK] = ra[i];
    }
#pragma unroll
    for (int i = 0; i < LB; ++i) {
      const int e = tid + NT * i;
      Bs[e / BN][e % BN] = rb[i];
    }
    __syncthreads();
    if (k0 + BK < K) fetch(k0 + BK);
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
      const float y = epilogue_at(acc[i][j], n, bias, epilogue);
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

// ---------------------------------------------------------------------------
// float32: the TF32 split (x = hi + lo, both TF32 values)
// round to TF32 (nearest, ties away from zero): the low 13 mantissa bits cleared
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ void split3(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_bits(x);
  lo = tf32_bits(x - __uint_as_float(hi));
}
// ---------------------------------------------------------------------------
// bfloat16: wgmma from shared memory, one producer warp, mbarrier ring
namespace bf16mm {
constexpr int BM = 128;                   // output rows per block: two consumer warpgroups
constexpr int BK = 64;                    // depth of one ring stage: four k16 steps
constexpr int STAGES = 3;                 // depth of the ring: two blocks share an SM
constexpr int CONSUMERS = 256;            // threads of the two consumer warpgroups
constexpr int NT = CONSUMERS + 32;        // and the producer warp
constexpr int A_BYTES = BM * BK * 2;      // one stage of a
constexpr int B_LBO = BK / 8 * 1024;      // b: bytes from one 64-column block to the next
__host__ __device__ constexpr int stage_bytes(int bn) { return A_BYTES + BK * bn * 2; }
__host__ __device__ constexpr int smem_bytes(int bn) {
  // 1 KB to align the ring to the swizzle atoms, the ring, full / empty barriers
  return 1024 + STAGES * stage_bytes(bn) + 2 * STAGES * 8;
}
}  // namespace bf16mm

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// arrive once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
// wait for the completion of the barrier's phase of this parity; a wait
// that outlasts any sane stage (2^24 polls) traps, so a lost
// arrival fails the launch instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.b32 %0, 1, 0, P1;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 24)) __trap();
  }
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// registers a pending wgmma reads or writes: keep them live and unmoved
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// shared-memory matrix descriptor: start, LBO and SBO in bytes (16-byte
// units in the descriptor) and the swizzle mode (0 none, 1 128-byte).  No
// swizzle, K-major: LBO = next 8 K, SBO = next 8 rows.  128-byte swizzle:
// K-major, SBO = next 8 rows (LBO unused); N-major, LBO = next 64 columns,
// SBO = next 8 K
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint32_t swizzle = 0) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)swizzle << 62);
}

__device__ __forceinline__ void pin4(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// One bfloat16 stage in wgmma's 128-byte-swizzled layouts, by threads
// [first, first + count): a [BM rows, BK = 64] K-major, row r at r * 128
// bytes; b [BK, BN] N-major, 1 KB atoms of 8 K rows x 64 columns, the atom
// of (column block nb, K block kb) at nb * B_LBO + kb * 1024.  Within an
// atom's 128-byte row r, 16-byte chunk c lands at chunk c ^ (r % 8), so the
// tensor cores' reads of 8 rows hit 8 different bank groups.  16-byte
// cp.async with zero-fill (vec), else 2-byte loads and stores (the caller
// then fences and signals).
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}
template <int BN>
__device__ __forceinline__ void load_bf16_stage(uint8_t* As, uint8_t* Bs,
                                                const __nv_bfloat16* __restrict__ a,
                                                const __nv_bfloat16* __restrict__ b, int m0,
                                                int n0, int k0, int M, int N, int K, int vec_a,
                                                int vec_b, int first, int count) {
  using namespace bf16mm;
  if (vec_a) {
    for (int i = first; i < BM * BK / 8; i += count) {
      const int r = i >> 3, c = i & 7, m = m0 + r, k = k0 + c * 8;
      const bool ok = m < M && k < K;
      cp16(As + swz(r, c), a + (ok ? (size_t)m * K + k : 0), ok);
    }
  } else {
    for (int i = first; i < BM * BK; i += count) {
      const int r = i / BK, kk = i % BK, m = m0 + r, k = k0 + kk;
      *reinterpret_cast<__nv_bfloat16*>(As + swz(r, kk / 8) + (kk % 8) * 2) =
          (m < M && k < K) ? a[(size_t)m * K + k] : __float2bfloat16_rn(0.f);
    }
  }
  if (vec_b) {
    for (int i = first; i < BK * BN / 8; i += count) {
      const int kk = i / (BN / 8), nc = i % (BN / 8), k = k0 + kk, n = n0 + nc * 8;
      const bool ok = k < K && n < N;
      cp16(Bs + (nc / 8) * B_LBO + (kk / 8) * 1024 + swz(kk % 8, nc % 8),
           b + (ok ? (size_t)k * N + n : 0), ok);
    }
  } else {
    for (int i = first; i < BK * BN; i += count) {
      const int kk = i / BN, nn = i % BN, k = k0 + kk, n = n0 + nn;
      *reinterpret_cast<__nv_bfloat16*>(Bs + (nn / 64) * B_LBO + (kk / 8) * 1024 +
                                         swz(kk % 8, (nn % 64) / 8) + (nn % 8) * 2) =
          (k < K && n < N) ? b[(size_t)k * N + n] : __float2bfloat16_rn(0.f);
    }
  }
}

// The epilogue of the wgmma routes, in two steps.  First each thread
// stores its raw accumulators into a float32 tile in shared memory (the
// ring, once every product is done): a warpgroup's 64 x BN tile holds
// rows r and r + 8 of each thread, columns 8j + 2t (+1), acc[4j + 2h + e].
// Then each warp takes whole rows of the tile in a loop: bias, activation,
// the row's (sum, sum of squares) over the tile's columns (a fixed order:
// each lane's columns, then a butterfly over the lanes) and 16- or 8-byte
// stores of the row.  Applying the activation on the fragments instead
// unrolls it into every one of a thread's BN/2 values, and that straight
// code, run once a block, cost more than the products at small K
// (instruction fetch).
constexpr int TILE_M = 128;
template <int BN>
__host__ __device__ constexpr int tile_stride() { return BN + 8; }  // rows 16-byte aligned
template <int BN>
__host__ __device__ constexpr int tile_bytes() { return TILE_M * tile_stride<BN>() * 4; }

template <int BN>
__device__ __forceinline__ void stage_acc(const float (&acc)[BN / 2], float* tile, int r, int t) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(tile + (r + 8 * h) * tile_stride<BN>() + 8 * j + 2 * t) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
}

__device__ __forceinline__ void store4(float* p, const float (&y)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(y[0], y[1], y[2], y[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&y)[4]) {
  __nv_bfloat162 v[2] = {__floats2bfloat162_rn(y[0], y[1]), __floats2bfloat162_rn(y[2], y[3])};
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(v);
}

// rows warp, warp + nwarps, ... < rows of the staged tile to out[m0.., n0..]
template <int BN, typename T>
__device__ __forceinline__ void finish_rows(const float* tile, T* __restrict__ out,
                                            const float* __restrict__ bias,
                                            float* __restrict__ partials, int m0, int n0, int M,
                                            int N, int epilogue, int rows, int warp, int nwarps,
                                            int lane) {
  const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(out) % (4 * sizeof(T)) == 0;
  for (int r = warp; r < rows; r += nwarps) {
    const int m = m0 + r;
    if (m >= M) break;
    float rs = 0.f, rq = 0.f;
    for (int c = 4 * lane; c < BN; c += 128) {
      const int n = n0 + c;
      if (n >= N) break;
      const float4 v = *reinterpret_cast<const float4*>(tile + r * tile_stride<BN>() + c);
      float y[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        y[e] = n + e < N ? epilogue_at(y[e], n + e, bias, epilogue) : 0.f;
        rs += y[e];
        rq = fmaf(y[e], y[e], rq);
      }
      T* dst = out + (size_t)m * N + n;
      if (vec) {
        store4(dst, y);
      } else {
        for (int e = 0; e < 4 && n + e < N; ++e) store1(dst + e, y[e]);
      }
    }
    if (partials == nullptr) continue;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      rs += __shfl_xor_sync(0xffffffffu, rs, o);
      rq += __shfl_xor_sync(0xffffffffu, rq, o);
    }
    if (lane == 0) {
      partials[((size_t)blockIdx.x * 2) * M + m] = rs;
      partials[((size_t)blockIdx.x * 2 + 1) * M + m] = rq;
    }
  }
}

// D += A * B, m64n128k16, A K-major and B N-major (the transpose bit) from
// shared memory
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}
template <int BN>
__global__ void __launch_bounds__(bf16mm::NT, 2) wgmma_bf16_kernel(
    const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b,
    const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
    float* __restrict__ partials, int M, int N, int K, int epilogue, int vec_a, int vec_b) {
  using namespace bf16mm;
  constexpr int STAGE = stage_bytes(BN);
  extern __shared__ __align__(1024) uint8_t bf16_smem[];
  // the swizzle atoms (1 KB) must start on a 1 KB boundary
  uint8_t* smem = bf16_smem + ((1024 - (smem_u32(bf16_smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE);
  uint64_t* empty = full + STAGES;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // n fastest: the blocks in flight share a's rows, which stay in L2
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = (K + BK - 1) / BK;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {
    // producer: stage kt into slot kt % STAGES once the consumers freed it.
    // a: core matrix (8 rows, 16 bytes of K) (mg, kc) at (mg * 8 + kc) * 128;
    // b: core matrix (8 K rows, 16 bytes of N) (kg, ng) at (kg * BN/8 + ng) * 128
    for (int kt = 0; kt < nk; ++kt) {
      const int slot = kt % STAGES;
      if (kt >= STAGES) mbar_wait(&empty[slot], ((kt / STAGES) - 1) & 1);
      uint8_t* As = smem + slot * STAGE;
      load_bf16_stage<BN>(As, As + A_BYTES, a, b, m0, n0, kt * BK, M, N, K, vec_a, vec_b, lane,
                          32);
      if (vec_a && vec_b) {
        mbar_arrive_cp_async(&full[slot]);
      } else {
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(&full[slot]);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // consumers: warpgroup wg owns rows 64 * wg .. + 63 of the tile
  const int wg = warp / 4, g = lane / 4, t = lane % 4;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int slot = kt % STAGES;
    mbar_wait(&full[slot], (kt / STAGES) & 1);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const uint32_t a_base = smem_u32(smem + slot * STAGE), b_base = a_base + A_BYTES;
    pin(acc);
    wg_fence();
#pragma unroll
    for (int s = 0; s < BK / 16; ++s) {
      const uint64_t da = gmma_desc(a_base + wg * 64 * 128 + s * 32, 16, 1024, 1);
      const uint64_t db = gmma_desc(b_base + 2 * s * 1024, B_LBO, 1024, 1);
      wgmma_bf16(acc, da, db);
    }
    wg_commit();
    wg_wait<1>();  // the previous stage's products are done: free its slot
    pin(acc);
    if (kt > 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
  }
  wg_wait<0>();
  pin(acc);

  // the ring is free once both warpgroups' products are done (named barrier
  // 1 over the consumers: the producer warp has left)
  auto consumers_sync = [] { asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory"); };
  consumers_sync();
  float* tile = reinterpret_cast<float*>(smem);
  stage_acc<BN>(acc, tile, wg * 64 + (warp % 4) * 16 + g, t);
  consumers_sync();
  finish_rows<BN>(tile, out, bias, partials, m0, n0, M, N, epilogue, BM, warp, CONSUMERS / 32,
                  lane);
}

// D (+)= A * B, m64nNk8 tf32, A from registers (the m16n8k8 A fragment of each
// warp's 16 rows), B K-major from a shared-memory descriptor
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_tf32(float (&d)[80], const uint32_t (&a)[4], uint64_t desc,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, {%80, %81, %82, %83}, %84, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// ---------------------------------------------------------------------------
// float32 on wgmma: 3xTF32 with b split per call into K-major hi / lo
namespace tf32wg {
constexpr int BM = 128;      // output rows per block: two warpgroups of 64
constexpr int NT = 256;      // threads: two warpgroups
constexpr int STAGES = 4;    // depth of the cp.async ring
// a row stride in floats for a stage BK deep: conflict-free fragment reads
__host__ __device__ constexpr int ast(int bk) { return bk + 4; }
constexpr int KPAD = 32;     // b's split is padded along K to this (the split's tile)
__host__ __device__ constexpr int smem_bytes(int bn, int bk) {
  return STAGES * (BM * ast(bk) + 2 * bn * bk) * (int)sizeof(float);
}
}  // namespace tf32wg

// b [K, N] -> hi, lo [N_pad, K_pad]: the TF32 split of b, K-major and
// zero-padded, so the product's B tiles are whole 16-byte rows
__global__ void split_b_kernel(const float* __restrict__ b, float* __restrict__ hi,
                               float* __restrict__ lo, int K, int N, int K_pad) {
  __shared__ float tile[32][33];
  const int k0 = blockIdx.x * 32, n0 = blockIdx.y * 32, tx = threadIdx.x;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int k = k0 + i, n = n0 + tx;
    tile[i][tx] = (k < K && n < N) ? b[(size_t)k * N + n] : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    uint32_t h, l;
    split3(tile[tx][i], h, l);
    const size_t o = (size_t)(n0 + i) * K_pad + k0 + tx;
    hi[o] = __uint_as_float(h);
    lo[o] = __uint_as_float(l);
  }
}

// BK: depth of one stage (16 or 32: two or four k8 steps)
template <int BN, int BK>
__global__ void __launch_bounds__(tf32wg::NT, 1) tf32_wgmma_kernel(
    const float* __restrict__ a, const float* __restrict__ b_hi, const float* __restrict__ b_lo,
    const float* __restrict__ bias, float* __restrict__ out, float* __restrict__ partials, int M,
    int N, int K, int K_pad, int epilogue, int vec_a) {
  using namespace tf32wg;
  constexpr int AST = ast(BK);
  constexpr int KS = BK / 8;         // k8 steps a stage
  constexpr int CPR = BK / 4;        // 16-byte chunks a row
  constexpr int RPP = NT / CPR;      // a rows a load pass
  constexpr int A_FL = BM * AST;
  constexpr int B_FL = BN * BK;      // one of hi / lo
  constexpr int STAGE = A_FL + 2 * B_FL;
  extern __shared__ __align__(128) float tf32wg_smem[];
  float* smem = tf32wg_smem;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  // n fastest: the blocks in flight share a's rows, which stay in L2
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nst = K_pad / BK;
  const int ac = tid % CPR, ar = tid / CPR;

  auto load_stage = [&](int kt, int slot) {
    float* As = smem + slot * STAGE;
    float* Bh = As + A_FL;
    float* Bl = Bh + B_FL;
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < BM / RPP; ++i) {
      const int r = ar + RPP * i, m = m0 + r, k = k0 + 4 * ac;
      float* dst = As + r * AST + 4 * ac;
      if (vec_a) {
        const bool ok = m < M && k < K;
        cp16(dst, a + (ok ? (size_t)m * K + k : 0), ok);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = m < M && k + e < K;
          cp4(dst + e, a + (ok ? (size_t)m * K + k + e : 0), ok);
        }
      }
    }
    // B: BN rows of the split x CPR 16-byte chunks, hi then lo, into the
    // no-swizzle core-matrix layout (8 rows x 16 bytes a core matrix)
    const size_t brow = (size_t)n0 * K_pad + k0;
    for (int i = tid; i < BN * CPR * 2; i += NT) {
      const int lo = i / (BN * CPR), j = i % (BN * CPR), n = j / CPR, kc = j % CPR;
      const float* src = (lo ? b_lo : b_hi) + brow + (size_t)n * K_pad + 4 * kc;
      cp16((lo ? Bl : Bh) + ((kc * (BN / 8) + n / 8) * 8 + n % 8) * 4, src, true);
    }
  };

  // each stage's products go into a fresh tensor-core sum `part`, added to
  // `acc` with a float32 add (the fold)
  constexpr int NACC = BN / 2;
  float acc[NACC], part[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  const int wg_row = (warp / 4) * 64 + (warp % 4) * 16 + g;  // this thread's rows

  auto frags = [&](int it, uint32_t (&ah)[KS][4], uint32_t (&al)[KS][4]) {
    const float* ap = smem + (it % STAGES) * STAGE + wg_row * AST + t;
#pragma unroll
    for (int k8 = 0; k8 < KS; ++k8) {
      const float v[4] = {ap[8 * k8], ap[8 * AST + 8 * k8], ap[8 * k8 + 4],
                          ap[8 * AST + 8 * k8 + 4]};
#pragma unroll
      for (int e = 0; e < 4; ++e) split3(v[e], ah[k8][e], al[k8][e]);
    }
  };
  auto issue = [&](int it, uint32_t (&ah)[KS][4], uint32_t (&al)[KS][4]) {
    const float* Bh = smem + (it % STAGES) * STAGE + A_FL;
    const float* Bl = Bh + B_FL;
    constexpr uint32_t LBO = (BN / 8) * 128, SBO = 128;
    pin(part);
    wg_fence();
#pragma unroll
    for (int k8 = 0; k8 < KS; ++k8) {
      const uint64_t dh = gmma_desc(smem_u32(Bh + 2 * k8 * (BN / 8) * 32), LBO, SBO);
      const uint64_t dl = gmma_desc(smem_u32(Bl + 2 * k8 * (BN / 8) * 32), LBO, SBO);
      wgmma_tf32(part, al[k8], dh, k8);  // k8 == 0: part = a_lo * b_hi
      wgmma_tf32(part, ah[k8], dl, 1);
      wgmma_tf32(part, ah[k8], dh, 1);
    }
    wg_commit();
  };
  auto retire = [&](uint32_t (&ah)[KS][4], uint32_t (&al)[KS][4]) {
    wg_wait<0>();
    pin(part);
#pragma unroll
    for (int k8 = 0; k8 < KS; ++k8) {
      pin4(ah[k8]);
      pin4(al[k8]);
    }
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] += part[i];
  };

  // software-pipelined: while stage it's products run, the next stage's
  // fragments are read and split.  Loads run DIST stages ahead, into the
  // slot of stage it - 2, which every warpgroup retired before the barrier
  // of stage it - 1.
  constexpr int DIST = STAGES - 2;
#pragma unroll
  for (int s = 0; s < DIST; ++s) {
    if (s < nst) load_stage(s, s);
    cp_commit();
  }
  uint32_t ah0[KS][4], al0[KS][4], ah1[KS][4], al1[KS][4];
  auto step = [&](int it, uint32_t (&ah)[KS][4], uint32_t (&al)[KS][4],
                  uint32_t (&nh)[KS][4], uint32_t (&nl)[KS][4]) {
    if (it + DIST < nst) load_stage(it + DIST, (it + DIST) % STAGES);
    cp_commit();
    issue(it, ah, al);
    if (it + 1 < nst) {
      cp_wait<DIST - 1>();
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();  // stage it + 1 landed for all threads
      frags(it + 1, nh, nl);
    }
    retire(ah, al);
  };
  if (nst > 0) {
    cp_wait<DIST - 1>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    frags(0, ah0, al0);
  }
  for (int it = 0; it < nst; it += 2) {
    step(it, ah0, al0, ah1, al1);
    if (it + 1 < nst) step(it + 1, ah1, al1, ah0, al0);
  }
  cp_wait<0>();
  __syncthreads();  // every product is done: the ring takes the output tile
  float* tile = smem;
  stage_acc<BN>(acc, tile, wg_row, t);
  __syncthreads();
  finish_rows<BN>(tile, out, bias, partials, m0, n0, M, N, epilogue, BM, warp, NT / 32, lane);
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

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
struct Args {
  const T *a, *b;
  const float* bias;
  T* out;
  float *partials, *stats, *scratch;
  int M, N, K, epilogue;
};

template <typename T>
int finish(const Args<T>& p, int n_tiles, cudaStream_t stream) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.stats == nullptr) return (int)err;
  stats_reduce_kernel<<<(2 * p.M + 255) / 256, 256, 0, stream>>>(p.partials, p.stats, p.M,
                                                                  n_tiles);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_simt(const Args<T>& p, cudaStream_t stream) {
  const dim3 grid((p.M + simt::BM - 1) / simt::BM, (p.N + simt::BN - 1) / simt::BN);
  simt_kernel<T><<<grid, simt::NT, 0, stream>>>(p.a, p.b, p.bias, p.out,
                                                p.stats != nullptr ? p.partials : nullptr, p.M,
                                                p.N, p.K, p.epilogue);
  return finish(p, (int)grid.y, stream);
}

template <int BN>
int launch_wgmma(const Args<__nv_bfloat16>& p, cudaStream_t stream) {
  const int smem = bf16mm::smem_bytes(BN);
  cudaError_t err = cudaFuncSetAttribute(wgmma_bf16_kernel<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.N + BN - 1) / BN, (p.M + bf16mm::BM - 1) / bf16mm::BM);
  wgmma_bf16_kernel<BN><<<grid, bf16mm::NT, smem, stream>>>(
      p.a, p.b, p.bias, p.out, p.stats != nullptr ? p.partials : nullptr, p.M, p.N, p.K,
      p.epilogue, p.K % 8 == 0 && aligned16(p.a), p.N % 8 == 0 && aligned16(p.b));
  return finish(p, (int)grid.x, stream);
}

template <int BN, int BK>
int launch_tf32_wgmma(const Args<float>& p, cudaStream_t stream) {
  using namespace tf32wg;
  const int K_pad = (p.K + KPAD - 1) / KPAD * KPAD, N_pad = (p.N + BN - 1) / BN * BN;
  float* hi = p.scratch;
  float* lo = p.scratch + (size_t)N_pad * K_pad;
  if (hi == nullptr || !aligned16(hi)) return (int)cudaErrorInvalidValue;
  split_b_kernel<<<dim3(K_pad / 32, N_pad / 32), dim3(32, 8), 0, stream>>>(p.b, hi, lo, p.K,
                                                                          p.N, K_pad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int smem = smem_bytes(BN, BK);
  err = cudaFuncSetAttribute(tf32_wgmma_kernel<BN, BK>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(N_pad / BN, (p.M + BM - 1) / BM);
  tf32_wgmma_kernel<BN, BK><<<grid, NT, smem, stream>>>(
      p.a, hi, lo, p.bias, p.out, p.stats != nullptr ? p.partials : nullptr, p.M, p.N, p.K,
      K_pad, p.epilogue, p.K % 4 == 0 && aligned16(p.a));
  return finish(p, (int)grid.x, stream);
}

static_assert(tf32wg::smem_bytes(160, 16) <= SMEM_LIMIT, "tf32 wgmma ring");
static_assert(tf32wg::smem_bytes(128, 32) <= SMEM_LIMIT, "tf32 wgmma ring");
static_assert(tile_bytes<128>() <= tf32wg::smem_bytes(128, 32), "tile in the ring");
static_assert(tile_bytes<160>() <= tf32wg::smem_bytes(160, 16), "tile in the ring");
static_assert(tile_bytes<128>() <= bf16mm::STAGES * bf16mm::stage_bytes(128), "tile in the ring");
static_assert(bf16mm::A_BYTES % 1024 == 0 && bf16mm::stage_bytes(128) % 1024 == 0,
              "stages on swizzle-atom boundaries");
static_assert(2 * (bf16mm::smem_bytes(128) + 1024) <= 233472, "two blocks an SM");

}  // namespace

// a [M, K], b [K, N], out [M, N] of one type; bias [N] float32 or null (read
// unless epilogue is NONE); partials [ceil(N / bn), 2, M] and stats [2, M]
// float32, both null without stats; scratch (float32, tensor route only)
// [2, ceil(N / bn) * bn, ceil(K / 32) * 32] for b's split; epilogue 0 none,
// 1 bias, 2 gelu, 3 silu; route 0 (SIMT, bn 64) or 1 (tensor cores: bn 128
// or 160 for float32, 128 or 256 for bfloat16)
extern "C" int fused_matmul_f32(const float* a, const float* b, const float* bias, float* out,
                                float* partials, float* stats, float* scratch, int M, int N,
                                int K, int epilogue, int route, int bn, cudaStream_t stream) {
  const Args<float> p{a, b, bias, out, partials, stats, scratch, M, N, K, epilogue};
  if (route == SIMT && bn == simt::BN) return launch_simt(p, stream);
  if (route == TENSOR && bn == 128) return launch_tf32_wgmma<128, 32>(p, stream);
  if (route == TENSOR && bn == 160) return launch_tf32_wgmma<160, 16>(p, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" int fused_matmul_bf16(const __nv_bfloat16* a, const __nv_bfloat16* b,
                                 const float* bias, __nv_bfloat16* out, float* partials,
                                 float* stats, float* scratch, int M, int N, int K, int epilogue,
                                 int route, int bn, cudaStream_t stream) {
  const Args<__nv_bfloat16> p{a, b, bias, out, partials, stats, scratch, M, N, K, epilogue};
  if (route == SIMT && bn == simt::BN) return launch_simt(p, stream);
  if (route == TENSOR && bn == 128) return launch_wgmma<128>(p, stream);
  return (int)cudaErrorInvalidValue;
}
