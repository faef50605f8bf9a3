// Uni-conv for Hopper: a K x K "same" convolution on the (L = H*W, C) layout
// as an implicit GEMM on the tensor cores, float32 in and out.
//
// Replaces repro/kernels/uniconv/kernel.py::uniconv (plus the bias and the
// stride-2 subsampling of repro/kernels/uniconv/ops.py::uniconv).
//
// The GEMM is out[M = B*Ho*Wo, Cout] = bias + sum over taps f and input
// channels c of x[b, (yo*s + oy) * W + (xo*s + ox), c] * w[f, c, n]; taps
// whose input pixel leaves the image contribute zero (the TPU kernel's edge
// mask).  Stride 2 computes only the kept centres (2*yo, 2*xo).  There is no
// im2col and no halo copy in device memory.
//
// Bound on the card: operations (2*M*Cin*Cout*K*K against a few MB).  The
// reference computes in float32, and plain TF32 (10-bit mantissa) misses
// its tolerance, so every product is split "3xTF32": x = hi + lo with
// hi = tf32(x), lo = tf32(x - hi), and a*b ~ a_lo*b_hi + a_hi*b_lo +
// a_hi*b_hi, accumulated in float32 (the dropped a_lo*b_lo is ~2^-22 of
// a*b).  Three TF32 products run at 495/3 = 165 TFLOP/s, 2.5x the float32
// CUDA-core peak.  The design:
//   * weights are static: the wrapper splits them once per weight tensor
//     into w_hi / w_lo, laid out K-major [K*K, Cout_pad, Cin_pad] (tf32
//     wgmma takes its shared-memory B operand only K-major);
//   * a block owns a 128 x BN output tile and walks (tap, 16-channel chunk)
//     stages through a 4-deep ring in shared memory, filled by 16-byte
//     cp.async whose zero-fill (src-size 0) supplies the taps outside the
//     image, rows past M and channels past Cin (4-byte copies where Cin is
//     not a multiple of 4 or x does not start on a 16-byte boundary); B
//     lands in wgmma's no-swizzle core-matrix layout (8 rows x 16 bytes per
//     128-byte core matrix);
//   * two consumer warpgroups of 64 rows each read their A fragment from
//     the staged tile into registers, split it, and issue
//     wgmma.m64nBNk8.f32.tf32.tf32 with A from registers and B (w_hi, w_lo)
//     from shared-memory descriptors: three products per k8 step.  The
//     loop is software-pipelined: while one stage's products run, the
//     next stage's fragments are read and split;
//   * each stage's products go into a fresh tensor-core sum that is added
//     to the float32 accumulator with an ordinary add (STAGE_FOLD), so the
//     tensor cores' own float32 accumulation, which strays from
//     round-to-nearest, never runs over more than one stage: one
//     accumulator over a 9 x 2560 reduction erred by about 1e-4 relative on
//     an H100, five times the tolerance, the fold by about 1e-6
//     (kernels/uniconv/fold_ab.py);
//   * the N tile follows Cout (8/32 for the narrow VAE outputs, 160 for
//     320, else 64, two blocks an SM), and where the output tiles alone
//     leave the card short of blocks the K*K*Cin reduction is split over
//     gridDim.z; the partials go to scratch and a second launch adds them
//     in a fixed order with the bias (no atomics: the same result on every
//     run).  The plan is ops.py::tile_plan.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;        // output rows per block: two warpgroups of 64
constexpr int NT = 256;        // threads: two warpgroups
constexpr int BK = 16;         // input channels per stage: two k8 steps
constexpr int STAGES = 4;      // depth of the cp.async ring
constexpr int AST = BK + 4;    // A row stride in floats: conflict-free fragment reads
// fold each stage's tensor-core sum into a float32 accumulator (see the
// kernel); UNICONV_STAGE_FOLD=0 accumulates the whole reduction on the
// tensor cores, for the accuracy A/B of kernels/uniconv/fold_ab.py
#ifndef UNICONV_STAGE_FOLD
#define UNICONV_STAGE_FOLD 1
#endif
constexpr bool STAGE_FOLD = UNICONV_STAGE_FOLD;
// the N tiles instantiated, and the blocks an SM is built to hold at each
// (two where a thread's registers stay under 128); ops.py's tile plan
// restates these and checks them against uniconv_tiling at first use
constexpr int BN_TILES[] = {8, 32, 64, 160};
constexpr int NUM_BN = sizeof(BN_TILES) / sizeof(BN_TILES[0]);
__host__ __device__ constexpr int min_blocks(int bn) { return bn <= 64 ? 2 : 1; }

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

// round to TF32 (nearest, ties away from zero): the low 13 mantissa bits cleared
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ void split3(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// wgmma.m64nNk8 tf32, A from registers (the m16n8k8 A fragment of each warp's
// 16 rows), B from a shared-memory descriptor, D += A * B.
__device__ __forceinline__ void wgmma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_tf32(float (&d)[16], const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_tf32(float (&d)[80], const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, "
      "{%80, %81, %82, %83}, %84, p, 1, 1;\n}\n"
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

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// registers a pending wgmma reads or writes: keep them live and unmoved
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void pin(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// no-swizzle K-major descriptor: LBO = bytes between the two 16-byte K
// halves of a k8 step, SBO = bytes between 8-row groups along N
__device__ __forceinline__ uint64_t gmma_desc(const float* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

template <int BN>
__global__ void __launch_bounds__(NT, min_blocks(BN))
    uniconv_kernel(const float* __restrict__ x, const float* __restrict__ w_hi,
                   const float* __restrict__ w_lo, const float* __restrict__ bias,
                   float* __restrict__ out, int H, int W, int Cin, int Cout, int Cin_pad,
                   int Cout_pad, int K, int stride, int Ho, int Wo, int M, bool vec) {
  constexpr int KS = BK / 8;            // k8 steps per stage
  constexpr int CPR = BK / 4;           // 16-byte chunks per A row / weight row
  constexpr int RPP = NT / CPR;         // A rows per load pass
  constexpr int A_FLOATS = BM * AST;
  constexpr int B_FLOATS = BN * BK;     // one of w_hi / w_lo
  constexpr int STAGE = A_FLOATS + 2 * B_FLOATS;
  extern __shared__ __align__(128) float smem[];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int split = gridDim.z, kpart = blockIdx.z;
  const int pad = (K - 1) / 2;
  const int chunks = Cin_pad / BK;
  const int nk = K * K * chunks;
  // this block's share of the reduction: stages [kt0, kt1)
  const int kt0 = (int)((long long)nk * kpart / split);
  const int kt1 = (int)((long long)nk * (kpart + 1) / split);

  // A loads: rows ar + RPP * i of the tile, 16-byte chunk ac of the BK channels
  const int ac = tid % CPR, ar = tid / CPR;
  int rb[BM / RPP], ry[BM / RPP], rx[BM / RPP];
  bool rok[BM / RPP];
#pragma unroll
  for (int i = 0; i < BM / RPP; ++i) {
    const int m = m0 + ar + RPP * i;
    rok[i] = m < M;
    const int mm = rok[i] ? m : 0;
    rb[i] = mm / (Ho * Wo);
    const int rem = mm % (Ho * Wo);
    ry[i] = (rem / Wo) * stride;
    rx[i] = (rem % Wo) * stride;
  }

  auto load_stage = [&](int kt, int slot) {
    float* As = smem + slot * STAGE;
    float* Bh = As + A_FLOATS;
    float* Bl = Bh + B_FLOATS;
    const int f = kt / chunks, c0 = (kt % chunks) * BK;
    const int oy = f / K - pad, ox = f % K - pad;
#pragma unroll
    for (int i = 0; i < BM / RPP; ++i) {
      const int iy = ry[i] + oy, ix = rx[i] + ox;
      const bool in = rok[i] && iy >= 0 && iy < H && ix >= 0 && ix < W;
      const float* src = x + ((size_t)(rb[i] * H + (in ? iy : 0)) * W + (in ? ix : 0)) * Cin;
      float* dst = As + (ar + RPP * i) * AST + 4 * ac;
      const int c = c0 + 4 * ac;
      if (vec) {
        const bool ok = in && c < Cin;
        cp16(dst, src + (ok ? c : 0), ok);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = in && c + e < Cin;
          cp4(dst + e, src + (ok ? c + e : 0), ok);
        }
      }
    }
    // B: BN weight rows x CPR 16-byte chunks, hi then lo, into core matrices
    const size_t wrow = ((size_t)f * Cout_pad + n0) * Cin_pad + c0;
    for (int i = tid; i < BN * CPR * 2; i += NT) {
      const int lo = i / (BN * CPR), j = i % (BN * CPR), n = j / CPR, kc = j % CPR;
      const float* src = (lo ? w_lo : w_hi) + wrow + (size_t)n * Cin_pad + 4 * kc;
      cp16((lo ? Bl : Bh) + ((kc * (BN / 8) + n / 8) * 8 + n % 8) * 4, src, true);
    }
  };

  // Accumulators: the D fragments of a warpgroup's 64 x BN tile, BN / 2 a
  // thread.  With STAGE_FOLD each stage's products go into a fresh
  // tensor-core sum `part`, added to `acc` with a float32 add; without it
  // the products accumulate into `acc` itself.
  constexpr int NACC = BN / 2;
  float acc[NACC], part[NACC];
  float (&d)[NACC] = STAGE_FOLD ? part : acc;
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  const int wg_row = (warp / 4) * 64 + (warp % 4) * 16 + g;  // this thread's rows
  const int nst = kt1 - kt0;

  // this thread's A fragments of stage it, split into hi / lo
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
  // d (+)= the stage's 3 * KS products, issued and committed (not waited)
  auto issue = [&](int it, uint32_t (&ah)[KS][4], uint32_t (&al)[KS][4]) {
    const float* Bh = smem + (it % STAGES) * STAGE + A_FLOATS;
    const float* Bl = Bh + B_FLOATS;
    constexpr uint32_t LBO = (BN / 8) * 128, SBO = 128;
    pin(d);
    wg_fence();
#pragma unroll
    for (int k8 = 0; k8 < KS; ++k8) {
      const uint64_t dh = gmma_desc(Bh + 2 * k8 * (BN / 8) * 32, LBO, SBO);
      const uint64_t dl = gmma_desc(Bl + 2 * k8 * (BN / 8) * 32, LBO, SBO);
      wgmma_tf32(d, al[k8], dh, STAGE_FOLD ? k8 : 1);  // fold, k8 == 0: part = a_lo * b_hi
      wgmma_tf32(d, ah[k8], dl, 1);
      wgmma_tf32(d, ah[k8], dh, 1);
    }
    wg_commit();
  };
  auto retire = [&](uint32_t (&ah)[KS][4], uint32_t (&al)[KS][4]) {
    wg_wait_all();
    pin(d);
#pragma unroll
    for (int k8 = 0; k8 < KS; ++k8) {
      pin(ah[k8]);
      pin(al[k8]);
    }
    if constexpr (STAGE_FOLD) {
#pragma unroll
      for (int i = 0; i < NACC; ++i) acc[i] += part[i];
    }
  };

  // software-pipelined: while stage it's products run, the next stage's
  // fragments are read and split.  Loads run DIST = STAGES - 2 stages
  // ahead, into the slot of stage it - 2, which every warpgroup retired
  // before the barrier of stage it - 1.
  constexpr int DIST = STAGES - 2;
#pragma unroll
  for (int s = 0; s < DIST; ++s) {
    if (s < nst) load_stage(kt0 + s, s);
    cp_commit();
  }
  uint32_t ah0[KS][4], al0[KS][4], ah1[KS][4], al1[KS][4];
  auto step = [&](int it, uint32_t (&ah)[KS][4], uint32_t (&al)[KS][4],
                  uint32_t (&nh)[KS][4], uint32_t (&nl)[KS][4]) {
    if (it + DIST < nst) load_stage(kt0 + it + DIST, (it + DIST) % STAGES);
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

  // epilogue: D fragments hold (row, col 2t, 2t + 1) and (row + 8, same) per
  // 8-column tile.  One split: out = acc + bias.  Several: partial sums into
  // out[kpart] (scratch [split, M, Cout]) for the reduce launch.
  float* dst_base = out + (size_t)kpart * M * Cout;
  auto emit = [&](int r, int n, float v0, float v1) {
    const int m = m0 + r;
    if (m >= M) return;
    float* row = dst_base + (size_t)m * Cout;
    const bool add_bias = split == 1 && bias != nullptr;
    if (n < Cout) row[n] = v0 + (add_bias ? bias[n] : 0.f);
    if (n + 1 < Cout) row[n + 1] = v1 + (add_bias ? bias[n + 1] : 0.f);
  };
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = n0 + j * 8 + 2 * t;
    emit(wg_row, n, acc[4 * j], acc[4 * j + 1]);
    emit(wg_row + 8, n, acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// out[i] = bias[i % Cout] + sum over parts p = 0, 1, ... of partials[p][i], in that order
__global__ void splitk_reduce(const float* __restrict__ partials, const float* __restrict__ bias,
                              float* __restrict__ out, int MN, int Cout, int split) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float s = 0.f;
  for (int p = 0; p < split; ++p) s += partials[(size_t)p * MN + i];
  out[i] = s + (bias != nullptr ? bias[i % Cout] : 0.f);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

struct Args {
  const float *x, *w_hi, *w_lo, *bias;
  float *out, *partials;
  int B, H, W, Cin, Cout, Cin_pad, Cout_pad, K, stride, split;
};

template <int BN>
int launch(const Args& a, cudaStream_t stream) {
  const int Ho = (a.H + a.stride - 1) / a.stride, Wo = (a.W + a.stride - 1) / a.stride;
  const int M = a.B * Ho * Wo;
  const size_t smem = (size_t)STAGES * (BM * AST + 2 * BN * BK) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(uniconv_kernel<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((M + BM - 1) / BM, a.Cout_pad / BN, a.split);
  uniconv_kernel<BN><<<grid, NT, smem, stream>>>(
      a.x, a.w_hi, a.w_lo, a.bias, a.split > 1 ? a.partials : a.out, a.H, a.W, a.Cin, a.Cout,
      a.Cin_pad, a.Cout_pad, a.K, a.stride, Ho, Wo, M, a.Cin % 4 == 0 && aligned16(a.x));
  err = cudaGetLastError();
  if (err != cudaSuccess || a.split == 1) return (int)err;
  const int MN = M * a.Cout;
  splitk_reduce<<<(MN + 255) / 256, 256, 0, stream>>>(a.partials, a.bias, a.out, MN, a.Cout,
                                                       a.split);
  return (int)cudaGetLastError();
}

}  // namespace

// x [B, H*W, Cin]; w_hi / w_lo [K*K, Cout_pad, Cin_pad] (tf32 split of the
// weights, zero-padded); bias [Cout] or null; out [B, Ho*Wo, Cout];
// partials [split, B*Ho*Wo, Cout] scratch, read only when split > 1.
// bn is the N tile (one of BN_TILES), dividing Cout_pad; Cin_pad is a
// multiple of 16; w_hi and w_lo start on a 16-byte boundary (x need not).
extern "C" int uniconv_f32(const float* x, const float* w_hi, const float* w_lo,
                           const float* bias, float* out, float* partials, int B, int H, int W,
                           int Cin, int Cout, int Cin_pad, int Cout_pad, int K, int stride, int bn,
                           int split, cudaStream_t stream) {
  if (Cin_pad % BK != 0 || bn <= 0 || Cout_pad % bn != 0 || split < 1 || !aligned16(w_hi) ||
      !aligned16(w_lo))
    return (int)cudaErrorInvalidValue;
  const Args a{x, w_hi, w_lo, bias, out, partials, B, H, W, Cin, Cout, Cin_pad, Cout_pad, K,
               stride, split};
  switch (bn) {
    case 8: return launch<8>(a, stream);
    case 32: return launch<32>(a, stream);
    case 64: return launch<64>(a, stream);
    case 160: return launch<160>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The tiling the plan in ops.py must agree with: v = {BM, BK, NUM_BN, then
// (bn, min_blocks(bn)) per N tile}; returns the number of ints written, or
// -1 if cap is too small.
extern "C" int uniconv_tiling(int* v, int cap) {
  if (cap < 3 + 2 * NUM_BN) return -1;
  v[0] = BM;
  v[1] = BK;
  v[2] = NUM_BN;
  for (int i = 0; i < NUM_BN; ++i) {
    v[3 + 2 * i] = BN_TILES[i];
    v[4 + 2 * i] = min_blocks(BN_TILES[i]);
  }
  return 3 + 2 * NUM_BN;
}
