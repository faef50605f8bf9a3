// Uni-conv for Hopper: a K x K "same" convolution on the (L = H*W, C) layout
// as an implicit GEMM, float32 in and out, float32 accumulation.
//
// Replaces repro/kernels/uniconv/kernel.py::uniconv (plus the bias and the
// stride-2 subsampling of repro/kernels/uniconv/ops.py::uniconv).
//
// The GEMM is out[M = B*Ho*Wo, Cout] = sum over taps f and input channels c
// of x[b, (yo*s + oy) * W + (xo*s + ox), c] * w[f, c, n], with taps whose
// input pixel leaves the image contributing zero (the TPU kernel's edge
// mask).  Stride 2 computes only the kept outputs: output (yo, xo) is the
// centre (2*yo, 2*xo), which equals the full-resolution conv subsampled
// [::2, ::2].  There is no im2col and no halo copy in device memory: each
// block stages the shifted x rows of one tap and one Cin chunk, and the
// matching [Cin chunk, Cout] weight slice, in shared memory.
//
// Bound on the card: at the served sd_v14 shapes the conv does 2*M*Cin*Cout*K*K
// float32 operations against a few MB of traffic, so it is bound by
// operations.  This first version runs them on the float32 CUDA cores
// (64x64 block tile, 4x4 outputs per thread); tensor cores (TF32 or bf16
// wgmma) are later work.
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;   // output rows per block
constexpr int BN = 64;   // output channels per block
constexpr int BK = 16;   // input channels per stage
constexpr int NT = 256;  // threads: 16 x 16, each 4 rows x 4 channels

__global__ void __launch_bounds__(NT) uniconv_kernel(
    const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
    float* __restrict__ out, int H, int W, int Cin, int Cout, int K, int stride, int Ho,
    int Wo, int M) {
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int pad = (K - 1) / 2;

  // A loads: thread reads channel (tid % 16) of tile rows ty + 16 * i
  int row_b[4], row_y[4], row_x[4];
  bool row_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    row_ok[i] = m < M;
    const int mm = row_ok[i] ? m : 0;
    row_b[i] = mm / (Ho * Wo);
    const int rem = mm % (Ho * Wo);
    row_y[i] = (rem / Wo) * stride;
    row_x[i] = (rem % Wo) * stride;
  }
  const int ak = tid % 16;
  // B loads: thread reads rows (tid / 64) + 4 * i of the chunk, column tid % 64
  const int bk = tid / 64, bn = tid % 64;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int f = 0; f < K * K; ++f) {
    const int oy = f / K - pad, ox = f % K - pad;
    const float* src[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int iy = row_y[i] + oy, ix = row_x[i] + ox;
      const bool ok = row_ok[i] && iy >= 0 && iy < H && ix >= 0 && ix < W;
      src[i] = ok ? x + ((size_t)(row_b[i] * H + iy) * W + ix) * Cin : nullptr;
    }
    const float* wf = w + (size_t)f * Cin * Cout;
    for (int c0 = 0; c0 < Cin; c0 += BK) {
      const int c = c0 + ak;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        As[ak][ty + 16 * i] = (src[i] != nullptr && c < Cin) ? src[i][c] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kk = bk + 4 * i, n = n0 + bn;
        Bs[kk][bn] = (c0 + kk < Cin && n < Cout) ? wf[(size_t)(c0 + kk) * Cout + n] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < Cout) out[(size_t)m * Cout + n] = acc[i][j] + (bias != nullptr ? bias[n] : 0.f);
    }
  }
}

}  // namespace

// x [B, H*W, Cin], w [K*K, Cin, Cout], bias [Cout] or null, out [B, Ho*Wo, Cout]
extern "C" int uniconv_f32(const float* x, const float* w, const float* bias, float* out, int B,
                           int H, int W, int Cin, int Cout, int K, int stride,
                           cudaStream_t stream) {
  const int Ho = (H + stride - 1) / stride, Wo = (W + stride - 1) / stride;
  const int M = B * Ho * Wo;
  dim3 grid((M + BM - 1) / BM, (Cout + BN - 1) / BN);
  uniconv_kernel<<<grid, NT, 0, stream>>>(x, w, bias, out, H, W, Cin, Cout, K, stride, Ho, Wo,
                                          M);
  return (int)cudaGetLastError();
}
