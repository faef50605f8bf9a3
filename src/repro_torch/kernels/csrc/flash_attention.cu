// Flash attention for Hopper: softmax(Q K^T / sqrt(Dh)) V with an online
// max and exp-sum, float32 in and out, float32 accumulation.
//
// Replaces repro/kernels/flash_attention/kernel.py::flash_attention.  As
// there, the running max m and exp-sum l are updated tile by tile (paper
// Eqs. 5-6) and 1/l is folded into the output write, so the [Sq, Skv]
// logits never reach device memory.  Unlike the TPU kernel, whose grid walks
// the KV axis in order with the carry in VMEM scratch, Hopper blocks run in
// no order: one block owns one (batch*head, 64-row Q tile) and loops over
// the 64-row KV tiles itself, with m, l and the [64, Dh] accumulator in
// registers.  The KV tail (Skv = 77 for SD's text context) is masked, not
// asserted divisible.  Dh is a template parameter rounded up to a multiple
// of 16 (40/80/160 for sd_v14, 16/32 for sd_toy); the Q, K and V tiles take
// up to 137 KB of shared memory at Dh = 160, so the kernel opts in to
// dynamic shared memory above 48 KB.  Causal, sliding-window, tanh softcap
// and grouped-query KV heads (Hkv < H) are masks and an index map, as on
// the TPU.
//
// Bound on the card: at the served sd_v14 shapes the 4*Sq*Skv*Dh operations
// per head dominate the bytes of q, k, v and o, so it is bound by
// operations; this first version runs them on the float32 CUDA cores.
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64, BKV = 64, NT = 256;
constexpr float NEG_INF = -1e30f;

template <int DCH>  // Dh <= 16 * DCH
__global__ void __launch_bounds__(NT) flash_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, int H, int Hkv, int Sq, int Skv, int Dh, int causal, int window,
    float softcap, float scale) {
  extern __shared__ float smem[];
  const int Dp = Dh + 1;  // padded row stride: conflict-free column reads for even Dh
  float* Qs = smem;       // [BQ][Dp], pre-scaled
  float* Ks = Qs + BQ * Dp;
  float* Vs = Ks + BKV * Dp;
  float* Ps = Vs + BKV * Dp;  // [BQ][BKV + 1]

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int q0 = blockIdx.x * BQ;
  const float* qb = q + (size_t)(b * H + h) * Sq * Dh;
  const float* kb = k + (size_t)(b * Hkv + hk) * Skv * Dh;
  const float* vb = v + (size_t)(b * Hkv + hk) * Skv * Dh;
  float* ob = o + (size_t)(b * H + h) * Sq * Dh;

  for (int e = tid; e < BQ * Dh; e += NT) {
    const int r = e / Dh, d = e % Dh;
    Qs[r * Dp + d] = q0 + r < Sq ? qb[(size_t)(q0 + r) * Dh + d] * scale : 0.f;
  }

  float m[4], l[4], acc[4][DCH];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DCH; ++j) acc[i][j] = 0.f;
  }

  // KV tiles that hold a visible key for some row of this Q tile; skipped
  // tiles are fully masked, which the online update would zero anyway
  const int n_kt = (Skv + BKV - 1) / BKV;
  int kt_end = n_kt;
  if (causal) kt_end = min(n_kt, (min(Sq, q0 + BQ) - 1) / BKV + 1);
  const int kt_begin = window > 0 ? max(0, q0 - window + 1) / BKV : 0;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BKV;
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int e = tid; e < BKV * Dh; e += NT) {
      const int r = e / Dh, d = e % Dh;
      const bool in = k0 + r < Skv;
      Ks[r * Dp + d] = in ? kb[(size_t)(k0 + r) * Dh + d] : 0.f;
      Vs[r * Dp + d] = in ? vb[(size_t)(k0 + r) * Dh + d] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < Dh; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * Dp + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = Ks[(tx + 16 * j) * Dp + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        float sv = s[i][j];
        if (softcap > 0.f) sv = softcap * tanhf(sv / softcap);
        bool ok = true;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && kp > qp - window;
        if (!ok) sv = NEG_INF;
        if (kp >= Skv) sv = -INFINITY;  // past the KV tail: weight exactly 0
        s[i][j] = sv;
        mx = fmaxf(mx, sv);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off, 16));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * (BKV + 1) + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off, 16);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DCH; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    const int kn = min(BKV, Skv - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float vv[DCH];
#pragma unroll
      for (int j = 0; j < DCH; ++j) {
        const int d = tx + 16 * j;
        vv[j] = d < Dh ? Vs[kk * Dp + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(ty + 16 * i) * (BKV + 1) + kk];
#pragma unroll
        for (int j = 0; j < DCH; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DCH; ++j) {
      const int d = tx + 16 * j;
      if (d < Dh) ob[(size_t)qp * Dh + d] = acc[i][j] / denom;
    }
  }
}

template <int DCH>
int launch(const float* q, const float* k, const float* v, float* o, int B, int H, int Hkv,
           int Sq, int Skv, int Dh, int causal, int window, float softcap, float scale,
           cudaStream_t stream) {
  const int Dp = Dh + 1;
  const size_t smem = ((size_t)(BQ + 2 * BKV) * Dp + (size_t)BQ * (BKV + 1)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<DCH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_kernel<DCH><<<grid, NT, smem, stream>>>(q, k, v, o, H, Hkv, Sq, Skv, Dh, causal, window,
                                                softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q/o [B, H, Sq, Dh], k/v [B, Hkv, Skv, Dh]; Dh <= 160, H % Hkv == 0
extern "C" int flash_attention_f32(const float* q, const float* k, const float* v, float* o,
                                   int B, int H, int Hkv, int Sq, int Skv, int Dh, int causal,
                                   int window, float softcap, float scale, cudaStream_t stream) {
#define FA_CASE(n) \
  case n:          \
    return launch<n>(q, k, v, o, B, H, Hkv, Sq, Skv, Dh, causal, window, softcap, scale, stream);
  switch ((Dh + 15) / 16) {
    FA_CASE(1)
    FA_CASE(2)
    FA_CASE(3)
    FA_CASE(4)
    FA_CASE(5)
    FA_CASE(6)
    FA_CASE(7)
    FA_CASE(8)
    FA_CASE(9)
    FA_CASE(10)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FA_CASE
}
