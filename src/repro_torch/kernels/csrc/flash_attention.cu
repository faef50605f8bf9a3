// Flash attention for Hopper: softmax(Q K^T / sqrt(Dh)) V with an online
// max and exp-sum, float32 in and out, on the tensor cores.
//
// Replaces repro/kernels/flash_attention/kernel.py::flash_attention.  As
// there, the running max m and exp-sum l are updated tile by tile (paper
// Eqs. 5-6) and 1/l is folded into the output write, so the [Sq, Skv]
// logits never reach device memory.  Unlike the TPU kernel, whose grid walks
// the KV axis in order with the carry in VMEM scratch, Hopper blocks run in
// no order: one block owns one (batch*head, 64-row Q tile) and loops over
// the 64-row KV tiles itself.  Causal, sliding-window, tanh softcap and
// grouped-query KV heads (Hkv < H) are masks and an index map, as on the
// TPU; the KV tail (Skv = 77 for SD's text context) is masked to an exact 0
// weight, not asserted divisible.
//
// Bound on the card: operations (4*Sq*Skv*Dh per head against the bytes of
// q, k, v and o).  The reference is float32 and plain TF32 misses its
// tolerance, so both products run "3xTF32" on mma.sync.m16n8k8:
// x = hi + lo with hi = tf32(x), lo = tf32(x - hi), and
// a*b ~ a_lo*b_hi + a_hi*b_lo + a_hi*b_hi, accumulated in float32.
// The FA2 form:
//   * 4 warps, each owning 16 query rows (BQ 64); the KV tiles (64 rows)
//     come through a 2-stage cp.async ring whose zero-fill covers the KV
//     tail and the head-dim padding, so the next tile loads while this one
//     computes;
//   * S = Q K^T on the accumulator fragments: Q (scaled by 1/sqrt(Dh) first,
//     as before) and K are split into hi / lo as their fragments are read
//     from shared memory; Dh 40 / 80 / 160 are 5 / 10 / 20 k8 steps;
//   * the online softmax runs on the fragments: each thread holds two rows,
//     reduced across the four threads of a quad with __shfl_xor_sync;
//   * O += P V keeps P in registers.  The C fragment of S holds columns
//     (2t, 2t+1) of each 8-wide tile, the A fragment of m16n8k8 wants
//     (t, t+4).  Rather than shuffle, the kernel renumbers the tile's 8 KV
//     positions (logical t <-> physical 2t, t+4 <-> 2t+1) in both P and V:
//     a sum over KV positions does not depend on their order, so P's C
//     fragment is its A fragment as it stands, and the V fragment reads
//     rows 2t and 2t+1.  No P buffer in shared memory;
//   * each KV tile's P V is summed in a fresh fragment and folded into O
//     with float32 FMAs (O = alpha O + pv).  The mma's float32 accumulation
//     does not round as an FMA does: carried across all tiles, its error
//     grows with the key count (relative 3.5e-5 at 4,096 keys, cuBLAS
//     float32 2e-6); a tile spans 64 keys.
// Why mma.sync and not wgmma: tf32 wgmma reads B only K-major from shared
// memory, so P V would need V transposed into a second buffer per tile and
// P staged back to shared memory; at the served Dh = 40 every product is
// narrow and the softmax's share weighs more than the product rate.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64, BKV = 64, NT = 128;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
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
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ void split3(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d += a * b in 3xTF32 from split fragments
__device__ __forceinline__ void mma3(float* d, const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                     uint32_t bh0, uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// rows [row0, row0 + 64) of a [rows, Dh] matrix into a [64][DP] tile, zero
// past `rows` and in the columns [Dh, DP); 16-byte copies where `vec`
// (Dh % 4 == 0 and q, k, v start on a 16-byte boundary), else 4-byte ones
template <int DP>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int row0, int rows, int Dh,
                                          bool vec, int tid) {
  constexpr int CH = (DP - 4) / 4;  // 16-byte chunks per padded row
  if (vec) {
    for (int e = tid; e < 64 * CH; e += NT) {
      const int r = e / CH, c = 4 * (e % CH);
      const bool ok = row0 + r < rows && c < Dh;
      cp16(dst + r * DP + c, src + (ok ? (size_t)(row0 + r) * Dh + c : 0), ok);
    }
  } else {
    for (int e = tid; e < 64 * (DP - 4); e += NT) {
      const int r = e / (DP - 4), c = e % (DP - 4);
      const bool ok = row0 + r < rows && c < Dh;
      cp4(dst + r * DP + c, src + (ok ? (size_t)(row0 + r) * Dh + c : 0), ok);
    }
  }
}

template <int DK>  // head dim padded to 8 * DK
__global__ void __launch_bounds__(NT) flash_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, int H, int Hkv, int Sq, int Skv, int Dh, int causal, int window,
    float softcap, float scale, bool vec) {
  // row stride = 4 (mod 8) floats: the fragment reads of Q, K (rows g, column
  // t) and V (rows 2t, 2t + 1, column g) hit 32 distinct banks
  constexpr int DP = 8 * DK + 4;
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;               // [2][BKV][DP]
  float* Vs = Ks + 2 * BKV * DP;  // [2][BKV][DP]
  float* Qs = Vs + 2 * BKV * DP;  // [BQ][DP]
  // PRESPLIT (Dh <= 40, the sd_v14 level-0 width that takes most of the
  // time): Q's fragments are split once into registers, and each K / V tile
  // is split once by the whole block, hi in place and lo into KL / VL (which
  // take Q's buffer), instead of by every warp as it reads its fragments
  constexpr bool PRESPLIT = DK <= 5;
  float* KL = Qs;                 // [BKV][DP]
  float* VL = Qs + BKV * DP;      // [BKV][DP]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int q0 = blockIdx.x * BQ;
  const float* qb = q + (size_t)(b * H + h) * Sq * Dh;
  const float* kb = k + (size_t)(b * Hkv + hk) * Skv * Dh;
  const float* vb = v + (size_t)(b * Hkv + hk) * Skv * Dh;
  float* ob = o + (size_t)(b * H + h) * Sq * Dh;

  // KV tiles that hold a visible key for some row of this Q tile; skipped
  // tiles are fully masked, which the online update would zero anyway
  const int n_kt = (Skv + BKV - 1) / BKV;
  int kt_end = n_kt;
  if (causal) kt_end = min(n_kt, (min(Sq, q0 + BQ) - 1) / BKV + 1);
  const int kt_begin = window > 0 ? max(0, q0 - window + 1) / BKV : 0;

  load_tile<DP>(Qs, qb, q0, Sq, Dh, vec, tid);
  cp_commit();
  if (kt_begin < kt_end) {
    load_tile<DP>(Ks, kb, kt_begin * BKV, Skv, Dh, vec, tid);
    load_tile<DP>(Vs, vb, kt_begin * BKV, Skv, Dh, vec, tid);
  }
  cp_commit();

  const int r0 = warp * 16 + g;  // this thread's rows r0 and r0 + 8 of the Q tile
  // the A fragment of (scale * Q) for k8 step kk, split
  auto q_frag = [&](int kk, uint32_t (&ah)[4], uint32_t (&al)[4]) {
    const float* qp = Qs + r0 * DP + 8 * kk + t;
    const float qv[4] = {qp[0] * scale, qp[8 * DP] * scale, qp[4] * scale,
                         qp[8 * DP + 4] * scale};
#pragma unroll
    for (int e = 0; e < 4; ++e) split3(qv[e], ah[e], al[e]);
  };
  uint32_t qh[PRESPLIT ? DK : 1][4], ql[PRESPLIT ? DK : 1][4];
  if constexpr (PRESPLIT) {
    cp_wait<1>();
    __syncthreads();  // Q landed
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) q_frag(kk, qh[kk], ql[kk]);
    __syncthreads();  // Q's buffer is KL / VL from here on
  }

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[DK][4];
#pragma unroll
  for (int n = 0; n < DK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int slot = (kt - kt_begin) & 1;
    if (kt + 1 < kt_end) {
      load_tile<DP>(Ks + (slot ^ 1) * BKV * DP, kb, (kt + 1) * BKV, Skv, Dh, vec, tid);
      load_tile<DP>(Vs + (slot ^ 1) * BKV * DP, vb, (kt + 1) * BKV, Skv, Dh, vec, tid);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();  // tile kt (and Q) landed for every thread
    float* Kt = Ks + slot * BKV * DP;
    float* Vt = Vs + slot * BKV * DP;
    const int k0 = kt * BKV;
    if constexpr (PRESPLIT) {
      for (int e = tid; e < 2 * BKV * 2 * DK; e += NT) {
        const int kv = e / (BKV * 2 * DK), r = (e / (2 * DK)) % BKV, c = 4 * (e % (2 * DK));
        float4* hi = reinterpret_cast<float4*>((kv ? Vt : Kt) + r * DP + c);
        float4* lo = reinterpret_cast<float4*>((kv ? VL : KL) + r * DP + c);
        float4 x = *hi, xh, xl;
        xh.x = __uint_as_float(tf32(x.x));
        xh.y = __uint_as_float(tf32(x.y));
        xh.z = __uint_as_float(tf32(x.z));
        xh.w = __uint_as_float(tf32(x.w));
        xl.x = __uint_as_float(tf32(x.x - xh.x));
        xl.y = __uint_as_float(tf32(x.y - xh.y));
        xl.z = __uint_as_float(tf32(x.z - xh.z));
        xl.w = __uint_as_float(tf32(x.w - xh.w));
        *hi = xh;
        *lo = xl;
      }
      __syncthreads();  // the tile's hi / lo are in place
    }

    // S = (scale * Q) K^T: 8 column tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      uint32_t ah[4], al[4];
      if constexpr (PRESPLIT) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ah[e] = qh[kk][e];
          al[e] = ql[kk][e];
        }
      } else {
        q_frag(kk, ah, al);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int off = (8 * j + g) * DP + 8 * kk + t;
        uint32_t bh0, bl0, bh1, bl1;
        if constexpr (PRESPLIT) {
          bh0 = __float_as_uint(Kt[off]);
          bh1 = __float_as_uint(Kt[off + 4]);
          bl0 = __float_as_uint(KL[off]);
          bl1 = __float_as_uint(KL[off + 4]);
        } else {
          split3(Kt[off], bh0, bl0);
          split3(Kt[off + 4], bh1, bl1);
        }
        mma3(s[j], ah, al, bh0, bh1, bl0, bl1);
      }
    }

    // online softmax on the fragments: s[j][0..1] are row r0, s[j][2..3] row
    // r0 + 8.  A tile inside the KV length with no option set needs no mask.
    if (causal || window > 0 || softcap > 0.f || k0 + BKV > Skv) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qp = q0 + r0 + (e >= 2 ? 8 : 0), kp = k0 + 8 * j + 2 * t + (e & 1);
          float sv = s[j][e];
          if (softcap > 0.f) sv = softcap * tanhf(sv / softcap);
          bool ok = true;
          if (causal) ok = ok && kp <= qp;
          if (window > 0) ok = ok && kp > qp - window;
          if (!ok) sv = NEG_INF;
          if (kp >= Skv) sv = -INFINITY;  // past the KV tail: weight exactly 0
          s[j][e] = sv;
        }
    }
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = exp2f((m[i] - m_new) * LOG2E);
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f((s[j][e] - m[e >> 1]) * LOG2E);
        rs[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      l[i] = l[i] * alpha[i] + rs[i];
    }

    // pv = P V of this tile, P's C fragment used as its A fragment under the
    // renumbering logical key t <-> physical 2t, t + 4 <-> 2t + 1 within each
    // 8-key tile; then O = alpha O + pv
    float pv[DK][4];
#pragma unroll
    for (int n = 0; n < DK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[n][e] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t ah[4], al[4];
      split3(s[j][0], ah[0], al[0]);
      split3(s[j][2], ah[1], al[1]);
      split3(s[j][1], ah[2], al[2]);
      split3(s[j][3], ah[3], al[3]);
      const int row = (8 * j + 2 * t) * DP + g;
#pragma unroll
      for (int n = 0; n < DK; ++n) {
        const int off = row + 8 * n;
        uint32_t bh0, bl0, bh1, bl1;
        if constexpr (PRESPLIT) {
          bh0 = __float_as_uint(Vt[off]);
          bh1 = __float_as_uint(Vt[off + DP]);
          bl0 = __float_as_uint(VL[off]);
          bl1 = __float_as_uint(VL[off + DP]);
        } else {
          split3(Vt[off], bh0, bl0);
          split3(Vt[off + DP], bh1, bl1);
        }
        mma3(pv[n], ah, al, bh0, bh1, bl0, bl1);
      }
    }
#pragma unroll
    for (int n = 0; n < DK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = fmaf(acc[n][e], alpha[e >> 1], pv[n][e]);
    __syncthreads();  // tile kt is consumed before its slot is refilled
  }
  cp_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = q0 + r0 + 8 * i;
    if (qp >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < DK; ++n) {
      const int d = 8 * n + 2 * t;
      if (d < Dh) ob[(size_t)qp * Dh + d] = acc[n][2 * i] * inv;
      if (d + 1 < Dh) ob[(size_t)qp * Dh + d + 1] = acc[n][2 * i + 1] * inv;
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <int DK>
int launch(const float* q, const float* k, const float* v, float* o, int B, int H, int Hkv,
           int Sq, int Skv, int Dh, int causal, int window, float softcap, float scale,
           cudaStream_t stream) {
  // the K / V ring, then Q (and with PRESPLIT the lo halves of a K and V tile)
  const size_t smem =
      (size_t)(4 * BKV + (DK <= 5 ? 2 * BKV : BQ)) * (8 * DK + 4) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<DK>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_kernel<DK><<<grid, NT, smem, stream>>>(q, k, v, o, H, Hkv, Sq, Skv, Dh, causal, window,
                                               softcap, scale,
                                               Dh % 4 == 0 && aligned16(q) && aligned16(k) &&
                                                   aligned16(v));
  return (int)cudaGetLastError();
}

}  // namespace

// q/o [B, H, Sq, Dh], k/v [B, Hkv, Skv, Dh]; Dh <= 160, H % Hkv == 0.  The
// head dim is padded (zero-filled on load) to the next of 16, 32, 40, 80,
// 160: the sd_toy and sd_v14 widths, one instantiation each.
extern "C" int flash_attention_f32(const float* q, const float* k, const float* v, float* o,
                                   int B, int H, int Hkv, int Sq, int Skv, int Dh, int causal,
                                   int window, float softcap, float scale, cudaStream_t stream) {
#define FA_CASE(dk)                                                                            \
  if (Dh <= 8 * dk)                                                                            \
    return launch<dk>(q, k, v, o, B, H, Hkv, Sq, Skv, Dh, causal, window, softcap, scale, \
                      stream);
  if (Dh <= 0) return (int)cudaErrorInvalidValue;
  FA_CASE(2)
  FA_CASE(4)
  FA_CASE(5)
  FA_CASE(10)
  FA_CASE(20)
#undef FA_CASE
  return (int)cudaErrorInvalidValue;
}
