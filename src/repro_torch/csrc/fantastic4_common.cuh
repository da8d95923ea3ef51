// Shared device-side core of the four FantastIC4 serving kernels.
//
// Every kernel in fantastic4.cu computes its outputs through layer_pass():
// nibble unpack, W = sum_i omega_i * bit_i(code) (a 16-entry codebook built
// with the same add sequence as the plain version), one per-output dot over
// K in ascending order with __fmaf_rn, then the section V epilogue
//   y = act(acc * alpha1 + b), then y * alpha2  or  clip(rint(y / s), +-127).
// Because the four kernels share this code term for term, the port's int8
// paths (chain, batch-tiled, db, ws, stream) are bitwise equal to each other.
//
// Plain fp32 FFMA on CUDA cores: no tensor cores (TF32 would break the fp32
// gate), no fast-math (the epilogue multiplies and adds with __fmul_rn /
// __fadd_rn so FMA contraction cannot move a result by an ulp).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace f4 {

constexpr int NT = 256;          // threads per CTA
constexpr int BN = 64;           // output columns per pass (one per thread column)
constexpr int BK = 32;           // contraction rows staged in shared memory
constexpr int RG = NT / BN;      // row groups of threads
constexpr int MAXR = 32;         // rows per pass
constexpr int RPT = MAXR / RG;   // accumulators per thread

// One layer of a frozen pack, as the Python wrappers lay it out in device
// memory (kernels/fantastic4_fused_mlp.py::layer_table mirrors this).
struct LayerDesc {
  const uint8_t* packed;   // (K/2, ldp) row-pair packed codes, low nibble = row 2r
  const float* alpha1;     // (N,)
  const float* bias;       // (N,)
  long long wdec_off;      // float offset of this layer in the stream decode scratch
  float omega[4];
  float scale;             // alpha2 (fp32) or the int8 scale s_l
  int K;                   // contraction rows, even (odd K carries a zero code row)
  int N;                   // output columns
  int ldp;                 // packed row stride (N, or D for stacked operands)
  int act;                 // 0 none, 1 relu, 2 tanh-gelu
  int quant;               // 1: emit clip(rint(y / scale), +-127)
  int pad_[2];
};
static_assert(sizeof(LayerDesc) == 80, "LayerDesc layout is shared with Python");

struct alignas(16) CoreSmem {
  float xs[MAXR][BK];          // rows of 32 floats: 16-byte aligned float4 reads
  float wt[BK][BN];
  float book[16];
};

// v_c = sum_i omega_i * bit_i(c), added in the plain version's order.
__device__ __forceinline__ float decode_code(int c, const float* om) {
  float v = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    v = __fadd_rn(v, __fmul_rn(om[i], (float)((c >> i) & 1)));
  return v;
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float kBeta = 0.7978845608028654f;   // sqrt(2 / pi)
  const float kKappa = 0.044715f;
  float inner = kBeta * (x + kKappa * x * x * x);
  return 0.5f * x * (1.f + tanhf(inner));
}

__device__ __forceinline__ float epilogue(float acc, float a1, float b,
                                          int act, float scale, int quant) {
  float y = __fadd_rn(__fmul_rn(acc, a1), b);
  if (act == 1) y = fmaxf(y, 0.f);
  else if (act == 2) y = gelu_tanh(y);
  if (quant) {
    float q = rintf(__fdiv_rn(y, scale));      // round half to even, as torch.round
    q = fminf(fmaxf(q, -127.f), 127.f);
    y = (float)(int8_t)q;
  } else {
    y = __fmul_rn(y, scale);
  }
  return y;
}

template <bool CG>
__device__ __forceinline__ float load_in(const float* p) {
  // CG: data another CTA (or this one) wrote earlier in the same launch;
  // read through L2 so no stale L1 line is seen after a grid sync.
  if constexpr (CG) return __ldcg(p);
  else return *p;
}

// out[r][c] for r < rows and column chunks n_first, n_first + n_stride, ...
// below n_end.  Columns in [d.N, n_end) are written as 0 (the even pad the
// next layer's zero code row meets).  `in` has in_cols valid columns; the
// rest of the contraction reads zero.  DECODED takes weights from the
// stream kernel's decode scratch instead of decoding packed codes.
template <bool IN_CG, bool DECODED>
__device__ void layer_pass(CoreSmem& s, const LayerDesc& d,
                           const float* in, int in_ld, int in_cols, int rows,
                           const float* wdec, float* out, int out_ld,
                           int n_first, int n_stride, int n_end) {
  const int tid = threadIdx.x, tx = tid % BN, ty = tid / BN;
  if (tid < 16) s.book[tid] = decode_code(tid, d.omega);
  for (int r0 = 0; r0 < rows; r0 += MAXR) {
    const int nr = min(MAXR, rows - r0);
    for (int n0 = n_first; n0 < n_end; n0 += n_stride) {
      float acc[RPT];
#pragma unroll
      for (int j = 0; j < RPT; ++j) acc[j] = 0.f;
      for (int k0 = 0; k0 < d.K; k0 += BK) {
        const int kn = min(BK, d.K - k0);
        __syncthreads();
        for (int idx = tid; idx < MAXR * BK; idx += NT) {
          const int r = idx / BK, kk = idx % BK, k = k0 + kk;
          s.xs[r][kk] = (r < nr && k < in_cols)
              ? load_in<IN_CG>(in + (size_t)(r0 + r) * in_ld + k) : 0.f;
        }
        if constexpr (DECODED) {
          for (int idx = tid; idx < BK * BN; idx += NT) {
            const int kk = idx / BN, cc = idx % BN, k = k0 + kk, c = n0 + cc;
            s.wt[kk][cc] = (k < d.K && c < d.N)
                ? __ldcg(wdec + d.wdec_off + (size_t)k * d.N + c) : 0.f;
          }
        } else {
          for (int idx = tid; idx < (BK / 2) * BN; idx += NT) {
            const int pr = idx / BN, cc = idx % BN, kp = k0 / 2 + pr, c = n0 + cc;
            const int b = (kp < d.K / 2 && c < d.N)
                ? (int)d.packed[(size_t)kp * d.ldp + c] : 0;
            s.wt[2 * pr][cc] = s.book[b & 15];
            s.wt[2 * pr + 1][cc] = s.book[b >> 4];
          }
        }
        __syncthreads();
        // four k at a time: one float4 read of x per row serves four
        // FMAs, which are still issued in ascending k for every output
        int kk = 0;
        for (; kk + 4 <= kn; kk += 4) {
          const float w0 = s.wt[kk][tx], w1 = s.wt[kk + 1][tx];
          const float w2 = s.wt[kk + 2][tx], w3 = s.wt[kk + 3][tx];
#pragma unroll
          for (int j = 0; j < RPT; ++j) {
            const float4 xv =
                *reinterpret_cast<const float4*>(&s.xs[ty + RG * j][kk]);
            acc[j] = __fmaf_rn(xv.x, w0, acc[j]);
            acc[j] = __fmaf_rn(xv.y, w1, acc[j]);
            acc[j] = __fmaf_rn(xv.z, w2, acc[j]);
            acc[j] = __fmaf_rn(xv.w, w3, acc[j]);
          }
        }
        for (; kk < kn; ++kk) {
          const float w = s.wt[kk][tx];
#pragma unroll
          for (int j = 0; j < RPT; ++j)
            acc[j] = __fmaf_rn(s.xs[ty + RG * j][kk], w, acc[j]);
        }
      }
      const int c = n0 + tx;
      if (c < n_end) {
#pragma unroll
        for (int j = 0; j < RPT; ++j) {
          const int r = ty + RG * j;
          if (r < nr) {
            float y = 0.f;
            if (c < d.N)
              y = epilogue(acc[j], d.alpha1[c], d.bias[c], d.act, d.scale, d.quant);
            out[(size_t)(r0 + r) * out_ld + c] = y;
          }
        }
      }
    }
  }
  __syncthreads();
}

}  // namespace f4
