// Shared device-side arithmetic of the FantastIC4 serving kernels.
//
// Every kernel (the chain's matmul_kernel and stream_kernel in
// fantastic4.cu, the cluster kernels of fantastic4_cluster.cuh) computes its
// outputs through f4c::slice_pass:
// nibble unpack, W = sum_i omega_i * bit_i(code) (a 16-entry codebook built
// with the same add sequence as the plain version), one per-output dot over
// K in ascending order with __fmaf_rn from 0.f, then the section V epilogue
//   y = act(acc * alpha1 + b), then y * alpha2  or  clip(rint(y / s), +-127).
// Because every kernel does this term for term, the port's int8 paths
// (chain, batch-tiled, db, ws, stream) are bitwise equal to each other.
//
// Plain fp32 FFMA on CUDA cores: no tensor cores (TF32 would break the fp32
// gate), no fast-math (the epilogue multiplies and adds with __fmul_rn /
// __fadd_rn so FMA contraction cannot move a result by an ulp).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace f4 {

// One layer of a frozen pack, as the Python wrappers lay it out in device
// memory (kernels/fantastic4_fused_mlp.py::DESC_DTYPE mirrors this).  The
// code copy a kernel reads is slice-major (kernels/slices.py): n_slices
// slices of slice_w columns, slice_bytes each, from byte slice_off.
struct LayerDesc {
  const uint8_t* packed;   // (K/2, ldp) row-pair packed codes, low nibble = row 2r
  const float* alpha1;     // (N,)
  const float* bias;       // (N,)
  int n_slices;            // column slices of the layer's code copy
  int slice_w;             // columns per slice: ceil(n_end / n_slices)
  float omega[4];
  float scale;             // alpha2 (fp32) or the int8 scale s_l
  int K;                   // contraction rows, even (odd K carries a zero code row)
  int N;                   // output columns
  int ldp;                 // packed row stride (N, or D for stacked operands)
  int act;                 // 0 none, 1 relu, 2 tanh-gelu
  int quant;               // 1: emit clip(rint(y / scale), +-127)
  int slice_off;           // bytes: this layer's first code slice
  int slice_bytes;         // bytes of one slice, a multiple of 16
};
static_assert(sizeof(LayerDesc) == 80, "LayerDesc layout is shared with Python");

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

}  // namespace f4
