// Fused ECL assignment + dequantization for Hopper (sm_90a), CUDA C++.
//
// Replaces kernels/ecl_quant.py:ecl_quant_pallas (body _kernel) of the JAX
// package.  For every element of a contiguous fp32 w it takes
//   code = argmin_c (w - v_c)^2 + pen_c,   v_c = sum_{i: bit i of c} omega_i
// over the 16 subset sums, and writes the uint8 code and w_hat = v_code.
// The EC4T trainer calls it once per quantized tensor in the fake-quant
// forward, in the EMA probability update, in stats and at freeze time.
//
// Bound: bytes.  Each element reads w (4 B) and writes its code (1 B) and
// w_hat (4 B); the 16 candidates are ~64 flops, far below the card's rate.
// The design is one thread per element in a grid-stride loop, the codebook
// and penalty staged once per block in shared memory, no padding for ragged
// sizes.  At the MLP layer sizes (<= 262,144 elements) a launch is a few
// microseconds, so launch latency, not the bound, dominates.
//
// Bitwise contract with the plain version (kernels/ref.py ecl_quant_ref):
// * the cost is written with __fsub_rn / __fmul_rn / __fadd_rn, so nvcc's
//   default FMA contraction cannot round (w - v)^2 + pen once where the
//   plain version rounds twice;
// * v_c starts at 0 and adds omega_i for the set bits in ascending i, which
//   is bitwise equal to bitplanes.codebook(omega)[c];
// * best starts at +inf with code 0 and a candidate wins only on a strict
//   <, so ties keep the lowest code, as torch.argmin's first index.
//
// omega (4,) and the penalty (16,) are device pointers: the trainer builds
// the penalty on the card, so a launch needs no host synchronisation.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;   // 16 blocks per SM of an H100

__global__ void __launch_bounds__(kThreads)
ecl_quant_kernel(const float* __restrict__ w, const float* __restrict__ omega,
                 const float* __restrict__ penalty, int n,
                 uint8_t* __restrict__ codes, float* __restrict__ w_hat) {
  __shared__ float book[16];
  __shared__ float pen[16];
  if (threadIdx.x < 16) {
    const int c = threadIdx.x;
    float v = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if ((c >> i) & 1) v = __fadd_rn(v, omega[i]);
    book[c] = v;
    pen[c] = penalty[c];
  }
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < n; idx += stride) {
    const float x = w[idx];
    float best = INFINITY;
    int code = 0;
    float val = 0.f;
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const float d = __fsub_rn(x, book[c]);
      const float cost = __fadd_rn(__fmul_rn(d, d), pen[c]);
      if (cost < best) {
        best = cost;
        code = c;
        val = book[c];
      }
    }
    codes[idx] = (uint8_t)code;
    w_hat[idx] = val;
  }
}

}  // namespace

extern "C" {

// w (n,) fp32, omega (4,) fp32, penalty (16,) fp32 -> codes (n,) uint8 and
// w_hat (n,) fp32, all contiguous device memory; returns cudaGetLastError().
int f4_ecl_quant(const float* w, const float* omega, const float* penalty,
                 int n, uint8_t* codes, float* w_hat, void* stream) {
  if (n <= 0) return 0;
  int blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  ecl_quant_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      w, omega, penalty, n, codes, w_hat);
  return (int)cudaGetLastError();
}

}  // extern "C"
