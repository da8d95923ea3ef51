// The four FantastIC4 serving kernels for Hopper (sm_90a), CUDA C++.
//
// Built by kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and bound with ctypes: every entry takes device pointers and the CUDA
// stream as void*, ints as int, and returns cudaGetLastError() (0 = ok).
//
// Translation notes (TPU Pallas -> GPU):
// * The Pallas matmul carries its accumulator in VMEM across an "arbitrary"
//   K grid; here K is a loop inside the block (layer_pass).
// * _ws_kernel and _stream_kernel rely on the TPU grid running in order and
//   the stream kernel rewrites its activation in place.  GPU blocks run in
//   parallel and in no order, so the layer loop is inside one launch and
//   activations shared between CTAs ping-pong between two buffers; where
//   CTAs must see each other's results (ws between layers, stream between
//   decode and use) the launch is cooperative and syncs the grid.
// * A decoded 512x512 fp32 layer is 1 MiB and the packed MLP-GSC stack is
//   386 KB, both past the 227 KB of shared memory a block may use, so codes
//   are decoded in 32x64 tiles and streamed from L2 (50 MB).
#include <cooperative_groups.h>

#include "fantastic4_common.cuh"

namespace cg = cooperative_groups;
using f4::LayerDesc;

namespace {

// Kernel 1 -- replaces kernels/fantastic4_matmul.py:fantastic4_matmul_pallas.
// One CTA per (32-row, 64-column) output tile, K looped inside.  Bound: at
// serving batches the packed codes (bytes) for small M, FFMA issue for large
// M; the design reads each code byte once per row tile and decodes it into
// shared memory through a 16-entry codebook.
__global__ void __launch_bounds__(f4::NT)
matmul_kernel(const float* x, LayerDesc d, const float* omega,
              const float* scale, int M, float* y) {
  __shared__ f4::CoreSmem s;
  // omega and alpha2 stay on the device: reading them here spares the
  // wrapper a device-to-host copy per call.
  for (int i = 0; i < 4; ++i) d.omega[i] = omega[i];
  if (scale != nullptr) d.scale = *scale;
  const int r0 = blockIdx.y * f4::MAXR;
  const int n0 = blockIdx.x * f4::BN;
  f4::layer_pass<false, false>(s, d, x + (size_t)r0 * d.K, d.K, d.K,
                               min(f4::MAXR, M - r0), nullptr,
                               y + (size_t)r0 * d.N, d.N, n0, f4::BN,
                               min(n0 + f4::BN, d.N));
}

// Kernel 2 -- replaces kernels/fantastic4_fused_mlp.py:fantastic4_fused_mlp_pallas
// (batch_tiled, and db with double_buffer).  One CTA per row tile walks the
// whole stack; activations between layers never leave shared memory (two
// ping-pong buffers of rows x D fp32).  db splits each tile's two row
// groups across two CTAs: they traverse the stack concurrently on two SMs,
// which is what the TPU's skewed schedule emulated inside one core.
__global__ void __launch_bounds__(f4::NT)
tiled_kernel(const float* x, int M, int K0, const LayerDesc* layers, int L,
             int dmax, int rows_per_cta, float* y) {
  extern __shared__ float dyn[];
  __shared__ f4::CoreSmem s;
  float* bufs[2] = {dyn, dyn + (size_t)rows_per_cta * dmax};
  const int r0 = blockIdx.x * rows_per_cta;
  const int nr = min(rows_per_cta, M - r0);
  const int n_last = layers[L - 1].N;
  const float* in = x + (size_t)r0 * K0;
  int in_ld = K0, in_cols = K0;
  for (int l = 0; l < L; ++l) {
    const LayerDesc d = layers[l];
    const bool last = l == L - 1;
    float* out = last ? y + (size_t)r0 * n_last : bufs[l & 1];
    const int out_ld = last ? n_last : dmax;
    const int n_end = last ? d.N : d.N + (d.N & 1);
    f4::layer_pass<false, false>(s, d, in, in_ld, in_cols, nr, nullptr, out,
                                 out_ld, 0, f4::BN, n_end);
    in = out;
    in_ld = dmax;
    in_cols = n_end;
  }
}

// Kernel 3 -- replaces fantastic4_fused_mlp.py:fantastic4_fused_mlp_ws_pallas.
// Weight-stationary latency schedule: the output columns of each layer are
// split across CTAs, every code byte is read once per inference, and the
// small activation ping-pongs between two global (L2-resident) buffers with
// a grid sync between layers (cooperative launch).  Bound: the packed
// bytes and the per-layer grid syncs.
__global__ void __launch_bounds__(f4::NT)
ws_kernel(const float* x, int M, int K0, const LayerDesc* layers, int L,
          int dmax, float* act, float* y) {
  cg::grid_group grid = cg::this_grid();
  __shared__ f4::CoreSmem s;
  const int n_first = blockIdx.x * f4::BN, n_stride = gridDim.x * f4::BN;
  const int n_last = layers[L - 1].N;
  const float* in = x;
  int in_ld = K0, in_cols = K0;
  for (int l = 0; l < L; ++l) {
    const LayerDesc d = layers[l];
    const bool last = l == L - 1;
    float* out = last ? y : act + (size_t)(l & 1) * M * dmax;
    const int out_ld = last ? n_last : dmax;
    const int n_end = last ? d.N : d.N + (d.N & 1);
    if (l == 0)
      f4::layer_pass<false, false>(s, d, in, in_ld, in_cols, M, nullptr, out,
                                   out_ld, n_first, n_stride, n_end);
    else
      f4::layer_pass<true, false>(s, d, in, in_ld, in_cols, M, nullptr, out,
                                  out_ld, n_first, n_stride, n_end);
    if (!last) grid.sync();
    in = out;
    in_ld = dmax;
    in_cols = n_end;
  }
}

// Kernel 4 -- replaces fantastic4_fused_mlp.py:fantastic4_fused_mlp_stream_pallas.
// Decode-amortized streaming: every layer is decoded once per batch into an
// fp32 scratch in global memory (all CTAs together), one grid sync, then
// each CTA walks its batch tiles through the stack reading the decoded
// weights from L2.  A tile's rows are only ever touched by its own CTA, and
// its activation ping-pongs between two global buffers (no in-place update).
__global__ void __launch_bounds__(f4::NT)
stream_kernel(const float* x, int M, int K0, const LayerDesc* layers, int L,
              int dmax, int block_m, float* act, float* wdec, float* y) {
  cg::grid_group grid = cg::this_grid();
  __shared__ f4::CoreSmem s;
  const int gtid = blockIdx.x * f4::NT + threadIdx.x;
  const int gsize = gridDim.x * f4::NT;
  for (int l = 0; l < L; ++l) {
    const LayerDesc d = layers[l];
    const int total = d.K * d.N;
    for (int idx = gtid; idx < total; idx += gsize) {
      const int k = idx / d.N, c = idx % d.N;
      const int b = d.packed[(size_t)(k >> 1) * d.ldp + c];
      wdec[d.wdec_off + idx] = f4::decode_code((k & 1) ? (b >> 4) : (b & 15), d.omega);
    }
  }
  grid.sync();
  const int n_last = layers[L - 1].N;
  for (int r0 = blockIdx.x * block_m; r0 < M; r0 += gridDim.x * block_m) {
    const int nr = min(block_m, M - r0);
    const float* in = x + (size_t)r0 * K0;
    int in_ld = K0, in_cols = K0;
    for (int l = 0; l < L; ++l) {
      const LayerDesc d = layers[l];
      const bool last = l == L - 1;
      float* out = last ? y + (size_t)r0 * n_last
                        : act + (size_t)(l & 1) * M * dmax + (size_t)r0 * dmax;
      const int out_ld = last ? n_last : dmax;
      const int n_end = last ? d.N : d.N + (d.N & 1);
      if (l == 0)
        f4::layer_pass<false, true>(s, d, in, in_ld, in_cols, nr, wdec, out,
                                    out_ld, 0, f4::BN, n_end);
      else
        f4::layer_pass<true, true>(s, d, in, in_ld, in_cols, nr, wdec, out,
                                   out_ld, 0, f4::BN, n_end);
      in = out;
      in_ld = dmax;
      in_cols = n_end;
    }
  }
}

int coop_grid(const void* kernel, int want) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, f4::NT, 0);
  const int cap = sms * (per_sm > 0 ? per_sm : 1);
  return want < cap ? (want > 0 ? want : 1) : cap;
}

}  // namespace

extern "C" {

int f4_matmul(const float* x, const uint8_t* packed, const float* omega,
              const float* alpha1, const float* bias, const float* scale_dev,
              float scale, int quant, int act, int M, int K, int N, float* y,
              void* stream) {
  LayerDesc d{};
  d.packed = packed;
  d.alpha1 = alpha1;
  d.bias = bias;
  d.scale = scale;
  d.K = K;
  d.N = N;
  d.ldp = N;
  d.act = act;
  d.quant = quant;
  dim3 grid((N + f4::BN - 1) / f4::BN, (M + f4::MAXR - 1) / f4::MAXR);
  matmul_kernel<<<grid, f4::NT, 0, (cudaStream_t)stream>>>(x, d, omega, scale_dev,
                                                         M, y);
  return (int)cudaGetLastError();
}

int f4_fused_tiled(const float* x, int M, int K0, const void* layers, int L,
                   int dmax, int rows_per_cta, float* y, void* stream) {
  const size_t dyn = 2 * sizeof(float) * (size_t)rows_per_cta * dmax;
  cudaError_t e = cudaFuncSetAttribute(
      tiled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (e != cudaSuccess) return (int)e;
  const int grid = (M + rows_per_cta - 1) / rows_per_cta;
  tiled_kernel<<<grid, f4::NT, dyn, (cudaStream_t)stream>>>(
      x, M, K0, (const LayerDesc*)layers, L, dmax, rows_per_cta, y);
  return (int)cudaGetLastError();
}

int f4_fused_ws(const float* x, int M, int K0, const void* layers, int L,
                int dmax, float* act, float* y, void* stream) {
  const LayerDesc* lp = (const LayerDesc*)layers;
  int grid = coop_grid((const void*)ws_kernel, (dmax + f4::BN - 1) / f4::BN);
  void* args[] = {(void*)&x, (void*)&M, (void*)&K0, (void*)&lp, (void*)&L,
                  (void*)&dmax, (void*)&act, (void*)&y};
  cudaError_t e = cudaLaunchCooperativeKernel((const void*)ws_kernel, grid,
                                              f4::NT, args, 0,
                                              (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

int f4_fused_stream(const float* x, int M, int K0, const void* layers, int L,
                    int dmax, int block_m, float* act, float* wdec, float* y,
                    void* stream) {
  const LayerDesc* lp = (const LayerDesc*)layers;
  // at least one CTA per SM: the decode phase spreads over the whole card
  // even when the batch has a single tile
  int sms = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int tiles = (M + block_m - 1) / block_m;
  int grid = coop_grid((const void*)stream_kernel, tiles > sms ? tiles : sms);
  void* args[] = {(void*)&x, (void*)&M, (void*)&K0, (void*)&lp, (void*)&L,
                  (void*)&dmax, (void*)&block_m, (void*)&act, (void*)&wdec,
                  (void*)&y};
  cudaError_t e = cudaLaunchCooperativeKernel((const void*)stream_kernel, grid,
                                              f4::NT, args, 0,
                                              (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
