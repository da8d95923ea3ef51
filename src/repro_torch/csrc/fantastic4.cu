// The FantastIC4 serving kernels for Hopper (sm_90a), CUDA C++.
//
// Built by kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and bound with ctypes: every entry takes device pointers and the CUDA
// stream as void*, ints as int, and returns cudaGetLastError() (0 = ok).
//
// Translation notes (TPU Pallas -> GPU):
// * The Pallas matmul carries its accumulator in VMEM across an "arbitrary"
//   K grid; here K is a loop inside the block (layer_pass).
// * The TPU megakernels keep a tile's activations in one core's VMEM while
//   the grid walks the layers in order.  Here a thread-block cluster holds
//   them in distributed shared memory (fantastic4_cluster.cuh): each of its
//   CTAs owns a column slice of every layer, and a cluster barrier between
//   layers replaces the ordered grid.  batch_tiled/db and ws launch as
//   clusters (cudaLaunchKernelEx); there is no grid-wide barrier.
// * _stream_kernel relies on the TPU grid running in order and rewrites its
//   activation in place.  Here the layer loop is inside one cooperative
//   launch that syncs the grid between decode and use, and activations
//   shared between CTAs ping-pong between two global buffers.
// * A decoded 512x512 fp32 layer is 1 MiB and the packed MLP-GSC stack is
//   386 KB, both past the 227 KB of shared memory a block may use: the
//   chain and stream decode 32x64 tiles streamed from L2 (50 MB); the
//   cluster kernels hold one slice of the packed codes per CTA (1/8 of a
//   layer, or 1/8 of the stack for ws) and decode it in registers.
#include <cooperative_groups.h>

#include "fantastic4_cluster.cuh"
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

// Kernel 2 -- replaces kernels/fantastic4_fused_mlp.py:
// fantastic4_fused_mlp_pallas (batch_tiled, and db with double_buffer).
// One thread-block cluster per row tile (<= 32 rows) walks the whole
// stack; each CTA owns a column slice of every layer
// (fantastic4_cluster.cuh) and activations stay in the cluster's shared
// memory.  Bound: FMA issue and the shared-memory loads of the inputs on
// 8 SMs per tile at 16-32 rows; the dependent FMA chain (sum K_l) and the
// layer hand-offs at a few rows.  Before each layer a CTA copies that
// layer's code slice into shared memory with one bulk async copy; db keeps
// two slice buffers and requests layer l+1's slice before layer l's FMAs,
// the overlap of the next decode's load with this layer's matmul that the
// TPU's skewed two-row-group schedule bought.
template <bool DB>
__global__ void __launch_bounds__(f4c::NT, 1)
tiled_kernel(f4c::StackArgs a) {
  f4c::run_stack<DB ? f4c::kDouble : f4c::kSingle>(a);
}

// Kernel 3 -- replaces fantastic4_fused_mlp.py:fantastic4_fused_mlp_ws_pallas.
// Weight-stationary latency schedule: one cluster per group of <= 8 rows,
// and each CTA copies its slice of the whole stack's codes (cut from the
// layers' true extents, not the D x D stacked operands) into shared memory
// at launch, one mbarrier per layer, so layer 0 starts when its slice
// lands and every code byte is read from L2 once per cluster per
// inference.  Time no longer grows with rows: more rows, more clusters.
// Bound: the dependent FMA chain and the L - 1 layer hand-offs.  Two CTAs
// per SM (registers capped at 128 a thread, shared memory ~82 KB for
// MLP-GSC), so 256 rows -- 32 clusters -- run in one wave.
__global__ void __launch_bounds__(f4c::NT, 2)
ws_kernel(f4c::StackArgs a) {
  f4c::run_stack<f4c::kStationary>(a);
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

// Launch one cluster of `cluster` CTAs per row tile.  A configuration the
// card cannot hold (no cluster fits an SM group) is an error, never a
// quiet switch to another kernel.
cudaError_t launch_cluster(const void* kernel, int mode, f4c::StackArgs a,
                           int cluster, cudaStream_t stream) {
  // a refused call also sets the runtime's last error: clear it, so the
  // next launch's check does not report this one
  auto refuse = [](cudaError_t e) { cudaGetLastError(); return e; };
  // a pass holds at most 8 accumulators a thread: 32 rows of a cluster
  if (a.rows < 1 || a.rows > f4c::MAX_TILE_ROWS) return cudaErrorInvalidValue;
  const int dyn = f4c::smem_bytes(mode, a.L, a.rows, a.ldx, a.code_region);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (e != cudaSuccess) return refuse(e);
  if (cluster > 8) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return refuse(e);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(((a.M + a.rows - 1) / a.rows) * cluster));
  cfg.blockDim = dim3(f4c::NT);
  cfg.dynamicSmemBytes = (size_t)dyn;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (e != cudaSuccess) return refuse(e);
  if (clusters < 1) return cudaErrorLaunchOutOfResources;
  void* args[] = {(void*)&a};
  e = cudaLaunchKernelExC(&cfg, kernel, args);
  return e == cudaSuccess ? e : refuse(e);
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
                   const uint8_t* codes, int cluster, int rows, int ldx,
                   int slice_max, int db, float* y, void* stream) {
  f4c::StackArgs a{x, y, (const LayerDesc*)layers, codes, M, K0, L, rows,
                   ldx, (db ? 2 : 1) * slice_max};
  return db ? launch_cluster((const void*)tiled_kernel<true>, f4c::kDouble, a,
                             cluster, (cudaStream_t)stream)
            : launch_cluster((const void*)tiled_kernel<false>, f4c::kSingle, a,
                             cluster, (cudaStream_t)stream);
}

int f4_fused_ws(const float* x, int M, int K0, const void* layers, int L,
                const uint8_t* codes, int cluster, int rows, int ldx,
                int code_bytes, float* y, void* stream) {
  f4c::StackArgs a{x, y, (const LayerDesc*)layers, codes, M, K0, L, rows,
                   ldx, code_bytes};
  return launch_cluster((const void*)ws_kernel, f4c::kStationary, a, cluster,
                        (cudaStream_t)stream);
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
