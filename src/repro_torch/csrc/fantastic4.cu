// The FantastIC4 serving kernels for Hopper (sm_90a), CUDA C++.
//
// Built by kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and bound with ctypes: every entry takes device pointers and the CUDA
// stream as void*, ints as int, and returns the CUDA error of its launch
// (0 = ok).  A launch the card refuses is returned, never replaced by
// another kernel.
//
// Every kernel computes its outputs with f4c::slice_pass
// (fantastic4_cluster.cuh): a CTA holds one column slice of a layer's
// packed codes in shared memory (copied by one bulk async copy from a
// slice-major copy built once per pack, kernels/slices.py), decodes the
// weights in registers, and reads the layer input from shared memory; the
// K loop has no barrier and no L2 load, and a tile runs accumulators only
// for the rows it has.  The kernels differ in how they cut the work and
// where a layer's output goes.
//
// Translation notes (TPU Pallas -> GPU):
// * The Pallas matmul carries its accumulator in VMEM across an "arbitrary"
//   K grid; here K is a loop inside the block and the grid runs over
//   (column slice, row tile), so a 1-row batch still spreads a 512-wide
//   layer over 32 SMs.  The seven launches of a served chain overlap by
//   programmatic dependent launch: layer l+1's CTAs copy their code slice
//   while layer l runs, and wait for its output with griddepcontrol.
// * The TPU megakernels keep a tile's activations in one core's VMEM while
//   the grid walks the layers in order.  batch_tiled/db and ws hold them in
//   a thread-block cluster's distributed shared memory (each CTA owns a
//   column slice of every layer; a cluster barrier between layers replaces
//   the ordered grid), launched with cudaLaunchKernelEx.
// * _stream_kernel walks layers outer and batch tiles inner and decodes each
//   layer once per batch.  Here one cooperative launch walks the layers;
//   per layer each CTA takes a (column slice, row-tile group) work item,
//   copies that slice's codes into its shared memory once and serves every
//   row tile of the item from that copy -- each code byte is read from L2
//   once per CTA per layer.  Activations ping-pong between two global
//   buffers that stay in L2, read with ld.global.cg after one grid barrier
//   per layer boundary.
// * A decoded 512x512 fp32 layer is 1 MiB and the packed MLP-GSC stack
//   386 KB, past the 227 KB of shared memory a block may use: no kernel
//   decodes into memory.  A chain or stream slice is K/2 x 16 bytes (4 KB
//   at K = 512), a cluster CTA's 1/8 of a layer (or of the stack for ws).
#include "fantastic4_cluster.cuh"
#include "fantastic4_common.cuh"

using f4::LayerDesc;

namespace {

constexpr int STREAM_NT = 128;   // threads per stream CTA: 8 rows x 16 columns

// Programmatic dependent launch (PTX griddepcontrol; no-ops in a launch
// without the attribute).  wait: the previous grid in the stream has
// finished and its writes are visible; launch_dependents: the next grid
// may start its CTAs.
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// Rows [r0, r0 + nr) of src (row stride ld, `valid` columns) into the
// shared tile xs (row stride ldx) as K columns, zero past `valid`.  Read
// through L2 (ld.global.cg): src may have been written by another CTA of
// this launch before a grid sync, or by the grid this one waited for.
// Eight vector loads a thread are in flight before their stores, so a
// 32 x 512 tile takes two L2 round trips.
template <int NTH, typename V>
__device__ __forceinline__ void stage_vec(float* xs, int ldx,
                                          const float* base, int ld, int K,
                                          int nr) {
  constexpr int E = sizeof(V) / sizeof(float), U = 8;
  const int v = K / E, total = nr * v;
  // element i is (row i / v, vector i % v); a thread steps by NTH
  const int dr = NTH / v, dc = NTH % v;
  int r = threadIdx.x / v, c = threadIdx.x % v;
  for (int i0 = threadIdx.x; i0 < total; i0 += U * NTH) {
    V t[U];
    const int r_first = r, c_first = c;
#pragma unroll
    for (int j = 0; j < U; ++j) {
      if (i0 + j * NTH < total)
        t[j] = __ldcg(reinterpret_cast<const V*>(base + (size_t)r * ld) + c);
      c += dc;
      r += dr;
      if (c >= v) { c -= v; ++r; }
    }
    r = r_first;
    c = c_first;
#pragma unroll
    for (int j = 0; j < U; ++j) {
      if (i0 + j * NTH < total)
        *reinterpret_cast<V*>(xs + (size_t)r * ldx + E * c) = t[j];
      c += dc;
      r += dr;
      if (c >= v) { c -= v; ++r; }
    }
  }
}

template <int NTH>
__device__ __forceinline__ void stage_rows(float* xs, int ldx,
                                           const float* src, int ld,
                                           int valid, int K, int r0, int nr) {
  const float* base = src + (size_t)r0 * ld;
  if (valid == K && ((K | ld) & 3) == 0 &&
      (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    stage_vec<NTH, float4>(xs, ldx, base, ld, K, nr);
  } else if (valid == K && ((K | ld) & 1) == 0) {
    stage_vec<NTH, float2>(xs, ldx, base, ld, K, nr);
  } else {
    for (int i = threadIdx.x; i < nr * K; i += NTH) {
      const int r = i / K, k = i % K;
      xs[(size_t)r * ldx + k] =
          k < valid ? __ldcg(base + (size_t)r * ld + k) : 0.f;
    }
  }
}

// Shared memory of one chain CTA, mirrored byte for byte by
// kernels/fantastic4_matmul.py::chain_smem_bytes: the codebook, 16 fp32,
// as a static array (its address is a constant, so a lookup needs no add
// of a base), then dynamically [mbarrier, 16 B][x tile, rows x ldx fp32]
// [one K chunk of the code slice, chunk_bytes].
__host__ __device__ inline int chain_dyn_smem_bytes(int rows, int ldx,
                                                    int chunk_bytes) {
  return 16 + 4 * rows * ldx + chunk_bytes;
}

// Kernel 1 -- replaces kernels/fantastic4_matmul.py:fantastic4_matmul_pallas.
// One CTA per (column slice of <= 16 columns, row tile of <= 32 rows), K
// looped inside: a 512-wide layer covers 32 CTAs at any batch.  Bound, at
// serving batches: the dependent FFMA chain over K (latency) at a few rows,
// FFMA issue at 32-row tiles, and between the seven layers of a served
// chain the launch gap and each CTA's first loads.  The design: before
// griddepcontrol.wait a CTA reads only pack constants -- it copies its
// K x 16 code slice into shared memory with one bulk async copy and builds
// the codebook from omega -- so under programmatic dependent launch that
// prologue overlaps the previous layer; x, alpha1, b and alpha2 may come
// from the grid just before (the int8 chain folds alpha1 on the device,
// an odd K pads x) and are read after the wait.  The CTA lets the next
// layer's CTAs launch once its outputs are written (launching them as soon
// as the wait returns was as fast at 1-64 rows and slower at 256: the
// early CTAs took SM slots unevenly).
// CHUNKED: a K whose x tile and code slice do not fit a block's shared
// memory is cut into chunks of kc rows (a multiple of 64, so a chunk of the
// slice is a whole number of 16-byte units): per chunk the CTA copies that
// part of the slice, stages that part of x, and carries its sums across
// chunks in y (slice_pass's resume / finish).  A K that fits takes the
// instance without the chunk loop: the loop's run-time resume and finish
// made the kernel spill registers and slowed every launch.
template <bool CHUNKED>
__global__ void __launch_bounds__(f4c::NT)
matmul_kernel(const float* x, LayerDesc d, const float* omega,
              const float* scale, int M, int rows, int ldx, int kc,
              int chunk_bytes, float* y) {
  __shared__ __align__(16) float book[16];
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* xs = reinterpret_cast<float*>(smem + 16);
  unsigned char* cbuf =
      reinterpret_cast<unsigned char*>(xs + (size_t)rows * ldx);
  const int tid = threadIdx.x, s = blockIdx.x;
  const int r0 = blockIdx.y * rows, nr = min(rows, M - r0);
  const int K = d.K, chunks = CHUNKED ? (K + kc - 1) / kc : 1;
  const uint8_t* slice = d.packed + (size_t)s * d.slice_bytes;
  // chunk c of the slice: its kc / 8 words per column, the last one to the
  // slice's 16-byte padded end
  auto request = [&](int c) {
    const int off = c * chunk_bytes;
    f4c::bulk_load(cbuf, slice + off,
                   CHUNKED ? min(chunk_bytes, d.slice_bytes - off)
                           : d.slice_bytes,
                   bar);
  };
  if (tid == 0) {
    f4c::mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    request(0);
  }
  if (tid < 16) book[tid] = f4::decode_code(tid, omega);
  griddep_wait();
  if (scale != nullptr) d.scale = *scale;
  const f4c::Cols cs = f4c::slice_cols(d, d.N, s);
  float* out = y + (size_t)r0 * d.N;
  for (int c = 0; c < chunks; ++c) {
    const int k0 = c * kc;
    if (CHUNKED) d.K = min(kc, K - k0);   // the rows of this chunk
    if (CHUNKED && c > 0) {
      __syncthreads();   // the previous chunk's x and codes are read
      if (tid == 0) request(c);
    }
    stage_rows<f4c::NT>(xs, ldx, x + k0, K, d.K, d.K, r0, nr);
    __syncthreads();
    f4c::mbar_wait(bar, c & 1);
    f4c::run_slice<f4c::NT>(xs, ldx, reinterpret_cast<const uint32_t*>(cbuf),
                            book, d, cs, nr, out, d.N, CHUNKED && c > 0,
                            !CHUNKED || c == chunks - 1);
  }
  griddep_launch_dependents();
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
// Layers outer, the whole batch per layer, in one cooperative launch of at
// most the co-resident CTAs.  Layer l's columns are cut into n_slices
// slices of <= 16 columns (a 512-wide layer: 32) and its rows into tiles of
// `rows` (<= 32); a work item is (slice, group of row tiles), groups =
// min(tiles, CTAs / n_slices).  A CTA copies its item's code slice into
// shared memory once (one bulk copy on an mbarrier; layer l+1's first slice
// is requested before the grid barrier that ends layer l, into the other of
// two buffers) and serves each of its row tiles from that copy: the tile's
// input is staged in shared memory, the K loop decodes in registers.
// Bound: the dependent FFMA chain and the L - 1 grid barriers at a few rows,
// FFMA issue and the tiles' staging from L2 at 64-256 rows.
struct StreamArgs {
  const float* x;          // (M, K0)
  float* y;                // (M, N_L)
  float* act;              // two (M, lda) ping-pong activation buffers
  unsigned* arrived;       // grid barrier counter, 0 at launch
  const LayerDesc* layers; // L descriptors (slice fields set)
  const uint8_t* codes;    // slice-major device copy of every layer's codes
  int M, K0, L;
  int rows;                // rows per tile
  int ldx;                 // row stride of the shared tile, floats
  int lda;                 // row stride of the activation buffers, floats
  int code_region;         // bytes of one code buffer: the largest slice
};

// Shared memory of one stream CTA, mirrored byte for byte by
// kernels/fantastic4_fused_mlp.py::stream_mlp_smem_bytes: the current
// layer's codebook, 16 fp32, as a static array (constant address), then
// dynamically [2 mbarriers, 16 B][layer descriptors, 80 B each]
// [row tile, rows x ldx fp32][two code buffers of code_region bytes].
__host__ __device__ inline int stream_dyn_smem_bytes(int L, int rows,
                                                     int ldx,
                                                     int code_region) {
  return 16 + 80 * L + 4 * rows * ldx + 2 * code_region;
}

// All CTAs of the (co-resident, cooperative) grid have reached barrier
// number `n`; their writes before it are visible after it.  One release
// add per CTA and acquire polls by one thread, as CUTLASS's generic
// barrier does.
__device__ __forceinline__ void grid_barrier(unsigned* arrived, unsigned n) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n"
                 :: "l"(arrived) : "memory");
    const unsigned target = n * gridDim.x;
    unsigned seen = 0;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(seen) : "l"(arrived) : "memory");
    } while (seen < target);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(STREAM_NT, 4)
stream_kernel(StreamArgs a) {
  __shared__ __align__(16) float book[16];
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  LayerDesc* descs = reinterpret_cast<LayerDesc*>(smem + 16);
  float* xs = reinterpret_cast<float*>(descs + a.L);
  unsigned char* cbuf =
      reinterpret_cast<unsigned char*>(xs + (size_t)a.rows * a.ldx);
  const int tid = threadIdx.x, G = gridDim.x, b = blockIdx.x;
  const int tiles = (a.M + a.rows - 1) / a.rows;

  if (tid == 0) {
    f4c::mbar_init(bars, 1);
    f4c::mbar_init(bars + 1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  {
    const int4* src = reinterpret_cast<const int4*>(a.layers);
    int4* dst = reinterpret_cast<int4*>(descs);
    for (int i = tid; i < a.L * (int)(sizeof(LayerDesc) / 16); i += STREAM_NT)
      dst[i] = src[i];
  }
  __syncthreads();
  // row-tile groups per slice of layer l; layer l's code buffer is l & 1
  auto groups = [&](int l) {
    return max(1, min(tiles, G / descs[l].n_slices));
  };
  auto request = [&](int l, int s) {
    const LayerDesc& d = descs[l];
    f4c::bulk_load(cbuf + (size_t)(l & 1) * a.code_region,
                   a.codes + d.slice_off + (size_t)s * d.slice_bytes,
                   d.slice_bytes, bars + (l & 1));
  };
  if (tid == 0 && b < descs[0].n_slices * groups(0)) request(0, b / groups(0));

  unsigned parity = 0;   // bit i: the phase buffer i's next wait completes
  for (int l = 0; l < a.L; ++l) {
    const LayerDesc& d = descs[l];
    const bool last = l == a.L - 1;
    const int grp = groups(l), items = d.n_slices * grp;
    const float* in =
        l == 0 ? a.x : a.act + (size_t)((l - 1) & 1) * a.M * a.lda;
    const int in_ld = l == 0 ? a.K0 : a.lda, in_cols = l == 0 ? a.K0 : d.K;
    float* out = last ? a.y : a.act + (size_t)(l & 1) * a.M * a.lda;
    const int out_ld = last ? d.N : a.lda;
    const uint32_t* codes = reinterpret_cast<const uint32_t*>(
        cbuf + (size_t)(l & 1) * a.code_region);
    // the previous layer's lookups are done (its last tile's barrier, or
    // the grid barrier): this layer's codebook replaces it
    if (tid < 16) book[tid] = f4::decode_code(tid, d.omega);
    for (int item = b; item < items; item += G) {
      const int s = item / grp;
      if (item != b) {   // a second slice of this layer: more items than CTAs
        __syncthreads();
        if (tid == 0) request(l, s);
      }
      f4c::mbar_wait(bars + (l & 1), (parity >> (l & 1)) & 1);
      parity ^= 1u << (l & 1);
      const f4c::Cols cs = f4c::slice_cols(d, f4c::out_cols(d, last), s);
      for (int t = item % grp; t < tiles; t += grp) {
        const int r0 = t * a.rows, nr = min(a.rows, a.M - r0);
        stage_rows<STREAM_NT>(xs, a.ldx, in, in_ld, in_cols, d.K, r0, nr);
        __syncthreads();
        f4c::run_slice<STREAM_NT>(xs, a.ldx, codes, book, d, cs, nr,
                                  out + (size_t)r0 * out_ld, out_ld);
        __syncthreads();   // the tile and the slice are read
      }
    }
    if (last) break;
    // the next layer's first slice lands during the grid barrier
    if (tid == 0 && b < descs[l + 1].n_slices * groups(l + 1))
      request(l + 1, b / groups(l + 1));
    grid_barrier(a.arrived, l + 1);
  }
}

// Raise `kernel`'s dynamic shared memory limit to `bytes` past the 48 KB
// every kernel may use without asking; a size the card cannot give returns
// its error.
cudaError_t allow_dyn_smem(const void* kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
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
  cudaError_t e = allow_dyn_smem(kernel, dyn);
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

// `kc`: the K chunk a CTA stages at a time (all of K, or a multiple of 64);
// `chunk_bytes`: the bytes of one chunk of a code slice (slice_bytes when
// kc = K, else kc / 2 * slice_w).
int f4_matmul(const float* x, const uint8_t* codes, const float* omega,
              const float* alpha1, const float* bias, const float* scale_dev,
              float scale, int quant, int act, int M, int K, int N,
              int n_slices, int slice_w, int slice_bytes, int rows, int ldx,
              int kc, int chunk_bytes, int pdl, float* y, void* stream) {
  auto refuse = [](cudaError_t e) { cudaGetLastError(); return (int)e; };
  if (M < 1 || rows < 1 || rows > f4c::MAX_TILE_ROWS || (K & 1) ||
      kc < 2 || (kc < K && (kc & 63)) || ldx < (kc < K ? kc : K) ||
      (ldx & 3) || (slice_bytes & 15) || (chunk_bytes & 15) ||
      chunk_bytes > slice_bytes)
    return (int)cudaErrorInvalidValue;
  LayerDesc d{};
  d.packed = codes;
  d.alpha1 = alpha1;
  d.bias = bias;
  d.n_slices = n_slices;
  d.slice_w = slice_w;
  d.scale = scale;
  d.K = K;
  d.N = N;
  d.ldp = N;
  d.act = act;
  d.quant = quant;
  d.slice_bytes = slice_bytes;
  const int dyn = chain_dyn_smem_bytes(rows, ldx, chunk_bytes);
  const void* kernel = kc < K ? (const void*)matmul_kernel<true>
                               : (const void*)matmul_kernel<false>;
  cudaError_t e = allow_dyn_smem(kernel, dyn);
  if (e != cudaSuccess) return refuse(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)n_slices, (unsigned)((M + rows - 1) / rows));
  cfg.blockDim = dim3(f4c::NT);
  cfg.dynamicSmemBytes = (size_t)dyn;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = pdl ? 1 : 0;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* args[] = {(void*)&x, (void*)&d, (void*)&omega, (void*)&scale_dev,
                  (void*)&M, (void*)&rows, (void*)&ldx, (void*)&kc,
                  (void*)&chunk_bytes, (void*)&y};
  e = cudaLaunchKernelExC(&cfg, kernel, args);
  return e == cudaSuccess ? 0 : refuse(e);
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

// `want`: the most work items any layer has (CTAs beyond it would idle);
// the grid is the smaller of it and the co-resident CTAs, written to *ctas.
// `arrived`: 4 bytes of device memory for the grid barrier, zeroed here.
int f4_fused_stream(const float* x, int M, int K0, const void* layers, int L,
                    const uint8_t* codes, int rows, int ldx, int lda,
                    int code_region, int want, float* act, unsigned* arrived,
                    float* y, int* ctas, void* stream) {
  auto refuse = [](cudaError_t e) { cudaGetLastError(); return (int)e; };
  if (M < 1 || rows < 1 || rows > f4c::MAX_TILE_ROWS || want < 1 ||
      (ldx & 3) || (code_region & 15))
    return (int)cudaErrorInvalidValue;
  const int dyn = stream_dyn_smem_bytes(L, rows, ldx, code_region);
  const void* kernel = (const void*)stream_kernel;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaError_t e = allow_dyn_smem(kernel, dyn);
  if (e != cudaSuccess) return refuse(e);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    STREAM_NT, dyn);
  if (e != cudaSuccess) return refuse(e);
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  e = cudaMemsetAsync(arrived, 0, sizeof(unsigned), (cudaStream_t)stream);
  if (e != cudaSuccess) return refuse(e);
  const int grid = want < sms * per_sm ? want : sms * per_sm;
  StreamArgs a{x, y, act, arrived, (const LayerDesc*)layers, codes, M, K0,
               L, rows, ldx, lda, code_region};
  void* args[] = {(void*)&a};
  e = cudaLaunchCooperativeKernel(kernel, grid, STREAM_NT, args, (size_t)dyn,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return refuse(e);
  *ctas = grid;
  return 0;
}

}  // extern "C"
