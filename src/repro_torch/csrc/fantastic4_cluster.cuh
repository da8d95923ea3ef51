// Cluster core of the batch-tiled/db and weight-stationary serving kernels.
//
// One thread-block cluster of C CTAs (C = 8, the portable size, by default)
// serves one row tile of the batch and walks the whole stack.  CTA `rank`
// owns the output columns [rank * W_l, (rank + 1) * W_l) of every layer,
// W_l = ceil(n_l / C), where n_l is the layer's even-padded width (the last
// layer's true width).  Per layer a CTA
//   1. waits for its code slice (K_l/2 x W_l bytes, copied from L2 into its
//      own shared memory by one cp.async.bulk completing on an mbarrier),
//   2. runs one fp32 accumulator per output from 0.f with __fmaf_rn over
//      ascending k (slice_pass, which the chain and stream kernels run too)
//      reading the layer input from its own shared memory only,
//   3. writes its outputs into its own input buffer for the next layer and
//      sends the same columns into every peer's buffer through distributed
//      shared memory with st.async, each store counted on the receiving
//      CTA's mbarrier, so a layer starts as soon as its input has landed
//      (no cluster-wide barrier between layers).
// So activations never leave the chip, the K loop has no barrier and no L2
// load in it, and a batch of one row runs one accumulator per thread.
//
// Why stores and not loads across the cluster: a remote load stalls the
// warp for the DSMEM round trip, a remote store does not, and once the
// input has landed every K step reads local shared memory.  The price is
// the input buffer: two of rows x D fp32 (ping-pong: peers write layer
// l+1's input while this CTA may still read layer l's).  A peer can write
// buffer b only after it has received this CTA's outputs of the layer that
// read b, so two buffers are enough.
//
// Code slices are laid out on the host (kernels/slices.py, code_slices) as
// (ceil(K/8), W, 4) bytes: one 32-bit word holds the four packed rows
// 4q..4q+3 of one column, so a warp reads 32 consecutive words and decodes
// 8 weights of its column through the 16-entry codebook.
#pragma once

#include <cooperative_groups.h>

#include "fantastic4_common.cuh"

namespace f4c {

namespace cg = cooperative_groups;
using f4::LayerDesc;

constexpr int NT = 256;          // threads per CTA
constexpr int MAX_TILE_ROWS = 32;  // rows per cluster (Python: MAX_TILE_ROWS)
constexpr int MAX_WP = 64;       // columns per pass: threads form (NT/Wp) x Wp

// How a CTA holds the code slices in shared memory.
enum CodeMode { kSingle = 0, kDouble = 1, kStationary = 2 };

struct StackArgs {
  const float* x;          // (M, K0)
  float* y;                // (M, N_L)
  const LayerDesc* layers; // L descriptors (slice_off / slice_bytes set)
  const uint8_t* codes;    // slice-major device copy of every layer's codes
  int M, K0, L;
  int rows;                // rows per cluster (the row tile)
  int ldx;                 // row stride of the input buffers, floats
  int code_region;         // bytes of shared memory for code slices
};

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// Shared-memory layout, identical to the Python fits
// (kernels/fantastic4_fused_mlp.py::cluster_smem_bytes):
//   [mbarriers, 8 B each, rounded to 16][layer descriptors, 80 B each]
//   [codebooks, 16 fp32 per layer][two input buffers, rows x ldx fp32 each]
//   [code slices]
// code-slice barriers (one, two, or one per layer), then the two input
// barriers: input buffer b is complete when the peers' bytes have landed
__host__ __device__ inline int n_code_barriers(int mode, int L) {
  return mode == kStationary ? L : (mode == kDouble ? 2 : 1);
}
__host__ __device__ inline int n_barriers(int mode, int L) {
  return n_code_barriers(mode, L) + 2;
}
__host__ __device__ inline int bar_bytes(int mode, int L) {
  return round_up(8 * n_barriers(mode, L), 16);
}
__host__ __device__ inline int smem_bytes(int mode, int L, int rows, int ldx,
                                          int code_region) {
  return bar_bytes(mode, L) + (80 + 64) * L + 8 * rows * ldx + code_region;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// Wait for the phase of `bar` with this parity to complete; the acquire is
// cluster-wide, so the peers' stores it counted are visible after it.  A
// copy that never lands traps (a launch error) instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  for (long long spin = 0; !done; ++spin) {
    if (spin > (1ll << 28)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64"
        " p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

// Arm `bar` for this phase: one arrival plus `bytes` still to land.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// The address of the same shared-memory location in CTA `rank`.
__device__ __forceinline__ uint32_t peer_addr(uint32_t local, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(local), "r"(rank));
  return r;
}

// Store into a peer's shared memory and count the bytes on the peer's
// mbarrier (no cluster-wide barrier needed to publish them).
__device__ __forceinline__ void st_async(uint32_t raddr, float4 v,
                                         uint32_t rbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 "
      "[%0], {%1, %2, %3, %4}, [%5];\n"
      :: "r"(raddr), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(rbar)
      : "memory");
}
__device__ __forceinline__ void st_async(uint32_t raddr, float v,
                                         uint32_t rbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 "
      "[%0], %1, [%2];\n"
      :: "r"(raddr), "f"(v), "r"(rbar) : "memory");
}

// One thread: copy `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global memory into this CTA's shared memory, completing on `bar`.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes);
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  // the buffer may have been read by ordinary loads before: order those
  // before the async proxy's writes
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  mbar_expect(bar, bytes);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The columns of slice s of a layer that writes n_end columns: W (the
// slice width, d.slice_w) and how many of them exist (the last slices of a
// narrow layer may own none).
struct Cols {
  int w, c0, cnt, n_end;
};
__device__ __forceinline__ Cols slice_cols(const LayerDesc& d, int n_end,
                                           int s) {
  Cols c;
  c.n_end = n_end;
  c.w = d.slice_w;
  c.c0 = s * c.w;
  c.cnt = max(0, min(c.w, n_end - c.c0));
  return c;
}
// A layer writes its even-padded width; the last layer its true width.
__device__ __forceinline__ int out_cols(const LayerDesc& d, bool last) {
  return last ? d.N : d.N + (d.N & 1);
}

// Explicit shared-memory loads of the layer input: through a pointer the
// compiler cannot place in shared memory it would emit generic loads.
__device__ __forceinline__ float4 lds128(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr)
               : "memory");
  return v;
}
__device__ __forceinline__ float lds32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void decode8(uint32_t word, const float* book,
                                        float* w) {
#pragma unroll
  for (int i = 0; i < 8; ++i) w[i] = book[(word >> (4 * i)) & 15u];
}

// One layer's slice: rows [0, nr) of `xin` (ldx stride, K valid columns)
// times one slice's columns, on a CTA of NTH threads.  Threads form G row
// groups x (Wp / CPT) lanes; each thread runs RPT x CPT accumulators: the
// rows ty, ty + G, ... that exist, times the columns tx, tx + Wp / CPT,
// ...  CPT = 2 halves the input reads per FMA when a tile has many rows.
// The loop is software-pipelined: while the FMAs of packed group q run,
// the weights of q + 1 are looked up and the code words of q + 2 are
// loaded, so a 1-row pass runs near the FMA chain's latency, not the
// shared-memory loads'.
// A pass may cover one chunk of K (d.K rows of the input and the codes):
// `resume` starts each sum from the partial the previous chunk's pass left
// in `out` (the same thread wrote it), and without `finish` the pass
// leaves its sums there instead of applying the epilogue -- one fp32 sum
// per output over ascending k all the same.
template <int RPT, int CPT, int NTH>
__device__ __forceinline__ void slice_pass(
    const float* xin, int ldx, const uint32_t* codes, const float* book,
    const LayerDesc& d, const Cols& cs, int wp, int nr, float* out,
    int out_ld, bool resume, bool finish) {
  const int lanes = wp / CPT;
  const int tid = threadIdx.x, tx = tid % lanes, ty = tid / lanes;
  const int g = NTH / lanes;
  if (ty >= nr) return;
  const int K = d.K, q_full = K / 8, rem_pairs = (K / 2) % 4;
  const int n_words = q_full + (rem_pairs ? 1 : 0);
  uint32_t xr[RPT];     // shared-memory byte addresses of the thread's rows
#pragma unroll
  for (int j = 0; j < RPT; ++j)
    xr[j] = smem_addr(xin + (size_t)min(ty + g * j, nr - 1) * ldx);
  for (int cb = 0; cb < cs.cnt; cb += wp) {
    int col[CPT];
    bool live[CPT];
    float a1[CPT], b1[CPT];
    bool any = false;
#pragma unroll
    for (int m = 0; m < CPT; ++m) {
      col[m] = cb + tx + m * lanes;
      live[m] = col[m] < cs.cnt;
      any |= live[m];
      // the epilogue's operands, requested now, used after the K loop
      const int gc = cs.c0 + col[m];
      const bool real = live[m] && gc < d.N;
      a1[m] = real ? __ldg(d.alpha1 + gc) : 0.f;
      b1[m] = real ? __ldg(d.bias + gc) : 0.f;
    }
    if (!any) continue;
    auto word_at = [&](int m, int q) -> uint32_t {
      return (live[m] && q < n_words) ? codes[(size_t)q * cs.w + col[m]] : 0u;
    };
    float acc[RPT][CPT];
#pragma unroll
    for (int j = 0; j < RPT; ++j)
#pragma unroll
      for (int m = 0; m < CPT; ++m) {
        const int r = ty + g * j, gc = cs.c0 + col[m];
        acc[j][m] = resume && live[m] && r < nr
                        ? out[(size_t)r * out_ld + gc] : 0.f;
      }
    float w[CPT][8], wn[CPT][8];
    uint32_t word_n[CPT];
#pragma unroll
    for (int m = 0; m < CPT; ++m) {
      decode8(word_at(m, 0), book, w[m]);
      word_n[m] = word_at(m, 1);
    }
    // one packed group: 8 k of every row, in ascending k per accumulator
    auto fma8 = [&](int q, const float (&wq)[CPT][8]) {
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const float4 a = lds128(xr[j] + 32 * q);
        const float4 b = lds128(xr[j] + 32 * q + 16);
#pragma unroll
        for (int m = 0; m < CPT; ++m) {
          float& s = acc[j][m];
          s = __fmaf_rn(a.x, wq[m][0], s);
          s = __fmaf_rn(a.y, wq[m][1], s);
          s = __fmaf_rn(a.z, wq[m][2], s);
          s = __fmaf_rn(a.w, wq[m][3], s);
          s = __fmaf_rn(b.x, wq[m][4], s);
          s = __fmaf_rn(b.y, wq[m][5], s);
          s = __fmaf_rn(b.z, wq[m][6], s);
          s = __fmaf_rn(b.w, wq[m][7], s);
        }
      }
    };
    auto fetch = [&](int q_word, float (&wq)[CPT][8]) {
#pragma unroll
      for (int m = 0; m < CPT; ++m) {
        decode8(word_n[m], book, wq[m]);
        word_n[m] = word_at(m, q_word);
      }
    };
    // two groups per trip, so the weight buffers swap roles without copies
    int q = 0;
    for (; q + 1 < q_full; q += 2) {
      fetch(q + 2, wn);
      fma8(q, w);
      fetch(q + 3, w);
      fma8(q + 1, wn);
    }
    if (q < q_full) {
      fetch(q + 2, wn);
      fma8(q, w);
#pragma unroll
      for (int m = 0; m < CPT; ++m)
#pragma unroll
        for (int i = 0; i < 8; ++i) w[m][i] = wn[m][i];
    }
    // K is even, so the tail is 1-3 packed rows of the last word, whose
    // weights are in w: nibbles 2i, 2i + 1 are rows k, k + 1
    for (int i = 0; i < rem_pairs; ++i) {
      const int k = 8 * q_full + 2 * i;
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const float x0 = lds32(xr[j] + 4 * k), x1 = lds32(xr[j] + 4 * k + 4);
#pragma unroll
        for (int m = 0; m < CPT; ++m) {
          acc[j][m] = __fmaf_rn(x0, w[m][2 * i], acc[j][m]);
          acc[j][m] = __fmaf_rn(x1, w[m][2 * i + 1], acc[j][m]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < CPT; ++m) {
      if (!live[m]) continue;
      const int gc = cs.c0 + col[m];   // column in the layer's output
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const int r = ty + g * j;
        if (r < nr) {
          float v = 0.f;       // the even pad column stays 0
          if (!finish)
            v = acc[j][m];
          else if (gc < d.N)
            v = f4::epilogue(acc[j][m], a1[m], b1[m], d.act, d.scale,
                             d.quant);
          out[(size_t)r * out_ld + gc] = v;
        }
      }
    }
  }
}

template <int NTH = NT>
__device__ __forceinline__ void run_slice(
    const float* xin, int ldx, const uint32_t* codes, const float* book,
    const LayerDesc& d, const Cols& cs, int nr, float* out, int out_ld,
    bool resume = false, bool finish = true) {
  // thread columns: the slice width rounded up to a power of two, <= 64
  int wp = 1;
  while (wp < cs.w && wp < MAX_WP) wp *= 2;
  // accumulators for the rows that exist, one column per thread; a tile
  // holds at most MAX_TILE_ROWS rows
  const int need = (nr + NTH / wp - 1) / (NTH / wp);
  if (need <= 1)
    slice_pass<1, 1, NTH>(xin, ldx, codes, book, d, cs, wp, nr, out, out_ld,
                          resume, finish);
  else if (need <= 2)
    slice_pass<2, 1, NTH>(xin, ldx, codes, book, d, cs, wp, nr, out, out_ld,
                          resume, finish);
  else if (need <= 4)
    slice_pass<4, 1, NTH>(xin, ldx, codes, book, d, cs, wp, nr, out, out_ld,
                          resume, finish);
  else   // 8 rows per thread: two columns of four instead
    slice_pass<4, 2, NTH>(xin, ldx, codes, book, d, cs, wp, nr, out, out_ld,
                          resume, finish);
}

// Send this rank's columns of rows [0, nr) of `buf` to the same place in
// every other CTA of the cluster, counted on each peer's barrier `bar`.
__device__ __forceinline__ void send_cols(float* buf, int ldx, int nr,
                                          const Cols& cs, int rank, int C,
                                          uint64_t* bar) {
  if (cs.cnt == 0) return;
  const int tid = threadIdx.x;
  const uint32_t lbar = smem_addr(bar);
  if ((cs.c0 & 3) == 0 && (cs.cnt & 3) == 0) {
    const int vpr = cs.cnt / 4, per_peer = nr * vpr;
    for (int idx = tid; idx < (C - 1) * per_peer; idx += NT) {
      const int p = (rank + 1 + idx / per_peer) % C, rest = idx % per_peer;
      const float* src = buf + (size_t)(rest / vpr) * ldx + cs.c0 +
                         4 * (rest % vpr);
      st_async(peer_addr(smem_addr(src), p),
               *reinterpret_cast<const float4*>(src), peer_addr(lbar, p));
    }
  } else {
    const int per_peer = nr * cs.cnt;
    for (int idx = tid; idx < (C - 1) * per_peer; idx += NT) {
      const int p = (rank + 1 + idx / per_peer) % C, rest = idx % per_peer;
      const float* src = buf + (size_t)(rest / cs.cnt) * ldx + cs.c0 +
                         rest % cs.cnt;
      st_async(peer_addr(smem_addr(src), p), *src, peer_addr(lbar, p));
    }
  }
}

template <int MODE>
__device__ __forceinline__ void run_stack(const StackArgs& a) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tile = blockIdx.x / C;
  const int r0 = tile * a.rows;
  const int nr = min(a.rows, a.M - r0);
  const int tid = threadIdx.x;

  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  // the layer table lives in shared memory: every layer reads it, and
  // a read from global memory there would cost an L2 round trip per layer
  LayerDesc* descs = reinterpret_cast<LayerDesc*>(smem + bar_bytes(MODE, a.L));
  float* books = reinterpret_cast<float*>(descs + a.L);
  float* xbuf[2];
  xbuf[0] = books + 16 * a.L;
  xbuf[1] = xbuf[0] + (size_t)a.rows * a.ldx;
  unsigned char* cbuf = reinterpret_cast<unsigned char*>(
      xbuf[1] + (size_t)a.rows * a.ldx);

  // where layer l's slice lives in shared memory
  auto slot = [&](int l) -> unsigned char* {
    if (MODE == kStationary) {
      int off = 0;
      for (int i = 0; i < l; ++i) off += descs[i].slice_bytes;
      return cbuf + off;
    }
    if (MODE == kDouble) return cbuf + (l & 1) * (a.code_region / 2);
    return cbuf;
  };
  auto bar_of = [&](int l) -> uint64_t* {
    if (MODE == kStationary) return bars + l;
    return bars + (MODE == kDouble ? (l & 1) : 0);
  };
  // the phase a layer's wait completes: barrier uses in order
  auto parity_of = [&](int l) -> int {
    return MODE == kStationary ? 0 : (MODE == kDouble ? (l >> 1) & 1 : l & 1);
  };
  auto request = [&](int l) {
    const LayerDesc& d = descs[l];
    bulk_load(slot(l), a.codes + d.slice_off + (size_t)rank * d.slice_bytes,
              d.slice_bytes, bar_of(l));
  };

  if (tid == 0) {
    for (int i = 0; i < n_barriers(MODE, a.L); ++i) mbar_init(bars + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  {
    const int4* src = reinterpret_cast<const int4*>(a.layers);
    int4* dst = reinterpret_cast<int4*>(descs);
    for (int i = tid; i < a.L * (int)(sizeof(LayerDesc) / 16); i += NT)
      dst[i] = src[i];
  }
  __syncthreads();
  if (tid == 0) {
    if (MODE == kStationary) {
      for (int l = 0; l < a.L; ++l) request(l);
    } else {
      request(0);
      if (MODE == kDouble && a.L > 1) request(1);
    }
  }
  // peers' buffers are written only after every CTA has started
  cluster_arrive_relaxed();
  for (int i = tid; i < 16 * a.L; i += NT)
    books[i] = f4::decode_code(i % 16, descs[i / 16].omega);
  {
    // layer 0's input: the x tile from global memory, zero past K0
    const int k_in = descs[0].K;
    if ((a.K0 & 3) == 0) {
      const int vpr = a.K0 / 4;
      for (int idx = tid; idx < nr * vpr; idx += NT) {
        const int r = idx / vpr, v = idx % vpr;
        const float4* row =
            reinterpret_cast<const float4*>(a.x + (size_t)(r0 + r) * a.K0);
        *reinterpret_cast<float4*>(xbuf[0] + (size_t)r * a.ldx + 4 * v) =
            __ldg(row + v);
      }
    } else {
      for (int idx = tid; idx < nr * k_in; idx += NT) {
        const int r = idx / k_in, k = idx % k_in;
        xbuf[0][(size_t)r * a.ldx + k] =
            k < a.K0 ? a.x[(size_t)(r0 + r) * a.K0 + k] : 0.f;
      }
    }
  }
  __syncthreads();

  // inbar[b]: the peers' columns of input buffer b have landed
  uint64_t* inbar = bars + n_code_barriers(MODE, a.L);
  for (int l = 0; l < a.L; ++l) {
    const LayerDesc& d = descs[l];
    const bool last = l == a.L - 1;
    const Cols cs = slice_cols(d, out_cols(d, last), rank);
    if (l >= 1) mbar_wait(inbar + (l & 1), ((l - 1) >> 1) & 1);
    // arm the next input buffer: the bytes the peers will send into it
    if (!last && tid == 0)
      mbar_expect(inbar + ((l + 1) & 1), 4 * nr * (cs.n_end - cs.cnt));
    mbar_wait(bar_of(l), parity_of(l));
    // db: the next layer's slice is in flight during this layer's FMAs
    if (MODE == kDouble && tid == 0 && l >= 1 && l + 1 < a.L) request(l + 1);
    const uint32_t* codes = reinterpret_cast<const uint32_t*>(slot(l));
    if (last) {
      run_slice(xbuf[l & 1], a.ldx, codes, books + 16 * l, d, cs, nr,
                a.y + (size_t)r0 * d.N, d.N);
      if (l == 0) cluster_wait();   // one layer: match the start's arrive
      break;
    }
    float* nxt = xbuf[(l + 1) & 1];
    run_slice(xbuf[l & 1], a.ldx, codes, books + 16 * l, d, cs, nr, nxt,
              a.ldx);
    __syncthreads();   // own outputs written; this slice and input read
    if (MODE == kSingle && tid == 0) request(l + 1);
    if (l == 0) cluster_wait();
    send_cols(nxt, a.ldx, nr, cs, rank, C, inbar + ((l + 1) & 1));
  }
}

}  // namespace f4c
