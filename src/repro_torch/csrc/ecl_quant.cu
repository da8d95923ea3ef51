// Fused ECL assignment + dequantization for Hopper (sm_90a), CUDA C++:
// one grouped launch for a list of tensors.
//
// Replaces kernels/ecl_quant.py:ecl_quant_pallas (body _kernel) of the JAX
// package.  For every element of a segment's contiguous fp32 w it takes
//   code = argmin_c (w - v_c)^2 + pen_c,   v_c = sum_{i: bit i of c} omega_i
// over the 16 subset sums, and writes the uint8 code and w_hat = v_code.
// A segment is one quantized tensor, or one leading index of a tensor with
// a batched omega, with its own omega (4,) and penalty (16,).  The EC4T
// trainer quantizes every tensor of the net in one launch: once in the
// fake-quant forward, once in the EMA probability update, once in stats,
// at freeze time and in each eval forward.
//
// Bound: bytes, 9 per element (read w 4 B, write the code 1 B and w_hat
// 4 B): MLP-GSC's seven tensors (771,584 elements) take 2.07 us at
// 3.35 TB/s, 512x512 alone 0.70 us.  Issue is close behind: the 16
// candidates cost ~6 instructions each (sub, mul, add, compare, two
// selects), ~100 an element with the loads, stores and decode, ~2.5 us a
// pass on 132 SMs.  The design:
// * one launch per list of up to kMaxSegments segments.  The segment table
//   travels by value in the kernel parameters (__grid_constant__), so a
//   call copies nothing to the device and the table never goes stale (the
//   optimizer makes new parameter tensors every step).  Each segment owns
//   a run of CTAs from table.seg[s].block0 on; a CTA finds its segment by
//   a uniform scan of the block offsets.
// * kUnits float4 units (8 elements) a thread: 16-byte loads of w and
//   stores of w_hat, the 4 codes of a unit packed into one 4-byte store;
//   a warp's units are consecutive, so every access is coalesced.  The
//   grid is sized to the elements (2,048 a CTA: 377 CTAs for MLP-GSC,
//   below one wave of 132 SMs x 8 CTAs), with no grid-stride loop.
// * a segment base that is not 16-byte aligned (a lead slice of a
//   (L, 37, 129) tensor) runs its first 1-3 elements, and the last 0-3,
//   one a thread in the segment's first CTA.  The outputs must sit at the
//   same offset as w within 16 bytes (w_hat) and 4 elements (codes); the
//   wrapper copies a w that is not (a view at an odd offset), and the C
//   entry refuses such a segment.
// * the codebook and the penalty in registers: each thread builds its
//   segment's 16 v_c and loads its 16 penalties once, so the candidate
//   loop loads nothing; the loop selects only (best, code), and w_hat is
//   decoded from the winning code's bits afterwards.
//
// Bitwise contract with the plain version (kernels/ref.py ecl_quant_ref):
// * the cost is written with __fsub_rn / __fmul_rn / __fadd_rn, so nvcc's
//   default FMA contraction cannot round (w - v)^2 + pen once where the
//   plain version rounds twice;
// * v_c (and w_hat) start at 0 and add omega_i for the set bits in
//   ascending i, which is bitwise equal to bitplanes.codebook(omega)[c];
// * best starts at +inf with code 0 and a candidate wins only on a strict
//   <, so ties keep the lowest code, as torch.argmin's first index.
//
// omega and the penalty are device pointers: the trainer builds the
// penalty on the card, so a launch needs no host synchronisation.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnits = 2;                          // float4 units a thread
constexpr int kElemsPerCta = kThreads * kUnits * 4;
constexpr int kMaxSegments = 32;                   // kernels/ecl_quant.py

struct Segment {
  const float* w;
  const float* omega;     // (4,)
  const float* penalty;   // (16,)
  uint8_t* codes;
  float* w_hat;
  int n;                  // elements
  int block0;             // the segment's first CTA
};

struct SegmentTable {
  Segment seg[kMaxSegments];
  int count;
};

struct Book {
  float omega[4];
  float v[16];
  float pen[16];
};

__device__ __forceinline__ void load_book(const Segment& g, Book& b) {
#pragma unroll
  for (int i = 0; i < 4; ++i) b.omega[i] = __ldg(g.omega + i);
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    float v = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if ((c >> i) & 1) v = __fadd_rn(v, b.omega[i]);
    b.v[c] = v;
    b.pen[c] = __ldg(g.penalty + c);
  }
}

// code[e] = argmin_c cost(x[e], c), candidates outer so the E elements
// are E independent chains.
template <int E>
__device__ __forceinline__ void assign(const float (&x)[E], const Book& b,
                                       int (&code)[E]) {
  float best[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    best[e] = INFINITY;
    code[e] = 0;
  }
#pragma unroll
  for (int c = 0; c < 16; ++c) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float d = __fsub_rn(x[e], b.v[c]);
      const float cost = __fadd_rn(__fmul_rn(d, d), b.pen[c]);
      if (cost < best[e]) {
        best[e] = cost;
        code[e] = c;
      }
    }
  }
}

// v_code, added in the codebook's order.
__device__ __forceinline__ float decode(int code, const Book& b) {
  float v = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if ((code >> i) & 1) v = __fadd_rn(v, b.omega[i]);
  return v;
}

__device__ __forceinline__ void quant_one(const Segment& g, const Book& b,
                                          int e) {
  const float x[1] = {g.w[e]};
  int code[1];
  assign<1>(x, b, code);
  g.codes[e] = (uint8_t)code[0];
  g.w_hat[e] = decode(code[0], b);
}

__global__ void __launch_bounds__(kThreads)
ecl_quant_group_kernel(const __grid_constant__ SegmentTable table) {
  int s = 0;
#pragma unroll 1
  for (int i = 1; i < table.count; ++i)
    if (table.seg[i].block0 <= (int)blockIdx.x) s = i;
  const Segment g = table.seg[s];
  const int lb = (int)blockIdx.x - g.block0;   // CTA within the segment
  const int n = g.n;
  Book b;
  load_book(g, b);

  // elements before w's first 16-byte boundary (w is 4-byte aligned)
  int head = (int)((16 - ((uintptr_t)g.w & 15)) & 15) >> 2;
  head = head < n ? head : n;
  constexpr int E = 4 * kUnits;
  float x[E];
  int code[E];

  const int units = (n - head) >> 2;
  const float4* w4 = reinterpret_cast<const float4*>(g.w + head);
  uint32_t* c4 = reinterpret_cast<uint32_t*>(g.codes + head);
  float4* h4 = reinterpret_cast<float4*>(g.w_hat + head);
  const int u0 = lb * (kThreads * kUnits) + (int)threadIdx.x;
#pragma unroll
  for (int k = 0; k < kUnits; ++k) {
    const int u = u0 + k * kThreads;
    const float4 v = u < units ? __ldg(w4 + u) : make_float4(0.f, 0.f, 0.f,
                                                             0.f);
    x[4 * k] = v.x;
    x[4 * k + 1] = v.y;
    x[4 * k + 2] = v.z;
    x[4 * k + 3] = v.w;
  }
  assign<E>(x, b, code);
#pragma unroll
  for (int k = 0; k < kUnits; ++k) {
    const int u = u0 + k * kThreads;
    if (u < units) {
      c4[u] = (uint32_t)code[4 * k] | ((uint32_t)code[4 * k + 1] << 8) |
              ((uint32_t)code[4 * k + 2] << 16) |
              ((uint32_t)code[4 * k + 3] << 24);
      h4[u] = make_float4(decode(code[4 * k], b), decode(code[4 * k + 1], b),
                          decode(code[4 * k + 2], b),
                          decode(code[4 * k + 3], b));
    }
  }
  // the ragged ends: the segment's first CTA, one element a thread
  if (lb == 0) {
    const int t = (int)threadIdx.x;
    const int tail0 = head + 4 * units;
    if (t < head)
      quant_one(g, b, t);
    else if (t >= 4 && tail0 + (t - 4) < n)
      quant_one(g, b, tail0 + (t - 4));
  }
}

}  // namespace

extern "C" {

// segs: count rows of 6 int64 each, (w, omega, penalty, codes, w_hat, n):
// w (n,) fp32 -> codes (n,) uint8 and w_hat (n,) fp32, omega (4,) and
// penalty (16,) fp32, all contiguous device memory, w_hat at w's offset
// within 16 bytes and codes at w's element offset within 4.  One launch
// for at most kMaxSegments segments; returns cudaGetLastError() (or
// cudaErrorInvalidValue for a count or size the kernel does not take,
// cudaErrorMisalignedAddress for outputs aligned otherwise than w).
int f4_ecl_quant_many(const long long* segs, int count, void* stream) {
  if (count <= 0) return 0;
  if (count > kMaxSegments) return (int)cudaErrorInvalidValue;
  SegmentTable table;
  long long blocks = 0;
  for (int i = 0; i < count; ++i) {
    const long long* r = segs + 6 * i;
    if (r[5] < 0 || r[5] > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    // w_hat at w's offset within 16 bytes, codes within 4 elements
    if ((r[0] & 3) || ((r[4] - r[0]) & 15) || (((r[0] >> 2) - r[3]) & 3))
      return (int)cudaErrorMisalignedAddress;
    Segment& g = table.seg[i];
    g.w = reinterpret_cast<const float*>(r[0]);
    g.omega = reinterpret_cast<const float*>(r[1]);
    g.penalty = reinterpret_cast<const float*>(r[2]);
    g.codes = reinterpret_cast<uint8_t*>(r[3]);
    g.w_hat = reinterpret_cast<float*>(r[4]);
    g.n = (int)r[5];
    g.block0 = (int)blocks;
    blocks += (r[5] + kElemsPerCta - 1) / kElemsPerCta;
  }
  table.count = count;
  if (blocks == 0) return 0;
  ecl_quant_group_kernel<<<(unsigned)blocks, kThreads, 0,
                           (cudaStream_t)stream>>>(table);
  return (int)cudaGetLastError();
}

}  // extern "C"
