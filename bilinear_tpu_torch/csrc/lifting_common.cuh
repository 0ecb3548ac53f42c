// Shared building blocks of the lifting kernels (lifting.cu, lifting_int8.cu):
// one GEMM per layer, Y = epilogue(A @ W^T), and the same tiles walked by one
// persistent kernel for a serving batch.
//
// What bounds a layer on an H100: a hidden layer is n x 1024 x 1024 products
// (2.1 MFLOP per row) against 2 to 6 KB of activation per row, so at bulk
// size the tensor cores are the limit and only `wgmma` reaches their rate;
// at a serving batch (n <= 256) the 2 to 8 MB of weights streamed from L2
// and the launches are.
//
// Why the six layers are not one kernel at bulk size: the smallest wgmma row
// tile is 64 rows; a 64 x 1024 bf16 activation is 128 KB and a layer needs
// its input and its output at once (256 KB > the 227 KB a block may use).
// Even a 2-block cluster that holds one activation and a weight ring would
// stream all 8.4 MB of weights from L2 for every 64 rows: 1024 tiles x 8.4
// MB = 8.6 GB per call at n = 65536, as much as L2 delivers in ~1.5 ms. One
// GEMM per layer with 128-row tiles reads a layer's 2 MB of weights once per
// 128 rows (half as much per row) and its activation round trips (~1.6 GB
// per bf16 call, ~0.5 ms of device memory time) overlap the products. So bulk
// batches run one GEMM per layer; the whole chain is one launch only for a
// serving batch, where launches, not bytes, are the cost. (This argument is
// for bf16 and these per-layer kernels: in int8 two 64-row activations fit
// beside a weight ring, and a cluster's multicast shares the weight reads;
// the int8 scale probe's chains, K5 in int8_scale_probe.cu, run so, fused.)
//
// The GEMM (gemm_tile): A is (M, K) and the weight a K-contiguous (N, K) copy
// made once per checkpoint, so both operands reach wgmma as 128-byte swizzled
// rows of K (64 bf16 or 128 int8 values: the loaders and descriptors count
// bytes and serve both types). A block is NWG warpgroups, each owning 64
// rows x BN columns of accumulators in registers. All threads copy slabs
// into a DEPTH-stage cp.async ring, ahead of the product; one block barrier
// per slab publishes a stage. Per-layer bulk (launch_bulk: K2's layers, the
// decode of K1 and K2, K1's bf16 layers below PERSISTENT_MIN_ROWS in
// ops/lifting.py): 2 x (64 x 128) with two blocks to an SM, whose ring of 3
// waits for each slab's product, so that one block's epilogue and load
// latency run under the other's products; serving: 1 x (64 x 64).
// What bounds a bulk bf16 hidden layer on an H100 is its products (137
// GFLOP at n = 65536, 139 us at the card's peak), with 256-384 MB of device
// memory to flow under them, and at bulk size this tile holds the tensor
// cores to a third of that: every thread spends instruction slots on copies
// and barriers, a block never has two products in flight, and nothing
// multiplies on a block during its epilogue. So K1's bf16 bulk layers run in
// lifting.cu's gemm_wgmma_persistent instead: one block to an SM walks 128 x
// 256 tiles, a producer thread keeps TMA loads in flight into an mbarrier
// ring, two consumer warpgroups multiply, and the epilogue's skip and store
// move by TMA under the products (lifting.cu has its design and the timings
// that chose it: 900 us against 1,336 for the four hidden layers at n =
// 65536). Every path runs the k-steps of one output in the same order with
// the same instruction family, so a row's result does not depend on the
// batch it came in (checked on the card, bit for bit).
//
// Epilogue: accumulators are staged through the freed ring, then every
// thread finishes 8 consecutive columns of a row: [dequant] + bias, [ReLU],
// round to the working type, [+ skip, round again], 16-byte stores in up to
// three forms (working type, bf16, int8 quantised with the NEXT layer's
// static scale) and the per-row-group amax. A thread's bias and scales are
// loaded once per tile and four rows' skip loads fly together: the epilogue
// is bound by load latency, not by bytes. Quantising divides without the
// division instruction (see quantize). The ragged edge is masked: loads
// zero-fill, the epilogue skips rows >= M and columns >= N, and masked rows
// never enter an amax.
//
// The int8 forms of the probe's chains (int8_scale_probe.cu, which finishes
// its values in registers with them): a product with a given multiplier
// (quantize_mul), a saturating truncation (saturate_int8) and the int32
// accumulator's low byte with no bias (wrap_int8).
//
// Dynamic int8 scales span 512 rows x 1024 columns, 32 tiles: such a layer
// runs as a persistent cooperative grid that takes a group's tiles together
// (gemm_wgmma_groups), each block waiting for its group's amax with its
// finished tile still in shared memory, then quantising it itself. One group
// of more tiles than the card holds at once (a calibration batch run as one
// group) cannot wait so: the wrapper asks how many rows fit and runs such a
// call as plain GEMMs with one quantise pass before each hidden layer.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "wgmma_sm90.cuh"

namespace lifting {

using bf16 = __nv_bfloat16;

constexpr int HID = 1024, IN_F = 32, OUT_F = 48;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
// v rounded to T and back.
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

// Activation scale of an int8 layer from a group's amax, as _quant_dot
// computes it.
__device__ __forceinline__ float scale_of_amax(float amax) {
  return __fdiv_rn(fmaxf(amax, 1e-12f), 127.0f);
}
// A scale with its correctly rounded reciprocal, made once per tile or group.
struct Scale {
  float s, r;
};
__device__ __forceinline__ Scale make_scale(float s) {
  return {s, __frcp_rn(s)};
}
// clip(rint(v / s), -127, 127): true division, round half to even. v / s is
// formed without the division instruction, whose slow path every zero (half
// of all ReLU outputs) takes. With r = RN(1 / s): q0 = RN(v r) is within two
// ulps of the quotient; e = v - q s is exact in an FMA, so one correction
// RN(q0 + e r) is a faithful quotient and a second one its correct rounding
// (Markstein's theorem). A quotient small enough to underflow rounds to 0
// either way; one too large is clipped.
__device__ __forceinline__ int quantize(float v, Scale sc) {
  float q = __fmul_rn(v, sc.r);
  q = __fmaf_rn(__fmaf_rn(-q, sc.s, v), sc.r, q);
  q = __fmaf_rn(__fmaf_rn(-q, sc.s, v), sc.r, q);
  return (int)fminf(fmaxf(rintf(q), -127.f), 127.f);
}

// The int8 forms of the probe's chains (int8_scale_probe.cu), value by value
// as their plain versions compute them. fixed: clip(rint(v * r), -127, 127),
// a product with the given multiplier r, not K2's division, for v >= 0 (fixed
// quantises ReLU outputs and sums of two: never negative, never NaN). Rounded
// without conversion instructions, which run at a sixteenth of the issue
// rate: clamped to 128 first, the sum with 1.5 * 2^23 rounds to an integer,
// half to even, whose bits are the integer plus 0x4B400000.
__device__ __forceinline__ int quantize_mul(float v, float r) {
  const float y = fminf(__fmul_rn(v, r), 128.f);
  return min(__float_as_int(__fadd_rn(y, 12582912.f)) - 0x4B400000, 127);
}
// mxu's encode: v truncated toward zero, saturated to [-128, 127], NaN to 0
// (cvt.rzi.s32.f32 truncates, saturates to int32 and sends NaN to 0).
__device__ __forceinline__ int saturate_int8(float v) {
  return min(max(__float2int_rz(v), -128), 127);
}
// mxu's hidden layers: an int32 accumulator modulo 256, as int8, by integer
// operations alone (a float round trip would cost two conversions a value).
__device__ __forceinline__ int wrap_int8(int t) {
  return ((t & 0xff) ^ 0x80) - 0x80;
}

// ---- V consecutive values to and from global memory ------------------------
// Addresses are aligned to V elements. Loads bypass L1 (__ldcg): inside the
// persistent kernel another SM wrote the data earlier in the same launch.

template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[V]) {
#pragma unroll
  for (int i = 0; i < V / 4; ++i) {
    float4 t = __ldcg(reinterpret_cast<const float4*>(p) + i);
    v[4 * i] = t.x, v[4 * i + 1] = t.y, v[4 * i + 2] = t.z, v[4 * i + 3] = t.w;
  }
}
__device__ __forceinline__ void unpack_bf16x2(uint32_t w, float& a, float& b) {
  __nv_bfloat162 t = *reinterpret_cast<__nv_bfloat162*>(&w);
  a = __low2float(t), b = __high2float(t);
}
__device__ __forceinline__ void load_vec(const bf16* p, float (&v)[4]) {
  uint2 t = __ldcg(reinterpret_cast<const uint2*>(p));
  unpack_bf16x2(t.x, v[0], v[1]);
  unpack_bf16x2(t.y, v[2], v[3]);
}
__device__ __forceinline__ void load_vec(const bf16* p, float (&v)[8]) {
  uint4 t = __ldcg(reinterpret_cast<const uint4*>(p));
  unpack_bf16x2(t.x, v[0], v[1]);
  unpack_bf16x2(t.y, v[2], v[3]);
  unpack_bf16x2(t.z, v[4], v[5]);
  unpack_bf16x2(t.w, v[6], v[7]);
}
template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[V]) {
#pragma unroll
  for (int i = 0; i < V / 4; ++i)
    reinterpret_cast<float4*>(p)[i] =
        make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
}
__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  __nv_bfloat162 t = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&t);
}
__device__ __forceinline__ void store_vec(bf16* p, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
}
__device__ __forceinline__ void store_vec(bf16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                 pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
}
// The values quantised with scale s, as int8.
template <int V>
__device__ __forceinline__ void store_quantized(int8_t* p, const float (&v)[V],
                                                Scale s) {
  uint32_t w[V / 4];
#pragma unroll
  for (int i = 0; i < V / 4; ++i) {
    w[i] = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      w[i] |= (uint32_t)(quantize(v[4 * i + b], s) & 0xff) << (8 * b);
  }
  if (V == 8)
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[V / 4 - 1]);
  else
    *reinterpret_cast<uint32_t*>(p) = w[0];
}

// ---- every layer's epilogue -------------------------------------------------
// W is the working type the layer's value is rounded to (bf16, or float for
// no rounding). Null pointers switch parts off.
template <typename W>
struct Epilogue {
  const float* bias;      // (N,)
  const float* wscale;    // (N,) int8 per-output-channel weight scale, or null
  const float* in_amax;   // per-group amax of the layer input (dynamic int8)
  float in_scale;         // static activation scale (int8, in_amax null)
  const W* skip;          // (M, N) residual added after the ReLU, or null
  W* out;                 // (M, N) in the working type, or null
  bf16* out_bf16;         // (M, N) the value rounded to bf16, or null
  int8_t* out_q;          // (M, N) the value quantised with q_scale, or null
  float q_scale;          // the next layer's static activation scale
  float* out_amax;        // per-group amax of the value, or null
  unsigned* done;         // group-synchronous tiles only: per-group count of
  int8_t* dyn_q;          // finished tiles, and where the value goes as int8
                          // once its group's amax is whole
  int group_rows;         // rows per dynamic-scale group
  int relu;

  // What a thread needs of its V columns, loaded once per tile: the bias and,
  // for an int8 layer, (s_x * s_w): formed first, it then multiplies acc
  // (lifting_int8.py _quant_dot). `row` is any row of the tile: a tile lies
  // in one scale group.
  template <int V>
  struct Cols {
    float b[V], sw[V];
    Scale q;  // q_scale
  };
  template <int V>
  __device__ __forceinline__ void load_cols(int row, int col,
                                            Cols<V>& c) const {
    load_vec(bias + col, c.b);
    if (out_q) c.q = make_scale(q_scale);
    if (wscale) {
      const float s = in_amax
                          ? scale_of_amax(__ldcg(in_amax + row / group_rows))
                          : in_scale;
      load_vec(wscale + col, c.sw);
#pragma unroll
      for (int i = 0; i < V; ++i) c.sw[i] = __fmul_rn(s, c.sw[i]);
    }
  }
  template <int V>
  __device__ __forceinline__ void load_skip(size_t idx, float (&sk)[V]) const {
    if (skip) load_vec(skip + idx, sk);
  }

  // Finishes V values of a row at flat index idx = row * N + col; sk holds
  // the skip's values there when there is a skip. Returns the largest value
  // (all are >= 0 wherever an amax is taken). Explicit _rn ops keep nvcc from
  // contracting to FMA.
  template <int V>
  __device__ __forceinline__ float finish(size_t idx, float (&y)[V],
                                          const Cols<V>& c,
                                          const float (&sk)[V]) const {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (wscale) y[i] = __fmul_rn(y[i], c.sw[i]);
      y[i] = __fadd_rn(y[i], c.b[i]);
      if (relu) y[i] = fmaxf(y[i], 0.0f);
      y[i] = rnd<W>(y[i]);
      if (skip) y[i] = rnd<W>(__fadd_rn(y[i], sk[i]));
    }
    if (out) store_vec(out + idx, y);
    if (out_bf16) store_vec(out_bf16 + idx, y);
    if (out_q) store_quantized<V>(out_q + idx, y, c.q);
    float m = 0.0f;
#pragma unroll
    for (int i = 0; i < V; ++i) m = fmaxf(m, y[i]);
    return m;
  }
};

// One layer: Y (M, N) = epilogue(A (M, K) @ B), with B the K-contiguous
// (N, K) weight for the wgmma kernels and the (K, N) one for the f32 kernel.
template <typename W>
struct Layer {
  const void* A;
  const void* B;
  int M, N, K;
  Epilogue<W> ep;
};

// ---- asynchronous copies ----------------------------------------------------

// 16 bytes global -> shared; pred false zero-fills (reads nothing).
__device__ __forceinline__ void cp16z(uint32_t dst, const void* src,
                                      bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most N of this thread's committed groups are pending.
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Byte offset of the 16-byte chunk j of row r in a 128-byte swizzled tile.
__device__ __forceinline__ uint32_t swz(int r, int j) {
  return (uint32_t)(r * 128 + ((j ^ (r & 7)) << 4));
}

// ---- the wgmma GEMM tile ----------------------------------------------------

template <typename TC, int BN> struct MmaOf;
template <int BN> struct MmaOf<bf16, BN> {
  using acc_t = float;
  __device__ __forceinline__ static void run(float (&d)[BN / 2], uint64_t da,
                                             uint64_t db, int scale_d) {
    wg::Mma<BN, 0, 0>::run(d, da, db, scale_d);
  }
};
template <int BN> struct MmaOf<int8_t, BN> {
  using acc_t = int;
  __device__ __forceinline__ static void run(int (&d)[BN / 2], uint64_t da,
                                             uint64_t db, int scale_d) {
    wg::MmaS8<BN>::run(d, da, db, scale_d);
  }
};

// NWG warpgroups of 64 rows, BN columns, a ring of DEPTH slabs of 128 bytes
// of K.
template <int NWG, int BN, int DEPTH>
struct Tile {
  // Slabs the copies run ahead of the product. A ring of 4 or more keeps two
  // products in flight (the newest and the one before it), so its
  // copies run DEPTH - 2 ahead. A ring of 3 (two blocks to an SM) waits for
  // each product before the next barrier instead, so copies run 2 ahead; the
  // other block on the SM fills the tensor cores meanwhile.
  static constexpr bool DRAIN = DEPTH == 3;
  static constexpr int AHEAD = DRAIN ? DEPTH - 1 : DEPTH - 2;
  static constexpr int THREADS = 128 * NWG;
  static constexpr int BM = 64 * NWG;
  static constexpr int A_BYTES = BM * 128;
  static constexpr int STAGE = A_BYTES + BN * 128;
  static constexpr int RING = DEPTH * STAGE;
  static constexpr int LDS = BN + 8;  // staged accumulator row, in words
  static_assert(DEPTH >= 3, "a stage is multiplied while others fill");
  static_assert(BM * LDS * 4 <= RING, "the staged accumulators reuse the ring");
  static_assert(BN * 8 % THREADS == 0, "whole B chunks per thread");
  static constexpr int SMEM = 1024 + RING;  // the ring is 1024-byte aligned
};

__device__ __forceinline__ unsigned char* align_ring(unsigned char* raw) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~(uintptr_t)1023);
}

// acc = the products of slabs [s0, s1) of K (128 bytes each; kbytes, a row
// of K in bytes, a multiple of 32) for this thread's warpgroup, the first
// product overwriting acc. load(stage, s) issues this thread's copies of
// slab s into the ring stage at shared address `stage` (BM rows of A, then
// BN rows of B, 128-byte swizzled); it is called once per slab, in order.
// The copies of slab s + AHEAD start when slab s is multiplied, into the
// stage whose product every warpgroup has waited for. Ends with the ring
// free.
template <typename TC, int NWG, int BN, int DEPTH, typename Load>
__device__ __forceinline__ void mainloop(
    Load& load, int kbytes, int s0, int s1, unsigned char* ring,
    typename MmaOf<TC, BN>::acc_t (&acc)[BN / 2]) {
  using C = Tile<NWG, BN, DEPTH>;
  const int wgid = threadIdx.x >> 7;
  const uint32_t ring_s = (uint32_t)__cvta_generic_to_shared(ring);
  int fetched = s0, fstage = 0;
  auto fetch = [&]() {
    if (fetched < s1) load(ring_s + fstage * C::STAGE, fetched);
    ++fetched;
    fstage = fstage + 1 == DEPTH ? 0 : fstage + 1;
    cp_commit();  // one group per slab, empty past the end
  };
#pragma unroll
  for (int s = 0; s < C::AHEAD; ++s) fetch();
  int cstage = 0;
  for (int s = s0; s < s1; ++s) {
    const unsigned char* st = ring + cstage * C::STAGE;
    cstage = cstage + 1 == DEPTH ? 0 : cstage + 1;
    cp_wait<C::AHEAD - 1>();  // this thread's copies of slab s have landed
    wg::fence_async_shared();
    __syncthreads();  // slab s is whole; the stage to refill is read out
    fetch();
    const int steps = min(4, (kbytes - s * 128) >> 5);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      if (kk < steps)
        MmaOf<TC, BN>::run(acc, wg::desc(st + wgid * 8192 + kk * 32, 16, 1024),
                           wg::desc(st + C::A_BYTES + kk * 32, 16, 1024),
                           (s != s0 || kk != 0));
    wg::commit();
    if (C::DRAIN)
      wg::wait<0>();
    else
      wg::wait<1>();
  }
  wg::wait<0>();
  cp_wait<0>();
  __syncthreads();
}

// The (M, HID) f32 matrix h quantised into q by the whole grid, each group of
// group_rows rows with its own scale (amax[g] / 127). A thread takes every
// nthreads-th vector of 8 values, whatever group it lies in, four at a time.
__device__ __forceinline__ void quantize_groups(const float* __restrict__ h,
                                                int8_t* __restrict__ q, int M,
                                                int group_rows,
                                                const float* amax) {
  constexpr int UNROLL = 4;
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t nthreads = (size_t)gridDim.x * blockDim.x;
  const size_t vecs = (size_t)M * (HID / 8);
  for (size_t i0 = t; i0 < vecs; i0 += nthreads * UNROLL) {
    float v[UNROLL][8];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (i0 + u * nthreads < vecs) load_vec<8>(h + (i0 + u * nthreads) * 8, v[u]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const size_t i = i0 + u * nthreads;
      if (i < vecs) {
        const int g = (int)(i / (HID / 8)) / group_rows;
        store_quantized<8>(q + i * 8, v[u],
                           make_scale(scale_of_amax(__ldcg(amax + g))));
      }
    }
  }
}

// Spins until *counter >= target. Only among blocks that are resident
// together (a cooperative launch). A wait that lasts seconds is a fault of
// the schedule: it traps, so the launch fails where it would have hung.
__device__ __forceinline__ void wait_count(const unsigned* counter,
                                           unsigned target) {
  unsigned seen;
  for (unsigned spins = 0;; ++spins) {
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                 : "=r"(seen)
                 : "l"(counter)
                 : "memory");
    if (seen >= target) return;
    if (spins > (1u << 24)) __trap();
    __nanosleep(100);
  }
}

// 8 finished values back into the staged tile, as their bits.
__device__ __forceinline__ void store_staged(float* p, const float (&y)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(y[0], y[1], y[2], y[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(y[4], y[5], y[6], y[7]);
}
__device__ __forceinline__ void store_staged(int* p, const float (&y)[8]) {
  store_staged(reinterpret_cast<float*>(p), y);
}
__device__ __forceinline__ void load_finished(const float* p, float (&y)[8]) {
  float4 a = reinterpret_cast<const float4*>(p)[0];
  float4 b = reinterpret_cast<const float4*>(p)[1];
  y[0] = a.x, y[1] = a.y, y[2] = a.z, y[3] = a.w;
  y[4] = b.x, y[5] = b.y, y[6] = b.z, y[7] = b.w;
}
__device__ __forceinline__ void load_finished(const int* p, float (&y)[8]) {
  load_finished(reinterpret_cast<const float*>(p), y);
}

// 8 staged accumulators (32-byte aligned) as floats.
__device__ __forceinline__ void load_staged(const float* p, float (&y)[8]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float4 t = reinterpret_cast<const float4*>(p)[i];
    y[4 * i] = t.x, y[4 * i + 1] = t.y, y[4 * i + 2] = t.z, y[4 * i + 3] = t.w;
  }
}
__device__ __forceinline__ void load_staged(const int* p, float (&y)[8]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    int4 t = reinterpret_cast<const int4*>(p)[i];
    y[4 * i] = (float)t.x, y[4 * i + 1] = (float)t.y;
    y[4 * i + 2] = (float)t.z, y[4 * i + 3] = (float)t.w;
  }
}

// One output tile: rows m0.., columns n0.. of layer L. Leaves the ring free
// (ends on a block barrier), so persistent callers may loop over tiles.
// GROUPSYNC (dynamic int8, every tile of the tile's scale group resident at
// once): the finished values stay in the staged tile; the block adds its
// amax, counts itself in (ep.done), waits until the whole group has, and
// quantises its own tile with the group's scale into ep.dyn_q, so the
// activation never makes an f32 round trip to be quantised.
template <typename TC, typename W, int NWG, int BN, int DEPTH,
          bool GROUPSYNC = false>
__device__ __forceinline__ void gemm_tile(const Layer<W>& L, int m0, int n0,
                                          unsigned char* ring) {
  using C = Tile<NWG, BN, DEPTH>;
  using acc_t = typename MmaOf<TC, BN>::acc_t;
  const int tid = threadIdx.x;
  const int wgid = tid >> 7, warp = (tid & 127) >> 5, lane = tid & 31;

  acc_t acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  // Slab s: rows m0.. of A and n0.. of B, bytes [128 s, 128 s + 128) of K.
  const unsigned char* A = static_cast<const unsigned char*>(L.A);
  const unsigned char* B = static_cast<const unsigned char*>(L.B);
  const int kbytes = L.K * (int)sizeof(TC);
  const int j = tid & 7, rb = tid >> 3;
  auto load = [&](uint32_t st, int s) {
    const int kb = s * 128 + j * 16;
    const bool kok = kb < kbytes;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rb + i * (C::THREADS / 8);
      const bool ok = kok && m0 + r < L.M;
      cp16z(st + swz(r, j), A + (ok ? (size_t)(m0 + r) * kbytes + kb : 0),
            ok);
    }
#pragma unroll
    for (int i = 0; i < BN * 8 / C::THREADS; ++i) {
      const int n = rb + i * (C::THREADS / 8);
      const bool ok = kok && n0 + n < L.N;
      cp16z(st + C::A_BYTES + swz(n, j),
            B + (ok ? (size_t)(n0 + n) * kbytes + kb : 0), ok);
    }
  };
  mainloop<TC, NWG, BN, DEPTH>(load, kbytes, 0, (kbytes + 127) >> 7, ring,
                               acc);

  acc_t* stg = reinterpret_cast<acc_t*>(ring);
  {
    const int frow = wgid * 64 + warp * 16 + (lane >> 2), fcol = 2 * (lane & 3);
    using pair_t = typename std::conditional<std::is_same<acc_t, int>::value,
                                             int2, float2>::type;
#pragma unroll
    for (int jj = 0; jj < BN / 8; ++jj) {
      pair_t lo, hi;
      lo.x = acc[4 * jj], lo.y = acc[4 * jj + 1];
      hi.x = acc[4 * jj + 2], hi.y = acc[4 * jj + 3];
      *reinterpret_cast<pair_t*>(stg + frow * C::LDS + 8 * jj + fcol) = lo;
      *reinterpret_cast<pair_t*>(stg + (frow + 8) * C::LDS + 8 * jj + fcol) = hi;
    }
  }
  __syncthreads();

  // Pass 2: a thread finishes the same 8 columns of every STEP-th row, four
  // rows at a time so that their skip loads are in flight together.
  float vmax = 0.0f;
  constexpr int CHUNKS = BN / 8;  // 8-column chunks per row
  constexpr int STEP = C::THREADS / CHUNKS, UNROLL = 4;
  static_assert(C::BM % (STEP * UNROLL) == 0, "whole row groups per thread");
  const int c = tid % CHUNKS, col = n0 + 8 * c;
  if (col < L.N) {
    typename Epilogue<W>::template Cols<8> cols;
    L.ep.template load_cols<8>(m0, col, cols);
    for (int r = tid / CHUNKS; r < C::BM; r += STEP * UNROLL) {
      float sk[UNROLL][8];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (m0 + r + u * STEP < L.M)
          L.ep.template load_skip<8>(
              (size_t)(m0 + r + u * STEP) * L.N + col, sk[u]);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int row = m0 + r + u * STEP;
        if (row < L.M) {
          float y[8];
          load_staged(stg + (r + u * STEP) * C::LDS + 8 * c, y);
          vmax = fmaxf(vmax, L.ep.template finish<8>((size_t)row * L.N + col,
                                                     y, cols, sk[u]));
          if (GROUPSYNC) store_staged(stg + (r + u * STEP) * C::LDS + 8 * c, y);
        }
      }
    }
  }
  if (L.ep.out_amax) {
    // Values entering an int8 layer are >= 0 (ReLU outputs or sums of two),
    // so the float's bits order like ints and atomicMax is exact and
    // order-independent. BM divides the group size: one group per tile.
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      vmax = fmaxf(vmax, __shfl_xor_sync(0xffffffffu, vmax, o));
    if (lane == 0)
      atomicMax(reinterpret_cast<int*>(L.ep.out_amax) + m0 / L.ep.group_rows,
                __float_as_int(vmax));
  }
  if constexpr (GROUPSYNC) {
    const int group = m0 / L.ep.group_rows;
    __threadfence();  // this block's amax before its count
    __syncthreads();
    if (tid == 0) {
      const int rows = min(L.ep.group_rows, L.M - group * L.ep.group_rows);
      const unsigned tiles = (unsigned)((rows + C::BM - 1) / C::BM) *
                             (unsigned)((L.N + BN - 1) / BN);
      __threadfence();  // and every warp's amax, seen through the barrier
      atomicAdd(L.ep.done + group, 1u);
      wait_count(L.ep.done + group, tiles);
    }
    __syncthreads();
    if (col < L.N) {
      const Scale s = make_scale(scale_of_amax(__ldcg(L.ep.out_amax + group)));
      for (int r = tid / CHUNKS; r < C::BM && m0 + r < L.M; r += STEP) {
        float y[8];  // the values this thread stored itself
        load_finished(stg + r * C::LDS + 8 * c, y);
        store_quantized<8>(L.ep.dyn_q + (size_t)(m0 + r) * L.N + col, y, s);
      }
    }
  }
  __syncthreads();  // the staged tile is read: the ring is free again
}

// ---- launches ---------------------------------------------------------------

// One layer, one launch: block b computes row tile b / tiles_n, column tile
// b % tiles_n, so the column tiles of a row tile run together (A comes from
// device memory once, the weights from L2).
template <typename TC, typename W, int NWG, int BN, int DEPTH, int MINB>
__global__ void __launch_bounds__(128 * NWG, MINB)
gemm_wgmma(const __grid_constant__ Layer<W> L) {
  extern __shared__ unsigned char smem_raw[];
  const int tiles_n = (L.N + BN - 1) / BN;
  gemm_tile<TC, W, NWG, BN, DEPTH>(
      L, (int)(blockIdx.x / tiles_n) * Tile<NWG, BN, DEPTH>::BM,
      (int)(blockIdx.x % tiles_n) * BN, align_ring(smem_raw));
}

template <typename TC, typename W, int NWG, int BN, int DEPTH, int MINB = 1>
inline cudaError_t launch_layer(const Layer<W>& L, cudaStream_t stream) {
  using C = Tile<NWG, BN, DEPTH>;
  auto kernel = gemm_wgmma<TC, W, NWG, BN, DEPTH, MINB>;
  cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return attr;
  const unsigned tiles = (unsigned)((L.M + C::BM - 1) / C::BM) *
                         (unsigned)((L.N + BN - 1) / BN);
  kernel<<<tiles, C::THREADS, C::SMEM, stream>>>(L);
  return cudaSuccess;
}

// The bulk tile: 2 warpgroups, 128 rows x 128 columns, two blocks per SM
// with 3-slab rings, so that one block's epilogue runs under the other's
// products. The decode's 48 columns take a 64-column tile.
template <typename TC, typename W>
inline cudaError_t launch_bulk(const Layer<W>& L, cudaStream_t stream) {
  if (L.N <= 64)  // decode
    return launch_layer<TC, W, 2, 64, 6, 1>(L, stream);
  return launch_layer<TC, W, 2, 128, 3, 2>(L, stream);
}

// Dynamic int8, one launch per layer without a quantise pass: a persistent
// grid whose blocks take the tiles of a scale group TOGETHER. Block b works
// on group b / tpg + k * (grid / tpg), tile b % tpg of it (tpg tiles per
// group, its column tiles adjacent), so all tiles of a group are in flight
// at once and may wait for each other (gemm_tile, GROUPSYNC). The launch is
// cooperative, which guarantees that every block is resident.
template <typename TC, int NWG, int BN, int DEPTH, int MINB>
__global__ void __launch_bounds__(128 * NWG, MINB)
gemm_wgmma_groups(const __grid_constant__ Layer<float> L, int tpg) {
  using C = Tile<NWG, BN, DEPTH>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align_ring(smem_raw);
  const int tiles_n = (L.N + BN - 1) / BN;
  const int group_rows = min(L.ep.group_rows, (L.M + C::BM - 1) / C::BM * C::BM);
  const int groups = (L.M + group_rows - 1) / group_rows;
  const int t = blockIdx.x % tpg;
  for (int g = blockIdx.x / tpg; g < groups; g += gridDim.x / tpg) {
    const int m0 = g * group_rows + t / tiles_n * C::BM;
    if (m0 < L.M && m0 < (g + 1) * group_rows)
      gemm_tile<TC, float, NWG, BN, DEPTH, true>(L, m0, t % tiles_n * BN, ring);
  }
}

// Blocks of `kernel` that are resident together on the current device.
template <typename K>
inline cudaError_t resident_blocks(K kernel, int threads, int smem,
                                   int* resident) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                      smem);
  *resident = sms * per_sm;
  return e;
}

// The group-synchronous kernel of operand type TC, ready to launch, and how
// many of its blocks the current device holds at once.
template <typename TC>
inline cudaError_t groups_kernel(const void** kernel_out, int* resident_out) {
  using C = Tile<2, 128, 3>;
  auto kernel = gemm_wgmma_groups<TC, 2, 128, 3, 2>;
  *kernel_out = reinterpret_cast<const void*>(kernel);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return e;
  static int resident_on[64] = {};
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int& resident = resident_on[dev & 63];
  if (resident == 0) {
    e = resident_blocks(kernel, C::THREADS, C::SMEM, &resident);
    if (e != cudaSuccess) return e;
  }
  *resident_out = resident;
  return cudaSuccess;
}

// Launches layer L group-synchronously. A scale group whose tiles the card
// does not hold at once is an error (cudaErrorCooperativeLaunchTooLarge):
// the caller asks groups_kernel first and runs such a call with a quantise
// pass instead.
template <typename TC>
inline cudaError_t launch_groups(const Layer<float>& L, cudaStream_t stream) {
  using C = Tile<2, 128, 3>;
  constexpr int BN = 128;
  const void* kernel = nullptr;
  int resident = 0;
  cudaError_t e = groups_kernel<TC>(&kernel, &resident);
  if (e != cudaSuccess) return e;
  const int row_tiles = (L.M + C::BM - 1) / C::BM;
  const int group_tiles = L.ep.group_rows / C::BM < row_tiles
                              ? L.ep.group_rows / C::BM
                              : row_tiles;
  int tpg = group_tiles * ((L.N + BN - 1) / BN);
  if (tpg > resident) return cudaErrorCooperativeLaunchTooLarge;
  const int groups = (row_tiles + group_tiles - 1) / group_tiles;
  int waves = resident / tpg < groups ? resident / tpg : groups;
  void* params[] = {const_cast<Layer<float>*>(&L), &tpg};
  return cudaLaunchCooperativeKernel(kernel, dim3(waves * tpg),
                                     dim3(C::THREADS), params, C::SMEM, stream);
}

// The serving tile of the persistent kernels: 1 warpgroup, 64 x 64.
constexpr int SERVE_BN = 64, SERVE_DEPTH = 6;
using ServeTile = Tile<1, SERVE_BN, SERVE_DEPTH>;

// All tiles of layer L, strided over the grid's blocks.
template <typename TC, typename W>
__device__ __forceinline__ void serve_layer(const Layer<W>& L,
                                            unsigned char* ring) {
  const int tiles_n = (L.N + SERVE_BN - 1) / SERVE_BN;
  const int tiles = (L.M + ServeTile::BM - 1) / ServeTile::BM * tiles_n;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x)
    gemm_tile<TC, W, 1, SERVE_BN, SERVE_DEPTH>(
        L, t / tiles_n * ServeTile::BM, t % tiles_n * SERVE_BN, ring);
}

// Cooperative launch of a persistent kernel over at most `max_tiles` blocks:
// every block must be resident, so the grid is sized from the occupancy the
// runtime reports for this kernel.
template <typename K, typename Args>
inline cudaError_t launch_persistent(K kernel, const Args& args, int max_tiles,
                                     cudaStream_t stream) {
  cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, ServeTile::SMEM);
  if (attr != cudaSuccess) return attr;
  static int resident_on[64] = {};  // by device: blocks that fit at once
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int& resident = resident_on[dev & 63];
  if (resident == 0) {
    e = resident_blocks(kernel, ServeTile::THREADS, ServeTile::SMEM, &resident);
    if (e != cudaSuccess) return e;
    if (resident < 1) return cudaErrorLaunchOutOfResources;
  }
  const int grid = max_tiles < resident ? max_tiles : resident;
  void* params[] = {const_cast<Args*>(&args)};
  return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                     dim3(grid), dim3(ServeTile::THREADS),
                                     params, ServeTile::SMEM, stream);
}

inline int serve_tiles(int M, int N) {
  return (M + ServeTile::BM - 1) / ServeTile::BM *
         ((N + SERVE_BN - 1) / SERVE_BN);
}

}  // namespace lifting
