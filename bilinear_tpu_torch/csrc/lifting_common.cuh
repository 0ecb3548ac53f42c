// Shared building blocks of the lifting kernels (lifting.cu, lifting_int8.cu):
// one tiled GEMM per layer, Y = epilogue(A @ W), with A (M, K) and W (K, N)
// row-major (the JAX package's Dense layout), an f32 (or int32) accumulator
// and a fused epilogue: [dequant] + bias, [ReLU], round to the output type,
// [+ skip, round again], store, [per-row-group amax of the stored value].
//
// Tensor-core route: WMMA 16x16x16 fragments (bf16 -> f32, s8 -> s32), 8
// warps as 2 (rows) x 4 (cols). The block tile follows the row count: 32 x 64
// for serving batches (enough blocks to spread over the SMs), 64 x 64, and
// 128 x 128 for bulk batches (fewer shared-memory reads per product). The
// inner dimension advances 32 at a time through a 3-stage cp.async ring, so
// the loads of later slices are in flight while one slice is multiplied.
// Shared memory holds each slice chunked by 16 along the inner dimension
// (A as [k/16][BM][16], W as [n/16][32][16]) with rows padded to 48 bytes:
// fragment pointers stay 32-byte aligned and the 16-byte row reads of a
// fragment load hit distinct banks. The ragged edge in M and N is masked:
// loads zero-fill, the epilogue skips rows >= M and columns >= N.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace lifting {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int BK = 32;         // inner-dimension slice
constexpr int STAGES = 3;      // slices in flight
constexpr int THREADS = 256;   // 8 warps
constexpr int ROW_BYTES = 48;  // padded shared-memory row of 16 elements

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// Activation scale of an int8 layer for row group g: dynamic (amax of the
// group's input over 127, as _quant_dot computes it) or a static constant.
__device__ __forceinline__ float act_scale(const float* amax, int g,
                                           float static_scale) {
  return amax ? __fdiv_rn(fmaxf(amax[g], 1e-12f), 127.0f) : static_scale;
}

// Every layer's epilogue. Null pointers switch parts off.
template <typename TOut>
struct Epilogue {
  const float* bias;      // (N,)
  const float* wscale;    // (N,) int8 per-output-channel weight scale, or null
  const float* in_amax;   // per-group amax of the layer input (dynamic int8)
  float in_scale;         // static activation scale (int8, in_amax null)
  const TOut* skip;       // (M, N) residual added after the ReLU, or null
  TOut* out;              // (M, N)
  float* out_amax;        // per-group amax of the stored output, or null
  int group_rows;         // rows per dynamic-scale group
  int relu;

  // Returns the stored value (as float) for the amax.
  __device__ __forceinline__ float apply(int row, int col, int ldo,
                                         float acc) const {
    float y = acc;
    if (wscale) {
      // (s_x * s_w) is formed first, then multiplies acc (lifting_int8.py
      // _quant_dot); explicit _rn ops keep nvcc from contracting to FMA.
      float s = act_scale(in_amax, row / group_rows, in_scale);
      y = __fmul_rn(y, __fmul_rn(s, wscale[col]));
    }
    y = __fadd_rn(y, bias[col]);
    if (relu) y = fmaxf(y, 0.0f);
    TOut o = from_f<TOut>(y);
    size_t idx = (size_t)row * ldo + col;
    if (skip) o = from_f<TOut>(__fadd_rn(to_f(o), to_f(skip[idx])));
    out[idx] = o;
    return to_f(o);
  }
};

// ---- asynchronous copies --------------------------------------------------

// 16 bytes global -> shared; pred false zero-fills (reads nothing).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---- slice loaders (global -> chunked shared) -----------------------------
// LDS: the padded row length in elements of TC.

// A slice (BM_ x BK) with the compute type in global memory: cp.async.
template <int BM_, typename TC>
__device__ __forceinline__ void load_a(TC* As, const TC* A, int M, int K,
                                       int m0, int k0) {
  constexpr int CH = 16 / sizeof(TC), LDS = ROW_BYTES / sizeof(TC);
  constexpr int PER_ROW = BK / CH;
  for (int c = threadIdx.x; c < BM_ * PER_ROW; c += THREADS) {
    int row = c / PER_ROW, k = (c % PER_ROW) * CH;
    bool ok = m0 + row < M;
    const TC* src = A + (size_t)(ok ? m0 + row : 0) * K + k0 + k;
    cp_async16(As + ((k >> 4) * BM_ + row) * LDS + (k & 15), src, ok);
  }
}

// A slice from f32 rows rounded to bf16 (the int8 path's decode input is
// h.astype(bf16)): loaded through registers.
template <int BM_>
__device__ __forceinline__ void load_a(bf16* As, const float* A, int M, int K,
                                       int m0, int k0) {
  constexpr int LDS = ROW_BYTES / sizeof(bf16);
  for (int c = threadIdx.x; c < BM_ * BK / 4; c += THREADS) {
    int row = c / (BK / 4), k = (c % (BK / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m0 + row < M)
      v = *reinterpret_cast<const float4*>(A + (size_t)(m0 + row) * K + k0 + k);
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(
        As + ((k >> 4) * BM_ + row) * LDS + (k & 15));
    dst[0] = __floats2bfloat162_rn(v.x, v.y);
    dst[1] = __floats2bfloat162_rn(v.z, v.w);
  }
}

// W slice (BK x BN_): cp.async, N a multiple of 16 bytes' worth of columns.
template <int BN_, typename TC>
__device__ __forceinline__ void load_b(TC* Bs, const TC* B, int N, int k0,
                                       int n0) {
  constexpr int CH = 16 / sizeof(TC), LDS = ROW_BYTES / sizeof(TC);
  constexpr int PER_ROW = BN_ / CH;
  for (int c = threadIdx.x; c < BK * PER_ROW; c += THREADS) {
    int kr = c / PER_ROW, n = (c % PER_ROW) * CH;
    bool ok = n0 + n < N;
    const TC* src = B + (size_t)(k0 + kr) * N + (ok ? n0 + n : 0);
    cp_async16(Bs + ((n >> 4) * BK + kr) * LDS + (n & 15), src, ok);
  }
}

template <typename T> struct Acc { using type = float; };
template <> struct Acc<int8_t> { using type = int; };

template <int BM_, int BN_, typename TC>
constexpr int smem_bytes() {
  constexpr int stage = (BK / 16) * BM_ * ROW_BYTES + (BN_ / 16) * BK * ROW_BYTES;
  constexpr int staging = (THREADS / 32) * 256 * 4;  // epilogue, reuses ring
  return STAGES * stage > staging ? STAGES * stage : staging;
}

// ---- the tensor-core GEMM -------------------------------------------------
// TA: global A element type; TC: compute type (bf16 or int8_t).
// Grid: (ceil(M / BM_), ceil(N / BN_)). K % BK == 0.
template <int BM_, int BN_, typename TA, typename TC, typename TOut>
__global__ void __launch_bounds__(THREADS)
gemm_tc(const TA* __restrict__ A, const TC* __restrict__ B, int M, int N,
        int K, Epilogue<TOut> ep) {
  using TAcc = typename Acc<TC>::type;
  constexpr int LDS = ROW_BYTES / sizeof(TC);
  constexpr int WM = BM_ / 2, WN = BN_ / 4;    // warp tile
  constexpr int FM = WM / 16, FN = WN / 16;    // fragments per warp
  constexpr int A_STAGE = (BK / 16) * BM_ * LDS;  // elements
  constexpr int B_STAGE = (BN_ / 16) * BK * LDS;
  extern __shared__ __align__(128) unsigned char smem[];
  TC* As = reinterpret_cast<TC*>(smem);
  TC* Bs = As + STAGES * A_STAGE;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.x * BM_, n0 = blockIdx.y * BN_;
  const int ktiles = K / BK;

  wmma::fragment<wmma::accumulator, 16, 16, 16, TAcc> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], (TAcc)0);

  auto load = [&](int stage, int kt) {
    load_a<BM_>(As + stage * A_STAGE, A, M, K, m0, kt * BK);
    load_b<BN_>(Bs + stage * B_STAGE, B, N, kt * BK, n0);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // slice kt landed; slice kt - 1 is no longer read
    if (kt + STAGES - 1 < ktiles) load((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_async_commit();

    const TC* as = As + (kt % STAGES) * A_STAGE;
    const TC* bs = Bs + (kt % STAGES) * B_STAGE;
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, TC, wmma::row_major> a[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, TC, wmma::row_major> b[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(a[i], as + (kc * BM_ + wm * WM + i * 16) * LDS,
                               LDS);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(
            b[j], bs + ((wn * (WN / 16) + j) * BK + kc * 16) * LDS, LDS);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: reuse it to stage the epilogue

  // Epilogue through a per-warp 16 x 16 staging tile.
  TAcc* stage = reinterpret_cast<TAcc*>(smem) + warp * 256;
  float vmax = 0.0f;
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        int row = m0 + wm * WM + i * 16 + (e >> 4);
        int col = n0 + wn * WN + j * 16 + (e & 15);
        if (row < M && col < N)
          vmax = fmaxf(vmax, ep.apply(row, col, N, (float)stage[e]));
      }
      __syncwarp();
    }
  if (ep.out_amax) {
    // Values entering an int8 layer are >= 0 (ReLU outputs or sums of two),
    // so the float's bits order like ints and atomicMax is exact and
    // order-independent. BM_ divides the group size: one group per block.
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      vmax = fmaxf(vmax, __shfl_xor_sync(0xffffffffu, vmax, o));
    if (lane == 0)
      atomicMax(reinterpret_cast<int*>(ep.out_amax) + m0 / ep.group_rows,
                __float_as_int(vmax));
  }
}

template <int BM_, int BN_, typename TA, typename TC, typename TOut>
inline void launch_tile(const TA* A, const TC* B, int M, int N, int K,
                        const Epilogue<TOut>& ep, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<BM_, BN_, TC>();
  auto kernel = gemm_tc<BM_, BN_, TA, TC, TOut>;
  if (bytes > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         bytes);
  dim3 grid((M + BM_ - 1) / BM_, (N + BN_ - 1) / BN_);
  kernel<<<grid, THREADS, bytes, stream>>>(A, B, M, N, K, ep);
}

// Largest row tile MAX_BM: 128, which must divide a dynamic scale group.
constexpr int MAX_BM = 128;

template <typename TA, typename TC, typename TOut>
inline void launch_gemm_tc(const TA* A, const TC* B, int M, int N, int K,
                           const Epilogue<TOut>& ep, cudaStream_t stream) {
  if (M <= 1024)
    launch_tile<32, 64>(A, B, M, N, K, ep, stream);
  else if (M <= 8192)
    launch_tile<64, 64>(A, B, M, N, K, ep, stream);
  else
    launch_tile<MAX_BM, 128>(A, B, M, N, K, ep, stream);
}

}  // namespace lifting
