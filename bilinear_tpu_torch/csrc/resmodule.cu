// The torch7 bottleneck ResModule (kernels K3 and K4 of the port):
//
//   skip = x @ Wsk + bsk  (or x)
//   a1 = relu(bn1(x));  h1 = a1 @ W1 + b1                      Ci -> Ch
//   a2 = relu(bn2(h1)); h2 = sum_t mask_t(q) a2[q + d_t] @ W2[t] + b2   3x3
//   a3 = relu(bn3(h2)); out = skip + a3 @ W3 + b3              Ch -> Co
//
// on (N = B*H*W, C) rows of an NHWC activation, forward in train mode (batch
// statistics) or eval mode (running statistics), and the train-mode
// backward, which recomputes h1 and h2 from x and the saved statistics.
//
// Replaces: bilinear_tpu/ops/pallas/resmodule.py::_build_fwd (K3, body
// _fwd_kernel_body) and ::_build_bwd (K4, body _bwd_kernel_body_chunked).
//
// What bounds it on an H100: at (8, 64, 64, 256 -> 256) in bf16 the forward
// is 1.40e10 FLOPs (0.0141 ms at 989 TFLOP/s) against 33.6 MB of x and out
// (0.0100 ms at 3.35 TB/s), so operations bound it; the backward twice that.
//
// Design. The TPU kernel keeps x, h1, a2 and h2 of the whole batch in
// ~118 MB of VMEM; an SM has 227 KB, and train-mode BN needs a reduction
// over all N rows before the next stage can normalise. So the block is a
// chain of launches:
//   - column statistics: two passes (mean, then the mean of squared
//     deviations) over values of the working type, in f32, as per-block
//     partial sums reduced by a second launch in a fixed order: reruns give
//     bit-identical statistics (no float atomics);
//   - one tiled GEMM per conv, whose A-tile loader applies BN + ReLU to the
//     rows it loads (the prologue) and rounds to the working type, and whose
//     epilogue rounds the product, adds the rounded bias, and adds the
//     residual. The 3x3 conv is an implicit GEMM over K = 9 * Ch: the loader
//     reads row q + dy*W + dx for tap (dy, dx) and zeroes a tap that crosses
//     an image edge in activation space (after BN + ReLU, as the TPU kernel
//     does), guarding the address itself, since there is no zeroed margin
//     to read here;
//   - the backward's weight gradients (reductions over N) are split-N
//     partial GEMMs into f32 buffers reduced in a fixed order; its data
//     gradients are GEMMs with transposed weights (the 3x3 one reads
//     g_h2[q - d_t] under the mask of the negated tap), whose epilogue gates
//     by the sign of the BN output; the BN backward is an elementwise pass
//     after its column reductions.
// bf16 products run on tensor cores (WMMA 16x16x16, bf16 -> f32) in 128 x 64
// tiles (8 warps as 4 x 2, each 32 x 32) with the next K slice's global loads
// in registers while the current one is multiplied; f32 runs a SIMT FMA
// GEMM in the same tiles. This first version keeps every intermediate in
// device memory; wgmma, TMA and fusing the stages are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace rm {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr float EPS = 1e-5f;
constexpr int THREADS = 256;
constexpr int MAXC = 256;          // channels whose BN parameters fit in smem
constexpr int BM = 128, BN = 64, BK = 32;  // GEMM tile
constexpr int WK = 64, WN = 64, WR = 32;   // weight-gradient tile, row chunk
constexpr int COL_ROWS = 256;      // rows per block of a column reduction

// ---- element types --------------------------------------------------------

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
// Round to T and back.
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

template <typename T> struct Cfg;
template <> struct Cfg<bf16> { static constexpr int VEC = 8, PAD = 8; };
template <> struct Cfg<float> { static constexpr int VEC = 4, PAD = 4; };

// 16 bytes (VEC elements) global -> float registers.
__device__ __forceinline__ void ld16(const bf16* p, float* o) {
  uint4 u = *reinterpret_cast<const uint4*>(p);
  const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = __bfloat162float(e[i]);
}
__device__ __forceinline__ void ld16(const float* p, float* o) {
  float4 f = *reinterpret_cast<const float4*>(p);
  o[0] = f.x; o[1] = f.y; o[2] = f.z; o[3] = f.w;
}
// VEC floats (exact in T) -> 16 bytes of shared memory.
__device__ __forceinline__ void st16(bf16* p, const float* v) {
  uint4 u;
  bf16* e = reinterpret_cast<bf16*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) e[i] = __float2bfloat16_rn(v[i]);
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ void st16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// ---- BN -------------------------------------------------------------------

__device__ __forceinline__ float rsqrt_eps(float v) {
  return __frsqrt_rn(__fadd_rn(v, EPS));
}
// y = (h - m) * rs * g + b, in this order, without contraction.
__device__ __forceinline__ float bn_y(float h, float m, float rs, float g,
                                      float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(h, m), rs), g), b);
}

// ---- the A operand: what a GEMM row loader reads --------------------------

enum { A_PLAIN = 0, A_BN = 1, A_CONV_BN = 2, A_CONV_NEG = 3 };

template <typename T>
struct ALoad {
  const T* src;  // (M, C) rows
  int C;         // channels of src; K = C, or 9 * C for the conv modes
  int H, W;      // image geometry of the rows (conv modes)
  const float *m, *v, *g, *b;  // BN of src's channels (BN modes)
};

struct BNSmem {
  float m[MAXC], rs[MAXC], g[MAXC], b[MAXC];
};

template <int MODE, typename T>
__device__ __forceinline__ void stage_bn(const ALoad<T>& a, BNSmem& s) {
  if (MODE == A_BN || MODE == A_CONV_BN) {
    for (int c = threadIdx.x; c < a.C; c += THREADS) {
      s.m[c] = a.m[c];
      s.rs[c] = rsqrt_eps(a.v[c]);
      s.g[c] = a.g[c];
      s.b[c] = a.b[c];
    }
  }
  __syncthreads();
}

// VEC consecutive elements of row `row`, columns k..k+VEC of the effective
// A matrix (zeros for rows >= limit and for masked taps).
template <int MODE, typename T>
__device__ __forceinline__ void load_a(const ALoad<T>& a, const BNSmem& s,
                                       int limit, int row, int k, float* o) {
  constexpr int VEC = Cfg<T>::VEC;
  bool ok = row < limit;
  int c = k;
  long src_row = row;
  if (MODE == A_CONV_BN || MODE == A_CONV_NEG) {
    int t = k / a.C;
    c = k - t * a.C;
    int dy = t / 3 - 1, dx = t % 3 - 1;
    if (MODE == A_CONV_NEG) { dy = -dy; dx = -dx; }
    int xq = row % a.W, yq = (row / a.W) % a.H;
    ok = ok && xq + dx >= 0 && xq + dx < a.W && yq + dy >= 0 && yq + dy < a.H;
    src_row = (long)row + dy * a.W + dx;  // read only when ok
  }
  if (!ok) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) o[i] = 0.0f;
    return;
  }
  ld16(a.src + src_row * a.C + c, o);
  if (MODE == A_BN || MODE == A_CONV_BN) {
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      o[i] = rnd<T>(fmaxf(bn_y(o[i], s.m[c + i], s.rs[c + i], s.g[c + i],
                               s.b[c + i]), 0.0f));
  }
}

// ---- GEMM: out = epilogue(A @ B), A (M, K) from ALoad, B (K, N) row-major -

enum { E_BIAS = 0, E_GATE = 1 };

template <typename T>
struct Epi {
  // E_BIAS: out_t = rnd(rnd(acc) + rnd(bias)), then + resid and rounded.
  // resid may alias out_t (same element, read before the write).
  const float* bias;
  const T* resid;
  T* out_t;
  // E_GATE: out_f = acc where bn(gate_h) > 0 (or everywhere when gate_h is
  // null), else 0, with the BN of gate_h's channels (the output columns).
  const T* gate_h;
  const float *gm, *gv, *gg, *gb;
  float* out_f;
};

template <typename T, int EMODE>
__device__ __forceinline__ void epi_apply(const Epi<T>& ep, int row, int col,
                                          int N, float acc) {
  size_t idx = (size_t)row * N + col;
  if (EMODE == E_BIAS) {
    float y = rnd<T>(__fadd_rn(rnd<T>(acc), rnd<T>(ep.bias[col])));
    if (ep.resid) y = __fadd_rn(y, to_f(ep.resid[idx]));
    ep.out_t[idx] = from_f<T>(y);
  } else {
    float o = acc;
    if (ep.gate_h) {
      float y = bn_y(to_f(ep.gate_h[idx]), ep.gm[col], rsqrt_eps(ep.gv[col]),
                     ep.gg[col], ep.gb[col]);
      if (!(y > 0.0f)) o = 0.0f;
    }
    ep.out_f[idx] = o;
  }
}

// Grid: (ceil(M / BM), N / BN). K % BK == 0, N % BN == 0.
template <typename T, int AMODE, int EMODE>
__global__ void __launch_bounds__(THREADS)
gemm_k(ALoad<T> a, const T* __restrict__ B, int M, int N, int K, Epi<T> ep) {
  constexpr int VEC = Cfg<T>::VEC;
  constexpr int LDA = BK + Cfg<T>::PAD, LDB = BN + Cfg<T>::PAD;
  constexpr int AV = BM * BK / VEC / THREADS;
  constexpr int BV = BK * BN / VEC / THREADS;
  __shared__ __align__(128) T As[BM * LDA];
  __shared__ __align__(128) T Bs[BK * LDB];
  __shared__ __align__(128) float stage[THREADS / 32][256];
  __shared__ BNSmem bn;

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  stage_bn<AMODE>(a, bn);

  float ra[AV][VEC], rb[BV][VEC];
  auto gload = [&](int k0) {
#pragma unroll
    for (int i = 0; i < AV; ++i) {
      int idx = tid + i * THREADS;
      int r = idx / (BK / VEC), kk = (idx % (BK / VEC)) * VEC;
      load_a<AMODE>(a, bn, M, m0 + r, k0 + kk, ra[i]);
    }
#pragma unroll
    for (int i = 0; i < BV; ++i) {
      int idx = tid + i * THREADS;
      int kr = idx / (BN / VEC), nn = (idx % (BN / VEC)) * VEC;
      ld16(B + (size_t)(k0 + kr) * N + n0 + nn, rb[i]);
    }
  };
  auto sstore = [&]() {
#pragma unroll
    for (int i = 0; i < AV; ++i) {
      int idx = tid + i * THREADS;
      int r = idx / (BK / VEC), kk = (idx % (BK / VEC)) * VEC;
      st16(As + r * LDA + kk, ra[i]);
    }
#pragma unroll
    for (int i = 0; i < BV; ++i) {
      int idx = tid + i * THREADS;
      int kr = idx / (BN / VEC), nn = (idx % (BN / VEC)) * VEC;
      st16(Bs + kr * LDB + nn, rb[i]);
    }
  };

  const int ktiles = K / BK;
  if constexpr (sizeof(T) == 2) {
    const int warp = tid >> 5, lane = tid & 31;
    const int wm = warp >> 1, wn = warp & 1;  // 4 x 2 warps of 32 x 32
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
    gload(0);
    for (int kt = 0; kt < ktiles; ++kt) {
      sstore();
      __syncthreads();
      if (kt + 1 < ktiles) gload((kt + 1) * BK);
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], As + (wm * 32 + i * 16) * LDA + kc * 16,
                                 LDA);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], Bs + kc * 16 * LDB + wn * 32 + j * 16,
                                 LDB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      __syncthreads();
    }
    float* st = stage[warp];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          int row = m0 + wm * 32 + i * 16 + (e >> 4);
          int col = n0 + wn * 32 + j * 16 + (e & 15);
          if (row < M) epi_apply<T, EMODE>(ep, row, col, N, st[e]);
        }
        __syncwarp();
      }
  } else {
    const int tr = tid >> 4, tc = tid & 15;  // 8 rows x 4 columns each
    float acc[8][4] = {};
    gload(0);
    for (int kt = 0; kt < ktiles; ++kt) {
      sstore();
      __syncthreads();
      if (kt + 1 < ktiles) gload((kt + 1) * BK);
#pragma unroll 8
      for (int k = 0; k < BK; ++k) {
        float av[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) av[i] = to_f(As[(tr * 8 + i) * LDA + k]);
        float4 bv = *reinterpret_cast<const float4*>(
            reinterpret_cast<const float*>(Bs) + k * LDB + tc * 4);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[i][0] = fmaf(av[i], bv.x, acc[i][0]);
          acc[i][1] = fmaf(av[i], bv.y, acc[i][1]);
          acc[i][2] = fmaf(av[i], bv.z, acc[i][2]);
          acc[i][3] = fmaf(av[i], bv.w, acc[i][3]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      int row = m0 + tr * 8 + i;
      if (row >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        epi_apply<T, EMODE>(ep, row, n0 + tc * 4 + j, N, acc[i][j]);
    }
  }
}

// ---- weight gradient: part[z] = A[rows of split z]^T @ G[rows of split z] -
// Grid: (K / WK, N / WN, splits); A (M, K) from ALoad, G (M, N) row-major.

template <typename T, int AMODE>
__global__ void __launch_bounds__(THREADS)
wgrad_k(ALoad<T> a, const T* __restrict__ G, int M, int K, int N,
        int rows_per_split, float* __restrict__ part) {
  constexpr int VEC = Cfg<T>::VEC, LD = WK + Cfg<T>::PAD;
  constexpr int V = WR * WK / VEC / THREADS;
  __shared__ __align__(128) T As[WR * LD];
  __shared__ __align__(128) T Gs[WR * LD];
  __shared__ BNSmem bn;
  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * WK, n0 = blockIdx.y * WN;
  const int r0 = blockIdx.z * rows_per_split;
  const int r1 = min(M, r0 + rows_per_split);
  stage_bn<AMODE>(a, bn);
  float* out = part + (size_t)blockIdx.z * K * N;

  auto load_chunk = [&](int r) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      int idx = tid + i * THREADS;
      int rr = idx / (WK / VEC), cc = (idx % (WK / VEC)) * VEC;
      float va[VEC], vg[VEC];
      load_a<AMODE>(a, bn, r1, r + rr, k0 + cc, va);
      if (r + rr < r1) {
        ld16(G + (size_t)(r + rr) * N + n0 + cc, vg);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) vg[e] = 0.0f;
      }
      st16(As + rr * LD + cc, va);
      st16(Gs + rr * LD + cc, vg);
    }
  };

  if constexpr (sizeof(T) == 2) {
    const int warp = tid >> 5;
    const int kf = warp >> 1, nf0 = (warp & 1) * 2;  // 16 x 32 per warp
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
    wmma::fill_fragment(acc[0], 0.0f);
    wmma::fill_fragment(acc[1], 0.0f);
    for (int r = r0; r < r1; r += WR) {
      load_chunk(r);
      __syncthreads();
#pragma unroll
      for (int rr = 0; rr < WR; rr += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
        wmma::load_matrix_sync(fa, As + rr * LD + kf * 16, LD);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, Gs + rr * LD + (nf0 + j) * 16, LD);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(out + (size_t)(k0 + kf * 16) * N + n0 +
                                  (nf0 + j) * 16,
                              acc[j], N, wmma::mem_row_major);
  } else {
    const int tk = tid >> 4, tn = tid & 15;  // 4 x 4 each
    float acc[4][4] = {};
    for (int r = r0; r < r1; r += WR) {
      load_chunk(r);
      __syncthreads();
#pragma unroll 8
      for (int rr = 0; rr < WR; ++rr) {
        float4 av = *reinterpret_cast<const float4*>(
            reinterpret_cast<const float*>(As) + rr * LD + tk * 4);
        float4 gv = *reinterpret_cast<const float4*>(
            reinterpret_cast<const float*>(Gs) + rr * LD + tn * 4);
        float ai[4] = {av.x, av.y, av.z, av.w};
        float gj[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ai[i], gj[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        out[(size_t)(k0 + tk * 4 + i) * N + n0 + tn * 4 + j] = acc[i][j];
  }
}

// out[i] = sum over p of part[p][i], p in order.
__global__ void sum_parts(const float* __restrict__ part, int nparts,
                          int size, float* out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size) return;
  float s = 0.0f;
  for (int p = 0; p < nparts; ++p) s += part[(size_t)p * size + i];
  out[i] = s;
}

// ---- column reductions over rows ------------------------------------------

enum { C_SUM = 0, C_SQDEV = 1, C_BNBWD = 2 };

// Per block: 32 columns x COL_ROWS rows, 8 row lanes; partial sums to
// part1[blockIdx.y][c] (and part2 for C_BNBWD: sum(gy * hhat), sum(gy)).
template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS)
col_partial(const T* __restrict__ x, const float* __restrict__ gy, int M,
            int C, const float* mean, const float* var, float* part1,
            float* part2) {
  __shared__ float s1[8][32], s2[8][32];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + tx;
  const int r0 = blockIdx.y * COL_ROWS, r1 = min(M, r0 + COL_ROWS);
  float m = (MODE != C_SUM) ? mean[c] : 0.0f;
  float rs = (MODE == C_BNBWD) ? rsqrt_eps(var[c]) : 0.0f;
  float a = 0.0f, b = 0.0f;
  for (int r = r0 + ty; r < r1; r += 8) {
    float v = to_f(x[(size_t)r * C + c]);
    if (MODE == C_SUM) {
      a += v;
    } else if (MODE == C_SQDEV) {
      float d = __fsub_rn(v, m);
      a = __fadd_rn(a, __fmul_rn(d, d));
    } else {
      float g = gy[(size_t)r * C + c];
      float hh = __fmul_rn(__fsub_rn(v, m), rs);
      a = __fadd_rn(a, __fmul_rn(g, hh));
      b += g;
    }
  }
  s1[ty][tx] = a;
  s2[ty][tx] = b;
  __syncthreads();
  if (ty == 0) {
    float ta = 0.0f, tb = 0.0f;
    for (int i = 0; i < 8; ++i) {
      ta += s1[i][tx];
      tb += s2[i][tx];
    }
    part1[(size_t)blockIdx.y * C + c] = ta;
    if (MODE == C_BNBWD) part2[(size_t)blockIdx.y * C + c] = tb;
  }
}

// out[c] = (sum over blocks of part[.][c]) / div, blocks in order.
__global__ void col_finish(const float* __restrict__ part, int nparts, int C,
                           float divisor, float* out, float* out2) {
  int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float s = 0.0f;
  for (int p = 0; p < nparts; ++p) s += part[(size_t)p * C + c];
  s = __fdiv_rn(s, divisor);
  out[c] = s;
  if (out2) out2[c] = s;
}

// ---- BN backward, elementwise ---------------------------------------------
// out = rnd((rs / n) * (n * gy' * g - g * dbe - hhat * (g * dg)) [+ addf]
//           [+ addt]), gy' = gy rounded to T when round_gy.
template <typename T>
__global__ void bn_bwd(const float* __restrict__ gy, const T* __restrict__ h,
                       const float* m, const float* v, const float* g,
                       const float* dg, const float* dbe, int round_gy,
                       const float* __restrict__ addf,
                       const T* __restrict__ addt, T* __restrict__ out,
                       size_t total, int C, float nf) {
  size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  int c = (int)(i % C);
  float rs = rsqrt_eps(v[c]);
  float hh = __fmul_rn(__fsub_rn(to_f(h[i]), m[c]), rs);
  float gv = round_gy ? rnd<T>(gy[i]) : gy[i];
  float ghat = __fmul_rn(gv, g[c]);
  float t = __fsub_rn(__fsub_rn(__fmul_rn(nf, ghat), __fmul_rn(g[c], dbe[c])),
                      __fmul_rn(hh, __fmul_rn(g[c], dg[c])));
  float r = __fmul_rn(__fdiv_rn(rs, nf), t);
  if (addf) r = __fadd_rn(r, addf[i]);
  if (addt) r = __fadd_rn(r, to_f(addt[i]));
  out[i] = from_f<T>(r);
}

// ---- host-side launch helpers ---------------------------------------------

template <typename T>
ALoad<T> rows(const void* src, int C, int H = 1, int W = 1,
              const float* m = nullptr, const float* v = nullptr,
              const float* g = nullptr, const float* b = nullptr) {
  ALoad<T> a;
  a.src = static_cast<const T*>(src);
  a.C = C;
  a.H = H;
  a.W = W;
  a.m = m;
  a.v = v;
  a.g = g;
  a.b = b;
  return a;
}

template <typename T>
Epi<T> bias_epi(const float* bias, const void* resid, void* out) {
  Epi<T> e = {};
  e.bias = bias;
  e.resid = static_cast<const T*>(resid);
  e.out_t = static_cast<T*>(out);
  return e;
}

template <typename T>
Epi<T> gate_epi(const void* h, const float* m, const float* v, const float* g,
                const float* b, float* out) {
  Epi<T> e = {};
  e.gate_h = static_cast<const T*>(h);
  e.gm = m;
  e.gv = v;
  e.gg = g;
  e.gb = b;
  e.out_f = out;
  return e;
}

template <typename T, int AMODE, int EMODE>
void gemm(const ALoad<T>& a, const void* B, int M, int N, int K,
          const Epi<T>& ep, cudaStream_t s) {
  dim3 grid((M + BM - 1) / BM, N / BN);
  gemm_k<T, AMODE, EMODE><<<grid, THREADS, 0, s>>>(
      a, static_cast<const T*>(B), M, N, K, ep);
}

template <typename T, int AMODE>
void wgrad(const ALoad<T>& a, const void* G, int M, int K, int N, int splits,
           int rows_per_split, float* part, float* out, cudaStream_t s) {
  dim3 grid(K / WK, N / WN, splits);
  wgrad_k<T, AMODE><<<grid, THREADS, 0, s>>>(
      a, static_cast<const T*>(G), M, K, N, rows_per_split, part);
  int size = K * N;
  sum_parts<<<(size + 255) / 256, 256, 0, s>>>(part, splits, size, out);
}

inline int col_blocks(int M) { return (M + COL_ROWS - 1) / COL_ROWS; }

// Column sums of x (T) divided by divisor; out2 receives a copy when given.
template <typename T>
void col_sum(const void* x, int M, int C, float divisor, float* part,
             float* out, float* out2, cudaStream_t s) {
  int nb = col_blocks(M);
  col_partial<T, C_SUM><<<dim3(C / 32, nb), THREADS, 0, s>>>(
      static_cast<const T*>(x), nullptr, M, C, nullptr, nullptr, part,
      nullptr);
  col_finish<<<(C + 255) / 256, 256, 0, s>>>(part, nb, C, divisor, out, out2);
}

// Batch mean and biased variance of x's columns, two passes.
template <typename T>
void col_stats(const void* x, int M, int C, float* part, float* mean,
               float* var, cudaStream_t s) {
  col_sum<T>(x, M, C, (float)M, part, mean, nullptr, s);
  int nb = col_blocks(M);
  col_partial<T, C_SQDEV><<<dim3(C / 32, nb), THREADS, 0, s>>>(
      static_cast<const T*>(x), nullptr, M, C, mean, nullptr, part, nullptr);
  col_finish<<<(C + 255) / 256, 256, 0, s>>>(part, nb, C, (float)M, var,
                                             nullptr);
}

// (sum(gy * hhat), sum(gy)) over rows, hhat from h and its BN statistics.
template <typename T>
void col_bnbwd(const float* gy, const void* h, int M, int C, const float* m,
               const float* v, float* part, float* dg, float* dbe,
               cudaStream_t s) {
  int nb = col_blocks(M);
  float* part2 = part + (size_t)nb * C;
  col_partial<T, C_BNBWD><<<dim3(C / 32, nb), THREADS, 0, s>>>(
      static_cast<const T*>(h), gy, M, C, m, v, part, part2);
  col_finish<<<(C + 255) / 256, 256, 0, s>>>(part, nb, C, 1.0f, dg, nullptr);
  col_finish<<<(C + 255) / 256, 256, 0, s>>>(part2, nb, C, 1.0f, dbe, nullptr);
}

template <typename T>
void bnbwd(const float* gy, const void* h, int M, int C, const float* m,
           const float* v, const float* g, const float* dg, const float* dbe,
           int round_gy, const float* addf, const void* addt, void* out,
           cudaStream_t s) {
  size_t total = (size_t)M * C;
  bn_bwd<T><<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      gy, static_cast<const T*>(h), m, v, g, dg, dbe, round_gy, addf,
      static_cast<const T*>(addt), static_cast<T*>(out), total, C, (float)M);
}

// ---- the forward (K3) -----------------------------------------------------

template <typename T>
int forward(int train, int B, int H, int W, int ci, int ch, int co,
            const void* x, const void* w1, const float* b1, const void* w2,
            const float* b2, const void* w3, const float* b3, const float* g1,
            const float* be1, const float* g2, const float* be2,
            const float* g3, const float* be3, const void* skw,
            const float* skb, float* m1, float* v1, float* m2, float* v2,
            float* m3, float* v3, void* out, void* h1, void* h2, float* part,
            cudaStream_t s) {
  const int M = B * H * W;
  if (train) col_stats<T>(x, M, ci, part, m1, v1, s);
  gemm<T, A_BN, E_BIAS>(rows<T>(x, ci, H, W, m1, v1, g1, be1), w1, M, ch, ci,
                        bias_epi<T>(b1, nullptr, h1), s);
  if (train) col_stats<T>(h1, M, ch, part, m2, v2, s);
  gemm<T, A_CONV_BN, E_BIAS>(rows<T>(h1, ch, H, W, m2, v2, g2, be2), w2, M,
                             ch, 9 * ch, bias_epi<T>(b2, nullptr, h2), s);
  if (train) col_stats<T>(h2, M, ch, part, m3, v3, s);
  const void* resid = x;
  if (skw) {  // the skip product first, into out; conv3 adds itself to it
    gemm<T, A_PLAIN, E_BIAS>(rows<T>(x, ci), skw, M, co, ci,
                             bias_epi<T>(skb, nullptr, out), s);
    resid = out;
  }
  gemm<T, A_BN, E_BIAS>(rows<T>(h2, ch, H, W, m3, v3, g3, be3), w3, M, co, ch,
                        bias_epi<T>(b3, resid, out), s);
  return (int)cudaGetLastError();
}

// ---- the backward (K4), in the TPU kernel's pass order p5 ... p11 ---------

template <typename T>
int backward(int B, int H, int W, int ci, int ch, int co, const void* x,
             const void* gout, const void* w1, const float* b1,
             const void* w2, const float* b2, const float* g1,
             const float* be1, const float* g2, const float* be2,
             const float* g3, const float* be3, const void* w1t,
             const void* w2t, const void* w3t, const void* wskt,
             const float* m1, const float* v1, const float* m2,
             const float* v2, const float* m3, const float* v3, void* gx,
             float* dw1, float* db1, float* dw2, float* db2, float* dw3,
             float* db3, float* dg1, float* dbe1, float* dg2, float* dbe2,
             float* dg3, float* dbe3, float* dskw, float* dskb, void* h1,
             void* h2, void* gh2, void* gh1, float* gyc, float* gy1,
             float* skd, float* wpart, float* cpart, int splits, int rps,
             cudaStream_t s) {
  const int M = B * H * W;
  // recompute h1, h2
  gemm<T, A_BN, E_BIAS>(rows<T>(x, ci, H, W, m1, v1, g1, be1), w1, M, ch, ci,
                        bias_epi<T>(b1, nullptr, h1), s);
  gemm<T, A_CONV_BN, E_BIAS>(rows<T>(h1, ch, H, W, m2, v2, g2, be2), w2, M,
                             ch, 9 * ch, bias_epi<T>(b2, nullptr, h2), s);
  // p5: db3 (= dskip_b), dw3, gy3 and the bn3 reductions, dskip_w
  col_sum<T>(gout, M, co, 1.0f, cpart, db3, dskb, s);
  wgrad<T, A_BN>(rows<T>(h2, ch, H, W, m3, v3, g3, be3), gout, M, ch, co,
                 splits, rps, wpart, dw3, s);
  gemm<T, A_PLAIN, E_GATE>(rows<T>(gout, co), w3t, M, ch, co,
                           gate_epi<T>(h2, m3, v3, g3, be3, gyc), s);
  col_bnbwd<T>(gyc, h2, M, ch, m3, v3, cpart, dg3, dbe3, s);
  if (wskt)
    wgrad<T, A_PLAIN>(rows<T>(x, ci), gout, M, ci, co, splits, rps, wpart,
                      dskw, s);
  // p6: g_h2
  bnbwd<T>(gyc, h2, M, ch, m3, v3, g3, dg3, dbe3, 0, nullptr, nullptr, gh2, s);
  // p7: db2, dw2 (the implicit im2col of a2 against g_h2)
  col_sum<T>(gh2, M, ch, 1.0f, cpart, db2, nullptr, s);
  wgrad<T, A_CONV_BN>(rows<T>(h1, ch, H, W, m2, v2, g2, be2), gh2, M, 9 * ch,
                      ch, splits, rps, wpart, dw2, s);
  // p8: g_a2 -> gy2 (f32, reusing gyc) and the bn2 reductions
  gemm<T, A_CONV_NEG, E_GATE>(rows<T>(gh2, ch, H, W), w2t, M, ch, 9 * ch,
                              gate_epi<T>(h1, m2, v2, g2, be2, gyc), s);
  col_bnbwd<T>(gyc, h1, M, ch, m2, v2, cpart, dg2, dbe2, s);
  // p9: g_h1 from gy2 as stored in the working type
  bnbwd<T>(gyc, h1, M, ch, m2, v2, g2, dg2, dbe2, 1, nullptr, nullptr, gh1, s);
  // p10: db1, dw1, gy1 and the bn1 reductions
  col_sum<T>(gh1, M, ch, 1.0f, cpart, db1, nullptr, s);
  wgrad<T, A_BN>(rows<T>(x, ci, H, W, m1, v1, g1, be1), gh1, M, ci, ch,
                 splits, rps, wpart, dw1, s);
  gemm<T, A_PLAIN, E_GATE>(rows<T>(gh1, ch), w1t, M, ci, ch,
                           gate_epi<T>(x, m1, v1, g1, be1, gy1), s);
  col_bnbwd<T>(gy1, x, M, ci, m1, v1, cpart, dg1, dbe1, s);
  // p11: g_x = bn1 backward + the skip's data gradient
  if (wskt)
    gemm<T, A_PLAIN, E_GATE>(
        rows<T>(gout, co), wskt, M, ci, co,
        gate_epi<T>(nullptr, nullptr, nullptr, nullptr, nullptr, skd), s);
  bnbwd<T>(gy1, x, M, ci, m1, v1, g1, dg1, dbe1, 0, wskt ? skd : nullptr,
           wskt ? nullptr : gout, gx, s);
  return (int)cudaGetLastError();
}

}  // namespace rm

// C entries. is_bf16: 1 for bf16 tensors, 0 for f32. Rows are NHWC
// (B*H*W, C) row-major; 1x1 weights (in, out), w2 (9 * Ch, Ch) in TAPS order;
// biases, BN parameters and statistics f32. skw/skb null for the identity
// skip. Train mode writes m1..v3, eval mode reads them. Returns
// cudaGetLastError().
extern "C" int resmodule_forward(
    int is_bf16, int train, int B, int H, int W, int ci, int ch, int co,
    const void* x, const void* w1, const void* b1, const void* w2,
    const void* b2, const void* w3, const void* b3, const void* g1,
    const void* be1, const void* g2, const void* be2, const void* g3,
    const void* be3, const void* skw, const void* skb, void* m1, void* v1,
    void* m2, void* v2, void* m3, void* v3, void* out, void* h1, void* h2,
    void* part, void* stream) {
  auto F = [](const void* p) { return static_cast<const float*>(p); };
  auto O = [](void* p) { return static_cast<float*>(p); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return rm::forward<rm::bf16>(
        train, B, H, W, ci, ch, co, x, w1, F(b1), w2, F(b2), w3, F(b3), F(g1),
        F(be1), F(g2), F(be2), F(g3), F(be3), skw, F(skb), O(m1), O(v1),
        O(m2), O(v2), O(m3), O(v3), out, h1, h2, O(part), s);
  return rm::forward<float>(
      train, B, H, W, ci, ch, co, x, w1, F(b1), w2, F(b2), w3, F(b3), F(g1),
      F(be1), F(g2), F(be2), F(g3), F(be3), skw, F(skb), O(m1), O(v1), O(m2),
      O(v2), O(m3), O(v3), out, h1, h2, O(part), s);
}

// Gradients: g_x in the working type, every parameter gradient f32 (dw2 as
// (9, Ch, Ch)); dskw/dskb null for the identity skip. w1t (Ch, Ci), w2t the
// (9 * Ch, Ch) stack of w2[t]^T, w3t (Co, Ch), wskt (Co, Ci). Scratch: h1,
// h2, gh2, gh1 (N, Ch) in the working type; gyc (N, Ch), gy1 (N, Ci) and skd
// (N, Ci) f32; wpart (splits * max K*N) and cpart (column partials) f32.
extern "C" int resmodule_backward(
    int is_bf16, int B, int H, int W, int ci, int ch, int co, const void* x,
    const void* gout, const void* w1, const void* b1, const void* w2,
    const void* b2, const void* g1, const void* be1, const void* g2,
    const void* be2, const void* g3, const void* be3, const void* w1t,
    const void* w2t, const void* w3t, const void* wskt, const void* m1,
    const void* v1, const void* m2, const void* v2, const void* m3,
    const void* v3, void* gx, void* dw1, void* db1, void* dw2, void* db2,
    void* dw3, void* db3, void* dg1, void* dbe1, void* dg2, void* dbe2,
    void* dg3, void* dbe3, void* dskw, void* dskb, void* h1, void* h2,
    void* gh2, void* gh1, void* gyc, void* gy1, void* skd, void* wpart,
    void* cpart, int splits, int rows_per_split, void* stream) {
  auto F = [](const void* p) { return static_cast<const float*>(p); };
  auto O = [](void* p) { return static_cast<float*>(p); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return rm::backward<rm::bf16>(
        B, H, W, ci, ch, co, x, gout, w1, F(b1), w2, F(b2), F(g1), F(be1),
        F(g2), F(be2), F(g3), F(be3), w1t, w2t, w3t, wskt, F(m1), F(v1),
        F(m2), F(v2), F(m3), F(v3), gx, O(dw1), O(db1), O(dw2), O(db2),
        O(dw3), O(db3), O(dg1), O(dbe1), O(dg2), O(dbe2), O(dg3), O(dbe3),
        O(dskw), O(dskb), h1, h2, gh2, gh1, O(gyc), O(gy1), O(skd), O(wpart),
        O(cpart), splits, rows_per_split, s);
  return rm::backward<float>(
      B, H, W, ci, ch, co, x, gout, w1, F(b1), w2, F(b2), F(g1), F(be1),
      F(g2), F(be2), F(g3), F(be3), w1t, w2t, w3t, wskt, F(m1), F(v1), F(m2),
      F(v2), F(m3), F(v3), gx, O(dw1), O(db1), O(dw2), O(db2), O(dw3), O(db3),
      O(dg1), O(dbe1), O(dg2), O(dbe2), O(dg3), O(dbe3), O(dskw), O(dskb), h1,
      h2, gh2, gh1, O(gyc), O(gy1), O(skd), O(wpart), O(cpart), splits,
      rows_per_split, s);
}
