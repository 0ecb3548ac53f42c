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
// Below N = 8192 rows every stage is less than one wave of blocks and the
// chain is bound by the latency of its stages, one after the other.
//
// Design. The TPU kernel keeps x, h1, a2 and h2 of the whole batch in
// ~118 MB of VMEM; an SM has 227 KB, and train-mode BN needs a reduction
// over all N rows before the next stage can normalise. So the block is a
// chain of launches, 8 for a train forward, 4 for an eval forward and 16 to
// 18 for a backward:
//   - one launch packs the call's weights: it reads each f32 weight where
//     PyTorch keeps it, by its strides (a transposed or permuted view costs
//     no copy), rounds to the working type and writes it with K contiguous,
//     the layout the GEMMs' B tiles are copied from;
//   - one GEMM per conv on 128-row tiles. The A-tile loader applies BN +
//     ReLU to the rows it loads and rounds to the working type. The
//     accumulators are staged in shared memory and the epilogue walks them
//     row by row with 16-byte accesses: it rounds the product, adds the
//     rounded bias and the skip, and in the same pass reduces what the next
//     stage needs over the tile's rows;
//   - the forward 3x3 conv copies each tile's rows and their halo (W + 1
//     rows either side) into shared memory, applies BN + ReLU once per
//     element there, and reads the nine taps' A operands from that tile at
//     the taps' row offsets with ldmatrix, into registers; a tap that
//     crosses an image edge is zeroed in activation space (after BN + ReLU,
//     as the TPU kernel does). The backward's 3x3 data gradient runs
//     through the same kernel on g_h2 under the negated taps, without the
//     BN + ReLU step. The tile needs (128 + 2 W + 2) * (2 Ch + 16) bytes,
//     which bounds the image width (W <= 217 at Ch = 128, 277 with the
//     64-column tile of fewer than 8192 rows): wider images are refused,
//     see conv_fits;
//   - a BN's batch statistics come out of the producing epilogue as per-tile
//     (mean, M2) over the values already rounded to the working type (x's
//     own take one pass of the same form), merged by Chan's formula in a
//     fixed order by one finish launch that also updates the running
//     statistics in place: no float atomics, reruns give identical bits;
//   - the 1x1 skip is a second product inside conv3's launch, rounded
//     separately, kept in shared memory and added in the working type;
//   - in the backward the BN reductions sum(gy * hhat) and sum(gy) come out
//     of the gating epilogue that produces gy, as per-tile partials finished
//     in one launch; the column sums of g_out, g_h2 and g_h1 (the bias
//     gradients) are folded into the weight-gradient launches that read
//     them; the weight gradients are split-N partial products reduced in a
//     fixed order by one launch for all of them, which writes each gradient
//     in its parameter's own layout.
// Under data parallelism the BN statistics are the global batch's, as
// inside JAX's GSPMD program, but a C entry cannot call torch.distributed:
// a train forward or a backward then runs as four stages of the same entry
// (Stage, the STAGE slot). Each of stages 0-2 ends with this rank's row of
// one BN reduction (the forward's (mean, M2, count) per channel, the
// backward's (sum gy * hhat, sum gy)); the caller gathers every rank's row
// and the next stage starts by merging them in rank order (rank_merge_k:
// Chan's formula, then the running update once with the global count;
// rank_sum_k), the same bits on every rank. The rows are 2 C + 1 floats:
// the exchanges cost host round trips, not bandwidth.
// bf16 products run on wgmma (m64nNk16, f32 accumulators, operands in
// 128-byte swizzled shared-memory tiles or, for the 3x3, A in registers)
// from a ring of cp.async stages filled up to three K slabs ahead: two
// warpgroups of 64 rows share one B tile whose width is the whole output
// width where the row tiles alone fill the card (64 columns below that), a
// thread transforms in place the chunks it copied itself, and one block
// barrier per slab publishes the stage. The weight gradients take both
// operands transposed through the descriptors (rows are the reduction
// dimension). f32 runs SIMT FMA loops in full f32 with the same epilogues.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_sm90.cuh"

namespace rm {

using bf16 = __nv_bfloat16;

constexpr float EPS = 1e-5f;
constexpr int THREADS = 256;
constexpr int MAXC = 256;  // channels whose BN parameters fit in smem
constexpr int BM = 128;    // rows of a GEMM tile and of a statistics partial
constexpr int LANES = 8;    // row lanes of a statistics partial
constexpr int GROUPS = 32;  // ordered groups of a finish reduction
constexpr int FIN_THREADS = 32 * GROUPS;

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

// ---- BN -------------------------------------------------------------------

__device__ __forceinline__ float rsqrt_eps(float v) {
  return __frsqrt_rn(__fadd_rn(v, EPS));
}
// y = (h - m) * rs * g + b, in this order, without contraction.
__device__ __forceinline__ float bn_y(float h, float m, float rs, float g,
                                      float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(h, m), rs), g), b);
}

// ---- the operands ---------------------------------------------------------

enum { A_PLAIN = 0, A_BN = 1, A_CONV_BN = 2, A_CONV_NEG = 3 };

// The A operand: what a row loader reads.
template <typename T>
struct ALoad {
  const T* src;  // (M, C) rows
  int C;         // channels of src; K = C, or 9 * C for the conv modes
  int H, W;      // image geometry of the rows (conv modes)
  const float *m, *v, *g, *b;  // BN of src's channels (BN modes)
};

// The B operand: a (K, N) matrix packed by pack_k in the working type with
// K contiguous, element (k, n) at p[((k / kper) * N + n) * kper + k % kper].
// kper = K for a 1x1 weight, Ch for the taps of the 3x3.
template <typename T>
struct BOp {
  const T* p;
  int kper, N;
};

struct BNSmem {
  float m[MAXC], rs[MAXC], g[MAXC], b[MAXC];
};

template <int MODE, typename T>
__device__ __forceinline__ void stage_bn(const ALoad<T>& a, BNSmem& s) {
  if (MODE == A_BN || MODE == A_CONV_BN) {
    for (int c = threadIdx.x; c < a.C; c += blockDim.x) {
      s.m[c] = a.m[c];
      s.rs[c] = rsqrt_eps(a.v[c]);
      s.g[c] = a.g[c];
      s.b[c] = a.b[c];
    }
  }
  __syncthreads();
}

// ---- epilogues ------------------------------------------------------------

enum { E_BIAS = 0, E_GATE = 1 };

template <typename T>
struct Epi {
  // E_BIAS: out_t = rnd(rnd(acc) + rnd(bias)), then + the skip (the second
  // product rnd(rnd(acc2) + rnd(bias2)), or resid) and rounded. stat_part,
  // when given, receives the tile's (mean, M2) of out_t's columns as
  // [tile][2][N].
  const float* bias;
  const float* bias2;
  const T* resid;
  T* out_t;
  float* stat_part;
  // E_GATE: out_f = acc where bn(gate_h) > 0 (or everywhere when gate_h is
  // null), else 0, with the BN of gate_h's channels (the output columns).
  // red_part, when given, receives the tile's (sum(out * hhat), sum(out))
  // as [tile][2][N].
  const T* gate_h;
  const float *gm, *gv, *gg, *gb;
  float* out_f;
  float* red_part;
};

template <typename T>
struct GemmArgs {
  ALoad<T> a;
  BOp<T> b;
  int M, N, K;
  Epi<T> ep;
  ALoad<T> a2;  // the skip product (SKIP): A_PLAIN rows of x against b2
  BOp<T> b2;
  int K2;
};

// 8 consecutive elements of T <-> floats.
__device__ __forceinline__ void load8(const bf16* p, float* v) {
  uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(e[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float* v) {
  float4 a = reinterpret_cast<const float4*>(p)[0];
  float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ uint4 pack8(const float* v) {
  uint4 u;
  __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    e[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  return u;
}
__device__ __forceinline__ void store8(bf16* p, const float* v) {
  *reinterpret_cast<uint4*>(p) = pack8(v);
}

// Epilogue geometry: a thread owns 8 consecutive columns (16-byte accesses)
// and every RPP-th row of the 128-row tile.
template <int NT>
struct EpiGeom {
  static constexpr int LPR = NT / 8;         // threads along a row
  static constexpr int RPP = THREADS / LPR;  // rows per pass
  static constexpr int PASSES = BM / RPP;
  static constexpr int RED = RPP * NT;       // floats of reduction scratch
};

// tot[q] = the sum of v[q] over the threads that own the same 8 columns, in
// the order of their rows; every thread calls it.
template <int NT>
__device__ __forceinline__ void column_totals(const float* v, float* red,
                                              float* tot) {
  using G = EpiGeom<NT>;
  const int c0 = (threadIdx.x % G::LPR) * 8, rl = threadIdx.x / G::LPR;
  __syncthreads();
  store8(red + rl * NT + c0, v);
  __syncthreads();
#pragma unroll
  for (int q = 0; q < 8; ++q) tot[q] = 0.0f;
  for (int r = 0; r < G::RPP; ++r) {
    float t[8];
    load8(red + r * NT + c0, t);
#pragma unroll
    for (int q = 0; q < 8; ++q) tot[q] += t[q];
  }
}

// The epilogue over a staged tile: stg holds the accumulators of rows m0 ..
// m0 + BM, columns n0 .. n0 + NT as f32 with row stride NT + 8; skp the
// rounded skip product of the same elements in T (SKIP); red has
// EpiGeom<NT>::RED floats. Rows are taken UP at a time, their global reads
// started together before any is used.
template <typename T, int NT, int EMODE, bool SKIP>
__device__ __forceinline__ void epilogue(const Epi<T>& ep, int M, int N,
                                         int m0, int n0, float* stg,
                                         const T* skp, float* red) {
  using G = EpiGeom<NT>;
  constexpr int LDS = NT + 8, UP = 4;
  const int c0 = (threadIdx.x % G::LPR) * 8, rl = threadIdx.x / G::LPR;
  const int col = n0 + c0;
  const int rows = min(BM, M - m0);
  float s1[8], s2[8], tot[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) s1[q] = s2[q] = 0.0f;
  if (EMODE == E_BIAS) {
    float bias[8];
    load8(ep.bias + col, bias);
#pragma unroll
    for (int q = 0; q < 8; ++q) bias[q] = rnd<T>(bias[q]);
    const bool stats = ep.stat_part != nullptr;
    const bool resid = !SKIP && ep.resid != nullptr;
#pragma unroll
    for (int p0 = 0; p0 < G::PASSES; p0 += UP) {
      float res[UP][8];
#pragma unroll
      for (int u = 0; u < UP; ++u) {
        int r = rl + (p0 + u) * G::RPP;
        if (resid && r < rows)
          load8(ep.resid + (size_t)(m0 + r) * N + col, res[u]);
      }
#pragma unroll
      for (int u = 0; u < UP; ++u) {
        int r = rl + (p0 + u) * G::RPP;
        if (r < rows) {
          float v[8], k[8];
          load8(stg + r * LDS + c0, v);
          if (SKIP) load8(skp + r * LDS + c0, k);
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            float y = rnd<T>(__fadd_rn(rnd<T>(v[q]), bias[q]));
            if (SKIP) {
              y = __fadd_rn(y, k[q]);
            } else if (resid) {
              y = __fadd_rn(y, res[u][q]);
            }
            v[q] = rnd<T>(y);
            s1[q] += v[q];
          }
          store8(ep.out_t + (size_t)(m0 + r) * N + col, v);
          if (stats) store8(stg + r * LDS + c0, v);
        }
      }
    }
    if (stats) {  // two passes inside the tile: the mean, then M2 about it
      column_totals<NT>(s1, red, tot);
      float mean[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) mean[q] = __fdiv_rn(tot[q], (float)rows);
      for (int r = rl; r < rows; r += G::RPP) {
        float v[8];
        load8(stg + r * LDS + c0, v);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          float d = __fsub_rn(v[q], mean[q]);
          s2[q] = __fadd_rn(s2[q], __fmul_rn(d, d));
        }
      }
      column_totals<NT>(s2, red, tot);
      if (rl == 0) {
        float* part = ep.stat_part + (size_t)blockIdx.x * 2 * N;
        store8(part + col, mean);
        store8(part + N + col, tot);
      }
    }
  } else {
    const bool gate = ep.gate_h != nullptr;
    float gm[8], grs[8], gg[8], gb[8];
    if (gate) {
      load8(ep.gm + col, gm);
      load8(ep.gv + col, grs);
      load8(ep.gg + col, gg);
      load8(ep.gb + col, gb);
#pragma unroll
      for (int q = 0; q < 8; ++q) grs[q] = rsqrt_eps(grs[q]);
    }
#pragma unroll
    for (int p0 = 0; p0 < G::PASSES; p0 += UP) {
      float h[UP][8];
#pragma unroll
      for (int u = 0; u < UP; ++u) {
        int r = rl + (p0 + u) * G::RPP;
        if (gate && r < rows)
          load8(ep.gate_h + (size_t)(m0 + r) * N + col, h[u]);
      }
#pragma unroll
      for (int u = 0; u < UP; ++u) {
        int r = rl + (p0 + u) * G::RPP;
        if (r < rows) {
          float o[8];
          load8(stg + r * LDS + c0, o);
          if (gate) {
#pragma unroll
            for (int q = 0; q < 8; ++q) {
              float hh = __fmul_rn(__fsub_rn(h[u][q], gm[q]), grs[q]);
              float y = __fadd_rn(__fmul_rn(hh, gg[q]), gb[q]);
              if (!(y > 0.0f)) o[q] = 0.0f;
              s1[q] = __fadd_rn(s1[q], __fmul_rn(o[q], hh));
              s2[q] += o[q];
            }
          }
          store8(ep.out_f + (size_t)(m0 + r) * N + col, o);
        }
      }
    }
    if (ep.red_part) {
      float* part = ep.red_part + (size_t)blockIdx.x * 2 * N;
      column_totals<NT>(s1, red, tot);
      if (rl == 0) store8(part + col, tot);
      column_totals<NT>(s2, red, tot);
      if (rl == 0) store8(part + N + col, tot);
    }
  }
}

// The skip product's accumulator as it is added later: rnd(rnd(acc) +
// rnd(bias2)).
template <typename T>
__device__ __forceinline__ T skip_value(float acc, float bias2) {
  return from_f<T>(__fadd_rn(rnd<T>(acc), rnd<T>(bias2)));
}

// ===========================================================================
// bf16: wgmma
// ===========================================================================

// (y << 16) | x of a row of the (B, H, W) image grid.
__device__ __forceinline__ int pack_yx(int row, int H, int W) {
  return (((row / W) % H) << 16) | (row % W);
}

// Byte offset of the 16-byte chunk j of row r in a 128-byte swizzled tile.
__device__ __forceinline__ uint32_t swz(int r, int j) {
  return (uint32_t)(r * 128 + ((j ^ (r & 7)) << 4));
}

// ---- asynchronous copies (cp.async, 16 bytes) ----------------------------

__device__ __forceinline__ void cp16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most N of this thread's committed groups are pending.
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Where a K slab of 64 starts in the A operand: first channel and, for the
// im2col rows of the 3x3's weight gradient (A_CONV_BN), the tap's offset.
struct Tap {
  int c0, dy, dx;
};
template <int AMODE>
__device__ __forceinline__ Tap tap_of(int C, int k0) {
  Tap t = {k0, 0, 0};
  if (AMODE == A_CONV_BN) {
    int tap = k0 / C;
    t.c0 = k0 - tap * C;
    t.dy = tap / 3 - 1;
    t.dx = tap % 3 - 1;
  }
  return t;
}
// Whether row `row` (image position yx) has a source row under the tap.
template <int AMODE>
__device__ __forceinline__ bool tap_ok(const Tap& t, int row, int limit, int yx,
                                       int H, int W) {
  bool ok = row < limit;
  if (AMODE == A_CONV_BN) {
    int y = (yx >> 16) + t.dy, x = (yx & 0xffff) + t.dx;
    ok = ok && (unsigned)y < (unsigned)H && (unsigned)x < (unsigned)W;
  }
  return ok;
}

// The A tile of a slab: ROWS rows from row0 on, 64 channels from column k0 on
// of the effective A matrix, as 128-byte swizzled rows (row r at r * 128). It
// is made in two steps by the same thread for the same chunks (thread tid:
// chunk tid % 8 of rows tid / 8 + i * NTH / 8; yx[i] is pack_yx of the i-th):
// copy_a_tile starts the raw copies (and zeroes the chunks of rows past the
// end or of taps that cross an image edge); transform_a_tile, once the
// thread's copies have landed, applies BN + ReLU in place and rounds. A
// masked chunk stays zero: the mask lives in activation space.
template <int AMODE, int ROWS, int NTH>
__device__ __forceinline__ void copy_a_tile(const ALoad<bf16>& a, int limit,
                                             int row0, const int* yx, int k0,
                                             unsigned char* tile) {
  const Tap t = tap_of<AMODE>(a.C, k0);
  const int j = threadIdx.x & 7, rb = threadIdx.x >> 3;
  const uint32_t dst0 = (uint32_t)__cvta_generic_to_shared(tile);
#pragma unroll
  for (int i = 0; i < ROWS * 8 / NTH; ++i) {
    const int r = rb + i * (NTH / 8), row = row0 + r;
    if (tap_ok<AMODE>(t, row, limit, yx[i], a.H, a.W)) {
      long src = (long)row + t.dy * a.W + t.dx;
      cp16(dst0 + swz(r, j), a.src + src * a.C + t.c0 + 8 * j);
    } else {
      *reinterpret_cast<uint4*>(tile + swz(r, j)) = make_uint4(0, 0, 0, 0);
    }
  }
}

template <int AMODE, int ROWS, int NTH>
__device__ __forceinline__ void transform_a_tile(const ALoad<bf16>& a,
                                                 const BNSmem& bn, int limit,
                                                 int row0, const int* yx,
                                                 int k0, unsigned char* tile) {
  if (AMODE != A_BN && AMODE != A_CONV_BN) return;
  const Tap t = tap_of<AMODE>(a.C, k0);
  const int j = threadIdx.x & 7, rb = threadIdx.x >> 3;
  const int c = t.c0 + 8 * j;
  float m[8], rs[8], g[8], b[8];
  load8(bn.m + c, m);
  load8(bn.rs + c, rs);
  load8(bn.g + c, g);
  load8(bn.b + c, b);
#pragma unroll
  for (int i = 0; i < ROWS * 8 / NTH; ++i) {
    const int r = rb + i * (NTH / 8);
    if (!tap_ok<AMODE>(t, row0 + r, limit, yx[i], a.H, a.W)) continue;
    uint4* p = reinterpret_cast<uint4*>(tile + swz(r, j));
    float v[8];
    load8(reinterpret_cast<const bf16*>(p), v);
#pragma unroll
    for (int q = 0; q < 8; ++q)
      v[q] = fmaxf(bn_y(v[q], m[q], rs[q], g[q], b[q]), 0.0f);
    *p = pack8(v);
  }
}

// NT columns from n0 on, 64 rows from k0 on of the B matrix: column n is the
// tile's row n (128 bytes of K, swizzled), copied as it lies.
template <int NT>
__device__ __forceinline__ void copy_b_tile(const BOp<bf16>& b, int k0, int n0,
                                             unsigned char* tile) {
  const int t = k0 / b.kper;
  const bf16* base = b.p + ((size_t)t * b.N + n0) * b.kper + (k0 - t * b.kper);
  const uint32_t dst0 = (uint32_t)__cvta_generic_to_shared(tile);
#pragma unroll
  for (int i = 0; i < NT * 8 / THREADS; ++i) {
    int q = threadIdx.x + i * THREADS;
    int n = q >> 3, j = q & 7;
    cp16(dst0 + swz(n, j), base + (size_t)n * b.kper + j * 8);
  }
}

template <int NT, bool SKIP>
struct Tc {
  static constexpr int A_BYTES = BM * 128;
  static constexpr int STAGE = A_BYTES + NT * 128;
  // Ring depth: copies run DEPTH - 2 slabs ahead of the product.
  static constexpr int DEPTH = NT == 256 ? (SKIP ? 3 : 4) : 5;
  static constexpr int RING = DEPTH * STAGE;
  static constexpr int LDS = NT + 8;
  static constexpr int SKIP_BYTES = BM * LDS * 2;
  static_assert(BM * LDS * 4 <= RING, "the staged accumulators reuse the ring");
  static constexpr int smem() {
    return 1024 + RING + (SKIP ? SKIP_BYTES : 0) + (int)sizeof(BNSmem) +
           EpiGeom<NT>::RED * 4;
  }
};

// acc = A[m0 .. m0 + 128, :K] @ B[:K, n0 .. n0 + NT] for this thread's
// warpgroup (64 rows). A ring of DEPTH stages: the raw copies of slab s +
// DEPTH - 2 are started when slab s is multiplied, into the stage whose
// product (slab s - 2) every warpgroup has waited for; a thread transforms
// the chunks it copied itself, so it only waits for its own copies, and one
// block barrier per slab publishes the stage to wgmma. Ends with the ring
// free.
template <int NT, int AMODE, bool SKIP>
__device__ __forceinline__ void tc_mainloop(const ALoad<bf16>& a,
                                            const BOp<bf16>& b, int K, int M,
                                            int m0, int n0, const int* yx,
                                            const BNSmem& bn,
                                            unsigned char* ring,
                                            float (&acc)[NT / 2]) {
  using C = Tc<NT, SKIP>;
  constexpr int D = C::DEPTH;
  const int slabs = K / 64;
  const int wgid = threadIdx.x >> 7;
  auto fetch = [&](int s) {
    if (s < slabs) {
      unsigned char* st = ring + (s % D) * C::STAGE;
      copy_a_tile<AMODE, BM, THREADS>(a, M, m0, yx, s * 64, st);
      copy_b_tile<NT>(b, s * 64, n0, st + C::A_BYTES);
    }
    cp_commit();  // one group per slab, empty past the end
  };
#pragma unroll
  for (int s = 0; s < D - 2; ++s) fetch(s);
  for (int s = 0; s < slabs; ++s) {
    unsigned char* st = ring + (s % D) * C::STAGE;
    cp_wait<D - 3>();  // this thread's copies of slab s have landed
    transform_a_tile<AMODE, BM, THREADS>(a, bn, M, m0, yx, s * 64, st);
    wg::fence_async_shared();
    __syncthreads();  // slab s is whole; every warpgroup is past slab s - 2
    fetch(s + D - 2);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wg::Mma<NT, 0, 0>::run(
          acc, wg::desc(st + wgid * 8192 + kk * 32, 16, 1024),
          wg::desc(st + C::A_BYTES + kk * 32, 16, 1024), (s | kk) != 0);
    wg::commit();
    wg::wait<1>();
  }
  wg::wait<0>();
  cp_wait<0>();
  __syncthreads();
}

// Grid: (ceil(M / 128), N / NT) blocks of 256 threads. NT is the whole output
// width where the row tiles alone fill the card; below that the columns are
// split over more blocks, each of which transforms the A tile again.
template <int NT, int AMODE, int EMODE, bool SKIP>
__global__ void __launch_bounds__(THREADS, 1)
gemm_tc_k(const __grid_constant__ GemmArgs<bf16> g) {
  using C = Tc<NT, SKIP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* after = ring + C::RING;
  bf16* skp = reinterpret_cast<bf16*>(after);
  if (SKIP) after += C::SKIP_BYTES;
  BNSmem& bn = *reinterpret_cast<BNSmem*>(after);
  float* red = reinterpret_cast<float*>(after + sizeof(BNSmem));
  float* stg = reinterpret_cast<float*>(ring);

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * NT;
  const int wgid = tid >> 7, warp = (tid & 127) >> 5, lane = tid & 31;
  const int frow = wgid * 64 + warp * 16 + (lane >> 2), fcol = 2 * (lane & 3);
  int yx[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    yx[i] = pack_yx(m0 + (tid >> 3) + i * 32, g.a.H, g.a.W);
  stage_bn<AMODE>(g.a, bn);

  float acc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0.0f;
  if (SKIP) {
    tc_mainloop<NT, A_PLAIN, SKIP>(g.a2, g.b2, g.K2, g.M, m0, n0, yx, bn, ring,
                                   acc);
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
      int col = 8 * j + fcol;
      float b0 = g.ep.bias2[n0 + col], b1 = g.ep.bias2[n0 + col + 1];
      __nv_bfloat162 lo, hi;
      lo.x = skip_value<bf16>(acc[4 * j], b0);
      lo.y = skip_value<bf16>(acc[4 * j + 1], b1);
      hi.x = skip_value<bf16>(acc[4 * j + 2], b0);
      hi.y = skip_value<bf16>(acc[4 * j + 3], b1);
      *reinterpret_cast<__nv_bfloat162*>(skp + frow * C::LDS + col) = lo;
      *reinterpret_cast<__nv_bfloat162*>(skp + (frow + 8) * C::LDS + col) = hi;
    }
  }
  tc_mainloop<NT, AMODE, SKIP>(g.a, g.b, g.K, g.M, m0, n0, yx, bn, ring, acc);
#pragma unroll
  for (int j = 0; j < NT / 8; ++j) {
    int col = 8 * j + fcol;
    *reinterpret_cast<float2*>(stg + frow * C::LDS + col) =
        make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(stg + (frow + 8) * C::LDS + col) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  __syncthreads();
  epilogue<bf16, NT, EMODE, SKIP>(g.ep, g.M, g.N, m0, n0, stg, skp, red);
}

// ---- the 3x3 convs: BN + ReLU once per element ----------------------------
// out = epilogue(sum_t mask_t * a[q + d_t] @ W[t]) on 128-row tiles, with a =
// relu(bn(h)) and the taps d_t (A_CONV_BN, the forward conv) or a = g_h2 and
// the negated taps (A_CONV_NEG, its data gradient). The block copies the rows
// its taps reach (its own 128 and W + 1 on either side) into shared memory
// once, applies BN + ReLU to them in place once, and then reads every tap's A
// operand from that tile with ldmatrix at the tap's row offset, into
// registers: a shifted view cannot be a shared-memory wgmma operand (the
// swizzle is bound to 8-row groups), a register operand can. A tap that
// crosses an image edge zeroes the fragment's row (activation space). B
// tiles come through a cp.async ring as in gemm_tc_k; the fragments of two
// slabs alternate, so one product runs while the next is prepared. Grid:
// (ceil(M / 128), N / NT); dynamic shared memory from conv_smem().
template <int NT>
struct Cv {
  static constexpr int B_BYTES = NT * 128;
  static constexpr int DEPTH = 4;
  static constexpr int RING = DEPTH * B_BYTES;
};
__host__ __device__ inline int conv_halo_bytes(int W, int C) {
  return ((BM + 2 * W + 2) * (C * 2 + 16) + 1023) / 1024 * 1024;
}
template <int NT>
int conv_smem(int W, int C) {
  return 1024 + Cv<NT>::RING + conv_halo_bytes(W, C) + (int)sizeof(BNSmem) +
         EpiGeom<NT>::RED * 4;
}

template <int NT, int AMODE, int EMODE>
__global__ void __launch_bounds__(THREADS, 1)
conv_tc_k(const __grid_constant__ GemmArgs<bf16> g) {
  constexpr int SGN = AMODE == A_CONV_NEG ? -1 : 1;
  using C = Cv<NT>;
  constexpr int D = C::DEPTH;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  const ALoad<bf16>& a = g.a;
  const int W = a.W, H = a.H, Cc = a.C, M = g.M;
  const int hs = Cc * 2 + 16;          // bytes per halo row (padded)
  const int hrows = BM + 2 * W + 2;
  unsigned char* halo = ring + C::RING;
  unsigned char* after = halo + conv_halo_bytes(W, Cc);
  BNSmem& bn = *reinterpret_cast<BNSmem*>(after);
  float* red = reinterpret_cast<float*>(after + sizeof(BNSmem));
  float* stg = reinterpret_cast<float*>(ring);  // reuses ring + halo

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * NT;
  const int wgid = tid >> 7, warp = (tid & 127) >> 5, lane = tid & 31;
  const int frow = wgid * 64 + warp * 16 + (lane >> 2), fcol = 2 * (lane & 3);
  const int slabs = g.K / 64, per_tap = Cc / 64;
  stage_bn<AMODE>(a, bn);

  // The halo tile: row h holds source row m0 - W - 1 + h, raw.
  const int cpr = Cc / 8;  // chunks per row; divides the thread count
  const int q0 = m0 - W - 1;
  const uint32_t halo_s = (uint32_t)__cvta_generic_to_shared(halo);
  for (int idx = tid; idx < hrows * cpr; idx += THREADS) {
    int h = idx / cpr, j = idx - h * cpr;
    int q = q0 + h;
    if (q >= 0 && q < M) {
      cp16(halo_s + h * hs + j * 16, a.src + (size_t)q * Cc + j * 8);
    } else {
      *reinterpret_cast<uint4*>(halo + h * hs + j * 16) =
          make_uint4(0, 0, 0, 0);
    }
  }
  cp_commit();
  auto fetch = [&](int s) {
    if (s < slabs)
      copy_b_tile<NT>(g.b, s * 64, n0, ring + (s % D) * C::B_BYTES);
    cp_commit();
  };
#pragma unroll
  for (int s = 0; s < D - 2; ++s) fetch(s);
  cp_wait<D - 2>();  // the halo copies of this thread
  if (AMODE == A_CONV_BN) {
    const int j = tid % cpr;  // the same for every chunk of this thread
    float m[8], rs[8], gg[8], b[8];
    load8(bn.m + 8 * j, m);
    load8(bn.rs + 8 * j, rs);
    load8(bn.g + 8 * j, gg);
    load8(bn.b + 8 * j, b);
    for (int idx = tid; idx < hrows * cpr; idx += THREADS) {
      int h = idx / cpr;
      int q = q0 + h;
      if (q < 0 || q >= M) continue;
      uint4* p = reinterpret_cast<uint4*>(halo + h * hs + j * 16);
      float v[8];
      load8(reinterpret_cast<const bf16*>(p), v);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = fmaxf(bn_y(v[e], m[e], rs[e], gg[e], b[e]), 0.0f);
      *p = pack8(v);
    }
  }

  // This lane's ldmatrix row (tap (0, 0)) and the tap masks of the two rows
  // of its fragment: bit t set when the tap has a source row.
  const int lrow = wgid * 64 + warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const uint32_t a_base = halo_s + (lrow + W + 1) * hs + (lane >> 4) * 16;
  uint32_t mask[2] = {0, 0};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    int row = m0 + frow + 8 * r;
    int x = row % W, y = (row / W) % H;
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      int yy = y + SGN * (t / 3 - 1), xx = x + SGN * (t % 3 - 1);
      if (row < M && (unsigned)yy < (unsigned)H && (unsigned)xx < (unsigned)W)
        mask[r] |= 1u << t;
    }
  }

  float acc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0.0f;
  // One slab: its B tile published, its A fragments read and masked, its
  // product started; then the product before it is waited for, which frees
  // the other set of fragments and, after the next barrier, its B stage.
  auto step = [&](int s, uint32_t (&af)[4][4]) {
    const unsigned char* bt = ring + (s % D) * C::B_BYTES;
    const int t = s / per_tap, c0 = (s - t * per_tap) * 64;
    cp_wait<D - 3>();
    wg::fence_async_shared();
    __syncthreads();  // B tile s (and, at s = 0, the halo) is whole
    fetch(s + D - 2);
    const uint32_t a_tap =
        a_base + SGN * ((t / 3 - 1) * W + (t % 3 - 1)) * hs + c0 * 2;
    const bool ok0 = (mask[0] >> t) & 1, ok1 = (mask[1] >> t) & 1;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wg::ldmatrix_x4(af[kk], a_tap + kk * 32);
      if (!ok0) af[kk][0] = af[kk][2] = 0;
      if (!ok1) af[kk][1] = af[kk][3] = 0;
    }
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wg::MmaRS<NT, 0>::run(acc, af[kk], wg::desc(bt + kk * 32, 16, 1024),
                            (s | kk) != 0);
    wg::commit();
    wg::wait<1>();
  };
  uint32_t af0[4][4], af1[4][4];
  int s = 0;
  for (; s + 1 < slabs; s += 2) {
    step(s, af0);
    step(s + 1, af1);
  }
  if (s < slabs) step(s, af0);
  wg::wait<0>();
  cp_wait<0>();
  __syncthreads();
  constexpr int LDS = NT + 8;
#pragma unroll
  for (int j = 0; j < NT / 8; ++j) {
    int col = 8 * j + fcol;
    *reinterpret_cast<float2*>(stg + frow * LDS + col) =
        make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(stg + (frow + 8) * LDS + col) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  __syncthreads();
  epilogue<bf16, NT, EMODE, false>(g.ep, M, g.N, m0, n0, stg, nullptr, red);
}

// ---- weight gradient: part[z] = A[rows of split z]^T @ G[rows of split z] -
// Grid: (K / 64, N / (64 * NB), splits), one warpgroup. The rows are the
// reduction dimension, so both tiles are stored as they lie in memory (a
// row's channels contiguous) and handed to wgmma transposed. bpart, when
// given, receives the split's column sums of G (from the blocks of the
// first K tile) as [split][N].
constexpr int WROWS = 64;  // rows per chunk

template <int NB>
struct Wg {
  static constexpr int STAGE = (1 + NB) * 8192;
  static constexpr int DEPTH = 4;
  static constexpr int smem() {
    return 1024 + DEPTH * STAGE + (int)sizeof(BNSmem);
  }
};

template <int NB, int AMODE>
__global__ void __launch_bounds__(128)
wgrad_tc_k(const __grid_constant__ ALoad<bf16> a, const bf16* __restrict__ G,
           int M, int K, int N, int rows_per_split, float* __restrict__ part,
           float* __restrict__ bpart) {
  using C = Wg<NB>;
  constexpr int D = C::DEPTH;
  constexpr bool CONV = AMODE == A_CONV_BN;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  BNSmem& bn = *reinterpret_cast<BNSmem*>(ring + D * C::STAGE);
  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * 64, n0 = blockIdx.y * 64 * NB;
  const int r0 = blockIdx.z * rows_per_split;
  const int r1 = min(M, r0 + rows_per_split);
  const int chunks = (r1 - r0 + WROWS - 1) / WROWS;
  const bool sums = bpart != nullptr && blockIdx.x == 0;
  stage_bn<AMODE>(a, bn);

  // pack_yx of the four rows this thread copies of the chunk from row r on.
  auto geom = [&](int r, int* yx) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      yx[i] = CONV ? pack_yx(r + (tid >> 3) + i * 16, a.H, a.W) : 0;
  };
  auto fetch = [&](int ch) {
    if (ch < chunks) {
      unsigned char* st = ring + (ch % D) * C::STAGE;
      const int r = r0 + ch * WROWS;
      int yx[4];
      geom(r, yx);
      copy_a_tile<AMODE, WROWS, 128>(a, r1, r, yx, k0, st);
      const uint32_t dst0 = (uint32_t)__cvta_generic_to_shared(st + 8192);
#pragma unroll
      for (int i = 0; i < NB * 4; ++i) {
        int q = tid + i * 128;
        int row = q / (NB * 8), jj = q % (NB * 8);
        uint32_t off = (jj >> 3) * 8192 + swz(row, jj & 7);
        if (r + row < r1) {
          cp16(dst0 + off, G + (size_t)(r + row) * N + n0 + jj * 8);
        } else {
          *reinterpret_cast<uint4*>(st + 8192 + off) = make_uint4(0, 0, 0, 0);
        }
      }
    }
    cp_commit();
  };

  float acc[NB][32];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[b][i] = 0.0f;
  float colsum = 0.0f;

#pragma unroll
  for (int s = 0; s < D - 2; ++s) fetch(s);
  for (int s = 0; s < chunks; ++s) {
    unsigned char* st = ring + (s % D) * C::STAGE;
    cp_wait<D - 3>();
    {
      int yx[4];
      geom(r0 + s * WROWS, yx);
      transform_a_tile<AMODE, WROWS, 128>(a, bn, r1, r0 + s * WROWS, yx, k0,
                                          st);
    }
    wg::fence_async_shared();
    __syncthreads();
    fetch(s + D - 2);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint64_t da = wg::desc(st + kk * 2048, 8192, 1024);
#pragma unroll
      for (int b = 0; b < NB; ++b)
        wg::Mma<64, 1, 1>::run(
            acc[b], da, wg::desc(st + 8192 + b * 8192 + kk * 2048, 8192, 1024),
            (s | kk) != 0);
    }
    wg::commit();
    if (sums && tid < 64 * NB) {
      const unsigned char* gt = st + 8192 + (tid >> 6) * 8192;
      const int cc = tid & 63;
      for (int row = 0; row < WROWS; ++row)
        colsum += __bfloat162float(*reinterpret_cast<const bf16*>(
            gt + swz(row, cc >> 3) + (cc & 7) * 2));
    }
    wg::wait<1>();
  }
  wg::wait<0>();
  cp_wait<0>();

  float* out = part + (size_t)blockIdx.z * K * N;
  const int warp = tid >> 5, lane = tid & 31;
  const int row = k0 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      int col = n0 + b * 64 + 8 * j + 2 * (lane & 3);
      *reinterpret_cast<float2*>(out + (size_t)row * N + col) =
          make_float2(acc[b][4 * j], acc[b][4 * j + 1]);
      *reinterpret_cast<float2*>(out + (size_t)(row + 8) * N + col) =
          make_float2(acc[b][4 * j + 2], acc[b][4 * j + 3]);
    }
  if (sums && tid < 64 * NB) bpart[(size_t)blockIdx.z * N + n0 + tid] = colsum;
}

// ===========================================================================
// f32: SIMT
// ===========================================================================

constexpr int SN = 64, SK = 32;              // column tile, K slab
constexpr int LDA = SK + 4, LDB = SN + 4;    // padded smem rows
constexpr int SLDS = SN + 8;                 // staged accumulator rows

// 4 consecutive elements of row `row`, columns k..k+4 of the effective A
// matrix (zeros for rows >= limit and for masked taps).
template <int MODE>
__device__ __forceinline__ void load_a4(const ALoad<float>& a, const BNSmem& s,
                                        int limit, int row, int k, float* o) {
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
    o[0] = o[1] = o[2] = o[3] = 0.0f;
    return;
  }
  float4 f = *reinterpret_cast<const float4*>(a.src + src_row * a.C + c);
  o[0] = f.x; o[1] = f.y; o[2] = f.z; o[3] = f.w;
  if (MODE == A_BN || MODE == A_CONV_BN) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      o[i] = fmaxf(bn_y(o[i], s.m[c + i], s.rs[c + i], s.g[c + i], s.b[c + i]),
                   0.0f);
  }
}

__device__ __forceinline__ float b_at(const BOp<float>& b, int k, int n) {
  int t = k / b.kper;
  return b.p[((size_t)t * b.N + n) * b.kper + (k - t * b.kper)];
}

// acc[8][4] = A[m0 + tr * 8 .., :K] @ B[:K, n0 + tc * 4 ..]; the next slab's
// global loads sit in registers while the current one is multiplied.
template <int AMODE>
__device__ __forceinline__ void simt_mainloop(const ALoad<float>& a,
                                              const BOp<float>& b, int K, int M,
                                              int m0, int n0, const BNSmem& bn,
                                              float* As, float* Bs,
                                              float (&acc)[8][4]) {
  constexpr int AV = BM * SK / 4 / THREADS, BV = SK * SN / THREADS;
  const int tid = threadIdx.x;
  const int tr = tid >> 4, tc = tid & 15;
  float ra[AV][4], rb[BV];
  auto gload = [&](int k0) {
#pragma unroll
    for (int i = 0; i < AV; ++i) {
      int idx = tid + i * THREADS;
      load_a4<AMODE>(a, bn, M, m0 + idx / (SK / 4), k0 + (idx % (SK / 4)) * 4,
                     ra[i]);
    }
#pragma unroll
    for (int i = 0; i < BV; ++i) {
      int idx = tid + i * THREADS;
      int kr = idx % SK, nn = idx / SK;
      rb[i] = b_at(b, k0 + kr, n0 + nn);
    }
  };
  auto sstore = [&]() {
#pragma unroll
    for (int i = 0; i < AV; ++i) {
      int idx = tid + i * THREADS;
      *reinterpret_cast<float4*>(As + (idx / (SK / 4)) * LDA +
                                 (idx % (SK / 4)) * 4) =
          make_float4(ra[i][0], ra[i][1], ra[i][2], ra[i][3]);
    }
#pragma unroll
    for (int i = 0; i < BV; ++i) {
      int idx = tid + i * THREADS;
      int kr = idx % SK, nn = idx / SK;
      Bs[kr * LDB + nn] = rb[i];
    }
  };
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  const int ktiles = K / SK;
  gload(0);
  for (int kt = 0; kt < ktiles; ++kt) {
    sstore();
    __syncthreads();
    if (kt + 1 < ktiles) gload((kt + 1) * SK);
#pragma unroll 8
    for (int k = 0; k < SK; ++k) {
      float av[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = As[(tr * 8 + i) * LDA + k];
      float4 bv = *reinterpret_cast<const float4*>(Bs + k * LDB + tc * 4);
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
}

constexpr int simt_smem(bool skip) {
  return (BM * LDA + SK * LDB + BM * SLDS * (skip ? 2 : 1) +
          EpiGeom<SN>::RED) * 4 + (int)sizeof(BNSmem);
}

// Grid: (ceil(M / 128), N / 64).
template <int AMODE, int EMODE, bool SKIP>
__global__ void __launch_bounds__(THREADS)
gemm_simt_k(const __grid_constant__ GemmArgs<float> g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* As = reinterpret_cast<float*>(smem_raw);
  float* Bs = As + BM * LDA;
  float* stg = Bs + SK * LDB;
  float* skp = stg + BM * SLDS;
  float* red = skp + (SKIP ? BM * SLDS : 0);
  BNSmem& bn = *reinterpret_cast<BNSmem*>(red + EpiGeom<SN>::RED);
  const int tid = threadIdx.x;
  const int tr = tid >> 4, tc = tid & 15;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * SN;
  stage_bn<AMODE>(g.a, bn);
  float acc[8][4];
  if (SKIP) {
    simt_mainloop<A_PLAIN>(g.a2, g.b2, g.K2, g.M, m0, n0, bn, As, Bs, acc);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        skp[(tr * 8 + i) * SLDS + tc * 4 + j] =
            skip_value<float>(acc[i][j], g.ep.bias2[n0 + tc * 4 + j]);
  }
  simt_mainloop<AMODE>(g.a, g.b, g.K, g.M, m0, n0, bn, As, Bs, acc);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      stg[(tr * 8 + i) * SLDS + tc * 4 + j] = acc[i][j];
  __syncthreads();
  epilogue<float, SN, EMODE, SKIP>(g.ep, g.M, g.N, m0, n0, stg, skp, red);
}

// Weight gradient, f32. Grid: (K / 64, N / 64, splits); 32-row chunks.
constexpr int FR = 32, FLD = 64 + 4;

template <int AMODE>
__global__ void __launch_bounds__(THREADS)
wgrad_simt_k(const __grid_constant__ ALoad<float> a,
             const float* __restrict__ G, int M, int K, int N,
             int rows_per_split, float* __restrict__ part,
             float* __restrict__ bpart) {
  constexpr int V = FR * 64 / 4 / THREADS;
  __shared__ __align__(16) float As[FR * FLD];
  __shared__ __align__(16) float Gs[FR * FLD];
  __shared__ BNSmem bn;
  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * 64, n0 = blockIdx.y * 64;
  const int r0 = blockIdx.z * rows_per_split;
  const int r1 = min(M, r0 + rows_per_split);
  const bool sums = bpart != nullptr && blockIdx.x == 0;
  stage_bn<AMODE>(a, bn);
  const int tk = tid >> 4, tn = tid & 15;  // 4 x 4 each
  float acc[4][4] = {};
  float colsum = 0.0f;
  for (int r = r0; r < r1; r += FR) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      int idx = tid + i * THREADS;
      int rr = idx / 16, cc = (idx % 16) * 4;
      float va[4];
      load_a4<AMODE>(a, bn, r1, r + rr, k0 + cc, va);
      float4 vg = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (r + rr < r1)
        vg = *reinterpret_cast<const float4*>(G + (size_t)(r + rr) * N + n0 +
                                              cc);
      *reinterpret_cast<float4*>(As + rr * FLD + cc) =
          make_float4(va[0], va[1], va[2], va[3]);
      *reinterpret_cast<float4*>(Gs + rr * FLD + cc) = vg;
    }
    __syncthreads();
#pragma unroll 8
    for (int rr = 0; rr < FR; ++rr) {
      float4 av = *reinterpret_cast<const float4*>(As + rr * FLD + tk * 4);
      float4 gv = *reinterpret_cast<const float4*>(Gs + rr * FLD + tn * 4);
      float ai[4] = {av.x, av.y, av.z, av.w};
      float gj[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ai[i], gj[j], acc[i][j]);
    }
    if (sums && tid < 64)
      for (int rr = 0; rr < FR; ++rr) colsum += Gs[rr * FLD + tid];
    __syncthreads();
  }
  float* out = part + (size_t)blockIdx.z * K * N;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[(size_t)(k0 + tk * 4 + i) * N + n0 + tn * 4 + j] = acc[i][j];
  if (sums && tid < 64) bpart[(size_t)blockIdx.z * N + n0 + tid] = colsum;
}

// ===========================================================================
// statistics, finishes, elementwise
// ===========================================================================

// Per tile of BM rows: (mean, M2) of x's columns as part[tile][2][C], two
// passes inside the tile. Grid: (C / 32, tiles); 32 columns x 8 row lanes.
template <typename T>
__global__ void __launch_bounds__(THREADS)
stats_partial_k(const T* __restrict__ x, int M, int C,
                float* __restrict__ part) {
  __shared__ float s[LANES][32];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + tx;
  const int r0 = blockIdx.y * BM, r1 = min(M, r0 + BM);
  float a = 0.0f;
  for (int r = r0 + ty; r < r1; r += LANES) a += to_f(x[(size_t)r * C + c]);
  s[ty][tx] = a;
  __syncthreads();
  float tot = 0.0f;
#pragma unroll
  for (int i = 0; i < LANES; ++i) tot += s[i][tx];
  const float mean = __fdiv_rn(tot, (float)(r1 - r0));
  __syncthreads();
  a = 0.0f;
  for (int r = r0 + ty; r < r1; r += LANES) {
    float d = __fsub_rn(to_f(x[(size_t)r * C + c]), mean);
    a = __fadd_rn(a, __fmul_rn(d, d));
  }
  s[ty][tx] = a;
  __syncthreads();
  if (ty == 0) {
    tot = 0.0f;
#pragma unroll
    for (int i = 0; i < LANES; ++i) tot += s[i][tx];
    float* p = part + (size_t)blockIdx.y * 2 * C;
    p[c] = mean;
    p[C + c] = tot;
  }
}

// Chan's merge of (n, mean, M2) with (nb, mb, m2b).
__device__ __forceinline__ void chan_merge(float& n, float& mean, float& m2,
                                           float nb, float mb, float m2b) {
  if (nb == 0.0f) return;
  float tot = n + nb;
  float d = __fsub_rn(mb, mean);
  float f = __fdiv_rn(nb, tot);
  mean = __fadd_rn(mean, __fmul_rn(d, f));
  m2 = __fadd_rn(__fadd_rn(m2, m2b),
                 __fmul_rn(__fmul_rn(d, d), __fmul_rn(n, f)));
  n = tot;
}

// r = omf * r + f * batch for the mean and the variance unbiased by
// `unbias`, and one more batch on *count (by one thread).
__device__ __forceinline__ void update_running(int c, float mean, float var,
                                               float* run_mean, float* run_var,
                                               long long* count, float omf,
                                               float f, float unbias) {
  run_mean[c] = __fadd_rn(__fmul_rn(omf, run_mean[c]), __fmul_rn(f, mean));
  run_var[c] = __fadd_rn(__fmul_rn(omf, run_var[c]),
                         __fmul_rn(f, __fmul_rn(var, unbias)));
  if (count && c == 0) *count += 1;
}

// Merges the tiles' (mean, M2) in a fixed order (32 groups of consecutive
// tiles, each merged in order, then the groups in order) into the batch mean
// and biased variance; with run_mean given, also updates the running
// statistics in place (update_running). With xch given (a rank's share of
// a staged call) writes the rank's row instead: xch[c] = mean, xch[C + c] =
// M2, xch[2 C] = the row count, for rank_merge_k. Grid: C / 32.
__global__ void __launch_bounds__(FIN_THREADS)
stats_finish_k(const float* __restrict__ part, int tiles, int M, int C,
               float* mean_out, float* var_out, float* run_mean,
               float* run_var, long long* count, float omf, float f,
               float unbias, float* xch) {
  __shared__ float sn[GROUPS][32], sm[GROUPS][32], s2[GROUPS][32];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + tx;
  const int per = (tiles + GROUPS - 1) / GROUPS;
  const int t1 = min(tiles, (ty + 1) * per);
  float n = 0.0f, mean = 0.0f, m2 = 0.0f;
  for (int t = ty * per; t < t1; ++t) {
    const float* p = part + (size_t)t * 2 * C;
    chan_merge(n, mean, m2, (float)min(BM, M - t * BM), p[c], p[C + c]);
  }
  sn[ty][tx] = n;
  sm[ty][tx] = mean;
  s2[ty][tx] = m2;
  __syncthreads();
  if (ty != 0) return;
  for (int i = 1; i < GROUPS; ++i)
    chan_merge(n, mean, m2, sn[i][tx], sm[i][tx], s2[i][tx]);
  if (xch) {
    xch[c] = mean;
    xch[C + c] = m2;
    if (c == 0) xch[2 * C] = n;
    return;
  }
  float var = __fdiv_rn(m2, (float)M);
  mean_out[c] = mean;
  var_out[c] = var;
  if (run_mean)
    update_running(c, mean, var, run_mean, run_var, count, omf, f, unbias);
}

// A staged call's BN statistics over the data group: the ranks' rows of
// stats_finish_k (gath[r * stride ...], in rank order) merged by Chan's
// formula in that order, the same bits on every rank, into the global mean
// and biased variance; the running statistics as stats_finish_k. The merge
// starts from the first rank that holds rows (a rank of none sends a row of
// count 0, which chan_merge skips). With one rank the result is that rank's
// finish, bit for bit. Grid: C / 32 x 32.
__global__ void rank_merge_k(const float* __restrict__ gath, int world,
                             int stride, int C, float* mean_out,
                             float* var_out, float* run_mean, float* run_var,
                             long long* count, float omf, float f,
                             float unbias) {
  const int c = blockIdx.x * 32 + threadIdx.x;
  int r0 = 0;
  while (r0 + 1 < world && gath[(size_t)r0 * stride + 2 * C] == 0.0f) ++r0;
  const float* p0 = gath + (size_t)r0 * stride;
  float n = p0[2 * C], mean = p0[c], m2 = p0[C + c];
  for (int r = r0 + 1; r < world; ++r) {
    const float* p = gath + (size_t)r * stride;
    chan_merge(n, mean, m2, p[2 * C], p[c], p[C + c]);
  }
  float var = __fdiv_rn(m2, n);
  mean_out[c] = mean;
  var_out[c] = var;
  if (run_mean)
    update_running(c, mean, var, run_mean, run_var, count, omf, f, unbias);
}

// o1[c], o2[c] = the sums over tiles of part[tile][0][c], part[tile][1][c],
// in the same fixed order; with xch given also xch[c], xch[C + c] (a rank's
// row of a staged backward). Grid: C / 32.
__global__ void __launch_bounds__(FIN_THREADS)
pair_finish_k(const float* __restrict__ part, int tiles, int C, float* o1,
              float* o2, float* xch) {
  __shared__ float s1[GROUPS][32], s2[GROUPS][32];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + tx;
  const int per = (tiles + GROUPS - 1) / GROUPS;
  const int t1 = min(tiles, (ty + 1) * per);
  float a = 0.0f, b = 0.0f;
  for (int t = ty * per; t < t1; ++t) {
    const float* p = part + (size_t)t * 2 * C;
    a += p[c];
    b += p[C + c];
  }
  s1[ty][tx] = a;
  s2[ty][tx] = b;
  __syncthreads();
  if (ty != 0) return;
  for (int i = 1; i < GROUPS; ++i) {
    a += s1[i][tx];
    b += s2[i][tx];
  }
  o1[c] = a;
  o2[c] = b;
  if (xch) {
    xch[c] = a;
    xch[C + c] = b;
  }
}

// The ranks' rows of pair_finish_k summed in rank order (from rank 0's own
// value, so one rank gives its row's bits): o1[c] = sum_r gath[r][c], o2[c]
// = sum_r gath[r][C + c]. Grid: C / 32 x 32.
__global__ void rank_sum_k(const float* __restrict__ gath, int world,
                           int stride, int C, float* o1, float* o2) {
  const int c = blockIdx.x * 32 + threadIdx.x;
  float a = gath[c], b = gath[C + c];
  for (int r = 1; r < world; ++r) {
    a = __fadd_rn(a, gath[(size_t)r * stride + c]);
    b = __fadd_rn(b, gath[(size_t)r * stride + C + c]);
  }
  o1[c] = a;
  o2[c] = b;
}

// The split reductions of a backward, finished in one launch: segment s of
// `size` = K * N elements, out (k, n) = sum over p in order of
// part[p][k][n], written at out[(k / kper) * st + (k % kper) * sk + n * sn]
// (the parameter's own layout). Grid: (blocks, segments).
struct Seg {
  const float* part;
  float* out;
  int nparts, size, N, kper;
  long st, sk, sn;
};
struct Segs {
  Seg s[8];
};

__global__ void finish_grads_k(const __grid_constant__ Segs segs) {
  const Seg& g = segs.s[blockIdx.y];
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < g.size;
       i += gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int p = 0; p < g.nparts; ++p) s += g.part[(size_t)p * g.size + i];
    int k = i / g.N, n = i - k * g.N;
    int t = k / g.kper;
    g.out[t * g.st + (long)(k - t * g.kper) * g.sk + n * g.sn] = s;
  }
}

// Packs weights for the GEMMs: segment s is a logical (K, N) matrix read from
// an f32 weight where PyTorch keeps it, element (k, n) at src[(k / kper) * st
// + (k % kper) * sk + n * sn] (any strides: a transposed view costs
// nothing), rounded to T and written with K contiguous as BOp reads it.
// Grid: (blocks, segments).
struct PackSeg {
  const float* src;
  void* dst;
  long st, sk, sn;
  int kper, K, N;
};
struct PackSegs {
  PackSeg s[6];
};

template <typename T>
__global__ void pack_k(const __grid_constant__ PackSegs segs) {
  const PackSeg& g = segs.s[blockIdx.y];
  T* dst = static_cast<T*>(g.dst);
  const int total = g.K * g.N;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    int kk = i % g.kper, rest = i / g.kper;
    int n = rest % g.N, t = rest / g.N;
    dst[i] = from_f<T>(g.src[t * g.st + (long)kk * g.sk + (long)n * g.sn]);
  }
}

// BN backward, elementwise:
// out = rnd((rs / n) * (n * gy' * g - g * dbe - hhat * (g * dg)) [+ addf]
//           [+ addt]), gy' = gy rounded to T when round_gy.
template <typename T>
__global__ void bn_bwd_k(const float* __restrict__ gy, const T* __restrict__ h,
                         const float* m, const float* v, const float* g,
                         const float* dg, const float* dbe, int round_gy,
                         const float* __restrict__ addf,
                         const T* __restrict__ addt, T* __restrict__ out,
                         size_t total, int C, float nf) {
  size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 8;
  if (i >= total) return;
  const int c = (int)(i % C);  // 8 columns of one row: C is a multiple of 8
  float gv[8], hv[8], af[8], at[8], mm[8], vv[8], gg[8], dgv[8], dbv[8], r[8];
  load8(gy + i, gv);
  load8(h + i, hv);
  if (addf) load8(addf + i, af);
  if (addt) load8(addt + i, at);
  load8(m + c, mm);
  load8(v + c, vv);
  load8(g + c, gg);
  load8(dg + c, dgv);
  load8(dbe + c, dbv);
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    float rs = rsqrt_eps(vv[q]);
    float hh = __fmul_rn(__fsub_rn(hv[q], mm[q]), rs);
    float gq = round_gy ? rnd<T>(gv[q]) : gv[q];
    float ghat = __fmul_rn(gq, gg[q]);
    float t = __fsub_rn(
        __fsub_rn(__fmul_rn(nf, ghat), __fmul_rn(gg[q], dbv[q])),
        __fmul_rn(hh, __fmul_rn(gg[q], dgv[q])));
    float o = __fmul_rn(__fdiv_rn(rs, nf), t);
    if (addf) o = __fadd_rn(o, af[q]);
    if (addt) o = __fadd_rn(o, at[q]);
    r[q] = rnd<T>(o);
  }
  store8(out + i, r);
}

// ===========================================================================
// host side
// ===========================================================================

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

// A weight as PyTorch keeps it: logical (taps, in, out) at strides (st, si,
// so), taps = 1 for a 1x1 kernel.
struct Weight {
  const float* p;
  long st, si, so;
};

// Collects the weights a call multiplies by and packs them in one launch.
template <typename T>
struct Packer {
  PackSegs segs = {};
  int n = 0;
  // B = W (in -> out), per tap; dst holds taps * cin * cout elements.
  BOp<T> fwd(const Weight& w, int taps, int cin, int cout, T* dst) {
    segs.s[n++] = PackSeg{w.p, dst, w.st, w.si, w.so, cin, taps * cin, cout};
    return BOp<T>{dst, cin, cout};
  }
  // B = W^T (out -> in), per tap.
  BOp<T> bwd(const Weight& w, int taps, int cin, int cout, T* dst) {
    segs.s[n++] = PackSeg{w.p, dst, w.st, w.so, w.si, cout, taps * cout, cin};
    return BOp<T>{dst, cout, cin};
  }
  void run(cudaStream_t s) {
    pack_k<T><<<dim3(128, n), 256, 0, s>>>(segs);
  }
};

template <typename T>
Epi<T> bias_epi(const float* bias, const void* resid, void* out,
                float* stat_part, const float* bias2 = nullptr) {
  Epi<T> e = {};
  e.bias = bias;
  e.bias2 = bias2;
  e.resid = static_cast<const T*>(resid);
  e.out_t = static_cast<T*>(out);
  e.stat_part = stat_part;
  return e;
}

template <typename T>
Epi<T> gate_epi(const void* h, const float* m, const float* v, const float* g,
                const float* b, float* out, float* red_part) {
  Epi<T> e = {};
  e.gate_h = static_cast<const T*>(h);
  e.gm = m;
  e.gv = v;
  e.gg = g;
  e.gb = b;
  e.out_f = out;
  e.red_part = red_part;
  return e;
}

inline int tiles_of(int M) { return (M + BM - 1) / BM; }

// The first error of a one-time kernel set-up; the C entries return it.
inline cudaError_t& setup_error() {
  static cudaError_t e = cudaSuccess;
  return e;
}

template <typename K>
void allow_smem(K kernel, int bytes) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess && setup_error() == cudaSuccess) setup_error() = e;
}

// The last launch error of this thread, or else a failed set-up.
inline int call_status() {
  cudaError_t e = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : setup_error());
}

template <int NT, int AMODE, int EMODE, bool SKIP>
void launch_tc(const GemmArgs<bf16>& g, cudaStream_t s) {
  constexpr int smem = Tc<NT, SKIP>::smem();
  static bool once = (allow_smem(gemm_tc_k<NT, AMODE, EMODE, SKIP>, smem),
                      true);
  (void)once;
  gemm_tc_k<NT, AMODE, EMODE, SKIP>
      <<<dim3(tiles_of(g.M), g.N / NT), THREADS, smem, s>>>(g);
}

constexpr int MAX_SMEM = 227 * 1024;  // dynamic shared memory of one block

template <int NT, int AMODE, int EMODE>
void launch_conv(const GemmArgs<bf16>& g, cudaStream_t s) {
  static bool once = (allow_smem(conv_tc_k<NT, AMODE, EMODE>, MAX_SMEM),
                      true);
  (void)once;
  conv_tc_k<NT, AMODE, EMODE><<<dim3(tiles_of(g.M), g.N / NT), THREADS,
                                conv_smem<NT>(g.a.W, g.a.C), s>>>(g);
}

// Column tile of a bf16 GEMM: fewer than 64 row tiles leave most of the 132
// SMs idle, so the columns are split.
inline int column_tile(int M, int N) { return tiles_of(M) >= 64 ? N : 64; }

// Whether the bf16 3x3's haloed tile of a (M rows, width W, Ch channels)
// activation fits in a block's shared memory.
inline bool conv_fits(int M, int W, int ch) {
  int need = column_tile(M, ch) == 128 ? conv_smem<128>(W, ch)
                                       : conv_smem<64>(W, ch);
  return need <= MAX_SMEM;
}

template <int AMODE, int EMODE, bool SKIP>
void launch_gemm(const GemmArgs<bf16>& g, cudaStream_t s) {
  const int nt = column_tile(g.M, g.N);
  if constexpr (AMODE == A_CONV_BN || AMODE == A_CONV_NEG) {  // N = Ch <= 128
    if (nt == 128) {
      launch_conv<128, AMODE, EMODE>(g, s);
    } else {
      launch_conv<64, AMODE, EMODE>(g, s);
    }
  } else if (nt == 256) {
    launch_tc<256, AMODE, EMODE, SKIP>(g, s);
  } else if (nt == 128) {
    launch_tc<128, AMODE, EMODE, SKIP>(g, s);
  } else {
    launch_tc<64, AMODE, EMODE, SKIP>(g, s);
  }
}

template <int AMODE, int EMODE, bool SKIP>
void launch_gemm(const GemmArgs<float>& g, cudaStream_t s) {
  static bool once = (allow_smem(gemm_simt_k<AMODE, EMODE, SKIP>,
                                 simt_smem(SKIP)), true);
  (void)once;
  gemm_simt_k<AMODE, EMODE, SKIP>
      <<<dim3(tiles_of(g.M), g.N / SN), THREADS, simt_smem(SKIP), s>>>(g);
}

// out = epilogue(A @ B) [+ the skip product a2 @ b2 when given].
template <typename T, int AMODE, int EMODE>
void gemm(const ALoad<T>& a, const BOp<T>& b, int M, int N, int K,
          const Epi<T>& ep, cudaStream_t s, const ALoad<T>* a2 = nullptr,
          const BOp<T>* b2 = nullptr, int K2 = 0) {
  GemmArgs<T> g = {};
  g.a = a;
  g.b = b;
  g.M = M;
  g.N = N;
  g.K = K;
  g.ep = ep;
  if constexpr (EMODE == E_BIAS && AMODE == A_BN) {
    if (a2) {
      g.a2 = *a2;
      g.b2 = *b2;
      g.K2 = K2;
      launch_gemm<AMODE, EMODE, true>(g, s);
      return;
    }
  }
  launch_gemm<AMODE, EMODE, false>(g, s);
}

// (splits, rows per split) of a weight gradient over M rows whose output
// has `otiles` tiles: about two waves of blocks, at most 32 splits, each a
// multiple of 64 rows.
inline void wgrad_split(int M, int otiles, int* splits, int* rps) {
  if (M <= 0) {  // no rows: no partial, the gradient is zero
    *splits = 0;
    *rps = 64;
    return;
  }
  int want = (2 * 132 + otiles - 1) / otiles;
  if (want > 32) want = 32;
  if (want < 1) want = 1;
  int r = (M + want - 1) / want;
  r = (r + 63) / 64 * 64;
  *rps = r;
  *splits = (M + r - 1) / r;
}
inline int wgrad_tiles(bool is_bf16, int K, int N) {
  int ncols = (is_bf16 && N % 128 == 0) ? 128 : 64;
  return (K / 64) * (N / ncols);
}

template <int NB, int AMODE>
void launch_wgrad_tc(const ALoad<bf16>& a, const void* G, int M, int K, int N,
                     int splits, int rps, float* part, float* bpart,
                     cudaStream_t s) {
  static bool once = (allow_smem(wgrad_tc_k<NB, AMODE>, Wg<NB>::smem()), true);
  (void)once;
  wgrad_tc_k<NB, AMODE>
      <<<dim3(K / 64, N / (64 * NB), splits), 128, Wg<NB>::smem(), s>>>(
          a, static_cast<const bf16*>(G), M, K, N, rps, part, bpart);
}

// part[split] = A^T @ G over the split's rows; returns the split count.
template <int AMODE>
int wgrad(const ALoad<bf16>& a, const void* G, int M, int K, int N,
          float* part, float* bpart, cudaStream_t s) {
  int splits, rps;
  wgrad_split(M, wgrad_tiles(true, K, N), &splits, &rps);
  if (N % 128 == 0) {
    launch_wgrad_tc<2, AMODE>(a, G, M, K, N, splits, rps, part, bpart, s);
  } else {
    launch_wgrad_tc<1, AMODE>(a, G, M, K, N, splits, rps, part, bpart, s);
  }
  return splits;
}
template <int AMODE>
int wgrad(const ALoad<float>& a, const void* G, int M, int K, int N,
          float* part, float* bpart, cudaStream_t s) {
  int splits, rps;
  wgrad_split(M, wgrad_tiles(false, K, N), &splits, &rps);
  wgrad_simt_k<AMODE><<<dim3(K / 64, N / 64, splits), THREADS, 0, s>>>(
      a, static_cast<const float*>(G), M, K, N, rps, part, bpart);
  return splits;
}

template <typename T>
void bnbwd(const float* gy, const void* h, int M, int C, const float* m,
           const float* v, const float* g, const float* dg, const float* dbe,
           int round_gy, const float* addf, const void* addt, void* out,
           float nf, cudaStream_t s) {
  size_t total = (size_t)M * C;
  bn_bwd_k<T><<<(unsigned)((total / 8 + 255) / 256), 256, 0, s>>>(
      gy, static_cast<const T*>(h), m, v, g, dg, dbe, round_gy, addf,
      static_cast<const T*>(addt), static_cast<T*>(out), total, C, nf);
}

// Scratch: a bump allocator over the caller's buffer, 256-byte aligned.
struct Bump {
  char* p;
  size_t used = 0;
  template <typename U> U* take(size_t count) {
    size_t bytes = (count * sizeof(U) + 255) / 256 * 256;
    U* r = p ? reinterpret_cast<U*>(p + used) : nullptr;
    used += bytes;
    return r;
  }
};

struct Running {  // null pointers: leave the running statistics alone
  float *mean[3], *var[3];
  long long* count[3];
  float omf, f, unbias;
};

struct Shape {
  int B, H, W, ci, ch, co;
  int M() const { return B * H * W; }
};

// A staged call: one of the four stages of a train forward or a backward
// whose BN reductions span a data group. Each of stages 0-2 ends by writing
// this rank's row of one BN reduction to xch; the caller gathers every
// rank's row into gath (rank order, `stride` floats apart) and the next
// stage starts by merging them (forward: Chan's merge of (mean, M2, count),
// rank_merge_k; backward: the sums, rank_sum_k). Everything a stage leaves
// for the next stays in the call's scratch. which = -1 is the whole call in
// one entry, as before. A rank of no rows (M = 0) launches no GEMM: its
// stages write rows of count 0 (forward) or of zeros (backward) and take
// part in every merge, and its parameter gradients are zero.
struct Stage {
  int which = -1;
  float* xch = nullptr;
  const float* gath = nullptr;
  int world = 1, stride = 0;
  float n_global = 0.0f;  // rows of the global batch (backward)
  bool now(int k) const { return which < 0 || which == k; }
};

struct FwdParams {
  Weight w1, w2, w3, skw;  // skw.p null for the identity skip
  const float *b1, *b2, *b3, *skb;
  const float *g1, *be1, *g2, *be2, *g3, *be3;
};

// ---- the forward (K3) -----------------------------------------------------

// With scratch null only sizes the scratch.
template <typename T>
size_t forward(bool train, const Shape& sh, const void* x, const FwdParams& p,
               float* const* st, const Running& run, void* out, char* scratch,
               cudaStream_t s, const Stage& stg = Stage{}) {
  const int M = sh.M(), ci = sh.ci, ch = sh.ch, co = sh.co;
  const int tiles = tiles_of(M);
  Bump mem{scratch};
  T* h1 = mem.take<T>((size_t)M * ch);
  T* h2 = mem.take<T>((size_t)M * ch);
  float* part =
      train ? mem.take<float>((size_t)tiles * 2 * max(ci, ch)) : nullptr;
  T* k1 = mem.take<T>(ci * ch);
  T* k2 = mem.take<T>(9 * ch * ch);
  T* k3 = mem.take<T>(ch * co);
  T* ksk = mem.take<T>(ci * co);
  if (!scratch) return mem.used;
  const bool has_rows = M > 0;
  Packer<T> pack;
  BOp<T> w1 = pack.fwd(p.w1, 1, ci, ch, k1);
  BOp<T> w2 = pack.fwd(p.w2, 9, ch, ch, k2);
  BOp<T> w3 = pack.fwd(p.w3, 1, ch, co, k3);
  BOp<T> wsk = p.skw.p ? pack.fwd(p.skw, 1, ci, co, ksk) : BOp<T>{};
  if (stg.now(0) && has_rows) pack.run(s);
  float *m1 = st[0], *v1 = st[1], *m2 = st[2], *v2 = st[3], *m3 = st[4],
        *v3 = st[5];
  // BN i's statistics from the partials of its input: finished here, or,
  // staged, this rank's row at the end of stage i and the ranks' merge at
  // the start of stage i + 1.
  auto finish = [&](int i, int C) {
    if (!train) return;
    const bool staged = stg.which >= 0;
    if (stg.now(i))
      stats_finish_k<<<C / 32, FIN_THREADS, 0, s>>>(
          part, tiles, M, C, st[2 * i], st[2 * i + 1], run.mean[i],
          run.var[i], run.count[i], run.omf, run.f, run.unbias,
          staged ? stg.xch : nullptr);
    if (staged && stg.which == i + 1)
      rank_merge_k<<<C / 32, 32, 0, s>>>(
          stg.gath, stg.world, stg.stride, C, st[2 * i], st[2 * i + 1],
          run.mean[i], run.var[i], run.count[i], run.omf, run.f, run.unbias);
  };
  if (train && stg.now(0) && has_rows)
    stats_partial_k<T><<<dim3(ci / 32, tiles), THREADS, 0, s>>>(
        static_cast<const T*>(x), M, ci, part);
  finish(0, ci);
  if (stg.now(1) && has_rows)
    gemm<T, A_BN, E_BIAS>(rows<T>(x, ci, sh.H, sh.W, m1, v1, p.g1, p.be1), w1,
                          M, ch, ci, bias_epi<T>(p.b1, nullptr, h1, part), s);
  finish(1, ch);
  if (stg.now(2) && has_rows)
    gemm<T, A_CONV_BN, E_BIAS>(
        rows<T>(h1, ch, sh.H, sh.W, m2, v2, p.g2, p.be2), w2, M, ch, 9 * ch,
        bias_epi<T>(p.b2, nullptr, h2, part), s);
  finish(2, ch);
  if (!stg.now(3) || !has_rows) return mem.used;
  ALoad<T> a3 = rows<T>(h2, ch, sh.H, sh.W, m3, v3, p.g3, p.be3);
  if (p.skw.p) {
    ALoad<T> ax = rows<T>(x, ci);
    gemm<T, A_BN, E_BIAS>(a3, w3, M, co, ch,
                          bias_epi<T>(p.b3, nullptr, out, nullptr, p.skb), s,
                          &ax, &wsk, ci);
  } else {
    gemm<T, A_BN, E_BIAS>(a3, w3, M, co, ch,
                          bias_epi<T>(p.b3, x, out, nullptr), s);
  }
  return mem.used;
}

// ---- the backward (K4), in the TPU kernel's pass order p5 ... p11 ---------

struct Grads {
  Weight w1, w2, w3, skw;  // written in these layouts (non-const use)
  float *b1, *b2, *b3, *skb;
  float *g1, *be1, *g2, *be2, *g3, *be3;
};

template <typename T>
size_t backward(const Shape& sh, const void* x, const void* gout,
                const FwdParams& p, const float* const* st, void* gx,
                const Grads& d, char* scratch, cudaStream_t s,
                const Stage& stg = Stage{}) {
  constexpr bool BF = sizeof(T) == 2;
  const int M = sh.M(), ci = sh.ci, ch = sh.ch, co = sh.co;
  const int tiles = tiles_of(M);
  const bool skip = p.skw.p != nullptr;
  auto nsplits = [&](int K, int N) {
    int splits, rps;
    wgrad_split(M, wgrad_tiles(BF, K, N), &splits, &rps);
    return splits;
  };
  auto psize = [&](int K, int N) { return (size_t)nsplits(K, N) * K * N; };
  Bump mem{scratch};
  T* h1 = mem.take<T>((size_t)M * ch);
  T* h2 = mem.take<T>((size_t)M * ch);
  T* gh2 = mem.take<T>((size_t)M * ch);
  T* gh1 = mem.take<T>((size_t)M * ch);
  float* gyc = mem.take<float>((size_t)M * ch);
  float* gy1 = mem.take<float>((size_t)M * ci);
  float* skd = skip ? mem.take<float>((size_t)M * ci) : nullptr;
  float* red = mem.take<float>((size_t)tiles * 2 * max(ci, ch));
  float* pw1 = mem.take<float>(psize(ci, ch));
  float* pw2 = mem.take<float>(psize(9 * ch, ch));
  float* pw3 = mem.take<float>(psize(ch, co));
  float* psk = skip ? mem.take<float>(psize(ci, co)) : nullptr;
  float* pb1 = mem.take<float>(32 * ch);
  float* pb2 = mem.take<float>(32 * ch);
  float* pb3 = mem.take<float>(32 * co);
  float* gsum = mem.take<float>(2 * max(ci, ch));
  T* k1 = mem.take<T>(ci * ch);
  T* k2 = mem.take<T>(9 * ch * ch);
  T* k1t = mem.take<T>(ci * ch);
  T* k2t = mem.take<T>(9 * ch * ch);
  T* k3t = mem.take<T>(ch * co);
  T* kskt = mem.take<T>(ci * co);
  if (!scratch) return mem.used;
  const bool has_rows = M > 0;
  Packer<T> pack;
  BOp<T> w1 = pack.fwd(p.w1, 1, ci, ch, k1);
  BOp<T> w2 = pack.fwd(p.w2, 9, ch, ch, k2);
  BOp<T> w1t = pack.bwd(p.w1, 1, ci, ch, k1t);
  BOp<T> w2t = pack.bwd(p.w2, 9, ch, ch, k2t);
  BOp<T> w3t = pack.bwd(p.w3, 1, ch, co, k3t);
  BOp<T> wskt = skip ? pack.bwd(p.skw, 1, ci, co, kskt) : BOp<T>{};
  if (stg.now(0) && has_rows) pack.run(s);
  const float *m1 = st[0], *v1 = st[1], *m2 = st[2], *v2 = st[3], *m3 = st[4],
              *v3 = st[5];
  ALoad<T> a1 = rows<T>(x, ci, sh.H, sh.W, m1, v1, p.g1, p.be1);
  ALoad<T> a2 = rows<T>(h1, ch, sh.H, sh.W, m2, v2, p.g2, p.be2);
  ALoad<T> a3 = rows<T>(h2, ch, sh.H, sh.W, m3, v3, p.g3, p.be3);
  Segs segs = {};
  int nseg = 0;
  auto seg = [&](const float* part, int nparts, int K, int N, int kper,
                 const Weight& w) {
    segs.s[nseg++] = Seg{part, const_cast<float*>(w.p), nparts, K * N, N,
                         kper, w.st, w.si, w.so};
  };
  auto vec = [&](const float* part, int nparts, int N, float* out) {
    seg(part, nparts, 1, N, 1, Weight{out, 0, 0, 1});
  };

  const bool staged = stg.which >= 0;
  const float nf = staged ? stg.n_global : (float)M;
  // The BN reduction (sum gy * hhat, sum gy) of pass k: this rank's share
  // is the parameter gradient (dg, dbe), which the data group sums later
  // with every other gradient; staged, the row at the end of stage k goes
  // to the caller, and stage k + 1 forms the data gradient from the ranks'
  // sums.
  auto reduce = [&](int k, int C, float* dg, float* dbe) {
    if (stg.now(k))
      pair_finish_k<<<C / 32, FIN_THREADS, 0, s>>>(red, tiles, C, dg, dbe,
                                                    staged ? stg.xch : nullptr);
  };
  auto global = [&](int k, int C, const float* dg, const float* dbe,
                    const float** gg, const float** gb) {
    *gg = dg;
    *gb = dbe;
    if (!staged) return;
    *gg = gsum;
    *gb = gsum + C;
    if (stg.which == k + 1)
      rank_sum_k<<<C / 32, 32, 0, s>>>(stg.gath, stg.world, stg.stride, C,
                                       gsum, gsum + C);
  };
  const float *sg, *sb;
  const int n3 = nsplits(ch, co), n2 = nsplits(9 * ch, ch),
            n1 = nsplits(ci, ch), nsk = nsplits(ci, co);
  seg(pw3, n3, ch, co, ch, d.w3);
  vec(pb3, n3, co, d.b3);
  if (skip) {
    vec(pb3, n3, co, d.skb);
    seg(psk, nsk, ci, co, ci, d.skw);
  }
  seg(pw2, n2, 9 * ch, ch, ch, d.w2);
  vec(pb2, n2, ch, d.b2);
  seg(pw1, n1, ci, ch, ci, d.w1);
  vec(pb1, n1, ch, d.b1);

  if (stg.now(0) && has_rows) {
    // recompute h1, h2
    gemm<T, A_BN, E_BIAS>(a1, w1, M, ch, ci,
                          bias_epi<T>(p.b1, nullptr, h1, nullptr), s);
    gemm<T, A_CONV_BN, E_BIAS>(a2, w2, M, ch, 9 * ch,
                               bias_epi<T>(p.b2, nullptr, h2, nullptr), s);
    // p5: db3 (= dskip_b), dw3, gy3 and the bn3 reductions, dskip_w
    wgrad<A_BN>(a3, gout, M, ch, co, pw3, pb3, s);
    if (skip) wgrad<A_PLAIN>(rows<T>(x, ci), gout, M, ci, co, psk, nullptr, s);
    gemm<T, A_PLAIN, E_GATE>(rows<T>(gout, co), w3t, M, ch, co,
                             gate_epi<T>(h2, m3, v3, p.g3, p.be3, gyc, red),
                             s);
  }
  reduce(0, ch, d.g3, d.be3);
  global(0, ch, d.g3, d.be3, &sg, &sb);
  if (stg.now(1) && has_rows) {
    // p6: g_h2
    bnbwd<T>(gyc, h2, M, ch, m3, v3, p.g3, sg, sb, 0, nullptr, nullptr, gh2,
             nf, s);
    // p7: db2, dw2 (the implicit im2col of a2 against g_h2)
    wgrad<A_CONV_BN>(a2, gh2, M, 9 * ch, ch, pw2, pb2, s);
    // p8: g_a2 -> gy2 (f32, reusing gyc) and the bn2 reductions
    gemm<T, A_CONV_NEG, E_GATE>(rows<T>(gh2, ch, sh.H, sh.W), w2t, M, ch,
                                9 * ch,
                                gate_epi<T>(h1, m2, v2, p.g2, p.be2, gyc, red),
                                s);
  }
  reduce(1, ch, d.g2, d.be2);
  global(1, ch, d.g2, d.be2, &sg, &sb);
  if (stg.now(2) && has_rows) {
    // p9: g_h1 from gy2 as stored in the working type
    bnbwd<T>(gyc, h1, M, ch, m2, v2, p.g2, sg, sb, 1, nullptr, nullptr, gh1,
             nf, s);
    // p10: db1, dw1, gy1 and the bn1 reductions
    wgrad<A_BN>(a1, gh1, M, ci, ch, pw1, pb1, s);
    gemm<T, A_PLAIN, E_GATE>(rows<T>(gh1, ch), w1t, M, ci, ch,
                             gate_epi<T>(x, m1, v1, p.g1, p.be1, gy1, red), s);
  }
  reduce(2, ci, d.g1, d.be1);
  global(2, ci, d.g1, d.be1, &sg, &sb);
  if (!stg.now(3)) return mem.used;
  if (has_rows) {
    // p11: g_x = bn1 backward + the skip's data gradient
    if (skip)
      gemm<T, A_PLAIN, E_GATE>(
          rows<T>(gout, co), wskt, M, ci, co,
          gate_epi<T>(nullptr, nullptr, nullptr, nullptr, nullptr, skd,
                      nullptr),
          s);
    bnbwd<T>(gy1, x, M, ci, m1, v1, p.g1, sg, sb, 0, skd,
             skip ? nullptr : gout, gx, nf, s);
  }
  // every split reduction (no partials: zero gradients) of this backward
  finish_grads_k<<<dim3(128, nseg), 256, 0, s>>>(segs);
  return mem.used;
}

}  // namespace rm

// ---------------------------------------------------------------------------
// C entries. Arguments come as one array of 64-bit integers (sizes, strides
// in elements, and addresses; the slots are named below) and one of doubles.
// A train forward or a backward whose BN reductions span a data group is
// four calls of the same entry, STAGE 0 to 3, with the same arguments and
// scratch; between two, the caller gathers every rank's XCH row (XSTRIDE
// floats) into GATH in rank order (rm::Stage). Rows are NHWC (B*H*W, C)
// row-major in the working type (is_bf16: 1 for bf16, 0 for f32). Every
// parameter, statistic and parameter gradient is f32. A 1x1 weight is the
// logical (in, out) matrix at (address, stride along in, stride along out);
// the 3x3 weight the logical (9, in, out) stack in TAPS order with its tap
// stride first. A null skip weight means the identity skip. Each entry
// returns a cudaError_t, 0 for success.
// ---------------------------------------------------------------------------

namespace {

template <typename P> P* ptr(long long v) {
  return reinterpret_cast<P*>(static_cast<uintptr_t>(v));
}
rm::Weight weight1(const long long* a) {
  return rm::Weight{ptr<const float>(a[0]), 0, a[1], a[2]};
}
rm::Weight weight9(const long long* a) {
  return rm::Weight{ptr<const float>(a[0]), a[1], a[2], a[3]};
}

// Argument slots, named once: the enums below index the array by these
// names, and resmodule_*_slots() hands the same names, in order, to the
// caller, which fills the array by name.
#define RM_FWD_SLOTS(DO)                                                     \
  DO(BF16) DO(TRAIN) DO(B) DO(H) DO(W) DO(CI) DO(CH) DO(CO) DO(X)            \
  DO(W1) DO(W1_SI) DO(W1_SO) DO(B1)                                          \
  DO(W2) DO(W2_ST) DO(W2_SI) DO(W2_SO) DO(B2)                                \
  DO(W3) DO(W3_SI) DO(W3_SO) DO(B3)                                          \
  DO(G1) DO(BE1) DO(G2) DO(BE2) DO(G3) DO(BE3)                               \
  DO(SKW) DO(SKW_SI) DO(SKW_SO) DO(SKB)                                      \
  /* written in train mode */                                                \
  DO(M1) DO(V1) DO(M2) DO(V2) DO(M3) DO(V3)                                  \
  /* null to leave the running statistics alone */                           \
  DO(RUN_MEAN1) DO(RUN_MEAN2) DO(RUN_MEAN3)                                  \
  DO(RUN_VAR1) DO(RUN_VAR2) DO(RUN_VAR3)                                     \
  DO(RUN_COUNT1) DO(RUN_COUNT2) DO(RUN_COUNT3)                               \
  DO(OUT) DO(SCRATCH) DO(STREAM)                                             \
  /* a staged call (rm::Stage): STAGE -1 for the whole call */               \
  DO(STAGE) DO(XCH) DO(GATH) DO(WORLD) DO(XSTRIDE)

#define RM_BWD_SLOTS(DO)                                                     \
  DO(BF16) DO(B) DO(H) DO(W) DO(CI) DO(CH) DO(CO) DO(X) DO(GOUT)             \
  DO(W1) DO(W1_SI) DO(W1_SO) DO(B1)                                          \
  DO(W2) DO(W2_ST) DO(W2_SI) DO(W2_SO) DO(B2)                                \
  DO(W3) DO(W3_SI) DO(W3_SO)                                                 \
  DO(SKW) DO(SKW_SI) DO(SKW_SO)                                              \
  DO(G1) DO(BE1) DO(G2) DO(BE2) DO(G3) DO(BE3)                               \
  DO(M1) DO(V1) DO(M2) DO(V2) DO(M3) DO(V3)                                  \
  DO(GX)                                                                     \
  DO(DW1) DO(DW1_SI) DO(DW1_SO) DO(DB1)                                      \
  DO(DW2) DO(DW2_ST) DO(DW2_SI) DO(DW2_SO) DO(DB2)                           \
  DO(DW3) DO(DW3_SI) DO(DW3_SO) DO(DB3)                                      \
  DO(DG1) DO(DBE1) DO(DG2) DO(DBE2) DO(DG3) DO(DBE3)                         \
  DO(DSKW) DO(DSKW_SI) DO(DSKW_SO) DO(DSKB)                                  \
  DO(SCRATCH) DO(STREAM)                                                     \
  DO(STAGE) DO(XCH) DO(GATH) DO(WORLD) DO(XSTRIDE) DO(N_GLOBAL)

#define RM_ENUM_F(name) F_##name,
#define RM_ENUM_B(name) B_##name,
#define RM_NAME(name) #name " "
enum { RM_FWD_SLOTS(RM_ENUM_F) F_COUNT };
enum { RM_BWD_SLOTS(RM_ENUM_B) B_COUNT };

rm::FwdParams fwd_params(const long long* a, int w1, int b1, int w2, int b2,
                         int w3, int b3, int skw, int skb, int g1) {
  rm::FwdParams p = {};
  p.w1 = weight1(a + w1);
  p.w2 = weight9(a + w2);
  p.w3 = weight1(a + w3);
  p.skw = weight1(a + skw);
  p.b1 = ptr<const float>(a[b1]);
  p.b2 = ptr<const float>(a[b2]);
  p.b3 = b3 >= 0 ? ptr<const float>(a[b3]) : nullptr;
  p.skb = skb >= 0 ? ptr<const float>(a[skb]) : nullptr;
  p.g1 = ptr<const float>(a[g1]);
  p.be1 = ptr<const float>(a[g1 + 1]);
  p.g2 = ptr<const float>(a[g1 + 2]);
  p.be2 = ptr<const float>(a[g1 + 3]);
  p.g3 = ptr<const float>(a[g1 + 4]);
  p.be3 = ptr<const float>(a[g1 + 5]);
  return p;
}

rm::Stage stage_of(const long long* a, int first) {
  rm::Stage g;
  g.which = (int)a[first];
  g.xch = ptr<float>(a[first + 1]);
  g.gath = ptr<const float>(a[first + 2]);
  g.world = (int)a[first + 3];
  g.stride = (int)a[first + 4];
  return g;
}

}  // namespace

// The slots' names in array order, each followed by a space.
extern "C" const char* resmodule_forward_slots() {
  return RM_FWD_SLOTS(RM_NAME);
}
extern "C" const char* resmodule_backward_slots() {
  return RM_BWD_SLOTS(RM_NAME);
}

// Bytes of scratch a call needs: kind 0 eval forward, 1 train forward, 2
// backward; -1 for a shape the kernels do not take (a bf16 image too wide
// for the 3x3's shared-memory tile).
extern "C" long long resmodule_scratch_bytes(int kind, int is_bf16, int B,
                                             int H, int W, int ci, int ch,
                                             int co) {
  rm::Shape sh{B, H, W, ci, ch, co};
  if (is_bf16 && !rm::conv_fits(sh.M(), W, ch)) return -1;
  rm::FwdParams p = {};
  if (ci != co) p.skw.p = reinterpret_cast<const float*>(16);
  rm::Running run = {};
  rm::Grads d = {};
  if (kind == 2)
    return is_bf16 ? rm::backward<rm::bf16>(sh, nullptr, nullptr, p, nullptr,
                                            nullptr, d, nullptr, nullptr)
                   : rm::backward<float>(sh, nullptr, nullptr, p, nullptr,
                                         nullptr, d, nullptr, nullptr);
  return is_bf16 ? rm::forward<rm::bf16>(kind == 1, sh, nullptr, p, nullptr,
                                         run, nullptr, nullptr, nullptr)
                 : rm::forward<float>(kind == 1, sh, nullptr, p, nullptr, run,
                                      nullptr, nullptr, nullptr);
}

// f: [0] the running-statistics factor, [1] n / (n - 1).
extern "C" int resmodule_forward(const long long* a, const double* f) {
  rm::Shape sh{(int)a[F_B], (int)a[F_H], (int)a[F_W], (int)a[F_CI],
               (int)a[F_CH], (int)a[F_CO]};
  rm::FwdParams p = fwd_params(a, F_W1, F_B1, F_W2, F_B2, F_W3, F_B3, F_SKW,
                               F_SKB, F_G1);
  float* st[6];
  for (int i = 0; i < 6; ++i) st[i] = ptr<float>(a[F_M1 + i]);
  rm::Running run = {};
  for (int i = 0; i < 3; ++i) {
    run.mean[i] = ptr<float>(a[F_RUN_MEAN1 + i]);
    run.var[i] = ptr<float>(a[F_RUN_VAR1 + i]);
    run.count[i] = ptr<long long>(a[F_RUN_COUNT1 + i]);
  }
  run.f = (float)f[0];
  run.omf = (float)(1.0 - f[0]);
  run.unbias = (float)f[1];
  cudaStream_t s = ptr<CUstream_st>(a[F_STREAM]);
  const void* x = ptr<const void>(a[F_X]);
  void* out = ptr<void>(a[F_OUT]);
  char* scratch = ptr<char>(a[F_SCRATCH]);
  const rm::Stage stg = stage_of(a, F_STAGE);
  if (stg.which >= 0 && !a[F_TRAIN]) return (int)cudaErrorInvalidValue;
  if (a[F_BF16])
    rm::forward<rm::bf16>(a[F_TRAIN] != 0, sh, x, p, st, run, out, scratch, s,
                          stg);
  else
    rm::forward<float>(a[F_TRAIN] != 0, sh, x, p, st, run, out, scratch, s,
                       stg);
  return rm::call_status();
}

extern "C" int resmodule_backward(const long long* a) {
  rm::Shape sh{(int)a[B_B], (int)a[B_H], (int)a[B_W], (int)a[B_CI],
               (int)a[B_CH], (int)a[B_CO]};
  rm::FwdParams p = fwd_params(a, B_W1, B_B1, B_W2, B_B2, B_W3, -1, B_SKW, -1,
                               B_G1);
  const float* st[6];
  for (int i = 0; i < 6; ++i) st[i] = ptr<const float>(a[B_M1 + i]);
  rm::Grads d = {};
  d.w1 = weight1(a + B_DW1);
  d.w2 = weight9(a + B_DW2);
  d.w3 = weight1(a + B_DW3);
  d.skw = weight1(a + B_DSKW);
  d.b1 = ptr<float>(a[B_DB1]);
  d.b2 = ptr<float>(a[B_DB2]);
  d.b3 = ptr<float>(a[B_DB3]);
  d.skb = ptr<float>(a[B_DSKB]);
  d.g1 = ptr<float>(a[B_DG1]);
  d.be1 = ptr<float>(a[B_DBE1]);
  d.g2 = ptr<float>(a[B_DG2]);
  d.be2 = ptr<float>(a[B_DBE2]);
  d.g3 = ptr<float>(a[B_DG3]);
  d.be3 = ptr<float>(a[B_DBE3]);
  cudaStream_t s = ptr<CUstream_st>(a[B_STREAM]);
  const void* x = ptr<const void>(a[B_X]);
  const void* gout = ptr<const void>(a[B_GOUT]);
  void* gx = ptr<void>(a[B_GX]);
  char* scratch = ptr<char>(a[B_SCRATCH]);
  rm::Stage stg = stage_of(a, B_STAGE);
  stg.n_global = (float)a[B_N_GLOBAL];
  if (a[B_BF16])
    rm::backward<rm::bf16>(sh, x, gout, p, st, gx, d, scratch, s, stg);
  else
    rm::backward<float>(sh, x, gout, p, st, gx, d, scratch, s, stg);
  return rm::call_status();
}
