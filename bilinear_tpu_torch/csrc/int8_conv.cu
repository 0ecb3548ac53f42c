// The detectors' dynamic int8 convolutions on Hopper (sm_90a): kernels K6
// and K7 of the port.
//
// They replace no Pallas kernel: the JAX package runs its int8 convolutions
// as XLA ops (bilinear_tpu/ops/int8.py:34-71, ``lax.conv_general_dilated``
// on int8 operands with an int32 accumulator), and PyTorch has no int8
// convolution on CUDA. What they compute is JAX's to the bit on equal
// inputs; every route below computes the same bits.
//
// K6 (int8_quantize_activations): per-sample symmetric int8 of an NHWC
// activation tensor, f32 or bf16: q = clip(rint(x / s), -127, 127) with
// s = max(amax, 1e-12) / 127 and amax = max|x| over the sample, both
// divisions IEEE (__fdiv_rn, as JAX's and torch's true division). Bound:
// bytes (x read once, q written once), 3.8 us at the served 3x3's input.
// Design: ONE launch, no memset. A sample is cut into tiles of 8,192
// values. A sample of at most 8 tiles (every level of 16x16 and below, the
// 256-channel 8x8s) takes one thread-block cluster, a block of 1,024
// threads per tile (a 256-thread block does a tile's 8,192 IEEE divisions
// on 8 warps; 1,024 threads cut K6 per served forward by ~14% on an
// H100): each block
// loads its tile into registers and puts its max|x| in its shared memory,
// and after a cluster barrier reads the others' through distributed shared
// memory (a maximum is exact in any order, so the scale is the plain
// version's bit for bit) and quantises its registers. A larger sample
// takes a persistent cooperative grid over all the tiles, each block
// writing its tile's max|x| into the tile's own slot (no atomics, so
// nothing to zero), then grid.sync(), then each block reduces the slots of
// its tiles' samples and quantises its tiles: its first tile from the
// registers it was loaded into, any other one read again (from L2: the
// served activations are 1-34 MB). The grid barrier costs ~2.4 us a call
// (H100), more than a memset and a second launch would where a sample is a
// few tiles; the cluster's barrier does not.
//
// K6 in two stage entries (int8_activation_amax, int8_quantize_scaled), for
// a tensor cut into row slabs that must share one per-sample scale (the
// detectors' spatially sharded forward, parallel/spatial.py): stage 1
// writes each sample's max|x| over its slab into a (batch,) f32 buffer,
// stage 2 quantises with a (batch,) f32 scale it is given. The caller takes
// the maximum over the slabs (exact in any order) and forms the scale with
// a true division in between, so the slabs put back together are the
// one-launch K6's bits. Both stages are the bodies above: stage 1 the first
// pass and the maxima's meeting (cluster or grid), stage 2 the second pass
// alone, one block per tile with no barrier between blocks. Bound: bytes,
// as the one launch; the second read of x is the price of the split.
//
// K7 (int8_conv_forward): an implicit-GEMM convolution, stride 1, padding
// (k - 1) / 2, of NHWC int8 activations (B, H, W, Ci) with int8 weights
// (Co, k, k, Ci): M = B * H * W output pixels by N = Co by K = k * k * Ci,
// with K contiguous per output channel. No im2col is ever written: the
// loader gathers each row's source pixel for the tap of each 16-byte chunk
// of K (at Ci = 64 a 128-byte K slab spans two taps) and zero-fills what
// falls outside the image (cp.async with a source size of 0). Products run
// on wgmma m64nNk32 s32.s8.s8 (wgmma_sm90.cuh) from 128-byte swizzled,
// K-contiguous tiles, as K2's. The epilogue is JAX's: y = float(acc) *
// (s_x[b] * s_w[co]) (+ bias[co]), each operation rounded on its own (no
// FMA), stored as f32 or bf16; out_kind 2 stores the raw int32 accumulator
// (to hold every route bit for bit against the plain version).
//
// What bounds K7, per shape class of a served forward (batch 8), and what
// the design does about it (times: ops/int8.py's plans on an H100, by
// trace; PERF.md):
// - 64x64 and larger (M >= 32,768, a grid of a wave or more): the
//   128-channel 3x3 is bound by operations (0.0049 ms), the 1x1s and the
//   64-channel 3x3s by bytes (mostly the output's write). A block is 2
//   warpgroups x 64 rows by a 128-channel tile (64 at Co = 64; a Co that
//   is no tile width has its B rows zero-filled and the epilogue skips
//   c >= Co), so each gathered activation tile feeds 128 channels at once;
//   a 256-wide tile (all of Co = 256 in one block, one block to an SM) lost
//   to two 128-wide ones at every served shape. Every thread copies its
//   share of a slab into a ring of DEPTH stages (cp.async groups and one
//   barrier per 128-byte slab hand a stage from the copies to the
//   products). The 128-wide tile runs 3 stages, two blocks to an SM, so
//   that one block's gathers and epilogue run under the other's products
//   (a 4-stage ring at one block to an SM measured 23-28% slower).
// - Smaller grids (32x32 and below at batch 8, every level of one frame):
//   too few blocks to fill the SMs, and each one's walk over K is bound by
//   the latency of its gathers. The plan takes 64-wide tiles (twice the
//   blocks) and, where the grid is at most half a wave and K has 3 slabs
//   or more (the 3x3s), splits K: each of `splits` blocks of a tile sums
//   `per` consecutive slabs. The tile's blocks are one thread-block cluster
//   (at most 8): each stages its int32 partial sums in its own shared
//   memory, and after a cluster barrier each finishes 1/splits of the
//   tile's rows, adding every block's partials through distributed shared
//   memory, so no partial sum leaves the SMs and nothing is zeroed or
//   counted between launches (partials added into global memory with
//   atomics measured slower than no split at all). int32 addition is exact
//   and associative, so the sum is the accumulator bit for bit.
// The epilogue's operands (each row's sample scale, each channel's weight
// scale and bias) are copied with the first slab. The epilogue stages the
// accumulators through the freed ring and writes 16-byte stores, a row's
// channels by neighbouring threads.
// The route, tile width, ring depth and splits are chosen on the host
// (plan_conv) and passed in; a (tile width, depth) pair that is not
// instantiated here is refused.
//
// int8_conv_fused launches K6 and then K7 on one stream: one call per
// convolution.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lifting_common.cuh"
#include "wgmma_sm90.cuh"

namespace {

namespace cg = cooperative_groups;
using lifting::cp16z;
using lifting::swz;

// ------------------------------------------------------------------- K6

constexpr int Q_VEC = 8;       // values per thread step (16 bytes of bf16)
constexpr int Q_TILE = 1024;   // vectors per tile: 8,192 values
// The cooperative grid: 256 threads, 4 steps each per tile.
constexpr int Q_THREADS = 256;
constexpr int Q_UNROLL = Q_TILE / Q_THREADS;
// The cluster route: a block of Q_SAMPLE_THREADS per tile, so that a
// tile's 8,192 divisions are spread over 32 warps.
constexpr int Q_SAMPLE_THREADS = 1024;
// Samples of at most Q_CLUSTER_TILES tiles take one cluster each
// (quantize_sample_kernel); larger ones the cooperative grid.
constexpr int Q_CLUSTER_TILES = 8;  // the largest portable cluster

struct Vec8 {
  float v[Q_VEC];
};

// 8 values as loaded (kept in registers between the two passes), and widened.
template <typename T> struct Raw8;
template <> struct Raw8<float> {
  float4 a, b;
};
template <> struct Raw8<__nv_bfloat16> {
  uint4 a;
};

__device__ __forceinline__ Raw8<float> load8(const float* p) {
  return {*reinterpret_cast<const float4*>(p),
          *reinterpret_cast<const float4*>(p + 4)};
}
__device__ __forceinline__ Raw8<__nv_bfloat16> load8(const __nv_bfloat16* p) {
  return {*reinterpret_cast<const uint4*>(p)};
}

__device__ __forceinline__ Vec8 widen(const Raw8<float>& r) {
  Vec8 v;
  v.v[0] = r.a.x; v.v[1] = r.a.y; v.v[2] = r.a.z; v.v[3] = r.a.w;
  v.v[4] = r.b.x; v.v[5] = r.b.y; v.v[6] = r.b.z; v.v[7] = r.b.w;
  return v;
}
__device__ __forceinline__ Vec8 widen(const Raw8<__nv_bfloat16>& r) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r.a);
  Vec8 v;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    v.v[2 * i] = f.x;
    v.v[2 * i + 1] = f.y;
  }
  return v;
}

__device__ __forceinline__ int quantize1(float x, float s) {
  float q = rintf(__fdiv_rn(x, s));  // round half to even
  return (int)fminf(fmaxf(q, -127.f), 127.f);
}

// The block's largest m, in every thread. `red` holds one value per warp.
template <int THREADS = Q_THREADS>
__device__ __forceinline__ float block_max(float m, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  m = red[0];
#pragma unroll
  for (int i = 1; i < THREADS / 32; ++i) m = fmaxf(m, red[i]);
  __syncthreads();  // red is free again
  return m;
}

struct QuantArgs {
  const void* x;     // (batch, vps * 8) f32 or bf16
  int8_t* q;         // the same shape, int8
  float* scale;      // (batch,)
  float* slots;      // (batch * tps,) max|x| of each tile
  long long batch;
  long long vps;     // 8-value vectors per sample
  long long tps;     // tiles per sample
  // 0: the one launch (max|x|, scale, quantise); 1: write each sample's
  // max|x| into `scale` and stop; 2: quantise with the scale read from
  // `scale`.
  int stage;
};

template <typename T>
__global__ void __launch_bounds__(Q_THREADS)
quantize_kernel(const __grid_constant__ QuantArgs a) {
  __shared__ float red[Q_THREADS / 32];
  const T* x = static_cast<const T*>(a.x);
  const long long tiles = a.batch * a.tps;
  Raw8<T> held[Q_UNROLL];  // the block's first tile
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long b = t / a.tps, v0 = (t - b * a.tps) * Q_TILE;
    const T* xs = x + b * a.vps * Q_VEC;
    float m = 0.f;
#pragma unroll
    for (int u = 0; u < Q_UNROLL; ++u) {
      const long long v = v0 + u * Q_THREADS + threadIdx.x;
      if (v < a.vps) {
        const Raw8<T> raw = load8(xs + v * Q_VEC);
        const Vec8 val = widen(raw);
#pragma unroll
        for (int i = 0; i < Q_VEC; ++i) m = fmaxf(m, fabsf(val.v[i]));
        if (t == blockIdx.x) held[u] = raw;
      }
    }
    m = block_max(m, red);
    if (threadIdx.x == 0) a.slots[t] = m;
  }
  cg::this_grid().sync();
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long b = t / a.tps, p = t - b * a.tps, v0 = p * Q_TILE;
    if (a.stage == 1 && p != 0) continue;  // one block writes the sample's
    float m = 0.f;
    for (long long i = threadIdx.x; i < a.tps; i += Q_THREADS)
      m = fmaxf(m, __ldcg(a.slots + b * a.tps + i));
    m = block_max(m, red);
    if (a.stage == 1) {
      if (threadIdx.x == 0) a.scale[b] = m;
      continue;
    }
    const float s = __fdiv_rn(fmaxf(m, 1e-12f), 127.0f);
    if (p == 0 && threadIdx.x == 0) a.scale[b] = s;
    const T* xs = x + b * a.vps * Q_VEC;
    int8_t* qs = a.q + b * a.vps * Q_VEC;
#pragma unroll
    for (int u = 0; u < Q_UNROLL; ++u) {
      const long long v = v0 + u * Q_THREADS + threadIdx.x;
      if (v < a.vps) {
        const Vec8 val =
            widen(t == blockIdx.x ? held[u] : load8(xs + v * Q_VEC));
        uint32_t w[2] = {0u, 0u};
#pragma unroll
        for (int i = 0; i < Q_VEC; ++i)
          w[i >> 2] |= (uint32_t)(uint8_t)(int8_t)quantize1(val.v[i], s)
                       << (8 * (i & 3));
        *reinterpret_cast<uint2*>(qs + v * Q_VEC) = make_uint2(w[0], w[1]);
      }
    }
  }
}

// A sample of at most Q_CLUSTER_TILES tiles: one cluster of a.tps blocks
// per sample (a single block for a sample of one tile), block rank p taking
// tile p, its values held in registers between the two passes; the tiles'
// maxima meet in distributed shared memory, with no grid-wide barrier and
// no slots. Stage 2 launches it over samples of any size without a
// cluster: each block quantises its tile with the given scale.
template <typename T>
__global__ void __launch_bounds__(Q_SAMPLE_THREADS)
quantize_sample_kernel(const __grid_constant__ QuantArgs a) {
  constexpr int UNROLL = Q_TILE / Q_SAMPLE_THREADS;
  __shared__ float red[Q_SAMPLE_THREADS / 32];
  __shared__ float tile_max;
  const long long b = blockIdx.x / a.tps;
  const long long v0 = (blockIdx.x - b * a.tps) * Q_TILE;
  const T* xs = static_cast<const T*>(a.x) + b * a.vps * Q_VEC;
  int8_t* qs = a.q + b * a.vps * Q_VEC;
  const bool given = a.stage == 2;
  const bool meet = !given && a.tps > 1;
  Raw8<T> held[UNROLL];
  float m = 0.f;
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const long long v = v0 + u * Q_SAMPLE_THREADS + threadIdx.x;
    if (v < a.vps) {
      held[u] = load8(xs + v * Q_VEC);
      const Vec8 val = widen(held[u]);
#pragma unroll
      for (int i = 0; i < Q_VEC; ++i) m = fmaxf(m, fabsf(val.v[i]));
    }
  }
  if (!given) m = block_max<Q_SAMPLE_THREADS>(m, red);
  if (meet) {
    cg::cluster_group cluster = cg::this_cluster();
    if (threadIdx.x == 0) tile_max = m;
    cluster.sync();  // every tile's maximum is in its block
    float r[Q_CLUSTER_TILES];
#pragma unroll
    for (int i = 0; i < Q_CLUSTER_TILES; ++i)  // all loads in flight at once
      r[i] = i < a.tps ? *cluster.map_shared_rank(&tile_max, i) : 0.f;
#pragma unroll
    for (int i = 0; i < Q_CLUSTER_TILES; ++i) m = fmaxf(m, r[i]);
  }
  if (a.stage == 1) {
    if (v0 == 0 && threadIdx.x == 0) a.scale[b] = m;
  } else {
    const float s = given ? a.scale[b] : __fdiv_rn(fmaxf(m, 1e-12f), 127.0f);
    if (!given && v0 == 0 && threadIdx.x == 0) a.scale[b] = s;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long v = v0 + u * Q_SAMPLE_THREADS + threadIdx.x;
      if (v < a.vps) {
        const Vec8 val = widen(held[u]);
        uint32_t w[2] = {0u, 0u};
#pragma unroll
        for (int i = 0; i < Q_VEC; ++i)
          w[i >> 2] |= (uint32_t)(uint8_t)(int8_t)quantize1(val.v[i], s)
                       << (8 * (i & 3));
        *reinterpret_cast<uint2*>(qs + v * Q_VEC) = make_uint2(w[0], w[1]);
      }
    }
  }
  if (meet) cg::this_cluster().sync();  // the others have read tile_max
}

// Blocks of the quantise kernel of type T that the current device holds at
// once (asked once per device).
template <typename T>
cudaError_t quantize_resident(int* out) {
  static int resident_on[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int& r = resident_on[dev & 63];
  if (r == 0) {
    e = lifting::resident_blocks(quantize_kernel<T>, Q_THREADS, 0, &r);
    if (e != cudaSuccess) return e;
    if (r < 1) return cudaErrorLaunchOutOfResources;
  }
  *out = r;
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_quantize(const QuantArgs& a, cudaStream_t stream) {
  if (a.tps == 1 || a.stage == 2) {
    quantize_sample_kernel<T>
        <<<(unsigned)(a.batch * a.tps), Q_SAMPLE_THREADS, 0, stream>>>(a);
    return cudaGetLastError();
  }
  if (a.tps <= Q_CLUSTER_TILES) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(a.batch * a.tps));
    cfg.blockDim = dim3(Q_SAMPLE_THREADS);
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)a.tps;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, quantize_sample_kernel<T>, a);
  }
  int resident = 0;
  cudaError_t e = quantize_resident<T>(&resident);
  if (e != cudaSuccess) return e;
  const long long tiles = a.batch * a.tps;
  const int grid = tiles < resident ? (int)tiles : resident;
  auto kernel = quantize_kernel<T>;
  void* params[] = {const_cast<QuantArgs*>(&a)};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                     dim3(grid), dim3(Q_THREADS), params, 0,
                                     stream);
}

cudaError_t quantize(const void* x, int dtype, long long batch,
                     long long per_sample, void* q, void* scale, void* slots,
                     int stage, cudaStream_t stream) {
  QuantArgs a;
  a.stage = stage;
  a.x = x;
  a.q = static_cast<int8_t*>(q);
  a.scale = static_cast<float*>(scale);
  a.slots = static_cast<float*>(slots);
  a.batch = batch;
  a.vps = per_sample / Q_VEC;
  a.tps = (a.vps + Q_TILE - 1) / Q_TILE;
  if (a.tps < 1) a.tps = 1;
  return dtype == 0 ? launch_quantize<float>(a, stream)
                    : launch_quantize<__nv_bfloat16>(a, stream);
}

// ------------------------------------------------------------------- K7

constexpr int NWG = 2;  // consumer warpgroups, 64 rows each
constexpr int MAX_SPLITS = 8;  // the largest portable cluster

struct ConvArgs {
  const int8_t* x;     // (B, H, W, Ci)
  const int8_t* w;     // (Co, k, k, Ci)
  const float* sx;     // (B,)
  const float* ks;     // (Co,)
  const float* bias;   // (Co,) or null
  void* out;           // (B, H, W, Co): f32, bf16 or int32
  int H, W, Ci, Co, k, out_kind;
  int M, K;            // output pixels; K in bytes
  int slabs, per;
  int splits;          // blocks per output tile: one cluster, <= MAX_SPLITS
  int n_tiles;
};

__device__ __forceinline__ float dequant(int acc, float sx, float ks,
                                         float bias) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), __fmul_rn(sx, ks)), bias);
}
__device__ __forceinline__ float dequant(int acc, float sx, float ks) {
  return __fmul_rn(__int2float_rn(acc), __fmul_rn(sx, ks));
}

// Issues this thread's copies of each slab of K, in order, for output rows
// m0.. and channels n0.. (lifting::mainloop's loader): the rows of A are the
// source pixels of the tap of this thread's 16-byte chunk, zero-filled
// outside the image; the rows of B the kernel's.
template <int BN, int DEPTH>
struct ConvLoader {
  using C = lifting::Tile<NWG, BN, DEPTH>;
  static constexpr int ROWS_STEP = C::THREADS / 8;
  static constexpr int AROWS = C::BM / ROWS_STEP;
  static constexpr int BROWS = BN / ROWS_STEP;
  const ConvArgs& a;
  int n0, j, rb, pad;
  // This thread's rows of A: the pixel's address and its (y, x); a row past
  // M takes a y that no tap brings inside the image.
  const int8_t* abase[AROWS];
  int ay[AROWS], ax[AROWS];
  // The tap (ty, tx) and channel ci of this thread's 16-byte chunk j of the
  // next slab, advanced by 128 bytes of K per slab.
  int kb, ci, ty, tx;

  __device__ __forceinline__ ConvLoader(const ConvArgs& args, int m0, int n0_,
                                        int s0)
      : a(args), n0(n0_), j(threadIdx.x & 7), rb(threadIdx.x >> 3),
        pad((args.k - 1) >> 1) {
    const int hw = a.H * a.W;
#pragma unroll
    for (int i = 0; i < AROWS; ++i) {
      const int m = m0 + rb + i * ROWS_STEP;
      abase[i] = a.x;
      ay[i] = -(1 << 29);
      ax[i] = 0;
      if (m < a.M) {
        const int b = m / hw, rem = m - b * hw;
        ay[i] = rem / a.W;
        ax[i] = rem - ay[i] * a.W;
        abase[i] = a.x + (size_t)m * a.Ci;
      }
    }
    kb = s0 * 128 + j * 16;
    const int tap = kb / a.Ci;
    ci = kb - tap * a.Ci;
    ty = tap / a.k;
    tx = tap - ty * a.k;
  }

  __device__ __forceinline__ void operator()(uint32_t st, int) {
    const bool kok = kb < a.K;
    const int dy = ty - pad, dx = tx - pad;
    const ptrdiff_t off = (ptrdiff_t)(dy * a.W + dx) * a.Ci + ci;
#pragma unroll
    for (int i = 0; i < AROWS; ++i) {
      const int y = ay[i] + dy, x = ax[i] + dx;
      const bool ok = kok && y >= 0 && y < a.H && x >= 0 && x < a.W;
      cp16z(st + swz(rb + i * ROWS_STEP, j), ok ? abase[i] + off : a.x, ok);
    }
#pragma unroll
    for (int i = 0; i < BROWS; ++i) {
      const int n = rb + i * ROWS_STEP;
      const bool ok = kok && n0 + n < a.Co;
      cp16z(st + C::A_BYTES + swz(n, j),
            ok ? a.w + (size_t)(n0 + n) * a.K + kb : a.w, ok);
    }
    kb += 128;
    ci += 128;
    while (ci >= a.Ci) {
      ci -= a.Ci;
      if (++tx == a.k) tx = 0, ++ty;
    }
  }
};

// 4 bytes global -> shared; pred false zero-fills (reads nothing).
__device__ __forceinline__ void cp4z(uint32_t dst, const void* src,
                                     bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

// One block: output tile (m0, n0) over its split's slabs. With split-K the
// tile's `splits` blocks are one cluster, rank = split. MINB blocks to an
// SM.
template <int BN, int DEPTH, int MINB>
__global__ void __launch_bounds__(128 * NWG, MINB)
int8_conv_kernel(const __grid_constant__ ConvArgs a) {
  using C = lifting::Tile<NWG, BN, DEPTH>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(16) float row_sx[C::BM];
  __shared__ __align__(16) float col_ks[BN];
  __shared__ __align__(16) float col_b[BN];
  unsigned char* ring = lifting::align_ring(smem_raw);
  const int tid = threadIdx.x;
  const int wgid = tid >> 7, warp = (tid & 127) >> 5, lane = tid & 31;
  const int split = blockIdx.x % a.splits;
  const int tile = blockIdx.x / a.splits;
  const int m0 = tile / a.n_tiles * C::BM, n0 = tile % a.n_tiles * BN;
  const int s0 = split * a.per, s1 = min(s0 + a.per, a.slabs);

  // The epilogue's operands, copied under the products (they land with the
  // first slab): each row's sample scale, each channel's weight scale and
  // bias.
  if (a.out_kind != 2) {
    if (tid < C::BM) {
      const int m = m0 + tid;
      const bool ok = m < a.M;
      cp4z((uint32_t)__cvta_generic_to_shared(row_sx + tid),
           ok ? a.sx + m / (a.H * a.W) : a.sx, ok);
    }
    for (int c = 4 * tid; c < BN; c += 4 * C::THREADS) {
      const bool ok = n0 + c < a.Co;  // Co % 16 == 0: all four or none
      cp16z((uint32_t)__cvta_generic_to_shared(col_ks + c),
            ok ? a.ks + n0 + c : a.ks, ok);
      if (a.bias)
        cp16z((uint32_t)__cvta_generic_to_shared(col_b + c),
              ok ? a.bias + n0 + c : a.bias, ok);
    }
  }

  int acc[BN / 2];
  ConvLoader<BN, DEPTH> load(a, m0, n0, s0);
  lifting::mainloop<int8_t, NWG, BN, DEPTH>(load, a.K, s0, s1, ring, acc);

  // Stage the accumulators (wgmma_sm90.cuh's layout) in the freed ring.
  int* stg = reinterpret_cast<int*>(ring);
  {
    const int frow = wgid * 64 + warp * 16 + (lane >> 2), fcol = 2 * (lane & 3);
#pragma unroll
    for (int jj = 0; jj < BN / 8; ++jj) {
      *reinterpret_cast<int2*>(stg + frow * C::LDS + 8 * jj + fcol) =
          make_int2(acc[4 * jj], acc[4 * jj + 1]);
      *reinterpret_cast<int2*>(stg + (frow + 8) * C::LDS + 8 * jj + fcol) =
          make_int2(acc[4 * jj + 2], acc[4 * jj + 3]);
    }
  }

  // Rows this block finishes: all of the tile's, or with split-K its share
  // of them, summed over the cluster's staged partials (distributed shared
  // memory; the cluster barrier makes every block's stage visible).
  int lo = 0, hi = C::BM;
  cg::cluster_group cluster = cg::this_cluster();
  if (a.splits > 1) {
    lo = split * C::BM / a.splits;
    hi = (split + 1) * C::BM / a.splits;
    cluster.sync();
  } else {
    __syncthreads();
  }

  // A thread finishes the same 8 channels of every STEP-th row of its
  // share, UNROLL rows at a time so that their loads are in flight
  // together.
  constexpr int CHUNKS = BN / 8, STEP = C::THREADS / CHUNKS, UNROLL = 4;
  const int c = tid % CHUNKS, col = n0 + 8 * c;
  if (col < a.Co) {
    for (int r0 = lo + tid / CHUNKS; r0 < hi; r0 += STEP * UNROLL) {
      int v[UNROLL][8];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
#pragma unroll
        for (int i = 0; i < 8; ++i) v[u][i] = 0;
      for (int q = 0; q < a.splits; ++q) {
        const int* src = a.splits > 1 ? cluster.map_shared_rank(stg, q) : stg;
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int r = r0 + u * STEP;
          if (r < hi) {
            const int4* p =
                reinterpret_cast<const int4*>(src + r * C::LDS + 8 * c);
            const int4 x0 = p[0], x1 = p[1];
            v[u][0] += x0.x, v[u][1] += x0.y, v[u][2] += x0.z, v[u][3] += x0.w;
            v[u][4] += x1.x, v[u][5] += x1.y, v[u][6] += x1.z, v[u][7] += x1.w;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int r = r0 + u * STEP, m = m0 + r;
        if (r >= hi || m >= a.M) break;
        const size_t o = (size_t)m * a.Co + col;
        if (a.out_kind == 2) {
          int4* d = reinterpret_cast<int4*>(static_cast<int*>(a.out) + o);
          d[0] = make_int4(v[u][0], v[u][1], v[u][2], v[u][3]);
          d[1] = make_int4(v[u][4], v[u][5], v[u][6], v[u][7]);
          continue;
        }
        const float sx = row_sx[r];
        float y[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          y[i] = a.bias
                     ? dequant(v[u][i], sx, col_ks[8 * c + i], col_b[8 * c + i])
                     : dequant(v[u][i], sx, col_ks[8 * c + i]);
        if (a.out_kind == 0) {
          float4* d = reinterpret_cast<float4*>(static_cast<float*>(a.out) + o);
          d[0] = make_float4(y[0], y[1], y[2], y[3]);
          d[1] = make_float4(y[4], y[5], y[6], y[7]);
        } else {
          *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(a.out) + o) =
              make_uint4(lifting::pack_bf16x2(y[0], y[1]),
                         lifting::pack_bf16x2(y[2], y[3]),
                         lifting::pack_bf16x2(y[4], y[5]),
                         lifting::pack_bf16x2(y[6], y[7]));
        }
      }
    }
  }
  if (a.splits > 1) cluster.sync();  // the others have read this block's stage
}

template <int BN, int DEPTH, int MINB>
cudaError_t launch_conv(const ConvArgs& a, int blocks, cudaStream_t stream) {
  using C = lifting::Tile<NWG, BN, DEPTH>;
  auto kernel = int8_conv_kernel<BN, DEPTH, MINB>;
  static bool ready_on[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (!ready_on[dev & 63]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::SMEM);
    if (e != cudaSuccess) return e;
    ready_on[dev & 63] = true;
  }
  if (a.splits == 1) {
    kernel<<<blocks, C::THREADS, C::SMEM, stream>>>(a);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(C::THREADS);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

// The instantiated tiles: (BN, DEPTH) -> blocks per SM. Keep in step with
// ops/int8.py::TILES.
cudaError_t conv(const void* x, const void* w, const void* sx, const void* ks,
                 const void* bias, void* out, int B, int H, int W, int Ci,
                 int Co, int k, int out_kind, int bn, int depth, int splits,
                 int per, cudaStream_t stream) {
  ConvArgs a;
  a.x = static_cast<const int8_t*>(x);
  a.w = static_cast<const int8_t*>(w);
  a.sx = static_cast<const float*>(sx);
  a.ks = static_cast<const float*>(ks);
  a.bias = static_cast<const float*>(bias);
  a.out = out;
  a.H = H; a.W = W; a.Ci = Ci; a.Co = Co; a.k = k; a.out_kind = out_kind;
  a.M = B * H * W;
  a.K = k * k * Ci;
  a.slabs = (a.K + 127) / 128;
  a.per = per;
  a.splits = splits;
  a.n_tiles = (Co + bn - 1) / bn;
  if (splits < 1 || splits > MAX_SPLITS || per < 1)
    return cudaErrorInvalidValue;
  const int blocks = (a.M + NWG * 64 - 1) / (NWG * 64) * a.n_tiles * splits;
  if (bn == 64 && depth == 4) return launch_conv<64, 4, 2>(a, blocks, stream);
  if (bn == 128 && depth == 3) return launch_conv<128, 3, 2>(a, blocks, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// K6. x: (batch, per_sample) f32 (dtype 0) or bf16 (dtype 1), per_sample %
// 8 == 0 and 16-byte aligned rows; q: int8 of the same shape; scale:
// (batch,) f32; slots: batch * ceil(per_sample / 8192) f32, written before
// they are read. Returns the launch's CUDA error.
extern "C" int int8_quantize_activations(const void* x, int dtype,
                                         long long batch,
                                         long long per_sample, void* q,
                                         void* scale, void* slots,
                                         void* stream) {
  return (int)quantize(x, dtype, batch, per_sample, q, scale, slots, 0,
                       static_cast<cudaStream_t>(stream));
}

// K6's first stage: amax (batch,) f32 gets each sample's max|x| over the
// slab x (arguments as int8_quantize_activations; slots are used by a
// sample of more than 8 tiles). Returns the launch's CUDA error.
extern "C" int int8_activation_amax(const void* x, int dtype, long long batch,
                                    long long per_sample, void* amax,
                                    void* slots, void* stream) {
  return (int)quantize(x, dtype, batch, per_sample, nullptr, amax, slots, 1,
                       static_cast<cudaStream_t>(stream));
}

// K6's second stage: q = clip(rint(x / scale[b]), -127, 127) with the
// given (batch,) f32 scale, one block per 8,192-value tile. Returns the
// launch's CUDA error.
extern "C" int int8_quantize_scaled(const void* x, int dtype, long long batch,
                                    long long per_sample, const void* scale,
                                    void* q, void* stream) {
  return (int)quantize(x, dtype, batch, per_sample, q,
                       const_cast<void*>(scale), nullptr, 2,
                       static_cast<cudaStream_t>(stream));
}

// K7. x (B, H, W, Ci) int8, w (Co, k, k, Ci) int8, sx (B,) f32, ks (Co,)
// f32, bias (Co,) f32 or null, out (B, H, W, Co): out_kind 0 f32, 1 bf16, 2
// the int32 accumulator. The plan (ops/int8.py::plan_conv): tile width bn,
// ring depth, splits of K (at most MAX_SPLITS, one cluster per output
// tile) and 128-byte slabs per split. Needs Ci % 64 == 0, Co % 16 == 0, k
// odd, 16-byte aligned x and w. Returns the launch's CUDA error.
extern "C" int int8_conv_forward(const void* x, const void* w, const void* sx,
                                 const void* ks, const void* bias, void* out,
                                 int B, int H, int W, int Ci, int Co, int k,
                                 int out_kind, int bn, int depth, int splits,
                                 int per, void* stream) {
  return (int)conv(x, w, sx, ks, bias, out, B, H, W, Ci, Co, k, out_kind, bn,
                   depth, splits, per, static_cast<cudaStream_t>(stream));
}

// K6 on the f32 (dtype 0) or bf16 (dtype 1) NHWC activation xf into xq and
// sx, then K7 on them, on one stream: the arguments of the two entries
// above.
extern "C" int int8_conv_fused(const void* xf, int dtype, void* xq, void* sx,
                               void* slots, const void* w, const void* ks,
                               const void* bias, void* out, int B, int H,
                               int W, int Ci, int Co, int k, int out_kind,
                               int bn, int depth, int splits, int per,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = quantize(xf, dtype, B, (long long)H * W * Ci, xq, sx, slots,
                           0, s);
  if (e != cudaSuccess) return (int)e;
  return (int)conv(xq, w, sx, ks, bias, out, B, H, W, Ci, Co, k, out_kind, bn,
                   depth, splits, per, s);
}
