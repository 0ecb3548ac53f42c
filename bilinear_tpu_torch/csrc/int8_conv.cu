// The detectors' dynamic int8 convolutions on Hopper (sm_90a): kernels K6
// and K7 of the port.
//
// They replace no Pallas kernel: the JAX package runs its int8 convolutions
// as XLA ops (bilinear_tpu/ops/int8.py:34-71, ``lax.conv_general_dilated``
// on int8 operands with an int32 accumulator), and PyTorch has no int8
// convolution on CUDA.
//
// K6 (int8_quantize_activations): per-sample symmetric int8 of an NHWC
// activation tensor, f32 or bf16. One pass reduces max|x| of each sample
// (atomicMax on the f32 bit pattern, which orders like the value for
// x >= 0), a second writes q = clip(rint(x / s), -127, 127) with
// s = max(amax, 1e-12) / 127, both divisions IEEE (__fdiv_rn, as JAX's and
// torch's true division). Bound: bytes (read x twice, write q once).
//
// K7 (int8_conv_forward): an implicit-GEMM convolution, stride 1, padding
// (k - 1) / 2, of NHWC int8 activations (B, H, W, Ci) with int8 weights
// (Co, k, k, Ci), K = k * k * Ci contiguous per output channel. The GEMM is
// M = B * H * W output pixels by N = Co by K; no im2col is ever written: a
// block's loader computes each row's source pixel for the tap of the
// current K tile (Ci % 64 == 0, so a 64-byte K tile lies in one tap) and
// zero-fills what falls outside the image (cp.async with a source size of
// 0). Products run on the int8 tensor cores (mma.sync m16n8k32
// s32.s8.s8.s32) into int32 accumulators. The epilogue is JAX's:
// y = float(acc) * (s_x[b] * s_w[co]) (+ bias[co]), each operation rounded
// on its own (no FMA), then stored as f32 or bf16; out_kind 2 stores the
// raw int32 accumulator (to hold it bit for bit against the plain
// version). Bound at the served shapes: bytes (the output's write) for the
// 1x1 convs and the 64-channel 3x3s, operations for the 128-channel 3x3s.
// This first kernel is the simple one: a
// 128 x 64 block tile, 8 warps of 32 x 32, a 3-stage cp.async ring in
// static shared memory, 32-bit fragment loads from rows padded to 80 bytes
// (conflict-free), and no wgmma.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ------------------------------------------------------------------- K6

constexpr int Q_THREADS = 256;
constexpr int Q_VEC = 8;           // elements per thread step (16 bytes of bf16)
constexpr int Q_MAX_BLOCKS = 512;  // blocks per sample (grid-stride beyond)

struct Vec8 {
  float v[Q_VEC];
};

__device__ __forceinline__ Vec8 load8(const float* p) {
  float4 a = *reinterpret_cast<const float4*>(p);
  float4 b = *reinterpret_cast<const float4*>(p + 4);
  Vec8 r;
  r.v[0] = a.x; r.v[1] = a.y; r.v[2] = a.z; r.v[3] = a.w;
  r.v[4] = b.x; r.v[5] = b.y; r.v[6] = b.z; r.v[7] = b.w;
  return r;
}

__device__ __forceinline__ Vec8 load8(const __nv_bfloat16* p) {
  uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  Vec8 r;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    r.v[2 * i] = f.x;
    r.v[2 * i + 1] = f.y;
  }
  return r;
}

template <typename T>
__global__ void __launch_bounds__(Q_THREADS)
amax_kernel(const T* __restrict__ x, long long per_sample,
            unsigned int* __restrict__ amax_bits) {
  const int b = blockIdx.y;
  const T* xs = x + (long long)b * per_sample;
  const long long chunks = per_sample / Q_VEC;
  float m = 0.f;
  for (long long c = (long long)blockIdx.x * Q_THREADS + threadIdx.x;
       c < chunks; c += (long long)gridDim.x * Q_THREADS) {
    Vec8 v = load8(xs + c * Q_VEC);
#pragma unroll
    for (int i = 0; i < Q_VEC; ++i) m = fmaxf(m, fabsf(v.v[i]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ float part[Q_THREADS / 32];
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < Q_THREADS / 32 ? part[threadIdx.x] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (threadIdx.x == 0) atomicMax(amax_bits + b, __float_as_uint(m));
  }
}

__device__ __forceinline__ float sample_scale(unsigned int bits) {
  return __fdiv_rn(fmaxf(__uint_as_float(bits), 1e-12f), 127.0f);
}

__device__ __forceinline__ int quantize1(float x, float s) {
  float q = rintf(__fdiv_rn(x, s));  // round half to even
  return (int)fminf(fmaxf(q, -127.f), 127.f);
}

template <typename T>
__global__ void __launch_bounds__(Q_THREADS)
quantize_kernel(const T* __restrict__ x, long long per_sample,
                const unsigned int* __restrict__ amax_bits,
                int8_t* __restrict__ q, float* __restrict__ scale_out) {
  const int b = blockIdx.y;
  const float s = sample_scale(amax_bits[b]);
  if (blockIdx.x == 0 && threadIdx.x == 0) scale_out[b] = s;
  const T* xs = x + (long long)b * per_sample;
  int8_t* qs = q + (long long)b * per_sample;
  const long long chunks = per_sample / Q_VEC;
  for (long long c = (long long)blockIdx.x * Q_THREADS + threadIdx.x;
       c < chunks; c += (long long)gridDim.x * Q_THREADS) {
    Vec8 v = load8(xs + c * Q_VEC);
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < Q_VEC; ++i)
      w[i >> 2] |= (uint32_t)(uint8_t)(int8_t)quantize1(v.v[i], s)
                   << (8 * (i & 3));
    *reinterpret_cast<uint2*>(qs + c * Q_VEC) = make_uint2(w[0], w[1]);
  }
}

// ------------------------------------------------------------------- K7

constexpr int BM = 128;      // output pixels per block
constexpr int BN = 64;       // output channels per block
constexpr int BK = 64;       // K bytes per pipeline stage
constexpr int LDS = BK + 16; // shared-memory row pitch in bytes
constexpr int STAGES = 3;
constexpr int THREADS = 256; // 8 warps: 4 along M x 2 along N, 32 x 32 each

struct ConvArgs {
  const int8_t* x;     // (B, H, W, Ci)
  const int8_t* w;     // (Co, k, k, Ci)
  const float* sx;     // (B,)
  const float* ks;     // (Co,)
  const float* bias;   // (Co,) or null
  void* out;           // (B, H, W, Co): f32, bf16 or int32
  int B, H, W, Ci, Co, k, out_kind;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float dequant(int acc, float sx, float ks,
                                         const float* bias, int c) {
  float y = __fmul_rn(__int2float_rn(acc), __fmul_rn(sx, ks));
  return bias ? __fadd_rn(y, bias[c]) : y;
}

__global__ void __launch_bounds__(THREADS) int8_conv_kernel(ConvArgs a) {
  __shared__ __align__(16) int8_t As[STAGES][BM * LDS];
  __shared__ __align__(16) int8_t Bs[STAGES][BN * LDS];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int warp_m = warp & 3, warp_n = warp >> 2;

  const long long hw = (long long)a.H * a.W;
  const long long M = (long long)a.B * hw;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int pad = (a.k - 1) / 2;
  const int K = a.k * a.k * a.Ci;
  const int ktiles = K / BK;

  // Loader roles: A rows ar and ar + 64, B row br, each one 16-byte column.
  const int ar = tid >> 2, col16 = (tid & 3) * 16;
  int ab[2], ay[2], ax[2];
  bool aok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long m = m0 + ar + 64 * i;
    aok[i] = m < M;
    const long long mm = aok[i] ? m : 0;
    ab[i] = (int)(mm / hw);
    const int rem = (int)(mm - (long long)ab[i] * hw);
    ay[i] = rem / a.W;
    ax[i] = rem - ay[i] * a.W;
  }
  const int bn = n0 + ar;
  const bool bok = ar < BN && bn < a.Co;

  auto load_tile = [&](int kt, int stage) {
    const int kb = kt * BK;
    const int tap = kb / a.Ci;
    const int ci0 = kb - tap * a.Ci;
    const int dy = tap / a.k - pad, dx = tap % a.k - pad;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int y = ay[i] + dy, x = ax[i] + dx;
      const bool ok = aok[i] && y >= 0 && y < a.H && x >= 0 && x < a.W;
      const int8_t* src = ok
          ? a.x + (((long long)ab[i] * a.H + y) * a.W + x) * a.Ci + ci0 + col16
          : a.x;
      cp_async16(&As[stage][(ar + 64 * i) * LDS + col16], src, ok);
    }
    if (ar < BN) {
      const int8_t* src = bok ? a.w + (long long)bn * K + kb + col16 : a.w;
      cp_async16(&Bs[stage][ar * LDS + col16], src, bok);
    }
  };

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load_tile(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile kt landed; every warp is done with tile kt - 1
    const int nk = kt + STAGES - 1;
    if (nk < ktiles) load_tile(nk, nk % STAGES);
    cp_async_commit();

    const int8_t* as = As[kt % STAGES];
    const int8_t* bs = Bs[kt % STAGES];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int8_t* p = as + (warp_m * 32 + mi * 16 + g) * LDS + kk + t * 4;
        af[mi][0] = lds32(p);
        af[mi][1] = lds32(p + 8 * LDS);
        af[mi][2] = lds32(p + 16);
        af[mi][3] = lds32(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* p = bs + (warp_n * 32 + ni * 8 + g) * LDS + kk + t * 4;
        bf[ni][0] = lds32(p);
        bf[ni][1] = lds32(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
  }
  cp_async_wait<0>();

  // Epilogue: accumulator (mi, ni, r) is row g (+ 8 for r >= 2), columns
  // 2t and 2t + 1 (r even, odd) of the warp's 16 x 8 tile.
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long m = m0 + warp_m * 32 + mi * 16 + g + 8 * half;
      if (m >= M) continue;
      const int b = (int)(m / hw);
      const float sx = a.out_kind == 2 ? 0.f : a.sx[b];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int c = n0 + warp_n * 32 + ni * 8 + 2 * t;
        if (c >= a.Co) continue;  // Co % 16 == 0: c + 1 < Co too
        const int v0 = acc[mi][ni][2 * half], v1 = acc[mi][ni][2 * half + 1];
        const long long o = m * a.Co + c;
        if (a.out_kind == 2) {
          *reinterpret_cast<int2*>(static_cast<int*>(a.out) + o) =
              make_int2(v0, v1);
          continue;
        }
        const float y0 = dequant(v0, sx, a.ks[c], a.bias, c);
        const float y1 = dequant(v1, sx, a.ks[c + 1], a.bias, c + 1);
        if (a.out_kind == 0) {
          *reinterpret_cast<float2*>(static_cast<float*>(a.out) + o) =
              make_float2(y0, y1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(a.out) + o) =
              __floats2bfloat162_rn(y0, y1);
        }
      }
    }
  }
}

}  // namespace

// x: (batch, per_sample) f32 (dtype 0) or bf16 (dtype 1), per_sample % 8 == 0
// and 16-byte aligned rows; q: int8 of the same shape; scale: (batch,) f32;
// scratch: (batch,) 32-bit words, zeroed here. Returns the last CUDA error.
extern "C" int int8_quantize_activations(const void* x, int dtype,
                                         long long batch,
                                         long long per_sample, void* q,
                                         void* scale, void* scratch,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(scratch, 0, batch * sizeof(unsigned int), s);
  if (err != cudaSuccess) return (int)err;
  const long long chunks = per_sample / Q_VEC;
  long long per = (chunks + Q_THREADS - 1) / Q_THREADS;
  if (per > Q_MAX_BLOCKS) per = Q_MAX_BLOCKS;
  if (per < 1) per = 1;
  const dim3 grid((unsigned)per, (unsigned)batch);
  unsigned int* bits = static_cast<unsigned int*>(scratch);
  if (dtype == 0) {
    const float* xf = static_cast<const float*>(x);
    amax_kernel<float><<<grid, Q_THREADS, 0, s>>>(xf, per_sample, bits);
    quantize_kernel<float><<<grid, Q_THREADS, 0, s>>>(
        xf, per_sample, bits, static_cast<int8_t*>(q),
        static_cast<float*>(scale));
  } else {
    const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
    amax_kernel<__nv_bfloat16><<<grid, Q_THREADS, 0, s>>>(xb, per_sample,
                                                          bits);
    quantize_kernel<__nv_bfloat16><<<grid, Q_THREADS, 0, s>>>(
        xb, per_sample, bits, static_cast<int8_t*>(q),
        static_cast<float*>(scale));
  }
  return (int)cudaGetLastError();
}

// x (B, H, W, Ci) int8, w (Co, k, k, Ci) int8, sx (B,) f32, ks (Co,) f32,
// bias (Co,) f32 or null, out (B, H, W, Co): out_kind 0 f32, 1 bf16, 2 the
// int32 accumulator. Needs Ci % 64 == 0, Co % 16 == 0, k odd, 16-byte
// aligned x and w. Returns the last CUDA error.
extern "C" int int8_conv_forward(const void* x, const void* w, const void* sx,
                                 const void* ks, const void* bias, void* out,
                                 int B, int H, int W, int Ci, int Co, int k,
                                 int out_kind, void* stream) {
  ConvArgs a;
  a.x = static_cast<const int8_t*>(x);
  a.w = static_cast<const int8_t*>(w);
  a.sx = static_cast<const float*>(sx);
  a.ks = static_cast<const float*>(ks);
  a.bias = static_cast<const float*>(bias);
  a.out = out;
  a.B = B; a.H = H; a.W = W; a.Ci = Ci; a.Co = Co; a.k = k;
  a.out_kind = out_kind;
  const long long M = (long long)B * H * W;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((Co + BN - 1) / BN));
  int8_conv_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
