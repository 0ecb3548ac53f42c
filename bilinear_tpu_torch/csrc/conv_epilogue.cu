// HRNet's eval epilogue of a convolution on Hopper (sm_90a): kernel K8 of
// the port.
//
// It replaces no Pallas kernel: the JAX package has no HRNet. It was added
// because HRNet's glue around its ~290 cuDNN convolutions (each conv's
// output cast to f32, cuDNN's f32 BN, the cast back, then the ReLUs, the
// residual and exchange adds and the nearest upsamples, each a kernel of
// its own) took ~70% of a served chunk's device time, moving ~4x the bytes
// the arithmetic needs.
//
// One launch computes, over one output tensor (B, H, W, C) in NHWC:
//
//   acc = t_0;  acc = round(acc + t_k) for k = 1 .. n-1;  [acc = relu(acc)]
//
// where each term t_k is a (B, H >> m_k, W >> m_k, C) tensor read at pixel
// (h >> m_k, w >> m_k) (nearest upsampling by 2^m_k, m_k <= 3), optionally
// through its eval BN as round(f32(x) * scale + shift) with the per-channel
// (scale, shift) an f32 (2, C) table. round() is to the element type (bf16
// or f32) and is where the composition it replaces rounds: the BN in f32
// rounded back, each add in the element type. The output is the element
// type, or f32 (the heatmap head, its bias a shift with scale 1).
//
// Bound: bytes. Each term is read once (an upsampled term's pixel is read
// by the 4^m threads that need it, from L2 after the first), the output
// written once, ~5.5 bytes per bf16 output element at a block's two terms.
// Design: a thread owns 8 channels of one output pixel, so every load and
// store is 16 bytes (two for f32), neighbouring threads on neighbouring
// addresses; the (pixel, channel group) split of a thread's index and the
// pixel's (b, h, w) use multiply-shift division (divisors' magic numbers
// computed on the host), the tables are read through the read-only cache.
// No shared memory, no synchronisation, one launch a call.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace conv_epilogue {

constexpr int kMaxTerms = 4;
constexpr int kVec = 8;  // channels a thread owns
constexpr int kThreads = 256;

// n / d for n < 2^31 by a multiply-high and a shift (the magic number of
// Granlund and Montgomery, as PyTorch's IntDivider).
struct FastDiv {
  uint32_t m, s;
};

static FastDiv make_div(uint32_t d) {
  uint32_t s = 0;
  while ((1u << s) < d) ++s;
  const uint64_t one = 1;
  return {(uint32_t)(((one << 32) * ((one << s) - d)) / d + 1), s};
}

__device__ __forceinline__ uint32_t divide(FastDiv f, uint32_t n) {
  return (__umulhi(n, f.m) + n) >> f.s;
}

struct Params {
  const void* x[kMaxTerms];
  const float* affine[kMaxTerms];  // (2, C): scale, shift; null for none
  int m[kMaxTerms];
  void* out;
  int n_terms, relu, h, w, cv;  // cv = C / kVec
  uint32_t total;               // B * H * W * cv
  FastDiv by_cv, by_w, by_h;
};

template <typename T>
__device__ __forceinline__ float rnd(float v);
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
template <>
__device__ __forceinline__ float rnd<float>(float v) {
  return v;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4* q = reinterpret_cast<const float4*>(p);
  float4 a = __ldg(q), b = __ldg(q + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  float4* q = reinterpret_cast<float4*>(p);
  q[0] = make_float4(v[0], v[1], v[2], v[3]);
  q[1] = make_float4(v[4], v[5], v[6], v[7]);
}

template <typename T, typename O>
__global__ void __launch_bounds__(kThreads) epilogue_k(const Params p) {
  const uint32_t v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= p.total) return;
  const uint32_t pix = divide(p.by_cv, v);
  const uint32_t cg = v - pix * p.cv;
  const uint32_t row = divide(p.by_w, pix);  // b * H + h
  const uint32_t w = pix - row * p.w;
  const uint32_t b = divide(p.by_h, row);
  const uint32_t h = row - b * p.h;
  const uint32_t c = (uint32_t)p.cv * kVec;
  float acc[kVec];
#pragma unroll
  for (int k = 0; k < kMaxTerms; ++k) {
    if (k >= p.n_terms) break;
    const int m = p.m[k];
    const uint32_t hm = p.h >> m, wm = p.w >> m;
    const uint64_t at =
        ((uint64_t)(b * hm + (h >> m)) * wm + (w >> m)) * c + cg * kVec;
    float x[kVec];
    load8(static_cast<const T*>(p.x[k]) + at, x);
    if (p.affine[k] != nullptr) {
      float s[kVec], t[kVec];
      load8(p.affine[k] + cg * kVec, s);
      load8(p.affine[k] + c + cg * kVec, t);
#pragma unroll
      for (int i = 0; i < kVec; ++i) x[i] = rnd<T>(fmaf(x[i], s[i], t[i]));
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[i] = k == 0 ? x[i] : rnd<T>(acc[i] + x[i]);
  }
  if (p.relu) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[i] = acc[i] <= 0.f ? 0.f : acc[i];
  }
  store8(static_cast<O*>(p.out) + (uint64_t)v * kVec, acc);
}

}  // namespace conv_epilogue

// flags: bits 0-2 the number of terms (1-4), bit 3 ReLU, bit 4 an f32
// output, bit 5 f32 terms (else bf16), bits 8 + 2k and 9 + 2k term k's m,
// bits 16-23 the device. Returns the launch's cudaError_t.
extern "C" int conv_epilogue_forward(void* out, const void* x0, const void* x1,
                                     const void* x2, const void* x3,
                                     const float* a0, const float* a1,
                                     const float* a2, const float* a3, int b,
                                     int h, int w, int c, int flags,
                                     void* stream) {
  using namespace conv_epilogue;
  Params p;
  const void* xs[kMaxTerms] = {x0, x1, x2, x3};
  const float* as[kMaxTerms] = {a0, a1, a2, a3};
  for (int k = 0; k < kMaxTerms; ++k) {
    p.x[k] = xs[k];
    p.affine[k] = as[k];
    p.m[k] = (flags >> (8 + 2 * k)) & 3;
  }
  p.out = out;
  p.n_terms = flags & 7;
  p.relu = (flags >> 3) & 1;
  p.h = h;
  p.w = w;
  p.cv = c / kVec;
  p.total = (uint32_t)((long long)b * h * w * p.cv);
  p.by_cv = make_div((uint32_t)p.cv);
  p.by_w = make_div((uint32_t)w);
  p.by_h = make_div((uint32_t)h);
  const int device = (flags >> 16) & 255;
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return (int)e;
  if (prev != device && (e = cudaSetDevice(device)) != cudaSuccess)
    return (int)e;
  if (p.total > 0) {
    dim3 grid((p.total + kThreads - 1) / kThreads);
    cudaStream_t s = (cudaStream_t)stream;
    const bool f32_in = (flags >> 5) & 1, f32_out = (flags >> 4) & 1;
    if (f32_in)
      epilogue_k<float, float><<<grid, kThreads, 0, s>>>(p);
    else if (f32_out)
      epilogue_k<__nv_bfloat16, float><<<grid, kThreads, 0, s>>>(p);
    else
      epilogue_k<__nv_bfloat16, __nv_bfloat16><<<grid, kThreads, 0, s>>>(p);
    e = cudaGetLastError();
  }
  if (prev != device) cudaSetDevice(prev);
  return (int)e;
}
