// Lifting forward (kernel K1 of the port): the whole BilinearUnit eval
// forward, with BN folded into each Linear and dropout as the identity:
//   h = dense_relu(x, W0)          encode 32 -> 1024
//   2 x { skip = h; h = dense_relu(h, W1); h = dense_relu(h, W2);
//         h = round(h + skip) }    residual blocks 1024 -> 1024
//   out = h @ W5 + b5              decode 1024 -> 48, f32
// dense_relu(h, W) = round(relu(h @ W + b)), f32 accumulation, rounded to the
// working type (bf16 or f32) exactly where the TPU kernel rounds.
//
// Replaces: bilinear_tpu/ops/pallas/lifting.py::_kernel (the pallas_call in
// _run, entered through lifting_forward).
//
// What bounds it on an H100: 2 n 4,276,224 FLOPs against n (32 * 2 + 48 * 4)
// bytes of rows plus 8.6 MB of bf16 weights. At serving batches (n = 256)
// the weight read dominates; at n = 65536 the tensor-core rate does.
//
// Design: the TPU kernel keeps all weights in VMEM and streams row tiles;
// an SM's 227 KB of shared memory cannot hold them, but the 50 MB L2 can.
// This first version launches one tiled tensor-core GEMM per layer
// (lifting_common.cuh) with bias + ReLU + rounding + skip fused into the
// epilogue, so each weight matrix is read from L2 by every row block and
// each activation (n x 1024 in the working type) makes one round trip
// through device memory per layer. The ragged edge is masked, not padded.
// The f32 mode (LiftingServer(dtype=float32)) uses a plain FMA tiled GEMM.
#include "lifting_common.cuh"

namespace lifting {

// f32 SIMT GEMM: 64 x 64 block tile, 16-deep K slices, 256 threads each
// computing a 4 x 4 patch with FMAs.
constexpr int FBM = 64, FBN = 64, FBK = 16;

__global__ void __launch_bounds__(256)
gemm_f32(const float* __restrict__ A, const float* __restrict__ B, int M,
         int N, int K, Epilogue<float> ep) {
  __shared__ float As[FBK][FBM];
  __shared__ float Bs[FBK][FBN];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int m0 = blockIdx.x * FBM, n0 = blockIdx.y * FBN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += FBK) {
    for (int e = threadIdx.x; e < FBM * FBK; e += 256) {
      int r = e / FBK, k = e % FBK;
      As[k][r] = (m0 + r < M) ? A[(size_t)(m0 + r) * K + k0 + k] : 0.0f;
    }
    for (int e = threadIdx.x; e < FBK * FBN; e += 256) {
      int k = e / FBN, c = e % FBN;
      Bs[k][c] = (n0 + c < N) ? B[(size_t)(k0 + k) * N + n0 + c] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FBK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int row = m0 + ty * 4 + i, col = n0 + tx * 4 + j;
      if (row < M && col < N) ep.apply(row, col, N, acc[i][j]);
    }
}

template <typename T>
Epilogue<T> dense(const float* bias, const T* skip, T* out, int relu) {
  Epilogue<T> ep = {};
  ep.bias = bias;
  ep.skip = skip;
  ep.out = out;
  ep.relu = relu;
  ep.group_rows = 1;
  return ep;
}

inline void gemm(const bf16* A, const bf16* B, int M, int N, int K,
                 const Epilogue<bf16>& ep, cudaStream_t s) {
  launch_gemm_tc<bf16, bf16, bf16>(A, B, M, N, K, ep, s);
}
inline void gemm(const bf16* A, const bf16* B, int M, int N, int K,
                 const Epilogue<float>& ep, cudaStream_t s) {
  launch_gemm_tc<bf16, bf16, float>(A, B, M, N, K, ep, s);
}
inline void gemm(const float* A, const float* B, int M, int N, int K,
                 const Epilogue<float>& ep, cudaStream_t s) {
  dim3 grid((M + FBM - 1) / FBM, (N + FBN - 1) / FBN);
  gemm_f32<<<grid, 256, 0, s>>>(A, B, M, N, K, ep);
}

// The six layers. h0, h1, h2: (n, 1024) scratch in the working type.
template <typename T>
int forward(const T* x, const T* const* w, const float* const* b, float* out,
            T* h0, T* h1, T* h2, int n, cudaStream_t s) {
  const int H = 1024, IN = 32, OUT = 48;
  gemm(x, w[0], n, H, IN, dense<T>(b[0], nullptr, h0, 1), s);   // encode
  gemm(h0, w[1], n, H, H, dense<T>(b[1], nullptr, h1, 1), s);
  gemm(h1, w[2], n, H, H, dense<T>(b[2], h0, h2, 1), s);        // + skip
  gemm(h2, w[3], n, H, H, dense<T>(b[3], nullptr, h0, 1), s);
  gemm(h0, w[4], n, H, H, dense<T>(b[4], h2, h1, 1), s);        // + skip
  gemm(h1, w[5], n, OUT, H, dense<float>(b[5], nullptr, out, 0), s);
  return (int)cudaGetLastError();
}

}  // namespace lifting

// C entry. is_bf16: 1 for bf16 tensors, 0 for f32. Weights (in, out)
// row-major in the working type, biases f32. Returns cudaGetLastError().
extern "C" int lifting_forward(int is_bf16, const void* x, const void* w0,
                               const void* b0, const void* w1, const void* b1,
                               const void* w2, const void* b2, const void* w3,
                               const void* b3, const void* w4, const void* b4,
                               const void* w5, const void* b5, void* out,
                               void* h0, void* h1, void* h2, int n,
                               void* stream) {
  const float* b[6] = {(const float*)b0, (const float*)b1, (const float*)b2,
                       (const float*)b3, (const float*)b4, (const float*)b5};
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    using lifting::bf16;
    const bf16* w[6] = {(const bf16*)w0, (const bf16*)w1, (const bf16*)w2,
                        (const bf16*)w3, (const bf16*)w4, (const bf16*)w5};
    return lifting::forward<bf16>((const bf16*)x, w, b, (float*)out,
                                  (bf16*)h0, (bf16*)h1, (bf16*)h2, n, s);
  }
  const float* w[6] = {(const float*)w0, (const float*)w1, (const float*)w2,
                       (const float*)w3, (const float*)w4, (const float*)w5};
  return lifting::forward<float>((const float*)x, w, b, (float*)out,
                                 (float*)h0, (float*)h1, (float*)h2, n, s);
}
