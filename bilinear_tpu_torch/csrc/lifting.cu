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
// bytes of rows plus 8.6 MB of bf16 weights. At n = 65536 the tensor-core
// rate is the bound (0.57 ms in bf16); at a serving batch (n <= 256) the
// weight read and, in practice, the launches are.
//
// Design. The TPU kernel keeps all weights in VMEM and runs a 512-row tile
// through all six layers. An SM cannot do that at bulk size
// (lifting_common.cuh has the shared-memory and L2 arithmetic), so:
// - bulk batches: one wgmma GEMM per layer (128 x 128 block tile, two blocks
//   to an SM; cp.async ring, bias + ReLU + rounding + skip in the epilogue),
//   each activation making one
//   round trip through device memory per layer while the weights stay in
//   the 50 MB L2;
// - serving batches: ONE cooperative launch of a persistent kernel whose
//   blocks each own 64 x 64 output tiles of a layer and meet at a grid
//   barrier between layers, activations going through L2-resident scratch.
//   Six launches become one.
// Both paths multiply with the same instruction family in the same k order,
// so a row's bits do not depend on its batch. The weights come K-contiguous
// ((out, in), made once per checkpoint by prepare_weights).
// - f32 mode (LiftingServer(dtype=float32)): a register-tiled SIMT GEMM per
//   layer with true f32 FMAs (no TF32): 256 threads, each TM x TN outputs
//   (8 x 8 on a 128 x 128 tile at bulk size), float4 shared-memory reads, a
//   3-stage cp.async ring; the weights stay (in, out).
#include "lifting_common.cuh"

namespace lifting {

namespace cg = cooperative_groups;

// ---- f32: SIMT ---------------------------------------------------------------

// 256 threads as 16 x 16; thread (ty, tx) owns rows ty * TM + i and columns
// g * 64 + tx * 4 + c (g < TN / 4, c < 4), so that a quarter warp's float4
// reads of a B row are consecutive.
template <int TM, int TN>
struct Simt {
  static constexpr int BM = 16 * TM, BN = 16 * TN, BK = 16, STAGES = 3;
  static constexpr int LDA = BK + 4;  // floats; rows stay 16-byte aligned
  static constexpr int A_FLOATS = BM * LDA, B_FLOATS = BK * BN;
  static constexpr int SMEM = STAGES * (A_FLOATS + B_FLOATS) * 4;
};

template <int TM, int TN>
__global__ void __launch_bounds__(256)
gemm_f32(const __grid_constant__ Layer<float> L) {
  using C = Simt<TM, TN>;
  extern __shared__ __align__(16) unsigned char smem_f32[];
  float* As = reinterpret_cast<float*>(smem_f32);
  float* Bs = As + C::STAGES * C::A_FLOATS;
  const float* __restrict__ A = static_cast<const float*>(L.A);
  const float* __restrict__ B = static_cast<const float*>(L.B);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int tiles_n = (L.N + C::BN - 1) / C::BN;
  const int m0 = (int)(blockIdx.x / tiles_n) * C::BM;
  const int n0 = (int)(blockIdx.x % tiles_n) * C::BN;
  const int ktiles = L.K / C::BK;

  auto fetch = [&](int kt) {
    if (kt < ktiles) {
      const int st = kt % C::STAGES, k0 = kt * C::BK;
      const uint32_t as = (uint32_t)__cvta_generic_to_shared(As + st * C::A_FLOATS);
      const uint32_t bs = (uint32_t)__cvta_generic_to_shared(Bs + st * C::B_FLOATS);
      for (int c = tid; c < C::BM * 4; c += 256) {
        const int row = c >> 2, ch = c & 3;
        const bool ok = m0 + row < L.M;
        cp16z(as + (row * C::LDA + ch * 4) * 4,
              A + (ok ? (size_t)(m0 + row) * L.K + k0 + ch * 4 : 0), ok);
      }
      for (int c = tid; c < C::BK * (C::BN / 4); c += 256) {
        const int kr = c / (C::BN / 4), ch = c % (C::BN / 4);
        const bool ok = n0 + ch * 4 < L.N;
        cp16z(bs + (kr * C::BN + ch * 4) * 4,
              B + (ok ? (size_t)(k0 + kr) * L.N + n0 + ch * 4 : 0), ok);
      }
    }
    cp_commit();
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  fetch(0);
  fetch(1);
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_wait<1>();
    __syncthreads();  // slice kt landed; slice kt - 1 is no longer read
    fetch(kt + 2);
    const float* as = As + (kt % C::STAGES) * C::A_FLOATS + ty * TM * C::LDA;
    const float* bs = Bs + (kt % C::STAGES) * C::B_FLOATS + tx * 4;
#pragma unroll
    for (int kq = 0; kq < C::BK / 4; ++kq) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(as + i * C::LDA + kq * 4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float b[TN];
#pragma unroll
        for (int g = 0; g < TN / 4; ++g) {
          float4 t = *reinterpret_cast<const float4*>(
              bs + (kq * 4 + kk) * C::BN + g * 64);
          b[4 * g] = t.x, b[4 * g + 1] = t.y, b[4 * g + 2] = t.z,
                b[4 * g + 3] = t.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y
                         : kk == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av, b[j], acc[i][j]);
        }
      }
    }
  }
  cp_wait<0>();

#pragma unroll
  for (int g = 0; g < TN / 4; ++g) {
    const int col = n0 + g * 64 + tx * 4;
    if (col >= L.N) continue;
    Epilogue<float>::Cols<4> cols;
    L.ep.load_cols<4>(m0, col, cols);
    float sk[TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      if (m0 + ty * TM + i < L.M)
        L.ep.load_skip<4>((size_t)(m0 + ty * TM + i) * L.N + col, sk[i]);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = m0 + ty * TM + i;
      if (row >= L.M) break;
      float y[4] = {acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
                    acc[i][4 * g + 3]};
      L.ep.finish<4>((size_t)row * L.N + col, y, cols, sk[i]);
    }
  }
}

template <int TM, int TN>
inline cudaError_t launch_f32_tile(const Layer<float>& L, cudaStream_t stream) {
  using C = Simt<TM, TN>;
  auto kernel = gemm_f32<TM, TN>;
  cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return attr;
  const unsigned tiles = (unsigned)((L.M + C::BM - 1) / C::BM) *
                         (unsigned)((L.N + C::BN - 1) / C::BN);
  kernel<<<tiles, 256, C::SMEM, stream>>>(L);
  return cudaSuccess;
}

// The tile follows the row count: enough blocks to spread a serving batch
// over the SMs, the most products per shared-memory read at bulk size. Every
// tile sums k in the same order with the same FMA, so rows stay bit-equal.
inline cudaError_t launch_f32(const Layer<float>& L, cudaStream_t stream) {
  if (L.M <= 512) return launch_f32_tile<2, 4>(L, stream);
  if (L.M <= 4096) return launch_f32_tile<4, 4>(L, stream);
  return launch_f32_tile<8, 8>(L, stream);
}

// ---- the six layers ----------------------------------------------------------

template <typename W>
Layer<W> dense(const void* A, const void* B, int M, int N, int K,
               const float* bias, const W* skip, W* out, int relu) {
  Layer<W> L = {};
  L.A = A, L.B = B, L.M = M, L.N = N, L.K = K;
  L.ep.bias = bias;
  L.ep.skip = skip;
  L.ep.out = out;
  L.ep.relu = relu;
  L.ep.group_rows = 1 << 30;
  return L;
}

// h0, h1, h2: (n, 1024) scratch in the working type T.
template <typename T>
struct Chain {
  Layer<T> hid[5];   // encode and the four hidden layers
  Layer<float> dec;
};

template <typename T>
Chain<T> make_chain(const T* x, const void* const* w, const float* const* b,
                    float* out, T* h0, T* h1, T* h2, int n) {
  Chain<T> c;
  c.hid[0] = dense<T>(x, w[0], n, HID, IN_F, b[0], nullptr, h0, 1);  // encode
  c.hid[1] = dense<T>(h0, w[1], n, HID, HID, b[1], nullptr, h1, 1);
  c.hid[2] = dense<T>(h1, w[2], n, HID, HID, b[2], h0, h2, 1);  // + skip
  c.hid[3] = dense<T>(h2, w[3], n, HID, HID, b[3], nullptr, h0, 1);
  c.hid[4] = dense<T>(h0, w[4], n, HID, HID, b[4], h2, h1, 1);  // + skip
  c.dec = dense<float>(h1, w[5], n, OUT_F, HID, b[5], nullptr, out, 0);
  return c;
}

// The serving batch: all six layers in one cooperative launch.
__global__ void __launch_bounds__(ServeTile::THREADS)
lifting_chain_wgmma(const __grid_constant__ Chain<bf16> c) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align_ring(smem_raw);
  cg::grid_group grid = cg::this_grid();
  for (int l = 0; l < 5; ++l) {
    serve_layer<bf16, bf16>(c.hid[l], ring);
    grid.sync();
  }
  serve_layer<bf16, float>(c.dec, ring);
}

}  // namespace lifting

// C entry. is_bf16: 1 for bf16 tensors, 0 for f32. Weights in the working
// type: K-contiguous (out, in) for bf16, (in, out) row-major for f32; biases
// f32. h0..h2: (n, 1024) scratch in the working type. path: 0 one launch per
// layer, 1 the one-launch serving kernel (bf16 only). Returns the first CUDA
// error, or cudaGetLastError().
extern "C" int lifting_forward(int is_bf16, const void* x, const void* w0,
                               const void* b0, const void* w1, const void* b1,
                               const void* w2, const void* b2, const void* w3,
                               const void* b3, const void* w4, const void* b4,
                               const void* w5, const void* b5, void* out,
                               void* h0, void* h1, void* h2, int n, int path,
                               void* stream) {
  using namespace lifting;
  const float* b[6] = {(const float*)b0, (const float*)b1, (const float*)b2,
                       (const float*)b3, (const float*)b4, (const float*)b5};
  const void* w[6] = {w0, w1, w2, w3, w4, w5};
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaSuccess;
  if (is_bf16) {
    Chain<bf16> c = make_chain<bf16>((const bf16*)x, w, b, (float*)out,
                                     (bf16*)h0, (bf16*)h1, (bf16*)h2, n);
    if (path == 1) {
      e = launch_persistent(lifting_chain_wgmma, c, serve_tiles(n, HID), s);
    } else {
      for (int l = 0; l < 5 && e == cudaSuccess; ++l)
        e = launch_bulk<bf16, bf16>(c.hid[l], s);
      if (e == cudaSuccess) e = launch_bulk<bf16, float>(c.dec, s);
    }
  } else {
    if (path != 0) return (int)cudaErrorInvalidValue;
    Chain<float> c = make_chain<float>((const float*)x, w, b, (float*)out,
                                       (float*)h0, (float*)h1, (float*)h2, n);
    for (int l = 0; l < 5 && e == cudaSuccess; ++l) e = launch_f32(c.hid[l], s);
    if (e == cudaSuccess) e = launch_f32(c.dec, s);
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
