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
// - bulk batches: one launch per layer, each activation making one round
//   trip through device memory while the weights stay in the 50 MB L2. From
//   ops/lifting.py's PERSISTENT_MIN_ROWS up, the encode and the four hidden
//   layers run in gemm_wgmma_persistent (below); under it, and for the
//   decode's 48 f32 columns, lifting_common.cuh's gemm_wgmma (128 x 128
//   tiles, two blocks to an SM): at 2,048 rows or fewer a grid of 128 x 256
//   tiles leaves SMs idle.
//   What bounds a bulk hidden layer: its products, 137 GFLOP at n = 65536
//   (139 us at 989 TFLOP/s), with 256-384 MB of device memory (80-115 us at
//   3.35 TB/s) to flow under them; the card sits at its 700 W limit there,
//   at 1.6-1.7 GHz. So the kernel keeps the tensor cores fed and takes the
//   rest off their path: one block to an SM walks the layer's 128 x 256
//   output tiles (a persistent grid; walking the rows down in every other
//   layer, each layer starts on rows still in L2); one producer thread keeps
//   TMA loads of 64-wide slabs of K in flight into a 3-stage mbarrier ring;
//   two consumer warpgroups multiply (m64n256k16, their registers raised
//   by setmaxnreg); two more threads bring each tile's skip in and its
//   output out by TMA while the products run.
//   How it was chosen, the four hidden layers at n = 65536 on an H100 SXM at
//   700 W: the per-layer gemm_wgmma 1,336 us; this kernel 991 us as first
//   written, against 1,027 us with 2-block clusters multicasting the weight
//   box (no cluster kept) and 1,203 us with the epilogue straight from the
//   registers and a 4-stage ring (the staged epilogue kept). Its epilogue
//   then took 3.5 us of a 14 us tile, bound by conversions (16 a clock an
//   SM): two values to a conversion, the skip and the result moved by
//   ldmatrix / stmatrix and the bias read from shared memory made it 1.3
//   us (2.0 with a skip), and the layers 900 us. Warpgroups kept two slabs
//   apart, so that one's epilogue would run under the other's products,
//   measured no faster (1.074 against 1.067 ms a call), so both finish a
//   tile together. A skip fetched from the tile's 8th slab on, not at its
//   start, saved 9 us a skip layer; the alternating direction 4% of a
//   call. A non-skip hidden layer takes 202-231 us there, cuBLAS's bare
//   65536 x 1024 x 1024 bf16 product 192-195 us in the same runs.
// - serving batches: ONE cooperative launch of a persistent kernel whose
//   blocks each own 64 x 64 output tiles of a layer and meet at a grid
//   barrier between layers, activations going through L2-resident scratch.
//   Six launches become one.
// Every path multiplies with the same instruction family, k16 step after
// k16 step in k order into f32 accumulators, and rounds where the TPU
// kernel rounds, so a row's bits do not depend on its batch or its path.
// The weights come K-contiguous ((out, in), made once per checkpoint by
// prepare_weights).
// - f32 mode (LiftingServer(dtype=float32)): a register-tiled SIMT GEMM per
//   layer with true f32 FMAs (no TF32): 256 threads, each TM x TN outputs
//   (8 x 8 on a 128 x 128 tile at bulk size), float4 shared-memory reads, a
//   3-stage cp.async ring; the weights stay (in, out).
#include <cuda.h>  // CUtensorMap; the encoder is looked up at run time

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

// ---- bf16 bulk layers: the persistent TMA kernel -----------------------------

// mbarriers and TMA, by PTX. A wait that lasts seconds is a fault of the
// schedule: it traps, so the launch fails where it would have hung.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ bool mbar_test(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}
// Waits for the phase of parity `parity` to complete.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_test(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_test(bar, parity))
    if (clock64() - t0 > (1ll << 33)) __trap();
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map))
               : "memory");
}
// Box (c0, c1) of `map` to shared memory at dst, counted on barrier `bar`;
// elements past the tensor's edge arrive as zeros, and count all the same.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
// Shared memory at src to box (c0, c1) of `map`; rows past the tensor's end
// are not written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, int c0,
                                          int c1, uint32_t src) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], "
      "[%3];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(src)
      : "memory");
}
// Four 8 x 8 b16 blocks to shared memory: lane l gives the address of row
// l % 8 of block l / 8; r[i] is this thread's part of block i (the layout of
// ldmatrix and of a wgmma accumulator's 8-column groups).
__device__ __forceinline__ void stmatrix_x4(uint32_t addr,
                                            const uint32_t (&r)[4]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
          addr),
      "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
      : "memory");
}

// A bulk layer n x 1024 = round(relu(A @ W^T + b)) [+ skip, round], K 1024
// or the encode's 32. Output tiles of BM x BN; a ring of STAGES slabs of
// 64 values of K (A 128 x 64, W 256 x 64); each consumer warpgroup's rows of
// the finished tile (64 x 256 bf16) staged in its half of the epilogue
// buffer, the layer's bias beside it.
struct Persist {
  static constexpr int BM = 128, BN = 256, STAGES = 3, THREADS = 384;
  static constexpr int TILES_N = HID / BN;
  static constexpr int A_BYTES = BM * 128, B_BYTES = BN * 128;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int BOX = 64 * 128;          // 64 rows x 64 columns
  static constexpr int HALF = BOX * (BN / 64);  // a warpgroup's rows, bf16
  static constexpr int BIAS = HID * 4;
  static constexpr int SKIP_AT = 7;  // the slab after which a skip is fetched
  static constexpr int BARS = 8 * (2 * STAGES + 6);
  static constexpr int SMEM = 1024 + STAGES * STAGE + 2 * HALF + BIAS + BARS;
  static_assert(SMEM <= 232448, "one block to an SM");
};

struct PersistLayer {
  CUtensorMap a;     // (M, K) input, boxes of 128 rows x 64
  CUtensorMap b;     // (1024, K) K-contiguous weight, 256 x 64
  CUtensorMap skip;  // (M, 1024) residual, 64 x 64 (read when has_skip)
  CUtensorMap out;   // (M, 1024) output, 64 x 64
  const float* bias;
  int K;
  int has_skip;
  int tiles;         // ceil(M / BM) x TILES_N
  int reverse;       // tiles from the last rows down
};

// Tile t: rows m0.., columns n0.. (the column tiles of a row tile adjacent).
__device__ __forceinline__ void persist_tile(const PersistLayer& L, int t,
                                             int& m0, int& n0) {
  if (L.reverse) t = L.tiles - 1 - t;
  m0 = t / Persist::TILES_N * Persist::BM;
  n0 = t % Persist::TILES_N * Persist::BN;
}

// One thread: every k-slab of every tile of this block into the ring.
__device__ void persist_produce(const PersistLayer& L, uint32_t ring,
                                uint32_t full0, uint32_t empty0) {
  using C = Persist;
  prefetch_map(&L.a);
  prefetch_map(&L.b);
  int stage = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < L.tiles; t += gridDim.x) {
    int m0, n0;
    persist_tile(L, t, m0, n0);
    for (int s = 0; s < (L.K + 63) / 64; ++s) {
      mbar_wait(empty0 + 8 * stage, phase ^ 1);
      const uint32_t st = ring + stage * C::STAGE, full = full0 + 8 * stage;
      mbar_expect(full, C::STAGE);
      tma_load(st, &L.a, s * 64, m0, full);
      tma_load(st + C::A_BYTES, &L.b, s * 64, n0, full);
      if (++stage == C::STAGES) stage = 0, phase ^= 1;
    }
  }
}

// One thread per consumer warpgroup: the skip of its rows of each tile into
// its half of the epilogue buffer while the warpgroup multiplies, once it is
// past slab SKIP_AT (fetched at the tile's start, the skip cost a skip layer
// 9 us more on an H100); without a skip, word that the half is free. Then
// its finished rows out by TMA once the warpgroup has staged them.
__device__ void persist_io(const PersistLayer& L, uint32_t half, uint32_t ready,
                           uint32_t staged, uint32_t mid, int wg) {
  using C = Persist;
  prefetch_map(&L.out);
  if (L.has_skip) prefetch_map(&L.skip);
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < L.tiles; t += gridDim.x, phase ^= 1) {
    int m0, n0;
    persist_tile(L, t, m0, n0);
    m0 += 64 * wg;
    if (L.has_skip) {
      mbar_wait(mid, phase);
      mbar_expect(ready, C::HALF);
      for (int b = 0; b < C::BN / 64; ++b)
        tma_load(half + b * C::BOX, &L.skip, n0 + 64 * b, m0, ready);
    } else {
      mbar_arrive(ready);
    }
    mbar_wait(staged, phase);
    for (int b = 0; b < C::BN / 64; ++b)
      tma_store(&L.out, n0 + 64 * b, m0, half + b * C::BOX);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Warpgroup wg, rows 64 wg.. of each tile: the slabs' m64n256k16 products in
// k order, one accumulator chain an output, as gemm_tile; then bias, ReLU,
// rounding and the skip, as Epilogue<bf16>::finish, into its half of the
// epilogue buffer in the TMA's 128-byte swizzled layout.
__device__ void persist_consume(const PersistLayer& L, const unsigned char* ring,
                                uint32_t half, const float* bias, uint32_t full0,
                                uint32_t empty0, uint32_t ready, uint32_t staged,
                                uint32_t mid, int wg) {
  using C = Persist;
  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31, q = lane & 3;
  // ldmatrix / stmatrix: lane l names row l % 8 of 8 x 8 block l / 8, the
  // blocks being rows +0 / +8 of column groups j / j + 1.
  const int brow = warp * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
  int stage = 0;
  uint32_t phase = 0, ephase = 0;
  float acc[C::BN / 2];
#pragma unroll
  for (int i = 0; i < C::BN / 2; ++i) acc[i] = 0.0f;
  for (int tile = blockIdx.x; tile < L.tiles; tile += gridDim.x, ephase ^= 1) {
    int m0, n0;
    persist_tile(L, tile, m0, n0);
    int prev = 0;
    for (int s = 0; s < (L.K + 63) / 64; ++s) {
      const int steps = min(4, (L.K - 64 * s) >> 4);
      mbar_wait(full0 + 8 * stage, phase);
      const unsigned char* st = ring + stage * C::STAGE;
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (kk < steps)
          wg::Mma<C::BN, 0, 0>::run(
              acc, wg::desc(st + wg * 8192 + kk * 32, 16, 1024),
              wg::desc(st + C::A_BYTES + kk * 32, 16, 1024), (s != 0 || kk != 0));
      wg::commit();
      wg::wait<1>();  // the previous slab's products are done
      if (s > 0 && t == 0) mbar_arrive(empty0 + 8 * prev);
      if (L.has_skip && s == C::SKIP_AT && t == 0) mbar_arrive(mid);
      prev = stage;
      if (++stage == C::STAGES) stage = 0, phase ^= 1;
    }
    wg::wait<0>();
    if (t == 0) mbar_arrive(empty0 + 8 * prev);

    mbar_wait(ready, ephase);  // the skip has landed; the half is free
    // Column groups j, j + 1 at a time: the skip's four 8 x 8 blocks in one
    // ldmatrix, the bias in one 16-byte read, the result in one stmatrix.
    // pack_bf16x2 rounds two values in one conversion, the same
    // round-to-nearest-even as rnd<bf16> value by value.
#pragma unroll
    for (int j = 0; j < C::BN / 8; j += 2) {
      const int jl = j + (lane >> 4);
      const uint32_t addr = half + (uint32_t)(jl >> 3) * C::BOX + brow * 128 +
                            ((((uint32_t)jl & 7) ^ (lane & 7)) << 4);
      const float4 b = *reinterpret_cast<const float4*>(
          bias + ((n0 + 8 * j) / 16 * 4 + q) * 4);
      const float bb[8] = {b.x, b.y, b.x, b.y, b.z, b.w, b.z, b.w};
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[i] = pack_bf16x2(
            fmaxf(__fadd_rn(acc[4 * j + 2 * i], bb[2 * i]), 0.0f),
            fmaxf(__fadd_rn(acc[4 * j + 2 * i + 1], bb[2 * i + 1]), 0.0f));
      if (L.has_skip) {
        uint32_t sk[4];
        wg::ldmatrix_x4(sk, addr);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float y0, y1, s0, s1;
          unpack_bf16x2(w[i], y0, y1);
          unpack_bf16x2(sk[i], s0, s1);
          w[i] = pack_bf16x2(__fadd_rn(y0, s0), __fadd_rn(y1, s1));
        }
      }
      stmatrix_x4(addr, w);
    }
    wg::fence_async_shared();  // the staged rows, visible to the TMA store
    mbar_arrive(staged);
  }
}

// Persistent: block b walks tiles b, b + grid, ... Warpgroup 0 loads with
// few registers (thread 0: the ring; threads 32 and 64: each consumer
// warpgroup's skips and stores); warpgroups 1 and 2 multiply. The paths
// never meet again.
__global__ void __launch_bounds__(Persist::THREADS, 1)
gemm_wgmma_persistent(const __grid_constant__ PersistLayer L) {
  using C = Persist;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align_ring(smem_raw);
  unsigned char* ebuf = ring + C::STAGES * C::STAGE;
  float* bias = reinterpret_cast<float*>(ebuf + 2 * C::HALF);
  const uint32_t full0 = smem_u32(bias + HID);
  const uint32_t empty0 = full0 + 8 * C::STAGES;
  // Per consumer warpgroup: ready, staged, mid.
  const uint32_t wgbars = empty0 + 8 * C::STAGES;
  if (threadIdx.x == 0) {
    for (int i = 0; i < C::STAGES; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, 2);  // each consumer warpgroup
    }
    for (int w = 0; w < 2; ++w) {
      mbar_init(wgbars + 24 * w, 1);
      mbar_init(wgbars + 24 * w + 8, 128);
      mbar_init(wgbars + 24 * w + 16, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Column c = 16 p + 8 h + 2 q + e at ((p * 4 + q) * 4 + 2 h + e): a
  // thread's bias for two column groups is one 16-byte read.
  for (int c = threadIdx.x; c < HID; c += C::THREADS)
    bias[((c >> 4) * 4 + ((c >> 1) & 3)) * 4 + ((c >> 3) & 1) * 2 + (c & 1)] =
        L.bias[c];
  __syncthreads();
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      persist_produce(L, smem_u32(ring), full0, empty0);
    } else if (threadIdx.x == 32 || threadIdx.x == 64) {
      const int w = threadIdx.x / 32 - 1;
      const uint32_t bars = wgbars + 24 * w;
      persist_io(L, smem_u32(ebuf + w * C::HALF), bars, bars + 8, bars + 16, w);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    // Uniform over each warp as the compiler sees it: wgmma in a path it
    // takes for divergent would be serialized.
    const int w = __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 7) - 1, 0);
    const uint32_t bars = wgbars + 24 * w;
    persist_consume(L, ring, smem_u32(ebuf + w * C::HALF), bias, full0, empty0,
                    bars, bars + 8, bars + 16, w);
  }
}

// cuTensorMapEncodeTiled, found at run time by the runtime's entry-point query
// (no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline cudaError_t encoder(EncodeTiled* out) {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess) return e;
    if (q != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorNotSupported;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  *out = fn;
  return cudaSuccess;
}

// A row-major (rows, cols) bf16 matrix in boxes of box_rows x 64 columns
// (128 bytes, 128-byte swizzled: wgmma's layout).
inline cudaError_t map_rows(EncodeTiled enc, CUtensorMap* map, const void* base,
                            int rows, int cols, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                   const_cast<void*>(base), dims, strides, box, unit,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// One bf16 layer with 1024 outputs and ReLU (the encode or a hidden layer)
// through the persistent kernel: its tensor maps, encoded per call, and a
// grid of at most one block per SM. reverse: tiles from the last rows down.
inline cudaError_t launch_persist(const Layer<bf16>& L, cudaStream_t stream,
                                  bool reverse) {
  using C = Persist;
  EncodeTiled enc;
  cudaError_t e = encoder(&enc);
  PersistLayer p = {};
  if (e == cudaSuccess) e = map_rows(enc, &p.a, L.A, L.M, L.K, C::BM);
  if (e == cudaSuccess) e = map_rows(enc, &p.b, L.B, HID, L.K, C::BN);
  if (e == cudaSuccess)
    e = map_rows(enc, &p.skip, L.ep.skip ? L.ep.skip : L.ep.out, L.M, HID, 64);
  if (e == cudaSuccess) e = map_rows(enc, &p.out, L.ep.out, L.M, HID, 64);
  if (e != cudaSuccess) return e;
  p.bias = L.ep.bias;
  p.K = L.K;
  p.has_skip = L.ep.skip != nullptr;
  p.tiles = (L.M + C::BM - 1) / C::BM * C::TILES_N;
  p.reverse = reverse;

  auto kernel = gemm_wgmma_persistent;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           C::SMEM);
  if (e != cudaSuccess) return e;
  static int resident_on[64] = {};  // by device: blocks that fit at once
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int& resident = resident_on[dev & 63];
  if (resident == 0) {
    e = resident_blocks(kernel, C::THREADS, C::SMEM, &resident);
    if (e != cudaSuccess) return e;
    if (resident < 1) return cudaErrorLaunchOutOfResources;
  }
  kernel<<<p.tiles < resident ? p.tiles : resident, C::THREADS, C::SMEM,
           stream>>>(p);
  return cudaSuccess;
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
// layer, 1 the one-launch serving kernel, 2 one launch per layer with the
// encode and hidden layers in the persistent kernel (1 and 2 bf16 only).
// Returns the first CUDA error, or cudaGetLastError().

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
    if (path < 0 || path > 2) return (int)cudaErrorInvalidValue;
    if (path == 1) {
      e = launch_persistent(lifting_chain_wgmma, c, serve_tiles(n, HID), s);
    } else {
      // Path 2 walks the rows down in the encode and the second layer of
      // each block, up in the others, so that every layer starts on the
      // rows the layer before it touched last, most of which are still in
      // L2 (-4% of a call on the card).
      for (int l = 0; l < 5 && e == cudaSuccess; ++l)
        e = path == 2 ? launch_persist(c.hid[l], s, l % 2 == 0)
                      : launch_bulk<bf16, bf16>(c.hid[l], s);
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
