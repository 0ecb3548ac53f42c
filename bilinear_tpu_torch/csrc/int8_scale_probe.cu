// The int8 scale probe's two chains (kernel K5 of the port): K2's int8
// lifting forward with the activation-scale work changed, to measure what
// that work costs. (n, 32) bf16 -> (n, 48) f32.
//   fixed: K2's static chain with ONE constant scale s for all four hidden
//          layers, quantised by a product: hq = clip(rint(h * r), -127, 127)
//          with r = f32(1 / s) (20.0 for s = 0.05), not K2's true division;
//          dequantised as relu(acc * (s * ws) + b), the scales' product
//          first; skips after hidden layers 1 and 3, out = bf16(h) @ dec_w
//          + dec_b.
//   mxu:   h = x @ enc_w + enc_b (no ReLU); hq = h converted to int8 as XLA
//          converts (truncated toward zero, saturated to [-128, 127], NaN
//          0); four times hq = int8(hq @ wq) modulo 256 (no scale, bias,
//          ReLU or skip); out = bf16(hq) @ dec_w + dec_b. A ceiling of the
//          chain's products, not a result.
//
// Replaces: benchmarks/int8_scale_probe.py::_kernel_fixed and _kernel_mxu
// (the pallas_call in _run, :117). The probe's third body, K2's dynamic
// _kernel, is K2 itself (ops/lifting_int8.py::_launch with its group rows).
//
// What bounds it on an H100: the products, 2 n 4 * 1024^2 int8 operations
// at 1,979 TOP/s plus encode and decode at the bf16 rate (0.29 ms at n =
// 65536); rows in and out are n (32 * 2 + 48 * 4) bytes. Every 64 rows need
// the whole 4.4 MB weight stream from L2, and fixed's epilogue (dequantise,
// ReLU, skip, requantise) costs about as much issue time per value as its
// share of the products: those two, not device memory, set its time.
//
// Design: one launch per call at every n, one block per SM, the whole
// chain fused (PERF.md, PR 14, holds the measurements behind each choice).
// - A block owns 64 rows (one wgmma row tile) through all six layers; in
//   int8 two 64-row activations (64 KB each) fit beside a weight ring.
//   Clusters of CL = 2 blocks walk over tiles of 2 x 64 rows (cluster k takes
//   tiles k, k + clusters, ...; a block past the last row computes on zero
//   rows and stores nothing). Keep in step with
//   ops/int8_scale_probe.py::plan_probe. Two, not four: an H100 holds 66
//   clusters of 2 (132 SMs) but 30 of 4 (120), and clusters of 4 measured
//   slower although they read half as much from L2.
// - Activations never leave shared memory: a layer reads one buffer (eight
//   128-byte swizzled K slabs of 64 rows, the layout wgmma reads) and its
//   epilogue writes its int8 values straight from the accumulators into the
//   other. The encode's x tile sits in the buffer the encode does not write.
// - Weights arrive as one stream, the same for every tile: pre-swizzled once
//   per checkpoint into the exact shared-memory image of each stage
//   (ops/int8_scale_probe.py::weight_image), 128 output columns x 128 bytes
//   of K per stage, a ring of STAGES. One producer thread per block copies
//   half of each stage with cp.async.bulk multicast to both blocks of its
//   cluster, so one L2 read feeds two SMs. A stage is refilled once each
//   block's consumer of it has released it (empty barriers of CL arrivals).
//   The producer runs ahead across layer boundaries.
// - Two consumer warpgroups take alternate passes: pass p (128 output
//   columns over all of K, KSLABS stages, m64n128k32 s8; bf16 m64n128k16 for
//   the encode) belongs to warpgroup p % 2, so one's epilogue runs under the
//   other's products. A parity wait tells only two phases of a slot apart,
//   so a warpgroup starts waiting for its pass's stages only once the other
//   has seen the previous pass's land (the order barriers). Layers meet at a
//   barrier of the two warpgroups.
// - fixed's epilogue operands (bias, s * ws, the skip) are loaded before the
//   pass's products and arrive under them.
// - The decode never sees hb: each pass of hidden layer 3 goes bf16 into
//   registers as the A operand of m64n48k16 against that pass's decode
//   stage, into a 64 x 48 f32 sum per warpgroup; the two sums meet in shared
//   memory at the end of the tile.
// - fixed's f32 skips (256 KB per 64 rows) do not fit: they live in a slot
//   of device memory per block (grid x 64 x 1024 f32, reused by every tile
//   of the block, 33 MB for 132 blocks). The encode writes h0; hidden layer
//   1 reads it and writes h1 over it; hidden layer 3 reads h1. Each value is
//   read back by the thread that wrote it.
// - The epilogue math is the plain versions', value by value (quantize_mul,
//   saturate_int8, wrap_int8 of lifting_common.cuh, which avoid conversion
//   instructions). Optional copies of every int8 activation and of the
//   decode's input go to device memory where a pointer is given; they change
//   no value.
//
// Shared memory (SMEM, at most 232,448 bytes): 2 x 65,536 activations +
// STAGES x 16,384 weight ring + (2 x STAGES + 2) mbarriers of 8 bytes +
// 1,024 to align the swizzled tiles = 230,512 bytes.
#include "lifting_common.cuh"

namespace probe {

using namespace lifting;

constexpr int CL = 2;            // blocks per cluster, one weight read each
static_assert(CL >= 2 && CL <= 4, "a multicast to every block; warp w tells block w");
constexpr int BM = 64;           // rows per block
constexpr int TILE_ROWS = CL * BM;
constexpr int BN = 128;          // output columns per stage, and per pass
constexpr int SLAB = 128;        // bytes of K per stage row
constexpr int STAGE = BN * SLAB;
constexpr int DEC_SUB = OUT_F * SLAB;  // 64 values of K of the decode weight
constexpr int DEC_STAGE = BN * 2 / SLAB * DEC_SUB;  // a pass's K, bf16
constexpr int STAGES = 6;
constexpr int ACT = BM * HID;
constexpr int PASSES = HID / BN;
constexpr int KSLABS = HID / SLAB;
constexpr int THREADS = 384;     // a producer warpgroup + 2 consumers
constexpr int SMEM = 1024 + 2 * ACT + STAGES * STAGE + (2 * STAGES + 2) * 8;
static_assert(SMEM <= 232448, "more shared memory than a block may use");
static_assert(BM * OUT_F * 4 <= ACT, "the decode's partial sums fit a buffer");

struct Args {
  const bf16* x;               // (n, 32)
  const unsigned char* image;  // the weight stream (weight_image)
  const float* enc_b;
  const float* ws[4];
  const float* bias[4];
  const float* dec_b;
  float* out;                  // (n, 48)
  float* skip;                 // fixed: (grid, 64, 1024) f32
  int8_t* q[4];                // copies of each hidden layer's input, or null
  bf16* hb;                    // copy of the decode's input, or null
  float s, r;
  int n, tiles;
};

// ---- barriers and bulk copies ------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ bool bar_test(uint32_t bar, uint32_t parity) {
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
// Waits for the phase of parity `parity` to complete. A wait of seconds is
// a fault of the schedule: it traps, so the launch fails where it would
// hang.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  if (bar_test(bar, parity)) return;
  const long long t0 = clock64();
  while (!bar_test(bar, parity))
    if (clock64() - t0 > (1ll << 33)) __trap();
}
__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// One arrival on the barrier at the same offset in block `rank` of the
// cluster. Its release is the CTA's (the default): what it orders is this
// warpgroup's reads of a stage, which wgmma.wait_group has already ended; a
// release at cluster scope would wait for every global store of the thread
// (MEMBAR.GPU) at every stage.
__device__ __forceinline__ void bar_arrive_at(uint32_t bar, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(bar), "r"(rank));
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(remote)
               : "memory");
}
// `bytes` from global to the same offset `dst` of every block in `mask`,
// each block's barrier at offset `bar` counting them.
__device__ __forceinline__ void bulk_multicast(uint32_t dst, const void* src,
                                               uint32_t bytes, uint32_t bar,
                                               uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes."
      "multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "h"(mask)
      : "memory");
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}
// The two consumer warpgroups meet (named barrier 1).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// ---- the producer --------------------------------------------------------

// One thread: the weight stream once per tile of this cluster, a share
// of each stage by this block, multicast to the whole cluster.
__device__ void produce(const Args& a, uint32_t ring, uint32_t full0,
                        uint32_t empty0, uint32_t rank, int cid,
                        int clusters) {
  int stage = 0;
  uint32_t phase = 0;
  auto put = [&](const unsigned char* src, uint32_t bytes) {
    bar_wait(empty0 + 8 * stage, phase ^ 1);
    bar_expect(full0 + 8 * stage, bytes);
    const uint32_t piece = bytes / CL;
    bulk_multicast(ring + stage * STAGE + rank * piece, src + rank * piece,
                   piece, full0 + 8 * stage, (uint16_t)((1 << CL) - 1));
    if (++stage == STAGES) stage = 0, phase ^= 1;
  };
  for (int t = cid; t < a.tiles; t += clusters) {
    const unsigned char* src = a.image;
    for (int p = 0; p < PASSES; ++p, src += STAGE) put(src, STAGE);
    for (int l = 0; l < 4; ++l)
      for (int p = 0; p < PASSES; ++p) {
        for (int s = 0; s < KSLABS; ++s, src += STAGE) put(src, STAGE);
        if (l == 3) put(src, DEC_STAGE), src += DEC_STAGE;
      }
  }
  // Every consumer of the cluster has released every stage: no arrival at
  // this block's barriers is still to come, so the block may leave.
  for (int i = 0; i < STAGES; ++i) {
    bar_wait(empty0 + 8 * stage, phase ^ 1);
    if (++stage == STAGES) stage = 0, phase ^= 1;
  }
}

// ---- the consumers ---------------------------------------------------------

// Two int8 values of a row into an activation buffer: columns col, col + 1
// (col even) of 64 x 1024, stored as 128-byte swizzled slabs of K.
__device__ __forceinline__ void put_pair(unsigned char* act, int row, int col,
                                         uint32_t pair) {
  const int c = col & (SLAB - 1);
  *reinterpret_cast<uint16_t*>(act + (col / SLAB) * (BM * SLAB) + row * SLAB +
                               (((c >> 4) ^ (row & 7)) << 4) + (c & 15)) =
      (uint16_t)pair;
}

template <int V>  // 0 fixed, 1 mxu
struct Consumer {
  const Args& a;
  unsigned char* act[2];  // a layer's input and output, 64 x 1024 int8 each
  unsigned char* ring;
  uint32_t full0, empty0;
  uint32_t order0;  // order[w]: warpgroup w has waited for its pass's stages
  int c;         // this warpgroup takes the passes p with p % 2 == c
  int t, warp, lane, r0;  // r0: this thread's rows r0 and r0 + 8
  float* skip;   // this block's slot (fixed)
  int stage = 0;
  uint32_t phase = 0;
  int passes = 0;  // passes of the kernel so far, both warpgroups'

  __device__ __forceinline__ unsigned char* wait_full() {
    bar_wait(full0 + 8 * stage, phase);
    return ring + stage * STAGE;
  }
  // This warpgroup has finished reading stage st: one arrival at it in
  // every block of the cluster (warp w tells blocks w, w + 4, ...).
  __device__ __forceinline__ void release(int st) {
    if (lane == 0)
      for (int k = warp; k < CL; k += 4) bar_arrive_at(empty0 + 8 * st, k);
  }
  __device__ __forceinline__ int advance() {
    const int st = stage;
    if (++stage == STAGES) stage = 0, phase ^= 1;
    return st;
  }
  // The other warpgroup's pass of k stages: counted, not read.
  __device__ __forceinline__ void pass_by(int k) {
    for (int i = 0; i < k; ++i) advance();
    ++passes;
  }
  // The passes alternate between the warpgroups, and so do their waits for
  // stages: a pass waits for its first stage only once the other warpgroup
  // has seen every stage of the pass before it land. A parity wait tells
  // only two phases of a slot apart, so no stage may be waited for before
  // the one STAGES earlier has landed.
  __device__ __forceinline__ void begin_pass() {
    if (passes > 0) bar_wait(order0 + 8 * (c ^ 1), ((passes - 1) >> 1) & 1);
  }
  __device__ __forceinline__ void end_waits() {
    bar_arrive(order0 + 8 * c);
    ++passes;
  }
  __device__ __forceinline__ int col_of(int p, int j) const {
    return p * BN + 8 * j + 2 * (lane & 3);
  }

  // x rows m0.. into act[1] (chunks 0-3 of each 128-byte row; a row past n
  // is zeros). Warpgroup 0 only: two 16-byte chunks a thread.
  __device__ __forceinline__ void load_x(int m0, uint4 (&v)[2]) const {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int ci = t + 128 * k, row = ci >> 2, j = ci & 3;
      v[k] = m0 + row < a.n ? __ldg(reinterpret_cast<const uint4*>(
                                        a.x + (size_t)(m0 + row) * IN_F) +
                                    j)
                            : make_uint4(0, 0, 0, 0);
    }
  }
  __device__ __forceinline__ void store_x(const uint4 (&v)[2]) const {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int ci = t + 128 * k, row = ci >> 2, j = ci & 3;
      *reinterpret_cast<uint4*>(act[1] + row * SLAB + ((j ^ (row & 7)) << 4)) =
          v[k];
    }
  }

  // A layer's output is whole and the next may read it (wgmma, async
  // proxy); its input buffer is free.
  __device__ __forceinline__ void layer_done() const {
    wg::fence_async_shared();
    consumers_sync();
  }
  // Two int8 values of row r0 + 8 h into out (and the copy, if asked).
  __device__ __forceinline__ void put(unsigned char* out, int h, int q0, int q1,
                                      int8_t* copy, int m0, int col) const {
    const uint32_t pair = (uint32_t)((q0 & 0xff) | ((q1 & 0xff) << 8));
    const int row = r0 + 8 * h;
    put_pair(out, row, col, pair);
    if (copy && m0 + row < a.n)
      *reinterpret_cast<uint16_t*>(copy + (size_t)(m0 + row) * HID + col) =
          (uint16_t)pair;
  }
  // The encode's pass p: x (act[1]) times the stage's 128 columns, bf16,
  // finished into the first int8 activation in act[0] (fixed: h0 into the
  // skip slot too). The bias is loaded before the products.
  __device__ __forceinline__ void encode(int p, int m0) {
    float2 b[BN / 8];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      b[j] = __ldg(reinterpret_cast<const float2*>(a.enc_b + col_of(p, j)));
    float acc[BN / 2] = {};
    begin_pass();
    const unsigned char* st = wait_full();
    end_waits();
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      wg::Mma<BN, 0, 0>::run(acc, wg::desc(act[1] + kk * 32, 16, 1024),
                             wg::desc(st + kk * 32, 16, 1024), kk);
    wg::commit();
    wg::wait<0>();
    release(advance());
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = col_of(p, j);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 8 * h, i = 4 * j + 2 * h;
        float y0 = __fadd_rn(acc[i], b[j].x);
        float y1 = __fadd_rn(acc[i + 1], b[j].y);
        int q0, q1;
        if constexpr (V == 0) {
          y0 = fmaxf(y0, 0.0f), y1 = fmaxf(y1, 0.0f);
          *reinterpret_cast<float2*>(skip + row * HID + col) =
              make_float2(y0, y1);
          q0 = quantize_mul(y0, a.r);
          q1 = quantize_mul(y1, a.r);
        } else {
          q0 = saturate_int8(y0), q1 = saturate_int8(y1);
        }
        put(act[0], h, q0, q1, a.q[0], m0, col);
      }
    }
  }

  // acc = in (64 x 1024 int8) times the 128 columns of the next KSLABS
  // stages; one stage's products stay in flight while the next is waited
  // for.
  __device__ __forceinline__ void products(const unsigned char* in,
                                           int (&acc)[BN / 2]) {
    int prev = -1;
#pragma unroll 1
    for (int s = 0; s < KSLABS; ++s) {
      const unsigned char* st = wait_full();
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wg::MmaS8<BN>::run(acc,
                           wg::desc(in + s * BM * SLAB + kk * 32, 16, 1024),
                           wg::desc(st + kk * 32, 16, 1024), s | kk);
      wg::commit();
      wg::wait<1>();
      if (prev >= 0) release(prev);
      prev = advance();
    }
    wg::wait<0>();
    release(prev);
  }

  // What fixed's epilogue reads of pass p, loaded before the pass's
  // products so that they arrive under them: the bias, the scales' product
  // s * ws and, after hidden layers 1 and 3, the skip.
  template <int L>
  struct Operands {
    float2 b[BN / 8], sw[BN / 8], sk[BN / 8][2];
  };
  template <int L>
  __device__ __forceinline__ void load_operands(int p, Operands<L>& o) const {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = col_of(p, j);
      o.b[j] = __ldg(reinterpret_cast<const float2*>(a.bias[L] + col));
      const float2 w = __ldg(reinterpret_cast<const float2*>(a.ws[L] + col));
      o.sw[j] = make_float2(__fmul_rn(a.s, w.x), __fmul_rn(a.s, w.y));
      if constexpr (L == 1 || L == 3)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          o.sk[j][h] = *reinterpret_cast<const float2*>(
              skip + (r0 + 8 * h) * HID + col);
    }
  }

  // Hidden layer L (0-3), pass p: acc finished (fixed: dequantised, ReLU,
  // skip; mxu: the accumulator's low byte). Layers 0-2 store the next
  // layer's int8 input into out; layer 3 leaves the values in y for the
  // decode.
  template <int L>
  __device__ __forceinline__ void finish(int p, int m0, const int (&acc)[BN / 2],
                                         const Operands<L>& o,
                                         unsigned char* out,
                                         float (&y)[BN / 2]) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = col_of(p, j);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 8 * h, i = 4 * j + 2 * h;
        float y0, y1;
        int q0 = 0, q1 = 0;
        if constexpr (V == 0) {
          y0 = fmaxf(__fadd_rn(__fmul_rn((float)acc[i], o.sw[j].x), o.b[j].x),
                     0.0f);
          y1 = fmaxf(
              __fadd_rn(__fmul_rn((float)acc[i + 1], o.sw[j].y), o.b[j].y),
              0.0f);
          if constexpr (L == 1 || L == 3) {
            y0 = __fadd_rn(y0, o.sk[j][h].x), y1 = __fadd_rn(y1, o.sk[j][h].y);
            if constexpr (L == 1)  // h1 over h0
              *reinterpret_cast<float2*>(skip + row * HID + col) =
                  make_float2(y0, y1);
          }
          if constexpr (L < 3) {
            q0 = quantize_mul(y0, a.r);
            q1 = quantize_mul(y1, a.r);
          }
        } else {
          q0 = wrap_int8(acc[i]), q1 = wrap_int8(acc[i + 1]);
          y0 = (float)q0, y1 = (float)q1;
        }
        if constexpr (L < 3) {
          put(out, h, q0, q1, a.q[L + 1], m0, col);
        } else {
          y[i] = y0, y[i + 1] = y1;
          if (a.hb && m0 + row < a.n)
            *reinterpret_cast<uint32_t*>(a.hb + (size_t)(m0 + row) * HID +
                                         col) = pack_bf16x2(y0, y1);
        }
      }
    }
  }

  // dec += bf16(y) (hidden layer 3's pass p, A from registers) times the
  // pass's rows of the decode weight (its decode stage).
  __device__ __forceinline__ void decode(int p, const float (&y)[BN / 2],
                                         const unsigned char* st,
                                         float (&dec)[24]) {
    uint32_t af[BN / 16][4];
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      af[kk][0] = pack_bf16x2(y[8 * kk], y[8 * kk + 1]);
      af[kk][1] = pack_bf16x2(y[8 * kk + 2], y[8 * kk + 3]);
      af[kk][2] = pack_bf16x2(y[8 * kk + 4], y[8 * kk + 5]);
      af[kk][3] = pack_bf16x2(y[8 * kk + 6], y[8 * kk + 7]);
      wg::MmaRS<48, 0>::run(
          dec, af[kk],
          wg::desc(st + (kk >> 2) * DEC_SUB + (kk & 3) * 32, 16, 1024),
          (p >> 1) | kk);
    }
    wg::commit();
    wg::wait<0>();
    release(advance());
  }

  // Hidden layer L: act[L % 2] in; layers 0-2 write act[1 - L % 2], layer 3
  // accumulates the decode's sums. This warpgroup's passes alternate with
  // the other's: one's epilogue runs under the other's products.
  template <int L>
  __device__ __forceinline__ void hidden(int m0, float (&dec)[24]) {
    const unsigned char* in = act[L & 1];
    unsigned char* out = act[(L & 1) ^ 1];
#pragma unroll 1
    for (int p = 0; p < PASSES; ++p) {
      if ((p & 1) != c) {
        pass_by(KSLABS + (L == 3));
        continue;
      }
      int acc[BN / 2] = {};
      float y[BN / 2];
      Operands<L> o;
      if constexpr (V == 0) load_operands<L>(p, o);
      begin_pass();
      products(in, acc);
      if constexpr (L == 3) {
        const unsigned char* st = wait_full();  // the pass's decode stage
        end_waits();
        finish<L>(p, m0, acc, o, out, y);
        decode(p, y, st, dec);
      } else {
        end_waits();
        finish<L>(p, m0, acc, o, out, y);
      }
    }
  }

  __device__ void run(int cid, int clusters, uint32_t rank) {
    uint4 xv[2];
    if (c == 0) {
      load_x(cid * TILE_ROWS + rank * BM, xv);
      store_x(xv);
    }
#pragma unroll 1
    for (int tile = cid; tile < a.tiles; tile += clusters) {
      const int m0 = tile * TILE_ROWS + rank * BM;
      const int next = tile + clusters;
      layer_done();  // the x tile
#pragma unroll 1
      for (int p = 0; p < PASSES; ++p) {
        if ((p & 1) == c)
          encode(p, m0);
        else
          pass_by(1);
      }
      layer_done();
      float dec[24] = {};
      hidden<0>(m0, dec);
      layer_done();
      hidden<1>(m0, dec);
      layer_done();
      hidden<2>(m0, dec);
      layer_done();
      if (c == 0 && next < a.tiles) load_x(next * TILE_ROWS + rank * BM, xv);
      hidden<3>(m0, dec);
      // The two warpgroups' decode sums meet in act[0] (free since hidden
      // layer 2 read it), in the accumulator layout: thread t holds the same
      // (row, column) pairs in both. Warpgroup 0, whose last pass is the
      // earlier one, hands its sums over and loads the next x.
      float* part = reinterpret_cast<float*>(act[0]);
      if (c == 0) {
#pragma unroll
        for (int i = 0; i < 24; ++i) part[i * 128 + t] = dec[i];
      }
      consumers_sync();  // and both warpgroups are done with act[1]
      if (c == 1) {
#pragma unroll
        for (int j = 0; j < OUT_F / 8; ++j) {
          const int col = 8 * j + 2 * (lane & 3);
          const float2 b = __ldg(reinterpret_cast<const float2*>(a.dec_b + col));
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = r0 + 8 * h, i = 4 * j + 2 * h;
            if (m0 + row < a.n)
              *reinterpret_cast<float2*>(a.out + (size_t)(m0 + row) * OUT_F +
                                         col) =
                  make_float2(
                      __fadd_rn(__fadd_rn(part[i * 128 + t], dec[i]), b.x),
                      __fadd_rn(__fadd_rn(part[(i + 1) * 128 + t], dec[i + 1]),
                                b.y));
          }
        }
      } else if (next < a.tiles) {
        store_x(xv);
      }
    }
  }
};

template <int V>
__global__ void __launch_bounds__(THREADS, 1)
chain_kernel(const __grid_constant__ Args a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_ring(smem_raw);
  unsigned char* ring = smem + 2 * ACT;
  const uint32_t full0 = smem_u32(ring + STAGES * STAGE);
  const uint32_t empty0 = full0 + 8 * STAGES;
  const uint32_t order0 = empty0 + 8 * STAGES;
  uint32_t rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  const int cid = blockIdx.x / CL, clusters = gridDim.x / CL;
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      bar_init(full0 + 8 * i, 1);
      bar_init(empty0 + 8 * i, CL);  // one warpgroup a stage
    }
    bar_init(order0, 128);
    bar_init(order0 + 8, 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // every block's barriers exist before any copy or arrival
  // Warpgroup 0 produces, with few registers; warpgroups 1 and 2 consume.
  // The two paths never meet again: no block leaves before its producer
  // has seen every arrival at its barriers (produce's last waits).
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0)
      produce(a, smem_u32(ring), full0, empty0, rank, cid, clusters);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int t = threadIdx.x & 127;
    // The warpgroup, uniform over each warp as the compiler sees it: wgmma
    // in a path it takes for divergent would be serialized.
    const int wgc = __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 7) - 1, 0);
    Consumer<V> w{a, {smem, smem + ACT}, ring, full0, empty0, order0, wgc,
                  t, t >> 5, t & 31, 16 * (t >> 5) + ((t & 31) >> 2),
                  a.skip ? a.skip + (size_t)blockIdx.x * BM * HID : nullptr};
    w.run(cid, clusters, rank);
  }
}

template <int V>
cudaLaunchConfig_t config(int clusters, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(clusters * CL));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int V>
cudaError_t launch(const Args& a, int clusters, cudaStream_t stream) {
  auto kernel = chain_kernel<V>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config<V>(clusters, stream, attr);
  e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace probe

// Clusters of the chain kernel that the current device holds at once (the
// grid of plan_probe is at most this many). Returns a cudaError_t.
extern "C" int int8_scale_probe_clusters(int* clusters) {
  using namespace probe;
  auto kernel = chain_kernel<0>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config<0>(1, 0, attr);
  return (int)cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}

// C entry. x: (n, 32) bf16; image: the weight stream of
// ops/int8_scale_probe.py::weight_image; enc_b, ws*, b* (1024,) and dec_b
// (48,) f32. out: (n, 48) f32. skip: fixed's (clusters * 2, 64, 1024) f32
// scratch (mxu: null). q0..q3: (n, 1024) int8 copies of each hidden
// layer's input, hb: (n, 1024) bf16 copy of the decode's input, each null
// for none. variant 0 fixed (scale s, multiplier r), 1 mxu (s, r unread).
// clusters: the plan's (plan_probe). One launch. Returns the first CUDA
// error, or cudaGetLastError().
extern "C" int int8_scale_probe_forward(
    const void* x, const void* image, const void* enc_b, const void* ws0,
    const void* b0, const void* ws1, const void* b1, const void* ws2,
    const void* b2, const void* ws3, const void* b3, const void* dec_b,
    void* out, void* skip, void* q0, void* q1, void* q2, void* q3, void* hb,
    float s, float r, int variant, int n, int clusters, void* stream) {
  using namespace probe;
  if (n < 1 || clusters < 1 || (variant == 0 && !skip))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = static_cast<const bf16*>(x);
  a.image = static_cast<const unsigned char*>(image);
  a.enc_b = static_cast<const float*>(enc_b);
  const void* ws[4] = {ws0, ws1, ws2, ws3};
  const void* bs[4] = {b0, b1, b2, b3};
  void* qs[4] = {q0, q1, q2, q3};
  for (int l = 0; l < 4; ++l) {
    a.ws[l] = static_cast<const float*>(ws[l]);
    a.bias[l] = static_cast<const float*>(bs[l]);
    a.q[l] = static_cast<int8_t*>(qs[l]);
  }
  a.dec_b = static_cast<const float*>(dec_b);
  a.out = static_cast<float*>(out);
  a.skip = static_cast<float*>(skip);
  a.hb = static_cast<bf16*>(hb);
  a.s = s, a.r = r, a.n = n;
  a.tiles = (n + TILE_ROWS - 1) / TILE_ROWS;
  cudaStream_t st = (cudaStream_t)stream;
  if (variant == 0) return (int)launch<0>(a, clusters, st);
  if (variant == 1) return (int)launch<1>(a, clusters, st);
  return (int)cudaErrorInvalidValue;
}
