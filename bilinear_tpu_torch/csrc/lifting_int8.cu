// Int8 lifting forward (kernel K2 of the port): the BilinearUnit eval forward
// with the four hidden 1024 x 1024 layers as int8 x int8 -> int32 products.
//   h = relu(bf16(x) @ enc_w + enc_b)                  f32, bf16 products
//   per hidden layer l: hq = clip(rint(h / s_x), -127, 127)   (int8)
//                       h  = relu(acc * (s_x * ws) + b) [+ skip]   f32
//   out = bf16(h) @ dec_w + dec_b                      f32
// s_x is amax(h) / 127 over a group of rows (dynamic mode: 512-row groups,
// the TPU kernel's tile) or one calibrated constant per layer (static mode).
//
// Replaces: bilinear_tpu/ops/pallas/lifting_int8.py::_make_static_kernel
// (and its dynamic instance _kernel; the pallas_call in _run_pallas, entered
// through lifting_forward_int8).
//
// What bounds it on an H100: the hidden layers' 2 n 4 * 1024^2 integer ops at
// 1,979 TOP/s plus encode/decode at the bf16 rate (0.29 ms at n = 65536),
// against n (32 * 2 + 48 * 4) bytes of rows and 4.3 MB of weights. Between
// layers the f32 value exists only where a later layer adds it back (after
// encode and after block 1): everything else travels as int8 or bf16, or the
// activation traffic, not the products, would set the time.
//
// Design (the tiles, rings and epilogue are lifting_common.cuh's; why the
// chain is one launch only at serving size is argued there):
// - Hidden layers run m64nNk32 s8 wgmma. The 8-bit forms take both operands
//   K-contiguous, so prepare_weights_int8 keeps an (out, in) copy of each wq.
// - Static mode has no quantise pass: the scale of the next layer is known
//   at launch, so the epilogue that produces an activation stores
//   clip(rint(y / s_next)) as int8 for the next layer, f32 only where that
//   value is a later skip, and bf16 for the decode.
// - Dynamic mode: the TPU grid runs its row tiles in order, each tile's amax
//   local to its block. Here a 512-row group spans many blocks, so the layer
//   that PRODUCES an activation reduces its group amax in its epilogue (warp
//   shuffle, then one atomicMax per warp on the float's bits, exact because
//   every such value is >= 0). On the per-layer path such a layer runs as a
//   persistent cooperative grid whose blocks take the 32 tiles of a group
//   together: each keeps its finished tile in shared memory, counts itself
//   in, waits until the group's count is full, and quantises its own tile
//   with the group's scale. No quantise pass, and no f32 round trip for a
//   value that is not a later skip. One group of more rows than the card
//   holds tiles for at once (calibrate_scales on a large batch) cannot run
//   so: lifting_int8_group_capacity tells the wrapper how many rows fit, and
//   it asks for plain launches with one vectorised quantise pass before each
//   hidden layer instead (quantize_pass).
//   (Tried first and measured slower on an H100: the block that finishes a
//   group's last tile quantising the whole group, L2-hot, which is bound by
//   that one block's latency; and a plain launch plus a quantise pass per
//   layer, whole or in chunks of 8192 rows.)
//   Padding rows: the JAX path pads with zero input rows up to the group size, and
//   those rows (relu(enc_b) after encode) enter the last group's amax. All
//   padding rows are identical, so the caller appends ONE zero row, which
//   puts the same value into the same group. Rows past that are masked and
//   never enter an amax.
// - Serving batches: one cooperative launch runs the six layers with a grid
//   barrier between them; in dynamic mode the grid quantises an activation
//   together between two barriers, once its amax is whole.
// - The dequant + bias + ReLU + skip run in the epilogue with explicit
//   round-to-nearest ops, in the JAX expression's order.
#include "lifting_common.cuh"

namespace lifting {

namespace cg = cooperative_groups;

struct ChainQ {
  Layer<float> enc, hid[4], dec;
  int dynamic;
};

// The serving batch: all six layers in one cooperative launch.
__global__ void __launch_bounds__(ServeTile::THREADS)
lifting_int8_chain_wgmma(const __grid_constant__ ChainQ c) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align_ring(smem_raw);
  cg::grid_group grid = cg::this_grid();
  serve_layer<bf16, float>(c.enc, ring);
  grid.sync();
  for (int l = 0; l < 4; ++l) {
    const Layer<float>& L = c.hid[l];
    if (c.dynamic) {
      // The input's amax is whole: the grid quantises it, group by group.
      quantize_groups(l == 0 ? c.enc.ep.out : c.hid[l - 1].ep.out,
                      (int8_t*)L.A, L.M, L.ep.group_rows, L.ep.in_amax);
      grid.sync();
    }
    serve_layer<int8_t, float>(L, ring);
    grid.sync();
  }
  serve_layer<bf16, float>(c.dec, ring);
}

// The per-layer path's quantise pass of dynamic mode: the whole activation,
// each group with its own scale.
__global__ void __launch_bounds__(256)
quantize_activation(const float* __restrict__ h, int8_t* __restrict__ q, int M,
                    int group_rows, const float* __restrict__ amax) {
  quantize_groups(h, q, M, group_rows, amax);
}

}  // namespace lifting

// C entry of the quantise pass alone, for checks against the plain version:
// h (m, 1024) f32 -> q (m, 1024) int8, group g of group_rows rows with the
// scale amax[g] / 127.
extern "C" int lifting_int8_quantize(const void* h, void* q, const void* amax,
                                     int m, int group_rows, void* stream) {
  const size_t vecs = (size_t)m * (lifting::HID / 8);
  lifting::quantize_activation<<<(unsigned)((vecs + 1023) / 1024), 256, 0,
                                 (cudaStream_t)stream>>>(
      (const float*)h, (int8_t*)q, m, group_rows, (const float*)amax);
  return (int)cudaGetLastError();
}

// The most rows of one dynamic scale group that the group-synchronous kernels
// take on the current device: every tile of a group must be resident at once.
extern "C" int lifting_int8_group_capacity(int* rows) {
  using namespace lifting;
  const void* kernel = nullptr;
  int enc = 0, hid = 0;
  cudaError_t e = groups_kernel<bf16>(&kernel, &enc);
  if (e == cudaSuccess) e = groups_kernel<int8_t>(&kernel, &hid);
  *rows = (enc < hid ? enc : hid) / (HID / 128) * 128;
  return (int)e;
}

// C entry. x: (n, 32) bf16 (n includes the one padding row in dynamic
// mode). enc_w (1024, 32) / dec_w (48, 1024) bf16 and wq* (1024, 1024) int8,
// all K-contiguous (out, in); ws*, b* f32 (1024,). h0..h2: (n, 1024) f32
// scratch; q0, q1: (n, 1024) int8; hb: (n, 1024) bf16. amax: dynamic mode's
// scratch, float[4 * groups] then unsigned[4 * groups] with groups =
// ceil(n / group_rows), zeroed here (on return the floats hold each layer
// input's group amax, the rest the per-group tile counts of the per-layer
// path); null for static mode with scales s0..s3. group_rows must be a
// multiple of 128. path: 0 one launch per layer, 1 the one-launch serving
// kernel. quantize_pass (dynamic mode, path 0): 0 each producing layer
// quantises its own output group-synchronously, which needs every scale
// group within lifting_int8_group_capacity rows (else the launch error is
// returned); 1 plain GEMMs and one quantise pass before each hidden layer.
// Returns the first CUDA error, or cudaGetLastError().
extern "C" int lifting_int8_forward(
    const void* x, const void* enc_w, const void* enc_b, const void* wq0,
    const void* ws0, const void* b0, const void* wq1, const void* ws1,
    const void* b1, const void* wq2, const void* ws2, const void* b2,
    const void* wq3, const void* ws3, const void* b3, const void* dec_w,
    const void* dec_b, void* out, void* h0, void* h1, void* h2, void* q0,
    void* q1, void* hb, void* amax, float s0, float s1, float s2, float s3,
    int n, int group_rows, int path, int quantize_pass, void* stream) {
  using namespace lifting;
  cudaStream_t s = (cudaStream_t)stream;
  const int groups = (n + group_rows - 1) / group_rows;
  float* am = (float*)amax;
  unsigned* cnt = am ? (unsigned*)(am + 4 * groups) : nullptr;
  cudaError_t e = cudaSuccess;
  if (am) e = cudaMemsetAsync(am, 0, sizeof(float) * 8 * groups, s);
  if (e != cudaSuccess) return (int)e;

  const void* wq[4] = {wq0, wq1, wq2, wq3};
  const float* ws[4] = {(const float*)ws0, (const float*)ws1,
                        (const float*)ws2, (const float*)ws3};
  const float* bs[4] = {(const float*)b0, (const float*)b1, (const float*)b2,
                        (const float*)b3};
  const float scales[4] = {s0, s1, s2, s3};
  float* hf[3] = {(float*)h0, (float*)h1, (float*)h2};
  int8_t* hq[2] = {(int8_t*)q0, (int8_t*)q1};

  // f32 buffers: out_buf[l] receives hidden layer l where a later layer
  // needs the f32 value (dynamic: always, to be quantised; static: only the
  // skip after block 1), skip_buf[l] is added after its ReLU. Block 1:
  // h0 -> h1 -> h2 (+h0); block 2: h2 -> h1 -> (+h2). The int8 activations
  // alternate between q0 and q1.
  const int out_buf[4] = {1, 2, 1, -1};
  const int skip_buf[4] = {-1, 0, -1, 2};

  ChainQ c = {};
  c.dynamic = am != nullptr;
  auto produces = [&](Epilogue<float>& ep, int next) {
    // This layer's value feeds hidden layer `next` as int8.
    if (am) {
      ep.out_amax = am + next * groups;
    } else {
      ep.out_q = hq[next & 1];
      ep.q_scale = scales[next];
    }
  };

  c.enc.A = x, c.enc.B = enc_w, c.enc.M = n, c.enc.N = HID, c.enc.K = IN_F;
  c.enc.ep.bias = (const float*)enc_b;
  c.enc.ep.out = hf[0];
  c.enc.ep.group_rows = group_rows;
  c.enc.ep.relu = 1;
  produces(c.enc.ep, 0);

  for (int l = 0; l < 4; ++l) {
    Layer<float>& L = c.hid[l];
    L.A = hq[l & 1], L.B = wq[l], L.M = n, L.N = HID, L.K = HID;
    L.ep.bias = bs[l];
    L.ep.wscale = ws[l];
    L.ep.in_amax = am ? am + l * groups : nullptr;
    L.ep.in_scale = scales[l];
    L.ep.skip = skip_buf[l] >= 0 ? hf[skip_buf[l]] : nullptr;
    L.ep.group_rows = group_rows;
    L.ep.relu = 1;
    if (l < 3) {
      if (am || l == 1) L.ep.out = hf[out_buf[l]];
      produces(L.ep, l + 1);
    } else {
      L.ep.out_bf16 = (bf16*)hb;  // the decode input, h.astype(bf16)
    }
  }

  c.dec.A = hb, c.dec.B = dec_w, c.dec.M = n, c.dec.N = OUT_F, c.dec.K = HID;
  c.dec.ep.bias = (const float*)dec_b;
  c.dec.ep.out = (float*)out;
  c.dec.ep.group_rows = group_rows;

  if (path == 1) {
    e = launch_persistent(lifting_int8_chain_wgmma, c, serve_tiles(n, HID), s);
  } else {
    // Dynamic mode: a layer whose value feeds a hidden layer runs
    // group-synchronously and quantises its own output (own), or a quantise
    // pass runs before each hidden layer.
    const bool own = am && !quantize_pass;
    auto produce = [&](auto tc, const Layer<float>& L, int next) {
      Layer<float> G = L;
      G.ep.done = cnt + next * groups;
      G.ep.dyn_q = hq[next & 1];
      // f32 only where the value is a later skip (after encode and block 1)
      if (next == 1 || next == 3) G.ep.out = nullptr;
      return launch_groups<decltype(tc)>(G, s);
    };
    e = own ? produce(bf16{}, c.enc, 0) : launch_bulk<bf16, float>(c.enc, s);
    for (int l = 0; l < 4 && e == cudaSuccess; ++l) {
      const Layer<float>& L = c.hid[l];
      if (am && !own) {
        const size_t vecs = (size_t)n * (HID / 8);
        const unsigned blocks = (unsigned)((vecs + 1023) / 1024);  // 4 a thread
        quantize_activation<<<blocks, 256, 0, s>>>(
            l == 0 ? c.enc.ep.out : c.hid[l - 1].ep.out, (int8_t*)L.A, n,
            group_rows, L.ep.in_amax);
      }
      e = own && l < 3 ? produce(int8_t{}, L, l + 1)
                       : launch_bulk<int8_t, float>(L, s);
    }
    if (e == cudaSuccess) e = launch_bulk<bf16, float>(c.dec, s);
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
