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
// 1,979 TOP/s plus encode/decode at the bf16 rate, against n (32 * 2 + 48 * 4)
// bytes of rows and 4.3 MB of weights. At n = 256 the weight read dominates.
//
// Design: one launch per step, on one stream.
// - The TPU grid runs its row tiles in order, each tile's amax local to its
//   block. Here a block owns 32 to 128 rows, so a dynamic group (512 rows)
//   spans several blocks: the layer that PRODUCES an activation reduces its
//   group amax in its epilogue (warp shuffle, then one atomicMax per warp on
//   the float's bits, exact because every such value is >= 0), and the next
//   launch reads it. Padding rows: the JAX path pads with zero input rows up to the
//   group size, and those rows (relu(enc_b) after encode) enter the last
//   group's amax. All padding rows are identical, so the caller appends ONE
//   zero row, which puts the same value into the same group.
// - Quantization is its own elementwise pass (true division, round half to
//   even, clip), so the int8 GEMM reads 1 byte per activation.
// - The dequant + bias + ReLU + skip run in the GEMM epilogue with explicit
//   round-to-nearest ops, in the JAX expression's order.
#include "lifting_common.cuh"

namespace lifting {

// hq = clip(rint(h / s_x(group)), -127, 127), 4 elements per thread.
__global__ void quantize_rows(const float* __restrict__ h,
                              int8_t* __restrict__ q, size_t n4, int width,
                              const float* amax, float static_scale,
                              int group_rows) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    int row = (int)((i * 4) / width);
    float s = act_scale(amax, row / group_rows, static_scale);
    float4 v = reinterpret_cast<const float4*>(h)[i];
    char4 o;
    o.x = (signed char)fminf(fmaxf(rintf(__fdiv_rn(v.x, s)), -127.f), 127.f);
    o.y = (signed char)fminf(fmaxf(rintf(__fdiv_rn(v.y, s)), -127.f), 127.f);
    o.z = (signed char)fminf(fmaxf(rintf(__fdiv_rn(v.z, s)), -127.f), 127.f);
    o.w = (signed char)fminf(fmaxf(rintf(__fdiv_rn(v.w, s)), -127.f), 127.f);
    reinterpret_cast<char4*>(q)[i] = o;
  }
}

}  // namespace lifting

// C entry. x: (n, 32) bf16 (n includes the one padding row in dynamic
// mode). enc_w (32, 1024) / dec_w (1024, 48) bf16; wq* (1024, 1024) int8;
// ws*, b* f32 (1024,). h0..h2: (n, 1024) f32 scratch; q: (n, 1024) int8
// scratch. amax: float[4 * ceil(n / group_rows)] for dynamic mode (zeroed
// here; it holds each layer input's group amax on return), or null for
// static mode with scales s0..s3. group_rows must be a multiple of MAX_BM (128).
// Returns cudaGetLastError().
extern "C" int lifting_int8_forward(
    const void* x, const void* enc_w, const void* enc_b, const void* wq0,
    const void* ws0, const void* b0, const void* wq1, const void* ws1,
    const void* b1, const void* wq2, const void* ws2, const void* b2,
    const void* wq3, const void* ws3, const void* b3, const void* dec_w,
    const void* dec_b, void* out, void* h0, void* h1, void* h2, void* q,
    void* amax, float s0, float s1, float s2, float s3, int n, int group_rows,
    void* stream) {
  using namespace lifting;
  cudaStream_t s = (cudaStream_t)stream;
  const int H = 1024, IN = 32, OUT = 48;
  const int groups = (n + group_rows - 1) / group_rows;
  float* am = (float*)amax;
  if (am) cudaMemsetAsync(am, 0, sizeof(float) * 4 * groups, s);

  const int8_t* wq[4] = {(const int8_t*)wq0, (const int8_t*)wq1,
                         (const int8_t*)wq2, (const int8_t*)wq3};
  const float* ws[4] = {(const float*)ws0, (const float*)ws1,
                        (const float*)ws2, (const float*)ws3};
  const float* bs[4] = {(const float*)b0, (const float*)b1, (const float*)b2,
                        (const float*)b3};
  const float scales[4] = {s0, s1, s2, s3};
  float* hf[3] = {(float*)h0, (float*)h1, (float*)h2};
  int8_t* hq = (int8_t*)q;

  // Buffers: in[l] feeds hidden layer l, out[l] receives it, skip[l] is
  // added after its ReLU. Block 1: h0 -> h1 -> h2 (+h0); block 2:
  // h2 -> h1 -> h0 (+h2).
  const int in_buf[4] = {0, 1, 2, 1};
  const int out_buf[4] = {1, 2, 1, 0};
  const int skip_buf[4] = {-1, 0, -1, 2};

  Epilogue<float> enc = {};
  enc.bias = (const float*)enc_b;
  enc.out = hf[0];
  enc.out_amax = am;  // amax of layer 0's input
  enc.group_rows = group_rows;
  enc.relu = 1;
  launch_gemm_tc<bf16, bf16, float>((const bf16*)x, (const bf16*)enc_w, n, H,
                                    IN, enc, s);

  size_t n4 = (size_t)n * H / 4;
  int qblocks = (int)((n4 + 255) / 256 < 65536 ? (n4 + 255) / 256 : 65536);
  for (int l = 0; l < 4; ++l) {
    const float* in_amax = am ? am + l * groups : nullptr;
    quantize_rows<<<qblocks, 256, 0, s>>>(hf[in_buf[l]], hq, n4, H, in_amax,
                                          scales[l], group_rows);
    Epilogue<float> ep = {};
    ep.bias = bs[l];
    ep.wscale = ws[l];
    ep.in_amax = in_amax;
    ep.in_scale = scales[l];
    ep.skip = skip_buf[l] >= 0 ? hf[skip_buf[l]] : nullptr;
    ep.out = hf[out_buf[l]];
    ep.out_amax = (am && l < 3) ? am + (l + 1) * groups : nullptr;
    ep.group_rows = group_rows;
    ep.relu = 1;
    launch_gemm_tc<int8_t, int8_t, float>(hq, wq[l], n, H, H, ep, s);
  }

  Epilogue<float> dec = {};
  dec.bias = (const float*)dec_b;
  dec.out = (float*)out;
  dec.group_rows = group_rows;
  launch_gemm_tc<float, bf16, float>(hf[0], (const bf16*)dec_w, n, OUT, H,
                                     dec, s);
  return (int)cudaGetLastError();
}
