// The int8 scale probe's two chains (kernel K5 of the port): K2's int8
// lifting forward with the activation-scale work changed, to measure what
// that work costs. (n, 32) bf16 -> (n, 48) f32, one launch per layer.
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
// What bounds it on an H100: K2's products, 2 n 4 * 1024^2 int8 operations
// at 1,979 TOP/s plus encode and decode at the bf16 rate (0.29 ms at n =
// 65536); rows in and out are n (32 * 2 + 48 * 4) bytes.
//
// Design: K2's per-layer path (lifting_common.cuh: int8 m64nNk32 wgmma,
// 128 x 128 tiles, two blocks to an SM, the cp.async ring), with the
// epilogue's int8 form a template parameter (Quant): fixed is K2's static
// epilogue under Q_MUL; mxu's encode runs Q_SAT and its hidden layers
// Q_WRAP, whose epilogue reads the int32 accumulator alone. Each hidden
// layer's int8 input gets a buffer of its own (q0..q3), so that a check
// can read every activation; mxu's last one travels as bf16, exact, into
// the decode. One launch per layer at every batch: the probe is a bulk
// measurement.
#include "lifting_common.cuh"

// C entry. x: (n, 32) bf16. enc_w (1024, 32) / dec_w (48, 1024) bf16 and
// wq* (1024, 1024) int8, all K-contiguous (out, in); ws*, b* f32 (1024,).
// out: (n, 48) f32. h0, h1: (n, 1024) f32 scratch (fixed's skips); q0..q3:
// (n, 1024) int8, the input of each hidden layer; hb: (n, 1024) bf16, the
// decode's input. variant 0 fixed (scale s, multiplier r), 1 mxu (s, r
// unread). Returns the first CUDA error, or cudaGetLastError().
extern "C" int int8_scale_probe_forward(
    const void* x, const void* enc_w, const void* enc_b, const void* wq0,
    const void* ws0, const void* b0, const void* wq1, const void* ws1,
    const void* b1, const void* wq2, const void* ws2, const void* b2,
    const void* wq3, const void* ws3, const void* b3, const void* dec_w,
    const void* dec_b, void* out, void* h0, void* h1, void* q0, void* q1,
    void* q2, void* q3, void* hb, float s, float r, int variant, int n,
    void* stream) {
  using namespace lifting;
  cudaStream_t st = (cudaStream_t)stream;
  const void* wq[4] = {wq0, wq1, wq2, wq3};
  const float* ws[4] = {(const float*)ws0, (const float*)ws1,
                        (const float*)ws2, (const float*)ws3};
  const float* bs[4] = {(const float*)b0, (const float*)b1, (const float*)b2,
                        (const float*)b3};
  int8_t* q[4] = {(int8_t*)q0, (int8_t*)q1, (int8_t*)q2, (int8_t*)q3};

  // Each layer's operands; the epilogue is the variant's.
  auto shape = [&](auto& L, const void* A, const void* B, int N, int K) {
    L = {};
    L.A = A, L.B = B, L.M = n, L.N = N, L.K = K;
  };
  Layer<float> dec;
  shape(dec, hb, dec_w, OUT_F, HID);
  dec.ep.bias = (const float*)dec_b;
  dec.ep.out = (float*)out;

  cudaError_t e = cudaSuccess;
  if (variant == 0) {
    Layer<float, Q_MUL> enc, hid[4];
    shape(enc, x, enc_w, HID, IN_F);
    enc.ep.bias = (const float*)enc_b;
    enc.ep.relu = 1;
    enc.ep.out = (float*)h0;  // the skip of hidden layer 1
    enc.ep.out_q = q[0];
    enc.ep.q_scale = r;
    for (int l = 0; l < 4; ++l) {
      Layer<float, Q_MUL>& L = hid[l];
      shape(L, q[l], wq[l], HID, HID);
      L.ep.bias = bs[l];
      L.ep.wscale = ws[l];
      L.ep.in_scale = s;
      L.ep.relu = 1;
      if (l == 1) L.ep.skip = (const float*)h0, L.ep.out = (float*)h1;
      if (l == 3) L.ep.skip = (const float*)h1;
      if (l < 3) {
        L.ep.out_q = q[l + 1];
        L.ep.q_scale = r;
      } else {
        L.ep.out_bf16 = (bf16*)hb;
      }
    }
    e = launch_bulk<bf16, float>(enc, st);
    for (int l = 0; l < 4 && e == cudaSuccess; ++l)
      e = launch_bulk<int8_t, float>(hid[l], st);
  } else if (variant == 1) {
    Layer<float, Q_SAT> enc;
    shape(enc, x, enc_w, HID, IN_F);
    enc.ep.bias = (const float*)enc_b;
    enc.ep.out_q = q[0];
    Layer<float, Q_WRAP> hid[4];
    for (int l = 0; l < 4; ++l) {
      shape(hid[l], q[l], wq[l], HID, HID);
      if (l < 3)
        hid[l].ep.out_q = q[l + 1];
      else
        hid[l].ep.out_bf16 = (bf16*)hb;  // |hq| <= 128: exact in bf16
    }
    e = launch_bulk<bf16, float>(enc, st);
    for (int l = 0; l < 4 && e == cudaSuccess; ++l)
      e = launch_bulk<int8_t, float>(hid[l], st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (e == cudaSuccess) e = launch_bulk<bf16, float>(dec, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
