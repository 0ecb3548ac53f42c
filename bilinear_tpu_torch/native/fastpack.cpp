// fastpack: native host-side image packing for the data pipeline (the
// port's own copy of bilinear_tpu/native/fastpack.cpp: the same three entry
// points and the same arithmetic, so either package's canvases are the
// other's bit for bit on one machine).
//
// On the host the data pipeline keeps JPEG decode (libjpeg via PIL) and the
// region pre-crop / downscale / float conversion of
// data/pipeline.py::record_to_canvas; the geometry runs on the card. These
// are the memory-bound steps, natively:
//
//   resize_linear_u8 : separable triangle-filter resample, coefficient-
//                      compatible with PIL's BILINEAR (support scales with
//                      the downscale ratio), uint8 HWC.
//   pack_canvas_f32  : clipped region copy into a float32 [0,1] canvas with
//                      zero padding (x * (1 / 255) in float32).
//   pack_canvas_u8   : the same copy kept uint8 (the u8 transport's wire
//                      format; the card scales it to [0, 1]).
//
// C linkage for ctypes. Built by bilinear_tpu_torch/native/__init__.py with
// g++ at first use; a failed build raises (no silent fallback).
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Tap {
    int first;           // first source index
    int count;           // number of taps
    const double* coef;  // normalized weights
};

// PIL-style coefficient table for a triangle (linear) filter.
void build_taps(int in_size, int out_size, std::vector<double>& coeffs,
                std::vector<int>& firsts, std::vector<int>& counts,
                int& ksize) {
    double scale = static_cast<double>(in_size) / out_size;
    double filterscale = std::max(scale, 1.0);
    double support = 1.0 * filterscale;  // triangle filter support
    ksize = static_cast<int>(std::ceil(support)) * 2 + 1;

    coeffs.assign(static_cast<size_t>(out_size) * ksize, 0.0);
    firsts.assign(out_size, 0);
    counts.assign(out_size, 0);

    for (int xx = 0; xx < out_size; ++xx) {
        double center = (xx + 0.5) * scale;
        double ww = 0.0;
        double ss = 1.0 / filterscale;
        int xmin = static_cast<int>(std::max(0.0, std::floor(center - support)));
        int xmax = static_cast<int>(std::min(static_cast<double>(in_size),
                                             std::ceil(center + support)));
        int n = xmax - xmin;
        double* k = &coeffs[static_cast<size_t>(xx) * ksize];
        for (int x = 0; x < n; ++x) {
            double w = (x + xmin - center + 0.5) * ss;
            w = 1.0 - std::abs(w);  // triangle
            if (w < 0.0) w = 0.0;
            k[x] = w;
            ww += w;
        }
        if (ww != 0.0)
            for (int x = 0; x < n; ++x) k[x] /= ww;
        firsts[xx] = xmin;
        counts[xx] = n;
    }
}

inline uint8_t clip8(double v) {
    return static_cast<uint8_t>(std::min(255.0, std::max(0.0, v + 0.5)));
}

}  // namespace

extern "C" {

// src: (sh, sw, ch) uint8 -> dst: (dh, dw, ch) uint8, PIL-BILINEAR-style.
void resize_linear_u8(const uint8_t* src, int sh, int sw, int ch,
                      uint8_t* dst, int dh, int dw) {
    std::vector<double> xcoef, ycoef;
    std::vector<int> xfirst, xcount, yfirst, ycount;
    int xks, yks;
    build_taps(sw, dw, xcoef, xfirst, xcount, xks);
    build_taps(sh, dh, ycoef, yfirst, ycount, yks);

    // Horizontal pass into a temp (sh, dw, ch) double buffer.
    std::vector<double> tmp(static_cast<size_t>(sh) * dw * ch);
    for (int y = 0; y < sh; ++y) {
        const uint8_t* row = src + static_cast<size_t>(y) * sw * ch;
        double* trow = &tmp[static_cast<size_t>(y) * dw * ch];
        for (int x = 0; x < dw; ++x) {
            const double* k = &xcoef[static_cast<size_t>(x) * xks];
            int x0 = xfirst[x], n = xcount[x];
            for (int c = 0; c < ch; ++c) {
                double acc = 0.0;
                for (int t = 0; t < n; ++t)
                    acc += k[t] * row[(x0 + t) * ch + c];
                trow[x * ch + c] = acc;
            }
        }
    }
    // Vertical pass.
    for (int y = 0; y < dh; ++y) {
        const double* k = &ycoef[static_cast<size_t>(y) * yks];
        int y0 = yfirst[y], n = ycount[y];
        uint8_t* drow = dst + static_cast<size_t>(y) * dw * ch;
        for (int x = 0; x < dw; ++x) {
            for (int c = 0; c < ch; ++c) {
                double acc = 0.0;
                for (int t = 0; t < n; ++t)
                    acc += k[t] * tmp[(static_cast<size_t>(y0 + t) * dw + x) * ch + c];
                drow[x * ch + c] = clip8(acc);
            }
        }
    }
}

// Copy the region starting at source coords (ul_x, ul_y) into a zeroed
// (canvas, canvas, ch) float32 buffer scaled to [0, 1]; out-of-source area
// stays zero.
void pack_canvas_f32(const uint8_t* src, int sh, int sw, int ch,
                     float* dst, int canvas, int ul_x, int ul_y) {
    std::memset(dst, 0, sizeof(float) * static_cast<size_t>(canvas) * canvas * ch);
    int sy0 = std::max(0, ul_y), sx0 = std::max(0, ul_x);
    int sy1 = std::min(sh, ul_y + canvas), sx1 = std::min(sw, ul_x + canvas);
    if (sy1 <= sy0 || sx1 <= sx0) return;
    int dy0 = sy0 - ul_y, dx0 = sx0 - ul_x;
    const float inv = 1.0f / 255.0f;
    for (int y = sy0; y < sy1; ++y) {
        const uint8_t* srow = src + (static_cast<size_t>(y) * sw + sx0) * ch;
        float* drow = dst + (static_cast<size_t>(y - sy0 + dy0) * canvas + dx0) * ch;
        int count = (sx1 - sx0) * ch;
        for (int i = 0; i < count; ++i) drow[i] = srow[i] * inv;
    }
}

// Same clipped region copy, but kept uint8 (no normalization): the wire
// format for the u8 transport path, where [0,1] scaling happens on the card
// (ops/affine.py::crop_batch): 4x fewer bytes to the card than float32.
void pack_canvas_u8(const uint8_t* src, int sh, int sw, int ch,
                    uint8_t* dst, int canvas, int ul_x, int ul_y) {
    std::memset(dst, 0, static_cast<size_t>(canvas) * canvas * ch);
    int sy0 = std::max(0, ul_y), sx0 = std::max(0, ul_x);
    int sy1 = std::min(sh, ul_y + canvas), sx1 = std::min(sw, ul_x + canvas);
    if (sy1 <= sy0 || sx1 <= sx0) return;
    int dy0 = sy0 - ul_y, dx0 = sx0 - ul_x;
    size_t count = static_cast<size_t>(sx1 - sx0) * ch;
    for (int y = sy0; y < sy1; ++y) {
        const uint8_t* srow = src + (static_cast<size_t>(y) * sw + sx0) * ch;
        uint8_t* drow = dst + (static_cast<size_t>(y - sy0 + dy0) * canvas + dx0) * ch;
        std::memcpy(drow, srow, count);
    }
}

}  // extern "C"
