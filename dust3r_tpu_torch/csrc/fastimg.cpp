// Native host-side image ops for the data pipeline: the port's copy of
// native/fastimg.cpp, kept whole (its arithmetic is the JAX package's
// default loader path, held bit for bit by tests/test_torch_port_fastimg.py).
//
// The torch reference leans on torchvision/PIL for per-sample transforms;
// the TPU build's loader is torch-free, so the hot per-pixel host work
// (uint8 -> normalized float32 NHWC, depth validity masks, nearest-neighbor
// depth resize) lives here as a small OpenMP-parallel C++ core, bound via
// ctypes (no pybind11 in the image).
//
// Build: dust3r_tpu_torch/ops/_build.py::load_host_library, at first use
// (g++ -O3 -march=native -fopenmp -shared -fPIC).

#include <cstdint>
#include <cstring>
#include <cmath>

extern "C" {

// uint8 HWC -> float32 in [-1, 1] (ImgNorm: (x/255 - 0.5) / 0.5)
void imgnorm_u8_f32(const uint8_t* src, float* dst, int64_t n) {
    const float scale = 2.0f / 255.0f;
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        dst[i] = src[i] * scale - 1.0f;
    }
}

// float32 [-1,1] -> float32 [0,1] (rgb() display un-normalization)
void unnorm_f32(const float* src, float* dst, int64_t n) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        float v = src[i] * 0.5f + 0.5f;
        dst[i] = v < 0.0f ? 0.0f : (v > 1.0f ? 1.0f : v);
    }
}

// validity mask: depth > 0 and finite
void depth_valid_mask(const float* depth, uint8_t* mask, int64_t n) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        float d = depth[i];
        mask[i] = (d > 0.0f && std::isfinite(d)) ? 1 : 0;
    }
}

// nearest-neighbor resize for depth maps (matches cv2.INTER_NEAREST:
// src index = floor(dst * scale))
void resize_nearest_f32(const float* src, int64_t sh, int64_t sw,
                        float* dst, int64_t dh, int64_t dw) {
    const double fy = (double)sh / (double)dh;
    const double fx = (double)sw / (double)dw;
#pragma omp parallel for schedule(static)
    for (int64_t y = 0; y < dh; ++y) {
        int64_t sy = (int64_t)(y * fy);
        if (sy >= sh) sy = sh - 1;
        const float* srow = src + sy * sw;
        float* drow = dst + y * dw;
        for (int64_t x = 0; x < dw; ++x) {
            int64_t sx = (int64_t)(x * fx);
            if (sx >= sw) sx = sw - 1;
            drow[x] = srow[sx];
        }
    }
}

// ---------------------------------------------------------------------
// Fused ColorJitter + ImgNorm (the Co3d training loader's per-sample hot
// path: torchvision ColorJitter(0.5,0.5,0.5,0.1) semantics — factors
// applied in a caller-chosen random order — followed by the [-1,1]
// normalization). One float pass per op instead of PIL uint8 roundtrips;
// luma = ITU-R 601-2 (0.299, 0.587, 0.114) like PIL convert("L"); hue
// rotates in float HSV (exact turn fraction — torchvision's definition,
// tighter than the cv2 [0,180) quantization of the python fallback).
// ops[i]: 0=brightness 1=contrast 2=saturation 3=hue; factors[i] is the
// enhance factor (hue: shift as a fraction of a turn).

static inline float clamp255(float v) {
    return v < 0.0f ? 0.0f : (v > 255.0f ? 255.0f : v);
}

static void hue_shift_px(float* r, float* g, float* b, float shift) {
    float R = *r / 255.0f, G = *g / 255.0f, B = *b / 255.0f;
    float mx = R > G ? (R > B ? R : B) : (G > B ? G : B);
    float mn = R < G ? (R < B ? R : B) : (G < B ? G : B);
    float d = mx - mn;
    float h = 0.0f;
    if (d > 0.0f) {
        if (mx == R)      h = (G - B) / d;
        else if (mx == G) h = 2.0f + (B - R) / d;
        else              h = 4.0f + (R - G) / d;
        h /= 6.0f;
        if (h < 0.0f) h += 1.0f;
    }
    float s = mx > 0.0f ? d / mx : 0.0f;
    float v = mx;
    h += shift;
    h -= std::floor(h);
    float i = std::floor(h * 6.0f);
    float f = h * 6.0f - i;
    float p = v * (1.0f - s);
    float q = v * (1.0f - s * f);
    float t = v * (1.0f - s * (1.0f - f));
    switch ((int)i % 6) {
        case 0: R = v; G = t; B = p; break;
        case 1: R = q; G = v; B = p; break;
        case 2: R = p; G = v; B = t; break;
        case 3: R = p; G = q; B = v; break;
        case 4: R = t; G = p; B = v; break;
        default: R = v; G = p; B = q; break;
    }
    *r = R * 255.0f; *g = G * 255.0f; *b = B * 255.0f;
}

void color_jitter_norm_u8(const uint8_t* src, float* dst, int64_t n_px,
                          const int32_t* ops, int32_t n_ops,
                          const float* factors) {
    // work in float [0, 255]
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < 3 * n_px; ++i) dst[i] = (float)src[i];

    for (int32_t k = 0; k < n_ops; ++k) {
        const float f = factors[k];
        switch (ops[k]) {
            case 0: {  // brightness: blend with black
#pragma omp parallel for schedule(static)
                for (int64_t i = 0; i < 3 * n_px; ++i)
                    dst[i] = clamp255(dst[i] * f);
                break;
            }
            case 1: {  // contrast: blend with current mean luma
                double sum = 0.0;
#pragma omp parallel for schedule(static) reduction(+:sum)
                for (int64_t p = 0; p < n_px; ++p)
                    sum += 0.299f * dst[3 * p] + 0.587f * dst[3 * p + 1]
                         + 0.114f * dst[3 * p + 2];
                const float mean = (float)(sum / (double)n_px);
#pragma omp parallel for schedule(static)
                for (int64_t i = 0; i < 3 * n_px; ++i)
                    dst[i] = clamp255(f * dst[i] + (1.0f - f) * mean);
                break;
            }
            case 2: {  // saturation: blend with per-pixel luma
#pragma omp parallel for schedule(static)
                for (int64_t p = 0; p < n_px; ++p) {
                    float l = 0.299f * dst[3 * p] + 0.587f * dst[3 * p + 1]
                            + 0.114f * dst[3 * p + 2];
                    for (int c = 0; c < 3; ++c)
                        dst[3 * p + c] =
                            clamp255(f * dst[3 * p + c] + (1.0f - f) * l);
                }
                break;
            }
            case 3: {  // hue rotation in float HSV
#pragma omp parallel for schedule(static)
                for (int64_t p = 0; p < n_px; ++p)
                    hue_shift_px(&dst[3 * p], &dst[3 * p + 1],
                                 &dst[3 * p + 2], f);
                break;
            }
        }
    }
    const float scale = 2.0f / 255.0f;
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < 3 * n_px; ++i) dst[i] = dst[i] * scale - 1.0f;
}

// batched uint8 HWC -> normalized float32, many images at once
// (the collation hot loop of the training data loader)
void imgnorm_batch_u8_f32(const uint8_t* const* srcs, float* dst,
                          int64_t n_imgs, int64_t img_elems) {
#pragma omp parallel for schedule(dynamic, 1)
    for (int64_t b = 0; b < n_imgs; ++b) {
        const uint8_t* src = srcs[b];
        float* out = dst + b * img_elems;
        const float scale = 2.0f / 255.0f;
        for (int64_t i = 0; i < img_elems; ++i) {
            out[i] = src[i] * scale - 1.0f;
        }
    }
}

}  // extern "C"
