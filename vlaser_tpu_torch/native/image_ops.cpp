// Copied from vlaser_tpu/native/image_ops.cpp for the PyTorch port. The
// only change is this header and the path of its Python binding, which is
// vlaser_tpu_torch/image/native.py here; native/build.py compiles it into
// vlaser_tpu_torch/_build/.
//
// Native host-side image preprocessing for the TPU data loader.
//
// The reference leans on cv2 (LANCZOS4 resize, env_adapter/simpler.py:83-87)
// and torchvision/PIL (bicubic resize + normalize, internvl/train/
// dataset.py:276-299) — both external native libraries. This is our own
// first-party implementation: separable Lanczos-4 / bicubic (a=-0.5, the
// PIL/OpenCV convention) resampling, ImageNet normalization fused into the
// resample output, and 448px tile cropping, threaded across a batch.
//
// Exposed as a plain C ABI consumed via ctypes (vlaser_tpu_torch/image/native.py).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

constexpr float kPi = 3.14159265358979323846f;

inline float sinc(float x) {
  if (x == 0.0f) return 1.0f;
  const float px = kPi * x;
  return std::sin(px) / px;
}

// Lanczos kernel, a taps each side (a=4 matches cv2 INTER_LANCZOS4).
inline float lanczos(float x, int a) {
  x = std::fabs(x);
  if (x >= static_cast<float>(a)) return 0.0f;
  return sinc(x) * sinc(x / static_cast<float>(a));
}

// Keys bicubic with a = -0.5 (PIL / OpenCV INTER_CUBIC convention).
inline float bicubic(float x) {
  constexpr float a = -0.5f;
  x = std::fabs(x);
  if (x < 1.0f) return ((a + 2.0f) * x - (a + 3.0f)) * x * x + 1.0f;
  if (x < 2.0f) return (((x - 5.0f) * x + 8.0f) * x - 4.0f) * a;
  return 0.0f;
}

struct Weights {
  // For each output coordinate: first source index + tap weights.
  std::vector<int> start;
  std::vector<float> w;  // [out_size * taps]
  int taps;
};

Weights build_weights(int in_size, int out_size, int support, bool use_lanczos) {
  const float scale = static_cast<float>(in_size) / out_size;
  const float filt_scale = std::max(scale, 1.0f);
  const float radius = support * filt_scale;
  const int taps = static_cast<int>(std::ceil(radius)) * 2 + 1;

  Weights ws;
  ws.taps = taps;
  ws.start.resize(out_size);
  ws.w.assign(static_cast<size_t>(out_size) * taps, 0.0f);

  for (int o = 0; o < out_size; ++o) {
    const float center = (o + 0.5f) * scale - 0.5f;
    int s0 = static_cast<int>(std::floor(center - radius + 0.5f));
    ws.start[o] = s0;
    float sum = 0.0f;
    for (int t = 0; t < taps; ++t) {
      const float x = (s0 + t - center) / filt_scale;
      const float wt = use_lanczos ? lanczos(x, support) : bicubic(x);
      ws.w[static_cast<size_t>(o) * taps + t] = wt;
      sum += wt;
    }
    if (sum != 0.0f) {
      for (int t = 0; t < taps; ++t)
        ws.w[static_cast<size_t>(o) * taps + t] /= sum;
    }
  }
  return ws;
}

// Separable resample of one HxWx3 uint8 image into float RGB [oh, ow, 3].
void resample_one(const uint8_t* src, int h, int w, float* dst, int oh, int ow,
                  bool use_lanczos, int support) {
  const Weights wx = build_weights(w, ow, support, use_lanczos);
  const Weights wy = build_weights(h, oh, support, use_lanczos);

  // horizontal pass: [h, ow, 3]
  std::vector<float> tmp(static_cast<size_t>(h) * ow * 3);
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y) * w * 3;
    float* trow = tmp.data() + static_cast<size_t>(y) * ow * 3;
    for (int x = 0; x < ow; ++x) {
      float acc[3] = {0, 0, 0};
      const int s0 = wx.start[x];
      for (int t = 0; t < wx.taps; ++t) {
        const int sx = std::clamp(s0 + t, 0, w - 1);
        const float wt = wx.w[static_cast<size_t>(x) * wx.taps + t];
        const uint8_t* px = row + static_cast<size_t>(sx) * 3;
        acc[0] += wt * px[0];
        acc[1] += wt * px[1];
        acc[2] += wt * px[2];
      }
      trow[x * 3 + 0] = acc[0];
      trow[x * 3 + 1] = acc[1];
      trow[x * 3 + 2] = acc[2];
    }
  }
  // vertical pass
  for (int y = 0; y < oh; ++y) {
    const int s0 = wy.start[y];
    float* drow = dst + static_cast<size_t>(y) * ow * 3;
    std::memset(drow, 0, sizeof(float) * ow * 3);
    for (int t = 0; t < wy.taps; ++t) {
      const int sy = std::clamp(s0 + t, 0, h - 1);
      const float wt = wy.w[static_cast<size_t>(y) * wy.taps + t];
      if (wt == 0.0f) continue;
      const float* trow = tmp.data() + static_cast<size_t>(sy) * ow * 3;
      for (int x = 0; x < ow * 3; ++x) drow[x] += wt * trow[x];
    }
  }
}

void parallel_for(int n, const std::function<void(int)>& fn) {
  const unsigned hw = std::max(1u, std::thread::hardware_concurrency());
  const int workers = static_cast<int>(std::min<unsigned>(hw, n));
  if (workers <= 1) {
    for (int i = 0; i < n; ++i) fn(i);
    return;
  }
  std::vector<std::thread> threads;
  std::atomic<int> next{0};
  for (int t = 0; t < workers; ++t) {
    threads.emplace_back([&] {
      int i;
      while ((i = next.fetch_add(1)) < n) fn(i);
    });
  }
  for (auto& th : threads) th.join();
}

constexpr float kMean[3] = {0.485f, 0.456f, 0.406f};
constexpr float kStd[3] = {0.229f, 0.224f, 0.225f};

}  // namespace

extern "C" {

// Batched resize: src [n, h, w, 3] uint8 -> dst [n, oh, ow, 3] float32.
// mode: 0 = bicubic, 1 = lanczos4. normalize: 0 = raw 0..255 floats,
// 1 = /255 then ImageNet mean/std.
void resize_batch(const uint8_t* src, int n, int h, int w, float* dst, int oh,
                  int ow, int mode, int normalize) {
  const bool lanc = mode == 1;
  const int support = lanc ? 4 : 2;
  parallel_for(n, [&](int i) {
    const uint8_t* s = src + static_cast<size_t>(i) * h * w * 3;
    float* d = dst + static_cast<size_t>(i) * oh * ow * 3;
    resample_one(s, h, w, d, oh, ow, lanc, support);
    if (normalize) {
      for (size_t p = 0; p < static_cast<size_t>(oh) * ow; ++p) {
        for (int c = 0; c < 3; ++c) {
          float v = d[p * 3 + c] * (1.0f / 255.0f);
          d[p * 3 + c] = (v - kMean[c]) / kStd[c];
        }
      }
    }
  });
}

// Normalize only: uint8 [n] RGB values -> ImageNet-normalized float32.
void normalize_batch(const uint8_t* src, float* dst, long long npix) {
  parallel_for(static_cast<int>((npix + (1 << 20) - 1) >> 20), [&](int blk) {
    const long long lo = static_cast<long long>(blk) << 20;
    const long long hi = std::min(npix, lo + (1 << 20));
    for (long long p = lo; p < hi; ++p) {
      for (int c = 0; c < 3; ++c) {
        float v = src[p * 3 + c] * (1.0f / 255.0f);
        dst[p * 3 + c] = (v - kMean[c]) / kStd[c];
      }
    }
  });
}

// Crop a resized [gh*tile, gw*tile, 3] float image into gh*gw tiles
// [gh*gw, tile, tile, 3] (dynamic_preprocess tiling, dataset.py:846-858).
void crop_tiles(const float* src, int gh, int gw, int tile, float* dst) {
  parallel_for(gh * gw, [&](int idx) {
    const int ty = idx / gw, tx = idx % gw;
    const int W = gw * tile;
    for (int y = 0; y < tile; ++y) {
      const float* srow =
          src + (static_cast<size_t>(ty) * tile + y) * W * 3 +
          static_cast<size_t>(tx) * tile * 3;
      float* drow = dst + (static_cast<size_t>(idx) * tile + y) * tile * 3;
      std::memcpy(drow, srow, sizeof(float) * tile * 3);
    }
  });
}

}  // extern "C"
