// Native host-side image preprocessing for the streaming video pipeline.
//
// The reference leans on external native code for its host pipeline
// (cv2 decode + PIL resize feeding the CUDA-graph loop,
// demo_streaming_inference.py:75-80,445-450). Here the hot host path —
// resize -> CLIP-normalize -> merger-aware patchify — is one fused C++ pass
// producing the flat patch layout the ViT's patch-embed matmul consumes, plus
// a pthread worker pipeline so frame preprocessing overlaps device compute
// (double buffering, the >=24 FPS requirement's host half).
//
// Built as a plain shared library; Python binds via ctypes (no pybind11 in
// the build). See native/__init__.py.

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

namespace {

inline float clampf(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Catmull-Rom-style cubic (a = -0.5), the classic bicubic kernel.
inline float cubic(float x) {
  const float a = -0.5f;
  x = std::fabs(x);
  if (x <= 1.0f) return ((a + 2.0f) * x - (a + 3.0f)) * x * x + 1.0f;
  if (x < 2.0f) return (((x - 5.0f) * x + 8.0f) * x - 4.0f) * a;
  return 0.0f;
}

// Resize HWC uint8 -> HWC float32, bilinear (align with the numpy fallback:
// sample centers, edge clamp) or bicubic.
void resize_f32(const uint8_t* in, int H, int W, int C, int oh, int ow,
                float* out, int bicubic) {
  for (int y = 0; y < oh; ++y) {
    float sy = (y + 0.5f) * H / oh - 0.5f;
    for (int x = 0; x < ow; ++x) {
      float sx = (x + 0.5f) * W / ow - 0.5f;
      float* dst = out + (static_cast<int64_t>(y) * ow + x) * C;
      if (bicubic) {
        int y0 = static_cast<int>(std::floor(sy));
        int x0 = static_cast<int>(std::floor(sx));
        for (int c = 0; c < C; ++c) dst[c] = 0.0f;
        float wsum = 0.0f;
        for (int dy = -1; dy <= 2; ++dy) {
          int yy = y0 + dy;
          yy = yy < 0 ? 0 : (yy >= H ? H - 1 : yy);
          float wy = cubic(sy - (y0 + dy));
          for (int dx = -1; dx <= 2; ++dx) {
            int xx = x0 + dx;
            xx = xx < 0 ? 0 : (xx >= W ? W - 1 : xx);
            float w = wy * cubic(sx - (x0 + dx));
            wsum += w;
            const uint8_t* src = in + (static_cast<int64_t>(yy) * W + xx) * C;
            for (int c = 0; c < C; ++c) dst[c] += w * src[c];
          }
        }
        float inv = 1.0f / wsum;
        for (int c = 0; c < C; ++c) dst[c] = clampf(dst[c] * inv, 0.f, 255.f);
      } else {
        int y0 = static_cast<int>(std::floor(sy));
        int x0 = static_cast<int>(std::floor(sx));
        int y0c = y0 < 0 ? 0 : (y0 >= H ? H - 1 : y0);
        int x0c = x0 < 0 ? 0 : (x0 >= W ? W - 1 : x0);
        int y1 = y0 + 1 >= H ? H - 1 : (y0 + 1 < 0 ? 0 : y0 + 1);
        int x1 = x0 + 1 >= W ? W - 1 : (x0 + 1 < 0 ? 0 : x0 + 1);
        float wy = sy - y0, wx = sx - x0;
        const uint8_t* p00 = in + (static_cast<int64_t>(y0c) * W + x0c) * C;
        const uint8_t* p01 = in + (static_cast<int64_t>(y0c) * W + x1) * C;
        const uint8_t* p10 = in + (static_cast<int64_t>(y1) * W + x0c) * C;
        const uint8_t* p11 = in + (static_cast<int64_t>(y1) * W + x1) * C;
        for (int c = 0; c < C; ++c) {
          float a = p00[c] * (1 - wy) * (1 - wx) + p01[c] * (1 - wy) * wx +
                    p10[c] * wy * (1 - wx) + p11[c] * wy * wx;
          dst[c] = a;
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Fused resize + CLIP normalize + merger-aware patchify for ONE frame
// (repeated across temporal_patch_size, the single-image path).
// out layout: [grid_h*grid_w, C*tps*patch*patch], transpose order
// (h_block, w_block, h_merge, w_merge, C, tps, ph, pw) — matches
// data/processing.py patchify exactly.
int ivl_preprocess_frame(const uint8_t* img, int H, int W, int C,
                         int out_h, int out_w, int patch, int tps, int merge,
                         const float* mean, const float* std, float* out,
                         int bicubic) {
  if (out_h % (patch * merge) || out_w % (patch * merge)) return -1;
  std::vector<float> resized(static_cast<size_t>(out_h) * out_w * C);
  resize_f32(img, H, W, C, out_h, out_w, resized.data(), bicubic);

  int gh = out_h / patch, gw = out_w / patch;
  int feat = C * tps * patch * patch;
  std::vector<float> inv_std(C), nmean(C);
  for (int c = 0; c < C; ++c) {
    inv_std[c] = 1.0f / (255.0f * std[c]);
    nmean[c] = mean[c] / std[c];
  }
  // token index in merger-aware order
  int tok = 0;
  for (int hb = 0; hb < gh / merge; ++hb)
    for (int wb = 0; wb < gw / merge; ++wb)
      for (int hm = 0; hm < merge; ++hm)
        for (int wm = 0; wm < merge; ++wm, ++tok) {
          int gr = hb * merge + hm;  // grid row
          int gc = wb * merge + wm;  // grid col
          float* dst = out + static_cast<int64_t>(tok) * feat;
          for (int c = 0; c < C; ++c)
            for (int t = 0; t < tps; ++t)
              for (int py = 0; py < patch; ++py)
                for (int px = 0; px < patch; ++px) {
                  int yy = gr * patch + py;
                  int xx = gc * patch + px;
                  float v = resized[(static_cast<int64_t>(yy) * out_w + xx) * C + c];
                  *dst++ = v * inv_std[c] - nmean[c];
                }
        }
  return gh * gw;
}

// ---------------------------------------------------------------------------
// Threaded prefetch pipeline: submit raw frames, collect preprocessed
// patch tensors; workers run while the device computes the previous frame.
// ---------------------------------------------------------------------------

struct Job {
  std::vector<uint8_t> img;
  int H, W, C, out_h, out_w, patch, tps, merge, bicubic;
  std::vector<float> mean, std;
  std::vector<float> out;
  int ticket;
  int status;  // 0 pending, 1 done, <0 error
};

struct Pipeline {
  std::deque<Job*> queue;
  std::vector<Job*> done;
  std::mutex mu;
  std::condition_variable cv;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};
  int next_ticket = 0;

  explicit Pipeline(int n) {
    for (int i = 0; i < n; ++i)
      workers.emplace_back([this] { run(); });
  }
  ~Pipeline() {
    stop = true;
    cv.notify_all();
    for (auto& t : workers) t.join();
    for (auto* j : queue) delete j;
    for (auto* j : done) delete j;
  }
  void run() {
    while (true) {
      Job* j = nullptr;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [this] { return stop || !queue.empty(); });
        if (stop && queue.empty()) return;
        j = queue.front();
        queue.pop_front();
      }
      int rc = ivl_preprocess_frame(j->img.data(), j->H, j->W, j->C, j->out_h,
                                    j->out_w, j->patch, j->tps, j->merge,
                                    j->mean.data(), j->std.data(),
                                    j->out.data(), j->bicubic);
      std::lock_guard<std::mutex> lk(mu);
      j->status = rc >= 0 ? 1 : rc;
      done.push_back(j);
      cv.notify_all();
    }
  }
};

void* ivl_pipeline_create(int workers) { return new Pipeline(workers); }

void ivl_pipeline_destroy(void* p) { delete static_cast<Pipeline*>(p); }

int ivl_pipeline_submit(void* p, const uint8_t* img, int H, int W, int C,
                        int out_h, int out_w, int patch, int tps, int merge,
                        const float* mean, const float* std, int bicubic) {
  auto* pl = static_cast<Pipeline*>(p);
  auto* j = new Job;
  j->img.assign(img, img + static_cast<size_t>(H) * W * C);
  j->H = H; j->W = W; j->C = C;
  j->out_h = out_h; j->out_w = out_w;
  j->patch = patch; j->tps = tps; j->merge = merge; j->bicubic = bicubic;
  j->mean.assign(mean, mean + C);
  j->std.assign(std, std + C);
  int gh = out_h / patch, gw = out_w / patch;
  j->out.resize(static_cast<size_t>(gh) * gw * C * tps * patch * patch);
  j->status = 0;
  std::lock_guard<std::mutex> lk(pl->mu);
  j->ticket = pl->next_ticket++;
  pl->queue.push_back(j);
  pl->cv.notify_one();
  return j->ticket;
}

// Blocking collect of a finished ticket; copies into caller buffer.
int ivl_pipeline_collect(void* p, int ticket, float* out, int64_t out_len) {
  auto* pl = static_cast<Pipeline*>(p);
  std::unique_lock<std::mutex> lk(pl->mu);
  while (true) {
    for (size_t i = 0; i < pl->done.size(); ++i) {
      Job* j = pl->done[i];
      if (j->ticket == ticket) {
        int st = j->status;
        if (st > 0) {
          size_t n = j->out.size();
          if (static_cast<int64_t>(n) > out_len) { return -2; }
          std::memcpy(out, j->out.data(), n * sizeof(float));
        }
        pl->done.erase(pl->done.begin() + i);
        delete j;
        return st;
      }
    }
    pl->cv.wait(lk);
  }
}

}  // extern "C"
