// Native frame-source runtime: multi-threaded producers + sequenced ring.
//
// The reference's data path is cv2.VideoCapture decoding frames one at a
// time on the consumer thread (data/loaders/video_loader.py:86-131), which
// serializes decode with compute.  This runtime decouples them: N producer
// threads fill a fixed-slot ring (synthetic generation or raw-file pread
// at computed offsets) while the Python consumer drains batches in frame
// order (straight into a pinned host buffer, runtime/stream.py), so host
// decode overlaps device execution.
//
// Concurrency model (Disruptor-style sequenced slots, no per-slot locks):
//   * producers claim frame indices from an atomic counter; frame i lives
//     in slot i % slots, so writers never contend for a slot;
//   * a producer may fill slot i once the consumer has drained frame
//     i - slots (ring depth credit);
//   * slot_ready[i % slots] publishes the frame index with release
//     semantics; the consumer takes frames strictly in order.
// One mutex + two condvars carry the blocking edges (throughput here is
// bounded by memory bandwidth, not synchronization).
//
// C ABI only — consumed via ctypes (runtime/loader.py), no Python headers.
//
// Build: runtime/loader.py `build_runtime` compiles it at first use with
//   c++ -O2 -fPIC -std=c++17 -shared frame_ring.cpp -lpthread
// into runtime/build/libmadpp_runtime.so.

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct FrameRing {
  int width = 0;
  int height = 0;
  int channels = 3;
  int slots = 0;
  size_t frame_bytes = 0;

  std::vector<uint8_t> storage;             // slots * frame_bytes
  std::vector<std::atomic<int64_t>> ready;  // frame idx published per slot

  std::mutex mu;
  std::condition_variable not_empty;
  std::condition_variable not_full;

  std::atomic<int64_t> next_claim{0};   // next frame index to produce
  std::atomic<int64_t> consumed{0};     // frames drained (in order)
  std::atomic<int64_t> produced{0};
  std::atomic<int64_t> total{-1};       // stream length once known
  std::atomic<bool> stop{false};

  std::vector<std::thread> producers;
  void* background = nullptr;  // Background*, owned; freed in ring_destroy

  uint8_t* slot_ptr(int64_t i) { return storage.data() + (i % slots) * frame_bytes; }
};

// --- synthetic road-frame rasterizer -------------------------------------
// Mirrors the reference generator's geometry: sky gradient,
// grass, road trapezoid to a vanishing point, solid lane edges.  Static
// rows (sky/grass/road base) are rasterized once into a per-ring template
// and memcpy'd per frame — the per-pixel cost is only the dynamic vehicle
// and the lane lines, leaving frame production memory-bandwidth-bound.

void draw_line(uint8_t* img, int w, int h, int x0, int y0, int x1, int y1,
               int thickness, uint8_t b, uint8_t g, uint8_t r) {
  int dx = std::abs(x1 - x0), dy = std::abs(y1 - y0);
  int steps = std::max(dx, dy);
  if (steps == 0) steps = 1;
  for (int i = 0; i <= steps; ++i) {
    int x = x0 + (x1 - x0) * i / steps;
    int y = y0 + (y1 - y0) * i / steps;
    for (int ty = -thickness / 2; ty <= thickness / 2; ++ty) {
      for (int tx = -thickness / 2; tx <= thickness / 2; ++tx) {
        int px = x + tx, py = y + ty;
        if (px >= 0 && px < w && py >= 0 && py < h) {
          uint8_t* p = img + (py * w + px) * 3;
          p[0] = b; p[1] = g; p[2] = r;
        }
      }
    }
  }
}

// Static background (everything except the drifting vehicle), built once.
void build_background(uint8_t* img, int w, int h) {
  const int vp_x = static_cast<int>(w * 0.5);
  const int vp_y = static_cast<int>(h * 0.45);
  const int left_x = static_cast<int>(w * 0.15);
  const int right_x = static_cast<int>(w * 0.85);

  // Sky gradient: one 3-byte pattern per row, duplicated across the row.
  for (int y = 0; y < vp_y; ++y) {
    int shade = 200 - 60 * y / vp_y;
    uint8_t px[3] = {static_cast<uint8_t>(std::min(255, shade + 55)),
                     static_cast<uint8_t>(shade),
                     static_cast<uint8_t>(std::max(0, shade - 30))};
    uint8_t* row = img + static_cast<size_t>(y) * w * 3;
    for (int x = 0; x < w; ++x) std::memcpy(row + x * 3, px, 3);
  }
  // Grass: constant — build the first row, memcpy the rest.
  if (vp_y < h) {
    uint8_t* first = img + static_cast<size_t>(vp_y) * w * 3;
    for (int x = 0; x < w; ++x) {
      first[x * 3 + 0] = 40; first[x * 3 + 1] = 110; first[x * 3 + 2] = 50;
    }
    for (int y = vp_y + 1; y < h; ++y)
      std::memcpy(img + static_cast<size_t>(y) * w * 3, first,
                  static_cast<size_t>(w) * 3);
  }
  // Road trapezoid: per-row segment fill.
  for (int y = vp_y; y < h; ++y) {
    double t = static_cast<double>(y - vp_y) / (h - vp_y);
    int lx = static_cast<int>(vp_x - 8 + t * ((left_x - 30) - (vp_x - 8)));
    int rx = static_cast<int>(vp_x + 8 + t * ((right_x + 30) - (vp_x + 8)));
    uint8_t* row = img + static_cast<size_t>(y) * w * 3;
    for (int x = std::max(0, lx); x < std::min(w, rx); ++x) {
      row[x * 3 + 0] = 60; row[x * 3 + 1] = 60; row[x * 3 + 2] = 60;
    }
  }
  // Lane edge lines.
  draw_line(img, w, h, left_x, h - 1, vp_x, vp_y, 5, 240, 240, 240);
  draw_line(img, w, h, right_x, h - 1, vp_x, vp_y, 5, 240, 240, 240);
}

struct Background {
  std::vector<uint8_t> pixels;
  std::once_flag once;
};

void synth_frame(uint8_t* img, int w, int h, int64_t frame_idx, Background* bg) {
  std::call_once(bg->once, [&] {
    bg->pixels.resize(static_cast<size_t>(w) * h * 3);
    build_background(bg->pixels.data(), w, h);
  });
  std::memcpy(img, bg->pixels.data(), bg->pixels.size());

  const int vp_x = static_cast<int>(w * 0.5);
  const int vp_y = static_cast<int>(h * 0.45);
  // A drifting vehicle so frames are not static.
  double tt = frame_idx * 0.05;
  int depth_px = static_cast<int>(h - (0.45 + 0.2 * std::sin(tt)) * (h - vp_y));
  int cx = vp_x + static_cast<int>(60 * std::sin(tt * 0.7));
  int bw = 70, bh = 50;
  for (int y = std::max(0, depth_px - bh); y < std::min(h, depth_px); ++y) {
    for (int x = std::max(0, cx - bw / 2); x < std::min(w, cx + bw / 2); ++x) {
      uint8_t* p = img + (static_cast<size_t>(y) * w + x) * 3;
      p[0] = 30; p[1] = 30; p[2] = 160;
    }
  }
}

// Claim frame indices and fill slots until the stream is exhausted.
// fill(frame_idx, dst) -> false on producer-side failure (truncated file).
template <typename Fill>
void producer_loop(FrameRing* ring, int64_t num_frames, Fill fill) {
  for (;;) {
    int64_t i = ring->next_claim.fetch_add(1);
    if (i >= num_frames || ring->stop.load(std::memory_order_acquire)) break;

    // Wait for ring-depth credit: slot i % slots is free once the consumer
    // has drained frame i - slots.
    {
      std::unique_lock<std::mutex> lk(ring->mu);
      ring->not_full.wait(lk, [&] {
        return i - ring->consumed.load(std::memory_order_acquire) < ring->slots ||
               ring->stop.load(std::memory_order_acquire);
      });
      if (ring->stop.load(std::memory_order_acquire)) break;
    }

    if (!fill(i, ring->slot_ptr(i))) {
      // Truncated stream: everything before i may still drain.
      int64_t cur = ring->total.load();
      while ((cur < 0 || i < cur) &&
             !ring->total.compare_exchange_weak(cur, i)) {
      }
      std::lock_guard<std::mutex> lk(ring->mu);
      ring->not_empty.notify_all();
      break;
    }

    ring->ready[i % ring->slots].store(i, std::memory_order_release);
    ring->produced.fetch_add(1);
    std::lock_guard<std::mutex> lk(ring->mu);
    ring->not_empty.notify_all();
  }
}

}  // namespace

extern "C" {

FrameRing* ring_create(int width, int height, int slots) {
  // slots == 0 would be modulo-by-zero UB in slot indexing; non-positive
  // dims would wrap frame_bytes through the size_t cast.
  if (width <= 0 || height <= 0 || slots <= 0) return nullptr;
  auto* ring = new FrameRing();
  ring->width = width;
  ring->height = height;
  ring->slots = slots;
  ring->frame_bytes = static_cast<size_t>(width) * height * 3;
  ring->storage.resize(ring->frame_bytes * slots);
  ring->ready = std::vector<std::atomic<int64_t>>(slots);
  for (auto& r : ring->ready) r.store(-1);
  return ring;
}

static int resolve_threads(int threads) {
  if (threads > 0) return threads;
  unsigned hw = std::thread::hardware_concurrency();
  int n = static_cast<int>(hw ? hw / 2 : 4);
  return n < 1 ? 1 : (n > 8 ? 8 : n);
}

// threads <= 0 selects an automatic count (half the cores, capped at 8).
void ring_start_synthetic(FrameRing* ring, int64_t num_frames, int threads) {
  ring->total.store(num_frames);
  auto* bg = new Background();
  ring->background = bg;  // freed in ring_destroy after producers join
  int n = resolve_threads(threads);
  for (int t = 0; t < n; ++t) {
    ring->producers.emplace_back([ring, num_frames, bg] {
      producer_loop(ring, num_frames, [ring, bg](int64_t i, uint8_t* dst) {
        synth_frame(dst, ring->width, ring->height, i, bg);
        return true;
      });
    });
  }
}

// Raw packed BGR frames: every producer opens its own descriptor and
// preads at i * frame_bytes — no shared file position, no serialization.
// Returns 0 on success, -1 when the file cannot be opened (otherwise a
// bad path would surface as a silent empty stream, indistinguishable from
// a legitimately empty source).
int ring_start_rawfile(FrameRing* ring, const char* path, int64_t num_frames,
                       int threads) {
  {
    FILE* probe = std::fopen(path, "rb");
    if (!probe) return -1;
    std::fclose(probe);
  }
  ring->total.store(num_frames);
  std::string p(path);
  int n = resolve_threads(threads);
  for (int t = 0; t < n; ++t) {
    ring->producers.emplace_back([ring, p, num_frames] {
      FILE* f = std::fopen(p.c_str(), "rb");
      producer_loop(ring, num_frames, [ring, f](int64_t i, uint8_t* dst) {
        if (!f) return false;
        if (std::fseek(f, static_cast<long>(i * ring->frame_bytes), SEEK_SET))
          return false;
        return std::fread(dst, 1, ring->frame_bytes, f) == ring->frame_bytes;
      });
      if (f) std::fclose(f);
    });
  }
  return 0;
}

// Copy the next frame into out (H*W*3 bytes).  Returns the frame index, or
// -1 when the stream is exhausted, or -2 on timeout.
int64_t ring_next(FrameRing* ring, uint8_t* out, int timeout_ms) {
  int64_t want = ring->consumed.load(std::memory_order_acquire);
  std::unique_lock<std::mutex> lk(ring->mu);
  bool ok = ring->not_empty.wait_for(
      lk, std::chrono::milliseconds(timeout_ms), [&] {
        int64_t total = ring->total.load(std::memory_order_acquire);
        if (total >= 0 && want >= total) return true;  // exhausted
        return ring->ready[want % ring->slots].load(std::memory_order_acquire) ==
               want;
      });
  if (!ok) return -2;
  int64_t total = ring->total.load(std::memory_order_acquire);
  if (total >= 0 && want >= total) return -1;
  lk.unlock();

  std::memcpy(out, ring->slot_ptr(want), ring->frame_bytes);
  ring->consumed.store(want + 1, std::memory_order_release);
  {
    std::lock_guard<std::mutex> lk2(ring->mu);
    ring->not_full.notify_all();
  }
  return want;
}

// Drain up to n frames into a contiguous buffer.  Returns the count copied
// (stopping early only at stream exhaustion), or -(i+1) when frame i timed
// out — a transient producer stall must stay distinguishable from
// end-of-stream, or a 5-second disk hiccup silently truncates the run.
int64_t ring_next_batch(FrameRing* ring, uint8_t* out, int64_t n, int timeout_ms) {
  for (int64_t i = 0; i < n; ++i) {
    int64_t idx = ring_next(ring, out + i * ring->frame_bytes, timeout_ms);
    if (idx == -2) return -(i + 1);
    if (idx < 0) return i;  // -1: exhausted
  }
  return n;
}

int64_t ring_produced(FrameRing* ring) { return ring->produced.load(); }
int64_t ring_consumed(FrameRing* ring) { return ring->consumed.load(); }

void ring_destroy(FrameRing* ring) {
  ring->stop.store(true, std::memory_order_release);
  {
    std::lock_guard<std::mutex> lk(ring->mu);
    ring->not_empty.notify_all();
    ring->not_full.notify_all();
  }
  for (auto& p : ring->producers)
    if (p.joinable()) p.join();
  delete static_cast<Background*>(ring->background);
  delete ring;
}

}  // extern "C"
