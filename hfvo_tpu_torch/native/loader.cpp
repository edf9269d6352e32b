// Native RGB-D sequence loader: threaded PNG decode + prefetch ring.
//
// A copy of hfvo_tpu/native/loader.cpp (the port builds its own library, into
// build/hfvo_tpu_torch/, from this file).
//
// The reference's driver loads PNGs synchronously with cv::imread on the
// tracking thread (reference: Examples/RGB-D/rgbd_tum.cc:91-153); at 30 fps
// the decode cost eats into the tracking budget. This loader owns a worker
// pool that reads ahead through the association list and hands the host
// decoded float buffers, so the Python side only copies and uploads.
//
// Exposed as a C ABI for ctypes:
//   void* loader_create(const char* seq_dir, const char* assoc_path,
//                       double depth_factor, int n_workers, int queue_cap);
//   int   loader_frame_count(void* h);
//   int   loader_next(void* h, float* gray, float* depth, double* ts,
//                     int* w, int* h_out);   // 1 ok, 0 end, <0 error
//   void  loader_destroy(void* h);
//
// Build: g++ -O3 -shared -fPIC loader.cpp -o libhfvo_loader.so -lpng -lz -lpthread
#include <png.h>

#include <atomic>
#include <condition_variable>
#include <cstdio>
#include <cstring>
#include <deque>
#include <fstream>
#include <mutex>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Frame {
  long index = -1;
  double timestamp = 0;
  int width = 0, height = 0;
  std::vector<float> gray;   // intensity [0, 255]
  std::vector<float> depth;  // meters
  bool ok = false;
};

bool decode_png(const std::string& path, bool as_depth, double depth_factor,
                std::vector<float>& out, int& w, int& h) {
  FILE* fp = std::fopen(path.c_str(), "rb");
  if (!fp) return false;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    std::fclose(fp);
    return false;
  }
  png_infop info = png_create_info_struct(png);
  if (!info || setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return false;
  }
  png_init_io(png, fp);
  png_read_info(png, info);
  w = png_get_image_width(png, info);
  h = png_get_image_height(png, info);
  int color = png_get_color_type(png, info);
  int depth_bits = png_get_bit_depth(png, info);

  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth_bits < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  if (depth_bits == 16) png_set_swap(png);  // PNG is big-endian; we want LE
  png_read_update_info(png, info);

  int channels = png_get_channels(png, info);
  size_t rowbytes = png_get_rowbytes(png, info);
  std::vector<unsigned char> data(rowbytes * h);
  std::vector<png_bytep> rows(h);
  for (int y = 0; y < h; ++y) rows[y] = data.data() + y * rowbytes;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);

  out.resize(static_cast<size_t>(w) * h);
  if (as_depth) {
    // Depth PNGs are 16-bit grayscale scaled by depth_factor.
    if (depth_bits == 16 && channels == 1) {
      const uint16_t* p = reinterpret_cast<const uint16_t*>(data.data());
      const float inv = static_cast<float>(1.0 / depth_factor);
      for (size_t i = 0; i < out.size(); ++i) out[i] = p[i] * inv;
    } else {  // unusual 8-bit depth: still scale
      const float inv = static_cast<float>(1.0 / depth_factor);
      for (size_t i = 0; i < out.size(); ++i)
        out[i] = data[i * channels] * inv;
    }
  } else {
    if (depth_bits == 16) {
      const uint16_t* p = reinterpret_cast<const uint16_t*>(data.data());
      for (size_t i = 0; i < out.size(); ++i)
        out[i] = static_cast<float>(p[i * channels] >> 8);
    } else if (channels >= 3) {
      // BT.601 luma, matching cv::cvtColor RGB->GRAY in the reference.
      for (size_t i = 0; i < out.size(); ++i) {
        const unsigned char* px = &data[i * channels];
        out[i] = 0.299f * px[0] + 0.587f * px[1] + 0.114f * px[2];
      }
    } else {
      for (size_t i = 0; i < out.size(); ++i) out[i] = data[i * channels];
    }
  }
  return true;
}

struct Loader {
  std::string seq_dir;
  double depth_factor;
  struct Entry {
    double ts;
    std::string rgb, depth;
  };
  std::vector<Entry> entries;

  std::mutex mu;
  std::condition_variable cv_produced, cv_space;
  std::deque<Frame> ready;          // decoded frames ordered by index
  std::atomic<long> next_to_fetch{0};  // next index a worker should decode
  long next_to_emit = 0;            // next index the consumer needs
  size_t queue_cap;
  std::atomic<bool> stop{false};
  std::vector<std::thread> workers;

  void worker() {
    for (;;) {
      if (stop.load()) return;
      long idx = next_to_fetch.fetch_add(1);
      if (idx >= static_cast<long>(entries.size())) return;
      Frame f;
      f.index = idx;
      f.timestamp = entries[idx].ts;
      int w = 0, h = 0;
      bool ok1 = decode_png(seq_dir + "/" + entries[idx].rgb, false,
                            depth_factor, f.gray, w, h);
      f.width = w;
      f.height = h;
      int dw = 0, dh = 0;
      bool ok2 = decode_png(seq_dir + "/" + entries[idx].depth, true,
                            depth_factor, f.depth, dw, dh);
      f.ok = ok1 && ok2 && dw == w && dh == h;
      std::unique_lock<std::mutex> lk(mu);
      cv_space.wait(lk, [&] {
        return stop.load() || ready.size() < queue_cap ||
               idx < next_to_emit + static_cast<long>(queue_cap);
      });
      if (stop.load()) return;
      ready.push_back(std::move(f));
      cv_produced.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* loader_create(const char* seq_dir, const char* assoc_path,
                    double depth_factor, int n_workers, int queue_cap) {
  auto* L = new Loader();
  L->seq_dir = seq_dir;
  L->depth_factor = depth_factor <= 0 ? 5000.0 : depth_factor;
  L->queue_cap = queue_cap < 2 ? 8 : queue_cap;
  std::ifstream f(assoc_path);
  if (!f) {
    delete L;
    return nullptr;
  }
  std::string line;
  while (std::getline(f, line)) {
    if (line.empty() || line[0] == '#') continue;
    std::istringstream ss(line);
    double t1, t2;
    std::string rgb, depth;
    if (ss >> t1 >> rgb >> t2 >> depth)
      L->entries.push_back({t1, rgb, depth});
  }
  int n = n_workers < 1 ? 2 : n_workers;
  for (int i = 0; i < n; ++i) L->workers.emplace_back(&Loader::worker, L);
  return L;
}

int loader_frame_count(void* h) {
  return static_cast<int>(static_cast<Loader*>(h)->entries.size());
}

int loader_next(void* h, float* gray, float* depth, double* ts, int* w,
                int* hh) {
  auto* L = static_cast<Loader*>(h);
  std::unique_lock<std::mutex> lk(L->mu);
  if (L->next_to_emit >= static_cast<long>(L->entries.size())) return 0;
  long want = L->next_to_emit;
  for (;;) {
    for (auto it = L->ready.begin(); it != L->ready.end(); ++it) {
      if (it->index == want) {
        if (!it->ok) {
          L->ready.erase(it);
          ++L->next_to_emit;
          L->cv_space.notify_all();
          return -1;
        }
        *ts = it->timestamp;
        *w = it->width;
        *hh = it->height;
        std::memcpy(gray, it->gray.data(), it->gray.size() * sizeof(float));
        std::memcpy(depth, it->depth.data(), it->depth.size() * sizeof(float));
        L->ready.erase(it);
        ++L->next_to_emit;
        L->cv_space.notify_all();
        return 1;
      }
    }
    L->cv_produced.wait(lk);
    if (L->stop.load()) return 0;
  }
}

void loader_destroy(void* h) {
  auto* L = static_cast<Loader*>(h);
  L->stop.store(true);
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->cv_space.notify_all();
    L->cv_produced.notify_all();
  }
  for (auto& t : L->workers) t.join();
  delete L;
}

}  // extern "C"
