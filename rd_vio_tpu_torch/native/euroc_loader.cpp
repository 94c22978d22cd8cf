// Native EuRoC dataset loader: CSV parsing, libpng grayscale decode, and a
// background prefetch thread pool.
//
// Plays the role of the reference's C++ dataset layer
// (examples/dataset.hpp:259-624 csvReader + EuRoC reader) as a
// shared library consumed from Python via ctypes — the IO/runtime side of the
// framework stays native while compute lives in XLA (see SURVEY.md §2 L7).
//
// C API (all functions exported with C linkage):
//   rdvio_euroc_open(mav0_dir)             -> handle (0 on failure)
//   rdvio_euroc_imu_count(h)               -> n
//   rdvio_euroc_imu_data(h, out[n*7])      -> rows of (t, wx, wy, wz, ax, ay, az)
//   rdvio_euroc_frame_count(h)             -> n
//   rdvio_euroc_frame_times(h, out[n])     -> seconds
//   rdvio_euroc_image_size(h, &w, &hgt)    -> first image dims
//   rdvio_euroc_load_image(h, i, out)      -> grayscale float32 row-major
//   rdvio_euroc_prefetch(h, i, count)      -> warm the decode cache ahead
//   rdvio_euroc_close(h)

#include <png.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <fstream>
#include <map>
#include <memory>
#include <mutex>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

namespace {

struct ImuRow {
  double t, wx, wy, wz, ax, ay, az;
};

struct Decoded {
  int width = 0, height = 0;
  std::vector<float> pixels;
};

bool decode_png_gray(const std::string &path, Decoded &out) {
  FILE *fp = std::fopen(path.c_str(), "rb");
  if (!fp) return false;
  png_byte header[8];
  if (std::fread(header, 1, 8, fp) != 8 || png_sig_cmp(header, 0, 8)) {
    std::fclose(fp);
    return false;
  }
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return false;
  }
  png_init_io(png, fp);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  png_uint_32 w = png_get_image_width(png, info);
  png_uint_32 h = png_get_image_height(png, info);
  png_byte color = png_get_color_type(png, info);
  png_byte depth = png_get_bit_depth(png, info);

  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (color & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  if (color == PNG_COLOR_TYPE_RGB || color == PNG_COLOR_TYPE_PALETTE ||
      color == PNG_COLOR_TYPE_RGB_ALPHA)
    png_set_rgb_to_gray_fixed(png, 1, -1, -1);
  png_read_update_info(png, info);

  std::vector<png_byte> row(png_get_rowbytes(png, info));
  out.width = static_cast<int>(w);
  out.height = static_cast<int>(h);
  out.pixels.resize(static_cast<size_t>(w) * h);
  for (png_uint_32 y = 0; y < h; ++y) {
    png_read_row(png, row.data(), nullptr);
    for (png_uint_32 x = 0; x < w; ++x)
      out.pixels[static_cast<size_t>(y) * w + x] = static_cast<float>(row[x]);
  }
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  return true;
}

struct EurocHandle {
  std::vector<ImuRow> imu;
  std::vector<double> frame_t;
  std::vector<std::string> frame_files;
  int width = 0, height = 0;

  // prefetch cache: decoded frames by index, bounded LRU-ish window
  std::mutex mu;
  std::condition_variable cv;
  std::map<int, std::shared_ptr<Decoded>> cache;
  std::deque<int> pending;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};
  static constexpr size_t kMaxCache = 64;

  ~EurocHandle() {
    stop.store(true);
    cv.notify_all();
    for (auto &t : workers)
      if (t.joinable()) t.join();
  }

  void worker_loop() {
    for (;;) {
      int idx = -1;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] { return stop.load() || !pending.empty(); });
        if (stop.load()) return;
        idx = pending.front();
        pending.pop_front();
        if (cache.count(idx)) continue;
      }
      auto dec = std::make_shared<Decoded>();
      if (idx >= 0 && idx < static_cast<int>(frame_files.size()) &&
          decode_png_gray(frame_files[idx], *dec)) {
        std::lock_guard<std::mutex> lk(mu);
        cache[idx] = dec;
        while (cache.size() > kMaxCache) cache.erase(cache.begin());
        cv.notify_all();
      }
    }
  }

  std::shared_ptr<Decoded> get(int idx) {
    {
      std::lock_guard<std::mutex> lk(mu);
      auto it = cache.find(idx);
      if (it != cache.end()) return it->second;
    }
    auto dec = std::make_shared<Decoded>();
    if (!decode_png_gray(frame_files[idx], *dec)) return nullptr;
    std::lock_guard<std::mutex> lk(mu);
    cache[idx] = dec;
    while (cache.size() > kMaxCache) cache.erase(cache.begin());
    return dec;
  }
};

std::mutex g_handles_mu;
std::map<int64_t, std::unique_ptr<EurocHandle>> g_handles;
int64_t g_next_handle = 1;

bool split_csv(const std::string &line, std::vector<std::string> &out) {
  out.clear();
  std::stringstream ss(line);
  std::string item;
  while (std::getline(ss, item, ',')) out.push_back(item);
  return !out.empty();
}

}  // namespace

extern "C" {

int64_t rdvio_euroc_open(const char *mav0_dir, int n_threads) {
  auto h = std::make_unique<EurocHandle>();
  std::string root(mav0_dir);

  {
    std::ifstream f(root + "/imu0/data.csv");
    if (!f.good()) return 0;
    std::string line;
    std::vector<std::string> cols;
    while (std::getline(f, line)) {
      if (line.empty() || line[0] == '#') continue;
      if (!split_csv(line, cols) || cols.size() < 7) continue;
      ImuRow r;
      r.t = std::stoll(cols[0]) * 1e-9;
      r.wx = std::stod(cols[1]);
      r.wy = std::stod(cols[2]);
      r.wz = std::stod(cols[3]);
      r.ax = std::stod(cols[4]);
      r.ay = std::stod(cols[5]);
      r.az = std::stod(cols[6]);
      h->imu.push_back(r);
    }
  }
  {
    std::ifstream f(root + "/cam0/data.csv");
    if (!f.good()) return 0;
    std::string line;
    std::vector<std::string> cols;
    while (std::getline(f, line)) {
      if (line.empty() || line[0] == '#') continue;
      if (!split_csv(line, cols) || cols.size() < 2) continue;
      std::string fn = cols[1];
      while (!fn.empty() && (fn.back() == '\r' || fn.back() == '\n' || fn.back() == ' '))
        fn.pop_back();
      h->frame_t.push_back(std::stoll(cols[0]) * 1e-9);
      h->frame_files.push_back(root + "/cam0/data/" + fn);
    }
  }
  if (!h->frame_files.empty()) {
    Decoded d;
    if (decode_png_gray(h->frame_files[0], d)) {
      h->width = d.width;
      h->height = d.height;
    }
  }
  int nt = n_threads > 0 ? n_threads : 2;
  for (int i = 0; i < nt; ++i)
    h->workers.emplace_back(&EurocHandle::worker_loop, h.get());

  std::lock_guard<std::mutex> lk(g_handles_mu);
  int64_t id = g_next_handle++;
  g_handles[id] = std::move(h);
  return id;
}

static EurocHandle *lookup(int64_t id) {
  std::lock_guard<std::mutex> lk(g_handles_mu);
  auto it = g_handles.find(id);
  return it == g_handles.end() ? nullptr : it->second.get();
}

int64_t rdvio_euroc_imu_count(int64_t id) {
  auto *h = lookup(id);
  return h ? static_cast<int64_t>(h->imu.size()) : -1;
}

void rdvio_euroc_imu_data(int64_t id, double *out) {
  auto *h = lookup(id);
  if (!h) return;
  for (size_t i = 0; i < h->imu.size(); ++i) {
    const ImuRow &r = h->imu[i];
    double *o = out + i * 7;
    o[0] = r.t; o[1] = r.wx; o[2] = r.wy; o[3] = r.wz;
    o[4] = r.ax; o[5] = r.ay; o[6] = r.az;
  }
}

int64_t rdvio_euroc_frame_count(int64_t id) {
  auto *h = lookup(id);
  return h ? static_cast<int64_t>(h->frame_t.size()) : -1;
}

void rdvio_euroc_frame_times(int64_t id, double *out) {
  auto *h = lookup(id);
  if (!h) return;
  std::memcpy(out, h->frame_t.data(), h->frame_t.size() * sizeof(double));
}

void rdvio_euroc_image_size(int64_t id, int *w, int *hgt) {
  auto *h = lookup(id);
  if (!h) { *w = *hgt = 0; return; }
  *w = h->width;
  *hgt = h->height;
}

int rdvio_euroc_load_image(int64_t id, int64_t idx, float *out) {
  auto *h = lookup(id);
  if (!h || idx < 0 || idx >= static_cast<int64_t>(h->frame_files.size()))
    return -1;
  auto dec = h->get(static_cast<int>(idx));
  if (!dec) return -2;
  std::memcpy(out, dec->pixels.data(), dec->pixels.size() * sizeof(float));
  return 0;
}

void rdvio_euroc_prefetch(int64_t id, int64_t start, int64_t count) {
  auto *h = lookup(id);
  if (!h) return;
  std::lock_guard<std::mutex> lk(h->mu);
  for (int64_t i = start; i < start + count &&
       i < static_cast<int64_t>(h->frame_files.size()); ++i) {
    if (!h->cache.count(static_cast<int>(i)))
      h->pending.push_back(static_cast<int>(i));
  }
  h->cv.notify_all();
}

void rdvio_euroc_close(int64_t id) {
  std::lock_guard<std::mutex> lk(g_handles_mu);
  g_handles.erase(id);
}

}  // extern "C"
