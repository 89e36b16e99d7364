// Native stereo-frame loader: PNG/PGM decode + threaded prefetch ring.
//
// The reference loads images synchronously on the pipeline thread with
// cv::imread (src/Stereo_Iterator.cpp:62-63,142-143), serializing disk I/O
// and decode with compute. Here a worker pool decodes frames ahead of the
// consumer into a bounded ring buffer so host I/O overlaps device compute
// (the host<->device pipeline of SURVEY.md §7 hard-part #6).
//
// Exposed as a C API consumed from Python via ctypes
// (edge_based_visual_odometry_tpu/io/native_loader.py).
//
// Build: g++ -O2 -shared -fPIC -o libebvo_loader.so loader.cpp -lpng -lz -lpthread

#include <png.h>

#include <atomic>
#include <condition_variable>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Decoders -> grayscale float32, resized buffer on mismatch is an error.
// ---------------------------------------------------------------------------

bool decode_png_gray(const std::string& path, std::vector<float>& out,
                     int expect_h, int expect_w) {
  FILE* fp = std::fopen(path.c_str(), "rb");
  if (!fp) return false;
  png_byte header[8];
  if (std::fread(header, 1, 8, fp) != 8 || png_sig_cmp(header, 0, 8)) {
    std::fclose(fp);
    return false;
  }
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    std::fclose(fp);
    return false;
  }
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    std::fclose(fp);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return false;
  }
  png_init_io(png, fp);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  const int w = png_get_image_width(png, info);
  const int h = png_get_image_height(png, info);
  const int color = png_get_color_type(png, info);
  const int depth = png_get_bit_depth(png, info);

  // normalize to 8-bit gray
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (depth == 16) png_set_strip_16(png);
  if (color & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  if (color == PNG_COLOR_TYPE_RGB || color == PNG_COLOR_TYPE_RGB_ALPHA ||
      color == PNG_COLOR_TYPE_PALETTE)
    png_set_rgb_to_gray_fixed(png, 1, -1, -1);
  png_read_update_info(png, info);

  if (h != expect_h || w != expect_w) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return false;
  }

  std::vector<png_byte> row(png_get_rowbytes(png, info));
  out.resize(size_t(h) * w);
  for (int y = 0; y < h; ++y) {
    png_read_row(png, row.data(), nullptr);
    for (int x = 0; x < w; ++x) out[size_t(y) * w + x] = float(row[x]);
  }
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  return true;
}

bool decode_pgm_gray(const std::string& path, std::vector<float>& out,
                     int expect_h, int expect_w) {
  FILE* fp = std::fopen(path.c_str(), "rb");
  if (!fp) return false;
  char magic[3] = {0};
  if (std::fscanf(fp, "%2s", magic) != 1 || std::strcmp(magic, "P5") != 0) {
    std::fclose(fp);
    return false;
  }
  // header ints with '#' comment-line handling (PGM allows comments
  // anywhere between tokens)
  int vals[3] = {0, 0, 0};
  for (int got = 0; got < 3;) {
    int c = std::fgetc(fp);
    if (c == EOF) {
      std::fclose(fp);
      return false;
    }
    if (c == '#') {
      while (c != '\n' && c != EOF) c = std::fgetc(fp);
    } else if (std::isspace(c)) {
      continue;
    } else {
      std::ungetc(c, fp);
      if (std::fscanf(fp, "%d", &vals[got]) != 1) {
        std::fclose(fp);
        return false;
      }
      ++got;
    }
  }
  const int w = vals[0], h = vals[1];
  if (w != expect_w || h != expect_h) {
    std::fclose(fp);
    return false;
  }
  std::fgetc(fp);  // single whitespace after header
  out.resize(size_t(h) * w);
  std::vector<uint8_t> buf(size_t(h) * w);
  if (std::fread(buf.data(), 1, buf.size(), fp) != buf.size()) {
    std::fclose(fp);
    return false;
  }
  for (size_t i = 0; i < buf.size(); ++i) out[i] = float(buf[i]);
  std::fclose(fp);
  return true;
}

bool decode_gray(const std::string& path, std::vector<float>& out, int h,
                 int w) {
  if (path.size() > 4 &&
      (path.compare(path.size() - 4, 4, ".pgm") == 0))
    return decode_pgm_gray(path, out, h, w);
  return decode_png_gray(path, out, h, w);
}

// ---------------------------------------------------------------------------
// Prefetching loader
// ---------------------------------------------------------------------------

struct Slot {
  std::vector<float> left, right;
  int frame = -1;
  bool ok = false;
  bool ready = false;
};

struct Loader {
  std::vector<std::string> lefts, rights;
  int h = 0, w = 0;
  size_t depth = 4;
  std::vector<Slot> ring;
  std::atomic<size_t> next_to_decode{0};
  size_t next_to_consume = 0;
  std::mutex mu;
  std::condition_variable cv;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};

  void worker() {
    while (!stop.load()) {
      const size_t idx = next_to_decode.fetch_add(1);
      if (idx >= lefts.size()) return;
      Slot tmp;
      tmp.frame = int(idx);
      tmp.ok = decode_gray(lefts[idx], tmp.left, h, w) &&
               decode_gray(rights[idx], tmp.right, h, w);
      // wait until the ring slot for idx is free (consumer caught up)
      std::unique_lock<std::mutex> lk(mu);
      cv.wait(lk, [&] {
        return stop.load() || idx < next_to_consume + depth;
      });
      if (stop.load()) return;
      Slot& s = ring[idx % depth];
      s = std::move(tmp);
      s.ready = true;
      cv.notify_all();
    }
  }

  int next(float* left_out, float* right_out) {
    if (next_to_consume >= lefts.size()) return -1;
    std::unique_lock<std::mutex> lk(mu);
    Slot& s = ring[next_to_consume % depth];
    cv.wait(lk, [&] {
      return s.ready && s.frame == int(next_to_consume);
    });
    int frame = -1;
    if (s.ok) {
      std::memcpy(left_out, s.left.data(), s.left.size() * sizeof(float));
      std::memcpy(right_out, s.right.data(), s.right.size() * sizeof(float));
      frame = s.frame;
    } else {
      frame = -2;  // decode failure; caller may skip
    }
    s.ready = false;
    ++next_to_consume;
    cv.notify_all();
    return frame;
  }
};

}  // namespace

extern "C" {

void* ebvo_loader_create(const char** left_paths, const char** right_paths,
                         int n, int h, int w, int prefetch_depth,
                         int n_threads) {
  auto* L = new Loader();
  L->lefts.assign(left_paths, left_paths + n);
  L->rights.assign(right_paths, right_paths + n);
  L->h = h;
  L->w = w;
  L->depth = size_t(prefetch_depth > 0 ? prefetch_depth : 4);
  L->ring.resize(L->depth);
  const int nt = n_threads > 0 ? n_threads : 2;
  for (int i = 0; i < nt; ++i)
    L->workers.emplace_back([L] { L->worker(); });
  return L;
}

int ebvo_loader_next(void* loader, float* left_out, float* right_out) {
  return static_cast<Loader*>(loader)->next(left_out, right_out);
}

void ebvo_loader_destroy(void* loader) {
  auto* L = static_cast<Loader*>(loader);
  L->stop.store(true);
  L->cv.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

int ebvo_decode_gray(const char* path, float* out, int h, int w) {
  std::vector<float> buf;
  if (!decode_gray(path, buf, h, w)) return -1;
  std::memcpy(out, buf.data(), buf.size() * sizeof(float));
  return 0;
}

}  // extern "C"
