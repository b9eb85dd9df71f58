// dyt_loader: native threaded image-decode pipeline for dynamic_tuning_tpu_torch.
//
// The reference delegates its data loading to torch DataLoader worker
// processes running PIL/decord (SURVEY.md §2: the repo itself has no native
// code; the native layer lives in its dependencies).  This is our equivalent
// native layer: a C++ worker pool that reads JPEG/PNG files, decodes with
// libjpeg/libpng, resizes (short side -> target, center crop) and assembles
// uint8 NHWC batches into preallocated buffers behind a bounded prefetch
// queue.  Exposed as a plain C ABI consumed via ctypes
// (dynamic_tuning_tpu_torch/data/native_loader.py).
//
// Build: g++ -O3 -march=native -shared -fPIC dyt_loader.cpp -o libdyt_loader.so -ljpeg -lpng -lpthread

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>
#include <setjmp.h>

namespace {

struct Image {
  std::vector<uint8_t> data;  // RGB HWC
  int h = 0, w = 0;
};

// ---------------------------------------------------------------- decode ---

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jb, 1);
}

bool decode_jpeg(const uint8_t* buf, size_t len, Image* out) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  // CMYK/YCCK JPEGs (PIL decodes these; ImageNet contains a few): libjpeg
  // can't convert them to RGB itself, so decode as CMYK and convert below.
  const bool cmyk = (cinfo.jpeg_color_space == JCS_CMYK ||
                     cinfo.jpeg_color_space == JCS_YCCK);
  cinfo.out_color_space = cmyk ? JCS_CMYK : JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  if (size_t(out->w) * out->h >= size_t(100) * 1000 * 1000) {
    jpeg_destroy_decompress(&cinfo);  // corrupt-header guard (see PNG path)
    return false;
  }
  out->data.resize(size_t(out->w) * out->h * 3);
  std::vector<uint8_t> cm;
  if (cmyk) cm.resize(size_t(out->w) * 4);
  const bool adobe = cinfo.saw_Adobe_marker != 0;
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* rgb = out->data.data() + size_t(cinfo.output_scanline) * out->w * 3;
    if (!cmyk) {
      jpeg_read_scanlines(&cinfo, &rgb, 1);
      continue;
    }
    uint8_t* crow = cm.data();
    jpeg_read_scanlines(&cinfo, &crow, 1);
    for (int x = 0; x < out->w; ++x) {
      // Adobe files store INVERTED ink (the common case; what PIL's
      // 'CMYK;I' rawmode + convert('RGB') yields): rgb = c*k/255.
      // Plain CMYK: rgb = (255-c)*(255-k)/255.
      const uint8_t* p = crow + size_t(x) * 4;
      const int k = adobe ? p[3] : 255 - p[3];
      for (int ch = 0; ch < 3; ++ch) {
        const int c = adobe ? p[ch] : 255 - p[ch];
        rgb[x * 3 + ch] = uint8_t((c * k + 127) / 255);
      }
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

bool decode_png_mem(const uint8_t* buf, size_t len, Image* out) {
  png_image img;
  memset(&img, 0, sizeof(img));
  img.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_memory(&img, buf, len)) return false;
  // read RGBA and DROP alpha below: asking libpng for RGB would composite
  // transparent pixels onto black, but PIL's convert('RGB') (the Python
  // loader path) discards the alpha band and keeps the raw RGB values
  img.format = PNG_FORMAT_RGBA;
  out->w = img.width;
  out->h = img.height;
  // adversarial-header guard: cap at ~100 MP so a corrupt 65500x65500
  // header fails the decode (zero-filled + counted) instead of throwing
  // bad_alloc out of the worker thread
  if (size_t(out->w) * out->h >= size_t(100) * 1000 * 1000) {
    png_image_free(&img);  // begin_read allocated internal state
    return false;
  }
  std::vector<uint8_t> rgba(PNG_IMAGE_SIZE(img));
  if (!png_image_finish_read(&img, nullptr, rgba.data(), 0, nullptr)) {
    png_image_free(&img);
    return false;
  }
  out->data.resize(size_t(out->w) * out->h * 3);
  const size_t n = size_t(out->w) * out->h;
  for (size_t i = 0; i < n; ++i) {
    out->data[i * 3] = rgba[i * 4];
    out->data[i * 3 + 1] = rgba[i * 4 + 1];
    out->data[i * 3 + 2] = rgba[i * 4 + 2];
  }
  return true;
}

bool read_file(const std::string& path, std::vector<uint8_t>* buf) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (n <= 0) {  // special files (FIFO/dir) report -1; don't resize(-1)
    fclose(f);
    return false;
  }
  buf->resize(n);
  size_t got = fread(buf->data(), 1, n, f);
  fclose(f);
  return got == size_t(n);
}

bool decode_any(const std::string& path, Image* out) {
  // one read, magic-byte dispatch (extensions lie; the buffer feeds both
  // decoders so PNGs aren't read from disk twice)
  std::vector<uint8_t> buf;
  if (!read_file(path, &buf) || buf.size() < 12) return false;
  if (buf[0] == 0x89 && buf[1] == 'P')
    return decode_png_mem(buf.data(), buf.size(), out);
  return decode_jpeg(buf.data(), buf.size(), out);
}

// ---------------------------------------------------------------- resize ---
//
// PIL-exact separable bicubic resampling.  The reference feeds the model
// PIL pixels (torchvision Resize/RandomResizedCrop with interpolation=3 =
// PIL.Image.BICUBIC, datasets/image_datasets.py:17,22) — PIL's bicubic is
// the Keys kernel a=-0.5 with filter support scaled by the downscale
// factor (antialiasing) and per-pass round+clip.  The Python loader path
// (data/datasets.py::decode_canvas) uses PIL itself; this reproduces it so
// pixels are identical (±1 fixed-point rounding) across backends.

double bicubic_w(double x) {  // PIL bicubic kernel, a = -0.5
  const double a = -0.5;
  x = x < 0 ? -x : x;
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

// PIL-spec coefficient build for one axis (ImagingPrecomputeCoeffs
// semantics, double precision instead of PIL's int16 fixed point).
int precompute_coeffs(int in_size, int out_size, std::vector<int>* bounds,
                      std::vector<float>* kk) {
  const double scale = double(in_size) / out_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = 2.0 * filterscale;
  const int ksize = int(ceil(support)) * 2 + 1;
  kk->assign(size_t(out_size) * ksize, 0.0);
  bounds->assign(size_t(out_size) * 2, 0);
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    const double ss = 1.0 / filterscale;
    int xmin = int(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = int(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    float* k = kk->data() + size_t(xx) * ksize;
    double ww = 0.0;
    std::vector<double> tmpw(xmax);
    for (int x = 0; x < xmax; ++x) {
      tmpw[x] = bicubic_w((x + xmin - center + 0.5) * ss);
      ww += tmpw[x];
    }
    for (int x = 0; x < xmax; ++x)
      k[x] = float(ww != 0.0 ? tmpw[x] / ww : tmpw[x]);
    (*bounds)[size_t(xx) * 2] = xmin;
    (*bounds)[size_t(xx) * 2 + 1] = xmax;
  }
  return ksize;
}

inline uint8_t clip8(float v) {
  const int i = int(v + 0.5f);  // PIL: round then clip, per pass
  return uint8_t(i < 0 ? 0 : (i > 255 ? 255 : i));
}

// Full-image resample to (nh, nw): horizontal pass then vertical pass with
// per-pass uint8 round+clip, like PIL's two-pass pipeline.  float
// accumulators; the vertical pass accumulates whole ROWS (sequential reads,
// auto-vectorizable) instead of walking columns.
void pil_resample(const Image& src, int nh, int nw, Image* dst) {
  std::vector<int> bx, by;
  std::vector<float> kx, ky;
  const int kxs = precompute_coeffs(src.w, nw, &bx, &kx);
  const int kys = precompute_coeffs(src.h, nh, &by, &ky);
  std::vector<uint8_t> tmp(size_t(src.h) * nw * 3);
  for (int y = 0; y < src.h; ++y) {
    const uint8_t* row = src.data.data() + size_t(y) * src.w * 3;
    uint8_t* orow = tmp.data() + size_t(y) * nw * 3;
    for (int x = 0; x < nw; ++x) {
      const int xmin = bx[size_t(x) * 2], xmax = bx[size_t(x) * 2 + 1];
      const float* k = kx.data() + size_t(x) * kxs;
      const uint8_t* p = row + size_t(xmin) * 3;
      float s0 = 0.f, s1 = 0.f, s2 = 0.f;
      for (int i = 0; i < xmax; ++i) {
        const float w = k[i];
        s0 += p[i * 3] * w;
        s1 += p[i * 3 + 1] * w;
        s2 += p[i * 3 + 2] * w;
      }
      orow[x * 3] = clip8(s0);
      orow[x * 3 + 1] = clip8(s1);
      orow[x * 3 + 2] = clip8(s2);
    }
  }
  dst->h = nh;
  dst->w = nw;
  dst->data.resize(size_t(nh) * nw * 3);
  std::vector<float> acc(size_t(nw) * 3);
  for (int y = 0; y < nh; ++y) {
    const int ymin = by[size_t(y) * 2], ymax = by[size_t(y) * 2 + 1];
    const float* k = ky.data() + size_t(y) * kys;
    std::fill(acc.begin(), acc.end(), 0.f);
    for (int i = 0; i < ymax; ++i) {
      const float w = k[i];
      const uint8_t* row = tmp.data() + size_t(ymin + i) * nw * 3;
      for (int j = 0; j < nw * 3; ++j) acc[j] += row[j] * w;
    }
    uint8_t* orow = dst->data.data() + size_t(y) * nw * 3;
    for (int j = 0; j < nw * 3; ++j) orow[j] = clip8(acc[j]);
  }
}

// torchvision CenterCrop offset: int(round(extra / 2.0)) with Python's
// round-half-even.
int center_off(int extra) {
  if (extra % 2 == 0) return extra / 2;
  const int k = extra / 2;      // floor (extra >= 0 here)
  return (k % 2 == 0) ? k : k + 1;
}

// Resize short side to `target` (torchvision size math: long side
// truncates), center-crop to target x target — the reference eval
// transform Resize(256)+CenterCrop (datasets/image_datasets.py:22-24
// scaled to the canvas).  Returns false on absurd geometry (extreme
// aspect ratios would overflow int / allocate GBs — treat like a decode
// failure: zero-fill + count, don't kill the run).
bool resize_center_crop(const Image& src, int target, uint8_t* dst) {
  const double long_side = src.w <= src.h
      ? double(target) * src.h / src.w
      : double(target) * src.w / src.h;
  if (long_side > 65535.0) return false;
  int nh, nw;
  if (src.w <= src.h) {
    nw = target;
    nh = int(long_side);
  } else {
    nh = target;
    nw = int(long_side);
  }
  Image r;
  pil_resample(src, nh, nw, &r);
  const int top = center_off(nh - target), left = center_off(nw - target);
  for (int y = 0; y < target; ++y)
    memcpy(dst + size_t(y) * target * 3,
           r.data.data() + (size_t(y + top) * nw + left) * 3,
           size_t(target) * 3);
  return true;
}

// Aspect-destroying square resize (the reference VTAB no-aug transform:
// Resize((224,224)), datasets/image_datasets_noaug.py:16-23).
bool resize_square(const Image& src, int target, uint8_t* dst) {
  Image r;
  pil_resample(src, target, target, &r);
  memcpy(dst, r.data.data(), size_t(target) * target * 3);
  return true;
}

// ---------------------------------------------------------------- loader ---

struct Batch {
  std::vector<uint8_t> images;
  std::vector<int32_t> labels;
  int count = 0;
};

struct Loader {
  std::vector<std::string> paths;
  std::vector<int32_t> labels;
  int batch_size = 0, canvas = 0, threads = 0, prefetch = 0;
  bool shuffle = false, drop_last = false, square = false;
  uint64_t seed = 0;
  int proc_index = 0, proc_count = 1;

  // per-epoch state
  std::vector<int64_t> order;
  std::atomic<int64_t> next_batch{0};
  int64_t num_batches = 0;

  // Batches are emitted in INDEX order regardless of worker completion
  // order: `ready` reorders, `next_emit` is the consumer cursor.  In-order
  // emission is load-bearing for multi-host eval — every process must see
  // the short tail batch at the SAME step or the global-array assembly in
  // shard_batch gets mismatched shapes across hosts (review finding).
  std::map<int64_t, Batch> ready;
  int64_t next_emit = 0;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};
  std::atomic<int> active_workers{0};
  std::atomic<int64_t> decode_failures{0};
  std::string error;  // first worker exception, surfaced via loader_next

  void build_order(int epoch) {
    // full index space (shuffled or sequential), padded to a multiple of
    // proc_count by repeating leading indices (DistributedSampler
    // semantics) so every process gets the same number of samples/batches,
    // then stride-sharded
    std::vector<int64_t> all(paths.size());
    for (size_t i = 0; i < all.size(); ++i) all[i] = i;
    if (shuffle) {
      std::mt19937_64 rng(seed + uint64_t(epoch));
      std::shuffle(all.begin(), all.end(), rng);
    }
    const int64_t total =
        (int64_t(all.size()) + proc_count - 1) / proc_count * proc_count;
    for (int64_t i = int64_t(all.size()); i < total; ++i)
      all.push_back(all[i - int64_t(paths.size())]);
    order.clear();
    for (size_t i = proc_index; i < all.size(); i += proc_count)
      order.push_back(all[i]);
    const int64_t n = order.size();
    num_batches = drop_last ? n / batch_size : (n + batch_size - 1) / batch_size;
    next_batch = 0;
  }

  void worker() {
    try {
      worker_loop();
    } catch (const std::exception& e) {
      // never let an exception escape the thread (std::terminate would
      // abort the whole training process); surface it to the consumer
      std::lock_guard<std::mutex> lk(mu);
      if (error.empty()) error = e.what();
      stop = true;
      cv_push.notify_all();
    } catch (...) {
      std::lock_guard<std::mutex> lk(mu);
      if (error.empty()) error = "unknown C++ exception in loader worker";
      stop = true;
      cv_push.notify_all();
    }
    if (active_workers.fetch_sub(1) == 1) {
      std::lock_guard<std::mutex> lk(mu);
      cv_pop.notify_all();
    }
  }

  void worker_loop() {
    const size_t img_bytes = size_t(canvas) * canvas * 3;
    while (!stop) {
      const int64_t b = next_batch.fetch_add(1);
      if (b >= num_batches) break;
      Batch batch;
      const int64_t start = b * batch_size;
      const int64_t end = std::min<int64_t>(start + batch_size,
                                            int64_t(order.size()));
      batch.count = int(end - start);
      batch.images.assign(size_t(batch_size) * img_bytes, 0);
      batch.labels.assign(batch_size, 0);
      for (int64_t i = start; i < end; ++i) {
        const int64_t idx = order[i];
        Image img;
        bool ok = decode_any(paths[idx], &img) && img.w > 1 && img.h > 1;
        if (ok) {
          uint8_t* out = batch.images.data() + size_t(i - start) * img_bytes;
          ok = square ? resize_square(img, canvas, out)
                      : resize_center_crop(img, canvas, out);
        }
        if (!ok) {
          // policy (pinned by tests): zero-fill and keep going, but COUNT
          // it and warn — silent black images skew training invisibly
          const int64_t k = decode_failures.fetch_add(1);
          if (k < 20)
            fprintf(stderr, "dyt_loader: decode failed (zero-filled): %s\n",
                    paths[idx].c_str());
          else if (k == 20)
            fprintf(stderr, "dyt_loader: further decode failures muted; "
                            "query dyt_loader_decode_failures()\n");
        }
        batch.labels[i - start] = labels[idx];
      }
      std::unique_lock<std::mutex> lk(mu);
      // bounded reorder window: a batch may only park once the consumer is
      // within `prefetch` of it.  The smallest outstanding index always
      // equals next_emit, so it is always admissible — no deadlock.
      cv_push.wait(lk, [&] { return stop || b < next_emit + prefetch; });
      if (stop) break;
      ready.emplace(b, std::move(batch));
      cv_pop.notify_all();
    }
  }

  void start_epoch(int epoch) {
    join_workers();
    build_order(epoch);
    stop = false;
    ready.clear();
    next_emit = 0;
    {  // don't carry a previous epoch's error into the new one
      std::lock_guard<std::mutex> lk(mu);
      error.clear();
    }
    active_workers = threads;
    for (int t = 0; t < threads; ++t)
      workers.emplace_back([this] { worker(); });
  }

  // returns actual sample count, 0 at end of epoch, -1 on worker error
  // (message via dyt_loader_error)
  int next(uint8_t* out_images, int32_t* out_labels) {
    std::unique_lock<std::mutex> lk(mu);
    cv_pop.wait(lk, [&] {
      return ready.count(next_emit) || active_workers == 0;
    });
    auto it = ready.find(next_emit);
    if (it == ready.end()) return error.empty() ? 0 : -1;
    Batch b = std::move(it->second);
    ready.erase(it);
    ++next_emit;
    cv_push.notify_all();
    lk.unlock();
    memcpy(out_images, b.images.data(), b.images.size());
    memcpy(out_labels, b.labels.data(), b.labels.size() * sizeof(int32_t));
    return b.count;
  }

  void join_workers() {
    {
      // set stop UNDER the mutex: a worker between its predicate check and
      // blocking on cv_push would otherwise miss this notify forever and
      // hang the join (classic missed-wakeup race)
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv_push.notify_all();
    for (auto& t : workers) t.join();
    workers.clear();
  }
};

}  // namespace

extern "C" {

void* dyt_loader_create(const char** paths, const int32_t* labels, int64_t n,
                        int batch_size, int canvas, int threads, int prefetch,
                        int shuffle, int drop_last, uint64_t seed,
                        int proc_index, int proc_count, int square) {
  auto* L = new Loader();
  if (batch_size <= 0) batch_size = 1;  // 0 would SIGFPE in the batch math
  L->paths.reserve(n);
  L->labels.assign(labels, labels + n);
  for (int64_t i = 0; i < n; ++i) L->paths.emplace_back(paths[i]);
  L->batch_size = batch_size;
  L->canvas = canvas;
  L->threads = threads > 0 ? threads : 4;
  L->prefetch = prefetch > 0 ? prefetch : 4;
  L->shuffle = shuffle != 0;
  L->drop_last = drop_last != 0;
  L->seed = seed;
  L->proc_index = proc_index;
  L->proc_count = proc_count > 0 ? proc_count : 1;
  L->square = square != 0;
  return L;
}

int64_t dyt_loader_num_batches(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  // padded-shard size: identical on every process
  const int64_t n = (int64_t(L->paths.size()) + L->proc_count - 1) /
                    L->proc_count;
  return L->drop_last ? n / L->batch_size
                      : (n + L->batch_size - 1) / L->batch_size;
}

void dyt_loader_start_epoch(void* handle, int epoch) {
  static_cast<Loader*>(handle)->start_epoch(epoch);
}

int dyt_loader_next(void* handle, uint8_t* images, int32_t* labels) {
  return static_cast<Loader*>(handle)->next(images, labels);
}

void dyt_loader_destroy(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  L->join_workers();
  delete L;
}

// cumulative decode failures (zero-filled images) since creation
int64_t dyt_loader_decode_failures(void* handle) {
  return static_cast<Loader*>(handle)->decode_failures.load();
}

// copy the first worker-exception message into buf; returns its length
// (0 = no error)
int dyt_loader_error(void* handle, char* buf, int len) {
  auto* L = static_cast<Loader*>(handle);
  std::lock_guard<std::mutex> lk(L->mu);
  const int n = int(std::min(L->error.size(), size_t(len > 0 ? len - 1 : 0)));
  if (n > 0) memcpy(buf, L->error.data(), n);
  if (len > 0) buf[n] = '\0';
  return int(L->error.size());
}

// standalone single-image decode (for tests / ad-hoc use)
int dyt_decode_resize(const char* path, int canvas, int square,
                      uint8_t* out) {
  Image img;
  if (!decode_any(path, &img) || img.w < 2 || img.h < 2) return 0;
  return (square ? resize_square(img, canvas, out)
                 : resize_center_crop(img, canvas, out)) ? 1 : 0;
}

}  // extern "C"
