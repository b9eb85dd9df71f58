// dyt_video: native video frame decoder for dynamic_tuning_tpu_torch.
//
// The reference delegates video decode to decord (K400,
// video_datasets/k400.py:115-117) and PyAV (SSv2,
// video_datasets/sthv2_dataset.py:115-121) — both thin wrappers over
// libav*.  This is our own native layer over the same libraries: demux ->
// decode -> swscale to RGB24 for a sorted list of wanted frame indices,
// exposed as a plain C ABI consumed via ctypes
// (dynamic_tuning_tpu_torch/data/native_video.py).  Sequential decode (no
// seeking) matches the PyAV reference path exactly and is the only
// frame-exact strategy for inter-coded streams.
//
// Build: g++ -O3 -shared -fPIC dyt_video.cpp -o libdyt_video.so \
//            -lavformat -lavcodec -lavutil -lswscale

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libswscale/swscale.h>
}

namespace {

struct Opened {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* dec = nullptr;
  int stream = -1;

  ~Opened() {
    if (dec) avcodec_free_context(&dec);
    if (fmt) avformat_close_input(&fmt);
  }

  bool open(const char* path) {
    if (avformat_open_input(&fmt, path, nullptr, nullptr) < 0) return false;
    if (avformat_find_stream_info(fmt, nullptr) < 0) return false;
    const AVCodec* codec = nullptr;
    stream = av_find_best_stream(fmt, AVMEDIA_TYPE_VIDEO, -1, -1, &codec, 0);
    if (stream < 0 || !codec) return false;
    dec = avcodec_alloc_context3(codec);
    if (!dec) return false;
    if (avcodec_parameters_to_context(dec, fmt->streams[stream]->codecpar) < 0)
      return false;
    dec->thread_count = 1;  // one worker thread per clip (pool parallelism
                            // lives in the Python loader workers)
    return avcodec_open2(dec, codec, nullptr) >= 0;
  }
};

}  // namespace

extern "C" {

// Probe geometry + frame count.  Returns 0 on success, -1 on failure.
// num_frames uses container metadata when present; falls back to a
// duration*fps estimate, then to a full packet count (always exact but
// reads the file).
int dyt_video_probe(const char* path, int* num_frames, int* h, int* w) {
  Opened v;
  if (!v.open(path)) return -1;
  AVStream* st = v.fmt->streams[v.stream];
  *h = v.dec->height;
  *w = v.dec->width;
  int64_t n = st->nb_frames;
  if (n <= 0 && st->duration > 0 && st->avg_frame_rate.num > 0) {
    n = av_rescale_q(st->duration, st->time_base,
                     av_inv_q(st->avg_frame_rate));
  }
  if (n <= 0) {
    AVPacket* pkt = av_packet_alloc();
    n = 0;
    while (av_read_frame(v.fmt, pkt) >= 0) {
      if (pkt->stream_index == v.stream) ++n;
      av_packet_unref(pkt);
    }
    av_packet_free(&pkt);
  }
  *num_frames = static_cast<int>(n);
  return 0;
}

// Decode the given (ascending, deduped) frame indices into out
// (n * h * w * 3, RGB24, rows tightly packed).  h/w must come from probe.
// Frames past the end of the stream repeat the last decoded frame (the
// Python backends clamp indices the same way).  Returns the number of
// wanted slots filled, or -1 on open/decode failure.
int dyt_video_decode(const char* path, const int* want, int n,
                     uint8_t* out, int h, int w) {
  if (n <= 0 || h <= 0 || w <= 0) return n <= 0 ? 0 : -1;
  Opened v;
  if (!v.open(path)) return -1;

  AVPacket* pkt = av_packet_alloc();
  AVFrame* frame = av_frame_alloc();
  AVFrame* last_dec = av_frame_alloc();  // ref to the LAST decoded frame,
                                         // kept for end-of-stream clamping
  SwsContext* sws = nullptr;
  const int last_want = want[n - 1];
  int idx = 0;        // decoded-frame counter
  int next = 0;       // next wanted slot
  int filled = 0;
  bool sws_failed = false;
  int sws_w = 0, sws_h = 0, sws_fmt = -1;  // geometry the context was built for

  auto scale_into = [&](AVFrame* f, uint8_t* dst) -> bool {
    if (!sws || f->width != sws_w || f->height != sws_h
        || f->format != sws_fmt) {
      // (re)build when geometry changes; a null context (w/h 0, exotic
      // pixel format) must not reach sws_scale — that segfaults
      if (sws) sws_freeContext(sws);
      sws = sws_getContext(f->width, f->height,
                           static_cast<AVPixelFormat>(f->format), w, h,
                           AV_PIX_FMT_RGB24, SWS_BILINEAR, nullptr,
                           nullptr, nullptr);
      sws_w = f->width;
      sws_h = f->height;
      sws_fmt = f->format;
    }
    if (!sws) {
      sws_failed = true;
      return false;
    }
    uint8_t* planes[1] = {dst};
    int strides[1] = {w * 3};
    sws_scale(sws, f->data, f->linesize, 0, f->height, planes, strides);
    return true;
  };

  auto emit = [&](AVFrame* f) {
    // one frame decoded with display index `idx`; copy into every wanted
    // slot that matches (duplicate indices in `want` are allowed)
    while (next < n && want[next] == idx) {
      uint8_t* dst = out + static_cast<size_t>(next) * h * w * 3;
      if (!scale_into(f, dst)) return;
      ++next;
      ++filled;
    }
    av_frame_unref(last_dec);
    av_frame_ref(last_dec, f);   // cheap: refcount bump, no pixel copy
    ++idx;
  };

  bool done = false;
  while (!done && !sws_failed && av_read_frame(v.fmt, pkt) >= 0) {
    if (pkt->stream_index == v.stream &&
        avcodec_send_packet(v.dec, pkt) >= 0) {
      while (avcodec_receive_frame(v.dec, frame) >= 0) {
        emit(frame);
        if (next >= n || idx > last_want) { done = true; break; }
      }
    }
    av_packet_unref(pkt);
  }
  if (!done && !sws_failed) {  // flush the decoder for trailing frames
    avcodec_send_packet(v.dec, nullptr);
    while (avcodec_receive_frame(v.dec, frame) >= 0) {
      emit(frame);
      if (next >= n || idx > last_want) break;
    }
  }
  // Clamp semantics: wanted indices past the real end of stream repeat the
  // last DECODED frame (np.minimum(idx, num_frames-1) in the Python
  // backends) — not the last wanted slot, which could be temporally far
  // from the end.  Covers probe overestimates on metadata-poor streams,
  // including the all-indices-past-EOF case (filled would otherwise be 0).
  if (next < n && !sws_failed && last_dec->width > 0) {
    uint8_t* first = out + static_cast<size_t>(next) * h * w * 3;
    if (scale_into(last_dec, first)) {
      ++next;
      ++filled;
      while (next < n) {
        std::memcpy(out + static_cast<size_t>(next) * h * w * 3, first,
                    static_cast<size_t>(h) * w * 3);
        ++next;
        ++filled;
      }
    }
  }

  if (sws) sws_freeContext(sws);
  av_frame_free(&last_dec);
  av_frame_free(&frame);
  av_packet_free(&pkt);
  return filled;
}

// Separable 4-tap resize of an RGB24 frame with CALLER-SUPPLIED tap tables
// (indices [n_out*4] int32 + weights [n_out*4] float32 per axis, computed
// in Python from the torch-bicubic matrix — data/video.py::_tb_taps keeps
// the kernel math single-sourced).  Same arithmetic as the numpy path:
// float32 accumulation in pair order (w0*a + w1*b) + (w2*c + w3*d), then
// +0.5, clip to [0,255], truncate to uint8.  The point of doing it here:
// ctypes releases the GIL for the call and -O3/-march=native vectorizes
// the row loops, so loader THREADS can resize concurrently with the main
// thread's H2D work (the numpy fancy-indexing path holds the GIL and
// measured 6.3 ms/frame; see BENCH.md round-5 decode correction).
int dyt_resize_bicubic(const uint8_t* in, int h, int w,
                       const int* ih, const float* wh, int nh,
                       const int* iw, const float* ww, int nw,
                       uint8_t* out) {
  if (h <= 0 || w <= 0 || nh <= 0 || nw <= 0) return -1;
  const int row = w * 3;
  std::vector<float> tmp(static_cast<size_t>(nh) * row);
  for (int i = 0; i < nh; ++i) {
    const uint8_t* r0 = in + static_cast<size_t>(ih[4 * i + 0]) * row;
    const uint8_t* r1 = in + static_cast<size_t>(ih[4 * i + 1]) * row;
    const uint8_t* r2 = in + static_cast<size_t>(ih[4 * i + 2]) * row;
    const uint8_t* r3 = in + static_cast<size_t>(ih[4 * i + 3]) * row;
    const float w0 = wh[4 * i + 0], w1 = wh[4 * i + 1];
    const float w2 = wh[4 * i + 2], w3 = wh[4 * i + 3];
    float* dst = tmp.data() + static_cast<size_t>(i) * row;
    for (int x = 0; x < row; ++x)
      dst[x] = (w0 * r0[x] + w1 * r1[x]) + (w2 * r2[x] + w3 * r3[x]);
  }
  for (int i = 0; i < nh; ++i) {
    const float* src = tmp.data() + static_cast<size_t>(i) * row;
    uint8_t* orow = out + static_cast<size_t>(i) * nw * 3;
    for (int j = 0; j < nw; ++j) {
      const float* p0 = src + 3 * iw[4 * j + 0];
      const float* p1 = src + 3 * iw[4 * j + 1];
      const float* p2 = src + 3 * iw[4 * j + 2];
      const float* p3 = src + 3 * iw[4 * j + 3];
      const float w0 = ww[4 * j + 0], w1 = ww[4 * j + 1];
      const float w2 = ww[4 * j + 2], w3 = ww[4 * j + 3];
      for (int c = 0; c < 3; ++c) {
        float v = (w0 * p0[c] + w1 * p1[c]) + (w2 * p2[c] + w3 * p3[c])
                  + 0.5f;
        v = v < 0.0f ? 0.0f : (v > 255.0f ? 255.0f : v);
        orow[3 * j + c] = static_cast<uint8_t>(v);
      }
    }
  }
  return 0;
}

}  // extern "C"
