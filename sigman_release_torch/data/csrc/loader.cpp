// Threaded JPEG / PNG decode + bilinear resize for the HGS-1M reader.
//
// The port's own copy of the JAX package's native decoder, with its C ABI and
// semantics: the decoder is chosen by the file's magic bytes, the image is
// resized bilinearly with half-pixel centres, a missing channel is broadcast
// from the last one, and a file that fails to decode gives a zero frame in a
// batch. Built with g++ at first use (sigman_release_torch/utils/cuda_build.py)
// and loaded with ctypes (sigman_release_torch/data/native_loader.py).
//
// JPEG: libjpeg where its header is found; otherwise nvJPEG of the CUDA
// toolkit (the build defines SLR_NVJPEG), whose RGB result is copied back to
// the host before the same resize. PNG: a decoder on zlib's inflate that
// applies the transforms the JAX package asks of libpng (16 -> 8 bits by the
// high byte, palette -> RGB, 1/2/4-bit grey -> 8 bits, tRNS -> alpha, Adam7).
//
// API (0 on success, negative otherwise):
//   slr_init()                        the JPEG backend's set-up
//   slr_jpeg_backend()                "libjpeg" or "nvjpeg"
//   slr_decode_file(path, out_f32, target_h, target_w, channels)
//       one file into HWC float32 in [0, 1]
//   slr_decode_batch(paths, n, out_f32, target_h, target_w, channels, n_threads)
//       n files at once into [n, H, W, C]; returns -(files that failed)

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#include <zlib.h>

#ifdef SLR_NVJPEG
#include <cuda_runtime.h>
#include <nvjpeg.h>
#else
#include <csetjmp>

#include <jpeglib.h>
#endif

namespace {

struct Image {
  std::vector<uint8_t> pixels;  // HWC uint8
  int h = 0, w = 0, c = 0;
};

// ---------------------------------------------------------------- JPEG

// libjpeg's YCbCr -> RGB (used on the nvJPEG path) in its integer arithmetic (jdcolor.c: 16-bit
// fixed-point tables, rounding, clamped to [0, 255]).
struct YccTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  YccTables() {
    const int32_t half = 1 << 15;
    auto fix = [](double x) { return int32_t(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; ++i) {
      const int32_t x = i - 128;
      cr_r[i] = int((fix(1.40200) * x + half) >> 16);
      cb_b[i] = int((fix(1.77200) * x + half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
  }
};

uint8_t clamp255(int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); }

// libjpeg's "fancy" (triangle-filter) chroma upsampling of one plane of
// cw x ch samples to w x h (jdsample.c h2v1 / h2v2; edge rows replicated),
// hs / vs the horizontal / vertical factors (1 or 2).
void fancy_upsample(const uint8_t* in, int cw, int ch, int hs, int vs, int w,
                    int h, uint8_t* out) {
  std::vector<int> row(static_cast<size_t>(cw));
  std::vector<uint8_t> wide(static_cast<size_t>(cw) * hs);
  for (int y = 0; y < h; ++y) {
    const int r = y / vs;
    const uint8_t* a = in + size_t(r) * cw;
    if (vs == 2) {  // h2v2: 3 x nearest row + the next-nearest, as col sums
      const int rn = (y % 2 == 0) ? (r > 0 ? r - 1 : 0)
                                  : (r + 1 < ch ? r + 1 : ch - 1);
      const uint8_t* b = in + size_t(rn) * cw;
      for (int x = 0; x < cw; ++x) row[x] = a[x] * 3 + b[x];
      if (cw == 1) {
        wide[0] = uint8_t((row[0] * 4 + 8) >> 4);
        wide[1] = uint8_t((row[0] * 4 + 7) >> 4);
      } else {
        for (int x = 0; x < cw; ++x) {
          const int last = x > 0 ? row[x - 1] : -1;
          const int next = x + 1 < cw ? row[x + 1] : -1;
          wide[2 * x] = uint8_t(last < 0 ? (row[x] * 4 + 8) >> 4
                                         : (row[x] * 3 + last + 8) >> 4);
          wide[2 * x + 1] = uint8_t(next < 0 ? (row[x] * 4 + 7) >> 4
                                             : (row[x] * 3 + next + 7) >> 4);
        }
      }
    } else if (hs == 2) {  // h2v1
      for (int x = 0; x < cw; ++x) {
        const int v = a[x];
        if (cw == 1) {
          wide[0] = wide[1] = uint8_t(v);
          continue;
        }
        wide[2 * x] = uint8_t(x == 0 ? v : (v * 3 + a[x - 1] + 1) >> 2);
        wide[2 * x + 1] =
            uint8_t(x + 1 == cw ? v : (v * 3 + a[x + 1] + 2) >> 2);
      }
    } else {
      std::memcpy(wide.data(), a, size_t(cw));
    }
    std::memcpy(out + size_t(y) * w, wide.data(), size_t(w));
  }
}


#ifdef SLR_NVJPEG

// One handle for the process; a pool of (state, stream, device buffer), one
// taken by each decode while it runs. Nothing in the pool is freed, so no
// decode synchronises the device through cudaFree (but when a buffer grows).
struct NvCtx {
  nvjpegJpegState_t state = nullptr;
  cudaStream_t stream = nullptr;
  unsigned char* dbuf = nullptr;
  size_t cap = 0;
};

nvjpegHandle_t g_handle = nullptr;
int g_init_status = 0;
std::once_flag g_init_once;
std::mutex g_pool_mu;
std::vector<NvCtx*> g_pool;

int jpeg_init() {
  std::call_once(g_init_once, [] {
    int dev_count = 0;
    if (cudaGetDeviceCount(&dev_count) != cudaSuccess || dev_count < 1) {
      g_init_status = -10;
      return;
    }
    if (nvjpegCreateSimple(&g_handle) != NVJPEG_STATUS_SUCCESS) {
      g_init_status = -11;
    }
  });
  return g_init_status;
}

NvCtx* acquire() {
  {
    std::lock_guard<std::mutex> lock(g_pool_mu);
    if (!g_pool.empty()) {
      NvCtx* c = g_pool.back();
      g_pool.pop_back();
      return c;
    }
  }
  auto* c = new NvCtx();
  if (nvjpegJpegStateCreate(g_handle, &c->state) != NVJPEG_STATUS_SUCCESS ||
      cudaStreamCreateWithFlags(&c->stream, cudaStreamNonBlocking) !=
          cudaSuccess) {
    return nullptr;  // leaks one half-made context; decode reports failure
  }
  return c;
}

void release(NvCtx* c) {
  std::lock_guard<std::mutex> lock(g_pool_mu);
  g_pool.push_back(c);
}

bool decode_jpeg(const uint8_t* data, size_t len, Image* out) {
  if (jpeg_init() != 0) return false;
  int n_comp = 0;
  nvjpegChromaSubsampling_t sub;
  int widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
  if (nvjpegGetImageInfo(g_handle, data, len, &n_comp, &sub, widths,
                         heights) != NVJPEG_STATUS_SUCCESS) {
    return false;
  }
  const int w = widths[0], h = heights[0];
  if (w <= 0 || h <= 0) return false;
  // planes nvJPEG returns: Y alone (grey), Y Cb Cr at their own sizes
  // (4:4:4, 4:2:2, 4:2:0: upsampled and converted here as libjpeg does),
  // else interleaved RGB of nvJPEG's own conversion
  const bool grey = n_comp == 1 || sub == NVJPEG_CSS_GRAY;
  const bool ycc = !grey && n_comp == 3 &&
                   (sub == NVJPEG_CSS_444 || sub == NVJPEG_CSS_422 ||
                    sub == NVJPEG_CSS_420);
  nvjpegOutputFormat_t fmt = grey  ? NVJPEG_OUTPUT_Y
                             : ycc ? NVJPEG_OUTPUT_YUV
                                   : NVJPEG_OUTPUT_RGBI;
  const int n_planes = grey ? 1 : ycc ? 3 : 1;
  size_t plane_off[3] = {0, 0, 0}, need = 0;
  int pw[3] = {w, 0, 0}, ph[3] = {h, 0, 0};
  for (int c = 0; c < n_planes; ++c) {
    if (ycc) {
      pw[c] = widths[c];
      ph[c] = heights[c];
    }
    plane_off[c] = need;
    need += size_t(pw[c]) * ph[c] * (fmt == NVJPEG_OUTPUT_RGBI ? 3 : 1);
  }
  NvCtx* c = acquire();
  if (!c) return false;
  bool ok = true;
  if (need > c->cap) {
    if (c->dbuf) cudaFree(c->dbuf);
    c->dbuf = nullptr;
    c->cap = 0;
    if (cudaMalloc(&c->dbuf, need) != cudaSuccess) {
      ok = false;
    } else {
      c->cap = need;
    }
  }
  std::vector<uint8_t> host(need);
  if (ok) {
    nvjpegImage_t img;
    std::memset(&img, 0, sizeof(img));
    for (int p = 0; p < n_planes; ++p) {
      img.channel[p] = c->dbuf + plane_off[p];
      img.pitch[p] = size_t(pw[p]) * (fmt == NVJPEG_OUTPUT_RGBI ? 3 : 1);
    }
    ok = nvjpegDecode(g_handle, c->state, data, len, fmt, &img, c->stream) ==
             NVJPEG_STATUS_SUCCESS &&
         cudaMemcpyAsync(host.data(), c->dbuf, need, cudaMemcpyDeviceToHost,
                         c->stream) == cudaSuccess &&
         cudaStreamSynchronize(c->stream) == cudaSuccess;
  }
  release(c);
  if (!ok) return false;
  out->w = w;
  out->h = h;
  out->c = 3;
  out->pixels.resize(size_t(w) * h * 3);
  uint8_t* px = out->pixels.data();
  const size_t n = size_t(w) * h;
  if (fmt == NVJPEG_OUTPUT_RGBI) {
    std::memcpy(px, host.data(), n * 3);
  } else if (grey) {
    for (size_t i = 0; i < n; ++i) px[3 * i] = px[3 * i + 1] = px[3 * i + 2] =
        host[i];
  } else {
    static const YccTables t;
    const int hs = sub == NVJPEG_CSS_444 ? 1 : 2;
    const int vs = sub == NVJPEG_CSS_420 ? 2 : 1;
    std::vector<uint8_t> cb(n), cr(n);
    fancy_upsample(host.data() + plane_off[1], pw[1], ph[1], hs, vs, w, h,
                   cb.data());
    fancy_upsample(host.data() + plane_off[2], pw[2], ph[2], hs, vs, w, h,
                   cr.data());
    const uint8_t* yp = host.data();
    for (size_t i = 0; i < n; ++i) {
      const int y = yp[i];
      px[3 * i] = clamp255(y + t.cr_r[cr[i]]);
      px[3 * i + 1] = clamp255(y + int((t.cb_g[cb[i]] + t.cr_g[cr[i]]) >> 16));
      px[3 * i + 2] = clamp255(y + t.cb_b[cb[i]]);
    }
  }
  return true;
}

const char* kJpegBackend = "nvjpeg";

#else  // libjpeg

int jpeg_init() { return 0; }

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

bool decode_jpeg(const uint8_t* data, size_t len, Image* out) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  out->c = 3;
  out->pixels.resize(size_t(out->h) * out->w * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row =
        out->pixels.data() + size_t(cinfo.output_scanline) * out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

const char* kJpegBackend = "libjpeg";

#endif  // SLR_NVJPEG

// ----------------------------------------------------------------- PNG

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

uint16_t be16(const uint8_t* p) { return uint16_t((p[0] << 8) | p[1]); }

struct PngInfo {
  uint32_t w = 0, h = 0;
  int depth = 0, color = 0, interlace = 0;
  uint8_t palette[256][3] = {};
  uint8_t pal_alpha[256];
  int n_trans = 0;       // tRNS entries (palette) or 1 (grey / RGB key)
  uint16_t key[3] = {};  // tRNS colour key of grey / RGB
  bool has_trns = false;
};

int samples_of(int color) {
  switch (color) {
    case 0: return 1;  // grey
    case 2: return 3;  // RGB
    case 3: return 1;  // palette index
    case 4: return 2;  // grey + alpha
    case 6: return 4;  // RGBA
  }
  return 0;
}

bool valid_header(const PngInfo& in) {
  const int d = in.depth;
  switch (in.color) {
    case 0: return d == 1 || d == 2 || d == 4 || d == 8 || d == 16;
    case 3: return d == 1 || d == 2 || d == 4 || d == 8;
    case 2: case 4: case 6: return d == 8 || d == 16;
  }
  return false;
}

uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = p > a ? p - a : a - p;
  const int pb = p > b ? p - b : b - p;
  const int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return uint8_t(a);
  if (pb <= pc) return uint8_t(b);
  return uint8_t(c);
}

// Undo the filters of `rows` scanlines of `rowbytes` bytes each, in place
// (each line led by its filter byte). False on an unknown filter type.
bool unfilter(uint8_t* buf, size_t rows, size_t rowbytes, size_t bpp) {
  const uint8_t* prev = nullptr;
  for (size_t y = 0; y < rows; ++y) {
    uint8_t* line = buf + y * (rowbytes + 1);
    const int type = line[0];
    uint8_t* cur = line + 1;
    for (size_t i = 0; i < rowbytes; ++i) {
      const int a = i >= bpp ? cur[i - bpp] : 0;
      const int b = prev ? prev[i] : 0;
      const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
      switch (type) {
        case 0: break;
        case 1: cur[i] = uint8_t(cur[i] + a); break;
        case 2: cur[i] = uint8_t(cur[i] + b); break;
        case 3: cur[i] = uint8_t(cur[i] + ((a + b) >> 1)); break;
        case 4: cur[i] = uint8_t(cur[i] + paeth(a, b, c)); break;
        default: return false;
      }
    }
    prev = cur;
  }
  return true;
}

// Raw sample `s` of pixel x in an unfiltered line (bit depth <= 16).
int sample_at(const uint8_t* line, uint32_t x, int s, int n_samples,
              int depth) {
  if (depth == 16) {
    return be16(line + (size_t(x) * n_samples + s) * 2);
  }
  if (depth == 8) return line[size_t(x) * n_samples + s];
  // packed 1/2/4-bit samples (grey or palette: one sample per pixel), MSB
  // first
  const size_t bit = size_t(x) * depth;
  const int shift = 8 - depth - int(bit % 8);
  return (line[bit / 8] >> shift) & ((1 << depth) - 1);
}

// One decoded pixel into `dst` (the output channels of `in`).
void put_pixel(const PngInfo& in, const uint8_t* line, uint32_t x,
               uint8_t* dst) {
  const int n = samples_of(in.color);
  const int d = in.depth;
  auto hi8 = [d](int v) { return uint8_t(d == 16 ? v >> 8 : v); };
  switch (in.color) {
    case 0: {
      const int v = sample_at(line, x, 0, n, d);
      uint8_t g;
      if (d < 8) {
        g = uint8_t(v * (d == 1 ? 0xff : d == 2 ? 0x55 : 0x11));
      } else {
        g = hi8(v);
      }
      dst[0] = g;
      if (in.has_trns) {
        const int key = d == 16 ? in.key[0] : in.key[0] & ((1 << d) - 1);
        dst[1] = v == key ? 0 : 255;
      }
      break;
    }
    case 2: {
      int v[3];
      for (int s = 0; s < 3; ++s) {
        v[s] = sample_at(line, x, s, n, d);
        dst[s] = hi8(v[s]);
      }
      if (in.has_trns) {
        const int m = d == 16 ? 0xffff : 0xff;
        const bool hit = v[0] == (in.key[0] & m) && v[1] == (in.key[1] & m) &&
                         v[2] == (in.key[2] & m);
        dst[3] = hit ? 0 : 255;
      }
      break;
    }
    case 3: {
      const int i = sample_at(line, x, 0, n, d);
      dst[0] = in.palette[i][0];
      dst[1] = in.palette[i][1];
      dst[2] = in.palette[i][2];
      if (in.has_trns) dst[3] = i < in.n_trans ? in.pal_alpha[i] : 255;
      break;
    }
    case 4: case 6:
      for (int s = 0; s < n; ++s) dst[s] = hi8(sample_at(line, x, s, n, d));
      break;
  }
}

bool decode_png(const uint8_t* data, size_t len, Image* out) {
  static const uint8_t kSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  if (len < 8 || std::memcmp(data, kSig, 8) != 0) return false;
  PngInfo in;
  std::memset(in.pal_alpha, 255, sizeof(in.pal_alpha));
  std::vector<uint8_t> idat;
  bool have_header = false, have_plte = false, have_end = false;
  size_t pos = 8;
  while (pos + 12 <= len && !have_end) {
    const uint32_t n = be32(data + pos);
    const uint8_t* type = data + pos + 4;
    if (n > len - pos - 12) return false;
    const uint8_t* body = data + pos + 8;
    const bool critical = !(type[0] & 0x20);
    const uint32_t crc = uint32_t(crc32(0L, type, n + 4));
    pos += 12 + size_t(n);
    if (crc != be32(body + n)) {
      if (critical) return false;
      continue;  // a damaged ancillary chunk is dropped
    }
    if (!std::memcmp(type, "IHDR", 4)) {
      if (n != 13) return false;
      in.w = be32(body);
      in.h = be32(body + 4);
      in.depth = body[8];
      in.color = body[9];
      in.interlace = body[12];
      if (body[10] != 0 || body[11] != 0 || in.interlace > 1 ||
          !valid_header(in) || in.w == 0 || in.h == 0 ||
          in.w > (1u << 16) || in.h > (1u << 16)) {
        return false;
      }
      have_header = true;
    } else if (!have_header) {
      return false;
    } else if (!std::memcmp(type, "PLTE", 4)) {
      if (n % 3 || n / 3 > 256) return false;
      for (uint32_t i = 0; i < n / 3; ++i) {
        for (int k = 0; k < 3; ++k) in.palette[i][k] = body[3 * i + k];
      }
      have_plte = true;
    } else if (!std::memcmp(type, "tRNS", 4)) {
      if (in.color == 3 && n <= 256) {
        in.n_trans = int(n);
        for (uint32_t i = 0; i < n; ++i) in.pal_alpha[i] = body[i];
        in.has_trns = n > 0;
      } else if (in.color == 0 && n == 2) {
        in.key[0] = be16(body);
        in.has_trns = true;
      } else if (in.color == 2 && n == 6) {
        for (int k = 0; k < 3; ++k) in.key[k] = be16(body + 2 * k);
        in.has_trns = true;
      }
    } else if (!std::memcmp(type, "IDAT", 4)) {
      idat.insert(idat.end(), body, body + n);
    } else if (!std::memcmp(type, "IEND", 4)) {
      have_end = true;
    }
  }
  if (!have_header || idat.empty() || (in.color == 3 && !have_plte)) {
    return false;
  }

  // the passes: (x0, y0, dx, dy), Adam7 or the whole image
  static const int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8},
                                   {2, 0, 4, 4}, {0, 2, 2, 4}, {1, 0, 2, 2},
                                   {0, 1, 1, 2}};
  static const int kWhole[1][4] = {{0, 0, 1, 1}};
  const int (*passes)[4] = in.interlace ? kAdam7 : kWhole;
  const int n_passes = in.interlace ? 7 : 1;
  const int n_samples = samples_of(in.color);
  const size_t bits_pp = size_t(n_samples) * in.depth;
  const size_t bpp = bits_pp < 8 ? 1 : bits_pp / 8;
  size_t total = 0;
  uint32_t pw[7], ph[7];
  for (int p = 0; p < n_passes; ++p) {
    const uint32_t x0 = passes[p][0], y0 = passes[p][1];
    const uint32_t dx = passes[p][2], dy = passes[p][3];
    pw[p] = in.w > x0 ? (in.w - x0 + dx - 1) / dx : 0;
    ph[p] = in.h > y0 ? (in.h - y0 + dy - 1) / dy : 0;
    if (pw[p] && ph[p]) total += size_t(ph[p]) * ((pw[p] * bits_pp + 7) / 8 + 1);
  }
  std::vector<uint8_t> raw(total);
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return false;
  zs.next_in = idat.data();
  zs.avail_in = uInt(idat.size());
  zs.next_out = raw.data();
  zs.avail_out = uInt(raw.size());
  int ret = Z_OK;
  while (zs.avail_out > 0 && ret == Z_OK) ret = inflate(&zs, Z_NO_FLUSH);
  inflateEnd(&zs);
  if (zs.avail_out != 0 || (ret != Z_OK && ret != Z_STREAM_END)) return false;

  const int out_c = n_samples + ((in.color == 3) ? 2 : 0) +
                    ((in.has_trns && (in.color == 0 || in.color == 2 ||
                                      in.color == 3)) ? 1 : 0);
  out->w = int(in.w);
  out->h = int(in.h);
  out->c = out_c;
  out->pixels.assign(size_t(in.h) * in.w * out_c, 0);
  size_t off = 0;
  for (int p = 0; p < n_passes; ++p) {
    if (!pw[p] || !ph[p]) continue;
    const size_t rowbytes = (pw[p] * bits_pp + 7) / 8;
    uint8_t* buf = raw.data() + off;
    if (!unfilter(buf, ph[p], rowbytes, bpp)) return false;
    for (uint32_t y = 0; y < ph[p]; ++y) {
      const uint8_t* line = buf + size_t(y) * (rowbytes + 1) + 1;
      const size_t oy = passes[p][1] + size_t(y) * passes[p][3];
      for (uint32_t x = 0; x < pw[p]; ++x) {
        const size_t ox = passes[p][0] + size_t(x) * passes[p][2];
        put_pixel(in, line, x, out->pixels.data() + (oy * in.w + ox) * out_c);
      }
    }
    off += size_t(ph[p]) * (rowbytes + 1);
  }
  return true;
}

bool decode_any(const uint8_t* data, size_t len, Image* out) {
  if (len >= 3 && data[0] == 0xFF && data[1] == 0xD8) {
    return decode_jpeg(data, len, out);
  }
  return decode_png(data, len, out);
}

// bilinear resize HWC uint8 -> HWC float32 in [0,1] with `channels` outputs
// (missing channels broadcast from the last available one; extra dropped)
void resize_to(const Image& img, float* out, int th, int tw, int channels) {
  const float sx = float(img.w) / tw;
  const float sy = float(img.h) / th;
  for (int y = 0; y < th; ++y) {
    // half-pixel centres (align_corners=False), clamped at the edges
    float fy = (y + 0.5f) * sy - 0.5f;
    if (fy < 0) fy = 0;
    if (fy > img.h - 1) fy = float(img.h - 1);
    int y0 = int(fy);
    int y1 = y0 + 1 < img.h ? y0 + 1 : y0;
    float wy = fy - y0;
    for (int x = 0; x < tw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      if (fx < 0) fx = 0;
      if (fx > img.w - 1) fx = float(img.w - 1);
      int x0 = int(fx);
      int x1 = x0 + 1 < img.w ? x0 + 1 : x0;
      float wx = fx - x0;
      for (int ch = 0; ch < channels; ++ch) {
        int c = ch < img.c ? ch : img.c - 1;
        auto at = [&](int yy, int xx) {
          return float(img.pixels[(size_t(yy) * img.w + xx) * img.c + c]);
        };
        float v = at(y0, x0) * (1 - wx) * (1 - wy) + at(y0, x1) * wx * (1 - wy) +
                  at(y1, x0) * (1 - wx) * wy + at(y1, x1) * wx * wy;
        out[(size_t(y) * tw + x) * channels + ch] = v / 255.0f;
      }
    }
  }
}

int decode_one(const char* path, float* out, int th, int tw, int channels) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long len = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(len > 0 ? size_t(len) : 0);
  if (len <= 0 || std::fread(buf.data(), 1, len, f) != size_t(len)) {
    std::fclose(f);
    return -2;
  }
  std::fclose(f);
  Image img;
  if (!decode_any(buf.data(), buf.size(), &img)) return -3;
  resize_to(img, out, th, tw, channels);
  return 0;
}

}  // namespace

extern "C" {

int slr_init() { return jpeg_init(); }

const char* slr_jpeg_backend() { return kJpegBackend; }

int slr_decode_file(const char* path, float* out, int target_h, int target_w,
                    int channels) {
  return decode_one(path, out, target_h, target_w, channels);
}

int slr_decode_batch(const char** paths, int n, float* out, int target_h,
                     int target_w, int channels, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next{0};
  std::atomic<int> errors{0};
  const size_t stride = size_t(target_h) * target_w * channels;
  auto worker = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      int rc = decode_one(paths[i], out + stride * i, target_h, target_w,
                          channels);
      if (rc != 0) {
        // a file that fails gives a zero frame (the reference dataloader's
        // try/except), and counts as an error
        std::memset(out + stride * i, 0, stride * sizeof(float));
        errors.fetch_add(1);
      }
    }
  };
  std::vector<std::thread> pool;
  int nt = n_threads < n ? n_threads : n;
  pool.reserve(nt);
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  return -errors.load();
}

}  // extern "C"
