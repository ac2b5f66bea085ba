// Native image IO for the data pipeline: async batch reads + threaded decode.
//
// The reference does all decoding in Python DataLoader worker processes
// (PIL in torch workers); here a small C++ library decodes a whole batch
// and writes directly into one contiguous buffer the Python loader hands to
// the device. Exposed as a C ABI consumed via ctypes
// (geomapnet_tpu/native/__init__.py) — no pybind dependency.
//
// Architecture (two overlapped stages per batch):
//   1. READ  — all files of the batch are slurped through one io_uring
//      (raw syscalls; no liburing dependency), keeping the storage queue
//      full instead of paying one synchronous open/read round trip per
//      image per worker. Falls back to pread when the kernel/container
//      forbids io_uring (probed once; see gm_io_backend).
//   2. DECODE — a thread pool consumes completed buffers from a queue and
//      decodes from memory (libpng custom read fn / jpeg_mem_src), so
//      decode of image i overlaps the kernel reading image j.
//
// Decoding: libpng (8/16-bit gray/RGB/RGBA -> RGB8) and libjpeg.
// Resize: bilinear, with a 2x2 box prefilter per octave when downscaling
// by more than 2x (cheap antialiasing approximating PIL's filter).

#include <png.h>
#include <jpeglib.h>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <sys/syscall.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <csetjmp>
#include <deque>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

#if defined(__linux__) && defined(__NR_io_uring_setup)
#include <linux/io_uring.h>
#define GM_HAVE_URING 1
#endif

namespace {

// ---------------------------------------------------------------------------
// File slurping: pread fallback + io_uring batch reader
// ---------------------------------------------------------------------------

struct FileBuf {
  std::vector<uint8_t> bytes;
  bool ok = false;
};

bool slurp(const char* path, std::vector<uint8_t>* out) {
  int fd = open(path, O_RDONLY | O_CLOEXEC);
  if (fd < 0) return false;
  struct stat st;
  if (fstat(fd, &st) != 0 || !S_ISREG(st.st_mode) || st.st_size <= 0) {
    close(fd);
    return false;
  }
  out->resize(static_cast<size_t>(st.st_size));
  size_t got = 0;
  while (got < static_cast<size_t>(st.st_size)) {
    ssize_t r = pread(fd, out->data() + got, st.st_size - got, got);
    if (r < 0 && errno == EINTR) continue;
    if (r <= 0) {
      close(fd);
      return false;
    }
    got += static_cast<size_t>(r);
  }
  close(fd);
  return true;
}

#ifdef GM_HAVE_URING

// Minimal single-submitter io_uring wrapper over raw syscalls (the image has
// kernel headers but no liburing). Read-only workload, queue depth fixed at
// init.
struct Uring {
  int fd = -1;
  unsigned depth = 0;
  unsigned pending = 0;  // prepped but not yet submitted
  unsigned* sq_head = nullptr;
  unsigned* sq_tail = nullptr;
  unsigned sq_mask = 0;
  unsigned* sq_array = nullptr;
  unsigned* cq_head = nullptr;
  unsigned* cq_tail = nullptr;
  unsigned cq_mask = 0;
  io_uring_sqe* sqes = nullptr;
  io_uring_cqe* cqes = nullptr;
  void* sq_ring = MAP_FAILED;
  size_t sq_ring_sz = 0;
  void* cq_ring = MAP_FAILED;
  size_t cq_ring_sz = 0;
  void* sqe_mem = MAP_FAILED;
  size_t sqe_mem_sz = 0;

  bool init(unsigned entries) {
    io_uring_params p;
    memset(&p, 0, sizeof(p));
    long r = syscall(__NR_io_uring_setup, entries, &p);
    if (r < 0) return false;
    fd = static_cast<int>(r);
    depth = p.sq_entries;
    sq_ring_sz = p.sq_off.array + p.sq_entries * sizeof(unsigned);
    cq_ring_sz = p.cq_off.cqes + p.cq_entries * sizeof(io_uring_cqe);
    bool single = p.features & IORING_FEAT_SINGLE_MMAP;
    if (single) sq_ring_sz = cq_ring_sz = std::max(sq_ring_sz, cq_ring_sz);
    sq_ring = mmap(nullptr, sq_ring_sz, PROT_READ | PROT_WRITE,
                   MAP_SHARED | MAP_POPULATE, fd, IORING_OFF_SQ_RING);
    if (sq_ring == MAP_FAILED) return destroy(), false;
    cq_ring = single ? sq_ring
                     : mmap(nullptr, cq_ring_sz, PROT_READ | PROT_WRITE,
                            MAP_SHARED | MAP_POPULATE, fd, IORING_OFF_CQ_RING);
    if (cq_ring == MAP_FAILED) return destroy(), false;
    sqe_mem_sz = p.sq_entries * sizeof(io_uring_sqe);
    sqe_mem = mmap(nullptr, sqe_mem_sz, PROT_READ | PROT_WRITE,
                   MAP_SHARED | MAP_POPULATE, fd, IORING_OFF_SQES);
    if (sqe_mem == MAP_FAILED) return destroy(), false;

    char* sq = static_cast<char*>(sq_ring);
    char* cq = static_cast<char*>(cq_ring);
    sq_head = reinterpret_cast<unsigned*>(sq + p.sq_off.head);
    sq_tail = reinterpret_cast<unsigned*>(sq + p.sq_off.tail);
    sq_mask = *reinterpret_cast<unsigned*>(sq + p.sq_off.ring_mask);
    sq_array = reinterpret_cast<unsigned*>(sq + p.sq_off.array);
    cq_head = reinterpret_cast<unsigned*>(cq + p.cq_off.head);
    cq_tail = reinterpret_cast<unsigned*>(cq + p.cq_off.tail);
    cq_mask = *reinterpret_cast<unsigned*>(cq + p.cq_off.ring_mask);
    sqes = static_cast<io_uring_sqe*>(sqe_mem);
    cqes = reinterpret_cast<io_uring_cqe*>(cq + p.cq_off.cqes);
    return true;
  }

  void destroy() {
    if (sqe_mem != MAP_FAILED) munmap(sqe_mem, sqe_mem_sz);
    if (cq_ring != MAP_FAILED && cq_ring != sq_ring) munmap(cq_ring, cq_ring_sz);
    if (sq_ring != MAP_FAILED) munmap(sq_ring, sq_ring_sz);
    sq_ring = cq_ring = sqe_mem = MAP_FAILED;
    if (fd >= 0) close(fd);
    fd = -1;
  }
  ~Uring() { destroy(); }

  unsigned in_ring() const {
    // single submitter: plain tail read; kernel advances head
    return *sq_tail - __atomic_load_n(sq_head, __ATOMIC_ACQUIRE);
  }

  bool prep_read(int file_fd, void* buf, unsigned len, uint64_t off,
                 uint64_t user_data) {
    if (in_ring() >= depth) return false;
    unsigned tail = *sq_tail;
    unsigned idx = tail & sq_mask;
    io_uring_sqe* sqe = &sqes[idx];
    memset(sqe, 0, sizeof(*sqe));
    sqe->opcode = IORING_OP_READ;
    sqe->fd = file_fd;
    sqe->addr = reinterpret_cast<uint64_t>(buf);
    sqe->len = len;
    sqe->off = off;
    sqe->user_data = user_data;
    sq_array[idx] = idx;
    __atomic_store_n(sq_tail, tail + 1, __ATOMIC_RELEASE);
    ++pending;
    return true;
  }

  // submit everything prepped; block for >=1 completion if wait is set.
  // Returns false on an unrecoverable enter error.
  bool flush(bool wait) {
    for (;;) {
      long r = syscall(__NR_io_uring_enter, fd, pending, wait ? 1u : 0u,
                       wait ? IORING_ENTER_GETEVENTS : 0u, nullptr, 0);
      if (r >= 0) {
        pending -= static_cast<unsigned>(r);
        return true;
      }
      if (errno == EINTR || errno == EAGAIN || errno == EBUSY) continue;
      return false;
    }
  }

  bool pop_cqe(long* res, uint64_t* user_data) {
    unsigned head = *cq_head;
    if (head == __atomic_load_n(cq_tail, __ATOMIC_ACQUIRE)) return false;
    const io_uring_cqe* c = &cqes[head & cq_mask];
    *res = c->res;
    *user_data = c->user_data;
    __atomic_store_n(cq_head, head + 1, __ATOMIC_RELEASE);
    return true;
  }
};

#endif  // GM_HAVE_URING

// Probe once per process whether io_uring is usable (containers commonly
// block it via seccomp); GM_DISABLE_URING=1 forces the pread path.
bool uring_available() {
  static const bool avail = [] {
#ifdef GM_HAVE_URING
    if (getenv("GM_DISABLE_URING")) return false;
    Uring probe;
    // probe with the SAME depth read_files uses: a 4-entry ring can
    // succeed where the 64-entry ring's larger mmaps fail (memlock
    // limits), which would misreport the backend
    return probe.init(64);
#else
    return false;
#endif
  }();
  return avail;
}

// Read all n files, calling ready(i) exactly once per file as its buffer
// completes (from this thread). Uses io_uring when available; any mid-run
// ring failure degrades to pread for the files still outstanding.
void read_files(const char** paths, int n, std::vector<FileBuf>& bufs,
                const std::function<void(int)>& ready) {
#ifdef GM_HAVE_URING
  if (uring_available()) {
    Uring ring;
    if (ring.init(64)) {
      struct ReadState {
        int fd = -1;
        size_t size = 0;
        size_t done = 0;
      };
      std::vector<ReadState> st(n);
      std::vector<char> finished(n, 0);
      int next = 0, inflight = 0, completed = 0;
      bool ring_dead = false;

      auto finish = [&](int i, bool ok) {
        if (finished[i]) return;
        finished[i] = 1;
        if (st[i].fd >= 0) close(st[i].fd);
        if (!ok) bufs[i].bytes.clear();
        bufs[i].ok = ok;
        ++completed;
        ready(i);
      };

      while (completed < n && !ring_dead) {
        // keep the ring full: open + submit first read for the next files
        while (next < n && static_cast<unsigned>(inflight) < ring.depth) {
          int i = next++;
          int fd = open(paths[i], O_RDONLY | O_CLOEXEC);
          struct stat s;
          if (fd < 0 || fstat(fd, &s) != 0 || !S_ISREG(s.st_mode) ||
              s.st_size <= 0) {
            if (fd >= 0) close(fd);
            finish(i, false);
            continue;
          }
          st[i].fd = fd;
          st[i].size = static_cast<size_t>(s.st_size);
          bufs[i].bytes.resize(st[i].size);
          if (!ring.prep_read(fd, bufs[i].bytes.data(),
                              static_cast<unsigned>(st[i].size), 0,
                              static_cast<uint64_t>(i))) {
            // ring unexpectedly full: undo and retry after draining
            --next;
            close(fd);
            st[i] = ReadState{};
            break;
          }
          ++inflight;
        }
        if (inflight == 0) continue;  // all remaining were open failures
        if (!ring.flush(/*wait=*/true)) {
          ring_dead = true;
          break;
        }
        long res;
        uint64_t data;
        while (ring.pop_cqe(&res, &data)) {
          int i = static_cast<int>(data);
          if (res <= 0) {
            --inflight;
            finish(i, false);
          } else {
            st[i].done += static_cast<size_t>(res);
            if (st[i].done >= st[i].size) {
              --inflight;
              finish(i, true);
            } else if (!ring.prep_read(
                           st[i].fd, bufs[i].bytes.data() + st[i].done,
                           static_cast<unsigned>(st[i].size - st[i].done),
                           st[i].done, data)) {
              // resubmit found the SQ ring full (possible after a partial
              // io_uring_enter): silently dropping the file would leave
              // `inflight` nonzero forever and deadlock the wait loop —
              // finish the remainder synchronously instead
              bool ok = true;
              while (st[i].done < st[i].size) {
                ssize_t r = pread(st[i].fd,
                                  bufs[i].bytes.data() + st[i].done,
                                  st[i].size - st[i].done, st[i].done);
                if (r < 0 && errno == EINTR) continue;
                if (r <= 0) {
                  ok = false;
                  break;
                }
                st[i].done += static_cast<size_t>(r);
              }
              --inflight;
              finish(i, ok);
            }
          }
        }
      }
      // unrecoverable enter failure: finish the outstanding files with
      // pread (a racing kernel write would write identical bytes)
      for (int i = 0; i < n && ring_dead; ++i) {
        if (!finished[i]) {
          if (st[i].fd >= 0) close(st[i].fd), st[i].fd = -1;
          bufs[i].ok = slurp(paths[i], &bufs[i].bytes);
          finished[i] = 1;
          ready(i);
        }
      }
      if (!ring_dead) return;
      return;
    }
  }
#endif
  for (int i = 0; i < n; ++i) {
    bufs[i].ok = slurp(paths[i], &bufs[i].bytes);
    ready(i);
  }
}

// ---------------------------------------------------------------------------
// In-memory decoders
// ---------------------------------------------------------------------------

struct Image {
  std::vector<uint8_t> data;  // RGB8, row-major
  int h = 0;
  int w = 0;
};

struct MemSrc {
  const uint8_t* p;
  size_t n;
  size_t off;
};

void png_mem_read(png_structp png, png_bytep out, png_size_t len) {
  MemSrc* s = static_cast<MemSrc*>(png_get_io_ptr(png));
  if (s->off + len > s->n) png_error(png, "read past end of buffer");
  memcpy(out, s->p + s->off, len);
  s->off += len;
}

bool is_png(const uint8_t* bytes, size_t len) {
  return len >= 8 && !png_sig_cmp(const_cast<png_bytep>(bytes), 0, 8);
}

bool decode_png(const uint8_t* bytes, size_t len, Image* out) {
  if (!is_png(bytes, len)) return false;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png ? png_create_info_struct(png) : nullptr;
  if (!png || !info || setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  MemSrc src{bytes, len, 0};
  png_set_read_fn(png, &src, png_mem_read);
  png_read_info(png, info);

  png_set_strip_16(png);
  png_set_palette_to_rgb(png);
  png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  png_set_strip_alpha(png);
  png_set_gray_to_rgb(png);
  png_read_update_info(png, info);

  out->w = png_get_image_width(png, info);
  out->h = png_get_image_height(png, info);
  size_t rowbytes = png_get_rowbytes(png, info);
  if (rowbytes < static_cast<size_t>(out->w) * 3) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  out->data.resize(rowbytes * out->h);
  std::vector<png_bytep> rows(out->h);
  for (int y = 0; y < out->h; ++y) rows[y] = out->data.data() + y * rowbytes;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);

  // compact rows to tight RGB8 if rowbytes > w*3
  if (rowbytes != static_cast<size_t>(out->w) * 3) {
    for (int y = 1; y < out->h; ++y) {
      memmove(out->data.data() + static_cast<size_t>(y) * out->w * 3,
              out->data.data() + static_cast<size_t>(y) * rowbytes,
              static_cast<size_t>(out->w) * 3);
    }
    out->data.resize(static_cast<size_t>(out->h) * out->w * 3);
  }
  return true;
}

// Single-channel decode preserving the raw sensor values (RobotCar Bayer
// mosaics are stored as grayscale PNGs; demosaic happens on the TPU, so any
// host-side channel promotion or resize would corrupt the mosaic).
bool decode_png_gray(const uint8_t* bytes, size_t len, Image* out) {
  if (!is_png(bytes, len)) return false;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png ? png_create_info_struct(png) : nullptr;
  if (!png || !info || setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  MemSrc src{bytes, len, 0};
  png_set_read_fn(png, &src, png_mem_read);
  png_read_info(png, info);

  png_set_strip_16(png);
  png_set_expand_gray_1_2_4_to_8(png);
  png_set_strip_alpha(png);
  int color = png_get_color_type(png, info);
  if (color != PNG_COLOR_TYPE_GRAY && color != PNG_COLOR_TYPE_GRAY_ALPHA) {
    // mosaic files are grayscale; anything else is not a raw Bayer frame
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  png_read_update_info(png, info);

  out->w = png_get_image_width(png, info);
  out->h = png_get_image_height(png, info);
  size_t rowbytes = png_get_rowbytes(png, info);
  out->data.resize(rowbytes * out->h);
  std::vector<png_bytep> rows(out->h);
  for (int y = 0; y < out->h; ++y) rows[y] = out->data.data() + y * rowbytes;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);

  if (rowbytes != static_cast<size_t>(out->w)) {
    for (int y = 1; y < out->h; ++y) {
      memmove(out->data.data() + static_cast<size_t>(y) * out->w,
              out->data.data() + static_cast<size_t>(y) * rowbytes,
              static_cast<size_t>(out->w));
    }
    out->data.resize(static_cast<size_t>(out->h) * out->w);
  }
  return true;
}

// 16-bit single-channel decode (7Scenes depth frames are 16-bit gray PNGs
// holding millimeters). Values land in native byte order.
bool decode_png_gray16(const uint8_t* bytes, size_t len,
                       std::vector<uint16_t>* data, int* h, int* w) {
  if (!is_png(bytes, len)) return false;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png ? png_create_info_struct(png) : nullptr;
  if (!png || !info || setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  MemSrc src{bytes, len, 0};
  png_set_read_fn(png, &src, png_mem_read);
  png_read_info(png, info);

  int color = png_get_color_type(png, info);
  int depth = png_get_bit_depth(png, info);
  if (color != PNG_COLOR_TYPE_GRAY || depth != 16) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  const uint16_t one = 1;
  if (*reinterpret_cast<const uint8_t*>(&one)) {
    png_set_swap(png);  // PNG is big-endian; host is little-endian
  }
  png_read_update_info(png, info);

  *w = png_get_image_width(png, info);
  *h = png_get_image_height(png, info);
  size_t rowbytes = png_get_rowbytes(png, info);
  if (rowbytes != static_cast<size_t>(*w) * 2) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  data->resize(static_cast<size_t>(*h) * *w);
  std::vector<png_bytep> rows(*h);
  for (int y = 0; y < *h; ++y) {
    rows[y] = reinterpret_cast<png_bytep>(data->data() +
                                          static_cast<size_t>(y) * *w);
  }
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

// libjpeg's default error_exit() calls exit(): a single corrupt file would
// take down the whole training process. Redirect fatal errors to longjmp.
struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jmp;
};

void jpeg_error_longjmp(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<JpegErr*>(cinfo->err)->jmp, 1);
}

bool decode_jpeg(const uint8_t* bytes, size_t len, Image* out) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_error_longjmp;
  jerr.mgr.output_message = [](j_common_ptr) {};  // no stderr spam
  if (setjmp(jerr.jmp)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(bytes),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  out->data.resize(static_cast<size_t>(out->h) * out->w * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row =
        out->data.data() + static_cast<size_t>(cinfo.output_scanline) * out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

bool decode_any(const char* path, const uint8_t* bytes, size_t len,
                Image* out) {
  size_t n = strlen(path);
  if (n > 4 && (strcmp(path + n - 4, ".jpg") == 0 ||
                strcmp(path + n - 5, ".jpeg") == 0)) {
    return decode_jpeg(bytes, len, out);
  }
  if (decode_png(bytes, len, out)) return true;
  return decode_jpeg(bytes, len, out);
}

// ---------------------------------------------------------------------------
// Resize
// ---------------------------------------------------------------------------

// 2x2 box downsample (one octave of antialias prefilter)
void box_halve(Image* img) {
  int nh = img->h / 2, nw = img->w / 2;
  std::vector<uint8_t> out(static_cast<size_t>(nh) * nw * 3);
  for (int y = 0; y < nh; ++y) {
    const uint8_t* r0 = img->data.data() + static_cast<size_t>(2 * y) * img->w * 3;
    const uint8_t* r1 = r0 + static_cast<size_t>(img->w) * 3;
    uint8_t* dst = out.data() + static_cast<size_t>(y) * nw * 3;
    for (int x = 0; x < nw; ++x) {
      for (int c = 0; c < 3; ++c) {
        int s = r0[(2 * x) * 3 + c] + r0[(2 * x + 1) * 3 + c] +
                r1[(2 * x) * 3 + c] + r1[(2 * x + 1) * 3 + c];
        dst[x * 3 + c] = static_cast<uint8_t>((s + 2) >> 2);
      }
    }
  }
  img->data.swap(out);
  img->h = nh;
  img->w = nw;
}

void resize_bilinear(const Image& src, uint8_t* dst, int oh, int ow) {
  const float sy = static_cast<float>(src.h) / oh;
  const float sx = static_cast<float>(src.w) / ow;
  for (int y = 0; y < oh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = fy < 0 ? 0 : static_cast<int>(fy);
    if (y0 > src.h - 2) y0 = src.h - 2;
    float wy = fy - y0;
    if (wy < 0) wy = 0;
    if (wy > 1) wy = 1;
    const uint8_t* r0 = src.data.data() + static_cast<size_t>(y0) * src.w * 3;
    const uint8_t* r1 = r0 + static_cast<size_t>(src.w) * 3;
    uint8_t* drow = dst + static_cast<size_t>(y) * ow * 3;
    for (int x = 0; x < ow; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = fx < 0 ? 0 : static_cast<int>(fx);
      if (x0 > src.w - 2) x0 = src.w - 2;
      float wx = fx - x0;
      if (wx < 0) wx = 0;
      if (wx > 1) wx = 1;
      for (int c = 0; c < 3; ++c) {
        float v = (1 - wy) * ((1 - wx) * r0[x0 * 3 + c] + wx * r0[(x0 + 1) * 3 + c]) +
                  wy * ((1 - wx) * r1[x0 * 3 + c] + wx * r1[(x0 + 1) * 3 + c]);
        drow[x * 3 + c] = static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

bool decode_resize(const char* path, const uint8_t* bytes, size_t len,
                   uint8_t* dst, int oh, int ow) {
  Image img;
  if (!decode_any(path, bytes, len, &img) || img.h < 2 || img.w < 2)
    return false;
  // antialias prefilter: halve while the downscale factor exceeds 2x
  while (img.h >= 2 * oh && img.w >= 2 * ow && img.h >= 4 && img.w >= 4) {
    box_halve(&img);
  }
  resize_bilinear(img, dst, oh, ow);
  return true;
}

// ---------------------------------------------------------------------------
// Staged batch runner: async reads feeding a decode thread pool
// ---------------------------------------------------------------------------

class IndexQueue {
 public:
  void push(int i) {
    {
      std::lock_guard<std::mutex> l(m_);
      q_.push_back(i);
    }
    cv_.notify_one();
  }
  void close() {
    {
      std::lock_guard<std::mutex> l(m_);
      closed_ = true;
    }
    cv_.notify_all();
  }
  int pop() {  // -1 = queue closed and drained
    std::unique_lock<std::mutex> l(m_);
    cv_.wait(l, [&] { return closed_ || !q_.empty(); });
    if (q_.empty()) return -1;
    int i = q_.front();
    q_.pop_front();
    return i;
  }

 private:
  std::mutex m_;
  std::condition_variable cv_;
  std::deque<int> q_;
  bool closed_ = false;
};

// decode_one(i, bytes, len) decodes file i's buffer into its output slot.
int run_batch(const char** paths, int n, int n_threads, uint8_t* ok,
              const std::function<bool(int, const uint8_t*, size_t)>& decode_one) {
  if (n_threads < 1) n_threads = 1;
  std::vector<FileBuf> bufs(n);
  IndexQueue queue;
  std::atomic<int> good(0);
  auto consumer = [&]() {
    for (int i; (i = queue.pop()) >= 0;) {
      bool success = bufs[i].ok &&
                     decode_one(i, bufs[i].bytes.data(), bufs[i].bytes.size());
      if (ok) ok[i] = success ? 1 : 0;
      if (success) good.fetch_add(1);
      std::vector<uint8_t>().swap(bufs[i].bytes);  // free as we go
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(consumer);
  read_files(paths, n, bufs, [&](int i) { queue.push(i); });
  queue.close();
  for (auto& t : threads) t.join();
  return good.load();
}

}  // namespace

extern "C" {

// Which batch-read backend this process uses: "io_uring" or "pread".
const char* gm_io_backend(void) {
  return uring_available() ? "io_uring" : "pread";
}

// Decode one image, resized to (out_h, out_w), RGB8 into `out`.
// Returns 1 on success, 0 on failure.
int gm_decode_image(const char* path, uint8_t* out, int out_h, int out_w) {
  std::vector<uint8_t> bytes;
  if (!slurp(path, &bytes)) return 0;
  return decode_resize(path, bytes.data(), bytes.size(), out, out_h, out_w)
             ? 1
             : 0;
}

// Decode `n` images with `n_threads` workers into one contiguous
// (n, out_h, out_w, 3) uint8 buffer. `ok` (length n) receives per-image
// success flags. Returns the number of successfully decoded images.
int gm_decode_batch(const char** paths, int n, uint8_t* out, int out_h,
                    int out_w, int n_threads, uint8_t* ok) {
  const size_t stride = static_cast<size_t>(out_h) * out_w * 3;
  return run_batch(paths, n, n_threads, ok,
                   [&](int i, const uint8_t* bytes, size_t len) {
                     return decode_resize(paths[i], bytes, len,
                                          out + i * stride, out_h, out_w);
                   });
}

// Decode `n` single-channel (Bayer-mosaic) PNGs at NATIVE resolution into a
// contiguous (n, h, w) uint8 buffer — no resize, no channel promotion (the
// mosaic goes to the accelerator raw). Images whose dimensions differ from
// (h, w) are flagged failed. Returns the number decoded successfully.
int gm_decode_batch_gray(const char** paths, int n, uint8_t* out, int h,
                         int w, int n_threads, uint8_t* ok) {
  const size_t stride = static_cast<size_t>(h) * w;
  return run_batch(paths, n, n_threads, ok,
                   [&](int i, const uint8_t* bytes, size_t len) {
                     Image img;
                     if (!decode_png_gray(bytes, len, &img) || img.h != h ||
                         img.w != w)
                       return false;
                     memcpy(out + i * stride, img.data.data(), stride);
                     return true;
                   });
}

// Decode `n` 16-bit single-channel PNGs (7Scenes depth) at NATIVE resolution
// into a contiguous (n, h, w) uint16 buffer in host byte order. Images whose
// dimensions/bit depth differ are flagged failed. Returns the number decoded.
int gm_decode_batch_gray16(const char** paths, int n, uint16_t* out, int h,
                           int w, int n_threads, uint8_t* ok) {
  const size_t stride = static_cast<size_t>(h) * w;
  return run_batch(paths, n, n_threads, ok,
                   [&](int i, const uint8_t* bytes, size_t len) {
                     std::vector<uint16_t> data;
                     int ih = 0, iw = 0;
                     if (!decode_png_gray16(bytes, len, &data, &ih, &iw) ||
                         ih != h || iw != w)
                       return false;
                     memcpy(out + i * stride, data.data(), stride * 2);
                     return true;
                   });
}

// Probe the (h, w) of an image without full decode (PNG parses the header
// chunk only; JPEG requires a full header parse). Returns 1 on success.
int gm_image_size(const char* path, int* h, int* w) {
  std::vector<uint8_t> bytes;
  if (!slurp(path, &bytes)) return 0;
  if (is_png(bytes.data(), bytes.size())) {
    png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                             nullptr, nullptr);
    png_infop info = png ? png_create_info_struct(png) : nullptr;
    if (png && info && !setjmp(png_jmpbuf(png))) {
      MemSrc src{bytes.data(), bytes.size(), 0};
      png_set_read_fn(png, &src, png_mem_read);
      png_read_info(png, info);
      *w = png_get_image_width(png, info);
      *h = png_get_image_height(png, info);
      png_destroy_read_struct(&png, &info, nullptr);
      return 1;
    }
    png_destroy_read_struct(&png, &info, nullptr);
    return 0;
  }
  Image img;
  if (!decode_any(path, bytes.data(), bytes.size(), &img)) return 0;
  *h = img.h;
  *w = img.w;
  return 1;
}

}  // extern "C"
