// Native obj36 TSV decoder: the host-side data-ingestion hot loop.
//
// The reference loads Faster-RCNN obj36 feature shards (tens of GB of
// base64-encoded float payloads) through Python csv + base64.b64decode
// (data_process/data/utils.py:20-89) — single-threaded, ~100 MB/s. Rows are
// independent, so this decoder splits the file into lines once and
// base64-decodes all payload fields across a thread pool into per-row
// buffers. The Python binding (lako_tpu/data/vision_native.py) copies the
// results into numpy arrays; decode dominates, the memcpy is noise.
//
// Exposed C ABI (see vision_native.py for the ctypes mirror):
//   lako_obj36_open(path, n_threads, max_rows) -> handle | NULL
//   lako_obj36_num_rows / _img_id / _meta / _field
//   lako_obj36_error(handle) -> message for the last row-level failure
//   lako_obj36_close

#include <atomic>
#include <memory>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <string>
#include <thread>
#include <vector>

#ifdef __AVX2__
#include <immintrin.h>
#endif

namespace {

// field order in the TSV (vision.py OBJ36_FIELDNAMES)
enum Field {
  F_IMG_ID = 0,
  F_IMG_H,
  F_IMG_W,
  F_OBJECTS_ID,
  F_OBJECTS_CONF,
  F_ATTRS_ID,
  F_ATTRS_CONF,
  F_NUM_BOXES,
  F_BOXES,
  F_FEATURES,
  N_FIELDS
};

// payload fields, in the order the `field` index of lako_obj36_field uses
constexpr int kPayloadFields[6] = {F_OBJECTS_ID, F_OBJECTS_CONF, F_ATTRS_ID,
                                   F_ATTRS_CONF, F_BOXES, F_FEATURES};

// Decoded payload bytes. Allocated uninitialized (vector::resize would
// memset ~600 MB per real shard before the decoder overwrites it) with 8
// bytes of write slack for the AVX2 path's 32-byte stores.
struct Buf {
  std::unique_ptr<uint8_t[]> p;
  size_t n = 0;

  void alloc(size_t size) {
    p.reset(new uint8_t[size + 8]);
    n = size;
  }
};

struct Row {
  std::string img_id;
  int64_t img_h = 0, img_w = 0, num_boxes = 0, feat_dim = 0;
  Buf payload[6];  // decoded bytes per payload field
};

struct Obj36File {
  std::vector<Row> rows;
  std::string error;
};

// 4-char-per-iteration table decoder (Galbreath-style): four pre-shifted
// uint32 LUTs, bit 31 doubles as the invalid-char sentinel. ~3x the naive
// 6-bit accumulator — this is the hot loop of the whole ingest on a
// single-core host, where the thread pool cannot help.
uint32_t kD0[256], kD1[256], kD2[256], kD3[256];

struct B64InvInit {
  B64InvInit() {
    const char* alphabet =
        "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/";
    for (int i = 0; i < 256; ++i)
      kD0[i] = kD1[i] = kD2[i] = kD3[i] = 0x80000000u;
    for (uint32_t i = 0; i < 64; ++i) {
      uint8_t c = (uint8_t)alphabet[i];
      kD0[c] = i << 18;
      kD1[c] = i << 12;
      kD2[c] = i << 6;
      kD3[c] = i;
    }
  }
} kB64InvInit;

#ifdef __AVX2__
// Muła–Lemire AVX2 base64 block decode: 32 chars -> 24 bytes (writes 32,
// the last 8 are slack). Algorithm from the public fastbase64 work
// ("Faster Base64 Encoding and Decoding Using AVX2 Instructions"):
// nibble-LUT validation + roll offsets, then maddubs/madd packing.
// ~6x the 4-char scalar LUT loop; this loop IS the single-core ingest
// bottleneck once file read and line split are off the critical path.
inline bool decode32_avx2(const char* src, uint8_t* dst) {
  const __m256i lut_lo = _mm256_setr_epi8(
      0x15, 0x11, 0x11, 0x11, 0x11, 0x11, 0x11, 0x11,
      0x11, 0x11, 0x13, 0x1A, 0x1B, 0x1B, 0x1B, 0x1A,
      0x15, 0x11, 0x11, 0x11, 0x11, 0x11, 0x11, 0x11,
      0x11, 0x11, 0x13, 0x1A, 0x1B, 0x1B, 0x1B, 0x1A);
  const __m256i lut_hi = _mm256_setr_epi8(
      0x10, 0x10, 0x01, 0x02, 0x04, 0x08, 0x04, 0x08,
      0x10, 0x10, 0x10, 0x10, 0x10, 0x10, 0x10, 0x10,
      0x10, 0x10, 0x01, 0x02, 0x04, 0x08, 0x04, 0x08,
      0x10, 0x10, 0x10, 0x10, 0x10, 0x10, 0x10, 0x10);
  const __m256i lut_roll = _mm256_setr_epi8(
      0, 16, 19, 4, -65, -65, -71, -71, 0, 0, 0, 0, 0, 0, 0, 0,
      0, 16, 19, 4, -65, -65, -71, -71, 0, 0, 0, 0, 0, 0, 0, 0);

  __m256i str = _mm256_loadu_si256((const __m256i*)src);
  __m256i hi_nib = _mm256_and_si256(_mm256_srli_epi32(str, 4),
                                    _mm256_set1_epi8(0x0F));
  __m256i lo_nib = _mm256_and_si256(str, _mm256_set1_epi8(0x0F));
  __m256i lo = _mm256_shuffle_epi8(lut_lo, lo_nib);
  __m256i hi = _mm256_shuffle_epi8(lut_hi, hi_nib);
  if (!_mm256_testz_si256(lo, hi)) return false;
  __m256i eq_2f = _mm256_cmpeq_epi8(str, _mm256_set1_epi8(0x2F));
  __m256i roll = _mm256_shuffle_epi8(lut_roll,
                                     _mm256_add_epi8(eq_2f, hi_nib));
  __m256i vals = _mm256_add_epi8(str, roll);
  __m256i ab_bc = _mm256_maddubs_epi16(vals, _mm256_set1_epi32(0x01400140));
  __m256i merged = _mm256_madd_epi16(ab_bc, _mm256_set1_epi32(0x00011000));
  __m256i shuf = _mm256_shuffle_epi8(merged, _mm256_setr_epi8(
      2, 1, 0, 6, 5, 4, 10, 9, 8, 14, 13, 12, -1, -1, -1, -1,
      2, 1, 0, 6, 5, 4, 10, 9, 8, 14, 13, 12, -1, -1, -1, -1));
  __m256i out = _mm256_permutevar8x32_epi32(
      shuf, _mm256_setr_epi32(0, 1, 2, 4, 5, 6, -1, -1));
  _mm256_storeu_si256((__m256i*)dst, out);
  return true;
}
#endif

// Decode base64 span [p, p+n) into out; returns false on invalid input.
bool b64_decode(const char* p, size_t n, Buf& out) {
  while (n > 0 && (p[n - 1] == '=' || p[n - 1] == '\r')) --n;
  size_t rem0 = n % 4;
  out.alloc(n / 4 * 3 + (rem0 ? rem0 - 1 : 0));
  uint8_t* dst = out.p.get();
  size_t main = n / 4 * 4;
  size_t i = 0;
#ifdef __AVX2__
  for (; i + 32 <= main; i += 32, dst += 24)
    if (!decode32_avx2(p + i, dst)) return false;
#endif
  for (; i < main; i += 4) {
    uint32_t v = kD0[(uint8_t)p[i]] | kD1[(uint8_t)p[i + 1]] |
                 kD2[(uint8_t)p[i + 2]] | kD3[(uint8_t)p[i + 3]];
    if (v & 0x80000000u) return false;
    dst[0] = (uint8_t)(v >> 16);
    dst[1] = (uint8_t)(v >> 8);
    dst[2] = (uint8_t)v;
    dst += 3;
  }
  size_t rem = n - main;
  if (rem == 1) return false;  // a lone trailing char is never valid
  if (rem >= 2) {
    uint32_t v = kD0[(uint8_t)p[main]] | kD1[(uint8_t)p[main + 1]] |
                 (rem == 3 ? kD2[(uint8_t)p[main + 2]] : 0);
    if (v & 0x80000000u) return false;
    *dst++ = (uint8_t)(v >> 16);
    if (rem == 3) *dst++ = (uint8_t)(v >> 8);
  }
  return true;
}

bool parse_i64(const char* p, size_t n, int64_t* out) {
  if (n == 0) return false;
  int64_t v = 0;
  bool neg = false;
  size_t i = 0;
  if (p[0] == '-') { neg = true; i = 1; }
  for (; i < n; ++i) {
    if (p[i] < '0' || p[i] > '9') return false;
    v = v * 10 + (p[i] - '0');
  }
  *out = neg ? -v : v;
  return true;
}

// Parse one line (fields separated by \t) into `row`.
bool parse_row(const char* line, size_t len, Row* row, std::string* err) {
  const char* spans[N_FIELDS];
  size_t lens[N_FIELDS];
  // memchr tab-scan: a per-byte loop over multi-hundred-KB payload fields
  // costs ~0.35 s per 790 MB shard on its own
  const char* cur = line;
  const char* end = line + len;
  int f = 0;
  while (f < N_FIELDS) {
    const char* tab = (const char*)memchr(cur, '\t', (size_t)(end - cur));
    const char* stop = tab ? tab : end;
    spans[f] = cur;
    lens[f] = (size_t)(stop - cur);
    ++f;
    if (!tab) break;
    cur = tab + 1;
  }
  if (f != N_FIELDS) {
    *err = "expected 10 tab-separated fields";
    return false;
  }
  // strip a trailing \r from the last field (CRLF files)
  if (lens[N_FIELDS - 1] > 0 &&
      spans[N_FIELDS - 1][lens[N_FIELDS - 1] - 1] == '\r')
    --lens[N_FIELDS - 1];

  row->img_id.assign(spans[F_IMG_ID], lens[F_IMG_ID]);
  if (!parse_i64(spans[F_IMG_H], lens[F_IMG_H], &row->img_h) ||
      !parse_i64(spans[F_IMG_W], lens[F_IMG_W], &row->img_w) ||
      !parse_i64(spans[F_NUM_BOXES], lens[F_NUM_BOXES], &row->num_boxes)) {
    *err = "bad integer field";
    return false;
  }
  for (int j = 0; j < 6; ++j) {
    int src = kPayloadFields[j];
    if (!b64_decode(spans[src], lens[src], row->payload[j])) {
      *err = "invalid base64 payload";
      return false;
    }
  }
  int64_t n = row->num_boxes;
  // size checks mirror the reshape asserts of the Python loader
  if (n <= 0 ||
      row->payload[0].n != (size_t)n * 8 ||   // objects_id int64
      row->payload[1].n != (size_t)n * 4 ||   // objects_conf f32
      row->payload[2].n != (size_t)n * 8 ||   // attrs_id int64
      row->payload[3].n != (size_t)n * 4 ||   // attrs_conf f32
      row->payload[4].n != (size_t)n * 16 ||  // boxes (n,4) f32
      row->payload[5].n % ((size_t)n * 4) != 0) {
    *err = "payload size inconsistent with num_boxes";
    return false;
  }
  row->feat_dim = (int64_t)(row->payload[5].n / ((size_t)n * 4));
  return true;
}

}  // namespace

extern "C" {

void* lako_obj36_open(const char* path, int n_threads, long long max_rows) {
  // mmap read-only: skips a full-file copy (~0.45 s per 790 MB shard);
  // all decoded data is copied out before return, so the mapping is
  // transient. Falls back to read() if mmap fails.
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) { ::close(fd); return nullptr; }
  size_t size = (size_t)st.st_size;
  std::unique_ptr<char[]> fallback;
  const char* base = nullptr;
  void* mapped = nullptr;
  if (size > 0) {
    mapped = mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (mapped != MAP_FAILED) {
      madvise(mapped, size, MADV_SEQUENTIAL);
      base = (const char*)mapped;
    } else {
      mapped = nullptr;
      fallback.reset(new char[size]);
      size_t got = 0;
      while (got < size) {
        ssize_t r = ::read(fd, fallback.get() + got, size - got);
        if (r <= 0) { ::close(fd); return nullptr; }
        got += (size_t)r;
      }
      base = fallback.get();
    }
  }
  ::close(fd);

  // line split via memchr (SIMD in libc; a byte loop costs ~0.5 s on a
  // 790 MB shard)
  std::vector<std::pair<const char*, size_t>> lines;
  const char* end = base + size;
  const char* cur = base;
  while (cur < end) {
    const char* nl = (const char*)memchr(cur, '\n', (size_t)(end - cur));
    const char* stop = nl ? nl : end;
    if (stop > cur) lines.emplace_back(cur, (size_t)(stop - cur));
    if (!nl) break;
    cur = nl + 1;
    if (max_rows >= 0 && (long long)lines.size() >= max_rows) break;
  }
  if (max_rows >= 0 && (long long)lines.size() > max_rows)
    lines.resize((size_t)max_rows);

  auto* out = new Obj36File();
  out->rows.resize(lines.size());
  if (n_threads < 1) n_threads = 1;
  std::atomic<size_t> next(0);
  std::atomic<bool> failed(false);
  std::vector<std::string> errs((size_t)n_threads);
  std::vector<std::thread> pool;
  for (int t = 0; t < n_threads; ++t) {
    pool.emplace_back([&, t]() {
      for (;;) {
        size_t i = next.fetch_add(1);
        if (i >= lines.size() || failed.load(std::memory_order_relaxed))
          return;
        std::string err;
        if (!parse_row(lines[i].first, lines[i].second, &out->rows[i],
                       &err)) {
          errs[(size_t)t] = "row " + std::to_string(i) + ": " + err;
          failed.store(true, std::memory_order_relaxed);
          return;
        }
      }
    });
  }
  for (auto& th : pool) th.join();
  if (mapped) munmap(mapped, size);
  if (failed.load()) {
    for (auto& e : errs)
      if (!e.empty()) { out->error = e; break; }
    out->rows.clear();
  }
  return out;  // on failure the caller checks lako_obj36_error
}

long long lako_obj36_num_rows(void* h) {
  return (long long)static_cast<Obj36File*>(h)->rows.size();
}

const char* lako_obj36_error(void* h) {
  return static_cast<Obj36File*>(h)->error.c_str();
}

const char* lako_obj36_img_id(void* h, long long row) {
  return static_cast<Obj36File*>(h)->rows[(size_t)row].img_id.c_str();
}

int lako_obj36_meta(void* h, long long row, long long* img_h,
                    long long* img_w, long long* num_boxes,
                    long long* feat_dim) {
  const Row& r = static_cast<Obj36File*>(h)->rows[(size_t)row];
  *img_h = r.img_h;
  *img_w = r.img_w;
  *num_boxes = r.num_boxes;
  *feat_dim = r.feat_dim;
  return 0;
}

// field: index into kPayloadFields order (0 objects_id .. 5 features).
// Returns pointer to the decoded bytes; size via lako_obj36_field_size.
const void* lako_obj36_field(void* h, long long row, int field) {
  return static_cast<Obj36File*>(h)->rows[(size_t)row]
      .payload[field].p.get();
}

long long lako_obj36_field_size(void* h, long long row, int field) {
  return (long long)static_cast<Obj36File*>(h)->rows[(size_t)row]
      .payload[field].n;
}

void lako_obj36_close(void* h) { delete static_cast<Obj36File*>(h); }

}  // extern "C"
