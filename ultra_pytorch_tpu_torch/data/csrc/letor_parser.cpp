// Fast LETOR text parser (libsvm + ULTRA .feature formats).
//
// Native replacement for per-line Python parsing, which is the ingestion
// bottleneck at MSLR/Istella scale (~GB of "idx:val" text). Exposed to
// Python through ctypes by ../native.py, which builds it at first use
// (g++ -O3 -fPIC -shared -std=c++17) into build/ultra_pytorch_tpu_torch/;
// the loaders parse in Python when the library cannot be built.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace {

// Exact powers of ten: every one up to 1e22 is a double.
constexpr double kPow10[] = {1e0,  1e1,  1e2,  1e3,  1e4,  1e5,
                             1e6,  1e7,  1e8,  1e9,  1e10, 1e11,
                             1e12, 1e13, 1e14, 1e15};

// strtod's value, faster for plain "[-]ddd.ddd" tokens of at most 15
// digits: the digits as an integer m < 10^15 < 2^53 and 10^k are both
// exact doubles, so m / 10^k is one correctly rounded division, which is
// strtod's (correctly rounded) result. Anything else (an exponent, more
// digits, hex, inf/nan, a token that does not end at a separator) goes
// to strtod.
inline double parse_number(const char* p, const char** end) {
  const char* s = p;
  bool neg = (*s == '-');
  if (*s == '-' || *s == '+') ++s;
  uint64_t mant = 0;
  int digits = 0, frac = -1;
  for (;; ++s) {
    if (*s >= '0' && *s <= '9') {
      mant = mant * 10 + static_cast<uint64_t>(*s - '0');
      if (++digits > 15) break;
      if (frac >= 0) ++frac;
    } else if (*s == '.' && frac < 0) {
      frac = 0;
    } else {
      break;
    }
  }
  const char c = *s;
  const bool separator = c == ' ' || c == '\n' || c == '\r' || c == '\0';
  if (digits == 0 || digits > 15 || !separator) {
    return strtod(p, const_cast<char**>(end));
  }
  double v = static_cast<double>(mant);
  if (frac > 0) v /= kPow10[frac];
  *end = s;
  return neg ? -v : v;
}

inline long parse_long(const char* p, const char** end) {
  return strtol(p, const_cast<char**>(end), 10);
}

struct FileBuf {
  char* data = nullptr;
  size_t size = 0;
  bool ok = false;
};

FileBuf read_file(const char* path) {
  FileBuf fb;
  FILE* f = fopen(path, "rb");
  if (!f) return fb;
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  fb.data = static_cast<char*>(malloc(sz + 1));
  if (!fb.data) {
    fclose(f);
    return fb;
  }
  size_t got = fread(fb.data, 1, sz, f);
  fclose(f);
  fb.data[got] = '\0';
  fb.size = got;
  fb.ok = true;
  return fb;
}

}  // namespace

extern "C" {

// Pass 1: count rows and the maximum 1-based feature index.
// format: 0 = libsvm "label qid:X idx:val ..."; 1 = ULTRA "did idx:val ...".
// Returns row count, or -1 on IO error.
int64_t letor_count(const char* path, int format, int64_t* max_feature) {
  FileBuf fb = read_file(path);
  if (!fb.ok) return -1;
  int64_t rows = 0;
  int64_t max_idx = 0;
  const char* p = fb.data;
  const char* end = fb.data + fb.size;
  while (p < end) {
    // skip leading spaces
    while (p < end && (*p == ' ' || *p == '\r')) ++p;
    if (p >= end) break;
    if (*p == '\n') {
      ++p;
      continue;
    }
    ++rows;
    // first token (label or did)
    while (p < end && *p != ' ' && *p != '\n') ++p;
    if (format == 0) {  // skip qid token
      while (p < end && *p == ' ') ++p;
      while (p < end && *p != ' ' && *p != '\n') ++p;
    }
    // feature tokens
    while (p < end && *p != '\n') {
      while (p < end && *p == ' ') ++p;
      if (p >= end || *p == '\n') break;
      if (*p == '#') {  // comment to end of line
        while (p < end && *p != '\n') ++p;
        break;
      }
      const char* q;
      long idx = parse_long(p, &q);
      if (q != p && *q == ':') {
        if (idx > max_idx) max_idx = idx;
        p = q + 1;
        parse_number(p, &q);
        p = q;
      } else {
        while (p < end && *p != ' ' && *p != '\n') ++p;
      }
    }
    if (p < end && *p == '\n') ++p;
  }
  free(fb.data);
  *max_feature = max_idx;
  return rows;
}

// Pass 2: fill dense row-major features [rows x feature_size] (caller
// zero-initializes), labels[rows] (format 0; may be null for format 1),
// and ids (rows * id_bytes chars, NUL-padded: qid for format 0, did for
// format 1). Feature indices are 1-based in the file; idx-1 is the dense
// column; indices > feature_size are ignored (ref data_utils.py:140-141).
// Returns rows parsed, or -1 on IO error.
int64_t letor_parse(const char* path, int format, int64_t feature_size,
                    float* features, float* labels, char* ids,
                    int64_t id_bytes) {
  FileBuf fb = read_file(path);
  if (!fb.ok) return -1;
  int64_t row = 0;
  const char* p = fb.data;
  const char* end = fb.data + fb.size;
  while (p < end) {
    while (p < end && (*p == ' ' || *p == '\r')) ++p;
    if (p >= end) break;
    if (*p == '\n') {
      ++p;
      continue;
    }
    float* frow = features + row * feature_size;
    const char* q;
    if (format == 0) {
      // label
      double label = parse_number(p, &q);
      if (labels) labels[row] = static_cast<float>(label);
      p = q;
      while (p < end && *p == ' ') ++p;
      // qid:X -> id
      const char* tok = p;
      while (p < end && *p != ' ' && *p != '\n') ++p;
      const char* colon = tok;
      while (colon < p && *colon != ':') ++colon;
      const char* idstart = (colon < p) ? colon + 1 : tok;
      int64_t len = p - idstart;
      if (len > id_bytes - 1) len = id_bytes - 1;
      if (ids) {
        memcpy(ids + row * id_bytes, idstart, len);
        memset(ids + row * id_bytes + len, 0, id_bytes - len);
      }
    } else {
      // did token
      const char* tok = p;
      while (p < end && *p != ' ' && *p != '\n') ++p;
      int64_t len = p - tok;
      if (len > id_bytes - 1) len = id_bytes - 1;
      if (ids) {
        memcpy(ids + row * id_bytes, tok, len);
        memset(ids + row * id_bytes + len, 0, id_bytes - len);
      }
    }
    // feature tokens
    while (p < end && *p != '\n') {
      while (p < end && *p == ' ') ++p;
      if (p >= end || *p == '\n') break;
      if (*p == '#') {
        while (p < end && *p != '\n') ++p;
        break;
      }
      long idx = parse_long(p, &q);
      if (q != p && *q == ':') {
        p = q + 1;
        double val = parse_number(p, &q);
        p = q;
        if (idx >= 1 && idx <= feature_size) {
          frow[idx - 1] = static_cast<float>(val);
        }
      } else {
        while (p < end && *p != ' ' && *p != '\n') ++p;
      }
    }
    if (p < end && *p == '\n') ++p;
    ++row;
  }
  free(fb.data);
  return row;
}

}  // extern "C"
